"""The port's SPMD collective lint (``analysis/collective.py``) against
the JAX package's.

* Every source-level fixture of ``tests/test_collective_lint.py``,
  translated to ``torch.distributed`` line for line (``psum`` ->
  ``dist.all_reduce``, ``process_index()`` -> ``dist.get_rank()``, the
  multihost barrier -> ``dist.barrier()``), gives the port's lint the
  JAX lint's ``(rule, line)`` findings on the original.
* The pragma contract, interprocedural carriers, the barrier-tag order
  model and the collective-site inventory, as in the JAX tests.
* What the registry says of ``torch.distributed``: a point-to-point
  peer is rank-derived by design, ``dist.barrier()`` takes no tag, the
  port's wrappers of ``parallel/collectives.py`` are collectives.
* The sweep: ``lint_paths`` over the port returns no finding.
"""
from __future__ import annotations

import os

import pytest

from kfac_pytorch_tpu_torch.analysis import collective

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, JAX fixture, its torch.distributed translation); the two have
# the same line structure.
FIXTURES = [
    ('traced_under_rank_guard', '''
import jax
def f(x):
    if jax.process_index() == 0:
        x = jax.lax.psum(x, 'data')
    return x
''', '''
import torch.distributed as dist
def f(x):
    if dist.get_rank() == 0:
        dist.all_reduce(x)
    return x
'''),
    ('host_under_rank_attribute', '''
def f(rt, x):
    if rt.rank == 0:
        rt.barrier('drill/start')
    return x
''', '''
def f(rt, x):
    if rt.rank == 0:
        rt.barrier('drill/start')
    return x
'''),
    ('uniform_guard_clean', '''
import jax
def f(x):
    if jax.process_count() > 1:
        x = jax.lax.psum(x, 'data')
    return x
''', '''
import torch.distributed as dist
def f(x):
    if dist.get_world_size() > 1:
        dist.all_reduce(x)
    return x
'''),
    ('else_branch_of_rank_guard', '''
import jax
def f(x):
    if jax.process_index() == 0:
        pass
    else:
        x = jax.lax.psum(x, 'data')
    return x
''', '''
import torch.distributed as dist
def f(x):
    if dist.get_rank() == 0:
        pass
    else:
        dist.all_reduce(x)
    return x
'''),
    ('collective_in_except_handler', '''
def f(x):
    try:
        return x + 1
    except ValueError:
        return all_gather(x, 'data')
''', '''
def f(x, out):
    try:
        return x + 1
    except ValueError:
        return dist.all_gather(out, x)
'''),
    ('collective_via_retry_wrapper', '''
def f(path, precond, state):
    def attempt():
        return save_streaming(path, precond, state)
    return retry_transient_save(attempt)
''', '''
def f(path, precond, extras):
    def attempt():
        return save_streaming(path, precond, extras=extras)
    return retry_transient_save(attempt)
'''),
    ('collective_free_retry_clean', '''
def f(path, payload):
    def attempt():
        with open(path, 'w') as fh:
            fh.write(payload)
    return retry_transient_save(attempt)
''', '''
def f(path, payload):
    def attempt():
        with open(path, 'w') as fh:
            fh.write(payload)
    return retry_transient_save(attempt)
'''),
    ('collective_after_rank_conditional_return', '''
import jax
def f(x):
    if jax.process_index() != 0:
        return None
    return sync_global_devices('x')
''', '''
import torch.distributed as dist
def f(x):
    if dist.get_rank() != 0:
        return None
    return dist.barrier()
'''),
    ('no_downstream_collective_clean', '''
import jax
def f(x):
    if jax.process_index() != 0:
        return None
    with open('out.json', 'w') as fh:
        fh.write(x)
''', '''
import torch.distributed as dist
def f(x):
    if dist.get_rank() != 0:
        return None
    with open('out.json', 'w') as fh:
        fh.write(x)
'''),
    ('rank_value_feeding_argument', '''
import jax
def f(x):
    return jax.lax.ppermute(
        x, 'data', perm=[(jax.process_index(), 0)])
''', '''
import torch.distributed as dist
def f(x):
    return dist.broadcast(
        x, src=dist.get_rank())
'''),
    ('uniform_arguments_clean', '''
import jax
def f(x):
    return jax.lax.all_gather(x, 'data', tiled=True)
''', '''
import torch.distributed as dist
def f(x, out):
    return dist.all_gather_into_tensor(out, x, async_op=False)
'''),
    ('unregistered_tag', '''
def f():
    commit_point('bogus/tag')
''', '''
def f():
    commit_point('bogus/tag')
'''),
    ('tag_order_violation', '''
def f():
    commit_point('elastic/commit')
    commit_point('elastic/stamp')
''', '''
def f():
    commit_point('elastic/commit')
    commit_point('elastic/stamp')
'''),
    ('declared_order_clean', '''
def f():
    commit_point('elastic/stamp')
    commit_point('elastic/commit')
''', '''
def f():
    commit_point('elastic/stamp')
    commit_point('elastic/commit')
'''),
    ('reasoned_proc0_pragma_clean', '''
import jax
def f(x):
    if jax.process_index() == 0:  # spmd: proc0(writer contract)
        save_streaming('d', None, None)
    return x
''', '''
import torch.distributed as dist
def f(x):
    if dist.get_rank() == 0:  # spmd: proc0(writer contract)
        save_streaming('d', None)
    return x
'''),
    ('reasonless_pragma', '''
import jax
def f(x):
    if jax.process_index() == 0:  # spmd: proc0()
        save_streaming('d', None, None)
    return x
''', '''
import torch.distributed as dist
def f(x):
    if dist.get_rank() == 0:  # spmd: proc0()
        save_streaming('d', None)
    return x
'''),
    ('pragma_does_not_leak', '''
import jax
def f(x):
    if jax.process_index() == 0:  # spmd: proc0(writer contract)
        save_streaming('d', None, None)
    return x
def g():
    commit_point('bogus/tag')
''', '''
import torch.distributed as dist
def f(x):
    if dist.get_rank() == 0:  # spmd: proc0(writer contract)
        save_streaming('d', None)
    return x
def g():
    commit_point('bogus/tag')
'''),
    ('carrier_through_two_hops', '''
def helper(x):
    return inner(x)
def inner(x):
    return psum(x, 'data')
def f(x, rank):
    if rank == 0:
        return helper(x)
    return x
''', '''
def helper(x):
    return inner(x)
def inner(x):
    return all_reduce(x)
def f(x, rank):
    if rank == 0:
        return helper(x)
    return x
'''),
    ('non_carrier_callee_clean', '''
def helper(x):
    return x * 2
def f(x, rank):
    if rank == 0:
        return helper(x)
    return x
''', '''
def helper(x):
    return x * 2
def f(x, rank):
    if rank == 0:
        return helper(x)
    return x
'''),
]


def findings(module, src):
    return sorted((f.rule, f.line) for f in module.lint_source(src))


@pytest.mark.parametrize('name,jax_src,torch_src', FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_translated_fixture_matches_jax(name, jax_src, torch_src):
    from kfac_pytorch_tpu.analysis import collective as jax_collective

    assert len(jax_src.splitlines()) == len(torch_src.splitlines())
    want = findings(jax_collective, jax_src)
    assert findings(collective, torch_src) == want
    # The clean fixtures are clean, the rest are not.
    assert bool(want) != name.endswith('_clean')


def test_messages_name_the_guard_and_the_tag():
    fs = collective.lint_source(FIXTURES[0][2])
    assert [f.rule for f in fs] == ['collective-under-rank-guard']
    assert 'dist.get_rank' in fs[0].message
    assert fs[0].guard_line == 4
    fs = collective.lint_source("def f():\n    commit_point('bogus/tag')\n")
    assert 'bogus/tag' in fs[0].message


def test_reasonless_pragma_keeps_the_finding_and_adds_its_own():
    src = dict((f[0], f[2]) for f in FIXTURES)['reasonless_pragma']
    assert sorted({f.rule for f in collective.lint_source(src)}) == [
        'collective-under-rank-guard', 'spmd-pragma-reason']


def test_collective_safe_pragma_exempts_any_rule():
    src = '''
import torch.distributed as dist
def f(x):
    return dist.broadcast(x, src=dist.get_rank())  # spmd: collective-safe(test)
'''
    assert collective.lint_source(src) == []


def test_barrier_tag_order_model():
    tags = collective.BARRIER_TAG_ORDER
    assert len(tags) == len(set(tags))
    assert 'drill/start' in tags
    from kfac_pytorch_tpu.analysis import collective as jax_collective

    assert tags == jax_collective.BARRIER_TAG_ORDER
    assert collective.SPMD_RULES.keys() == jax_collective.SPMD_RULES.keys()


def test_collective_sites_inventory():
    sites = collective.collective_sites('''
import torch.distributed as dist
def f(x, out):
    dist.all_reduce(x)
    return all_gather(out, x)
''')
    assert sorted(s.name for s in sites) == ['all_gather', 'dist.all_reduce']
    assert {s.kind for s in sites} == {'traced'}


@pytest.mark.parametrize('src,rules', [
    # A point-to-point peer is rank-derived by design.
    ('''
import torch.distributed as dist
def f(x, world):
    dist.send(x, dst=(dist.get_rank() + 1) % world)
    dist.recv(x, (dist.get_rank() - 1) % world)
''', []),
    # ...but its tensor is checked.
    ('''
import torch.distributed as dist
def f(xs):
    dist.send(xs[dist.get_rank()], dst=0)
''', ['rank-divergent-argument']),
    # torch.distributed's barrier takes a group, not a tag.
    ('''
import torch.distributed as dist
def f(group):
    dist.barrier(group)
''', []),
    # The port's wrappers are collectives in any module.
    ('''
from kfac_pytorch_tpu_torch.parallel import collectives
def f(t, group, rank):
    if rank == 0:
        collectives.all_reduce_mean(t, group)
''', ['collective-under-rank-guard']),
    # Object collectives are host collectives.
    ('''
import torch.distributed as dist
def f(box):
    if dist.get_rank() == 0:
        dist.broadcast_object_list(box, src=0)
''', ['collective-under-rank-guard']),
    # A helper that gathers is a carrier to its callers in the module.
    ('''
import torch.distributed as dist
def _every_rank(item):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, item)
    return out
def f(item):
    if dist.get_rank() == 0:
        return _every_rank(item)
''', ['collective-under-rank-guard']),
])
def test_torch_registry(src, rules):
    assert [f.rule for f in collective.lint_source(src)] == rules


def test_port_is_lint_clean():
    """The sweep's steady state: every finding on the port fixed or given
    a reasoned ``# spmd:`` pragma."""
    pkg = os.path.join(REPO, 'kfac_pytorch_tpu_torch')
    out = collective.lint_paths([pkg])
    assert out == [], '\n'.join(f.format() for f in out)
    # The sweep saw the port's collective call sites.
    sites = collective.collective_sites(open(os.path.join(
        pkg, 'parallel', 'collectives.py')).read())
    assert len(sites) >= 5
