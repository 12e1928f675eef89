"""The port's retrace guard, signatures, canonical scalars and trace
contracts against the JAX package's (``tests/test_analysis.py``).

* Signatures: the same drifts (shape, dtype, a host scalar against a 0-d
  tensor, structure) give JAX's diff kinds.
* The guard, on JAX's ``tiny_setup`` (``TinyModel(hidden=20, out=10)``,
  batch 8, factor 2, inv 4, damping 1e-3, lr 0.1) with the same schedule
  in both packages: the damping sweep's 3 programs and 0 retraces, the
  budget raise at JAX's step with its message, the exempt restore
  refresh, the strict raise on every retry, the bf16 drift's dtype diff,
  guarded steps bitwise the unguarded ones, and ``engine_variants``
  naming JAX's variants for the default, stagger 2, overlap and
  consistency engines.
* Contracts: every variant of those engines validates on fake tensors,
  ResNet-50 at full width with no real parameter, a poisoned layer is
  named, the default-off parity pin holds and monitor-on differs, the
  real engine is bitwise untouched, and the precondition tail traces
  with zero graph breaks.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor
from torch._subclasses.fake_tensor import FakeTensorMode

import kfac_pytorch_tpu_torch as kt
from kfac_pytorch_tpu.analysis import contracts as jax_contracts
from kfac_pytorch_tpu.analysis import signature as jax_sig
from kfac_pytorch_tpu.analysis.retrace import (
    CompileBudgetError as JaxBudgetError,
)
from kfac_pytorch_tpu.analysis.retrace import RetraceError as JaxRetraceError
from kfac_pytorch_tpu_torch.analysis import contracts
from kfac_pytorch_tpu_torch.analysis import signature as sig
from kfac_pytorch_tpu_torch.analysis.retrace import CompileBudgetError
from kfac_pytorch_tpu_torch.analysis.retrace import RetraceError
from kfac_pytorch_tpu_torch.hyperparams import canonical_scalar
from kfac_pytorch_tpu_torch.models import TinyModel
from kfac_pytorch_tpu_torch.observe import ObserveConfig

from test_analysis import tiny_setup as jax_tiny_setup
from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

DAMPINGS = [1e-3, 3e-3, 1e-2]


def batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 10)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,))
    return torch.from_numpy(x), torch.from_numpy(y)


def tiny_setup(**kw):
    """The port's ``tiny_setup``: the same model, batch and cadence."""
    torch.manual_seed(2)
    model = TinyModel(hidden=20, out=10)
    kw.setdefault('factor_update_steps', 2)
    kw.setdefault('inv_update_steps', 4)
    kw.setdefault('damping', 1e-3)
    kw.setdefault('lr', 0.1)
    return kt.KFACPreconditioner(model, **kw), model


def step(precond, model, x, y):
    model.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    precond.step()
    return loss.detach()


def jax_step(precond, variables, state, x, y):
    return precond.step(variables, state, x, loss_args=(y,))[3]


# ----------------------------------------------------------------------
# signatures and canonical scalars
# ----------------------------------------------------------------------


def test_diff_kinds_match_jax():
    a = {'x': ((4, 2), 'f32'), 'y': ((3,), 'f32'), 'gone': ((1,), 'f32'),
         's': 'static-a'}
    b = {'x': ((4, 2), 'bf16'), 'y': ((5,), 'f32'), 'new': ((1,), 'f32'),
         's': 'static-b'}

    def jax_tree(d):
        return {k: v if isinstance(v, str) else jnp.zeros(
            v[0], jnp.bfloat16 if v[1] == 'bf16' else jnp.float32)
            for k, v in d.items()}

    def torch_tree(d):
        return {k: v if isinstance(v, str) else torch.zeros(
            v[0], dtype=torch.bfloat16 if v[1] == 'bf16' else torch.float32)
            for k, v in d.items()}

    want = {d.path: d.kind for d in jax_sig.diff_signatures(
        jax_sig.abstract_signature(jax_tree(a)),
        jax_sig.abstract_signature(jax_tree(b)))}
    got = {d.path: d.kind for d in sig.diff_signatures(
        sig.abstract_signature(torch_tree(a)),
        sig.abstract_signature(torch_tree(b)))}
    assert got == want
    assert got["['x']"] == 'dtype' and got["['y']"] == 'shape'
    assert got["['gone']"] == 'removed' and got["['new']"] == 'added'


def test_host_scalar_against_0d_tensor_is_jaxs_kind_diff():
    want = [d.kind for d in jax_sig.diff_signatures(
        jax_sig.abstract_signature((jnp.float32(1.0),)),
        jax_sig.abstract_signature((1.0,)))]
    got = [d.kind for d in sig.diff_signatures(
        sig.abstract_signature((torch.tensor(1.0),)),
        sig.abstract_signature((1.0,)))]
    assert got == want == ['kind']
    assert sig.abstract_signature((1.0,))['[0]'].weak
    assert not sig.abstract_signature((torch.tensor(1.0),))['[0]'].weak


def test_signature_paths_and_devices():
    t = sig.abstract_signature({'grads': {'w': torch.zeros(2, 3)},
                                'hp': (torch.tensor(True), None)})
    assert t == {
        "['grads']['w']": sig.LeafSig('array', (2, 3), 'float32', False,
                                      'cpu'),
        "['hp'][0]": sig.LeafSig('array', (), 'bool', False, 'cpu'),
    }
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(torch.zeros(2, 3))
    assert sig.abstract_signature({'grads': {'w': fake}})[
        "['grads']['w']"] == t["['grads']['w']"]


def test_layout_drift_is_its_own_kind():
    a = sig.abstract_signature({'q': torch.zeros(4, 3)})
    b = sig.abstract_signature({'q': torch.zeros(3, 4).mT})
    (d,) = sig.diff_signatures(a, b)
    assert (d.path, d.kind) == ("['q']", 'layout')
    assert 'strides(1, 4)' in d.format()


def test_refreshed_bases_keep_one_layout():
    """The refresh keeps the eigenbases row-major, so the stacks a step
    reads keep one signature across refreshes (a compiled tail guards on
    strides)."""
    x, y = batch()
    precond, model = tiny_setup(inv_update_steps=2, factor_update_steps=1)
    sigs = []
    for _ in range(5):
        step(precond, model, x, y)
        sigs.append(sig.abstract_signature(precond.buckets))
        for bs in precond.buckets.values():
            assert bs.qa.is_contiguous() and bs.qg.is_contiguous()
    assert all(s == sigs[0] for s in sigs)


def test_canonical_scalar_is_cached_by_value():
    a = canonical_scalar(1e-3)
    assert a is canonical_scalar(1e-3)
    assert a.dtype == torch.float32 and a.ndim == 0
    assert canonical_scalar(True).dtype == torch.bool
    assert canonical_scalar(7).dtype == torch.int64
    assert canonical_scalar(1e-3) is not canonical_scalar(3e-3)
    with FakeTensorMode():
        fake = canonical_scalar(1e-3)
    assert isinstance(fake, FakeTensor)
    assert canonical_scalar(1e-3) is a  # the fake one was not cached


# ----------------------------------------------------------------------
# the retrace guard against JAX's on the same schedule
# ----------------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_guard():
    """JAX's guard outcomes on test_analysis.py's schedules."""
    out = {}
    precond, variables, state, x, y = jax_tiny_setup(
        damping=lambda s: DAMPINGS[s % 3], compile_budget=3)
    for _ in range(9):
        state = jax_step(precond, variables, state, x, y)
    out['sweep'] = (precond.retrace_guard.compiles,
                    precond.retrace_guard.retraces)

    precond, variables, state, x, y = jax_tiny_setup(compile_budget=2)
    for i in range(4):
        try:
            state = jax_step(precond, variables, state, x, y)
        except JaxBudgetError as e:
            out['budget'] = (i, str(e))
            break

    precond, variables, state, x, y = jax_tiny_setup(compile_budget=3)
    for _ in range(5):
        state = jax_step(precond, variables, state, x, y)
    state = precond.load_state_dict(precond.state_dict(state), state)
    guard = precond.retrace_guard
    out['restore'] = (guard.variants('restore_refresh'), guard.compiles)

    precond, variables, state, x, y = jax_tiny_setup()
    guard = precond.enable_retrace_guard(strict=True)
    for _ in range(5):
        state = jax_step(precond, variables, state, x, y)
    raised = 0
    for _ in range(3):
        try:
            jax_step(precond, variables, state, x.astype(jnp.bfloat16), y)
        except JaxRetraceError as e:
            raised += 1
            out['strict_message'] = str(e)
    out['strict'] = (raised, guard.retraces)
    return out


def test_damping_sweep_compiles_three_programs_as_jax():
    x, y = batch()
    precond, model = tiny_setup(damping=lambda s: DAMPINGS[s % 3],
                                compile_budget=3)
    for _ in range(9):
        step(precond, model, x, y)
    guard = precond.retrace_guard
    assert (guard.compiles, guard.retraces) == (3, 0)
    assert set(guard.keys()) == {
        (True, True, None, None, False),
        (False, False, None, None, False),
        (True, False, None, None, False),
    }


def test_guard_counts_equal_jaxs_on_the_sweep(jax_guard):
    x, y = batch()
    precond, model = tiny_setup(damping=lambda s: DAMPINGS[s % 3],
                                compile_budget=3)
    for _ in range(9):
        step(precond, model, x, y)
    guard = precond.retrace_guard
    assert (guard.compiles, guard.retraces) == jax_guard['sweep'] == (3, 0)


def test_budget_raises_at_jaxs_step_naming_the_new_program(jax_guard):
    x, y = batch()
    precond, model = tiny_setup(compile_budget=2)
    raised_at, msg = None, ''
    for i in range(4):
        try:
            step(precond, model, x, y)
        except CompileBudgetError as e:
            raised_at, msg = i, str(e)
            break
    jax_at, jax_msg = jax_guard['budget']
    assert raised_at == jax_at == 2
    for text in ('new-static-key', 'program registry',
                 'compile budget exceeded: 3 compiled programs > declared '
                 'budget 2'):
        assert text in msg and text in jax_msg
    # Enforced before the step ran: the counter did not move.
    assert precond.steps == 2


def test_restore_refresh_is_exempt_from_the_budget(jax_guard):
    x, y = batch()
    precond, model = tiny_setup(compile_budget=3)
    for _ in range(5):
        step(precond, model, x, y)
    precond.load_state_dict(precond.state_dict())
    guard = precond.retrace_guard
    assert (guard.variants('restore_refresh'), guard.compiles) == (
        jax_guard['restore']) == (1, 4)
    step(precond, model, x, y)  # still within the step-variant budget


def test_strict_guard_raises_on_every_retry(jax_guard):
    x, y = batch()
    precond, model = tiny_setup()
    guard = precond.enable_retrace_guard(strict=True)
    for _ in range(5):
        step(precond, model, x, y)
    assert precond.steps % 2 == 1  # the next dispatch reuses 'plain'
    model.bfloat16()
    raised, msg = 0, ''
    for _ in range(3):
        try:
            step(precond, model, x.bfloat16(), y)
        except RetraceError as e:
            raised += 1
            msg = str(e)
    assert (raised, guard.retraces) == jax_guard['strict'] == (3, 1)
    assert precond.steps == 5
    # The bf16 drift is a dtype diff naming the drifted leaf, as in JAX.
    for text in ('dtype', 'float32', 'bfloat16', '[retrace]'):
        assert text in msg and text in jax_guard['strict_message']
    assert "['arg0']['grads']['linear1.weight']: dtype: " in msg


def test_guarded_steps_are_bitwise_the_unguarded_ones():
    x, y = batch()
    runs = []
    for guarded in (False, True):
        precond, model = tiny_setup(
            damping=lambda s: DAMPINGS[s % 3],
            compile_budget=8 if guarded else None)
        out = []
        for _ in range(6):
            loss = step(precond, model, x, y)
            out.append([loss] + [p.grad.clone() for p in model.parameters()])
        runs.append(out)
        if guarded:
            assert precond.retrace_guard.compiles == 3
            assert precond.retrace_guard.retraces == 0
        else:
            assert precond.retrace_guard is None
    for a, b in zip(*runs):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_detached_guard_gathers_nothing():
    x, y = batch()
    precond, model = tiny_setup()
    calls, keys = [], []
    precond._variant_inputs = lambda *a: calls.append(a)
    dispatch = precond._dispatch
    precond._dispatch = lambda key, run, inputs=None: (
        keys.append(key), dispatch(key, run, inputs))[1]
    for _ in range(3):
        step(precond, model, x, y)
    assert calls == []
    assert keys == [
        (True, True, None, None, False), (False, False, None, None, False),
        (True, False, None, None, False)]
    # Only the tail's hyperparameters are made on an unguarded step.
    assert set(precond._hyperparams()) == {'damping', 'lr', 'kl_clip'}


def test_report_lists_programs():
    x, y = batch()
    precond, model = tiny_setup(compile_budget=8)
    step(precond, model, x, y)
    report = precond.retrace_guard.report()
    assert 'key=' in report and '1 signature(s)' in report


ENGINES = {
    'default': {},
    'stagger 2': {'stagger_refresh': 2},
    'overlap': {'overlap_comm': True},
    'consistency': {'consistency': 'config'},
}


@pytest.mark.parametrize('name', list(ENGINES))
def test_engine_variants_match_jax(name):
    from kfac_pytorch_tpu import ConsistencyConfig as JaxConsistency

    kw = dict(ENGINES[name])
    jkw, tkw = dict(kw), dict(kw)
    if 'consistency' in kw:
        jkw['consistency'] = JaxConsistency()
        tkw['consistency'] = kt.ConsistencyConfig()
    jprecond = jax_tiny_setup(**jkw)[0]
    precond, _ = tiny_setup(**tkw)
    got = contracts.engine_variants(precond)
    assert got == jax_contracts.engine_variants(jprecond)
    assert [v[0] for v in got][:3] == ['plain', 'factor', 'inv']


# ----------------------------------------------------------------------
# trace contracts
# ----------------------------------------------------------------------


@pytest.mark.parametrize('name', list(ENGINES))
def test_every_variant_validates_on_fake_tensors(name):
    kw = dict(ENGINES[name])
    if 'consistency' in kw:
        kw['consistency'] = kt.ConsistencyConfig()
    precond, _ = tiny_setup(**kw)
    x, y = batch()
    sigs = contracts.validate_engine(precond, (x,), (y,),
                                     loss_fn=F.cross_entropy)
    assert list(sigs) == [v[0] for v in contracts.engine_variants(precond)]
    # Nothing ran on the real engine.
    assert precond.steps == 0 and precond._variants_run == set()


def test_replicated_and_inverse_configs_validate():
    x, y = batch()
    for kw in ({'bucketed': False}, {'compute_method': 'inverse'}):
        precond, _ = tiny_setup(**kw)
        sigs = contracts.validate_engine(precond, (x,), (y,),
                                         loss_fn=F.cross_entropy)
        assert set(sigs) == {'plain', 'factor', 'inv'}


def test_resnet50_validates_on_fake_tensors():
    from kfac_pytorch_tpu_torch.models.resnet import ResNet

    with FakeTensorMode():
        model = ResNet((3, 4, 6, 3), num_classes=1000)
        precond = kt.KFACPreconditioner(model, factor_update_steps=10,
                                        inv_update_steps=100)
        images = torch.empty(32, 3, 224, 224)
        labels = torch.zeros(32, dtype=torch.long)
    assert all(isinstance(p, FakeTensor) for p in model.parameters())
    assert len(precond.plan.buckets) == 21
    sigs = contracts.validate_engine(precond, (images,), (labels,),
                                     loss_fn=F.cross_entropy)
    assert set(sigs) == {'plain', 'factor', 'inv'}
    grads = {k: v for k, v in sigs['plain'].items()
             if k.startswith("['grads']")}
    assert len(grads) == len(list(model.parameters()))
    assert grads["['grads']['conv1.weight']"].shape == (64, 3, 7, 7)


def test_poisoned_layer_shape_is_named():
    precond, _ = tiny_setup()
    precond.layers['linear1'].a_factor = torch.zeros(7, 7)
    x, y = batch()
    with pytest.raises(contracts.ContractError) as ei:
        contracts.validate_engine(precond, (x,), (y,),
                                  loss_fn=F.cross_entropy)
    msg = str(ei.value)
    assert "'linear1'" in msg and 'A factor shape' in msg


def test_poisoned_layer_dtype_is_named():
    precond, _ = tiny_setup()
    st = precond.layers['linear2']
    st.a_factor = st.a_factor.bfloat16()
    x, y = batch()
    with pytest.raises(contracts.ContractError) as ei:
        contracts.validate_engine(precond, (x,), (y,),
                                  loss_fn=F.cross_entropy)
    msg = str(ei.value)
    assert "'linear2'" in msg and 'dtype torch.bfloat16' in msg


def test_state_fixpoint_names_the_leaf_path():
    x, y = batch()
    precond, model = tiny_setup()
    step(precond, model, x, y)
    key = precond.plan.buckets[0].key
    bs = precond.buckets[key]
    bs.qa = bs.qa.bfloat16()  # a refresh writes the f32 inv_dtype back
    with pytest.raises(contracts.ContractError) as ei:
        contracts.step_signatures(precond, (x,), (y,),
                                  loss_fn=F.cross_entropy)
    msg = str(ei.value)
    assert "step variant 'inv' is not signature-preserving" in msg
    assert f"['buckets']['{key}'].qa: dtype: bfloat16" in msg


def test_default_off_observe_matches_the_seed_trace():
    x, y = batch()
    seed, _ = tiny_setup()
    off, _ = tiny_setup(observe=ObserveConfig(monitor=False, annotate=False,
                                              timeline=False))
    a = contracts.step_signatures(seed, (x,), (y,), loss_fn=F.cross_entropy)
    b = contracts.step_signatures(off, (x,), (y,), loss_fn=F.cross_entropy)
    assert contracts.parity_diffs(a, b) == {}


def test_monitor_on_differs_from_the_seed_trace():
    x, y = batch()
    seed, _ = tiny_setup()
    mon, _ = tiny_setup(observe=ObserveConfig(monitor=True, annotate=False))
    a = contracts.step_signatures(seed, (x,), (y,), loss_fn=F.cross_entropy)
    b = contracts.step_signatures(mon, (x,), (y,), loss_fn=F.cross_entropy)
    diffs = contracts.parity_diffs(a, b)
    assert set(diffs) == {'plain', 'factor', 'inv'}
    assert 'observe' in diffs['plain']


def test_dry_run_leaves_the_real_engine_bitwise_untouched():
    x, y = batch()
    precond, model = tiny_setup(stagger_refresh=2, compile_budget=8)
    for _ in range(3):
        step(precond, model, x, y)
    sd = {k: v.clone() if isinstance(v, torch.Tensor) else v
          for k, v in precond.state_dict().items()}
    grads = [p.grad.clone() for p in model.parameters()]
    params = [p.detach().clone() for p in model.parameters()]
    hooks = [(len(m._forward_pre_hooks), len(m._forward_hooks))
             for m in model.modules()]
    buckets = {k: {f: t.clone() for f, t in bs.tensors().items()}
               for k, bs in precond.buckets.items()}
    compiles = precond.retrace_guard.compiles
    contracts.validate_engine(precond, (x,), (y,), loss_fn=F.cross_entropy)
    contracts.tail_graph_breaks(precond)
    assert precond.steps == 3
    assert precond.retrace_guard.compiles == compiles
    after = precond.state_dict()
    assert set(after) == set(sd)
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(after[k], v), k
    for a, b in zip(grads, [p.grad for p in model.parameters()]):
        assert torch.equal(a, b)
    for a, b in zip(params, model.parameters()):
        assert torch.equal(a, b)
    assert hooks == [(len(m._forward_pre_hooks), len(m._forward_hooks))
                     for m in model.modules()]
    for k, fields in buckets.items():
        for f, t in fields.items():
            assert torch.equal(precond.buckets[k].tensors()[f], t)
    # The hooks still file into the real engine, which steps on.
    step(precond, model, x, y)
    assert precond.steps == 4


@pytest.mark.parametrize('kw', [{}, {'stagger_refresh': 2},
                                {'compute_eigenvalue_outer_product': False}],
                         ids=['prediv', 'stagger', 'no-prediv'])
def test_precondition_tail_has_no_graph_break(kw):
    x, y = batch()
    precond, model = tiny_setup(**kw)
    step(precond, model, x, y)
    assert contracts.tail_graph_breaks(precond) == 0
