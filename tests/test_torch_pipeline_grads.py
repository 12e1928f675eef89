"""The port's pipelined gradient gather (``pipeline_grads=True``) against
its synchronous tail and against the JAX package's, on the CPU.

* ``make_pipeline_order`` equals JAX's on the same bucket plans: LeNet,
  ResNet-32 on one, two and four grid columns, ImageNet ResNet-50, and
  the mixed-width MLP ``(64, 64, 32, 32, 10)`` of JAX's own tests (three
  buckets, so the order is not the plan's).
* A gather's handle at world 1 is done and returns its inputs; the
  engine installs the order only with the option on; the option needs
  the bucketed stage (JAX's message); ``pipeline_grads=False`` is bitwise
  the engine without the option, and on one device the pipelined tail is
  bitwise the synchronous one; the bench's ``precond_tail`` stage runs.
* Four gloo ranks (subprocesses of this file, as
  ``tests/test_torch_distributed.py`` runs them), on the MLP under
  HYBRID-OPT (2x2) and MEM-OPT (1x4), each wrapped in DDP with 4 of the
  16 rows: gather-then-scale equals scale-then-gather bitwise on the
  rank's grid row, and the asynchronous gather equals the synchronous
  one; the pipelined tail equals the synchronous one bitwise (the
  preconditioned gradients, the kl-clip scale and the parameters after
  SGD, every step, every rank) for eigen with prediv, eigen without it,
  inverse, iterative, ``stagger_refresh=2`` and ``overlap_comm``; and on
  fixed weights the pipelined run matches JAX's 4-device mesh run with
  ``pipeline_grads=True`` within a relative Frobenius ``1e-5`` per layer
  and step.  The reference's own ``test_pipeline_grads.py::
  TestBitwiseParity::test_finalize_path_matches_step`` holds JAX's
  ``finalize`` against its ``step()`` bit for bit and fails there: the
  two compiled programs' factor EMAs differ in the last bit, which is no
  fault of the pipeline.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch import DistributedStrategy  # noqa: E402
from kfac_pytorch_tpu_torch import KFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.models import MLP  # noqa: E402
from kfac_pytorch_tpu_torch.parallel import bucketing  # noqa: E402
from kfac_pytorch_tpu_torch.parallel import collectives  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

WIDTHS = (64, 64, 32, 32, 10)
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=0.1)
STEPS = 5
#: The relative Frobenius bar of the comparison with JAX.
TOL = 1e-5
WORLD = 4
STRATEGIES = ('HYBRID_OPT', 'MEM_OPT')
VARIANTS = {
    'eigen': {},
    'eigen_noprediv': dict(compute_eigenvalue_outer_product=False),
    'inverse': dict(compute_method='inverse'),
    'iterative': dict(compute_method='iterative'),
    'stagger': dict(inv_update_steps=4, stagger_refresh=2),
    'overlap': dict(overlap_comm=True),
}
SPAWN_TIMEOUT_S = 180


def data():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    return x, rng.integers(0, 10, size=(16,))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# -- the issue order ---------------------------------------------------------


def _jax_helpers(model, x, **kw):
    import jax

    from kfac_pytorch_tpu.capture import ModelCapture as JaxCapture

    variables = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, **kw))
    cap = JaxCapture(model)
    if kw:
        kw = dict(kw, mutable=['batch_stats'])
    specs = cap.register(variables, x, **kw)
    return {'/'.join(s.helper.path): s.helper for s in specs.values()}


@pytest.mark.parametrize('name,n_cols', [
    ('mlp', 1), ('mlp', 2), ('lenet', 1), ('resnet32', 1), ('resnet32', 2),
    ('resnet32', 4), ('resnet50', 1),
])
def test_pipeline_order_matches_jax(name, n_cols):
    import jax.numpy as jnp

    from kfac_pytorch_tpu.models import resnet32 as jax_resnet32
    from kfac_pytorch_tpu.models.resnet import resnet50 as jax_resnet50
    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
    from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
    from kfac_pytorch_tpu.parallel import bucketing as jax_bucketing
    from kfac_pytorch_tpu_torch.capture import ModelCapture
    from kfac_pytorch_tpu_torch.models import LeNet
    from kfac_pytorch_tpu_torch.models import resnet32
    from kfac_pytorch_tpu_torch.models import resnet50

    cnn = dict(train=True)
    jax_model, x, kw, port_model = {
        'mlp': (JaxMLP(features=WIDTHS), jnp.zeros((2, 64)), {},
                lambda: MLP(64, WIDTHS)),
        'lenet': (JaxLeNet(), jnp.zeros((2, 28, 28, 1)), {}, LeNet),
        'resnet32': (jax_resnet32(num_classes=10), jnp.zeros((2, 32, 32, 3)),
                     cnn, lambda: resnet32(device='cpu')),
        'resnet50': (jax_resnet50(num_classes=1000),
                     jnp.zeros((1, 32, 32, 3)), cnn,
                     lambda: resnet50(device='cpu')),
    }[name]
    jplan = jax_bucketing.make_bucket_plan(
        _jax_helpers(jax_model, x, **kw), n_cols=n_cols)
    helpers = ModelCapture(port_model()).helpers
    pplan = bucketing.make_bucket_plan(
        {n: h for n, h in helpers.items() if not h.diagonal_a},
        n_cols=n_cols)
    want = jax_bucketing.make_pipeline_order(jplan)
    got = bucketing.make_pipeline_order(pplan)
    assert got == want
    payload = {b.key: b.n_slots * b.g_pad * b.a_pad for b in pplan.buckets}
    assert [payload[k] for k in got] == sorted(payload.values(),
                                               reverse=True)
    if name == 'mlp':
        assert got == ('a128g64', 'a128g32', 'a64g32')
    if name == 'resnet50':
        assert got[:3] == ('a4608g512', 'a2304g256', 'a512g2048')
        assert got[-1] == 'a64g64'


# -- one process -----------------------------------------------------------


def test_handles_at_world_one_are_done():
    pg, clip = torch.randn(2, 3, 4), torch.randn(2)
    got = collectives.all_gather_preconditioned_async(pg, clip, None).wait()
    assert got[0] is pg and got[1] is clip
    stacks = [torch.randn(2, 2), torch.randn(3)]
    assert collectives.all_gather_stacks_async(stacks, None).wait() == stacks


def test_validation_matches_jax():
    from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    with pytest.raises(ValueError, match='bucketed') as want:
        JaxPreconditioner(JaxMLP(features=WIDTHS), loss_fn=None,
                          pipeline_grads=True, bucketed=False)
    with pytest.raises(ValueError, match='bucketed') as got:
        KFACPreconditioner(MLP(64, WIDTHS), pipeline_grads=True,
                           bucketed=False)
    assert str(got.value) == str(want.value)
    on = KFACPreconditioner(MLP(64, WIDTHS), pipeline_grads=True)
    assert on._second_order.pipeline_order == ('a128g64', 'a128g32',
                                               'a64g32')
    assert KFACPreconditioner(MLP(64, WIDTHS))._second_order \
        .pipeline_order is None


def one_device_run(**kw):
    torch.manual_seed(4)
    model = MLP(64, WIDTHS)
    x, y = data()
    x, y = torch.from_numpy(x), torch.from_numpy(y).long()
    p = KFACPreconditioner(model, **dict(HP, **kw))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    out = []
    for _ in range(STEPS):
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        p.step()
        out.append(({n: q.grad.clone() for n, q in model.named_parameters()},
                    p.last_kl_scale.clone()))
        opt.step()
    return out


@pytest.mark.parametrize('kw', [dict(pipeline_grads=True),
                                dict(pipeline_grads=False)],
                         ids=['pipelined', 'off'])
def test_one_device_tail_is_bitwise(kw):
    want = one_device_run()
    got = one_device_run(**kw)
    for (wg, ws), (gg, gs) in zip(want, got):
        assert torch.equal(ws, gs)
        for n, g in wg.items():
            assert torch.equal(gg[n], g)


def test_bench_precond_tail_on_the_cpu(monkeypatch):
    """The bench's ``precond_tail`` stage (JAX ``measure_precond_tail``)
    at two calls a repeat: its keys, the MLP's three buckets and their
    issue order, finite times."""
    import functools

    from kfac_pytorch_tpu_torch import bench

    monkeypatch.setitem(bench.STAGES, 'precond_tail', functools.partial(
        bench.measure_precond_tail, iters=2, repeats=2))
    d = bench.run(['precond_tail'], 'cpu')['detail']['precond_tail']
    assert d['bucket_shapes'] == [[2, 128, 64], [1, 128, 32], [2, 64, 32]]
    assert d['issue_order'] == ['a128g64', 'a128g32', 'a64g32']
    assert d['config'].endswith('world 1 (one rank)')
    assert d['sync_ms'] > 0 and d['pipelined_ms'] > 0
    assert np.isfinite(d['pipelined_over_sync'])


# -- four gloo ranks ----------------------------------------------------------


def rank_run(rank, world, weights, strategy, train=True, **kw):
    x, y = data()
    q = len(x) // world
    xl = torch.from_numpy(x[rank * q:(rank + 1) * q])
    yl = torch.from_numpy(y[rank * q:(rank + 1) * q]).long()
    model = MLP(64, WIDTHS)
    model.load_state_dict(weights)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    p = KFACPreconditioner(
        ddp, grad_worker_fraction=DistributedStrategy[strategy],
        **dict(HP, **kw))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    out = []
    for _ in range(STEPS if train else 3):
        opt.zero_grad()
        F.cross_entropy(ddp(xl), yl).backward()
        p.step()
        out.append(dict(
            grads={n: q.grad.clone() for n, q in model.named_parameters()},
            scale=p.last_kl_scale.clone(), refresh=p.last_refresh,
        ))
        if train:
            opt.step()
            out[-1]['params'] = [q.detach().clone()
                                 for q in model.parameters()]
    p.join_deferred_refresh()
    return p, out


def commutation(p):
    """On this rank's grid row: gather-then-scale against
    scale-then-gather, and the asynchronous gather against the
    synchronous one, bitwise."""
    row = p.grid.row_group
    gen = torch.Generator().manual_seed(100 + dist.get_rank())
    pg = torch.randn(3, 32, 64, generator=gen)
    clip = torch.randn(3, generator=gen)
    s = torch.tensor(0.37)
    a, ca = collectives.all_gather_preconditioned(pg, clip, row)
    b, cb = collectives.all_gather_preconditioned(pg * s, clip, row)
    c, cc = collectives.all_gather_preconditioned_async(pg, clip, row).wait()
    return (torch.equal(a * s, b) and torch.equal(a, c)
            and torch.equal(ca, cc) and torch.equal(ca, cb)
            and a.shape[0] == 3 * p.grid.cols)


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    weights = torch.load(out / 'init.pt')
    results = {}
    for strategy in STRATEGIES:
        for variant, kw in VARIANTS.items():
            _, sync = rank_run(rank, world, weights, strategy, **kw)
            p, pipe = rank_run(rank, world, weights, strategy,
                               pipeline_grads=True, **kw)
            bad = []
            for t, (s, q) in enumerate(zip(sync, pipe)):
                same = (torch.equal(s['scale'], q['scale'])
                        and s['refresh'] == q['refresh']
                        and all(torch.equal(s['grads'][n], q['grads'][n])
                                for n in s['grads'])
                        and all(torch.equal(a, b) for a, b in
                                zip(s['params'], q['params'])))
                if not same:
                    bad.append(t)
            results[strategy, variant] = dict(
                bad=bad, refreshes=[s['refresh'] for s in sync],
                order=p._second_order.pipeline_order, grid=(p.grid.rows,
                                                            p.grid.cols))
        p, fixed = rank_run(rank, world, weights, strategy, train=False,
                            pipeline_grads=True)
        results[strategy, 'fixed'] = [s['grads'] for s in fixed]
        results[strategy, 'commutes'] = commutation(p)
        results[strategy, 'order'] = p._second_order.pipeline_order
    torch.save(results, out / f'rank{rank}.pt')
    dist.destroy_process_group()


def spawn(out: Path) -> list[subprocess.Popen]:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    return [
        subprocess.Popen(
            [sys.executable, __file__, '--worker', str(rank), str(WORLD),
             str(out / 'pg_init'), str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(WORLD)
    ]


def join(procs, deadline) -> None:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail('worker ranks timed out and were killed')
    bad = [(i, p.returncode, log[-3000:])
           for i, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        pytest.fail(f'worker ranks failed: {bad}')


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """``(JAX mesh gradients per strategy, per-rank results)``; the
    parent runs the JAX mesh while the ranks train."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kfac_pytorch_tpu.enums import DistributedStrategy as JaxStrategy
    from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    out = tmp_path_factory.mktemp('pipeline')
    model = JaxMLP(features=WIDTHS)
    x, y = data()
    variables = jax.tree.map(np.asarray,
                             model.init(jax.random.PRNGKey(2), x))
    torch.save(flax_to_torch_state_dict(variables), out / 'init.pt')
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = spawn(out)

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ('data',))
    shard = NamedSharding(mesh, P('data'))
    ref = {}
    try:
        for strategy in STRATEGIES:
            precond = JaxPreconditioner(
                model, loss_fn=xent, mesh=mesh, pipeline_grads=True,
                grad_worker_fraction=JaxStrategy[strategy], **HP,
            )
            state = precond.init(variables, x)
            xs = jax.device_put(x, shard)
            ys = jax.device_put(jnp.asarray(y), shard)
            grads = []
            for _ in range(3):
                _, _, g, state = precond.step(variables, state, xs,
                                              loss_args=(ys,))
                grads.append(flax_to_torch_state_dict(
                    {'params': jax.tree.map(np.asarray, g)}))
            ref[strategy] = (grads, precond._second_order.pipeline_order)
    finally:
        join(procs, deadline)
    return ref, [torch.load(out / f'rank{r}.pt') for r in range(WORLD)]


@pytest.mark.parametrize('strategy', STRATEGIES)
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_pipelined_tail_is_bitwise_across_ranks(ranks, strategy, variant):
    _, results = ranks
    for rank, res in enumerate(results):
        r = res[strategy, variant]
        assert r['bad'] == [], (rank, r)
        assert r['order'] == ('a128g64', 'a128g32', 'a64g32')
        assert r['grid'] == ((2, 2) if strategy == 'HYBRID_OPT' else (1, 4))
    refreshes = results[0][strategy, variant]['refreshes']
    if variant == 'overlap':
        assert refreshes == ['full', None, None, 'overlap_inv', None]
    elif variant == 'stagger':
        assert refreshes == ['full', 1, None, None, 0]


@pytest.mark.parametrize('strategy', STRATEGIES)
def test_pipelined_mesh_run_matches_jax(ranks, strategy):
    ref, results = ranks
    want, order = ref[strategy]
    for rank, res in enumerate(results):
        assert res[strategy, 'commutes'], rank
        assert res[strategy, 'order'] == order
        for step, (w, g) in enumerate(zip(want, res[strategy, 'fixed'])):
            for name, grad in w.items():
                err = rel_err(g[name], grad)
                assert err <= TOL, (rank, step, name, err)


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
