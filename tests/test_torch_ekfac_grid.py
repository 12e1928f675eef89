"""EKFAC on KAISA grids with several columns (HYBRID-OPT 2x2, MEM-OPT
1x4) against the JAX package's mesh run, on the CPU.

Four gloo ranks (subprocesses of this file, as
``tests/test_torch_distributed.py`` runs them) train LeNet on 16x16
images with ``ekfac=True``, each wrapped in DDP with 4 of the 16 rows,
while the parent runs the JAX ``KFACPreconditioner`` on a 4-device mesh
over the global batch from the same bridged weights.  Each side applies
its own SGD step (lr 0.1).  A rank holds its column's eigenbases and
scales; each refresh gathers every column's bases over the grid row, so
the rank projects the rows of every layer it captured.

Compared, at the EKFAC trajectory tolerance of
``tests/test_torch_ekfac.py`` (``1e-4``; each quantity lives in an
``eigh`` basis, which two LAPACK builds resolve differently inside
near-degenerate clusters):

* every step: the loss (the mean of the ranks' local losses), every
  preconditioned gradient (relative Frobenius), the scales of every
  layer of the rank's column (unpadded, relative Frobenius) and
  ``ekfac_divergence``, whose bits are the same on every rank;
* ``AdaptiveRefresh`` on the grid (inputs scaled up step by step, inv
  1000): the same refresh steps and drift bits on every rank, at JAX's
  steps;
* accumulation (``accumulation_steps=2``, HYBRID-OPT) against JAX's
  ``accumulate``/``finalize`` on the mesh;
* a state-dict round trip at ``cols > 1`` (taken after the refresh of
  step 2) resumes bitwise, and a JAX mesh checkpoint with its scales
  (taken at the same point) resumes in the port: the rank's column of
  the scales bitwise, the next step's gradients within ``1e-4``.

A spawn that outlives its time limit is killed and fails its tests.
"""
from __future__ import annotations

import contextlib
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

from kfac_pytorch_tpu_torch import AdaptiveRefresh  # noqa: E402
from kfac_pytorch_tpu_torch import DistributedStrategy  # noqa: E402
from kfac_pytorch_tpu_torch import KFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.models import LeNet  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

WORLD = 4
STEPS = 5
LR = 0.1
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR, ekfac=True)
STRATEGIES = ('HYBRID_OPT', 'MEM_OPT')
GRIDS = {'HYBRID_OPT': (2, 2), 'MEM_OPT': (1, 4)}
#: The EKFAC trajectory tolerance of ``tests/test_torch_ekfac.py``.
TOL = 1e-4
#: The checkpoint point: after steps 0-2, so the last refresh (step 2)
#: decomposed the saved factors.
CKPT_AT = 3
ADAPTIVE_STEPS = 8
ADAPTIVE = dict(threshold=0.15, min_interval=2)
ACCUM = 2
ACCUM_STEPS = 4
SPAWN_TIMEOUT_S = 240


def data(steps: int = 1, scale_up: bool = False):
    """Per step ``(x NHWC, y)`` of the global batch of 16: one batch
    repeated, or with ``scale_up`` step ``i``'s inputs times ``1 + i/2``
    so the scales drift."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((16, 16, 16, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(16,))
    return [((x * np.float32(1.0 + 0.5 * i)) if scale_up else x, y)
            for i in range(steps)]


def port_input(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# -- the ranks ----------------------------------------------------------------


def local(batch, rank, world):
    x, y = batch
    q = len(x) // world
    return (port_input(x[rank * q:(rank + 1) * q]),
            torch.from_numpy(y[rank * q:(rank + 1) * q]).long())


def column_scales(p) -> dict[str, torch.Tensor]:
    """The unpadded scales of every layer of this rank's column."""
    out = {}
    for b in p.plan.buckets:
        skron = p.buckets[b.key].skron
        for i, name in enumerate(p._second_order.local_slots(b)):
            if name is None:
                continue
            a, g = p._second_order._slot_dims[b.key]
            slot = p.plan.slot_of[name][1]
            out[name] = skron[i, :g[slot], :a[slot]].clone()
    return out


def step_record(p, model, loss) -> dict:
    mean = loss.detach().clone()
    dist.all_reduce(mean)
    div = p.last_ekfac_divergence
    return dict(
        loss=float(mean) / dist.get_world_size(),
        grads={n: q.grad.clone() for n, q in model.named_parameters()},
        scales=column_scales(p),
        div=None if div is None else div.clone(),
        refresh=p.last_refresh,
    )


def make(weights, strategy, **kw):
    model = LeNet(image_size=16)
    model.load_state_dict(weights, strict=True)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    p = KFACPreconditioner(
        ddp, grad_worker_fraction=DistributedStrategy[strategy],
        **dict(HP, **kw))
    return model, ddp, p


def train(model, ddp, p, batches, rank, world, accumulation=1, hook=None):
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    out = []
    for step, batch in enumerate(batches):
        if hook is not None:
            hook(step)
        opt.zero_grad()
        x, y = batch
        n = len(x) // accumulation
        losses = []
        for m in range(accumulation):
            xl, yl = local((x[m * n:(m + 1) * n], y[m * n:(m + 1) * n]),
                           rank, world)
            sync = m == accumulation - 1
            with (contextlib.nullcontext() if sync else ddp.no_sync()):
                loss = F.cross_entropy(ddp(xl), yl)
                (loss / accumulation).backward()
            losses.append(loss.detach())
        p.step()
        out.append(step_record(p, model, torch.stack(losses).mean()))
        opt.step()
    return out


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120),
    )
    weights = torch.load(out / 'init.pt')
    results = {}
    for strategy in STRATEGIES:
        model, ddp, p = make(weights, strategy)
        saved = {}

        def hook(step, p=p, model=model, saved=saved):
            if step == CKPT_AT:
                saved['sd'] = p.state_dict(include_ekfac_scales=True)
                saved['params'] = {k: v.clone()
                                   for k, v in model.state_dict().items()}

        steps = train(model, ddp, p, data(STEPS), rank, world, hook=hook)
        results[strategy] = dict(
            steps=steps, grid=(p.grid.rows, p.grid.cols),
            held={k: tuple(bs.skron.shape) for k, bs in p.buckets.items()},
            basis={k: tuple(bs.basis_qa.shape)
                   for k, bs in p.buckets.items()},
            full_scales={k: tuple(v.shape) for k, v in
                         saved['sd']['ekfac_scales'].items()},
        )
        # The round trip: a new preconditioner on the saved weights
        # resumes steps CKPT_AT.. bit for bit.  It takes the same DDP
        # wrapper, whose gradient buckets were rebuilt after its first
        # step: a new wrapper's first all-reduce sums in another layout,
        # which moves the averaged gradients in the last bit.
        p._capture.armed = False
        model.load_state_dict(saved['params'])
        p2 = KFACPreconditioner(
            ddp, grad_worker_fraction=DistributedStrategy[strategy], **HP)
        p2.load_state_dict(saved['sd'])
        again = train(model, ddp, p2, data(STEPS - CKPT_AT), rank, world)
        results[strategy, 'resume'] = all(
            all(torch.equal(a['grads'][n], b['grads'][n]) for n in a['grads'])
            and all(torch.equal(a['scales'][n], b['scales'][n])
                    for n in a['scales'])
            and torch.equal(a['div'], b['div'])
            for a, b in zip(steps[CKPT_AT:], again)
        )
    model, ddp, p = make(weights, 'HYBRID_OPT', inv_update_steps=1000,
                         adaptive_refresh=AdaptiveRefresh(**ADAPTIVE))
    steps = train(model, ddp, p, data(ADAPTIVE_STEPS, scale_up=True), rank,
                  world)
    results['adaptive'] = dict(
        refreshes=[s['refresh'] for s in steps],
        divs=[s['div'] for s in steps],
        triggers=p._adaptive_refresh.triggers,
    )
    model, ddp, p = make(weights, 'HYBRID_OPT', accumulation_steps=ACCUM)
    results['accum'] = train(model, ddp, p, data(ACCUM_STEPS), rank, world,
                             accumulation=ACCUM)
    # The JAX mesh checkpoint, written by the parent once its HYBRID-OPT
    # run has reached the checkpoint.
    ckpt = out / 'jax_ckpt.pt'
    deadline = time.time() + SPAWN_TIMEOUT_S
    while not ckpt.exists() and time.time() < deadline:
        time.sleep(0.2)
    time.sleep(0.5)  # let the writer finish
    jax_ckpt = torch.load(ckpt, weights_only=False)
    model, ddp, p = make(jax_ckpt['params'], 'HYBRID_OPT')
    p.load_state_dict(jax_ckpt['sd'])
    col = {k: bs.skron.clone() for k, bs in p.buckets.items()}
    results['jax_resume'] = dict(
        col=p.grid.col, skron=col,
        steps=train(model, ddp, p, data(1), rank, world),
    )
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


# -- the JAX mesh reference ------------------------------------------------


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """``(JAX mesh records, per-rank results)``; the parent runs the JAX
    mesh while the ranks train."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kfac_pytorch_tpu.adaptive import AdaptiveRefresh as JaxRefresh
    from kfac_pytorch_tpu.enums import DistributedStrategy as JaxStrategy
    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
    from kfac_pytorch_tpu_torch.convert import jax_kfac_state_dict_to_torch

    out = tmp_path_factory.mktemp('ekfac_grid')
    model = JaxLeNet()
    variables = jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(2), data()[0][0]))
    torch.save(flax_to_torch_state_dict(variables), out / 'init.pt')
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = spawn(out)

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ('data',))
    shard = NamedSharding(mesh, P('data'))

    def put(x, y):
        return (jax.device_put(x, shard),
                jax.device_put(jnp.asarray(y), shard))

    def jax_run(strategy, batches, accumulation=1, hook=None, **kw):
        precond = JaxPreconditioner(
            model, loss_fn=xent, mesh=mesh,
            grad_worker_fraction=JaxStrategy[strategy],
            accumulation_steps=accumulation, **dict(HP, **kw))
        state = precond.init(variables, batches[0][0])
        accum = precond.init_accum() if accumulation > 1 else None
        params = variables['params']
        steps = []
        for step, (x, y) in enumerate(batches):
            if hook is not None:
                hook(step, precond, state, params)
            if accumulation == 1:
                loss, _, grads, state = precond.step(
                    {'params': params}, state, *put(x, y)[:1],
                    loss_args=(put(x, y)[1],))
            else:
                n = len(x) // accumulation
                total, losses = None, []
                for m in range(accumulation):
                    xs, ys = put(x[m * n:(m + 1) * n], y[m * n:(m + 1) * n])
                    loss, _, g, accum = precond.accumulate(
                        {'params': params}, state, accum, xs,
                        loss_args=(ys,))
                    losses.append(float(loss))
                    total = g if total is None else jax.tree.map(
                        jnp.add, total, g)
                grads, state, accum = precond.finalize(
                    state, jax.tree.map(lambda g: g / accumulation, total),
                    accum)
                loss = np.mean(losses)
            grads = jax.tree.map(np.asarray, grads)
            params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
            info = precond.last_step_info
            steps.append(dict(
                loss=float(loss),
                grads=flax_to_torch_state_dict({'params': grads}),
                skron={k: np.asarray(bs.skron)
                       for k, bs in state.buckets.items()},
                div=(float(info['ekfac_divergence'])
                     if 'ekfac_divergence' in info else None),
            ))
        return precond, steps

    def write_ckpt(step, precond, state, params):
        if step != CKPT_AT:
            return
        sd = precond.state_dict(state, include_ekfac_scales=True)
        sd = jax_kfac_state_dict_to_torch(jax.tree.map(
            lambda v: np.asarray(v) if hasattr(v, 'shape') else v, sd))
        tmp = out / 'jax_ckpt.tmp'
        torch.save(dict(sd=sd, params=flax_to_torch_state_dict(
            {'params': jax.tree.map(np.asarray, params)})), tmp)
        tmp.rename(out / 'jax_ckpt.pt')

    ref = {}
    try:
        for strategy in STRATEGIES:
            precond, steps = jax_run(
                strategy, data(STEPS),
                hook=write_ckpt if strategy == 'HYBRID_OPT' else None)
            ref[strategy] = steps
            ref[strategy, 'plan'] = {
                b.key: (b.slots, b.a_pad, b.g_pad)
                for b in precond._second_order.plan.buckets
            }
        jar = JaxRefresh(**ADAPTIVE)
        _, steps = jax_run('HYBRID_OPT', data(ADAPTIVE_STEPS, scale_up=True),
                           inv_update_steps=1000, adaptive_refresh=jar)
        ref['adaptive'] = dict(divs=[s['div'] for s in steps],
                               triggers=jar.triggers,
                               last=jar.state_dict()['last_refresh'])
        _, ref['accum'] = jax_run('HYBRID_OPT', data(ACCUM_STEPS),
                                  accumulation=ACCUM)
    finally:
        join(procs, deadline)
    return ref, [torch.load(out / f'rank{r}.pt', weights_only=False)
                 for r in range(WORLD)]


def layer_dims(ref, strategy):
    """Layer name -> ``(bucket key, slot)`` of the JAX plan."""
    out = {}
    for key, (slots, _, _) in ref[strategy, 'plan'].items():
        for i, name in enumerate(slots):
            if name is not None:
                out[name.replace('/', '.')] = (key, i)
    return out


def check_steps(got_steps, want_steps, where, slot_of):
    assert len(got_steps) == len(want_steps)
    for step, (got, want) in enumerate(zip(got_steps, want_steps)):
        np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
        assert set(got['grads']) == set(want['grads'])
        for n, g in want['grads'].items():
            err = rel_err(got['grads'][n], g)
            assert err <= TOL, (where, step, n, err)
        assert got['scales'], (where, step)
        for name, s in got['scales'].items():
            key, slot = slot_of[name]
            w = want['skron'][key][slot][:s.shape[0], :s.shape[1]]
            err = rel_err(s, w)
            assert err <= TOL, (where, step, name, err)
        if want['div'] is None:
            assert got['div'] is None
        else:
            assert abs(float(got['div']) - want['div']) <= TOL * max(
                want['div'], 1e-3), (where, step)


@pytest.mark.parametrize('strategy', STRATEGIES)
def test_ekfac_grid_trajectory_matches_jax(runs, strategy):
    ref, ranks = runs
    slot_of = layer_dims(ref, strategy)
    covered = set()
    for rank, res in enumerate(ranks):
        r = res[strategy]
        assert r['grid'] == GRIDS[strategy]
        check_steps(r['steps'], ref[strategy], (rank, strategy), slot_of)
        covered |= set(r['steps'][0]['scales'])
    assert covered == set(slot_of)


@pytest.mark.parametrize('strategy', STRATEGIES)
def test_ekfac_grid_holds_column_scales_and_every_basis(runs, strategy):
    """Each rank keeps its column's ``seg`` slots of the scales, the
    bases of every occupied slot (no column's padding), and saves every
    slot of the scales."""
    ref, ranks = runs
    cols = GRIDS[strategy][1]
    for res in ranks:
        r = res[strategy]
        for key, (slots, a, g) in ref[strategy, 'plan'].items():
            assert r['held'][key] == (len(slots) // cols, g, a)
            occupied = sum(n is not None for n in slots)
            assert r['basis'][key] == (occupied, a, a)
            assert r['full_scales'][key] == (len(slots), g, a)


@pytest.mark.parametrize('strategy', STRATEGIES)
def test_ekfac_grid_divergence_is_bitwise_on_every_rank(runs, strategy):
    _, ranks = runs
    for step in range(STEPS):
        divs = [res[strategy]['steps'][step]['div'] for res in ranks]
        assert all(torch.equal(d, divs[0]) for d in divs), step


@pytest.mark.parametrize('strategy', STRATEGIES)
def test_ekfac_grid_state_dict_round_trip_resumes_bitwise(runs, strategy):
    _, ranks = runs
    for rank, res in enumerate(ranks):
        assert res[strategy, 'resume'], rank


def test_adaptive_refresh_decides_alike_on_every_rank(runs):
    ref, ranks = runs
    first = ranks[0]['adaptive']
    for res in ranks:
        got = res['adaptive']
        assert got['refreshes'] == first['refreshes']
        assert all(torch.equal(a, b)
                   for a, b in zip(got['divs'], first['divs']))
    want = ref['adaptive']
    assert first['triggers'] == want['triggers'] >= 1
    refreshed = [i for i, r in enumerate(first['refreshes']) if r]
    assert refreshed[0] == 0 and len(refreshed) == 1 + want['triggers']
    assert refreshed[-1] == want['last']
    got = [float(d) for d in first['divs']]
    np.testing.assert_allclose(got, want['divs'], rtol=TOL, atol=1e-7)


def test_ekfac_grid_accumulation_matches_jax_finalize(runs):
    ref, ranks = runs
    slot_of = layer_dims(ref, 'HYBRID_OPT')
    for rank, res in enumerate(ranks):
        check_steps(res['accum'], ref['accum'], (rank, 'accum'), slot_of)


def test_jax_mesh_checkpoint_resumes_on_the_grid(runs):
    ref, ranks = runs
    slot_of = layer_dims(ref, 'HYBRID_OPT')
    want = ref['HYBRID_OPT'][CKPT_AT]
    for rank, res in enumerate(ranks):
        r = res['jax_resume']
        # The saved scales are the step-(CKPT_AT - 1) ones, the refresh
        # seed of step 2: the rank's column of JAX's, bitwise.
        prev = ref['HYBRID_OPT'][CKPT_AT - 1]['skron']
        for key, skron in r['skron'].items():
            seg = skron.shape[0]
            np.testing.assert_array_equal(
                skron.numpy(), prev[key][r['col'] * seg:(r['col'] + 1) * seg])
        check_steps(r['steps'], [want], (rank, 'jax_resume'), slot_of)


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
