"""The port's ``GPTKFACPreconditioner`` and its ring GPT under K-FAC,
against the JAX package's, on the CPU.

Four gloo ranks (subprocesses of this file, no JAX) train ``gpt_tiny``
(vocab 256, 2 blocks, ``d_model`` 32) for three steps with SGD (lr 0.1),
factor 1, inv 2 (refreshes at 0 and 2), damping 0.003, kl-clip 0.001,
next-token cross entropy on ``[8, 16]`` tokens, from the JAX weights,
while the parent runs the JAX references:

* ``GPTKFACPreconditioner`` on a ``('data', 'model')`` grid of ``2 x 2``
  (the model's four dense layers a block tensor-parallel over
  ``'model'``, DDP over ``'data'``, MEM-OPT over the data extent)
  against JAX's on a ``(2, 2)`` mesh: the loss (``rtol 1e-5``), every
  layer's factors and every rank's preconditioned gradient slices each
  step (``1e-5`` relative Frobenius); once at the default
  (``compute_eigenvalue_outer_product=False``) and once with it on;
* the ring GPT under ``KFACPreconditioner`` and DDP, at a sequence world
  of 4 and at data 2 x sequence 2, against JAX's dense model's
  ``KFACPreconditioner`` step on the whole batch (the same tolerances):
  each rank holds ``[B/d, T/s]`` tokens, the targets are shifted before
  the sharding (the last position dropped), and each rank's loss is
  ``world * local CE sum / global count``, so DDP's mean is the global
  loss.

Then, in this process: the eigen-only ``ValueError``, per-layer factor
files written by JAX and read by the port and the reverse, and missing
files tolerated with identity seeding.
"""
from __future__ import annotations

import datetime
import logging
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
from torch.nn.parallel import DistributedDataParallel

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch import KFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict  # noqa
from kfac_pytorch_tpu_torch.convert import flax_to_tp_state_dict  # noqa
from kfac_pytorch_tpu_torch.gpt import GPTKFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.models import gpt_tiny  # noqa: E402
from kfac_pytorch_tpu_torch.models.gpt import shard_state_dict  # noqa
from kfac_pytorch_tpu_torch.ops import fused_precond  # noqa: E402
from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups  # noqa: E402
from kfac_pytorch_tpu_torch.parallel.ring_attention import \
    sequence_links  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

WORLD = 4
STEPS = 3
LR = 0.1
TOKENS = (8, 16)
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR)
TOL = 1e-5
#: label -> ``(n_data, n_seq)`` of the ring runs.
RING_GRIDS = {'seq4': (1, 4), 'data2_seq2': (2, 2)}
TP_PASSES = {'default': False, 'prediv': True}
SPAWN_TIMEOUT_S = 300


def batches():
    rng = np.random.default_rng(16)
    return rng.integers(0, 256, (STEPS,) + TOKENS).astype(np.int32)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def port_lm_loss(logits, tokens):
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


# -- the worker ranks (no JAX) ---------------------------------------------


def snapshot(precond, model, loss):
    return dict(
        loss=float(loss),
        factors={n: (st.a_factor.clone(), st.g_factor.clone())
                 for n, st in precond.layers.items()},
        grads={n: p.grad.clone() for n, p in model.named_parameters()})


def sgd(model):
    with torch.no_grad():
        for p in model.parameters():
            p -= LR * p.grad


def tp_run(variables, prediv):
    """``GPTKFACPreconditioner`` on the ``2 x 2`` grid, from the JAX
    weights carried across by ``flax_to_tp_state_dict``: per step the
    rank's local loss, the factors and its parameters' gradients; and
    the calls of the fused kernel's entry (its plain version here)."""
    mesh = axis_groups(2, 2, names=('data', 'model'))
    model = gpt_tiny(device='cpu', tp_group=mesh.group('model'))
    model.load_state_dict(flax_to_tp_state_dict(variables, mesh.inner, 2),
                          strict=True)
    ddp = DistributedDataParallel(model, process_group=mesh.group('data'))
    precond = GPTKFACPreconditioner(
        ddp, mesh=mesh, compute_eigenvalue_outer_product=prediv, **HP)
    assert (precond.grid.rows, precond.grid.cols) == (1, 2)
    rows = slice(4 * mesh.outer, 4 * mesh.outer + 4)
    trace, calls = [], []
    real = fused_precond.fused_eigen_precondition

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    fused_precond.fused_eigen_precondition = counted
    try:
        for tokens in batches():
            tokens = torch.from_numpy(tokens[rows]).long()
            model.zero_grad()
            loss = port_lm_loss(ddp(tokens), tokens)
            loss.backward()
            precond.step()
            trace.append(snapshot(precond, model, loss.detach()))
            sgd(model)
    finally:
        fused_precond.fused_eigen_precondition = real
    return dict(trace=trace, calls=calls)


def ring_run(weights, n_data, n_seq):
    """The ring GPT under ``KFACPreconditioner`` and DDP over the world:
    per step the rank's loss share, the factors and the gradients."""
    grid = axis_groups(n_data, n_seq, names=('data', 'seq'))
    links = sequence_links(grid, 'seq')
    model = gpt_tiny(device='cpu', attention_impl='ring', seq_axis='seq',
                     seq_links=links)
    model.load_state_dict(weights, strict=True)
    ddp = DistributedDataParallel(model)
    precond = KFACPreconditioner(ddp, **HP)
    B, T = TOKENS
    rows = slice(grid.outer * B // n_data, (grid.outer + 1) * B // n_data)
    t = T // n_seq
    cols = slice(links.index * t, (links.index + 1) * t)
    count = B * (T - 1)
    trace = []
    for tokens in batches():
        full = torch.from_numpy(tokens).long()
        # Targets shifted before the sharding; the last position has none.
        targets = torch.cat([full[:, 1:], torch.full((B, 1), -100)], 1)
        x, y = full[rows, cols], targets[rows, cols]
        model.zero_grad()
        logits = ddp(x)
        loss = dist.get_world_size() * F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.reshape(-1),
            ignore_index=-100, reduction='sum') / count
        loss.backward()
        precond.step()
        trace.append(snapshot(precond, model, loss.detach()))
        sgd(model)
    return trace


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init}', rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    weights = torch.load(out / 'init.pt')
    variables = torch.load(out / 'init_flax.pt', weights_only=False)
    res = {('tp', k): tp_run(variables, v) for k, v in TP_PASSES.items()}
    for label, (n_data, n_seq) in RING_GRIDS.items():
        res[('ring', label)] = ring_run(weights, n_data, n_seq)
    torch.save(res, out / f'rank{rank}.pt')
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


# -- the JAX references (parent only) --------------------------------------


def jax_lm_loss(logits, tokens):
    import jax
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(logits[:, :-1])
    return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], -1))


def jax_init():
    import flax.linen as fnn
    import jax

    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

    variables = fnn.meta.unbox(jax.jit(jax_gpt_tiny().init)(
        jax.random.PRNGKey(0), batches()[0]))
    return jax.tree.map(np.asarray, variables)


def tp_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2),
                ('data', 'model'))


def jax_trajectory(init, tp):
    """JAX's steps with SGD: ``GPTKFACPreconditioner`` on the ``(2, 2)``
    mesh (``tp``), or the dense ``KFACPreconditioner`` on the whole
    batch; per step the loss, the factors and the gradients by port
    name.  Returns the trace, the preconditioner and its state."""
    import flax.linen as fnn
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from kfac_pytorch_tpu.gpt import GPTKFACPreconditioner as JaxGPT
    from kfac_pytorch_tpu.models.gpt import DEFAULT_RULES
    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from kfac_pytorch_tpu.preconditioner import KFACPreconditioner as Jax
    from kfac_pytorch_tpu.utils.compat import set_mesh

    data = batches()
    if tp:
        mesh = tp_mesh()
        precond = JaxGPT(jax_gpt_tiny(), loss_fn=jax_lm_loss, mesh=mesh,
                         data_axes=('data',), **HP)
    else:
        precond = Jax(jax_gpt_tiny(), loss_fn=jax_lm_loss, **HP)
    state = precond.init(init, data[0])
    params = init['params']
    trace = []
    for tokens in data:
        if tp:
            ts = jax.device_put(tokens, NamedSharding(mesh, P('data')))
            with fnn.logical_axis_rules(DEFAULT_RULES), set_mesh(mesh):
                loss, _, grads, state = precond.step(
                    {'params': params}, state, ts, loss_args=(ts,))
        else:
            loss, _, grads, state = precond.step(
                {'params': params}, state, tokens, loss_args=(tokens,))
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        trace.append(dict(
            loss=float(loss),
            factors={base.replace('/', '.'): (
                np.asarray(state[base].a_factor),
                np.asarray(state[base].g_factor)) for base in state.layers},
            grads=flax_to_torch_state_dict({'params': grads})))
    return trace, precond, state


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """The JAX references and the four ranks' results."""
    out = tmp_path_factory.mktemp('gpt_precond')
    init = jax_init()
    weights = flax_to_torch_state_dict(init)
    torch.save(weights, out / 'init.pt')
    torch.save(init, out / 'init_flax.pt')
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = spawn(out)
    r = {'init': init}
    try:
        r['tp'], r['tp_precond'], r['tp_state'] = jax_trajectory(init, True)
        r['dense'] = jax_trajectory(init, False)[0]
    finally:
        join(procs, deadline)
    r['ranks'] = [torch.load(out / f'rank{k}.pt', weights_only=False)
                  for k in range(WORLD)]
    return r


def assert_step(got, want, what):
    assert abs(got['loss'] - want['loss']) <= TOL * abs(want['loss']), what
    assert set(got['factors']) == set(want['factors'])
    for name, pair in want['factors'].items():
        for side in (0, 1):
            err = rel_err(got['factors'][name][side], pair[side])
            assert err <= TOL, (what, name, side, err)
    assert set(got['grads']) == set(want['grads'])
    for name, g in want['grads'].items():
        err = rel_err(got['grads'][name], g)
        assert err <= TOL, (what, name, err)


@pytest.mark.parametrize('label', list(TP_PASSES))
@pytest.mark.parametrize('step', range(STEPS))
def test_tp_grid_matches_jax_mesh(ref, label, step):
    """Each rank against JAX's ``(2, 2)`` mesh: the loss (the mean of the
    two data ranks'), the full factors, and the rank's gradient slices
    (JAX's gradients sharded as the rank's model index holds them)."""
    want = ref['tp'][step]
    ranks = [r[('tp', label)]['trace'][step] for r in ref['ranks']]
    loss = float(np.mean([ranks[0]['loss'], ranks[2]['loss']]))
    for k, got in enumerate(ranks):
        mine = shard_state_dict(want['grads'], k % 2, 2)
        assert_step(dict(got, loss=loss), dict(want, grads=mine),
                    (label, step, k))


@pytest.mark.parametrize('label', list(RING_GRIDS))
@pytest.mark.parametrize('step', range(STEPS))
def test_ring_gpt_step_matches_jax_dense_step(ref, label, step):
    """Every rank against JAX's dense model on the whole batch: the loss
    (the sum of the ranks' shares over the world), the factors and the
    full gradients (DDP's mean)."""
    want = ref['dense'][step]
    ranks = [r[('ring', label)][step] for r in ref['ranks']]
    loss = float(np.mean([r['loss'] for r in ranks]))
    for k, got in enumerate(ranks):
        assert_step(dict(got, loss=loss), want, (label, step, k))


def test_tp_prediv_pass_runs_the_fused_entry(ref):
    """At the default no ``dgda`` is kept and the fused kernel's entry is
    never called, as in JAX; with ``compute_eigenvalue_outer_product``
    it runs every step on the rank's column of the buckets (MEM-OPT: one
    row of two columns)."""
    for r in ref['ranks']:
        assert r[('tp', 'default')]['calls'] == []
        calls = r[('tp', 'prediv')]['calls']
        assert calls and len(calls) % STEPS == 0


def test_eigen_only():
    with pytest.raises(ValueError, match='eigen'):
        GPTKFACPreconditioner(gpt_tiny(device='cpu'),
                              compute_method='inverse')


def test_data_axis_must_be_on_the_mesh():
    from kfac_pytorch_tpu_torch.parallel.mesh import AxisGroups

    with pytest.raises(ValueError, match='not in mesh axes'):
        GPTKFACPreconditioner(gpt_tiny(device='cpu'),
                              mesh=AxisGroups(1, 1, names=('dp', 'model')))


def port_after_one_step(init, tmp_path):
    """A one-process ``GPTKFACPreconditioner`` after one step on the
    first batch (factors are the whole batch's, as on the mesh)."""
    model = gpt_tiny(device='cpu')
    model.load_state_dict(flax_to_torch_state_dict(init))
    precond = GPTKFACPreconditioner(model, factor_checkpoint_dir=str(
        tmp_path), **HP)
    tokens = torch.from_numpy(batches()[0]).long()
    port_lm_loss(model(tokens), tokens).backward()
    precond.step()
    return precond


def test_jax_factor_files_load_in_the_port(ref, tmp_path):
    """JAX's ``save_factors`` after its three mesh steps; a fresh port
    preconditioner's ``load_factors`` takes its factors bit for bit and
    its step count, and refreshes from them."""
    jax_precond = ref['tp_precond']
    jax_precond.factor_checkpoint_dir = str(tmp_path)
    subdir = jax_precond.save_factors(ref['tp_state'])
    assert len(os.listdir(subdir)) == 8  # one file a Dense layer
    fresh = GPTKFACPreconditioner(gpt_tiny(device='cpu'), **HP)
    fresh.load_factors(subdir)
    assert fresh.steps == STEPS
    want = ref['tp'][-1]['factors']
    for name, st in fresh.layers.items():
        assert np.array_equal(st.a_factor.numpy(), want[name][0])
        assert np.array_equal(st.g_factor.numpy(), want[name][1])
        assert st.qa is None or torch.isfinite(st.qa).all()


def test_port_factor_files_load_in_jax(ref, tmp_path):
    """The port's ``save_factors`` (``step_1``) read by JAX's
    ``load_factors``: the same factors and step count."""
    import flax.linen as fnn
    import jax

    from kfac_pytorch_tpu.gpt import GPTKFACPreconditioner as JaxGPT
    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

    precond = port_after_one_step(ref['init'], tmp_path)
    subdir = precond.save_factors(step=1)
    assert subdir.endswith('step_1')
    fresh = JaxGPT(jax_gpt_tiny(), loss_fn=jax_lm_loss,
                   mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]),
                                          ('data',)),
                   factor_checkpoint_dir=str(tmp_path), **HP)
    with fnn.logical_axis_rules((('batch', 'data'),)):
        state = fresh.load_factors(fresh.init(ref['init'], batches()[0]),
                                   subdir, compute_inverses=False)
    assert fresh.steps == 1
    for base in state.layers:
        st = precond.layers[base.replace('/', '.')]
        assert np.array_equal(np.asarray(state[base].a_factor),
                              st.a_factor.numpy())
        assert np.array_equal(np.asarray(state[base].g_factor),
                              st.g_factor.numpy())


def test_missing_factor_files_tolerated(ref, tmp_path, caplog):
    """A missing file warns; when others load, that layer's still-zero
    factors are seeded with the identity and the refresh stays finite;
    with every file missing nothing changes."""
    subdir = port_after_one_step(ref['init'], tmp_path).save_factors()
    os.remove(os.path.join(subdir, 'h_1.mlp.fc_out.npz'))
    fresh = GPTKFACPreconditioner(gpt_tiny(device='cpu'), **HP)
    with caplog.at_level(logging.WARNING):
        fresh.load_factors(subdir)
    assert 'No factor checkpoint found for layer h_1.mlp.fc_out' in caplog.text
    st = fresh.layers['h_1.mlp.fc_out']
    assert torch.equal(st.a_factor, torch.eye(65))
    assert torch.equal(st.g_factor, torch.eye(32))
    assert fresh.steps == 1
    empty = GPTKFACPreconditioner(gpt_tiny(device='cpu'), **HP)
    empty.load_factors(str(tmp_path / 'nowhere'))
    assert empty.steps == 0
    assert not torch.any(empty.layers['h_0.attn.qkv'].a_factor)


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
