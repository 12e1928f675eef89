"""The port's MoE model and ``MoEKFACPreconditioner`` against the JAX
package's, on the CPU.

The JAX test harness ``TinyMoEModel`` (``tests/test_moe.py:21``) at
``E = 4, d_model 16, d_ff 32`` and the port's, with the same numpy
inputs and the JAX weights carried across by ``convert.py``:

* the forward and the aux loss; the dispatch buffers (``xin``, the
  slots) with capacity for every token and with overflow
  (``capacity_factor 0.5``); ``probe_shapes``;
* the registration, the stacked factors and the preconditioned gradients
  after each of three SGD steps (``rtol 1e-5``, relative Frobenius);
  low-rank (``lowrank_rank=4``, the JAX sketches injected through
  ``ops.lowrank.draw_sketch``) and EKFAC on the stacks; the batch
  accumulated twice against JAX's plain step; a JAX state dict resumed
  in the port; the port's own round trip, packed; ``memory_usage``;
  ``train_loop`` against ``step``;
* four gloo ranks (subprocesses of this file) on the expert-sharded
  grids ``1 x 4`` (``X = 4``) and ``2 x 2`` (data x expert), two steps
  each, against JAX's ``('data', 'expert')`` mesh of the same shape:
  loss, each rank's factor and gradient slices.
"""
from __future__ import annotations

import datetime
import functools
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

from kfac_pytorch_tpu_torch.convert import shard_experts  # noqa: E402
from kfac_pytorch_tpu_torch.gpt import MoEKFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.models import moe as port_moe  # noqa: E402
from kfac_pytorch_tpu_torch.ops import lowrank  # noqa: E402
from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

E, D_MODEL, D_FF, IN, CLASSES = 4, 16, 32, 12, 8
HP = dict(factor_update_steps=1, inv_update_steps=1, damping=0.003, lr=0.1)
STEPS = 3
SGD_LR = 0.1
TOL = 1e-5
WORLD = 4
GRIDS = ((1, 4), (2, 2))  # (data, expert)
MESH_STEPS = 2
SPAWN_TIMEOUT_S = 180


def data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 6, IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, 8).astype(np.int32)
    return x, y


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def xent(out, labels):
    logits, aux = out
    return F.cross_entropy(logits, labels.long()) + 0.01 * aux


def port_model(weights, cf=1.25, expert_group=None, data_group=None):
    cfg = port_moe.MoEConfig(n_experts=E, d_model=D_MODEL, d_ff=D_FF,
                             capacity_factor=cf)
    model = port_moe.TinyMoEModel(cfg, IN, CLASSES, expert_group,
                                  data_group)
    X = E // model.moe.local_experts
    model.load_state_dict(shard_experts(
        weights, E, X, model.moe.expert_offset // model.moe.local_experts))
    return model


def grads_of(model) -> dict[str, torch.Tensor]:
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def factors_of(precond) -> dict[str, tuple]:
    return {n: (st.a_factor.clone(), st.g_factor.clone())
            for n, st in precond.layers.items()}


def sgd(model) -> None:
    with torch.no_grad():
        for p in model.parameters():
            p -= SGD_LR * p.grad


def port_run(weights, x, y, steps=STEPS, **kw):
    model = port_model(weights)
    precond = MoEKFACPreconditioner(model, xent, **HP, **kw)
    out = []
    for _ in range(steps):
        loss = precond.step(t(x), loss_args=(t(y),))
        out.append(dict(loss=float(loss), grads=grads_of(model),
                        factors=factors_of(precond)))
        sgd(model)
    return out, precond


# -- the JAX side ------------------------------------------------------


def jax_flavour_draw(seed, side, step, slot, n, m, device='cpu'):
    """The JAX MoE and pipeline flavours' sketch for one slot
    (``gpt/moe.py:698-707``, ``ops/lowrank.py:228-242``): the layer key
    ``PRNGKey(2 li + side)`` folded with the step, then with the slot for
    a stacked layer (an unstacked one, slot ``-1``, uses it as is)."""
    import jax
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    if slot >= 0:
        key = jax.random.fold_in(key, slot)
    return t(np.asarray(jax.random.normal(key, (n, m), jnp.float32))).to(
        device)


@functools.lru_cache(maxsize=None)
def jax_variables():
    """The JAX model's weights (capacity does not change them).  Params
    only: ``init`` also returns the sown ``moe_capture`` collection, and
    JAX's flavour reads the first sown value (``gpt/moe.py:342``), so
    passing it would feed the factors the init batch's ``xin``
    (ROADMAP.md Queue C)."""
    import flax.linen as nn
    import jax

    model, _ = jax_model()
    x, _ = data()
    return {'params': jax.tree.map(np.asarray, nn.meta.unbox(
        jax.jit(model.init)(jax.random.PRNGKey(2), x))['params'])}


def jax_model(cf=1.25):
    from kfac_pytorch_tpu.models.moe import MoEConfig
    from test_moe import TinyMoEModel
    from test_moe import xent as jax_xent

    cfg = MoEConfig(n_experts=E, d_model=D_MODEL, d_ff=D_FF,
                    capacity_factor=cf)
    return TinyMoEModel(moe=cfg), jax_xent


def jax_setup(cf=1.25, mesh=None, **kw):
    from kfac_pytorch_tpu.gpt.moe import MoEKFACPreconditioner as JaxMoE

    model, loss = jax_model(cf)
    precond = JaxMoE(model, loss, mesh=mesh, **HP, **kw)
    return model, jax_variables(), precond


def to_torch(tree) -> dict[str, torch.Tensor]:
    import jax

    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    return flax_to_torch_state_dict(
        {'params': jax.tree.map(np.asarray, tree)})


def jax_factors(state) -> dict[str, tuple]:
    return {n.replace('/', '.'): (t(st.a_factor), t(st.g_factor))
            for n, st in state.items()}


def jax_run(steps=STEPS, **kw):
    import jax

    _, variables, precond = jax_setup(**kw)
    x, y = data()
    state = precond.init(variables, x)
    out = []
    for _ in range(steps):
        loss, grads, state = precond.step(variables, state, x,
                                          loss_args=(y,))
        out.append(dict(loss=float(loss), grads=to_torch(grads),
                        factors=jax_factors(state), variables=variables,
                        sd=precond.state_dict(state,
                                              compress_symmetric=True)))
        variables = {'params': jax.tree.map(
            lambda p, g: p - SGD_LR * np.asarray(g), variables['params'],
            grads)}
    return out, precond, state


def jax_mesh_run(n_data, n_expert):
    import flax.linen as nn
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kfac_pytorch_tpu.utils.compat import set_mesh

    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(n_data, n_expert),
                ('data', 'expert'))
    x, y = data()
    out = []
    with nn.logical_axis_rules((('expert', 'expert'),)), set_mesh(mesh):
        _, variables, precond = jax_setup(mesh=mesh)
        state = precond.init(variables, x)
        xs = jax.device_put(x, NamedSharding(mesh, P('data')))
        for _ in range(MESH_STEPS):
            loss, grads, state = precond.step(variables, state, xs,
                                              loss_args=(y,))
            out.append(dict(loss=float(loss), grads=to_torch(grads),
                            factors=jax_factors(state)))
            variables = {'params': jax.tree.map(
                lambda p, g: p - SGD_LR * g, variables['params'], grads)}
    return out


# -- the four ranks ----------------------------------------------------


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    weights = torch.load(out / 'init.pt')
    x, y = data()
    results = {}
    for n_data, n_expert in GRIDS:
        grid = axis_groups(n_data, n_expert)
        model = port_model(weights, expert_group=grid.inner_group,
                           data_group=grid.outer_group)
        precond = MoEKFACPreconditioner(model, xent, **HP)
        rows = slice(grid.outer * 8 // n_data, (grid.outer + 1) * 8 // n_data)
        steps = []
        for _ in range(MESH_STEPS):
            loss = precond.step(t(x[rows]), loss_args=(t(y[rows]),))
            steps.append(dict(loss=float(loss), grads=grads_of(model),
                              factors=factors_of(precond)))
            sgd(model)
        results[n_data, n_expert] = dict(
            steps=steps, offset=model.moe.expert_offset,
            local=model.moe.local_experts,
            sd=precond.state_dict(compress_symmetric=True))
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
def ref(tmp_path_factory):
    """Every JAX reference of this file, computed once while the four
    ranks run; ``ref['ranks']`` holds the ranks' results."""
    out = tmp_path_factory.mktemp('moe')
    _, variables, _ = jax_setup()
    weights = to_torch(variables['params'])
    torch.save(weights, out / 'init.pt')
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = spawn(out)
    r = {'weights': weights}
    try:
        r['main'], r['precond'], r['state'] = jax_run()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lowrank, 'draw_sketch', jax_flavour_draw)
            r['lowrank'] = jax_run(2, lowrank_rank=4,
                                   lowrank_oversample=4)[0]
        r['ekfac'] = jax_run(2, ekfac=True)[0]
        r['mesh'] = {g: jax_mesh_run(*g) for g in GRIDS}
    finally:
        join(procs, deadline)
    r['ranks'] = [torch.load(out / f'rank{k}.pt') for k in range(WORLD)]
    return r


def assert_close(got: dict, want: dict, rows=None, what='') -> None:
    assert set(got) >= set(want), (what, sorted(set(want) - set(got)))
    for name, w in want.items():
        if rows is not None and name.rsplit('.', 1)[-1] in (
                'w_in', 'b_in', 'w_out', 'b_out'):
            w = w[rows]
        err = rel_err(got[name], w)
        assert err <= TOL, (what, name, err)


def assert_factors(got: dict, want: dict, rows=None, what='') -> None:
    assert set(got) == set(want), what
    for name, (a, g) in want.items():
        if '::' in name:
            a, g = (a, g) if rows is None else (a[rows], g[rows])
        else:
            a, g = a[None], g[None]
        for side, x, w in (('A', got[name][0], a), ('G', got[name][1], g)):
            err = rel_err(x, w)
            assert err <= TOL, (what, name, side, err)


# -- the model ---------------------------------------------------------


@pytest.mark.parametrize('cf', [1.25, 0.5])
def test_forward_aux_and_dispatch_match_jax(ref, cf):
    """Outputs, aux and the dispatched ``xin`` (slots in the cumsum
    order; at ``cf = 0.5`` tokens overflow and are dropped)."""
    import jax

    from kfac_pytorch_tpu.models.moe import MOE_COLLECTION

    model, variables, _ = jax_setup(cf=cf)
    x, _ = data()
    (logits, aux), mut = jax.jit(
        lambda v, x: model.apply(v, x, mutable=[MOE_COLLECTION]))(
            variables, x)
    xin = np.asarray(jax.tree.leaves(mut[MOE_COLLECTION])[0])
    port = port_model(ref['weights'], cf=cf)
    seen = {}
    port.moe.kfac_capture = (
        lambda m, sub, a, b: seen.setdefault(sub, a.detach()))
    got_logits, got_aux = port(t(x))
    np.testing.assert_allclose(got_logits.detach(), logits, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(got_aux.detach()), float(aux),
                               rtol=1e-6)
    assert tuple(seen['fc_in'].shape) == xin.shape
    np.testing.assert_array_equal(seen['fc_in'].numpy() != 0, xin != 0)
    np.testing.assert_allclose(seen['fc_in'], xin, rtol=1e-5, atol=1e-6)
    kept = int((np.abs(xin).sum(-1) > 0).sum())
    assert (kept < 48) == (cf < 1.0), kept


def test_probe_shapes_match_jax():
    from kfac_pytorch_tpu.models.moe import MoEConfig, MoEMLP

    for n in (16, 48, 100):
        cfg = MoEConfig(n_experts=E, d_model=D_MODEL, d_ff=D_FF)
        want = {k: s for k, (s, _) in MoEMLP.probe_shapes(cfg, n).items()}
        pcfg = port_moe.MoEConfig(n_experts=E, d_model=D_MODEL, d_ff=D_FF)
        got = {k: s for k, (s, _) in port_moe.probe_shapes(pcfg, n).items()}
        assert got == want


def test_registration_matches_jax(ref):
    precond, state = ref['precond'], ref['state']
    port = MoEKFACPreconditioner(port_model(ref['weights']), xent, **HP)
    assert set(port.layers) == {n.replace('/', '.') for n in state}
    for name, st in state.items():
        got = port.layers[name.replace('/', '.')]
        lead = () if st.a_factor.ndim == 3 else (1,)
        assert tuple(got.a_factor.shape) == lead + st.a_factor.shape
        assert tuple(got.dgda.shape) == lead + st.dgda.shape
    assert port.memory_usage() == precond.memory_usage(state)


# -- the preconditioner ------------------------------------------------


@pytest.fixture(scope='module')
def main_port(ref):
    x, y = data()
    return port_run(ref['weights'], x, y)[0]


@pytest.mark.parametrize('step', range(STEPS))
def test_trajectory_matches_jax(ref, main_port, step):
    """Loss, stacked factors and preconditioned gradients, each step."""
    got, want = main_port[step], ref['main'][step]
    assert abs(got['loss'] - want['loss']) <= TOL * abs(want['loss'])
    assert_factors(got['factors'], want['factors'], what=step)
    assert_close(got['grads'], want['grads'], what=step)


@pytest.mark.parametrize('variant', ['lowrank', 'ekfac'])
def test_variants_on_stacks_match_jax(ref, monkeypatch, variant):
    x, y = data()
    kw = (dict(lowrank_rank=4, lowrank_oversample=4) if variant == 'lowrank'
          else dict(ekfac=True))
    monkeypatch.setattr(lowrank, 'draw_sketch', jax_flavour_draw)
    got, precond = port_run(ref['weights'], x, y, steps=2, **kw)
    st = precond.layers['moe::fc_in']
    if variant == 'lowrank':
        assert tuple(st.qa.shape) == (E, D_MODEL + 1, 4) and st.dgda is None
    else:
        assert st.skron is not None and st.dgda is None
        assert torch.isfinite(precond.last_step_info['ekfac_divergence'])
    for step, want in enumerate(ref[variant]):
        assert_factors(got[step]['factors'], want['factors'], what=step)
        assert_close(got[step]['grads'], want['grads'], what=step)


def test_accumulation_matches_plain_step(ref):
    """The batch twice through ``accumulate`` and ``finalize`` is JAX's
    plain step on it (JAX's ``test_accumulate_finalize_matches_step``):
    each micro-batch's factors come from its own loss, the gradients are
    the micro-batches' average."""
    x, y = data()
    model = port_model(ref['weights'])
    port = MoEKFACPreconditioner(model, xent, accumulation_steps=2, **HP)
    model.zero_grad()
    for _ in range(2):
        port.accumulate(t(x), loss_args=(t(y),))
    port.finalize()
    want = ref['main'][0]
    assert_factors(factors_of(port), want['factors'])
    assert_close(grads_of(model), want['grads'])


def test_jax_state_dict_resumes_in_port(ref):
    """JAX's checkpoint after step 1 (packed) loads into a fresh port
    preconditioner on the step-1 weights; its step 2 is JAX's."""
    from kfac_pytorch_tpu_torch.convert import jax_kfac_state_dict_to_torch

    x, y = data()
    sd = jax_kfac_state_dict_to_torch(ref['main'][0]['sd'])
    want = ref['main'][1]
    model = port_model(to_torch(want['variables']['params']))
    port = MoEKFACPreconditioner(model, xent, **HP)
    port.load_state_dict(sd)
    assert port.steps == 1
    port.step(t(x), loss_args=(t(y),))
    assert_factors(factors_of(port), want['factors'])
    assert_close(grads_of(model), want['grads'])


def test_port_state_dict_roundtrip(ref):
    x, y = data()
    _, precond = port_run(ref['weights'], x, y, steps=1)
    sd = precond.state_dict(compress_symmetric=True)
    assert sd['layers']['moe::fc_out']['A']['triu'].shape[0] == E
    fresh = MoEKFACPreconditioner(port_model(ref['weights']), xent, **HP)
    fresh.load_state_dict(sd)
    for name, st in precond.layers.items():
        for f, v in st.tensors().items():
            assert torch.equal(fresh.layers[name].tensors()[f], v), (name, f)
    with pytest.raises(ValueError, match='unregistered'):
        fresh.load_state_dict(dict(sd, layers={'nope': {}}))


def test_train_loop_matches_step(ref):
    x, y = data()
    want, _ = port_run(ref['weights'], x, y, steps=2)
    model = port_model(ref['weights'])
    precond = MoEKFACPreconditioner(model, xent, **HP)
    loop = precond.train_loop(torch.optim.SGD(model.parameters(),
                                              lr=SGD_LR))
    for step in range(2):
        loss, _ = loop.step(t(x), loss_args=(t(y),))
        assert float(loss) == want[step]['loss']


def test_options_validated_as_jax():
    model = port_moe.TinyMoEModel(port_moe.MoEConfig(E, D_MODEL, D_FF), IN)
    with pytest.raises(ValueError, match='mutually exclusive'):
        MoEKFACPreconditioner(model, xent, ekfac=True, lowrank_rank=4)
    with pytest.raises(ValueError, match='requires ekfac'):
        MoEKFACPreconditioner(model, xent, adaptive_refresh=object())


# -- across ranks ------------------------------------------------------


@pytest.mark.parametrize('grid', GRIDS, ids=['1x4', '2x2'])
def test_ranks_match_jax_mesh(ref, grid):
    """Each rank's loss, factor slices and gradient slices against JAX's
    mesh run; every rank saves the whole stacks, the same dict."""
    want = ref['mesh'][grid]
    for rank, res in enumerate(ref['ranks']):
        r = res[grid]
        rows = slice(r['offset'], r['offset'] + r['local'])
        for step, (g, w) in enumerate(zip(r['steps'], want)):
            what = (grid, rank, step)
            assert abs(g['loss'] - w['loss']) <= TOL * abs(w['loss']), what
            assert_factors(g['factors'], w['factors'], rows, what)
            assert_close(g['grads'], w['grads'], rows, what)
        sd0 = ref['ranks'][0][grid]['sd']['layers']
        for name, f in r['sd']['layers'].items():
            assert torch.equal(f['A']['triu'], sd0[name]['A']['triu'])


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
