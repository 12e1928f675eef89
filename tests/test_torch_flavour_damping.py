"""``AdaptiveDamping`` on the port's MoE and GPipe flavours against the
JAX package's ``make_train_step``, on the CPU.

The harnesses are ``tests/test_torch_moe.py``'s (the JAX
``TinyMoEModel`` of ``tests/test_moe.py:21`` at ``E = 4``, params only)
and ``tests/test_torch_pipeline.py``'s (``PipelineLM``, 2 stages of one
block, ``M = 2``), factor 1, inv 1, damping
``AdaptiveDamping(0.003, interval=2)``, plain SGD (lr 0.1) in both
packages, four steps (adaptations at steps 1 and 3):

* one process (the MoE model whole; the pipeline LM holding both stages)
  against JAX's single-device MoE run and JAX's ``('pipe', 'data')``
  2 x 2 mesh: the damping after every step within ``1e-6`` relative,
  the losses and the parameters after the last step within ``1e-5``
  (relative; relative Frobenius);
* four gloo ranks (subprocesses of this file) on the MoE ``2 x 2``
  (data, expert) grid and the pipe ``2 x 2`` grid: every rank's damping
  bitwise equal to every other's and within ``1e-6`` of JAX's mesh run,
  the losses within ``1e-5``;
* ``step()`` warns once that the controller is not fed;
* the loss-only forward leaves the factors, the accumulated micro-batch
  sums and the capture as they were, and the padded stacks' cache
  follows each refresh's new ``dgda``.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
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

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch.adaptive import AdaptiveDamping  # noqa: E402
from kfac_pytorch_tpu_torch.gpt import MoEKFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.gpt import PipelineKFACPreconditioner  # noqa
from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups  # noqa: E402

import test_torch_moe as tm  # noqa: E402
import test_torch_pipeline as tp  # noqa: E402
from test_torch_moe import rel_err  # noqa: E402
from test_torch_moe import t  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

STEPS = 4
INTERVAL = 2
LR = 0.1
DAMPING_REL = 1e-6
TOL = 1e-5
WORLD = 4
SPAWN_TIMEOUT_S = 180


def hp(damping):
    return dict(factor_update_steps=1, inv_update_steps=1, lr=LR,
                damping=damping)


# -- the port ------------------------------------------------------------


def moe_train(weights, x, y, grid=None):
    """``make_train_step`` on the MoE harness: per step the loss and the
    damping in force after it; the model at the end."""
    kw = {} if grid is None else dict(expert_group=grid.inner_group,
                                      data_group=grid.outer_group)
    model = tm.port_model(weights, **kw)
    ad = AdaptiveDamping(0.003, interval=INTERVAL)
    precond = MoEKFACPreconditioner(model, tm.xent, **hp(ad))
    step = precond.make_train_step(torch.optim.SGD(model.parameters(),
                                                   lr=LR))
    out = []
    for _ in range(STEPS):
        loss, _ = step(t(x), loss_args=(t(y),))
        out.append(dict(loss=float(loss), damping=ad.damping))
    return out, model, precond


def pipe_train(weights, tokens, labels, grid=None):
    stages = None if grid is None else [grid.outer]
    model = tp.port_model(weights, stages)
    ad = AdaptiveDamping(0.003, interval=INTERVAL)
    precond = PipelineKFACPreconditioner(model, tp.xent, n_microbatches=tp.M,
                                         grid=grid, **hp(ad))
    step = precond.make_train_step(torch.optim.SGD(model.parameters(),
                                                   lr=LR))
    out = []
    for _ in range(STEPS):
        loss, _ = step(t(tokens), loss_args=(t(labels),))
        out.append(dict(loss=float(loss), damping=ad.damping))
    return out, model, precond


def params_of(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


# -- the JAX side ----------------------------------------------------------


def jax_moe_train(mesh=None):
    """JAX's MoE ``make_train_step`` with ``optax.sgd``: per step the
    loss and the damping; the final parameters by port name."""
    import flax.linen as fnn
    import jax
    import optax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from kfac_pytorch_tpu.adaptive import AdaptiveDamping as JaxDamping
    from kfac_pytorch_tpu.gpt.moe import MoEKFACPreconditioner as JaxMoE
    from kfac_pytorch_tpu.utils.compat import set_mesh

    x, y = tm.data()
    ad = JaxDamping(0.003, interval=INTERVAL)
    model, loss_fn = tm.jax_model()
    variables = tm.jax_variables()
    rules = (('expert', 'expert'),) if mesh is not None else ()
    out = []
    with fnn.logical_axis_rules(rules), (
            set_mesh(mesh) if mesh is not None else contextlib.nullcontext()):
        precond = JaxMoE(model, loss_fn, mesh=mesh, **hp(ad))
        state = precond.init(variables, x)
        tx = optax.sgd(LR)
        step = precond.make_train_step(tx)
        opt_state = tx.init(variables['params'])
        xs = (x if mesh is None
              else jax.device_put(x, NamedSharding(mesh, P('data'))))
        vs = variables
        for _ in range(STEPS):
            loss, _, vs, opt_state, state = step(vs, opt_state, state, xs,
                                                 loss_args=(y,))
            out.append(dict(loss=float(loss), damping=ad.damping))
    return out, tm.to_torch(vs['params'])


def jax_pipe_train():
    import jax
    import optax

    from kfac_pytorch_tpu.adaptive import AdaptiveDamping as JaxDamping
    from kfac_pytorch_tpu.gpt.pipeline import (
        PipelineKFACPreconditioner as JaxPipe,
    )
    from kfac_pytorch_tpu.utils.compat import set_mesh

    ad = JaxDamping(0.003, interval=INTERVAL)
    model, params, mesh, _ = tp.jax_setup()
    precond = JaxPipe(model, jax_pipe_xent, mesh=mesh, n_microbatches=tp.M,
                      **hp(ad))
    tokens, labels = tp.data()
    out = []
    with set_mesh(mesh):
        state = precond.init(params)
        tx = optax.sgd(LR)
        step = precond.make_train_step(tx)
        opt_state = tx.init(params)
        for _ in range(STEPS):
            loss, _, params, opt_state, state = step(
                params, opt_state, state, tokens, loss_args=(labels,))
            out.append(dict(loss=float(loss), damping=ad.damping))
    return out, tp.jax_grads(jax.tree.map(np.asarray, params))


def jax_pipe_xent(logits, labels):
    import jax
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))


def moe_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2),
                ('data', 'expert'))


# -- the four ranks ----------------------------------------------------------


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    x, y = tm.data()
    grid = axis_groups(2, 2)
    rows = slice(grid.outer * 4, grid.outer * 4 + 4)
    moe, model, _ = moe_train(torch.load(out / 'moe.pt'), x[rows], y[rows],
                              grid)
    res = dict(moe=moe, moe_offset=model.moe.expert_offset,
               moe_local=model.moe.local_experts)
    tokens, labels = tp.data()
    grid = axis_groups(tp.PIPE, tp.DATA)
    rows = slice(grid.inner * 4, grid.inner * 4 + 4)
    res['pipe'], _, _ = pipe_train(torch.load(out / 'pipe.pt'),
                                   tokens[rows], labels[rows], grid)
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


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """The JAX references, computed while the four ranks run."""
    out = tmp_path_factory.mktemp('flavour_damping')
    moe_weights = tm.to_torch(tm.jax_variables()['params'])
    pipe_weights = tp.pipeline_lm_state_dict(tp.jax_params()[1])
    torch.save(moe_weights, out / 'moe.pt')
    torch.save(pipe_weights, out / 'pipe.pt')
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = spawn(out)
    r = dict(moe_weights=moe_weights, pipe_weights=pipe_weights)
    try:
        r['moe'], r['moe_params'] = jax_moe_train()
        r['moe_mesh'], _ = jax_moe_train(moe_mesh())
        r['pipe'], r['pipe_params'] = jax_pipe_train()
    finally:
        tm.join(procs, deadline)
    r['ranks'] = [torch.load(out / f'rank{k}.pt') for k in range(WORLD)]
    return r


def assert_run(got, want, what):
    dampings = [w['damping'] for w in want]
    assert len(set(dampings)) > 1, dampings  # an adaptation moved it
    for step, (g, w) in enumerate(zip(got, want)):
        assert abs(g['damping'] - w['damping']) <= (
            DAMPING_REL * w['damping']), (what, step, g, w)
        assert abs(g['loss'] - w['loss']) <= TOL * abs(w['loss']), (
            what, step, g, w)


def assert_params(got, want, rows=None):
    assert set(got) == set(want)
    for name, w in want.items():
        if rows is not None and name.rsplit('.', 1)[-1] in (
                'w_in', 'b_in', 'w_out', 'b_out'):
            w = w[rows]
        err = rel_err(got[name], w)
        assert err <= TOL, (name, err)


# -- one process -------------------------------------------------------------


def test_moe_make_train_step_matches_jax(ref):
    x, y = tm.data()
    got, model, _ = moe_train(ref['moe_weights'], x, y)
    assert_run(got, ref['moe'], 'moe')
    assert_params(params_of(model), ref['moe_params'])


def test_pipeline_make_train_step_matches_jax(ref):
    tokens, labels = tp.data()
    got, model, _ = pipe_train(ref['pipe_weights'], tokens, labels)
    assert_run(got, ref['pipe'], 'pipeline')
    assert_params(params_of(model), ref['pipe_params'])


# -- four ranks --------------------------------------------------------------


@pytest.mark.parametrize('flavour', ['moe', 'pipe'])
def test_ranks_keep_the_same_damping_bitwise(ref, flavour):
    """Every rank's damping after every step is rank 0's, bit for bit,
    and JAX's mesh run's within ``1e-6``; each rank's loss is the global
    one."""
    want = ref['moe_mesh' if flavour == 'moe' else 'pipe']
    runs = [r[flavour] for r in ref['ranks']]
    for k, run in enumerate(runs):
        assert [s['damping'] for s in run] == [
            s['damping'] for s in runs[0]], (flavour, k)
        assert_run(run, want, (flavour, k))


# -- the warning and the loss-only forward -----------------------------------


@pytest.mark.parametrize('flavour', ['moe', 'pipe'])
def test_step_warns_once_that_the_controller_is_not_fed(ref, caplog,
                                                        flavour):
    if flavour == 'moe':
        x, y = tm.data()
        precond = MoEKFACPreconditioner(
            tm.port_model(ref['moe_weights']), tm.xent,
            **hp(AdaptiveDamping(0.003)))
        call = functools.partial(precond.step, t(x), loss_args=(t(y),))
    else:
        tokens, labels = tp.data()
        precond = PipelineKFACPreconditioner(
            tp.port_model(ref['pipe_weights']), tp.xent,
            n_microbatches=tp.M, **hp(AdaptiveDamping(0.003)))
        call = functools.partial(precond.step, t(tokens), t(labels))
    with caplog.at_level(logging.WARNING, 'kfac_pytorch_tpu_torch.engine'):
        for _ in range(3):
            call()
    msgs = [r.getMessage() for r in caplog.records
            if 'AdaptiveDamping' in r.getMessage()]
    assert len(msgs) == 1
    assert 'not auto-fed on the step() path' in msgs[0]


def state_of(precond) -> dict:
    return {(n, f): v.clone() for n, st in precond.layers.items()
            for f, v in st.tensors().items()}


def test_loss_only_leaves_factors_accumulators_and_capture(ref):
    """Between two micro-batches of an accumulated step: the loss-only
    forward returns the plain forward's loss and changes no factor, no
    accumulated sum, no capture and not the capture's switch."""
    x, y = tm.data()
    model = tm.port_model(ref['moe_weights'])
    precond = MoEKFACPreconditioner(model, tm.xent, accumulation_steps=2,
                                    **hp(AdaptiveDamping(0.003)))
    model.zero_grad()
    precond.accumulate(t(x), loss_args=(t(y),))
    before = state_of(precond)
    accum = {k: [n, [v.clone() for v in e if v is not None]]
             for k, (n, e) in precond._accum.items()}
    armed = precond._armed
    loss = precond._loss_only((t(x),), (t(y),), tm.xent)
    with torch.no_grad():
        want = tm.xent(model(t(x)), t(y))
    assert float(loss) == float(want)
    assert precond._armed == armed is True
    assert precond._capture.armed is True
    assert not precond._capture.pending()
    assert not precond._expert_acts and not precond._expert_grads
    for k, v in before.items():
        assert torch.equal(state_of(precond)[k], v), k
    assert set(precond._accum) == set(accum)
    for k, (n, e) in accum.items():
        n2, e2 = precond._accum[k]
        assert n2 == n
        assert all(torch.equal(a, b)
                   for a, b in zip([v for v in e2 if v is not None], e))


def test_padded_cache_follows_each_refresh(ref):
    """The expert stacks (``din`` 17, 33) reach the kernel padded; after
    the controller moved the damping, the next refresh's ``dgda`` holds
    it and the cache is rebuilt from that tensor."""
    x, y = tm.data()
    got, _, precond = moe_train(ref['moe_weights'], x, y)
    st = precond.layers['moe::fc_in']
    key, padded = precond._padded['moe::fc_in']
    assert key[2] is st.dgda
    dgda = padded[2][..., :st.dgda.shape[-2], :st.dgda.shape[-1]]
    assert torch.equal(dgda, st.dgda)
    # The last refresh (step 3) took the damping in force after step 2.
    damping = got[2]['damping']
    qa, qg = st.qa, st.qg
    da = torch.einsum('lji,ljk,lki->li', qa, st.a_factor, qa).clamp(min=0)
    dg = torch.einsum('lji,ljk,lki->li', qg, st.g_factor, qg).clamp(min=0)
    want = 1.0 / (dg[..., :, None] * da[..., None, :] + damping)
    assert rel_err(st.dgda, want) <= 1e-4


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
