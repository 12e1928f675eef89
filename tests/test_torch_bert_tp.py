"""The port's tensor-parallel ``BertForQA`` under ``GPTKFACPreconditioner``
against the JAX package's, on the CPU.

Four gloo ranks (subprocesses of this file, no JAX) train ``bert_tiny``
(vocab 256, 2 blocks, ``d_model`` 32, 2 heads) on a ``('data',
'model')`` grid of ``2 x 2``: the four dense layers of each block
tensor-parallel over ``'model'`` (``qkv`` split by heads), DDP over
``'data'``, MEM-OPT over the data extent; three SGD steps (lr 0.05),
factor 1, inv 2, damping 0.003, kl-clip 0.001, the span loss (the mean
of the start and end cross entropies) on ``[8, 16]`` tokens whose rows 0
and 1 mask their last 4 positions, from the JAX weights carried across
by ``convert.flax_bert_to_tp_state_dict``.  The parent meanwhile runs
JAX's ``GPTKFACPreconditioner`` on BERT on a ``(2, 2)`` mesh with the
rules of ``examples/squad_bert.py`` (``tests/test_bert.py:75-108``):

* the loss (``rtol 1e-5``), every layer's factors and every rank's
  preconditioned gradient slices each step (``1e-5`` relative
  Frobenius, a layer's ``[weight | bias]`` as one matrix; a gradient
  that is zero in exact arithmetic to ``1e-8`` absolute), at the default
  and with ``compute_eigenvalue_outer_product=True``;
* each rank's start and end logits of its rows before the first step
  against the one-process port BERT's (``atol 1e-5``);
* per-layer factor files written by JAX and read by the port, and the
  reverse, under JAX's names (``h_<i>/{qkv,proj,fc_in,fc_out}``,
  ``qa_head``).
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
from torch.nn.parallel import DistributedDataParallel

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch.convert import flax_bert_to_tp_state_dict  # noqa
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict  # noqa
from kfac_pytorch_tpu_torch.gpt import GPTKFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.models import bert_tiny  # noqa: E402
from kfac_pytorch_tpu_torch.models.bert import shard_state_dict  # noqa
from kfac_pytorch_tpu_torch.ops import fused_precond  # noqa: E402
from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups  # noqa: E402
from kfac_pytorch_tpu_torch.parallel.tensor import \
    ColumnParallelDense  # noqa: E402

from test_torch_gpt_precond import join  # noqa: E402
from test_torch_gpt_precond import rel_err  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

WORLD = 4
STEPS = 3
LR = 0.05
TOKENS = (8, 16)
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR)
TP_PASSES = {'default': False, 'prediv': True}
TOL = 1e-5
#: Absolute bar of a gradient that is zero in exact arithmetic
#: (``tests/test_torch_dense_general.py``'s ``ZERO_GRAD_ATOL``): the bias
#: of the last LayerNorm, whose output gradient is ``qa_head``'s kernel
#: times the start and end softmax gradients, each summing to zero over a
#: row's positions.
ZERO_GRAD_ATOL = 1e-8
LOGIT_ATOL = 1e-5
SPAWN_TIMEOUT_S = 240


def batches():
    """``(tokens, mask, starts, ends)`` per step."""
    rng = np.random.default_rng(17)
    out = []
    B, T = TOKENS
    for _ in range(STEPS):
        tokens = rng.integers(0, 256, (B, T)).astype(np.int32)
        mask = np.ones((B, T), bool)
        mask[:2, -4:] = False
        starts = rng.integers(0, T - 4, B).astype(np.int32)
        ends = rng.integers(0, T - 4, B).astype(np.int32)
        out.append((tokens, mask, starts, ends))
    return out


def port_span_loss(out, starts, ends):
    start, end = out
    return (F.cross_entropy(start, starts) + F.cross_entropy(end, ends)) / 2


def as_torch(batch, rows=slice(None)):
    tokens, mask, starts, ends = batch
    return (torch.from_numpy(tokens[rows]).long(),
            torch.from_numpy(mask[rows]),
            torch.from_numpy(starts[rows]).long(),
            torch.from_numpy(ends[rows]).long())


# -- the worker ranks (no JAX) ---------------------------------------------


def tp_run(variables, prediv):
    """``GPTKFACPreconditioner`` on the ``2 x 2`` grid: per step the
    rank's local loss, the factors and its parameters' gradients; the
    rank's logits before the first step; the fused entry's calls."""
    mesh = axis_groups(2, 2, names=('data', 'model'))
    model = bert_tiny(device='cpu', tp_group=mesh.group('model'))
    model.load_state_dict(
        flax_bert_to_tp_state_dict(variables, mesh.inner, 2), strict=True)
    assert isinstance(model.h_0.qkv, ColumnParallelDense)
    assert model.h_0.n_heads == 1
    ddp = DistributedDataParallel(model, process_group=mesh.group('data'))
    precond = GPTKFACPreconditioner(
        ddp, mesh=mesh, compute_eigenvalue_outer_product=prediv, **HP)
    rows = slice(4 * mesh.outer, 4 * mesh.outer + 4)
    data = batches()
    tokens, mask, _, _ = as_torch(data[0], rows)
    with torch.no_grad():
        logits = [t.clone() for t in model(tokens, None, mask)]
    trace, calls = [], []
    real = fused_precond.fused_eigen_precondition

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    fused_precond.fused_eigen_precondition = counted
    try:
        for batch in data:
            tokens, mask, starts, ends = as_torch(batch, rows)
            model.zero_grad()
            loss = port_span_loss(ddp(tokens, None, mask), starts, ends)
            loss.backward()
            precond.step()
            trace.append(dict(
                loss=float(loss.detach()),
                factors={n: (st.a_factor.clone(), st.g_factor.clone())
                         for n, st in precond.layers.items()},
                grads={n: p.grad.clone()
                       for n, p in model.named_parameters()}))
            with torch.no_grad():
                for p in model.parameters():
                    p -= LR * p.grad
    finally:
        fused_precond.fused_eigen_precondition = real
    return dict(trace=trace, calls=calls, logits=logits,
                names=sorted(precond.layers))


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init}', rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=200))
    variables = torch.load(out / 'init_flax.pt', weights_only=False)
    res = {k: tp_run(variables, v) for k, v in TP_PASSES.items()}
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


# -- the JAX references (parent only) --------------------------------------


def assert_step(got, want, layers, what):
    """The loss (``rtol``), every layer's factors, and the gradients:
    each registered layer's ``[weight | bias]`` as one matrix, the
    preconditioned gradient K-FAC forms, and every other parameter's
    alone, each within ``TOL`` relative Frobenius (or ``ZERO_GRAD_ATOL``
    absolute for a gradient that is zero in exact arithmetic)."""
    assert abs(got['loss'] - want['loss']) <= TOL * abs(want['loss']), what
    assert set(got['factors']) == set(want['factors'])
    for name, pair in want['factors'].items():
        for side in (0, 1):
            err = rel_err(got['factors'][name][side], pair[side])
            assert err <= TOL, (what, name, side, err)
    g, w = dict(got['grads']), dict(want['grads'])
    assert set(g) == set(w)
    for layer in layers:
        for d in (g, w):
            d[layer] = np.concatenate(
                [np.asarray(d.pop(f'{layer}.weight'), np.float64),
                 np.asarray(d.pop(f'{layer}.bias'), np.float64)[:, None]],
                1)
    for name, x in w.items():
        err = rel_err(g[name], x)
        diff = float(np.abs(np.asarray(g[name], np.float64)
                            - np.asarray(x, np.float64)).max())
        assert err <= TOL or diff <= ZERO_GRAD_ATOL, (what, name, err)


def jax_span_loss(out, starts, ends):
    import jax
    import jax.numpy as jnp

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    start, end = out
    return (xent(start, starts) + xent(end, ends)) / 2


def jax_init():
    import flax.linen as fnn
    import jax

    from kfac_pytorch_tpu.models.bert import bert_tiny as jax_bert_tiny

    tokens, mask, _, _ = batches()[0]
    variables = fnn.meta.unbox(jax.jit(
        lambda k, t, m: jax_bert_tiny().init(k, t, mask=m, train=False))(
            jax.random.PRNGKey(0), tokens, mask))
    return jax.tree.map(np.asarray, variables)


def jax_precond(**kw):
    import jax
    from jax.sharding import Mesh

    from kfac_pytorch_tpu.gpt import GPTKFACPreconditioner as JaxGPT
    from kfac_pytorch_tpu.models.bert import bert_tiny as jax_bert_tiny

    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, 2),
                ('data', 'model'))
    precond = JaxGPT(jax_bert_tiny(), loss_fn=jax_span_loss,
                     apply_kwargs={'train': True}, mesh=mesh,
                     data_axes=('data',), **HP, **kw)
    return precond, mesh


def rules():
    from kfac_pytorch_tpu.models.gpt import EMBED, HEADS, HIDDEN, SEQ, VOCAB

    return (('batch', 'data'), (EMBED, None), (HIDDEN, 'model'),
            (HEADS, 'model'), (VOCAB, None), (SEQ, None))


def jax_trajectory(init, prediv):
    """JAX's three mesh steps with SGD: per step the loss, the factors
    and the gradients by port name; the preconditioner and its state."""
    import flax.linen as fnn
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from kfac_pytorch_tpu.utils.compat import set_mesh

    precond, mesh = jax_precond(compute_eigenvalue_outer_product=prediv)
    data = batches()
    params = init['params']
    trace = []
    with fnn.logical_axis_rules(rules()), set_mesh(mesh):
        tokens, mask, _, _ = data[0]
        state = precond.init(init, tokens, None, mask)
        rows = NamedSharding(mesh, P('data'))
        for tokens, mask, starts, ends in data:
            loss, _, grads, state = precond.step(
                {'params': params}, state, jax.device_put(tokens, rows),
                None, jax.device_put(mask, rows), loss_args=(starts, ends))
            grads = jax.tree.map(np.asarray, grads)
            params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
            trace.append(dict(
                loss=float(loss),
                factors={base.replace('/', '.'): (
                    np.asarray(state[base].a_factor),
                    np.asarray(state[base].g_factor))
                    for base in state.layers},
                grads=flax_to_torch_state_dict({'params': grads})))
    return trace, precond, state


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """The JAX references and the four ranks' results."""
    out = tmp_path_factory.mktemp('bert_tp')
    init = jax_init()
    torch.save(init, out / 'init_flax.pt')
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = spawn(out)
    r = {'init': init}
    try:
        for label, prediv in TP_PASSES.items():
            r[label], precond, state = jax_trajectory(init, prediv)
            if not prediv:
                r['precond'], r['state'] = precond, state
    finally:
        join(procs, deadline)
    r['ranks'] = [torch.load(out / f'rank{k}.pt', weights_only=False)
                  for k in range(WORLD)]
    return r


@pytest.mark.parametrize('label', list(TP_PASSES))
@pytest.mark.parametrize('step', range(STEPS))
def test_tp_bert_matches_jax_mesh(ref, label, step):
    """Each rank against JAX's ``(2, 2)`` mesh: the loss (the mean of the
    two data ranks'), the full factors of every layer, and the rank's
    gradient slices (JAX's gradients sharded as the rank's model index
    holds them)."""
    want = ref[label][step]
    ranks = [r[label]['trace'][step] for r in ref['ranks']]
    loss = float(np.mean([ranks[0]['loss'], ranks[2]['loss']]))
    for k, got in enumerate(ranks):
        mine = shard_state_dict(want['grads'], k % 2, 2)
        assert_step(dict(got, loss=loss), dict(want, grads=mine),
                    list(want['factors']), (label, step, k))


def test_layers_registered_under_jax_names(ref):
    """The 2 x 4 dense layers and ``qa_head``, named as JAX names them."""
    want = sorted(b.replace('/', '.') for b in ref['state'].layers)
    assert len(want) == 2 * 4 + 1 and 'qa_head' in want
    for r in ref['ranks']:
        assert r['default']['names'] == want


def test_tp_logits_match_the_plain_model(ref):
    """Every rank's start and end logits of its rows, from its shards,
    are the one-process port BERT's."""
    model = bert_tiny(device='cpu')
    model.load_state_dict(flax_to_torch_state_dict(ref['init']))
    tokens, mask, _, _ = as_torch(batches()[0])
    with torch.no_grad():
        want = model(tokens, None, mask)
    for k, r in enumerate(ref['ranks']):
        rows = slice(4 * (k // 2), 4 * (k // 2) + 4)
        for got, w in zip(r['default']['logits'], want):
            torch.testing.assert_close(got, w[rows], rtol=0,
                                       atol=LOGIT_ATOL)


def test_prediv_runs_the_fused_entry(ref):
    """No ``dgda`` at the default, so the fused entry is never called, as
    in JAX; with ``compute_eigenvalue_outer_product`` every step."""
    for r in ref['ranks']:
        assert r['default']['calls'] == []
        calls = r['prediv']['calls']
        assert calls and len(calls) % STEPS == 0


def port_after_one_step(init, tmp_path):
    model = bert_tiny(device='cpu')
    model.load_state_dict(flax_to_torch_state_dict(init))
    precond = GPTKFACPreconditioner(model, factor_checkpoint_dir=str(
        tmp_path), **HP)
    tokens, mask, starts, ends = as_torch(batches()[0])
    port_span_loss(model(tokens, None, mask), starts, ends).backward()
    precond.step()
    return precond


def test_jax_factor_files_load_in_the_port(ref, tmp_path):
    """JAX's ``save_factors`` after its three mesh steps: a fresh port
    preconditioner takes every layer's factors bit for bit."""
    jax_precond_ = ref['precond']
    jax_precond_.factor_checkpoint_dir = str(tmp_path)
    subdir = jax_precond_.save_factors(ref['state'])
    assert len(os.listdir(subdir)) == 9
    fresh = GPTKFACPreconditioner(bert_tiny(device='cpu'), **HP)
    fresh.load_factors(subdir)
    assert fresh.steps == STEPS
    want = ref['default'][-1]['factors']
    for name, st in fresh.layers.items():
        assert np.array_equal(st.a_factor.numpy(), want[name][0])
        assert np.array_equal(st.g_factor.numpy(), want[name][1])


def test_port_factor_files_load_in_jax(ref, tmp_path):
    """The port's ``save_factors`` read by JAX's ``load_factors``."""
    import flax.linen as fnn

    precond = port_after_one_step(ref['init'], tmp_path)
    subdir = precond.save_factors(step=1)
    fresh, _ = jax_precond(factor_checkpoint_dir=str(tmp_path))
    tokens, mask, _, _ = batches()[0]
    with fnn.logical_axis_rules(rules()):
        state = fresh.load_factors(fresh.init(ref['init'], tokens, None,
                                              mask),
                                   subdir, compute_inverses=False)
    assert fresh.steps == 1
    for base in state.layers:
        st = precond.layers[base.replace('/', '.')]
        assert np.array_equal(np.asarray(state[base].a_factor),
                              st.a_factor.numpy())
        assert np.array_equal(np.asarray(state[base].g_factor),
                              st.g_factor.numpy())


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
