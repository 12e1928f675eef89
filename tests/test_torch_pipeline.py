"""The port's GPipe schedule, ``PipelineLM`` and
``PipelineKFACPreconditioner`` against the JAX package's, on the CPU.

* The schedule helpers (``num_ticks``, ``valid_tick_mask``,
  ``microbatch``/``unmicrobatch``, ``stack_stage_init``) equal JAX's.
* ``PipelineLM`` (vocab 64, 2 stages of one block, ``d_model 16``,
  ``d_ff 32``, 16 positions) with the JAX weights carried across by
  ``convert.pipeline_lm_state_dict``: ``apply_sequential`` equals JAX's.
* The preconditioner in one process holding both stages against JAX's
  ``('pipe', 'data')`` 2 x 2 mesh run (``n_microbatches=2``): loss, each
  stage's factors and the preconditioned gradients over two SGD steps
  within ``1e-5`` (relative Frobenius); low-rank (the JAX sketches
  injected) and EKFAC; the batch accumulated twice against the plain
  step; a JAX state dict resumed; the port's own round trip; the
  engine's ``train_loop`` against ``step``.
* Four gloo ranks (subprocesses of this file) on the pipe 2 x data 2
  grid, each holding one stage: the same gates against the same JAX
  run, every rank's stage slices; every activation handed off is
  ``mb * T * D * 4`` bytes; ``apply_pipelined`` gives the sequential
  logits on every rank; the ``send``/``recv`` hand-offs that
  ``PipeLinks`` takes on NCCL, forced over gloo on CPU tensors, give the
  pair-group broadcast's loss and gradients bitwise.
"""
from __future__ import annotations

import datetime
import functools
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch.convert import pipeline_lm_state_dict  # noqa
from kfac_pytorch_tpu_torch.gpt import PipelineKFACPreconditioner  # noqa
from kfac_pytorch_tpu_torch.models import pipeline as port_pipe  # noqa
from kfac_pytorch_tpu_torch.ops import lowrank  # noqa: E402
from kfac_pytorch_tpu_torch.parallel import pipeline as pp  # noqa: E402
from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups  # noqa: E402

from test_torch_moe import jax_flavour_draw  # noqa: E402
from test_torch_moe import rel_err  # noqa: E402
from test_torch_moe import t  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

CFG = dict(vocab_size=64, n_stages=2, blocks_per_stage=1, n_heads=2,
           d_model=16, d_ff=32, max_seq_len=16)
HP = dict(factor_update_steps=1, inv_update_steps=1, damping=0.003, lr=0.1)
M = 2
STEPS = 2
SGD_LR = 0.1
TOL = 1e-5
#: The low-rank run's keywords.  With the identity seed the first
#: refresh decomposes ``0.95 I + 0.05 S`` factors whose top eigenvalues
#: lie within ~1e-6 of each other (``attn.proj``'s G), where rounding
#: picks the randomized top-k subspace in JAX as in the port (1.5e-4
#: apart); with ``factor_decay=0`` the factors are the batch statistics,
#: whose spectrum is spread, so the comparison is well posed.
LOWRANK = dict(lowrank_rank=4, lowrank_oversample=4, factor_decay=0.0)
WORLD = 4
PIPE, DATA = 2, 2
SPAWN_TIMEOUT_S = 180


def data():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, CFG['vocab_size'], (8, 12)).astype(np.int32)
    labels = rng.integers(0, CFG['vocab_size'], (8, 12)).astype(np.int32)
    return tokens, labels


def xent(logits, labels):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def port_model(weights, stages=None):
    model = port_pipe.PipelineLM(port_pipe.PipeLMConfig(**CFG), stages)
    model.load_state_dict({k: v for k, v in weights.items()
                           if not k.startswith('stages.') or stages is None
                           or int(k.split('.')[1]) in stages})
    return model


def grads_of(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def factors_of(precond):
    return {n: (st.a_factor.clone(), st.g_factor.clone())
            for n, st in precond.layers.items()}


def sgd(model):
    with torch.no_grad():
        for p in model.parameters():
            p -= SGD_LR * p.grad


def port_run(weights, steps=STEPS, **kw):
    tokens, labels = data()
    model = port_model(weights)
    precond = PipelineKFACPreconditioner(model, xent, n_microbatches=M,
                                         **HP, **kw)
    out = []
    for _ in range(steps):
        loss = precond.step(t(tokens), t(labels))
        out.append(dict(loss=float(loss), grads=grads_of(model),
                        factors=factors_of(precond)))
        sgd(model)
    return out, precond


# -- the JAX side ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_params():
    import jax

    from kfac_pytorch_tpu.models.pipeline import PipeLMConfig, PipelineLM

    model = PipelineLM(PipeLMConfig(**CFG))
    tokens, _ = data()
    return model, jax.tree.map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), tokens))


def jax_setup(**kw):
    import jax
    from jax.sharding import Mesh

    from kfac_pytorch_tpu.gpt.pipeline import (
        PipelineKFACPreconditioner as JaxPipe,
    )

    model, params = jax_params()
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(PIPE, DATA),
                ('pipe', 'data'))

    def loss(logits, labels):
        import jax.numpy as jnp

        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))

    precond = JaxPipe(model, loss, mesh=mesh, n_microbatches=M, **HP, **kw)
    return model, params, mesh, precond


def jax_factors(state):
    return {n.replace('/', '.'): (t(st.a_factor), t(st.g_factor))
            for n, st in state.items()}


def jax_grads(grads):
    return pipeline_lm_state_dict(grads)


def jax_run(steps=STEPS, **kw):
    import jax

    from kfac_pytorch_tpu.utils.compat import set_mesh

    _, params, mesh, precond = jax_setup(**kw)
    tokens, labels = data()
    state = precond.init(params)
    out = []
    with set_mesh(mesh):
        for _ in range(steps):
            loss, grads, state = precond.step(params, state, tokens, labels)
            out.append(dict(
                loss=float(loss), params=params, factors=jax_factors(state),
                grads=jax_grads(jax.tree.map(np.asarray, grads)),
                sd=precond.state_dict(state, compress_symmetric=True)))
            params = jax.tree.map(lambda p, g: p - SGD_LR * np.asarray(g),
                                  params, grads)
    return out


# -- the four ranks ----------------------------------------------------


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    weights = torch.load(out / 'init.pt')
    tokens, labels = data()
    grid = axis_groups(PIPE, DATA)
    model = port_model(weights, [grid.outer])
    precond = PipelineKFACPreconditioner(model, xent, n_microbatches=M,
                                         grid=grid, **HP)
    rows = slice(grid.inner * 4, grid.inner * 4 + 4)
    logits = model.apply_pipelined(t(tokens[rows]), n_microbatches=M,
                                   links=precond.links)
    steps = []
    for _ in range(STEPS):
        loss = precond.step(t(tokens[rows]), t(labels[rows]))
        steps.append(dict(loss=float(loss), grads=grads_of(model),
                          factors=factors_of(precond)))
        sgd(model)
    sd = precond.state_dict(compress_symmetric=True)
    handoffs = list(precond.links.handoff_bytes)
    kinds = handoff_kinds(model, {'broadcast': precond.links,
                                  'send_recv': send_recv_links(grid)},
                          grid, rows)
    torch.save(dict(steps=steps, stage=grid.outer, sd=sd, logits=logits,
                    handoffs=handoffs, kinds=kinds), out / f'rank{rank}.pt')
    dist.destroy_process_group()


def send_recv_links(grid) -> pp.PipeLinks:
    """The rank's links as NCCL builds them (``send``/``recv``, no edge
    groups); gloo carries ``send``/``recv`` of CPU tensors."""
    with mock.patch.object(pp.dist, 'get_backend', lambda *a: 'nccl'):
        links = pp.PipeLinks(grid.outer_ranks(), grid.outer,
                             grid.outer_group)
    assert links.backend == 'nccl'
    return links


def handoff_kinds(model, links_by_kind, grid, rows):
    """One GPipe forward and backward per kind of hand-off, from the same
    weights: the loss, every gradient and the bytes handed forward."""
    tokens, labels = data()
    out = {}
    for kind, links in links_by_kind.items():
        for p in model.parameters():
            p.grad = None
        before = len(links.handoff_bytes)
        loss = model.pipelined_loss(
            t(tokens[rows]), xent, (t(labels[rows]),), n_microbatches=M,
            links=links, data_group=grid.inner_group)
        out[kind] = dict(loss=float(loss), grads=grads_of(model),
                         sent=links.handoff_bytes[before:])
    return out


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
    """The JAX references, computed once while the four ranks run."""
    import jax

    out = tmp_path_factory.mktemp('pipe')
    model, params, _, _ = jax_setup()
    weights = pipeline_lm_state_dict(params)
    torch.save(weights, out / 'init.pt')
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = spawn(out)
    r = {'weights': weights}
    try:
        tokens, _ = data()
        r['sequential'] = np.asarray(
            jax.jit(model.apply_sequential)(params, tokens))
        r['main'] = jax_run()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lowrank, 'draw_sketch', jax_flavour_draw)
            r['lowrank'] = jax_run(1, **LOWRANK)
        r['ekfac'] = jax_run(ekfac=True)
    finally:
        join(procs, deadline)
    r['ranks'] = [torch.load(out / f'rank{k}.pt') for k in range(WORLD)]
    return r


def assert_close(got, want, stages=None, what=''):
    for name, w in want.items():
        if name.startswith('stages.') and stages is not None:
            if int(name.split('.')[1]) not in stages:
                continue
        err = rel_err(got[name], w)
        assert err <= TOL, (what, name, err)


def assert_factors(got, want, stage=None, what=''):
    assert set(got) == set(want), what
    for name, (a, g) in want.items():
        if stage is not None:
            a, g = a[stage:stage + 1], g[stage:stage + 1]
        for side, x, w in (('A', got[name][0], a), ('G', got[name][1], g)):
            err = rel_err(x, w)
            assert err <= TOL, (what, name, side, err)


# -- the schedule and the model ----------------------------------------


@pytest.mark.parametrize('S,Mb', [(1, 1), (2, 2), (4, 4), (3, 5), (8, 2)])
def test_schedule_helpers_match_jax(S, Mb):
    from kfac_pytorch_tpu.parallel import pipeline as jp

    assert pp.num_ticks(S, Mb) == jp.num_ticks(S, Mb)
    np.testing.assert_array_equal(pp.valid_tick_mask(S, Mb).numpy(),
                                  jp.valid_tick_mask(S, Mb))
    x = np.arange(Mb * 2 * 3, dtype=np.float32).reshape(Mb * 2, 3)
    got = pp.microbatch(t(x), Mb)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp.microbatch(x, Mb)))
    assert torch.equal(pp.unmicrobatch(got), t(x))


def test_microbatch_indivisible_raises_as_jax():
    with pytest.raises(ValueError, match='not divisible'):
        pp.microbatch(torch.zeros(5, 2), 2)


def test_stack_stage_init_draws_each_stage_alone():
    full = pp.stack_stage_init(
        lambda s, g: torch.randn(3, generator=g), seed=7, n_stages=4)
    alone = pp.stack_stage_init(
        lambda s, g: torch.randn(3, generator=g), seed=7, n_stages=4,
        stages=[2])
    assert len(full) == 4 and torch.equal(full[2], alone[0])
    assert not torch.equal(full[0], full[1])


def test_sequential_matches_jax(ref):
    tokens, _ = data()
    got = port_model(ref['weights']).apply_sequential(t(tokens))
    np.testing.assert_allclose(got.detach(), ref['sequential'], rtol=1e-5,
                               atol=2e-5)


def test_seeded_model_holds_its_stage():
    cfg = port_pipe.PipeLMConfig(**CFG)
    full = port_pipe.pipeline_lm(cfg, device='cpu', seed=3)
    one = port_pipe.PipelineLM(cfg, [1])
    port_pipe.init_weights(one, 3)
    for name, p in one.named_parameters():
        assert torch.equal(p, dict(full.named_parameters())[name]), name


# -- the preconditioner, one process -----------------------------------


@pytest.mark.parametrize('step', range(STEPS))
def test_one_process_matches_jax_mesh(ref, step):
    got = port_run(ref['weights'])[0][step]
    want = ref['main'][step]
    assert abs(got['loss'] - want['loss']) <= TOL * abs(want['loss'])
    assert_factors(got['factors'], want['factors'], what=step)
    assert_close(got['grads'], want['grads'], what=step)


@pytest.mark.parametrize('variant', ['lowrank', 'ekfac'])
def test_variants_match_jax(ref, monkeypatch, variant):
    kw = LOWRANK if variant == 'lowrank' else dict(ekfac=True)
    monkeypatch.setattr(lowrank, 'draw_sketch', jax_flavour_draw)
    want = ref[variant]
    got, precond = port_run(ref['weights'], steps=len(want), **kw)
    if variant == 'ekfac':
        assert torch.isfinite(precond.last_step_info['ekfac_divergence'])
    for step, w in enumerate(want):
        assert_factors(got[step]['factors'], w['factors'], what=step)
        assert_close(got[step]['grads'], w['grads'], what=step)


def test_accumulation_matches_plain_step(ref):
    """The batch twice through ``accumulate`` and ``finalize`` is the
    plain step on it (JAX's ``test_accumulate_finalize_matches_step``):
    each micro-batch's factors come from its own loss, the gradients are
    the micro-batches' average."""
    tokens, labels = data()
    model = port_model(ref['weights'])
    precond = PipelineKFACPreconditioner(
        model, xent, n_microbatches=M, accumulation_steps=2, **HP)
    model.zero_grad()
    for _ in range(2):
        precond.accumulate(t(tokens), t(labels))
    precond.finalize()
    want = ref['main'][0]
    assert_factors(factors_of(precond), want['factors'])
    assert_close(grads_of(model), want['grads'])


def test_jax_state_dict_resumes_in_port(ref):
    from kfac_pytorch_tpu_torch.convert import jax_kfac_state_dict_to_torch

    tokens, labels = data()
    first, second = ref['main']
    model = port_model(pipeline_lm_state_dict(second['params']))
    precond = PipelineKFACPreconditioner(model, xent, n_microbatches=M,
                                         **HP)
    precond.load_state_dict(jax_kfac_state_dict_to_torch(first['sd']))
    assert precond.steps == 1
    precond.step(t(tokens), t(labels))
    assert_factors(factors_of(precond), second['factors'])
    assert_close(grads_of(model), second['grads'])


def test_port_state_dict_roundtrip(ref):
    _, precond = port_run(ref['weights'], steps=1)
    sd = precond.state_dict(compress_symmetric=True)
    fresh = PipelineKFACPreconditioner(port_model(ref['weights']), xent,
                                       n_microbatches=M, **HP)
    fresh.load_state_dict(sd)
    for name, st in precond.layers.items():
        for f, v in st.tensors().items():
            assert torch.equal(fresh.layers[name].tensors()[f], v), (name, f)
    assert fresh.memory_usage() == precond.memory_usage()


def test_train_loop_matches_step(ref):
    """The engine's fused loop over the flavour's own forward and
    backward: the same losses as ``step`` and SGD."""
    tokens, labels = data()
    want, _ = port_run(ref['weights'])
    model = port_model(ref['weights'])
    precond = PipelineKFACPreconditioner(model, xent, n_microbatches=M,
                                         **HP)
    loop = precond.train_loop(torch.optim.SGD(model.parameters(),
                                              lr=SGD_LR))
    for step in range(STEPS):
        loss, _ = loop.step(t(tokens), loss_args=(t(labels),))
        assert float(loss) == want[step]['loss']


def test_stage_count_checked_as_jax(ref):
    with pytest.raises(ValueError, match='n_stages'):
        PipelineKFACPreconditioner(port_model(ref['weights'], [0]), xent,
                                   n_microbatches=M)
    with pytest.raises(ValueError, match='mutually exclusive'):
        PipelineKFACPreconditioner(port_model(ref['weights']), xent,
                                   n_microbatches=M, ekfac=True,
                                   lowrank_rank=4)


# -- across ranks ------------------------------------------------------


@pytest.mark.parametrize('step', range(STEPS))
def test_ranks_match_jax_mesh(ref, step):
    """Each rank's loss, stage factors and gradients (its stage's
    blocks, the shared ``embed``/``head``) against JAX's mesh run."""
    want = ref['main'][step]
    for rank, res in enumerate(ref['ranks']):
        s = res['stage']
        got = res['steps'][step]
        what = (rank, step)
        assert abs(got['loss'] - want['loss']) <= TOL * abs(want['loss'])
        assert_factors(got['factors'], want['factors'], s, what)
        assert_close(got['grads'], want['grads'], [s], what)


def test_ranks_hand_off_one_activation_a_tick(ref):
    mb, T, D = 4 // M, 12, CFG['d_model']
    for res in ref['ranks']:
        sends = STEPS * M + M if res['stage'] == 0 else 0
        assert res['handoffs'] == [mb * T * D * 4] * sends


def test_ranks_send_recv_hand_offs_match_broadcast(ref):
    """``PipeLinks``' ``send``/``recv`` branch (NCCL's), driven over gloo
    on CPU tensors from the trained weights: the loss and every gradient
    bitwise those of the pair-group broadcast, the same bytes sent."""
    mb, T, D = 4 // M, 12, CFG['d_model']
    for rank, res in enumerate(ref['ranks']):
        bc, p2p = res['kinds']['broadcast'], res['kinds']['send_recv']
        assert p2p['loss'] == bc['loss'], rank
        assert set(p2p['grads']) == set(bc['grads'])
        for name, g in bc['grads'].items():
            assert torch.equal(p2p['grads'][name], g), (rank, name)
        want = [mb * T * D * 4] * M if res['stage'] == 0 else []
        assert p2p['sent'] == bc['sent'] == want, rank


def test_ranks_save_whole_stacks_and_pipelined_logits(ref):
    """Every rank saves the whole ``[S, ...]`` stacks, the same dict; at
    the initial weights ``apply_pipelined`` gives every pipe rank the
    sequential logits of its data rank's rows."""
    sd0 = ref['ranks'][0]['sd']['layers']
    for rank, res in enumerate(ref['ranks']):
        for name, f in res['sd']['layers'].items():
            assert f['A']['triu'].shape[0] == PIPE
            assert torch.equal(f['A']['triu'], sd0[name]['A']['triu'])
        d = rank % DATA
        np.testing.assert_allclose(res['logits'],
                                   ref['sequential'][d * 4:d * 4 + 4],
                                   rtol=1e-5, atol=2e-5)

if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
