"""The port's K-FAC across four ranks against the JAX package's mesh run.

Four gloo ranks on the CPU, launched as subprocesses of this file
(``python tests/test_torch_distributed.py --worker RANK WORLD INIT OUT``;
they import no JAX), run COMM-OPT, HYBRID-OPT and MEM-OPT in turn on
``TinyModel`` (``[16, 10]`` inputs) and ``LeNet`` (16x16, for the conv
buckets), then ``compute_method='inverse'`` and ``'iterative'`` under
HYBRID-OPT on ``TinyModel`` (a column gather of the inverses and a row
gather of the gradients), then ``gpt_tiny`` with full coverage (the
tied embedding's diagonal A on the side path every rank runs itself,
the LayerNorm and Dense layers in the buckets) under HYBRID-OPT with
the eigen and the inverse method, 16 sequences of 8 tokens, next-token
cross entropy, then LeNet under COMM-OPT with gradient accumulation
(``accumulation_steps=2``: the global batch of 16 as two micro-batches
of 8, each rank's 2 rows of each under ``no_sync()`` for the first,
against the JAX ``accumulate``/``finalize`` on the mesh), then LeNet
with ``lowrank_rank=16`` under HYBRID-OPT (the truncated buckets' sketch
draws are the JAX package's, computed by the parent and looked up by
each rank under the slot's index in the whole bucket, so a rank that
decomposes a share of its column draws what the mesh run draws) and
with ``ekfac=True`` under COMM-OPT (the scale contributions ride the
factor all-reduce; the scales are compared at a relative Frobenius
``<= 1e-4``, since they live in an ``eigh`` basis), and finally EKFAC
on the HYBRID-OPT grid, which every rank builds and steps
(``tests/test_torch_ekfac_grid.py`` holds it against JAX).  Each rank
wraps the model in
``DistributedDataParallel``,
takes its quarter of the global batch of 16 and trains 5 SGD steps
(lr 0.1) with ``factor_update_steps=1, inv_update_steps=2``, so the
trajectory crosses refreshes at steps 0, 2 and 4.  The reference is the
JAX ``KFACPreconditioner`` on a 4-device mesh over the global batch, from
the same bridged weights, applying its own gradients with the same SGD
update.  Neither model has BatchNorm, so the local batches normalize
nothing per rank.

Compared at every step, on every rank: the preconditioned gradients
(max abs difference ``< 2e-4``) and the factor EMAs (``rtol 1e-5, atol
1e-6``) — the bars of ``tests/test_parallel.py``; the parameters of all
ranks bitwise equal; each rank's decomposition stacks holding only its
grid column's ``seg`` slots.  A spawn that outlives its time limit is
killed and fails its tests.
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

from kfac_pytorch_tpu_torch import DistributedStrategy  # noqa: E402
from kfac_pytorch_tpu_torch import KFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.models import gpt_tiny  # noqa: E402
from kfac_pytorch_tpu_torch.models import LeNet  # noqa: E402
from kfac_pytorch_tpu_torch.models import TinyModel  # noqa: E402

pytestmark = pytest.mark.torch_port

WORLD = 4
STEPS = 5
LR = 0.1
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR)
MODELS = ('tiny', 'lenet')
STRATEGIES = ('COMM_OPT', 'HYBRID_OPT', 'MEM_OPT')
#: ``(model, strategy, compute_method)`` runs of the other methods.
METHOD_CASES = [('tiny', 'HYBRID_OPT', 'inverse'),
                ('tiny', 'HYBRID_OPT', 'iterative')]
#: ``(model, strategy, compute_method)`` runs of the full-coverage GPT.
GPT_CASES = [('gpt', 'HYBRID_OPT', 'eigen'), ('gpt', 'HYBRID_OPT', 'inverse')]
GPT_KW = dict(layer_types=('linear', 'conv2d', 'embedding', 'layernorm'),
              tied_weights=('wte',))
#: ``(model, strategy, accumulation_steps)`` runs with gradient
#: accumulation.
ACCUM_CASES = [('lenet', 'COMM_OPT', 2)]
#: ``(model, strategy, variant)`` runs of the eigen variants.
VARIANT_CASES = [('lenet', 'HYBRID_OPT', 'lowrank'),
                 ('lenet', 'COMM_OPT', 'ekfac')]
VARIANT_KW = {'lowrank': dict(lowrank_rank=16), 'ekfac': dict(ekfac=True)}
SPAWN_TIMEOUT_S = 180
#: Local batch size of each rank, per case.
UNEQUAL_BATCHES = {'one_short': (4, 4, 4, 3), 'mean_equal': (3, 4, 5, 4)}


def data(name: str) -> tuple[np.ndarray, np.ndarray]:
    """The global batch of 16 (NHWC images for LeNet; for the GPT 8
    tokens per sequence, which are their own labels)."""
    rng = np.random.default_rng(21)
    if name == 'gpt':
        tokens = rng.integers(0, 256, size=(16, 8)).astype(np.int32)
        return tokens, tokens
    shape = (16, 10) if name == 'tiny' else (16, 16, 16, 1)
    x = rng.standard_normal(shape).astype(np.float32)
    return x, rng.integers(0, 10, size=(16,))


def port_model(name: str) -> torch.nn.Module:
    if name == 'gpt':
        return gpt_tiny(device='cpu')
    return TinyModel() if name == 'tiny' else LeNet(image_size=16)


def port_input(x: np.ndarray) -> torch.Tensor:
    x = x.transpose(0, 3, 1, 2) if x.ndim == 4 else x
    x = torch.from_numpy(np.ascontiguousarray(x))
    return x.long() if not x.is_floating_point() else x


def port_loss(name, out, y):
    """Cross entropy; next-token for the GPT (``y`` is the tokens)."""
    if name == 'gpt':
        out, y = out[:, :-1].reshape(-1, out.shape[-1]), y[:, 1:].reshape(-1)
    return F.cross_entropy(out, y)


def train_rank(rank, world, weights, name, strategy, method='eigen',
               accumulation=1, **kfac_kw):
    """One rank's trajectory of ``name`` under ``strategy``; with
    ``accumulation`` micro-batches per step (the global batch split in
    order, each rank taking its share of each)."""
    x, y = data(name)
    n = len(x) // accumulation
    q = n // world
    micro = [
        (port_input(x[m * n + rank * q:m * n + (rank + 1) * q]),
         torch.from_numpy(y[m * n + rank * q:m * n + (rank + 1) * q]).long())
        for m in range(accumulation)
    ]
    model = port_model(name)
    model.load_state_dict(weights[name], strict=True)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    precond = KFACPreconditioner(
        ddp, grad_worker_fraction=DistributedStrategy[strategy],
        compute_method=method, accumulation_steps=accumulation, **HP,
        **(GPT_KW if name == 'gpt' else {}), **kfac_kw,
    )
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    steps = []
    for _ in range(STEPS):
        opt.zero_grad()
        for i, (xl, yl) in enumerate(micro):
            sync = i == accumulation - 1
            with (contextlib.nullcontext() if sync else ddp.no_sync()):
                loss = port_loss(name, ddp(xl), yl)
                (loss / accumulation if accumulation > 1 else loss).backward()
        precond.step()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        factors = {
            n: (st.a_factor.clone(), st.g_factor.clone())
            for n, st in precond.layers.items()
        }
        opt.step()
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        every = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(every, flat)
        steps.append(dict(
            grads=grads, factors=factors,
            params_equal=all(torch.equal(flat, o) for o in every),
            skron={k: bs.skron.clone() for k, bs in precond.buckets.items()
                   if bs.skron is not None},
        ))
    grid = precond.grid
    return precond, dict(
        steps=steps,
        grid=(grid.rows, grid.cols, grid.row, grid.col),
        second_order_bytes=precond.memory_usage()['second_order'],
    )


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    """One rank: every (model, strategy) trajectory, saved to ``out``."""
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    weights = torch.load(out / 'init.pt')
    results = {}
    for name in MODELS:
        for strategy in STRATEGIES:
            precond, res = train_rank(rank, world, weights, name, strategy)
            res['held'] = {
                b.key: (b.seg, tuple(precond.buckets[b.key].qa.shape),
                        tuple(precond.buckets[b.key].dgda.shape),
                        precond._second_order.local_slots(b))
                for b in precond.plan.buckets
            }
            results[name, strategy] = res
    for name, strategy, method in METHOD_CASES:
        precond, res = train_rank(
            rank, world, weights, name, strategy, method,
        )
        res['held'] = {
            k: {f: tuple(t.shape) for f, t in bs.tensors().items()}
            for k, bs in precond.buckets.items()
        }
        results[name, strategy, method] = res
    for case in GPT_CASES:
        precond, res = train_rank(rank, world, weights, *case)
        res['diag'] = {
            n: {f: tuple(t.shape) for f, t in
                precond.layers[n].decompositions().items()}
            for n in precond.diag_layers
        }
        res['buckets'] = [b.key for b in precond.plan.buckets]
        results[case] = res
    for name, strategy, n_accum in ACCUM_CASES:
        _, res = train_rank(rank, world, weights, name, strategy,
                            accumulation=n_accum)
        results[name, strategy, n_accum] = res
    from kfac_pytorch_tpu_torch.ops import lowrank

    draws = torch.load(out / 'draws.pt')
    real_draw = lowrank.draw_sketch
    lowrank.draw_sketch = (
        lambda seed, side, step, slot, n, m, device:
        draws[seed, side, step, slot, n, m].to(device))
    try:
        for name, strategy, variant in VARIANT_CASES:
            precond, res = train_rank(rank, world, weights, name, strategy,
                                      **VARIANT_KW[variant])
            res['held'] = {
                k: {f: tuple(t.shape) for f, t in bs.tensors().items()}
                for k, bs in precond.buckets.items()
            }
            results[name, strategy, variant] = res
    finally:
        lowrank.draw_sketch = real_draw
    # EKFAC off COMM-OPT (Queue A item 10b) builds and steps on every
    # rank; tests/test_torch_ekfac_grid.py holds it against JAX.
    try:
        ddp = torch.nn.parallel.DistributedDataParallel(LeNet(image_size=16))
        precond = KFACPreconditioner(
            ddp, ekfac=True,
            grad_worker_fraction=DistributedStrategy.HYBRID_OPT, **HP,
        )
        x, y = data('lenet')
        q = len(x) // world
        port_loss('lenet', ddp(port_input(x[rank * q:(rank + 1) * q])),
                  torch.from_numpy(y[rank * q:(rank + 1) * q]).long(),
                  ).backward()
        precond.step()
        results['ekfac_cols'] = (
            f'stepped on {precond.grid.rows}x{precond.grid.cols}, '
            f'divergence finite: '
            f'{bool(torch.isfinite(precond.last_ekfac_divergence))}'
        )
    except NotImplementedError as exc:
        results['ekfac_cols'] = str(exc)
    # Unequal local batches raise on every rank, so no rank goes on into
    # a collective that the others skip.  In the second case the mean
    # count equals ranks 1 and 3's own.
    x, y = data('tiny')
    for case, sizes in UNEQUAL_BATCHES.items():
        ddp = torch.nn.parallel.DistributedDataParallel(TinyModel())
        precond = KFACPreconditioner(ddp, **HP)
        n = sizes[rank]
        F.cross_entropy(
            ddp(port_input(x[:n])), torch.from_numpy(y[:n]),
        ).backward()
        try:
            precond.step()
            results['unequal', case] = 'no error'
        except RuntimeError as exc:
            results['unequal', case] = str(exc)
    torch.save(results, out / f'rank{rank}.pt')
    dist.destroy_process_group()


def spawn(script: str, world: int, out: Path) -> list[subprocess.Popen]:
    """Start ``world`` gloo ranks of ``script`` (``--worker RANK WORLD
    INIT OUT``); they meet through a file under ``out``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    return [
        subprocess.Popen(
            [sys.executable, script, '--worker', str(rank), str(world),
             str(out / 'pg_init'), str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]


def join(procs: list[subprocess.Popen], deadline: float) -> None:
    """Wait for every rank until ``deadline``; kill them all and fail on
    a timeout or a non-zero exit."""
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            logs.append(out)
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
def runs(tmp_path_factory):
    """``(jax trajectories, per-rank port results)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import flax.linen as fnn

    from kfac_pytorch_tpu.enums import DistributedStrategy as JaxStrategy
    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    out = tmp_path_factory.mktemp('kaisa')
    jax_models = {'tiny': JaxTiny(), 'lenet': JaxLeNet(),
                  'gpt': jax_gpt_tiny()}
    variables = {
        name: jax.tree.map(np.asarray, fnn.meta.unbox(m.init(
            jax.random.PRNGKey(2), data(name)[0],
        )))
        for name, m in jax_models.items()
    }
    torch.save(
        {n: flax_to_torch_state_dict(v) for n, v in variables.items()},
        out / 'init.pt',
    )
    torch.save(jax_lowrank_draws(), out / 'draws.pt')
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = spawn(__file__, WORLD, out)

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    def lm_loss(logits, tokens):
        logp = jax.nn.log_softmax(logits[:, :-1])
        return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], -1))

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ('data',))
    shard = NamedSharding(mesh, P('data'))
    ref = {}
    try:
        for name in MODELS:
            model = jax_models[name]
            x, y = data(name)
            xs = jax.device_put(x, shard)
            ys = jax.device_put(jnp.asarray(y), shard)
            for strategy in STRATEGIES:
                precond = JaxPreconditioner(
                    model, loss_fn=xent, mesh=mesh,
                    grad_worker_fraction=JaxStrategy[strategy], **HP,
                )
                state = precond.init(variables[name], x)
                params = variables[name]['params']
                steps = []
                for _ in range(STEPS):
                    _, _, grads, state = precond.step(
                        {'params': params}, state, xs, loss_args=(ys,),
                    )
                    grads = jax.tree.map(np.asarray, grads)
                    params = jax.tree.map(
                        lambda w, g: w - LR * g, params, grads,
                    )
                    steps.append(dict(
                        grads=flax_to_torch_state_dict({'params': grads}),
                        factors={
                            base: (np.asarray(state[base].a_factor),
                                   np.asarray(state[base].g_factor))
                            for base in state.layers
                        },
                    ))
                ref[name, strategy] = steps
        for name, strategy, method in METHOD_CASES + GPT_CASES:
            x, y = data(name)
            precond = JaxPreconditioner(
                jax_models[name], loss_fn=lm_loss if name == 'gpt' else xent,
                mesh=mesh, grad_worker_fraction=JaxStrategy[strategy],
                compute_method=method, **HP,
                **(GPT_KW if name == 'gpt' else {}),
            )
            state = precond.init(variables[name], x)
            params = variables[name]['params']
            steps = []
            for _ in range(STEPS):
                _, _, grads, state = precond.step(
                    {'params': params}, state,
                    jax.device_put(x, shard),
                    loss_args=(jax.device_put(jnp.asarray(y), shard),),
                )
                grads = jax.tree.map(np.asarray, grads)
                params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
                steps.append(dict(
                    grads=flax_to_torch_state_dict({'params': grads}),
                    factors={
                        base.replace('/', '.'): (
                            np.asarray(state[base].a_factor),
                            np.asarray(state[base].g_factor))
                        for base in state.layers
                    },
                ))
            ref[name, strategy, method] = steps
        for name, strategy, n_accum in ACCUM_CASES:
            x, y = data(name)
            n = len(x) // n_accum
            precond = JaxPreconditioner(
                jax_models[name], loss_fn=xent, mesh=mesh,
                grad_worker_fraction=JaxStrategy[strategy],
                accumulation_steps=n_accum, **HP,
            )
            state = precond.init(variables[name], x)
            accum = precond.init_accum()
            params = variables[name]['params']
            steps = []
            for _ in range(STEPS):
                total = None
                for m in range(n_accum):
                    _, _, grads, accum = precond.accumulate(
                        {'params': params}, state, accum,
                        jax.device_put(x[m * n:(m + 1) * n], shard),
                        loss_args=(jax.device_put(
                            jnp.asarray(y[m * n:(m + 1) * n]), shard),),
                    )
                    total = grads if total is None else jax.tree.map(
                        jnp.add, total, grads)
                grads, state, accum = precond.finalize(
                    state, jax.tree.map(lambda g: g / n_accum, total), accum,
                )
                grads = jax.tree.map(np.asarray, grads)
                params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
                steps.append(dict(
                    grads=flax_to_torch_state_dict({'params': grads}),
                    factors={
                        base: (np.asarray(state[base].a_factor),
                               np.asarray(state[base].g_factor))
                        for base in state.layers
                    },
                ))
            ref[name, strategy, n_accum] = steps
        for name, strategy, variant in VARIANT_CASES:
            x, y = data(name)
            precond = JaxPreconditioner(
                jax_models[name], loss_fn=xent, mesh=mesh,
                grad_worker_fraction=JaxStrategy[strategy], **HP,
                **VARIANT_KW[variant],
            )
            state = precond.init(variables[name], x)
            params = variables[name]['params']
            steps = []
            for _ in range(STEPS):
                _, _, grads, state = precond.step(
                    {'params': params}, state, jax.device_put(x, shard),
                    loss_args=(jax.device_put(jnp.asarray(y), shard),),
                )
                grads = jax.tree.map(np.asarray, grads)
                params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
                steps.append(dict(
                    grads=flax_to_torch_state_dict({'params': grads}),
                    factors={
                        base: (np.asarray(state[base].a_factor),
                               np.asarray(state[base].g_factor))
                        for base in state.layers
                    },
                    skron={k: np.asarray(bs.skron)
                           for k, bs in state.buckets.items()
                           if bs.skron is not None},
                    lowrank=dict(precond._second_order._lowrank),
                ))
            ref[name, strategy, variant] = steps
    finally:
        join(procs, deadline)
    ranks = [torch.load(out / f'rank{r}.pt') for r in range(WORLD)]
    return ref, ranks


def jax_lowrank_draws() -> dict:
    """The JAX bucketed stage's sketch for every ``(bucket seed, side,
    step, slot, n, m)`` LeNet's low-rank run can draw (its buckets'
    padded dims, both sides, the refresh steps, up to four slots):
    ``normal(fold_in(fold_in(fold_in(PRNGKey(seed), side), step),
    slot), (n, n_sketch))`` as torch tensors."""
    import zlib

    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu_torch.capture import ModelCapture
    from kfac_pytorch_tpu_torch.parallel.bucketing import pad_dim

    k = VARIANT_KW['lowrank']['lowrank_rank']
    m = k + 32
    helpers = ModelCapture(LeNet(image_size=16), skip_layers=(),
                           layer_types=('linear', 'conv2d'),
                           kfac_approx='expand', tied_weights=()).helpers
    out = {}
    for h in helpers.values():
        a, g = pad_dim(h.a_factor_shape[0]), pad_dim(h.g_factor_shape[0])
        seed = zlib.crc32(f'a{a}g{g}'.encode())
        for side, n in enumerate((a, g)):
            if not (n >= 2 * k and m < n):
                continue
            for step in range(0, STEPS, HP['inv_update_steps']):
                for slot in range(4):
                    key = jax.random.fold_in(jax.random.fold_in(
                        jax.random.fold_in(jax.random.PRNGKey(seed), side),
                        step), slot)
                    out[seed, side, step, slot, n, m] = torch.from_numpy(
                        np.array(jax.random.normal(key, (n, m),
                                                   jnp.float32)))
    return out


CASES = [(m, s) for m in MODELS for s in STRATEGIES]
IDS = [f'{m}-{s}' for m, s in CASES]


@pytest.mark.parametrize('name,strategy', CASES, ids=IDS)
def test_preconditioned_grads_match_jax(runs, name, strategy):
    ref, ranks = runs
    for rank, res in enumerate(ranks):
        for step, (got, want) in enumerate(zip(
                res[name, strategy]['steps'], ref[name, strategy])):
            assert set(got['grads']) == set(want['grads'])
            diff = max(
                float((got['grads'][n] - want['grads'][n]).abs().max())
                for n in want['grads']
            )
            assert diff < 2e-4, (rank, step, diff)


@pytest.mark.parametrize('name,strategy', CASES, ids=IDS)
def test_factor_emas_match_jax(runs, name, strategy):
    ref, ranks = runs
    for res in ranks:
        for got, want in zip(res[name, strategy]['steps'],
                             ref[name, strategy]):
            assert set(got['factors']) == set(want['factors'])
            for layer, (a, g) in want['factors'].items():
                np.testing.assert_allclose(
                    got['factors'][layer][0].numpy(), a, rtol=1e-5,
                    atol=1e-6,
                )
                np.testing.assert_allclose(
                    got['factors'][layer][1].numpy(), g, rtol=1e-5,
                    atol=1e-6,
                )


@pytest.mark.parametrize('name,strategy', CASES, ids=IDS)
def test_parameters_bitwise_equal_across_ranks(runs, name, strategy):
    _, ranks = runs
    for rank, res in enumerate(ranks):
        flags = [s['params_equal'] for s in res[name, strategy]['steps']]
        assert flags == [True] * STEPS, (rank, flags)


@pytest.mark.parametrize('name,strategy', CASES, ids=IDS)
def test_rank_holds_its_column_slots(runs, name, strategy):
    _, ranks = runs
    rows, cols = {'COMM_OPT': (4, 1), 'HYBRID_OPT': (2, 2),
                  'MEM_OPT': (1, 4)}[strategy]
    for rank, res in enumerate(ranks):
        run = res[name, strategy]
        assert run['grid'] == (rows, cols, rank // cols, rank % cols)
        total = 0
        for key, (seg, qa_shape, dgda_shape, slots) in run['held'].items():
            assert qa_shape[0] == seg and dgda_shape[0] == seg, key
            assert len(slots) == seg
            # qa, qg, dgda and bake_damping, all f32.
            total += 4 * (qa_shape[0] * qa_shape[1] * qa_shape[2]
                          + seg * dgda_shape[1] ** 2
                          + seg * dgda_shape[1] * dgda_shape[2] + seg)
        assert run['second_order_bytes'] == total


METHOD_IDS = [f'{m}-{s}-{c}' for m, s, c in METHOD_CASES]


@pytest.mark.parametrize('case', METHOD_CASES, ids=METHOD_IDS)
def test_methods_preconditioned_grads_match_jax(runs, case):
    ref, ranks = runs
    for rank, res in enumerate(ranks):
        for step, (got, want) in enumerate(zip(res[case]['steps'],
                                               ref[case])):
            assert set(got['grads']) == set(want['grads'])
            diff = max(
                float((got['grads'][n] - want['grads'][n]).abs().max())
                for n in want['grads']
            )
            assert diff < 2e-4, (rank, step, diff)


@pytest.mark.parametrize('case', METHOD_CASES, ids=METHOD_IDS)
def test_methods_factor_emas_match_jax(runs, case):
    ref, ranks = runs
    for res in ranks:
        for got, want in zip(res[case]['steps'], ref[case]):
            for layer, (a, g) in want['factors'].items():
                for side, w in enumerate((a, g)):
                    np.testing.assert_allclose(
                        got['factors'][layer][side].numpy(), w, rtol=1e-5,
                        atol=1e-6,
                    )


@pytest.mark.parametrize('case', METHOD_CASES, ids=METHOD_IDS)
def test_methods_parameters_bitwise_equal_across_ranks(runs, case):
    _, ranks = runs
    for rank, res in enumerate(ranks):
        flags = [s['params_equal'] for s in res[case]['steps']]
        assert flags == [True] * STEPS, (rank, flags)


@pytest.mark.parametrize('case', METHOD_CASES, ids=METHOD_IDS)
def test_methods_hold_their_fields_on_column_slots(runs, case):
    """Each rank keeps its column's ``seg`` slots of the method's fields
    (square inverses, and per-slot residual vectors when iterative)."""
    _, ranks = runs
    fields = {'a_inv', 'g_inv'}
    if case[2] == 'iterative':
        fields |= {f'iter_{k}_{s}' for k in ('res', 'bound', 'stale')
                   for s in 'ag'}
    for res in ranks:
        run = res[case]
        assert run['grid'][:2] == (2, 2)
        total = 0
        for key, shapes in run['held'].items():
            assert set(shapes) == fields, key
            seg = shapes['a_inv'][0]
            assert all(shape[0] == seg for shape in shapes.values())
            total += sum(4 * np.prod(shape) for shape in shapes.values())
        assert run['second_order_bytes'] == total


GPT_IDS = [f'{m}-{s}-{c}' for m, s, c in GPT_CASES]


@pytest.mark.parametrize('case', GPT_CASES, ids=GPT_IDS)
def test_gpt_preconditioned_grads_match_jax(runs, case):
    ref, ranks = runs
    for rank, res in enumerate(ranks):
        for step, (got, want) in enumerate(zip(res[case]['steps'],
                                               ref[case])):
            assert set(got['grads']) == set(want['grads'])
            for n in want['grads']:
                diff = float((got['grads'][n] - want['grads'][n]).abs().max())
                assert diff < 2e-4, (rank, step, n, diff)


@pytest.mark.parametrize('case', GPT_CASES, ids=GPT_IDS)
def test_gpt_factor_emas_match_jax(runs, case):
    """The tied embedding's ``[V]`` diagonal and ``[D, D]`` G ride the
    factor all-reduce with the buckets' factors."""
    ref, ranks = runs
    for res in ranks:
        for got, want in zip(res[case]['steps'], ref[case]):
            assert set(got['factors']) == set(want['factors'])
            assert got['factors']['wte'][0].shape == (256,)
            for layer, (a, g) in want['factors'].items():
                for side, w in enumerate((a, g)):
                    np.testing.assert_allclose(
                        got['factors'][layer][side].numpy(), w, rtol=1e-5,
                        atol=1e-6,
                    )


@pytest.mark.parametrize('case', GPT_CASES, ids=GPT_IDS)
def test_gpt_side_path_is_replicated(runs, case):
    """Every rank holds the diagonal layer's whole decomposition (the
    side path is not sharded) and keeps it out of the buckets; the
    parameters stay bitwise equal across ranks."""
    _, ranks = runs
    fields = ({'qg': (32, 32), 'dg': (32,), 'da': (256,)}
              if case[2] == 'eigen' else
              {'g_inv': (32, 32), 'a_inv': (256,)})
    for rank, res in enumerate(ranks):
        run = res[case]
        assert run['diag'] == {'wte': fields}
        assert run['buckets'] == ['a64g128', 'a128g32', 'a64g64', 'a64g32',
                                  'a32g32']
        flags = [s['params_equal'] for s in run['steps']]
        assert flags == [True] * STEPS, (rank, flags)


ACCUM_IDS = [f'{m}-{s}-N{n}' for m, s, n in ACCUM_CASES]


@pytest.mark.parametrize('case', ACCUM_CASES, ids=ACCUM_IDS)
def test_accumulation_matches_jax_finalize(runs, case):
    """Preconditioned gradients (max abs ``< 2e-4``) and factor EMAs
    (``rtol 1e-5, atol 1e-6``) of N backwards then ``step()`` on every
    rank against the JAX mesh's ``accumulate`` x N then ``finalize``."""
    ref, ranks = runs
    for rank, res in enumerate(ranks):
        for step, (got, want) in enumerate(zip(res[case]['steps'],
                                               ref[case])):
            assert set(got['grads']) == set(want['grads'])
            diff = max(
                float((got['grads'][n] - want['grads'][n]).abs().max())
                for n in want['grads']
            )
            assert diff < 2e-4, (rank, step, diff)
            for layer, (a, g) in want['factors'].items():
                for side, w in enumerate((a, g)):
                    np.testing.assert_allclose(
                        got['factors'][layer][side].numpy(), w, rtol=1e-5,
                        atol=1e-6,
                    )


@pytest.mark.parametrize('case', ACCUM_CASES, ids=ACCUM_IDS)
def test_accumulation_parameters_bitwise_equal_across_ranks(runs, case):
    _, ranks = runs
    for rank, res in enumerate(ranks):
        flags = [s['params_equal'] for s in res[case]['steps']]
        assert flags == [True] * STEPS, (rank, flags)


VARIANT_IDS = [f'{m}-{s}-{v}' for m, s, v in VARIANT_CASES]


@pytest.mark.parametrize('case', VARIANT_CASES, ids=VARIANT_IDS)
def test_variants_match_jax_mesh(runs, case):
    """Preconditioned gradients (max abs ``< 2e-4``), factor EMAs
    (``rtol 1e-5, atol 1e-6``) and, under EKFAC, every bucket's scales
    (relative Frobenius ``<= 1e-4``) on every rank against the JAX mesh
    run; parameters bitwise equal across ranks."""
    ref, ranks = runs
    for rank, res in enumerate(ranks):
        for step, (got, want) in enumerate(zip(res[case]['steps'],
                                               ref[case])):
            assert set(got['grads']) == set(want['grads'])
            diff = max(
                float((got['grads'][n] - want['grads'][n]).abs().max())
                for n in want['grads']
            )
            assert diff < 2e-4, (rank, step, diff)
            for layer, (a, g) in want['factors'].items():
                for side, w in enumerate((a, g)):
                    np.testing.assert_allclose(
                        got['factors'][layer][side].numpy(), w, rtol=1e-5,
                        atol=1e-6,
                    )
            assert set(got['skron']) == set(want['skron'])
            for key, s in want['skron'].items():
                err = float(np.linalg.norm(got['skron'][key].numpy() - s)
                            / np.linalg.norm(s))
                assert err <= 1e-4, (rank, step, key, err)
            assert got['params_equal'], (rank, step)


def test_lowrank_holds_thin_column_slots(runs):
    """HYBRID-OPT: each rank keeps its column's ``seg`` slots of the thin
    stacks (and of ``dgda`` on the exact bucket), truncated as the JAX
    plan truncates."""
    ref, ranks = runs
    case = ('lenet', 'HYBRID_OPT', 'lowrank')
    engaged = ref[case][0]['lowrank']
    assert any(la or lg for la, lg in engaged.values())
    for res in ranks:
        assert res[case]['grid'][:2] == (2, 2)
        for key, shapes in res[case]['held'].items():
            la, lg = engaged[key]
            assert ('dgda' in shapes) == (not (la or lg)), key
            a, g = (int(v) for v in key[1:].split('g'))
            assert shapes['qa'][1:] == (a, 16 if la else a), key
            assert shapes['qg'][1:] == (g, 16 if lg else g), key
            assert ('sa' in shapes) == la and ('sg' in shapes) == lg


def test_ekfac_off_comm_opt_raises_on_every_rank(runs):
    """EKFAC off COMM-OPT (here HYBRID-OPT) steps on every rank: each
    rank builds it and takes a step with a finite drift.  The name is
    kept from when the port raised there; a raise would now be caught,
    recorded and fail the comparison below."""
    _, ranks = runs
    for rank, res in enumerate(ranks):
        assert res['ekfac_cols'] == (
            'stepped on 2x2, divergence finite: True'), (rank,
                                                         res['ekfac_cols'])


@pytest.mark.parametrize('case', list(UNEQUAL_BATCHES))
def test_unequal_local_batches_raise_on_every_rank(runs, case):
    _, ranks = runs
    for rank, res in enumerate(ranks):
        assert 'local batch sizes differ' in res['unequal', case], rank


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    _, _, rank_s, world_s, init_s, out_s = sys.argv
    torch.set_num_threads(1)
    run_rank(int(rank_s), int(world_s), Path(init_s), Path(out_s))
