"""The port's compressed factor all-reduce (``factor_comm='bf16_triu'``),
its staggered refresh and its replicated engine across ranks, against
the JAX package's mesh run, on the CPU.

The reference is the JAX ``KFACPreconditioner`` on a 4-device mesh over
a global batch of 16, 5 SGD steps (lr 0.1, factor 1, inv 2) from the
JAX model's weights.  Then four gloo ranks (subprocesses of this file,
started and joined as ``tests/test_torch_distributed.py`` does; they
import no JAX) each take a quarter of the batch from the bridged
weights and apply the JAX run's gradients at every step, so the two
sides see the same weights and differ only in what a step computes.

* ``factor_comm='bf16_triu'``: LeNet under COMM-OPT, HYBRID-OPT and
  MEM-OPT, and the full-coverage ``gpt_tiny`` under HYBRID-OPT (its
  LayerNorm factors and the tied embedding's ``[V]`` diagonal A reduce
  dense; only linear and conv2d factors are packed).  Each rank's
  contribution rounds to bf16 on both sides, but the sums differ: gloo
  adds in bf16, rounding at every addition, where XLA on the CPU
  promotes the bf16 all-reduce to f32 and rounds once.  So the two
  sides are held to the JAX package's own bar for its compressed path
  against the dense one (``tests/test_stagger.py::
  test_factor_comm_bf16_triu_parity``): factor EMAs ``rtol 0.02, atol
  0.02 * max|F|``, preconditioned gradients ``rtol 0.05, atol 5e-3``
  (the largest gap, LeNet's ``fc1.bias`` at step 4, is 7.2% relative
  Frobenius; JAX's own compressed and dense runs differ there by 3.2%).
  The packed factors are exactly symmetric, the parameters stay bitwise
  equal across ranks, and the compressed run differs from the dense
  port run, by at most 8 units of ``2^-8`` of the largest entry (the
  compression really ran).  ``ops.cov_psum_compressed`` on each rank's
  quarter of a ``[64, 24]`` row block against the JAX function on the
  mesh and against float64: the same 8 units.
* ``stagger_refresh=2`` (dense) under HYBRID-OPT and MEM-OPT on LeNet
  (each rank decomposes the shard's slots of its own grid column and
  gathers them over the column), and the replicated engine
  (``bucketed=False``, every rank decomposes every layer) under
  HYBRID-OPT: the refresh of every step, losses, factor EMAs (``rtol
  1e-5, atol 1e-6``) and preconditioned gradients (max abs difference
  ``< 2e-4``, the bars of ``tests/test_parallel.py``) against the JAX
  mesh run with the same option.
* On one rank ``factor_comm`` warns and is ignored; an unknown mode and
  ``factor_comm`` with ``ekfac`` raise as in JAX.
"""
from __future__ import annotations

import datetime
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
from kfac_pytorch_tpu_torch import ops  # noqa: E402
from kfac_pytorch_tpu_torch.models import gpt_tiny  # noqa: E402
from kfac_pytorch_tpu_torch.models import LeNet  # noqa: E402
from kfac_pytorch_tpu_torch.models import TinyModel  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

WORLD = 4
STEPS = 5
LR = 0.1
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR)
GPT_KW = dict(layer_types=('linear', 'conv2d', 'embedding', 'layernorm'),
              tied_weights=('wte',))
#: ``(model, strategy, variant)`` runs; the variant's keywords below.
CASES = [('lenet', 'COMM_OPT', 'bf16'), ('lenet', 'HYBRID_OPT', 'bf16'),
         ('lenet', 'MEM_OPT', 'bf16'), ('gpt', 'HYBRID_OPT', 'bf16'),
         ('lenet', 'HYBRID_OPT', 'dense'),
         ('lenet', 'HYBRID_OPT', 'stagger'), ('lenet', 'MEM_OPT', 'stagger'),
         ('lenet', 'HYBRID_OPT', 'replicated')]
VARIANT_KW = {'bf16': dict(factor_comm='bf16_triu'), 'dense': {},
              'stagger': dict(stagger_refresh=2),
              'replicated': dict(bucketed=False)}
COMPRESSED = [c for c in CASES if c[2] == 'bf16']
#: The dense variants held to the mesh run, and the refresh of each step.
DENSE = {c: (['full', 1, 0, 1, 0] if c[2] == 'stagger'
             else ['full', None, 'full', None, 'full'])
         for c in CASES if c[2] in ('stagger', 'replicated')}
SPAWN_TIMEOUT_S = 180
#: bf16 agreement: units of 2^-8 of the largest entry.
BF16_ULPS = 8


def data(name: str) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(29)
    if name == 'gpt':
        tokens = rng.integers(0, 256, size=(16, 8)).astype(np.int32)
        return tokens, tokens
    x = rng.standard_normal((16, 16, 16, 1)).astype(np.float32)
    return x, rng.integers(0, 10, size=(16,))


def rows() -> np.ndarray:
    return np.random.default_rng(5).standard_normal((64, 24)).astype(
        np.float32)


def port_input(x: np.ndarray) -> torch.Tensor:
    x = x.transpose(0, 3, 1, 2) if x.ndim == 4 else x
    x = torch.from_numpy(np.ascontiguousarray(x))
    return x.long() if not x.is_floating_point() else x


def port_loss(name, out, y):
    if name == 'gpt':
        out, y = out[:, :-1].reshape(-1, out.shape[-1]), y[:, 1:].reshape(-1)
    return F.cross_entropy(out, y)


def train_rank(rank, world, weights, name, strategy, variant, apply=None):
    """One rank's run; each step applies ``apply[step]`` (the JAX run's
    gradients) when given, else its own."""
    x, y = data(name)
    q = len(x) // world
    xl = port_input(x[rank * q:(rank + 1) * q])
    yl = torch.from_numpy(y[rank * q:(rank + 1) * q]).long()
    model = gpt_tiny(device='cpu') if name == 'gpt' else LeNet(image_size=16)
    model.load_state_dict(weights[name], strict=True)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    precond = KFACPreconditioner(
        ddp, grad_worker_fraction=DistributedStrategy[strategy], **HP,
        **(GPT_KW if name == 'gpt' else {}), **VARIANT_KW[variant],
    )
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    steps = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = port_loss(name, ddp(xl), yl)
        loss.backward()
        precond.step()
        steps.append(dict(
            loss=float(loss.detach()), refresh=precond.last_refresh,
            grads={n: p.grad.clone() for n, p in model.named_parameters()},
            factors={n: (st.a_factor.clone(), st.g_factor.clone())
                     for n, st in precond.layers.items()},
        ))
        if apply is None:
            opt.step()
        else:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p -= LR * apply[len(steps) - 1][n]
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        every = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(every, flat)
        steps[-1]['params_equal'] = all(torch.equal(flat, o) for o in every)
    return dict(steps=steps, compressed=sorted(precond._compressed))


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    weights = torch.load(out / 'init.pt')
    applied = torch.load(out / 'ref_grads.pt')
    results = {case: train_rank(rank, world, weights, *case,
                                apply=applied.get(case))
               for case in CASES}
    r = torch.from_numpy(rows())
    q = len(r) // world
    results['cov'] = ops.cov_psum_compressed(r[rank * q:(rank + 1) * q], 2.0)
    try:
        KFACPreconditioner(
            torch.nn.parallel.DistributedDataParallel(TinyModel()),
            factor_comm='bf16_triu', ekfac=True,
        )
        results['ekfac'] = 'no error'
    except ValueError as exc:
        results['ekfac'] = str(exc)
    torch.save(results, out / f'rank{rank}.pt')
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """``(jax results, per-rank port results)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import flax.linen as fnn

    from kfac_pytorch_tpu.enums import DistributedStrategy as JaxStrategy
    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
    from kfac_pytorch_tpu.ops.cov import (
        cov_psum_compressed as jax_cov_psum_compressed,
    )
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from test_torch_distributed import join
    from test_torch_distributed import spawn

    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    out = tmp_path_factory.mktemp('factor_comm')
    jax_models = {'lenet': JaxLeNet(), 'gpt': jax_gpt_tiny()}
    variables = {
        name: jax.tree.map(np.asarray, fnn.meta.unbox(m.init(
            jax.random.PRNGKey(4), data(name)[0],
        )))
        for name, m in jax_models.items()
    }
    torch.save(
        {n: flax_to_torch_state_dict(v) for n, v in variables.items()},
        out / 'init.pt',
    )

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    def lm_loss(logits, tokens):
        logp = jax.nn.log_softmax(logits[:, :-1])
        return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], -1))

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ('data',))
    shard = NamedSharding(mesh, P('data'))
    ref = {}
    for case in CASES:
        name, strategy, variant = case
        if variant == 'dense':
            continue
        x, y = data(name)
        precond = JaxPreconditioner(
            jax_models[name], loss_fn=lm_loss if name == 'gpt' else xent,
            mesh=mesh, grad_worker_fraction=JaxStrategy[strategy], **HP,
            **(GPT_KW if name == 'gpt' else {}), **VARIANT_KW[variant],
        )
        state = precond.init(variables[name], x)
        params = variables[name]['params']
        steps = []
        for _ in range(STEPS):
            loss, _, grads, state = precond.step(
                {'params': params}, state, jax.device_put(x, shard),
                loss_args=(jax.device_put(jnp.asarray(y), shard),),
            )
            grads = jax.tree.map(np.asarray, grads)
            params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
            steps.append(dict(
                loss=float(loss),
                grads=flax_to_torch_state_dict({'params': grads}),
                factors={
                    base.replace('/', '.'): (
                        np.asarray(state[base].a_factor),
                        np.asarray(state[base].g_factor))
                    for base in precond._groups
                },
            ))
        ref[case] = steps
    ref['cov'] = np.asarray(jax_cov_psum_compressed(
            jax.device_put(jnp.asarray(rows()), shard), 2.0, mesh, ('data',),
        ))
    # The ranks apply the JAX run's gradients, so both sides see the
    # same weights at every step and differ only in the reduction.
    torch.save({case: [w['grads'] for w in steps]
                for case, steps in ref.items() if case != 'cov'},
               out / 'ref_grads.pt')
    join(spawn(__file__, WORLD, out), time.time() + SPAWN_TIMEOUT_S)
    ranks = [torch.load(out / f'rank{r}.pt') for r in range(WORLD)]
    return ref, ranks


def bf16_close(got, want) -> float:
    """The largest difference in units of 2^-8 of ``want``'s largest
    entry."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (2.0 ** -8 * np.abs(want).max()))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize('case', COMPRESSED, ids=lambda c: '-'.join(c))
def test_compressed_factors_match_jax_mesh(runs, case):
    ref, ranks = runs
    for res in ranks:
        packed = res[case]['compressed']
        for step, (w, g) in enumerate(zip(ref[case], res[case]['steps'])):
            for layer, (a, gf) in w['factors'].items():
                for side, want in enumerate((a, gf)):
                    got = g['factors'][layer][side].numpy()
                    np.testing.assert_allclose(
                        got, want, rtol=0.02,
                        atol=0.02 * float(np.abs(want).max()),
                        err_msg=f'{step} {layer} {side}',
                    )
                    if layer in packed:
                        np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize('case', COMPRESSED, ids=lambda c: '-'.join(c))
def test_compressed_grads_match_jax_mesh(runs, case):
    ref, ranks = runs
    # The mean of the ranks' local losses is the global batch's.
    np.testing.assert_allclose(
        np.mean([r[case]['steps'][0]['loss'] for r in ranks]),
        ref[case][0]['loss'], rtol=1e-5,
    )
    for res in ranks:
        steps = res[case]['steps']
        for step, (w, g) in enumerate(zip(ref[case], steps)):
            for name, grad in w['grads'].items():
                np.testing.assert_allclose(
                    g['grads'][name].numpy(), np.asarray(grad),
                    rtol=0.05, atol=5e-3, err_msg=f'{step} {name}',
                )
            assert g['params_equal'], step


def test_only_row_statistics_layers_are_packed(runs):
    _, ranks = runs
    lenet = ranks[0]['lenet', 'HYBRID_OPT', 'bf16']['compressed']
    assert lenet == ['conv1', 'conv2', 'fc1', 'fc2', 'fc3']
    gpt = ranks[0]['gpt', 'HYBRID_OPT', 'bf16']['compressed']
    assert gpt and all('ln' not in n and n != 'wte' for n in gpt)


def test_compression_changes_the_result(runs):
    """The compressed run is not the dense one: the bf16 sum ran."""
    _, ranks = runs
    dense = ranks[0]['lenet', 'HYBRID_OPT', 'dense']['steps'][0]['factors']
    bf16 = ranks[0]['lenet', 'HYBRID_OPT', 'bf16']['steps'][0]['factors']
    diffs = [float((dense[n][1] - bf16[n][1]).abs().max()) for n in dense]
    assert max(diffs) > 0
    assert all(bf16_close(bf16[n][1], dense[n][1]) <= BF16_ULPS
               for n in dense)


def test_cov_psum_compressed_matches_jax(runs):
    ref, ranks = runs
    want = ref['cov']
    exact = rows().astype(np.float64)
    exact = exact.T @ exact / (64 * 4.0)
    for res in ranks:
        got = res['cov'].numpy()
        assert got.dtype == np.float32 and got.shape == (24, 24)
        assert bf16_close(got, want) <= BF16_ULPS
        assert bf16_close(got, exact) <= BF16_ULPS
        np.testing.assert_array_equal(got, ranks[0]['cov'].numpy())


@pytest.mark.parametrize('case', list(DENSE), ids=lambda c: '-'.join(c))
def test_dense_variants_across_ranks_match_jax_mesh(runs, case):
    ref, ranks = runs
    np.testing.assert_allclose(
        np.mean([[s['loss'] for s in r[case]['steps']] for r in ranks], 0),
        [w['loss'] for w in ref[case]], rtol=1e-5,
    )
    for res in ranks:
        steps = res[case]['steps']
        assert [s['refresh'] for s in steps] == DENSE[case]
        for step, (w, g) in enumerate(zip(ref[case], steps)):
            for layer, pair in w['factors'].items():
                for side in (0, 1):
                    np.testing.assert_allclose(
                        g['factors'][layer][side].numpy(), pair[side],
                        rtol=1e-5, atol=1e-6,
                        err_msg=f'{step} {layer} {side}',
                    )
            for name, grad in w['grads'].items():
                diff = float(np.abs(g['grads'][name].numpy()
                                    - np.asarray(grad)).max())
                assert diff < 2e-4, (step, name, diff)
            assert g['params_equal'], step


def test_validation_on_every_rank(runs):
    _, ranks = runs
    for res in ranks:
        assert 'mutually exclusive' in res['ekfac']


def test_one_rank_warns_and_ignores():
    with pytest.warns(UserWarning, match='factor_comm'):
        p = KFACPreconditioner(TinyModel(), factor_comm='bf16_triu', **HP)
    assert p.factor_comm is None and not p._compressed
    with pytest.raises(ValueError, match='bf16_triu'):
        KFACPreconditioner(TinyModel(), factor_comm='zstd', **HP)
    with pytest.raises(ValueError, match='mutually exclusive'):
        KFACPreconditioner(TinyModel(), factor_comm='bf16_triu', ekfac=True,
                           **HP)


def test_one_rank_round_trip_is_bf16():
    """Without ranks the packed round trip still rounds to bf16."""
    got = ops.cov_psum_compressed(torch.from_numpy(rows()), 2.0)
    exact = torch.from_numpy(rows()).double()
    exact = exact.T @ exact / (64 * 4.0)
    assert got.dtype == torch.float32
    assert bf16_close(got, exact) <= 1
    assert not torch.equal(got, exact.float())


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    _, _, rank_s, world_s, init_s, out_s = sys.argv
    torch.set_num_threads(1)
    run_rank(int(rank_s), int(world_s), Path(init_s), Path(out_s))
