"""The port's drift-adaptive staggered refresh (``adaptive=``) against
the JAX package's, on the CPU.

* The controller: the JAX ``AdaptiveRefreshController`` and the port's
  are fed the same sketch and digest sequences (randomized drives over
  several configurations: digests that repeat, residual columns, tight
  and loose floors, a budget spent mid-interval); every decision, the
  counters, ``events``, ``ages`` and ``state_dict`` must be identical,
  and so must the restore (``load_state_dict``) of each.
* ``drift_info``: on LeNet's factor-EMA states from a JAX run (eigen,
  and iterative for the residual column), the port's digest equals
  JAX's bitwise (u32 values held in int64) and its sketch agrees within
  ``rtol 1e-6``; after a step of ``gpt_tiny`` with full coverage the
  port's layer states carry the fields JAX digests, the diagonal-A
  side path's decompositions included.
* The engine: LeNet at 12x12, batch 8, ``stagger_refresh=2``,
  ``inv_update_steps=4``, ``AdaptiveRefreshConfig(0.05,
  staleness_factor=3, record_events=True)``, 16 steps against the JAX
  engine from the same weights with the same SGD updates: the same
  decision events and counters, losses ``rtol 1e-5``, factor EMAs
  ``<= 1e-5`` and preconditioned gradients ``<= 1e-4`` (relative
  Frobenius); one host read of the drift per opportunity step.  A
  checkpoint keeps the counters and restarts the ages and references.
* Across ranks: four gloo ranks (subprocesses of this file, as
  ``tests/test_torch_distributed.py`` runs them) train LeNet under
  HYBRID-OPT with the adaptive cadence, eigen and iterative; every rank
  must make the same decisions from the same sketch and digest, the
  residual column assembled from every grid column by the one
  ``all_reduce(MAX)``.  The JAX package's grid ``drift_info`` goes
  through ``consistency._shard_map(check_rep=False)``, which jax 0.9.0
  no longer accepts (the reference's own ``tests/test_consistency.py``
  fails there), so the JAX comparison is made on one device only.
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

from kfac_pytorch_tpu_torch import AdaptiveRefreshConfig  # noqa: E402
from kfac_pytorch_tpu_torch import DistributedStrategy  # noqa: E402
from kfac_pytorch_tpu_torch import KFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.models import LeNet  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

LR = 0.1
STEPS = 16
HP = dict(factor_update_steps=1, inv_update_steps=4, damping=0.003, lr=LR)
ADAPTIVE = dict(threshold=0.05, staleness_factor=3, record_events=True)
WORLD = 4
SPAWN_TIMEOUT_S = 180


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def batches(steps=STEPS, n=8):
    rng = np.random.default_rng(43)
    return [(rng.standard_normal((n, 12, 12, 1)).astype(np.float32),
             rng.integers(0, 10, size=(n,))) for _ in range(steps)]


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# -- the controller on the same feed ---------------------------------------

LAYERS = ('l0', 'l1', 'l2', 'l3', 'l4')
SHARDS = (('l0', 'l1'), ('l2', 'l3'), ('l4',))


def controllers(**cfg):
    from kfac_pytorch_tpu import scheduler as jsched

    from kfac_pytorch_tpu_torch import scheduler as psched

    return [
        ctl_cls(cfg_cls(**cfg), layer_names=LAYERS, shard_layers=SHARDS)
        for cfg_cls, ctl_cls in (
            (jsched.AdaptiveRefreshConfig, jsched.AdaptiveRefreshController),
            (psched.AdaptiveRefreshConfig, psched.AdaptiveRefreshController),
        )
    ]


def feed(seed, steps):
    """Per step a sketch ``[5, 3]`` (random walks, some rows frozen for
    stretches) and a u32 digest that repeats while a row is frozen."""
    rng = np.random.RandomState(seed)
    sketch = np.abs(rng.randn(len(LAYERS), 3)).astype(np.float32) + 0.5
    digest = rng.randint(0, 2 ** 32, size=(len(LAYERS), 2),
                         dtype=np.uint64).astype(np.uint32)
    out = []
    for _ in range(steps):
        moving = rng.rand(len(LAYERS)) < 0.6
        sketch = sketch.copy()
        sketch[moving, :2] *= rng.uniform(0.9, 1.3, size=(moving.sum(), 2))
        sketch[:, 2] = np.where(rng.rand(len(LAYERS)) < 0.2,
                                rng.uniform(0, 0.5, len(LAYERS)), 0.0)
        digest = digest.copy()
        digest[moving] = rng.randint(0, 2 ** 32, size=(moving.sum(), 2),
                                     dtype=np.uint64).astype(np.uint32)
        out.append((sketch.astype(np.float32), digest))
    return out


@pytest.mark.parametrize('seed,inv,cfg', [
    (0, 4, dict(threshold=0.1, staleness_factor=2)),
    (1, 4, dict(threshold=0.3, staleness_factor=3)),
    (2, 6, dict(threshold=0.05, staleness_factor=2, residual_weight=0.0)),
    (3, 5, dict(threshold=1.0, staleness_factor=4)),
    (4, 3, dict(threshold=0.2, staleness_factor=3, residual_weight=2.0)),
])
def test_controller_matches_jax_on_the_same_feed(seed, inv, cfg):
    jax_ctl, port_ctl = controllers(record_events=True, **cfg)
    stream = feed(seed, 60)
    for step, (sk, dg) in enumerate(stream):
        # The drift of the previous factor step, as the engine reads it.
        sk, dg = stream[step - 1] if step else (None, None)
        decisions = []
        for ctl in (jax_ctl, port_ctl):
            if step == 0:
                ctl.note_full(0, sketch=stream[0][0], digest=stream[0][1])
                decisions.append('full')
            elif step % inv < ctl.n_shards:
                decisions.append(ctl.decide(
                    step, inv, sketch=sk,
                    digest=dg if step % 7 else None,
                ))
            else:
                decisions.append('none')
            ctl.commit(step)
        assert decisions[0] == decisions[1], step
        assert jax_ctl.ages == port_ctl.ages, step
    assert jax_ctl.events == port_ctl.events
    assert jax_ctl.counters() == port_ctl.counters()
    assert jax_ctl.state_dict() == port_ctl.state_dict()
    assert sum(port_ctl.counters().values()) > 0
    kinds = {e[1] for e in port_ctl.events}
    assert {'early', 'skip'} <= kinds, kinds
    # The restore: counters kept, cadence state reset, alike.
    sd = port_ctl.state_dict()
    for ctl in controllers(record_events=True, **cfg):
        ctl.load_state_dict(sd)
        assert ctl.counters() == port_ctl.counters()
        assert ctl.ages == [0] * 3 and ctl._ref_sketch is None
        assert ctl.decide(inv, inv) == 0


def test_budget_and_floor_hold_on_a_wild_feed():
    """Every shard at most once per interval; every age at decision
    time at most ``staleness_factor * inv - 1``."""
    _, ctl = controllers(threshold=0.01, staleness_factor=2,
                         record_events=True)
    inv = 4
    for step, (sk, dg) in enumerate(feed(9, 80)):
        if step == 0:
            ctl.note_full(0, sketch=sk, digest=dg)
        elif step % inv < ctl.n_shards:
            ctl.decide(step, inv, sketch=sk, digest=dg)
        ctl.commit(step)
    seen = {}
    for step, kind, shard, age in ctl.events:
        assert age <= 2 * inv - 1, (step, age)
        if shard is not None:
            key = (step // inv, shard)
            assert key not in seen, (step, shard)
            seen[key] = step


def test_config_validation_matches_jax():
    from kfac_pytorch_tpu import scheduler as jsched

    for kw in (dict(threshold=0.0), dict(staleness_factor=1),
               dict(staleness_factor=2.5), dict(residual_weight=-1.0),
               dict(eps=0.0)):
        with pytest.raises(ValueError) as want:
            jsched.AdaptiveRefreshConfig(**kw)
        with pytest.raises(ValueError) as got:
            AdaptiveRefreshConfig(**kw)
        assert str(got.value) == str(want.value)
    assert AdaptiveRefreshConfig(staleness_factor=3).floor(10) == 30


def test_engine_validation():
    net = LeNet(image_size=12)
    with pytest.raises(TypeError, match='AdaptiveRefreshConfig'):
        KFACPreconditioner(net, stagger_refresh=2, adaptive=object(), **HP)
    with pytest.raises(ValueError, match='stagger_refresh'):
        KFACPreconditioner(net, adaptive=AdaptiveRefreshConfig(), **HP)
    from kfac_pytorch_tpu_torch import AdaptiveRefresh

    with pytest.raises(ValueError, match='one or the other'):
        KFACPreconditioner(
            net, stagger_refresh=2, adaptive=AdaptiveRefreshConfig(),
            ekfac=True, adaptive_refresh=AdaptiveRefresh(), **HP,
        )


# -- drift_info against JAX's ------------------------------------------------


@pytest.mark.parametrize('method', ['eigen', 'iterative'])
def test_drift_info_matches_jax(method):
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu import adaptive as jadaptive
    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    from kfac_pytorch_tpu_torch import adaptive
    from kfac_pytorch_tpu_torch.parallel.second_order import BucketSecond
    from kfac_pytorch_tpu_torch.state import LayerKFACState

    data = batches(3)
    model = JaxLeNet()
    variables = model.init(jax.random.PRNGKey(3), data[0][0])

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))

    jp = JaxPreconditioner(model, loss_fn=xent, compute_method=method, **HP)
    state = jp.init(variables, data[0][0])
    for x, y in data:
        _, _, _, state = jp.step(variables, state, x,
                                 loss_args=(jnp.asarray(y),))
    want = jadaptive.drift_info(
        dict(state.layers), state.buckets, jp._second_order.plan.buckets,
        None,
    )
    port = KFACPreconditioner(LeNet(image_size=12),
                              compute_method=method, **HP)
    layers = {
        name: LayerKFACState(**{
            f: torch.from_numpy(np.array(getattr(st, f)))
            for f in ('a_factor', 'g_factor', 'qa', 'da', 'qg', 'dg',
                      'dgda', 'a_inv', 'g_inv')
            if getattr(st, f) is not None
        })
        for name, st in state.layers.items()
    }
    buckets = {
        key: BucketSecond(**{
            f: torch.from_numpy(np.array(v))
            for f, v in vars(bs).items()
            if f in BucketSecond.__dataclass_fields__ and v is not None
        })
        for key, bs in state.buckets.items()
    }
    got = adaptive.drift_info(layers, buckets, port.plan.buckets, port.grid)
    np.testing.assert_array_equal(
        got['adaptive/digest'].numpy(),
        np.asarray(want['adaptive/digest']).astype(np.int64),
    )
    np.testing.assert_allclose(got['adaptive/sketch'].numpy(),
                               np.asarray(want['adaptive/sketch']),
                               rtol=1e-6, atol=0)
    if method == 'iterative':
        assert (got['adaptive/sketch'][:, 2] > 0).all()


def test_digested_fields_match_jax():
    """``drift_info`` digests every set field of a layer's state, sorted
    by name: after a step of ``gpt_tiny`` with full coverage the port's
    ``LayerKFACState`` carries the fields the JAX state carries, the
    factors of every bucketed layer and the diagonal-A side path's
    decompositions too (``wte``: ``a_factor, da, dg, g_factor, qg``)."""
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu import consistency
    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    from kfac_pytorch_tpu_torch import adaptive
    from kfac_pytorch_tpu_torch.models import gpt_tiny

    kw = dict(layer_types=('linear', 'conv2d', 'embedding', 'layernorm'),
              tied_weights=('wte',), **HP)
    tokens = np.random.default_rng(3).integers(0, 256, (4, 8)).astype(
        np.int32)

    def lm(logits, t):
        logp = jax.nn.log_softmax(logits[:, :-1])
        return -jnp.mean(jnp.take_along_axis(logp, t[:, 1:, None], -1))

    import flax.linen as fnn

    model = jax_gpt_tiny()
    variables = fnn.meta.unbox(model.init(jax.random.PRNGKey(0), tokens))
    jp = JaxPreconditioner(model, loss_fn=lm, **kw)
    state = jp.init(variables, tokens)
    _, _, _, state = jp.step(variables, state, tokens,
                             loss_args=(jnp.asarray(tokens),))
    want = {b.replace('/', '.'): [f for f, _ in
                                  consistency._array_fields(state[b])]
            for b in jp._groups}
    net = gpt_tiny(device='cpu')
    port = KFACPreconditioner(net, **kw)
    logits = net(torch.from_numpy(tokens).long())
    F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                    torch.from_numpy(tokens[:, 1:]).long().reshape(-1),
                    ).backward()
    port.step()
    got = {n: [f for f, _ in adaptive._array_fields(st)]
           for n, st in port.layers.items()}
    assert got == want
    assert got['wte'] == ['a_factor', 'da', 'dg', 'g_factor', 'qg']


# -- the engine against JAX's --------------------------------------------------


def jax_run(data, variables, method='eigen'):
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from kfac_pytorch_tpu.scheduler import (
        AdaptiveRefreshConfig as JaxConfig,
    )

    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))

    jp = JaxPreconditioner(
        JaxLeNet(), loss_fn=xent, stagger_refresh=2, compute_method=method,
        adaptive=JaxConfig(**ADAPTIVE), **HP,
    )
    state = jp.init(variables, data[0][0])
    params = variables['params']
    out = []
    for x, y in data:
        loss, _, grads, state = jp.step(
            {'params': params}, state, x, loss_args=(jnp.asarray(y),))
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        out.append(dict(
            loss=float(loss),
            factors={b: (np.asarray(state[b].a_factor),
                         np.asarray(state[b].g_factor))
                     for b in state.layers},
            grads=flax_to_torch_state_dict({'params': grads}),
        ))
    return jp._adaptive_controller, out


@pytest.fixture(scope='module')
def engine_runs():
    import jax

    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet

    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    data = batches()
    variables = jax.tree.map(np.asarray, JaxLeNet().init(
        jax.random.PRNGKey(7), data[0][0]))
    jax_ctl, want = jax_run(data, variables)
    net = LeNet(image_size=12)
    net.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    port = KFACPreconditioner(
        net, stagger_refresh=2,
        adaptive=AdaptiveRefreshConfig(**ADAPTIVE), **HP,
    )
    got = []
    for (x, y), w in zip(data, want):
        net.zero_grad()
        loss = F.cross_entropy(net(nchw(x)), torch.from_numpy(y))
        loss.backward()
        port.step()
        got.append(dict(
            loss=float(loss.detach()),
            factors={n: (st.a_factor.clone(), st.g_factor.clone())
                     for n, st in port.layers.items()},
            grads={n: q.grad.clone() for n, q in net.named_parameters()},
        ))
        with torch.no_grad():
            for n, q in net.named_parameters():
                q -= LR * torch.as_tensor(w['grads'][n])
    return jax_ctl, want, port, got, net


def test_engine_decisions_match_jax(engine_runs):
    jax_ctl, _, port, _, _ = engine_runs
    ctl = port.adaptive_controller
    assert ctl.events == jax_ctl.events
    assert ctl.counters() == jax_ctl.counters()
    assert ctl.ages == jax_ctl.ages
    kinds = [e[1] for e in ctl.events]
    assert kinds[0] == 'full' and len(kinds) == 1 + 2 * 4 - 1
    # One host read of the drift per opportunity step after step 0.
    assert port.adaptive_host_syncs == len(kinds) - 1


def test_engine_trajectory_matches_jax(engine_runs):
    _, want, _, got, _ = engine_runs
    np.testing.assert_allclose([g['loss'] for g in got],
                               [w['loss'] for w in want], rtol=1e-5)
    for step, (w, g) in enumerate(zip(want, got)):
        for layer, pair in w['factors'].items():
            for side in (0, 1):
                err = rel_err(g['factors'][layer][side], pair[side])
                assert err <= 1e-5, (step, layer, side, err)
        for name, grad in w['grads'].items():
            err = rel_err(g['grads'][name], grad)
            assert err <= 1e-4, (step, name, err)


def test_checkpoint_keeps_counters_resets_cadence(engine_runs):
    _, _, port, _, net = engine_runs
    sd = port.state_dict()
    assert sd['adaptive'] == port.adaptive_controller.state_dict()
    fresh = KFACPreconditioner(
        net, stagger_refresh=2, adaptive=AdaptiveRefreshConfig(**ADAPTIVE),
        **HP,
    )
    fresh.load_state_dict(sd)
    ctl = fresh.adaptive_controller
    assert ctl.counters() == port.adaptive_controller.counters()
    assert ctl.ages == [0, 0] and ctl._ref_sketch is None
    assert fresh._stagger_bootstrapped


# -- across ranks -----------------------------------------------------------


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    """One gloo rank: LeNet under HYBRID-OPT with the adaptive cadence,
    eigen then iterative, its quarter of the global batch of 16."""
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    results = {}
    for method in ('eigen', 'iterative'):
        torch.manual_seed(0)
        model = LeNet(image_size=12)
        ddp = torch.nn.parallel.DistributedDataParallel(model)
        precond = KFACPreconditioner(
            ddp, grad_worker_fraction=DistributedStrategy.HYBRID_OPT,
            stagger_refresh=2, compute_method=method,
            adaptive=AdaptiveRefreshConfig(**ADAPTIVE), **HP,
        )
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        q = 16 // world
        for x, y in batches(STEPS, n=16):
            opt.zero_grad()
            F.cross_entropy(
                ddp(nchw(x[rank * q:(rank + 1) * q])),
                torch.from_numpy(y[rank * q:(rank + 1) * q]),
            ).backward()
            precond.step()
            opt.step()
        sketch, digest = precond._adaptive_last_drift
        results[method] = dict(
            events=precond.adaptive_controller.events,
            counters=precond.adaptive_controller.counters(),
            sketch=sketch.clone(), digest=digest.clone(),
            grid=(precond.grid.rows, precond.grid.cols),
            bucket_layers=sorted(precond.plan.slot_of),
            names=precond.adaptive_controller.layer_names,
        )
    torch.save(results, out / f'rank{rank}.pt')
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    from test_torch_distributed import join
    from test_torch_distributed import spawn

    out = tmp_path_factory.mktemp('adaptive')
    join(spawn(__file__, WORLD, out), time.time() + SPAWN_TIMEOUT_S)
    return [torch.load(out / f'rank{r}.pt') for r in range(WORLD)]


@pytest.mark.parametrize('method', ['eigen', 'iterative'])
def test_every_rank_makes_the_same_decisions(ranks, method):
    first = ranks[0][method]
    assert first['grid'] == (2, 2)
    assert len(first['events']) == 1 + 2 * 4 - 1
    for res in ranks[1:]:
        res = res[method]
        assert res['events'] == first['events']
        assert res['counters'] == first['counters']
        assert torch.equal(res['digest'], first['digest'])
        assert torch.equal(res['sketch'], first['sketch'])
    if method == 'iterative':
        # The residual column of every bucket layer, whichever grid
        # column holds its slot, reached every rank.
        rows = [first['names'].index(n) for n in first['bucket_layers']]
        assert (first['sketch'][rows, 2] > 0).all()


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    _, _, rank_s, world_s, init_s, out_s = sys.argv
    torch.set_num_threads(1)
    run_rank(int(rank_s), int(world_s), Path(init_s), Path(out_s))
