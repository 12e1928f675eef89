"""The port's deferred refresh (``overlap_comm=True``) against its own
synchronous engine and against the JAX package's, on the CPU.

* ``overlap_defer_action`` equals JAX's over every ``(monolithic_due,
  shard_due, bootstrapped)``.
* The one-step shift, bitwise, against the port's synchronous engine on
  ``TinyModel`` with fixed weights and batch (JAX
  ``tests/test_overlap.py::test_buckets_shift_and_grads_parity``): after
  every step ``t >= 1`` the overlap run's bucket stacks equal the
  synchronous run's after step ``t - 1``; the preconditioned gradients
  are equal off the refresh-due steps and differ on them; the factor
  EMAs are equal.  Also with ``stagger_refresh=2``, with
  ``compute_method='iterative'`` and under ``accumulation_steps=2``.
* Against JAX's ``overlap_comm=True`` run on the same numpy weights and
  batch (fixed, as JAX's ``run_pair`` keeps them): the refresh of every
  step, the factor EMAs, the preconditioned gradients and every bucket
  slot's action on a fixed probe (``qg ((qgᵀ X qa) ⊙ dgda) qaᵀ``, or
  ``g_inv X a_inv``; never raw eigenvectors) within a relative Frobenius
  ``1e-5`` at every step; so are the compositions with
  ``stagger_refresh=2``, ``compute_method='iterative'`` (the deferred
  refresh at warm depth), ``adaptive`` (the same decision events),
  a damping schedule (the deferred refresh takes step ``R + 1``'s
  damping, as JAX's does) and accumulation (the port's two micro-batches
  and ``step()`` against JAX ``accumulate``/``finalize`` with overlap).
  The reference's own ``test_overlap.py::TestOneStepShiftParity::
  test_finalize_path_defers_too`` fails: it holds JAX's ``finalize``
  against JAX's ``step()`` bitwise, and the two compiled programs'
  factor EMAs differ in the last bit (``a_factor`` 0.06970934 against
  0.06970935 at step 3), so the refresh deferred from step 2 decomposes
  a slightly different input.  Neither failure is a fault of the
  deferral; the port holds its accumulation path bitwise against its own
  synchronous accumulation path and within ``1e-5`` against JAX's
  ``finalize``.
* The restore invariant (a pending refresh is dropped; the next due
  refresh defers only after a recomputing restore), a pending refresh
  that survives a raised step, a refresh that raises in the worker,
  the validation errors (JAX's messages) and ``overlap_comm=False``
  bitwise equal to the engine without the option.
* Four gloo ranks (subprocesses of this file, as
  ``tests/test_torch_distributed.py`` runs them) under HYBRID-OPT on
  LeNet: each rank's overlap run against its synchronous run, shifted,
  bitwise.
"""
from __future__ import annotations

import datetime
import itertools
import os
import subprocess
import sys
import time
import types
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
from kfac_pytorch_tpu_torch.models import TinyModel  # noqa: E402
from kfac_pytorch_tpu_torch.scheduler import overlap_defer_action  # noqa

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003, lr=0.1)
STEPS = 9
#: The relative Frobenius bar of every comparison with JAX.
TOL = 1e-5
WORLD = 4
SPAWN_TIMEOUT_S = 180


def data():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 10)).astype(np.float32)
    return x, rng.integers(0, 10, size=(16,))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def probe(shape) -> np.ndarray:
    return np.random.default_rng(sum(shape)).standard_normal(shape)


def slot_actions(buckets) -> dict:
    """Per bucket the action of every slot on a fixed probe, float64:
    ``qg ((qgᵀ X qa) ⊙ dgda) qaᵀ`` (prediv eigen) or ``g_inv X a_inv``."""
    out = {}
    for key, bs in buckets.items():
        f = {n: np.asarray(getattr(bs, n), np.float64)
             for n in ('qa', 'qg', 'dgda', 'a_inv', 'g_inv')
             if getattr(bs, n, None) is not None}
        if 'dgda' in f:
            x = probe(f['dgda'].shape)
            v = np.swapaxes(f['qg'], 1, 2) @ x @ f['qa']
            out[key] = f['qg'] @ (v * f['dgda']) @ np.swapaxes(f['qa'], 1, 2)
        else:
            x = probe((f['g_inv'].shape[0], f['g_inv'].shape[1],
                       f['a_inv'].shape[1]))
            out[key] = f['g_inv'] @ x @ f['a_inv']
    return out


def bitwise_buckets(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[k].keys() == b[k].keys()
        and all(torch.equal(a[k][f], b[k][f]) for f in a[k])
        for k in a
    )


def snapshot(p, model):
    return dict(
        buckets={k: {f: t.clone() for f, t in bs.tensors().items()}
                 for k, bs in p.buckets.items()},
        grads={n: q.grad.clone() for n, q in model.named_parameters()},
        factors={n: (st.a_factor.clone(), st.g_factor.clone())
                 for n, st in p.layers.items()},
        refresh=p.last_refresh,
    )


def micro(x, y, n):
    k = len(x) // n
    return [(torch.from_numpy(x[i * k:(i + 1) * k]),
             torch.from_numpy(y[i * k:(i + 1) * k]).long())
            for i in range(n)]


def port_run(weights, kw, steps=STEPS, accumulation=1, hook=None):
    """Fixed weights and batch; ``accumulation`` micro-batches of the
    batch per step, each loss divided by their number."""
    x, y = data()
    model = TinyModel()
    model.load_state_dict(weights)
    p = KFACPreconditioner(model, accumulation_steps=accumulation,
                           **dict(HP, **kw))
    out = []
    for t in range(steps):
        if hook is not None:
            hook(p, t)
        model.zero_grad()
        for xm, ym in micro(x, y, accumulation):
            (F.cross_entropy(model(xm), ym) / accumulation).backward()
        p.step()
        out.append(snapshot(p, model))
    return p, out


def assert_shift(sync, over, ius):
    """The one-step shift, bitwise: overlap's stacks after step t are
    the synchronous run's after step t - 1; gradients equal off the
    refresh-due steps and different on them; factor EMAs equal."""
    for t in range(1, len(over)):
        assert bitwise_buckets(over[t]['buckets'], sync[t - 1]['buckets']), t
    for t, (s, o) in enumerate(zip(sync, over)):
        equal = all(torch.equal(s['grads'][n], o['grads'][n])
                    for n in s['grads'])
        due = t > 0 and t % ius == 0
        assert equal != due, (t, due)
        for n, (a, g) in s['factors'].items():
            assert torch.equal(a, o['factors'][n][0])
            assert torch.equal(g, o['factors'][n][1])


@pytest.fixture(scope='module')
def bridged():
    """``(flax variables as numpy, torch weights)`` of TinyModel."""
    import jax

    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    x, _ = data()
    variables = jax.tree.map(
        np.asarray, JaxTiny().init(jax.random.PRNGKey(2), x))
    return variables, flax_to_torch_state_dict(variables)


def jax_run(variables, kw, steps=STEPS, accumulation=1):
    """The JAX engine on the same fixed weights and batch: per step the
    refresh (``'full'``, ``'overlap_inv'``, ``'overlap_shard<k>'`` or
    ``None``), factors, gradients and bucket stacks."""
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    x, y = data()
    precond = JaxPreconditioner(JaxTiny(), loss_fn=xent,
                                accumulation_steps=accumulation,
                                **dict(HP, **kw))
    state = precond.init(variables, x)
    accum = precond.init_accum() if accumulation > 1 else None
    out = []
    for _ in range(steps):
        if kw.get('adaptive') is None:  # the plan stashes adaptive records
            uf, ui, shard, deferred, _ = precond._overlap_plan()
            refresh = ('full' if ui else shard if deferred is None
                       else 'overlap_inv' if deferred[0] == 'inv'
                       else f'overlap_shard{deferred[1]}')
        else:
            refresh = '?'
        if accumulation == 1:
            _, _, grads, state = precond.step(
                variables, state, x, loss_args=(jnp.asarray(y),))
        else:
            total = None
            k = len(x) // accumulation
            for i in range(accumulation):
                _, _, g, accum = precond.accumulate(
                    variables, state, accum, x[i * k:(i + 1) * k],
                    loss_args=(jnp.asarray(y[i * k:(i + 1) * k]),))
                total = g if total is None else jax.tree.map(jnp.add,
                                                             total, g)
            grads, state, accum = precond.finalize(
                state, jax.tree.map(lambda g: g / accumulation, total),
                accum)
        out.append(dict(
            refresh=refresh,
            grads=flax_to_torch_state_dict(
                {'params': jax.tree.map(np.asarray, grads)}),
            factors={b: (np.asarray(state[b].a_factor),
                         np.asarray(state[b].g_factor))
                     for b in state.layers},
            actions=slot_actions(state.buckets),
        ))
    return precond, out


def assert_matches_jax(want, got):
    for t, (w, g) in enumerate(zip(want, got)):
        if w['refresh'] != '?':
            assert g['refresh'] == w['refresh'], (t, g['refresh'],
                                                  w['refresh'])
        for name, grad in w['grads'].items():
            err = rel_err(g['grads'][name], grad)
            assert err <= TOL, (t, name, err)
        for layer, pair in w['factors'].items():
            for side in (0, 1):
                err = rel_err(g['factors'][layer][side], pair[side])
                assert err <= TOL, (t, layer, side, err)
        acts = slot_actions({k: types.SimpleNamespace(**fields)
                             for k, fields in g['buckets'].items()})
        for key, act in w['actions'].items():
            err = rel_err(acts[key], act)
            assert err <= TOL, (t, key, err)


# -- the decision ----------------------------------------------------------


def test_defer_action_matches_jax():
    from kfac_pytorch_tpu.scheduler import (
        overlap_defer_action as jax_defer,
    )

    for due, shard, boot in itertools.product(
            (False, True), (None, 0, 1, 3), (False, True)):
        kw = dict(monolithic_due=due, shard_due=shard, bootstrapped=boot)
        assert overlap_defer_action(**kw) == jax_defer(**kw)
    assert overlap_defer_action(monolithic_due=True, shard_due=None,
                                bootstrapped=False) == (True, None)


# -- the one-step shift against the port's synchronous engine ---------------

SHIFT_CASES = {
    'eigen': (dict(), 2, STEPS, 1),
    'stagger': (dict(inv_update_steps=4, stagger_refresh=2), 4, 10, 1),
    'iterative': (dict(compute_method='iterative'), 2, 7, 1),
    'accumulation': (dict(), 2, 7, 2),
}


@pytest.mark.parametrize('case', list(SHIFT_CASES))
def test_one_step_shift_is_bitwise(bridged, case):
    kw, ius, steps, accumulation = SHIFT_CASES[case]
    _, weights = bridged
    _, sync = port_run(weights, kw, steps, accumulation)
    p, over = port_run(weights, dict(kw, overlap_comm=True), steps,
                       accumulation)
    if case == 'stagger':
        # Every shard is due at phases 0 and 1 of an interval; the shard
        # steps shift, so the gradients differ one step after each too.
        for t in range(1, steps):
            assert bitwise_buckets(over[t]['buckets'],
                                   sync[t - 1]['buckets']), t
        assert [o['refresh'] for o in over] == [
            'full', None, 'overlap_shard1', None, None, 'overlap_shard0',
            'overlap_shard1', None, None, 'overlap_shard0']
        return
    assert_shift(sync, over, ius)
    want = ['full'] + [None if t % ius != 1 or t == 1 else 'overlap_inv'
                       for t in range(1, steps)]
    assert [o['refresh'] for o in over] == want
    assert p.overlap_pending == (('inv',) if (steps - 1) % ius == 0
                                 else None)


def test_iterative_deferred_refresh_is_warm(bridged):
    """The bootstrap runs the deep depth in band; every deferred refresh
    runs the warm depth, on the worker."""
    _, weights = bridged
    depths = []

    def spy(p, t):
        if t == 0:
            real = p._second_order._decompose

            def decompose(b, A, G, damping, warm, iters, *rest):
                depths.append(iters)
                return real(b, A, G, damping, warm, iters, *rest)
            p._second_order._decompose = decompose

    p, _ = port_run(weights, dict(compute_method='iterative',
                                  overlap_comm=True), 7, hook=spy)
    p.join_deferred_refresh()  # the refresh deferred by step 6
    cfg = p.iterative_config
    n = len(p.plan.buckets)
    assert depths == [cfg.bootstrap_iters] * n + [cfg.warm_iters] * 3 * n


# -- against the JAX package ------------------------------------------------

JAX_CASES = {
    'eigen': (dict(overlap_comm=True), STEPS, 1),
    'stagger': (dict(overlap_comm=True, inv_update_steps=4,
                     stagger_refresh=2), 10, 1),
    'iterative': (dict(overlap_comm=True, compute_method='iterative'), 7, 1),
    'damping_schedule': (dict(overlap_comm=True,
                              damping=lambda s: 0.003 * (1.0 + 0.25 * s)),
                         STEPS, 1),
    'accumulation': (dict(overlap_comm=True), 7, 2),
}


@pytest.mark.parametrize('case', list(JAX_CASES))
def test_matches_jax(bridged, case):
    kw, steps, accumulation = JAX_CASES[case]
    variables, weights = bridged
    _, want = jax_run(variables, kw, steps, accumulation)
    p, got = port_run(weights, kw, steps, accumulation)
    assert_matches_jax(want, got)
    if case == 'damping_schedule':
        # The refresh due at step 2 is installed at step 3 with step 3's
        # damping baked in, where the synchronous refresh bakes step 2's.
        baked = {float(v) for fields in got[3]['buckets'].values()
                 for v in fields['bake_damping']}
        assert baked == {float(torch.tensor(0.003 * (1.0 + 0.25 * 3)))}
        _, sync = port_run(weights, dict(kw, overlap_comm=False), 3)
        baked = {float(v) for fields in sync[2]['buckets'].values()
                 for v in fields['bake_damping']}
        assert baked == {float(torch.tensor(0.003 * (1.0 + 0.25 * 2)))}


def test_adaptive_matches_jax(bridged):
    """The drift-adaptive cadence with the deferral (JAX
    ``test_adaptive_stagger.py:399``): the same decision events and
    counters, and the trajectory within the bar."""
    variables, weights = bridged
    kw = dict(overlap_comm=True, inv_update_steps=4, stagger_refresh=2)
    jp, want = jax_run(variables, dict(kw, adaptive=_jax_adaptive()), 16)
    p, got = port_run(weights, dict(kw, adaptive=AdaptiveRefreshConfig(
        0.2, staleness_factor=3, record_events=True)), 16)
    jctl, ctl = jp._adaptive_controller, p.adaptive_controller
    assert ctl.events == [tuple(e) for e in jctl.events]
    assert ctl.counters() == jctl.counters()
    assert sum(ctl.counters()[k] for k in ('early', 'forced',
                                           'scheduled')) > 0
    assert_matches_jax(want, got)


def _jax_adaptive():
    from kfac_pytorch_tpu.scheduler import AdaptiveRefreshConfig as JaxCfg

    return JaxCfg(0.2, staleness_factor=3, record_events=True)


def test_validation_matches_jax():
    from kfac_pytorch_tpu.health import HealthConfig
    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    cases = [
        (dict(bucketed=False), dict(bucketed=False), 'bucketed'),
        (dict(lowrank_rank=4), dict(lowrank_rank=4), 'lowrank_rank'),
        (dict(ekfac=True), dict(ekfac=True), 'ekfac'),
        (dict(health=HealthConfig()), dict(health=object()), 'health'),
    ]
    for jkw, pkw, word in cases:
        with pytest.raises(ValueError, match=word) as want:
            JaxPreconditioner(JaxTiny(), loss_fn=None, overlap_comm=True,
                              **jkw)
        with pytest.raises(ValueError, match=word) as got:
            KFACPreconditioner(TinyModel(), overlap_comm=True, **pkw)
        assert str(got.value) == str(want.value)
    # health alone is ported (item 19): a non-config is JAX's TypeError.
    with pytest.raises(TypeError, match='HealthConfig'):
        KFACPreconditioner(TinyModel(), health=object())


# -- restores, failures and the default --------------------------------------


@pytest.mark.parametrize('compute_inverses', [True, False])
def test_restore_drops_pending(bridged, compute_inverses):
    _, weights = bridged
    p, _ = port_run(weights, dict(overlap_comm=True), 3)
    assert p.overlap_pending == ('inv',) and p._overlap_inflight is not None
    sd = p.state_dict()
    fresh = KFACPreconditioner(TinyModel(), overlap_comm=True, **HP)
    fresh.load_state_dict(sd, compute_inverses=compute_inverses)
    assert fresh.overlap_pending is None
    assert fresh._overlap_bootstrapped == compute_inverses
    # Restored in place: the refresh in flight is joined and discarded,
    # and the recompute's stacks stay.
    p.load_state_dict(sd)
    assert p.overlap_pending is None and p._overlap_inflight is None
    assert bitwise_buckets(
        {k: bs.tensors() for k, bs in p.buckets.items()},
        {k: bs.tensors() for k, bs in fresh.buckets.items()}
    ) == compute_inverses
    # Step 3 is not due; step 4 is: deferred after a recompute, in band
    # (the bootstrap) without one.
    model = TinyModel()
    model.load_state_dict(weights)
    resumed = KFACPreconditioner(model, overlap_comm=True, **HP)
    resumed.load_state_dict(sd, compute_inverses=compute_inverses)
    x, y = micro(*data(), 1)[0]
    for _ in range(2):
        model.zero_grad()
        F.cross_entropy(model(x), y).backward()
        resumed.step()
    assert resumed.last_refresh == (None if compute_inverses else 'full')
    assert resumed.overlap_pending == (('inv',) if compute_inverses
                                       else None)


def test_pending_survives_a_step_that_raises_before_the_collect(bridged):
    """A step that raises before its collect point keeps the pending
    refresh in flight; the retry installs it, and the run goes on as
    one that never failed (JAX ``test_pending_survives_failed_dispatch``)."""
    _, weights = bridged
    _, clean = port_run(weights, dict(overlap_comm=True), 6)
    failed = []

    def hook(p, t):
        if t == 3:
            real = p._refresh_plan

            def once():
                p._refresh_plan = real
                raise RuntimeError('injected')
            p._refresh_plan = once
            x, y = micro(*data(), 1)[0]
            p._capture.model.zero_grad()
            F.cross_entropy(p._capture.model(x), y).backward()
            with pytest.raises(RuntimeError, match='injected'):
                p.step()
            failed.append((p.steps, p.overlap_pending,
                           p._overlap_inflight is not None))

    _, got = port_run(weights, dict(overlap_comm=True), 6, hook=hook)
    assert failed == [(3, ('inv',), True)]
    for t in range(6):
        assert bitwise_buckets(got[t]['buckets'], clean[t]['buckets']), t
        assert got[t]['refresh'] == clean[t]['refresh']
        for n, g in clean[t]['grads'].items():
            assert torch.equal(got[t]['grads'][n], g)


def test_a_step_that_raises_after_the_collect_keeps_the_install(bridged):
    """Past the collect point the deferred refresh is installed: the
    failed step leaves it installed and no longer pending, and the retry
    goes on from there as the run that never failed."""
    _, weights = bridged
    _, clean = port_run(weights, dict(overlap_comm=True), 6)
    seen = []

    def hook(p, t):
        if t == 3:
            real = p._update_factors

            def once(first_update):
                p._update_factors = real
                raise RuntimeError('injected')
            p._update_factors = once
            x, y = micro(*data(), 1)[0]
            p._capture.model.zero_grad()
            F.cross_entropy(p._capture.model(x), y).backward()
            with pytest.raises(RuntimeError, match='injected'):
                p.step()
            seen.append((p.steps, p.overlap_pending, p._overlap_inflight))
            seen.append(bitwise_buckets(
                {k: bs.tensors() for k, bs in p.buckets.items()},
                clean[3]['buckets']))

    _, got = port_run(weights, dict(overlap_comm=True), 6, hook=hook)
    assert seen == [(3, None, None), True]
    for t in range(6):
        assert bitwise_buckets(got[t]['buckets'], clean[t]['buckets']), t
        for n, g in clean[t]['grads'].items():
            assert torch.equal(got[t]['grads'][n], g)


def test_a_refresh_that_raises_in_the_worker_raises_at_the_collect(bridged):
    _, weights = bridged

    def hook(p, t):
        if t == 2:
            def boom(*args):
                raise ValueError('refresh failed')
            p._refresh_state = boom

    with pytest.raises(RuntimeError, match='deferred refresh') as exc:
        port_run(weights, dict(overlap_comm=True), 4, hook=hook)
    assert isinstance(exc.value.__cause__, ValueError)


def test_pending_without_issued_work_raises(bridged):
    _, weights = bridged
    p, _ = port_run(weights, dict(overlap_comm=True), 2)
    p._overlap_pending = ('inv',)
    model = p._capture.model
    x, y = micro(*data(), 1)[0]
    model.zero_grad()
    F.cross_entropy(model(x), y).backward()
    with pytest.raises(RuntimeError, match='never issued'):
        p.step()


def test_overlap_off_is_the_engine_without_the_option(bridged):
    _, weights = bridged
    _, default = port_run(weights, {}, 5)
    p, off = port_run(weights, dict(overlap_comm=False), 5)
    assert p._overlap_inflight is None and p.overlap_pending is None
    for d, o in zip(default, off):
        assert bitwise_buckets(d['buckets'], o['buckets'])
        assert d['refresh'] == o['refresh']
        for n, g in d['grads'].items():
            assert torch.equal(o['grads'][n], g)


# -- four gloo ranks ----------------------------------------------------------


def rank_data(rank, world):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 1, 16, 16)).astype(np.float32)
    y = rng.integers(0, 10, size=(16,))
    q = len(x) // world
    return (torch.from_numpy(x[rank * q:(rank + 1) * q]),
            torch.from_numpy(y[rank * q:(rank + 1) * q]).long())


def rank_run(rank, world, weights, **kw):
    model = LeNet(image_size=16)
    model.load_state_dict(weights)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    p = KFACPreconditioner(
        ddp, grad_worker_fraction=DistributedStrategy.HYBRID_OPT,
        **dict(HP, kl_clip=0.001), **kw)
    x, y = rank_data(rank, world)
    out = []
    for _ in range(7):
        model.zero_grad()
        F.cross_entropy(ddp(x), y).backward()
        p.step()
        out.append(snapshot(p, model))
    p.join_deferred_refresh()  # its column gathers end before teardown
    return out


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    weights = torch.load(out / 'init.pt')
    sync = rank_run(rank, world, weights)
    over = rank_run(rank, world, weights, overlap_comm=True)
    verdict = []
    try:
        assert_shift(sync, over, 2)
        verdict.append('shift ok')
    except AssertionError as exc:
        verdict.append(f'shift broken: {exc!r}')
    verdict.append([o['refresh'] for o in over])
    torch.save(verdict, out / f'rank{rank}.pt')
    dist.destroy_process_group()


def test_four_ranks_hybrid_shift(tmp_path):
    torch.manual_seed(3)
    torch.save(LeNet(image_size=16).state_dict(), tmp_path / 'init.pt')
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, '--worker', str(rank), str(WORLD),
             str(tmp_path / 'pg_init'), str(tmp_path)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(WORLD)
    ]
    deadline = time.time() + SPAWN_TIMEOUT_S
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
    assert not bad, bad
    want = ['full', None, None, 'overlap_inv', None, 'overlap_inv', None]
    for rank in range(WORLD):
        verdict = torch.load(tmp_path / f'rank{rank}.pt')
        assert verdict == ['shift ok', want], (rank, verdict)


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
