"""The port's trajectory watchdog against the JAX package's, on the CPU.

* The four detectors and ``detect_divergence`` give JAX's answers on the
  same numpy series, exactly (NaN, infinities, zeros, climbs, plateaus);
  ``WatchdogConfig`` takes JAX's defaults and raises JAX's errors, and
  so do the preconditioner's exclusions; an ``observe/*`` signal is
  recorded when the Observe monitor is on and absent (not recorded, no
  error) when it is off, as in JAX.
* The ladder: the same loss series fed to a JAX watchdog (``TinyModel``
  on one device, the consistency guard off) and to the port's, with the
  step counters set alike before each update, gives the same rung,
  totals, damping, kl-clip, step counter after a rollback, generation
  listing with its stamps, and park (the whole model quarantined), at
  every update.
* Real training (``TinyModel``, ``train_loop``): a finite curvature
  poison is caught and rolled back onto the newest ``healthy``
  generation, bitwise (factor EMAs, bucket stacks, model and optimizer
  state as saved), with the damping and kl-clip escalated on re-entry;
  a clean run with the watchdog is bitwise the run without.
* Two gloo ranks (subprocesses of this file) feed different local
  losses, one rank's spiking: every check all-reduces the retained
  scalars once, so both ranks take the same rung at the same step,
  which the clean rank alone would not.
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

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

import kfac_pytorch_tpu_torch as kt  # noqa: E402
from kfac_pytorch_tpu_torch import elastic  # noqa: E402
from kfac_pytorch_tpu_torch import watchdog as wd  # noqa: E402
from kfac_pytorch_tpu_torch.models import TinyModel  # noqa: E402
from kfac_pytorch_tpu_torch.utils.metrics import watchdog_scalars  # noqa

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

HP = dict(factor_update_steps=1, inv_update_steps=3, damping=0.003,
          kl_clip=0.001, lr=0.1)
NAN, INF = float('nan'), float('inf')

# -- detectors -----------------------------------------------------------------

SERIES = {
    'flat': [1.0, 1.1, 0.9, 1.0, 1.05, 0.95],
    'spike': [1.0, 1.1, 0.9, 1.0, 50.0],
    'short': [1.0, 100.0],
    'climb': [1.0, 2.0, 4.0, 8.0, 16.0],
    'slow_climb': [1.0, 1.1, 1.2, 1.3, 1.4],
    'plateau': [80.0, 90.0, 85.0, 95.0],
    'zeros': [0.0, 0.0, 0.0, 0.0, 1e-9],
    'nan_tail': [1.0, 1.0, 1.0, NAN],
    'inf_mid': [1.0, INF, 1.0, 1.2, 30.0],
    'huge_finite': [1.0, 2e30, 1.0, -3e31],
    'neg_spike': [-1.0, -1.1, -0.9, -1.0, -40.0],
    'all_nan': [NAN, NAN, NAN, NAN],
}
REFERENCES = [None, 1.0, 10.0, 0.0]


@pytest.mark.parametrize('name', sorted(SERIES))
def test_detectors_equal_jax(name):
    from kfac_pytorch_tpu import watchdog as jwd

    values = SERIES[name]
    jcfg, cfg = jwd.WatchdogConfig(), wd.WatchdogConfig()
    assert wd.relative_spike(values, 10.0) == jwd.relative_spike(values, 10.0)
    for run, factor in ((4, 3.0), (3, 1.5), (2, 10.0)):
        assert (wd.monotone_blowup(values, run, factor)
                == jwd.monotone_blowup(values, run, factor))
    for ref in REFERENCES:
        assert (wd.plateau_at_garbage(values, ref, 5.0)
                == jwd.plateau_at_garbage(values, ref, 5.0))
        assert (wd.detect_divergence(values, ref, cfg)
                == jwd.detect_divergence(values, ref, jcfg))
    for bound in (1e30, 10.0):
        assert (wd.nan_adjacent_count(values, bound)
                == jwd.nan_adjacent_count(values, bound))


def test_detectors_fire_where_expected():
    cfg = wd.WatchdogConfig()
    assert wd.detect_divergence(SERIES['flat'], 1.0, cfg) == []
    assert wd.detect_divergence(SERIES['spike'], None, cfg) == [
        'relative_spike']
    assert 'monotone_blowup' in wd.detect_divergence(SERIES['climb'], None,
                                                     cfg)
    assert wd.detect_divergence(SERIES['plateau'], 1.0, cfg) == [
        'plateau_at_garbage']
    assert wd.nan_adjacent_count(SERIES['huge_finite'], 1e30) == 2


# -- configuration -------------------------------------------------------------

BAD_CONFIGS = [
    dict(window=1), dict(check_every=0), dict(spike_factor=1.0),
    dict(plateau_factor=0.5), dict(blowup_run=1), dict(blowup_factor=1.0),
    dict(nan_adjacent=0.0), dict(soften_damping=1.0),
    dict(soften_kl_clip=1.0), dict(rollback_after=0),
    dict(rollback_after=3, park_after=3), dict(max_rollbacks=-1),
    dict(save_every=0, save_dir='x'), dict(save_every=2),
    dict(clearance=0), dict(retain=0),
]


@pytest.mark.parametrize('kwargs', BAD_CONFIGS,
                         ids=[','.join(k) for k in BAD_CONFIGS])
def test_config_raises_jax_errors(kwargs):
    from kfac_pytorch_tpu import watchdog as jwd

    with pytest.raises(ValueError) as want:
        jwd.WatchdogConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        wd.WatchdogConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_config_defaults_equal_jax():
    import dataclasses

    from kfac_pytorch_tpu import watchdog as jwd

    assert dataclasses.asdict(wd.WatchdogConfig()) == dataclasses.asdict(
        jwd.WatchdogConfig())
    assert wd.WatchdogConfig().effective_clearance == 12
    assert wd.WatchdogConfig(clearance=3).effective_clearance == 3
    assert wd.WATCHDOG_INFO_KEYS == jwd.WATCHDOG_INFO_KEYS


@pytest.mark.parametrize('kwargs,error', [
    (dict(watchdog=object()), TypeError),
    (dict(bucketed=False), ValueError),
    (dict(lowrank_rank=4), ValueError),
    (dict(damping=lambda s: 0.003), ValueError),
    (dict(kl_clip=lambda s: 0.001), ValueError),
], ids=['type', 'bucketed', 'lowrank', 'damping', 'kl_clip'])
def test_engine_rejections_equal_jax(kwargs, error):
    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from kfac_pytorch_tpu.watchdog import WatchdogConfig as JaxConfig

    jkw = dict(kwargs)
    jkw.setdefault('watchdog', JaxConfig())
    kw = dict(kwargs)
    kw.setdefault('watchdog', kt.WatchdogConfig())
    with pytest.raises(error) as want:
        JaxPreconditioner(JaxTiny(), loss_fn=None, **jkw)
    with pytest.raises(error) as got:
        kt.KFACPreconditioner(TinyModel(), **kw)
    assert str(got.value) == str(want.value)


def test_observe_signals_name_item_23():
    """Queue A item 23 is ported: an ``observe/*`` signal is read from
    ``last_step_info`` with the monitor on, and is simply absent with it
    off (JAX ``watchdog.py:141-152``)."""
    from kfac_pytorch_tpu_torch.observe import ObserveConfig

    cfg = kt.WatchdogConfig(signals=('vg_sum', 'observe/grad_norm'),
                            check_every=2)
    x = torch.randn(4, 10)
    for observe, want in ((None, {'loss', 'vg_sum'}),
                          (ObserveConfig(), {'loss', 'vg_sum',
                                             'observe/grad_norm'})):
        torch.manual_seed(0)
        model = TinyModel()
        p = kt.KFACPreconditioner(model, watchdog=cfg, observe=observe)
        for _ in range(2):
            model.zero_grad()
            loss = model(x).square().mean()
            loss.backward()
            p.step()
            p.watchdog_step(loss.detach())
        assert set(p.watchdog._history) == want
        assert p.watchdog.totals['checks'] == 1


# -- the ladder against JAX ----------------------------------------------------

CLEAN = [1.0, 1.0625, 0.9375, 1.0, 1.125, 0.875]


def feed_series():
    """Clean steps, a spike held for two checks (soften, then rollback),
    clean steps after the rollback, then a spike held until the park
    (the rollback budget of one spent), and two parked checks."""
    return ([CLEAN[i % 6] for i in range(14)] + [1e6] * 4
            + [CLEAN[i % 6] for i in range(8)] + [1e6] * 8)


LADDER_CASES = {
    'rollback_then_park': dict(window=4, check_every=2, save_every=2,
                               clearance=4, rollback_after=2, park_after=4,
                               max_rollbacks=1),
    'soften_then_park': dict(window=4, check_every=2, rollback_after=2,
                             park_after=3),
}


def _jax_xent(logits, labels):
    import jax
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))


@pytest.mark.parametrize('case', sorted(LADDER_CASES))
def test_ladder_equals_jax(case, tmp_path):
    import jax

    from kfac_pytorch_tpu import elastic as jel
    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from kfac_pytorch_tpu.watchdog import WatchdogConfig as JaxConfig

    kw = dict(LADDER_CASES[case])
    saving = 'save_every' in kw
    jkw, pkw = dict(kw), dict(kw)
    if saving:
        jkw['save_dir'] = str(tmp_path / 'jax')
        pkw['save_dir'] = str(tmp_path / 'port')
    x = np.zeros((16, 10), np.float32)
    model = JaxTiny()
    jp = JaxPreconditioner(model, loss_fn=_jax_xent,
                           watchdog=JaxConfig(**jkw), **HP)
    jstate = jp.init(model.init(jax.random.PRNGKey(0), x), x)
    pp = kt.KFACPreconditioner(TinyModel(), watchdog=kt.WatchdogConfig(**pkw),
                               **HP)
    jwd, pwd = jp.watchdog, pp.watchdog
    step = 1
    rollbacks = 0
    for i, v in enumerate(feed_series()):
        jp._steps = pp._steps = step
        jstate, jrolled = jwd.update(v, jstate)
        prolled = pwd.update(v)
        where = (case, i, step)
        assert (jrolled is None) == (prolled is None), where
        if jrolled is not None:
            rollbacks += 1
            for key in ('target_step', 'generation', 'health_stamp',
                        'recomputed', 'resized'):
                assert prolled[key] == jrolled[key], (where, key)
        assert pwd.totals == jwd.totals, where
        assert (pwd._last_rung, pwd._last_strikes, pwd._last_dirty,
                pwd.parked) == (jwd._last_rung, jwd._last_strikes,
                                jwd._last_dirty, jwd.parked), where
        assert pwd.last_verdict == jwd.last_verdict, where
        assert (pp._damping, pp._kl_clip) == (jp._damping, jp._kl_clip), where
        assert pp.steps == jp.steps, where
        if saving:
            names = [(os.path.basename(g), s) for g, s in
                     elastic.list_generations(pkw['save_dir'], stamps=True)]
            jnames = [(os.path.basename(g), s) for g, s in
                      jel.list_generations(jkw['save_dir'], stamps=True)]
            assert names == jnames, where
        step = pp.steps + 1
    assert pwd.parked and pwd.totals['parks'] == 1
    assert rollbacks == (1 if saving else 0)
    for bs in pp.buckets.values():
        assert bool(bs.quarantined.all())
    for bs in jstate.buckets.values():
        assert bool(np.all(np.asarray(bs.quarantined)))
    info = watchdog_scalars(pp.last_step_info)
    assert info['watchdog/parked'] == 1.0
    assert info['watchdog/rollbacks_total'] == rollbacks
    assert set(info) == set(wd.WATCHDOG_INFO_KEYS)


# -- real training -------------------------------------------------------------


def batch():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((16, 10)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, size=(16,))))


def loop_run(steps, watchdog=None, poison_at=None, hp=HP):
    torch.manual_seed(2)
    model = TinyModel()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    precond = kt.KFACPreconditioner(model, watchdog=watchdog, **hp)
    loop = precond.train_loop(opt, F.cross_entropy)
    x, y = batch()
    rolled, guard = [], 0
    while precond.steps < steps and guard < 4 * steps:
        guard += 1
        if poison_at is not None and precond.steps == poison_at:
            kt.testing.poison_factors(precond, 'linear1', scale=1e-4)
            poison_at = None
        loop.step(x, loss_args=(y,))
        if loop.last_rollback is not None:
            rolled.append((precond.steps, loop.last_rollback))
            loop.last_rollback = None
    return model, opt, precond, rolled


def test_clean_run_with_watchdog_is_bitwise_without(tmp_path, monkeypatch):
    from kfac_pytorch_tpu_torch import engine

    cfg = kt.WatchdogConfig(window=4, check_every=2, save_dir=str(tmp_path),
                            save_every=2, clearance=4)
    off, _, _, _ = loop_run(12)
    built = []
    real = engine.training_extras
    monkeypatch.setattr(engine, 'training_extras',
                        lambda *a: built.append(1) or real(*a))
    on, _, precond, rolled = loop_run(12, watchdog=cfg)
    assert not rolled
    # The loop builds the extras only on the six steps that save.
    assert len(built) == 6
    assert all(torch.equal(a, b)
               for a, b in zip(off.parameters(), on.parameters()))
    stamps = dict((elastic.generation_step(g), s) for g, s in
                  elastic.list_generations(str(tmp_path), stamps=True))
    assert stamps[8] == 'healthy' and stamps[12] == 'pending'
    assert precond.watchdog.host_syncs == precond.watchdog.totals['checks']
    assert precond.watchdog.all_reduces == 0


def test_finite_poison_rolls_back_bitwise(tmp_path):
    cfg = kt.WatchdogConfig(window=4, check_every=2, save_dir=str(tmp_path),
                            save_every=2, clearance=4)
    hp = dict(HP, inv_update_steps=4, kl_clip=None)
    saved = {}
    orig = elastic.save_streaming

    def spy(directory, precond, **kw):
        path = orig(directory, precond, **kw)
        saved[precond.steps] = (
            {n: (st.a_factor.clone(), st.g_factor.clone())
             for n, st in precond.layers.items()},
            {k: {f: t.clone() for f, t in bs.tensors().items()}
             for k, bs in precond.buckets.items()},
            {k: v.clone() for k, v in kw['extras'].items()},
        )
        return path

    elastic.save_streaming = spy
    try:
        model, opt, precond, rolled = loop_run(
            16, watchdog=cfg, poison_at=10, hp=hp)
    finally:
        elastic.save_streaming = orig
    assert precond.watchdog.totals['detections'] >= 1
    assert len(rolled) >= 1
    _, first = rolled[0]
    assert first['health_stamp'] == 'healthy' and first['target_step'] < 10
    assert not first['recomputed'] and not first['resized']
    assert precond.damping > hp['damping']
    # The landing, replayed: restore the same generation into a fresh
    # engine and compare with what the spy kept at that save.
    target = first['target_step']
    fresh = kt.KFACPreconditioner(TinyModel(), watchdog=kt.WatchdogConfig(),
                                  **hp)
    info = elastic.restore_streaming(str(tmp_path), fresh,
                                     target_step=target)
    layers, buckets, extras = saved[target]
    for n, (a, g) in layers.items():
        assert torch.equal(fresh.layers[n].a_factor, a)
        assert torch.equal(fresh.layers[n].g_factor, g)
    for k, fields in buckets.items():
        for f, t in fields.items():
            if f in fresh.buckets[k].tensors():
                assert torch.equal(fresh.buckets[k].tensors()[f], t), (k, f)
    assert all(torch.equal(info['extras'][k], v) for k, v in extras.items())


# -- two ranks -----------------------------------------------------------------

WORLD = 2
SPAWN_TIMEOUT_S = 120
RANK_CFG = dict(window=4, check_every=2, rollback_after=1, park_after=3)


def rank_losses(rank):
    """Rank 0's local losses spike at step 10, a check step; rank 1's
    stay clean (and differ from rank 0's)."""
    base = [CLEAN[i % 6] * (1 + rank) for i in range(12)]
    if rank == 0:
        base[9] = 1e5
    return base


def watch(precond, losses):
    out = []
    for i, v in enumerate(losses):
        precond._steps = i + 1
        precond.watchdog.update(torch.tensor(v))
        w = precond.watchdog
        out.append((w._last_checked, w._last_rung, dict(w.totals),
                    {k: list(v) for k, v in w.last_verdict.items()}))
    return out


def run_rank(rank, world, init, out):
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    torch.set_num_threads(1)
    precond = kt.KFACPreconditioner(
        TinyModel(), watchdog=kt.WatchdogConfig(**RANK_CFG), **HP)
    rec = watch(precond, rank_losses(rank))
    torch.save({'rec': rec, 'all_reduces': precond.watchdog.all_reduces,
                'host_syncs': precond.watchdog.host_syncs},
               out / f'rank{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()


def test_ranks_with_different_losses_take_the_same_rung(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, '--worker', str(r), str(WORLD),
             str(tmp_path / 'pg_init'), str(tmp_path)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    deadline = time.time() + SPAWN_TIMEOUT_S
    # Meanwhile: rank 1's clean series alone never leaves rung 0.
    alone = watch(kt.KFACPreconditioner(
        TinyModel(), watchdog=kt.WatchdogConfig(**RANK_CFG), **HP),
        rank_losses(1))
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
    reports = [torch.load(tmp_path / f'rank{r}.pt') for r in range(WORLD)]
    assert reports[0]['rec'] == reports[1]['rec']
    rungs = [r[1] for r in reports[0]['rec']]
    assert max(rungs) >= 1 and max(r[1] for r in alone) == 0
    checks = reports[0]['rec'][-1][2]['checks']
    assert checks == 6
    for rep in reports:
        assert rep['all_reduces'] == rep['host_syncs'] == checks


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
