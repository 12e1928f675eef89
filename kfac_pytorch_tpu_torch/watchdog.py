"""Trajectory watchdog: divergence detection, rollback, and escalated
re-entry.

Port of ``kfac_pytorch_tpu/watchdog.py``.  Health
(:mod:`~kfac_pytorch_tpu_torch.health`) catches non-finite numerics, the
streaming checkpoints (:mod:`~kfac_pytorch_tpu_torch.elastic`) survive
preemption and resize, and the consistency guard
(:mod:`~kfac_pytorch_tpu_torch.consistency`) catches replicas that
disagree.  This catches the rest: every value finite, every replica in
agreement, and the trajectory still wrong (a bad data span, a finitely
poisoned factor EMA that re-poisons every refresh, a damping schedule off
a cliff).

1. **Detect**: four detectors per tracked scalar over a trailing window
   (:func:`detect_divergence`): a spike over the trailing median, a
   monotone blow-up, a plateau far above the last clean level, and
   finite values past ``nan_adjacent``.  The scalars are the loss the
   caller feeds and ``last_step_info`` keys (``vg_sum`` by default).
2. **Respond**, on a :class:`~kfac_pytorch_tpu_torch.health.\
EscalationLadder` of consecutive dirty checks: rung 1 softens in place
   (damping up, kl-clip down); rung 2 rolls back to the newest
   generation stamped ``healthy`` (:func:`~kfac_pytorch_tpu_torch.\
elastic.restore_streaming` pinned to it), forces the next refresh to a
   monolithic bootstrap, drops a pending deferral, and re-applies the
   softening on top of the restored values; rung 3 parks the model on
   SGD through the per-slot quarantine masks the guards share.
3. **Clear**: a generation is stamped ``healthy`` only after the
   trajectory ran clean for a clearance window beyond it, so a rollback
   never lands inside a span whose damage had not surfaced at save time.

The fused kernel stays on through all of it: a parked model's slots are
replaced by their raw gradients after the kernel
(:func:`~kfac_pytorch_tpu_torch.ops.fused_precond.\
substitute_quarantined`), and a replayed step after a rollback runs the
kernel on the restored stacks.

**One difference from the JAX package.**  JAX's loss is the global
batch's, the same on every process, so its watchdog adds no collective.
A port rank's loss is its own local batch's, and ranks that read
different losses could take different rungs: a rollback on one rank and
not another would desynchronize every later collective.  So at each
check the retained scalars are stacked into one vector and all-reduced
(the mean over the data world) before the detectors run: one collective
per ``check_every`` steps (:func:`~kfac_pytorch_tpu_torch.scheduler.\
watchdog_check_action`), none between checks, and one host read of the
vector.  :attr:`TrajectoryWatchdog.host_syncs` and
:attr:`TrajectoryWatchdog.all_reduces` count them.  The generation
listing a check decides from is read before that all-reduce and rank 0
alone writes stamps after it, so every rank decides from the same
listing.

``observe/*`` signals (``signals=('vg_sum', 'observe/grad_norm')``) are
read from ``last_step_info`` when the Observe monitor is on
(``ObserveConfig(monitor=True)``); with it off they are absent from the
step's info and not recorded, as in the JAX package.  The cost ledger
bills the check's all-reduce (``observe.costs``, ``watchdog_check``).
The rollback is a cross-process commit point
(:func:`~kfac_pytorch_tpu_torch.runtime.commit_point`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch import tracing
from kfac_pytorch_tpu_torch.health import EscalationLadder
from kfac_pytorch_tpu_torch.scheduler import watchdog_check_action
from kfac_pytorch_tpu_torch.utils.checkpoint import _distributed

__all__ = [
    'WATCHDOG_INFO_KEYS',
    'WatchdogConfig',
    'TrajectoryWatchdog',
    'detect_divergence',
    'monotone_blowup',
    'nan_adjacent_count',
    'plateau_at_garbage',
    'relative_spike',
]

# Floor under relative comparisons: a trailing median of exactly zero
# must not turn every finite value into an infinite ratio.
_EPS = 1e-12

# Trailing points before the spike and blow-up detectors may speak.
_MIN_HISTORY = 4


WATCHDOG_INFO_KEYS = (
    'watchdog/checked',
    'watchdog/dirty',
    'watchdog/divergent_signals',
    'watchdog/strikes',
    'watchdog/rung',
    'watchdog/parked',
    'watchdog/checks_total',
    'watchdog/detections_total',
    'watchdog/softens_total',
    'watchdog/rollbacks_total',
    'watchdog/parks_total',
    'watchdog/stamps_total',
)


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Static knobs of the trajectory watchdog (JAX ``watchdog.py:
    131-266``); ``KFACPreconditioner(watchdog=WatchdogConfig(...))``
    installs it, ``None`` (the default) leaves the engine unguarded.

    Args:
        window: trailing window (in observed steps) each detector reads.
        check_every: steps between verdicts; each check is the one host
            read (and, across ranks, the one all-reduce) of the scalars
            retained since the last.
        signals: ``last_step_info`` keys tracked besides the loss
            (``vg_sum`` always exists; ``observe/*`` keys need Queue A
            item 23 and raise).
        spike_factor: threshold of :func:`relative_spike`.
        blowup_run, blowup_factor: :func:`monotone_blowup`'s run length
            and total growth.
        plateau_factor: :func:`plateau_at_garbage`'s ratio to the clean
            reference.
        nan_adjacent: a finite magnitude at or past this counts as
            divergence (:func:`nan_adjacent_count`), as does a non-finite
            value.
        soften_damping: rung-1 multiplier on the constant damping (> 1).
        soften_kl_clip: rung-1 multiplier on the constant kl-clip (in
            (0, 1); skipped with ``kl_clip=None``).
        rollback_after: consecutive dirty checks before rung 2.
        park_after: consecutive dirty checks before rung 3 (more than
            ``rollback_after``).
        max_rollbacks: rollbacks before persistent dirt parks instead.
        save_dir: the streaming generations' directory; ``None`` disables
            the rollback and the stamping (the ladder softens, then parks).
        save_every: the watchdog's own save cadence in steps (``None``:
            the caller saves).
        clearance: steps a generation must survive, every check clean,
            before it is stamped ``healthy`` (default ``window +
            check_every``, the detection-latency bound).
        retain: generations the watchdog's saves keep.
    """

    window: int = 8
    check_every: int = 4
    signals: tuple[str, ...] = ('vg_sum',)
    spike_factor: float = 10.0
    blowup_run: int = 4
    blowup_factor: float = 3.0
    plateau_factor: float = 5.0
    nan_adjacent: float = 1e30
    soften_damping: float = 10.0
    soften_kl_clip: float = 0.1
    rollback_after: int = 2
    park_after: int = 4
    max_rollbacks: int = 2
    save_dir: str | None = None
    save_every: int | None = None
    clearance: int | None = None
    retain: int = 8

    def __post_init__(self) -> None:
        if self.window < 2:
            raise ValueError('window must be >= 2')
        if self.check_every < 1:
            raise ValueError('check_every must be >= 1')
        if self.spike_factor <= 1 or self.plateau_factor <= 1:
            raise ValueError('spike_factor/plateau_factor must be > 1')
        if self.blowup_run < 2:
            raise ValueError('blowup_run must be >= 2')
        if self.blowup_factor <= 1:
            raise ValueError('blowup_factor must be > 1')
        if self.nan_adjacent <= 0:
            raise ValueError('nan_adjacent must be > 0')
        if self.soften_damping <= 1:
            raise ValueError(
                'soften_damping must be > 1 (rung 1 escalates damping)',
            )
        if not 0 < self.soften_kl_clip < 1:
            raise ValueError(
                'soften_kl_clip must be in (0, 1) (rung 1 tightens the '
                'trust region)',
            )
        if self.rollback_after < 1:
            raise ValueError('rollback_after must be >= 1')
        if self.park_after <= self.rollback_after:
            raise ValueError(
                'park_after must exceed rollback_after (the ladder '
                'escalates soften -> rollback -> park)',
            )
        if self.max_rollbacks < 0:
            raise ValueError('max_rollbacks must be >= 0')
        if self.save_every is not None and self.save_every < 1:
            raise ValueError('save_every must be >= 1')
        if self.save_every is not None and self.save_dir is None:
            raise ValueError(
                'save_every without save_dir: the watchdog would silently '
                'write no generations, stamp nothing, and escalate straight '
                'past the rollback rung — pass save_dir= or drop save_every',
            )
        if self.clearance is not None and self.clearance < 1:
            raise ValueError('clearance must be >= 1')
        if self.retain < 1:
            raise ValueError('retain must be >= 1')

    @property
    def effective_clearance(self) -> int:
        """The clearance window applied (default ``window +
        check_every``)."""
        return (self.clearance if self.clearance is not None
                else self.window + self.check_every)


# -- detectors (host functions of trailing windows) ---------------------------


def _finite_abs(values: Sequence[float]) -> list[float]:
    return [abs(v) for v in values if math.isfinite(v)]


def relative_spike(values: Sequence[float], factor: float) -> bool:
    """The latest ``|value|`` exceeds ``factor`` times the median of the
    finite trailing samples (all but the latest); needs
    ``_MIN_HISTORY`` samples and a finite latest one."""
    if len(values) < _MIN_HISTORY:
        return False
    latest = values[-1]
    if not math.isfinite(latest):
        return False
    trail = _finite_abs(values[:-1])
    if not trail:
        return False
    med = float(np.median(trail))
    return abs(latest) > factor * max(med, _EPS)


def monotone_blowup(values: Sequence[float], run: int, factor: float) -> bool:
    """The last ``run`` magnitudes increase strictly and grow by more than
    ``factor`` in all: the slow climb a single-sample ratio misses."""
    if len(values) < max(run, _MIN_HISTORY):
        return False
    tail = values[-run:]
    if not all(math.isfinite(v) for v in tail):
        return False
    mags = [abs(v) for v in tail]
    if not all(b > a for a, b in zip(mags, mags[1:])):
        return False
    return mags[-1] > factor * max(mags[0], _EPS)


def plateau_at_garbage(
    values: Sequence[float], reference: float | None, factor: float,
) -> bool:
    """The median of the window's finite magnitudes sits more than
    ``factor`` times above the reference frozen at the last clean check:
    the signal jumped and stayed, which the spike detector forgets."""
    if reference is None or len(values) < 2:
        return False
    window = _finite_abs(values)
    if not window:
        return False
    med = float(np.median(window))
    return med > factor * max(abs(reference), _EPS)


def nan_adjacent_count(values: Sequence[float], bound: float) -> int:
    """How many samples are non-finite or finite at or past ``bound``."""
    return sum(1 for v in values if not math.isfinite(v) or abs(v) >= bound)


def detect_divergence(
    values: Sequence[float], reference: float | None, cfg: WatchdogConfig,
) -> list[str]:
    """Names of the detectors that fire on one signal's window (empty:
    healthy)."""
    fired = []
    if relative_spike(values, cfg.spike_factor):
        fired.append('relative_spike')
    if monotone_blowup(values, cfg.blowup_run, cfg.blowup_factor):
        fired.append('monotone_blowup')
    if plateau_at_garbage(values, reference, cfg.plateau_factor):
        fired.append('plateau_at_garbage')
    if nan_adjacent_count(values, cfg.nan_adjacent):
        fired.append('nan_adjacent')
    return fired


# -- the supervisor -----------------------------------------------------------


class TrajectoryWatchdog:
    """The trajectory supervisor of one preconditioner (JAX
    ``watchdog.py:392-884``), built by the engine from a
    :class:`WatchdogConfig` (``precond.watchdog``) and fed once per step,
    after the optimizer step::

        loss = F.cross_entropy(model(x), y)
        loss.backward()
        precond.step()
        opt.step()
        rolled = precond.watchdog_step(loss.detach(), extras=...)
        if rolled is not None:              # rung 2 ran
            load_back(rolled['extras'])

    ``extras`` is a flat ``str -> tensor`` mapping saved into each of the
    watchdog's generations and handed back by a rollback (the model's
    ``state_dict()`` and the optimizer's moments, so a rollback rewinds
    the whole process), or a zero-argument callable returning one, called
    only on a step that saves.  ``precond.train_loop(...)`` feeds the watchdog
    itself and loads the model and optimizer back.
    """

    _KEY = ('trajectory',)

    def __init__(self, config: WatchdogConfig, precond: Any) -> None:
        self.config = config
        self._precond = precond
        self.ladder = EscalationLadder(config.park_after)
        # (step, {signal: tensor or float}), unread until a check.
        self._pending: list[tuple[int, dict[str, Any]]] = []
        # signal -> [(step, float)], read back, trailing.
        self._history: dict[str, list[tuple[int, float]]] = {}
        # signal -> median of the window at the last clean check.
        self._reference: dict[str, float] = {}
        self._last_dirty_step = -1
        self.parked = False
        self.last_verdict: dict[str, list[str]] = {}
        self.last_rollback: dict[str, Any] | None = None
        self.totals = {
            'checks': 0, 'detections': 0, 'softens': 0, 'rollbacks': 0,
            'parks': 0, 'stamps': 0,
        }
        #: Host reads of the retained scalars (one per check with any).
        self.host_syncs = 0
        #: All-reduces of the retained scalars (one per such check across
        #: ranks, none on one).
        self.all_reduces = 0
        self._last_dirty = False
        self._last_checked = False
        self._last_strikes = 0
        self._last_rung = 0

    # -- public protocol ------------------------------------------------------

    def update(
        self, loss: Any,
        extras: (Mapping[str, Any] | Callable[[], Mapping[str, Any]]
                 | None) = None,
    ) -> dict[str, Any] | None:
        """Observe one completed step; save, stamp and check as due.
        Returns ``None``, or when this call rolled back, ``target_step``,
        ``generation``, ``health_stamp``, ``extras`` (the restored
        caller arrays, CPU tensors), ``recomputed`` and ``resized``; the
        step counter is then the restored one."""
        cfg = self.config
        precond = self._precond
        step = int(precond.steps)
        # An external restore rewound the engine: signal from the
        # abandoned future is stale.
        self._truncate(step)
        sig: dict[str, Any] = {}
        if loss is not None:
            sig['loss'] = loss
        info = precond.last_step_info or {}
        for key in cfg.signals:
            if key in info:
                sig[key] = info[key]
        if sig:
            self._pending.append((step, sig))
        if (cfg.save_dir is not None and cfg.save_every is not None
                and not self.parked and step > 0
                and step % cfg.save_every == 0):
            from kfac_pytorch_tpu_torch import elastic

            if callable(extras):
                extras = extras()
            elastic.save_streaming(
                cfg.save_dir, precond, extras=dict(extras) if extras else None,
                retain=cfg.retain,
            )
        rolled = None
        self._last_checked = False
        if watchdog_check_action(step, check_every=cfg.check_every,
                                 parked=self.parked):
            self._last_checked = True
            rolled = self._check()
        self._publish()
        return rolled

    def reset(self) -> None:
        """Forget all retained signal (after an external restore)."""
        self._pending.clear()
        self._history.clear()
        self._reference.clear()
        self.ladder.reset_all(prefix=self._KEY)
        self.last_verdict = {}
        self._last_dirty = False
        self._last_strikes = 0
        self._last_rung = 0

    # -- internals ------------------------------------------------------------

    def _truncate(self, step: int) -> None:
        """Drop retained signal of steps beyond ``step``."""
        self._pending = [(s, v) for s, v in self._pending if s <= step]
        for key in list(self._history):
            self._history[key] = [(s, v) for s, v in self._history[key]
                                  if s <= step]

    def _sync_pending(self) -> None:
        """Read every retained scalar back at once: one f64 vector on the
        device, all-reduced to its mean over the ranks, one ``.cpu()``."""
        if not self._pending:
            return
        device = self._precond.device
        layout, flat = [], []
        for step, sig in self._pending:
            for key, val in sig.items():
                layout.append((step, key))
                if isinstance(val, torch.Tensor):
                    flat.append(val.detach().reshape(()).to(
                        device=device, dtype=torch.float64))
                else:
                    flat.append(torch.tensor(float(val), dtype=torch.float64,
                                             device=device))
        vec = torch.stack(flat)
        if _distributed():
            dist.all_reduce(vec)
            vec = vec / dist.get_world_size()
            self.all_reduces += 1
        values = vec.cpu().tolist()
        self.host_syncs += 1
        keep = 4 * self.config.window
        for (step, key), val in zip(layout, values):
            series = self._history.setdefault(key, [])
            series.append((step, val))
            if len(series) > keep:
                del series[: len(series) - keep]
        self._pending.clear()

    def _windows(self) -> dict[str, list[float]]:
        w = self.config.window
        return {key: [v for _, v in series[-w:]]
                for key, series in self._history.items() if series}

    def _listing(self) -> list[tuple[str, str | None]]:
        """The save directory's generations and stamps (read before the
        check's all-reduce, so every rank decides from the same one)."""
        from kfac_pytorch_tpu_torch import elastic

        if self.config.save_dir is None:
            return []
        return elastic.list_generations(self.config.save_dir, stamps=True)

    def _check(self) -> dict[str, Any] | None:
        cfg = self.config
        step = int(self._precond.steps)
        listing = self._listing()
        self._sync_pending()
        self.totals['checks'] += 1
        verdict: dict[str, list[str]] = {}
        for key, window in self._windows().items():
            fired = detect_divergence(window, self._reference.get(key), cfg)
            if fired:
                verdict[key] = fired
        self.last_verdict = verdict
        dirty = bool(verdict)
        self._last_dirty = dirty
        if self.parked:
            # Terminal: keep counting, and re-assert the quarantine (a
            # health-managed refresh re-derives its masks).
            self._last_rung = 3
            self._last_strikes = self.ladder.strikes_for(self._KEY)
            self._park_dispatch()
            return None
        if not dirty:
            self.ladder.reset_all(prefix=self._KEY)
            self._last_strikes = 0
            self._last_rung = 0
            for key, window in self._windows().items():
                finite = _finite_abs(window)
                if finite:
                    self._reference[key] = float(np.median(finite))
            self._stamp_cleared(step, listing)
            return None
        self.totals['detections'] += 1
        tracing.count_event('watchdog_detect', step=step)
        self._last_dirty_step = max(self._last_dirty_step, step)
        self.ladder.note(self._KEY, True)
        strikes = self.ladder.strikes_for(self._KEY)
        self._last_strikes = strikes
        targets = self._rollback_targets(listing)
        rollback_available = (cfg.save_dir is not None
                              and self.totals['rollbacks'] < cfg.max_rollbacks
                              and bool(targets))
        # Rollback depth reached with the rollback budget spent: park
        # rather than replay the same span once more.
        rollbacks_exhausted = (cfg.save_dir is not None
                               and self.totals['rollbacks']
                               >= cfg.max_rollbacks)
        if strikes >= cfg.park_after or (
                strikes >= cfg.rollback_after and rollbacks_exhausted):
            self._park(step)
            return None
        if strikes >= cfg.rollback_after and rollback_available:
            self._last_rung = 2
            return self._rollback(targets)
        self._last_rung = 1
        self._soften()
        return None

    # -- rung 1: soften ---------------------------------------------------------

    def _soften(self, levels: int = 1) -> None:
        """Damping times ``soften_damping ** levels``, kl-clip times
        ``soften_kl_clip ** levels``: host writes to the stored constants
        (callables are refused when the preconditioner is built)."""
        precond = self._precond
        cfg = self.config
        assert not callable(precond._damping)
        precond._damping = float(precond._damping) * float(
            cfg.soften_damping ** levels)
        if precond._kl_clip is not None:
            assert not callable(precond._kl_clip)
            precond._kl_clip = float(precond._kl_clip) * float(
                cfg.soften_kl_clip ** levels)
        self.totals['softens'] += 1
        tracing.count_event('watchdog_soften', step=int(precond.steps))

    # -- rung 2: rollback -------------------------------------------------------

    def _rollback_targets(self, listing) -> list[int]:
        """Steps of every ``healthy`` generation, ascending."""
        from kfac_pytorch_tpu_torch import elastic

        return [elastic.generation_step(gen) for gen, stamp in listing
                if stamp == elastic.HEALTH_STAMP_HEALTHY]

    def _rollback(self, targets: Sequence[int]) -> dict[str, Any] | None:
        """Restore the newest ``healthy`` generation that restores,
        trying the candidates newest first (a stamped generation can
        still fail verification); with none left, park."""
        from kfac_pytorch_tpu_torch import elastic
        from kfac_pytorch_tpu_torch import runtime

        precond = self._precond
        decision_step = int(precond.steps)
        # The cross-process commit point: every rank decided the rollback
        # from the same all-reduced signal, and the restore below is
        # collective.
        runtime.commit_point('watchdog/rollback')
        info = target = None
        for candidate in sorted(targets, reverse=True):
            try:  # spmd: collective-safe(restore_streaming raises on every rank together: rank 0's verdict is broadcast and the install faults are all-gathered before it raises, so every rank moves to the next candidate in step)
                info = elastic.restore_streaming(
                    self.config.save_dir, precond, target_step=candidate,
                    require_stamp=elastic.HEALTH_STAMP_HEALTHY,
                )
                target = candidate
                break
            except elastic.ElasticCheckpointError:
                tracing.count_event('watchdog_rollback_candidate_failed',
                                    step=decision_step)
        if info is None:
            self._park(decision_step)
            return None
        # The refresh schedule walked the poisoned span: the next refresh
        # is a monolithic bootstrap and no deferral survives.
        precond._stagger_bootstrapped = False
        precond._iter_bootstrapped = False
        precond._overlap_bootstrapped = False
        precond._overlap_drop()
        ctl = precond._adaptive_controller
        if ctl is not None:
            ctl.reset()
            precond._adaptive_last_drift = None
        # Escalated re-entry: the restore reloaded the saving step's
        # hyperparameters; soften one level deeper per rollback taken.
        self.totals['rollbacks'] += 1
        self._soften(levels=self.totals['rollbacks'])
        tracing.count_event('watchdog_rollback', step=decision_step)
        self._truncate(target)
        self._pending.clear()
        self.ladder.reset_all(prefix=self._KEY)
        self._last_dirty_step = target
        self._last_strikes = 0
        rolled = {
            'rolled_back': True,
            'target_step': target,
            'generation': info['generation'],
            'health_stamp': info.get('health_stamp'),
            'extras': info.get('extras'),
            'recomputed': info.get('recomputed'),
            'resized': info.get('resized'),
        }
        self.last_rollback = {k: v for k, v in rolled.items()
                              if k != 'extras'}
        return rolled

    # -- rung 3: park -----------------------------------------------------------

    def _park(self, step: int) -> None:
        self._last_rung = 3
        self.totals['parks'] += 1
        tracing.count_event('watchdog_park', step=step)
        self.parked = True
        self._park_dispatch()

    def _park_dispatch(self) -> None:
        """OR the whole-model quarantine into every bucket's per-slot
        mask (identity preconditioning, idempotent)."""
        precond = self._precond
        precond._consistency_quarantine({
            b.key: np.ones((b.n_slots,), bool) for b in precond.plan.buckets
        })

    # -- clearance stamping -----------------------------------------------------

    def _stamp_cleared(self, clean_step: int, listing) -> None:
        """Stamp ``healthy`` every pending generation saved at ``S`` with
        ``S + clearance <= clean_step`` and no dirty check since ``S``;
        rank 0 writes, every rank counts."""
        from kfac_pytorch_tpu_torch import elastic
        from kfac_pytorch_tpu_torch import runtime

        clearance = self.config.effective_clearance
        writer = not _distributed() or dist.get_rank() == 0
        due = [gen for gen, stamp in listing
               if stamp == elastic.HEALTH_STAMP_PENDING
               and elastic.generation_step(gen) > self._last_dirty_step
               and elastic.generation_step(gen) + clearance <= clean_step]
        if due:
            # The cross-process commit point of the stamp: every rank
            # agreed it is due before rank 0 rewrites the files.
            runtime.commit_point('elastic/stamp')
        for gen in due:
            if writer:
                elastic._write_stamp(gen, elastic.HEALTH_STAMP_HEALTHY)
            self.totals['stamps'] += 1
            tracing.count_event('watchdog_stamp', step=clean_step)

    # -- surfacing --------------------------------------------------------------

    def _publish(self) -> None:
        """The host counters into ``last_step_info`` as CPU int32 tensors
        (reading them syncs no device)."""
        precond = self._precond
        info = dict(precond._last_step_info or {})
        values = {
            'watchdog/checked': int(self._last_checked),
            'watchdog/dirty': int(self._last_dirty),
            'watchdog/divergent_signals': len(self.last_verdict),
            'watchdog/strikes': self._last_strikes,
            'watchdog/rung': self._last_rung,
            'watchdog/parked': int(self.parked),
        }
        for name, n in self.totals.items():
            values[f'watchdog/{name}_total'] = n
        info.update({k: torch.tensor(v, dtype=torch.int32)
                     for k, v in values.items()})
        precond._last_step_info = info
