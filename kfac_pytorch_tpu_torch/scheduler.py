"""Hyperparameter scheduling, the refresh cadences and the iterative
method's warm-start rule.

Port of ``kfac_pytorch_tpu/scheduler.py``:
:class:`AdaptiveRefreshConfig` and :class:`AdaptiveRefreshController`
(``:33-405``, the drift-adaptive staggered refresh),
:func:`stagger_refresh_action` (``:409-470``),
:func:`post_restore_bootstrapped` (``:472-517``),
:func:`overlap_defer_action` (``:523-578``, ``overlap_comm``),
:func:`watchdog_check_action` (``:581-612``, the trajectory watchdog's
cadence), :func:`iterative_refresh_iters` (``:614-634``) and
:class:`LambdaParamScheduler` (``:637-734``).  The decisions are host
arithmetic on step counts and on the drift read back from the card.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import numpy as np

_INT_PARAMS = ('factor_update_steps', 'inv_update_steps')


class AdaptiveRefreshConfig:
    """Configuration of the drift-adaptive staggered refresh
    (``KFACPreconditioner(stagger_refresh=K, adaptive=
    AdaptiveRefreshConfig(...))``).

    :class:`AdaptiveRefreshController` picks which shard (or none) uses
    each opportunity step of the fixed cadence of
    :func:`stagger_refresh_action`, under two contracts: each shard
    refreshes at most once per ``inv_update_steps`` interval (the
    budget: never more work than the fixed cadence), and no shard's age
    at decision time exceeds ``staleness_factor * inv_update_steps -
    1`` steps (the forced refresh of the oldest shard at risk).

    Args:
        threshold: relative drift above which a shard refreshes early
            (the max over the shard's layers of the relative change of
            the factor EMAs' ``(fro², max-abs)`` sketch since the
            layer's last refresh, plus ``residual_weight`` times its
            Newton–Schulz residual under ``compute_method='iterative'``).
        staleness_factor: the staleness floor in intervals (an integer
            ``>= 2``).
        residual_weight: weight of the Newton–Schulz residual column
            (``0`` ignores it).
        eps: denominator guard of the relative sketch change.
        record_events: keep the ``(step, kind, shard, max_age)`` log of
            every decision (off by default: it grows without bound).
    """

    def __init__(
        self,
        threshold: float = 0.05,
        *,
        staleness_factor: int = 2,
        residual_weight: float = 1.0,
        eps: float = 1e-12,
        record_events: bool = False,
    ) -> None:
        if not threshold > 0.0:
            raise ValueError(f'threshold must be > 0, got {threshold}')
        if int(staleness_factor) != staleness_factor or staleness_factor < 2:
            raise ValueError(
                'staleness_factor must be an integer >= 2 (a factor of 1 '
                'leaves no room to skip anything and the overlap deferral '
                f'would breach the floor), got {staleness_factor}',
            )
        if residual_weight < 0.0:
            raise ValueError(
                f'residual_weight must be >= 0, got {residual_weight}',
            )
        if not eps > 0.0:
            raise ValueError(f'eps must be > 0, got {eps}')
        self.threshold = float(threshold)
        self.staleness_factor = int(staleness_factor)
        self.residual_weight = float(residual_weight)
        self.eps = float(eps)
        self.record_events = bool(record_events)

    def floor(self, inv_update_steps: int) -> int:
        """The staleness floor in steps for a refresh interval."""
        return self.staleness_factor * int(inv_update_steps)

    def __repr__(self) -> str:
        return (
            f'AdaptiveRefreshConfig(threshold={self.threshold}, '
            f'staleness_factor={self.staleness_factor}, '
            f'residual_weight={self.residual_weight})'
        )


class AdaptiveRefreshController:
    """Host-side decision state of the drift-adaptive cadence (JAX
    ``scheduler.py:113-405``).

    It holds per-shard ages, the per-layer reference sketch and digest
    taken at each shard's last refresh, the per-interval budget and the
    counters.  :meth:`decide` is a pure read that stashes a pending
    record; :meth:`commit` applies it once, after the step's work ran,
    and advances every age by one step.

    At an opportunity step (interval phase ``< n_shards`` after the
    bootstrap) the priority is: **forced** (the oldest shard whose age
    could breach the floor before its next opportunity) over **early**
    (the eligible shard of largest drift, when it reaches the threshold)
    over **skip**.  A shard already refreshed in the interval is never
    picked again; ``budget_clamped`` counts a forced pick the budget
    deferred (unreachable for ``staleness_factor >= 2``, counted
    anyway).  Without a reference sketch the controller returns the
    fixed cadence's shard, so a run that never feeds drift behaves as
    ``adaptive=None``.

    Args:
        config: the :class:`AdaptiveRefreshConfig`.
        layer_names: the rows of the sketch and digest (sorted names).
        shard_layers: the layer names each shard refreshes.
    """

    def __init__(
        self,
        config: AdaptiveRefreshConfig,
        *,
        layer_names: Sequence[str],
        shard_layers: Sequence[Sequence[str]],
    ) -> None:
        self.config = config
        self.layer_names = tuple(layer_names)
        row_of = {name: i for i, name in enumerate(self.layer_names)}
        self.shard_rows: tuple[tuple[int, ...], ...] = tuple(
            tuple(row_of[n] for n in shard) for shard in shard_layers
        )
        self.n_shards = len(self.shard_rows)
        self.ages: list[int] = [0] * self.n_shards
        self.skipped: list[int] = [0] * self.n_shards
        self.early: list[int] = [0] * self.n_shards
        self.forced: list[int] = [0] * self.n_shards
        self.scheduled: list[int] = [0] * self.n_shards
        self.budget_clamped = 0
        self.events: list[tuple[int, str, int | None, int]] = []
        self._ref_sketch = None  # [n_layers, 3] f32 at the last refresh
        self._ref_digest = None  # [n_layers, 2] u32 values
        self._interval_id: int | None = None
        self._refreshed_interval: set[int] = set()
        self._pending: tuple | None = None

    def _shard_drift(self, shard: int, sketch, digest) -> float:
        """Max relative drift over one shard's layers against their
        references; a layer whose digest equals its reference has
        bitwise unchanged factors and drifts 0."""
        cfg = self.config
        worst = 0.0
        for row in self.shard_rows[shard]:
            if (
                self._ref_digest is not None
                and digest is not None
                and bool(np.array_equal(digest[row], self._ref_digest[row]))
            ):
                continue
            ref = self._ref_sketch[row]
            cur = sketch[row]
            rel = float(
                np.max(np.abs(cur[:2] - ref[:2]) / (np.abs(ref[:2]) + cfg.eps)),
            )
            score = rel + cfg.residual_weight * float(cur[2])
            if score > worst:
                worst = score
        return worst

    def decide(
        self,
        step: int,
        inv_update_steps: int,
        *,
        sketch=None,
        digest=None,
    ) -> int | None:
        """The shard to refresh at one opportunity step, or ``None``
        (skip), from the latest drift read back to the host
        (``sketch [n_layers, 3]`` f32, ``digest [n_layers, 2]``); the
        matching :meth:`commit` does the bookkeeping."""
        cfg = self.config
        inv = int(inv_update_steps)
        phase = step % inv
        interval = step // inv
        refreshed = (
            self._refreshed_interval
            if interval == self._interval_id else set()
        )
        eligible = [k for k in range(self.n_shards) if k not in refreshed]
        floor = cfg.floor(inv)
        # Forced: skipping shard k now lets it reach ages[k] + inv before
        # the next decision can save it.
        at_risk = [
            k for k in eligible
            if self.shard_rows[k] and self.ages[k] + inv >= floor
        ]
        if at_risk:
            shard = max(at_risk, key=lambda k: self.ages[k])
            self._pending = (step, interval, 'forced', shard, sketch, digest)
            return shard
        clamped = any(
            self.ages[k] + inv >= floor
            for k in range(self.n_shards) if k not in eligible
        )
        if self._ref_sketch is None or sketch is None:
            # No drift baseline yet: the fixed cadence's shard.
            shard = phase if (phase in eligible) else None
            kind = 'scheduled' if shard is not None else 'skip'
            self._pending = (
                step, interval, kind, shard, sketch, digest, clamped,
            )
            return shard
        best, best_drift = None, 0.0
        for k in eligible:
            d = self._shard_drift(k, sketch, digest)
            if d > best_drift:
                best, best_drift = k, d
        if best is not None and best_drift >= cfg.threshold:
            self._pending = (
                step, interval, 'early', best, sketch, digest, clamped,
            )
            return best
        self._pending = (
            step, interval, 'skip', None, sketch, digest, clamped,
        )
        return None

    def note_full(self, step: int, *, sketch=None, digest=None) -> None:
        """Stash a pending monolithic-refresh record (the bootstrap)."""
        self._pending = (step, None, 'full', None, sketch, digest)

    def commit(self, step: int) -> None:
        """Apply the step's pending decision and advance every age;
        called once per completed step.  A pending record of another
        step is dropped."""
        pend, self._pending = self._pending, None
        for k in range(self.n_shards):
            self.ages[k] += 1
        if pend is None or pend[0] != step:
            return
        kind = pend[2]
        if kind == 'full':
            _s, _i, _k, _sh, sketch, digest = pend
            for k in range(self.n_shards):
                self.ages[k] = 0
            self._refreshed_interval = set()
            self._interval_id = None
            if sketch is not None:
                self._ref_sketch = np.array(sketch, copy=True)
                self._ref_digest = (
                    None if digest is None else np.array(digest, copy=True)
                )
            self._record_event(step, kind, None)
            return
        _s, interval, _k, shard, sketch, digest = pend[:6]
        clamped = bool(pend[6]) if len(pend) > 6 else False
        if interval != self._interval_id:
            self._interval_id = interval
            self._refreshed_interval = set()
        if clamped:
            self.budget_clamped += 1
        if kind == 'skip':
            # The skip is charged to the oldest shard not yet refreshed
            # in the interval (the one that coasted).
            stale = [
                k for k in range(self.n_shards)
                if k not in self._refreshed_interval
            ]
            who = max(stale, key=lambda k: self.ages[k]) if stale else 0
            self.skipped[who] += 1
            self._record_event(step, kind, None)
            return
        assert shard is not None
        self._refreshed_interval.add(shard)
        self.ages[shard] = 0
        if kind == 'early':
            self.early[shard] += 1
        elif kind == 'forced':
            self.forced[shard] += 1
        else:
            self.scheduled[shard] += 1
        if sketch is not None:
            if self._ref_sketch is None:
                self._ref_sketch = np.array(sketch, copy=True)
                self._ref_digest = (
                    None if digest is None else np.array(digest, copy=True)
                )
            else:
                for row in self.shard_rows[shard]:
                    self._ref_sketch[row] = sketch[row]
                    if self._ref_digest is not None and digest is not None:
                        self._ref_digest[row] = digest[row]
        self._record_event(step, kind, shard)

    def _record_event(self, step, kind, shard) -> None:
        if self.config.record_events:
            self.events.append(
                (int(step), kind, shard, int(max(self.ages, default=0))),
            )

    def reset(self) -> None:
        """Drop ages, references, the interval budget and any pending
        record (a restore); the counters survive.  Until the next
        bootstrap commits, :meth:`decide` follows the fixed cadence."""
        self.ages = [0] * self.n_shards
        self._ref_sketch = None
        self._ref_digest = None
        self._interval_id = None
        self._refreshed_interval = set()
        self._pending = None

    def counters(self) -> dict[str, int]:
        """The decision counters summed over shards."""
        return {
            'skipped': sum(self.skipped),
            'early': sum(self.early),
            'forced': sum(self.forced),
            'scheduled': sum(self.scheduled),
            'budget_clamped': self.budget_clamped,
        }

    def state_dict(self) -> dict:
        """The counters only: ages and references never survive a
        restore (its recompute resets them)."""
        return {
            'skipped': list(self.skipped),
            'early': list(self.early),
            'forced': list(self.forced),
            'scheduled': list(self.scheduled),
            'budget_clamped': self.budget_clamped,
        }

    def load_state_dict(self, sd: Mapping) -> None:
        """Restore the counters and :meth:`reset` the cadence state."""
        self.reset()
        for name in ('skipped', 'early', 'forced', 'scheduled'):
            saved = list(sd.get(name, []))
            if len(saved) == self.n_shards:
                setattr(self, name, [int(v) for v in saved])
        self.budget_clamped = int(sd.get('budget_clamped', 0))

    def __repr__(self) -> str:
        c = self.counters()
        return (
            f'AdaptiveRefreshController(n_shards={self.n_shards}, '
            f'ages={self.ages}, skipped={c["skipped"]}, '
            f'early={c["early"]}, forced={c["forced"]})'
        )


def stagger_refresh_action(
    step: int,
    inv_update_steps: int,
    n_shards: int,
    *,
    factors_ready: bool,
    monolithic_due: bool,
    bootstrapped: bool,
) -> str | int | None:
    """The refresh of one step under ``stagger_refresh=n_shards``:
    ``'full'`` (the monolithic bootstrap), a shard index, or ``None``.

    The first refresh is monolithic, so no slot preconditions through a
    zero stack.  After it, interval phase ``p = step % inv_update_steps``
    refreshes shard ``p`` when ``p < n_shards``: each shard once per
    interval, so a slot's decomposition is never older than the
    monolithic cadence's.  After a restore the next refresh is the
    bootstrap again unless the restore recomputed every slot
    (:func:`post_restore_bootstrapped`).

    Raises:
        ValueError: ``n_shards > inv_update_steps`` (the late shards
            would never refresh; this also catches a
            :class:`LambdaParamScheduler` that drives the interval below
            the shard count).
    """
    if n_shards > inv_update_steps:
        raise ValueError(
            f'stagger_refresh={n_shards} exceeds inv_update_steps='
            f'{inv_update_steps}: shard phases beyond the interval '
            'would never run and their slots would go stale forever',
        )
    if not factors_ready:
        return None
    if not bootstrapped:
        return 'full' if monolithic_due else None
    phase = step % inv_update_steps
    if phase < n_shards:
        return phase
    return None


def post_restore_bootstrapped(
    *,
    full_recompute: bool,
    decompositions_installed: bool = False,
    topology_changed: bool = False,
    saved_bootstrapped: bool = False,
) -> bool:
    """Whether a just-restored engine may resume the shard cadence (and
    the iterative method's warm start).

    Only when every slot verifiably holds a decomposition of the live
    layout: a restore-time monolithic recompute always qualifies;
    otherwise only decomposition stacks installed verbatim, of an
    unchanged layout, from an engine that was itself bootstrapped.
    ``load_state_dict`` feeds ``full_recompute``; the other inputs are
    those of the JAX elastic restore, kept for the same rule.
    """
    if full_recompute:
        return True
    if topology_changed or not decompositions_installed:
        return False
    return bool(saved_bootstrapped)


def overlap_defer_action(
    *,
    monolithic_due: bool,
    shard_due: int | None,
    bootstrapped: bool,
) -> tuple[bool, tuple | None]:
    """The deferral of one step's due refresh under ``overlap_comm``:
    ``(execute_in_band, pending)``, ``pending`` being ``('inv',)``, ``('shard',
    k)`` or ``None``.

    A refresh due at step ``R`` runs one step late, from the factor EMAs
    as they stood at the end of step ``R`` (the input the synchronous
    refresh at ``R`` reads); step ``R`` preconditions through the previous
    decompositions, and from ``R + 1`` on the trajectory is the
    synchronous engine's.  The first refresh of a run, and the first
    after a restore that left no live decompositions
    (:func:`post_restore_bootstrapped`), always runs in band: deferring it
    would precondition a step through the zero stacks.  A stagger shard is
    only ever due after that bootstrap, so a due shard always defers, and
    under ``compute_method='iterative'`` a deferred refresh is always the
    warm-depth one.
    """
    if monolithic_due:
        if not bootstrapped:
            return True, None
        return False, ('inv',)
    if shard_due is not None:
        return False, ('shard', shard_due)
    return False, None


def watchdog_check_action(
    step: int,
    *,
    check_every: int,
    parked: bool = False,
) -> bool:
    """Whether the trajectory watchdog
    (:mod:`kfac_pytorch_tpu_torch.watchdog`) runs its verdict after this
    step: after every ``check_every``-th completed step (``step`` counts
    completed steps).  Each check is the watchdog's one host read of the
    scalars it retained since the last (and, across ranks, its one
    all-reduce); between checks it only keeps references.  ``parked``,
    the terminal rung, keeps the cadence: checks still run and count,
    nothing escalates."""
    del parked  # the cadence is the same parked or not
    if check_every < 1:
        raise ValueError(f'check_every must be >= 1, got {check_every}')
    return step > 0 and step % check_every == 0


def iterative_refresh_iters(config: Any, bootstrapped: bool) -> int:
    """Newton–Schulz iterations of the next refresh:
    ``config.bootstrap_iters`` for the first refresh of a run and the
    first after a restore without a recompute, ``config.warm_iters``
    after that.

    Args:
        config: an :class:`~kfac_pytorch_tpu_torch.ops.iterative.
            IterativeConfig`.
        bootstrapped: the engine's warm-start flag
            (``precond._iter_bootstrapped``).
    """
    return config.warm_iters if bootstrapped else config.bootstrap_iters


class LambdaParamScheduler:
    """Multiplicative lambda scheduler for K-FAC hyperparameters.

    Each lambda maps the preconditioner's step count to a factor that
    multiplies the stored constant value; step intervals are cast to
    ``int`` and kept ``>= 1``.  Call :meth:`step` after
    ``preconditioner.step()``.

    Raises:
        ValueError: for a lambda on a parameter that is already a
            callable on the preconditioner (the two scheduling idioms
            exclude each other), on one that is ``None`` (disabled), or
            for an ``inv_update_steps`` lambda whose value at step 0
            takes the interval below ``stagger_refresh``.
    """

    def __init__(
        self,
        preconditioner: Any,
        *,
        factor_update_steps_lambda: Callable[[int], float] | None = None,
        inv_update_steps_lambda: Callable[[int], float] | None = None,
        damping_lambda: Callable[[int], float] | None = None,
        factor_decay_lambda: Callable[[int], float] | None = None,
        kl_clip_lambda: Callable[[int], float] | None = None,
        lr_lambda: Callable[[int], float] | None = None,
    ) -> None:
        self._preconditioner = preconditioner
        self._lambdas: dict[str, Callable[[int], float]] = {}
        provided = {
            'factor_update_steps': factor_update_steps_lambda,
            'inv_update_steps': inv_update_steps_lambda,
            'damping': damping_lambda,
            'factor_decay': factor_decay_lambda,
            'kl_clip': kl_clip_lambda,
            'lr': lr_lambda,
        }
        for name, lam in provided.items():
            if lam is None:
                continue
            current = getattr(preconditioner, f'_{name}')
            if callable(current):
                raise ValueError(
                    f'preconditioner.{name} is already a callable and '
                    'cannot be updated by the LambdaParamScheduler.',
                )
            if current is None:
                raise ValueError(
                    f'preconditioner.{name} is None (disabled) and '
                    'cannot be scheduled.',
                )
            self._lambdas[name] = lam
        # The construction-time half of stagger_refresh_action's
        # n_shards <= inv_update_steps rule, probed at step 0 (the
        # refresh-time raise backstops schedules that dip later).
        inv_lam = self._lambdas.get('inv_update_steps')
        n_shards = getattr(preconditioner, '_stagger_refresh', None)
        if inv_lam is not None and n_shards:
            base = getattr(preconditioner, '_inv_update_steps')
            factor = inv_lam(0)
            projected = max(1, int(base * factor))
            if int(n_shards) > projected:
                raise ValueError(
                    f'inv_update_steps_lambda(0)={factor!r} drives '
                    f'inv_update_steps={base} down to {projected}, below '
                    f'stagger_refresh={n_shards}: shard phases beyond the '
                    'interval would never run and their slots would go '
                    'stale forever',
                )

    def step(self, step: int | None = None) -> None:
        """Scale the scheduled hyperparameters in place.

        Args:
            step: the step passed to the lambdas (default: the
                preconditioner's step count).
        """
        at = step if step is not None else self._preconditioner.steps
        for name, lam in self._lambdas.items():
            new = getattr(self._preconditioner, f'_{name}') * lam(at)
            if name in _INT_PARAMS:
                new = max(1, int(new))
            setattr(self._preconditioner, f'_{name}', new)
