"""Honest per-phase step timing for the K-FAC engine.

Port of ``kfac_pytorch_tpu/observe/timeline.py``.  CUDA work is
asynchronous: a call returns before the card finishes, so a host clock
around it measures the enqueue.  Every span recorded here therefore ends
in ``torch.cuda.synchronize()`` (the JAX module's
``jax.block_until_ready``) and opens a
``torch.profiler.record_function('kfac/<name>')`` range, so the same
phase names appear in a ``torch.profiler`` trace.

Two measurement modes:

* **whole-step timeline** — :class:`StepTimeline` is installed on the
  engine by ``ObserveConfig(timeline=True)``; each step is recorded under
  its variant (``step/plain``, ``step/factor``, ``step/inv``; stagger
  shard steps ``step/{plain|factor}+shard<k>``, a step that installs a
  deferred refresh ``step/{plain|factor}+overlap_inv`` or
  ``+overlap_shard<k>``, a consistency check step ``+consistency``, the
  JAX names) with one synchronize per step.  That synchronize is an
  observer cost, so the timeline is opt-in.
* **split-phase profile** — :func:`profile_phases` runs the engine's own
  phase hooks (capture, factor EMA, refresh, precondition) eagerly, each
  bracketed by a synchronize, in one loop whose whole iteration is timed
  on the same runs, so the sum of the phases and the chained total come
  from the same work.

The canonical phase names (:data:`PHASES`) are the contract shared with
the report payloads (:mod:`~kfac_pytorch_tpu_torch.observe.report`).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator

import torch

from kfac_pytorch_tpu_torch.tracing import percentile

# Canonical step-phase names.  'capture' is the forward/backward with
# activation/output-gradient capture; 'factor_ema' the factor EMA fold
# (with the factor all-reduce); 'eigh_refresh' the second-order recompute
# (batched eigh or damped inverses, with the KAISA column gather of the
# decompositions); 'precondition' the rotation (the fused kernel) with
# the KAISA row gather of the preconditioned gradients.
#
# Overlap mode (overlap_comm=True) adds two scopes rather than host
# phases: 'overlap/refresh' (the deferred refresh, on its worker thread)
# and 'overlap/collect' (the precondition that first consumes it).
PHASES = ('capture', 'factor_ema', 'eigh_refresh', 'precondition')


def annotation(name: str) -> contextlib.AbstractContextManager:
    """Profiler range ``kfac/<name>`` in a ``torch.profiler`` trace."""
    return torch.profiler.record_function(f'kfac/{name}')


def scope(name: str, enabled: bool = True):
    """:func:`annotation` when ``enabled``, else a no-op.  A range in the
    trace only: never a numeric or scheduling change."""
    if not enabled:
        return contextlib.nullcontext()
    return annotation(name)


def _device_sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimeline:
    """Bounded per-phase wall-time recorder with percentile summaries.

    Args:
        history: samples retained per phase (a ring buffer: long runs
            must not grow host memory without bound).
        sync: called before a span's clock stops (default: synchronize
            the CUDA device when one is in use); :attr:`syncs` counts
            the calls.
    """

    def __init__(
        self, history: int = 512,
        sync: Callable[[], None] | None = None,
    ) -> None:
        if history < 1:
            raise ValueError('history must be >= 1')
        self.history = history
        self._sync = _device_sync if sync is None else sync
        self._times: dict[str, list[float]] = {}
        #: Synchronizes issued so far (one per timed span).
        self.syncs = 0

    def record(self, phase: str, seconds: float) -> None:
        times = self._times.setdefault(phase, [])
        times.append(float(seconds))
        if len(times) > self.history:
            del times[: len(times) - self.history]

    def sync(self) -> None:
        """The span's synchronize (counted)."""
        self._sync()
        self.syncs += 1

    @contextlib.contextmanager
    def span(self, phase: str) -> Iterator[None]:
        """Record one phase span, synchronized before the clock stops."""
        with annotation(phase):
            t0 = time.perf_counter()
            yield
            self.sync()
            self.record(phase, time.perf_counter() - t0)

    def timed(self, phase: str, fn: Callable[..., Any], *args: Any) -> Any:
        """Run ``fn(*args)``, synchronize, record the span, return the
        outputs."""
        with self.span(phase):
            out = fn(*args)
        return out

    def clear(self) -> None:
        self._times.clear()

    @property
    def phases(self) -> tuple[str, ...]:
        return tuple(self._times)

    def times(self, phase: str) -> tuple[float, ...]:
        return tuple(self._times.get(phase, ()))

    def summary(self) -> dict[str, dict[str, float]]:
        """Per-phase ``{'mean', 'p50', 'p95', 'max', 'count'}`` seconds;
        phases with no samples are omitted."""
        out: dict[str, dict[str, float]] = {}
        for phase, times in self._times.items():
            if not times:
                continue
            ordered = sorted(times)
            out[phase] = {
                'mean': sum(times) / len(times),
                'p50': percentile(ordered, 0.50),
                'p95': percentile(ordered, 0.95),
                'max': ordered[-1],
                'count': float(len(times)),
            }
        return out

    def scalars(self, prefix: str = 'observe/time') -> dict[str, float]:
        """Flat ``{prefix}/{phase}/{stat}`` scalars for the emitters."""
        out: dict[str, float] = {}
        for phase, stats in self.summary().items():
            for stat, value in stats.items():
                out[f'{prefix}/{phase}/{stat}'] = value
        return out


def _phase_hooks(precond: Any, forward_backward: Callable[[], Any]):
    """``{phase: fn}`` of one decomposed refresh step on ``precond``:
    the capture forward/backward, the factor EMA, the refresh and the
    precondition, each the engine's own hook."""
    def capture():
        precond._arm_capture(True)
        forward_backward()

    def ema():
        precond._update_factors(first_update=False)

    def refresh():
        precond._refresh(precond.damping)

    def pre():
        precond._precondition(precond.damping, precond.kl_clip, precond.lr)

    return {'capture': capture, 'factor_ema': ema, 'eigh_refresh': refresh,
            'precondition': pre}


def profile_phases(
    precond: Any,
    forward_backward: Callable[[], Any],
    iters: int = 5,
) -> tuple[dict[str, float], float]:
    """Time the engine's step phases one by one.

    ``forward_backward()`` runs one batch's forward and backward
    (``zero_grad``, the loss, ``backward()``).  Returns ``(phase_seconds,
    total_seconds)``: ``phase_seconds`` maps every name in :data:`PHASES`
    to the mean seconds of that phase and ``total_seconds`` is the mean
    wall time of one whole decomposed step.  The phases are the engine's
    own hooks (the capture, ``_update_factors``, ``_refresh``,
    ``_precondition``), so the decomposition is the step split at its
    phase boundaries.

    All numbers come from one loop: each iteration runs capture -> factor
    EMA -> refresh -> precondition in order, each phase ended by a
    synchronize, and the whole iteration is timed by the total clock;
    measuring phases and total on the same runs keeps the decomposition
    consistent on a noisy host.  Iteration 0 warms up and is not counted.
    The preconditioner's state (counters, factor EMAs, stacks) is put
    back afterwards; the ``.grad`` of the model holds the last
    iteration's preconditioned gradients.  Profile without a
    ``HealthConfig`` (the guarded EMA threads a verdict this loop does
    not carry).  Each phase is bracketed by :func:`annotation`.
    """
    from kfac_pytorch_tpu_torch.utils.checkpoint import snapshot_host_state

    rollback = snapshot_host_state(precond)
    hooks = _phase_hooks(precond, forward_backward)
    sums = dict.fromkeys(PHASES, 0.0)
    total_sum = 0.0
    try:
        for it in range(iters + 1):
            t_iter = time.perf_counter()
            for phase in PHASES:
                with annotation(phase):
                    t0 = time.perf_counter()
                    hooks[phase]()
                    _device_sync()
                    if it > 0:
                        sums[phase] += time.perf_counter() - t0
            if it > 0:
                total_sum += time.perf_counter() - t_iter
    finally:
        rollback()
    return {phase: sums[phase] / iters for phase in PHASES}, total_sum / iters


def profile_overlap_delta(
    precond: Any,
    forward_backward: Callable[[], Any],
    iters: int = 5,
) -> dict[str, float]:
    """Exposed-refresh estimate: the in-band refresh step against the
    deferred one, in one alternating loop.

    Both runs do the same work (capture, factor EMA, a full refresh,
    precondition); the synchronous one refreshes in band between the EMA
    and the precondition, the overlap one issues the refresh first
    (:meth:`_issue_deferred_refresh`, a worker thread and on CUDA a side
    stream, as ``overlap_comm=True`` does) and installs it before the
    precondition, so

    ``exposed_comm_estimate_s = sync_refresh_step_s -
    overlap_refresh_step_s``

    is the wall time per refresh that the deferral recovers.  The same
    loop, with synchronize bracketing, as :func:`profile_phases`; the
    state is put back afterwards.  Bucketed stage only.
    """
    from kfac_pytorch_tpu_torch.utils.checkpoint import snapshot_host_state

    if not getattr(precond, 'bucketed', False):
        raise ValueError('profile_overlap_delta needs the bucketed stage')
    rollback = snapshot_host_state(precond)
    hooks = _phase_hooks(precond, forward_backward)

    def sync_step():
        for phase in PHASES:
            hooks[phase]()

    def overlap_step():
        work = precond._issue_deferred_refresh(('inv',), precond.damping)
        hooks['capture']()
        hooks['factor_ema']()
        precond._install_refresh(work.wait())
        hooks['precondition']()

    sums = {'sync': 0.0, 'overlap': 0.0}
    try:
        for it in range(iters + 1):
            for name, fn in (('sync', sync_step), ('overlap', overlap_step)):
                with annotation(f'overlap_profile/{name}'):
                    t0 = time.perf_counter()
                    fn()
                    _device_sync()
                    if it > 0:
                        sums[name] += time.perf_counter() - t0
    finally:
        rollback()
    sync_s = sums['sync'] / iters
    overlap_s = sums['overlap'] / iters
    return {
        'sync_refresh_step_s': sync_s,
        'overlap_refresh_step_s': overlap_s,
        'exposed_comm_estimate_s': sync_s - overlap_s,
    }
