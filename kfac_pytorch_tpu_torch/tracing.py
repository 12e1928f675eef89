"""Function timing and the host-side event tally.

Port of ``kfac_pytorch_tpu/tracing.py``.  CUDA launches return before the
card finishes, so ``@trace(sync=True)`` calls ``torch.cuda.synchronize()``
before it stops the clock (the JAX module calls ``block_until_ready``
there); without ``sync`` the recorded time is the host's dispatch cost.

The event tally counts host-side recovery and robustness events (the
consistency guard's detections, repairs and quarantines), with an
optional step tag kept in a bounded ring for post-mortems.  It is
thread-safe: the deferred refresh of ``overlap_comm`` runs on a worker
thread (:mod:`kfac_pytorch_tpu_torch.overlap`).
"""
from __future__ import annotations

import functools
import logging
import threading
import time
from typing import Any, Callable, TypeVar

import torch

RT = TypeVar('RT')

_func_traces: dict[str, list[float]] = {}
_event_counts: dict[str, int] = {}
# Step-tagged event records, oldest dropped past the limit; the counts
# in _event_counts stay exact regardless.
_step_events: list[dict[str, Any]] = []
_STEP_EVENT_LIMIT = 4096
_event_lock = threading.Lock()
logger = logging.getLogger(__name__)


def clear_trace() -> None:
    """Clear recorded traces and event counts."""
    _func_traces.clear()
    with _event_lock:
        _event_counts.clear()
        _step_events.clear()


def count_event(name: str, n: int = 1, step: int | None = None) -> None:
    """Tally one host-side event (thread-safe); ``step`` also adds a
    ``{'step', 'name', 'n'}`` record to the bounded step-event ring
    (:func:`get_step_events`).  The tally is the same either way."""
    with _event_lock:
        _event_counts[name] = _event_counts.get(name, 0) + n
        if step is not None:
            _step_events.append(
                {'step': int(step), 'name': name, 'n': int(n)},
            )
            if len(_step_events) > _STEP_EVENT_LIMIT:
                del _step_events[: len(_step_events) - _STEP_EVENT_LIMIT]


def record_event(name: str, step: int, n: int = 1) -> None:
    """Step-tagged alias of :func:`count_event`."""
    count_event(name, n=n, step=step)


def get_events() -> dict[str, int]:
    """Snapshot of the event tally."""
    with _event_lock:
        return dict(_event_counts)


def get_step_events(
    since_step: int | None = None,
) -> list[dict[str, Any]]:
    """Snapshot of the step-tagged records, oldest first; ``since_step``
    keeps those at or after that step.  Untagged events are only in
    :func:`get_events`."""
    with _event_lock:
        out = [dict(e) for e in _step_events]
    if since_step is not None:
        out = [e for e in out if e['step'] >= since_step]
    return out


def log_events(loglevel: int = logging.INFO) -> None:
    """Log the event tally."""
    for name, count in get_events().items():
        logger.log(loglevel, f'{name}: {count}')


def percentile(ordered: list[float], q: float) -> float:
    """Linear-interpolation percentile of a sorted sample, ``q`` in
    ``[0, 1]``."""
    if not ordered:
        raise ValueError('percentile of an empty sample')
    if not 0.0 <= q <= 1.0:
        raise ValueError(f'q must be in [0, 1], got {q}')
    pos = q * (len(ordered) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    frac = pos - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


def get_trace(
    average: bool = True,
    max_history: int | None = None,
) -> dict[str, float]:
    """Recorded wall times in seconds by function name: the mean (or with
    ``average=False`` the sum) of the last ``max_history`` calls;
    functions with no call are omitted."""
    out = {}
    for fname, times in _func_traces.items():
        if max_history is not None and len(times) > max_history:
            times = times[-max_history:]
        if not times:
            continue
        out[fname] = sum(times)
        if average:
            out[fname] /= len(times)
    return out


def get_trace_stats(
    max_history: int | None = None,
) -> dict[str, dict[str, float]]:
    """``{fname: {'mean', 'p50', 'p95', 'max', 'count'}}`` in seconds over
    the last ``max_history`` calls."""
    out: dict[str, dict[str, float]] = {}
    for fname, times in _func_traces.items():
        if max_history is not None and len(times) > max_history:
            times = times[-max_history:]
        if not times:
            continue
        ordered = sorted(times)
        out[fname] = {
            'mean': sum(times) / len(times),
            'p50': percentile(ordered, 0.50),
            'p95': percentile(ordered, 0.95),
            'max': ordered[-1],
            'count': float(len(times)),
        }
    return out


def log_trace(
    average: bool = True,
    max_history: int | None = None,
    loglevel: int = logging.INFO,
) -> None:
    """Log :func:`get_trace`."""
    if len(_func_traces) == 0:
        return
    for fname, times in get_trace(average, max_history).items():
        logger.log(loglevel, f'{fname}: {times}')


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def trace(
    sync: bool = False,
) -> Callable[[Callable[..., RT]], Callable[..., RT]]:
    """Decorator factory recording each call's wall time under the
    function's name; with ``sync`` the card is synchronized before the
    clock stops (a no-op without CUDA)."""

    def decorator(func: Callable[..., RT]) -> Callable[..., RT]:
        @functools.wraps(func)
        def func_timer(*args: Any, **kwargs: Any) -> RT:
            t = time.perf_counter()
            out = func(*args, **kwargs)
            if sync:
                _synchronize()
            t = time.perf_counter() - t
            _func_traces.setdefault(func.__name__, []).append(t)
            return out

        return func_timer

    return decorator
