"""Hyperparameter schedules and validation.

Port of ``kfac_pytorch_tpu/hyperparams.py``: schedules are plain
``step -> value`` callables usable anywhere a constant hyperparameter
is accepted; the engine resolves them on the host every step.
"""
from __future__ import annotations

import math
from typing import Any, Callable


def resolve(value: Callable[[int], Any] | Any, step: int) -> Any:
    """A hyperparameter's value at ``step`` (callables are schedules)."""
    return value(step) if callable(value) else value


def validate_damping(value: float, origin: str = 'damping') -> float:
    """Validate a resolved damping value.

    K-FAC divides by ``outer(dg, da) + damping`` and the eigenvalues are
    clamped to ``>= 0``, so a zero or negative damping produces inf/NaN
    with no diagnostic.  Called on every resolution, so a schedule that
    decays through zero fails at the step it goes bad.

    Raises:
        ValueError: when the value is not finite or not ``> 0``.
    """
    v = float(value)
    if not math.isfinite(v) or v <= 0.0:
        raise ValueError(
            f'{origin} must be a finite value > 0, got {value!r}: K-FAC '
            'divides by (outer(dg, da) + damping), so zero/negative '
            'damping produces inf/NaN gradients',
        )
    return v


def exp_decay_factor_averaging(
    min_value: float = 0.95,
) -> Callable[[int], float]:
    """Exponentially decaying factor-averaging schedule.

    The running-average weight at K-FAC step ``k`` is
    ``min(1 - 1/k, min_value)`` (Martens & Grosse 2015); ``k = 0`` is
    treated as ``k = 1``.
    """
    if min_value <= 0:
        raise ValueError('min_value must be greater than 0')

    def _factor_weight(step: int) -> float:
        if step < 0:
            raise ValueError(
                f'step value cannot be negative. Got step={step}.',
            )
        step = max(step, 1)
        return min(1 - (1 / step), min_value)

    return _factor_weight
