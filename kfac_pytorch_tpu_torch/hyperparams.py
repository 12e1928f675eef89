"""Hyperparameter schedules, validation and the canonical scalars.

Port of ``kfac_pytorch_tpu/hyperparams.py``: schedules are plain
``step -> value`` callables usable anywhere a constant hyperparameter
is accepted; the engine resolves them on the host every step, and
:func:`canonical_scalar` turns each resolved value into the 0-d tensor
the step's device work reads.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

# (type, value, dtype, device) -> the cached 0-d tensor.
_CANONICAL: dict[tuple, torch.Tensor] = {}
_CANONICAL_LIMIT = 256


def canonical_scalar(
    value: Any,
    device: torch.device | str = 'cpu',
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The 0-d tensor of a host hyperparameter on ``device``.

    The engine boundary's canonicalization point (JAX
    ``hyperparams.canonical_scalar``): a float becomes an f32 tensor, a
    bool a bool tensor, an int an int64 tensor (``dtype`` overrides).  A
    compiled consumer then sees one tensor argument whose value changes,
    never a Python number that it would specialize on, so a damping
    sweep compiles one program per step variant.  A new value is made
    by ``torch.full``: a fill kernel that takes the value as its
    argument, with no host-to-device copy and so no host sync (a
    per-step schedule stays sync-free).  Tensors are cached by value: a
    constant hyperparameter is made once and every later step reads the
    same tensor.  Under an active ``FakeTensorMode`` it returns a fresh
    fake tensor and caches nothing.
    """
    if dtype is None:
        if isinstance(value, bool):
            dtype = torch.bool
        elif isinstance(value, int):
            dtype = torch.int64
        else:
            dtype = torch.float32
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        # A dry run (analysis.contracts): a fake scalar, never cached.
        return torch.full((), value, dtype=dtype, device=device)
    key = (type(value), value, dtype, str(torch.device(device)))
    t = _CANONICAL.get(key)
    if t is None:
        if len(_CANONICAL) >= _CANONICAL_LIMIT:
            _CANONICAL.clear()
        t = torch.full((), value, dtype=dtype, device=device)
        _CANONICAL[key] = t
    return t


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
