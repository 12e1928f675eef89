"""Fault injectors for the robustness subsystems (testing and drills).

Port of the injectors of ``kfac_pytorch_tpu/testing.py``:
:func:`bitflip` (one flipped bit, the silent-data-corruption model),
:func:`desync_replica` (a corruption on one rank only),
:func:`poison_factors` (non-finite or scaled factor EMAs) and
:func:`eigh_failure_config` (a :class:`~kfac_pytorch_tpu_torch.health.\
HealthConfig` that forces decomposition failures).  The JAX package
threads its state through functions, so its injectors return a new
state; the port's state lives in the preconditioner, so
:func:`poison_factors` and :func:`desync_slot` write into it.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch.health import HealthConfig

__all__ = [
    'bitflip',
    'desync_replica',
    'desync_slot',
    'eigh_failure_config',
    'poison_factors',
]


def bitflip(t: torch.Tensor, index: int = 0, bit: int = 20) -> torch.Tensor:
    """Copy of an f32 tensor with one bit of element ``index`` (flat,
    modulo the size) flipped; ``bit=20`` perturbs the value by a relative
    ~2^-3, and nothing overflows."""
    out = t.detach().to(torch.float32).clone().contiguous()
    view = out.reshape(-1).view(torch.int32)
    i = index % max(view.numel(), 1)
    mask = 1 << bit
    if bit == 31:  # the sign bit, as an int32 value
        mask = -(1 << 31)
    view[i] ^= mask
    return out


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def desync_replica(
    t: torch.Tensor,
    replica: int,
    fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """``fn(t)`` (default :func:`bitflip`) on rank ``replica``, ``t`` on
    every other rank: one rank's copy of a replicated tensor (or of its
    column's slot of a bucket stack) silently diverges.  Every rank calls
    it with the same arguments; only the owner's buffer changes."""
    if fn is None:
        fn = bitflip
    if _rank() != replica:
        return t
    return fn(t).to(dtype=t.dtype, device=t.device)


def poison_factors(
    precond: Any,
    bases: str | tuple[str, ...],
    value: float = float('nan'),
    sides: str = 'ag',
    *,
    replica: int | None = None,
    scale: float | None = None,
) -> Any:
    """Overwrite the A (``'a' in sides``) and/or G factor EMA of each
    named layer of ``precond`` with ``value`` (default NaN), or with
    ``scale`` multiply it (the finite mode).  ``replica`` restricts the
    change to that rank's copy (:func:`desync_replica`).  Returns
    ``precond``."""
    if isinstance(bases, str):
        bases = (bases,)
    if scale is not None:
        if not math.isfinite(scale):
            raise ValueError(
                'poison_factors(scale=...) is the FINITE poisoning '
                f'mode; got scale={scale!r}',
            )
        if not (isinstance(value, float) and math.isnan(value)):
            raise ValueError(
                'poison_factors: pass either value= (overwrite mode) '
                'or scale= (finite multiply mode), not both',
            )

    def poisoned(factor):
        def fn(f):
            return f * scale if scale is not None else torch.full_like(
                f, value)
        if replica is None:
            return fn(factor)
        return desync_replica(factor, replica, fn)

    for base in bases:
        st = precond.layers[base]
        if 'a' in sides:
            st.a_factor = poisoned(st.a_factor)
        if 'g' in sides:
            st.g_factor = poisoned(st.g_factor)
    return precond


def desync_slot(
    precond: Any,
    key: str,
    slot: int,
    field: str = 'qa',
    replica: int = 0,
    fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> Any:
    """Rewrite global slot ``slot`` of bucket ``key``'s ``field`` stack by
    ``fn`` (default :func:`bitflip`) on rank ``replica`` only, which must
    hold that slot (its grid column); the other ranks keep theirs.
    Returns ``precond``."""
    if fn is None:
        fn = bitflip
    if _rank() != replica:
        return precond
    seg = precond.plan.bucket(key).seg
    local = slot - precond.grid.col * seg
    if not 0 <= local < seg:
        raise ValueError(
            f'rank {replica} holds column {precond.grid.col} of bucket '
            f'{key!r}, not slot {slot}',
        )
    bs = precond.buckets[key]
    stack = getattr(bs, field).clone()
    stack[local] = fn(stack[local]).to(stack.dtype)
    setattr(bs, field, stack)
    return precond


def eigh_failure_config(
    precond: Any = None,
    layers: tuple[str, ...] | None = None,
    attempts: int = 99,
    **overrides: Any,
) -> HealthConfig:
    """A :class:`HealthConfig` that forces decomposition failures.

    ``layers`` (names) become the ``(bucket, slot)`` pairs of
    ``precond.plan.slot_of`` (so ``precond`` is needed); ``None`` fails
    every slot.  ``attempts=1`` fails only the first attempt (recovery
    by the first retry); more than ``max_eigh_retries`` fails every
    attempt (fallback, then quarantine)."""
    inject_layers = None
    if layers is not None:
        if precond is None:
            raise ValueError(
                'eigh_failure_config needs the preconditioner to map '
                'layer names to bucket slots',
            )
        inject_layers = tuple(precond.plan.slot_of[name] for name in layers)
    return HealthConfig(
        inject_eigh_failures=attempts,
        inject_eigh_layers=inject_layers,
        **overrides,
    )
