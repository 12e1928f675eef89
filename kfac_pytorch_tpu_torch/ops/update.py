"""Factor running averages and gradient scaling (kl-clip).

Port of ``kfac_pytorch_tpu/ops/update.py``.  The kl-clip reduction stays
on the device: no ``.item()`` host syncs.
"""
from __future__ import annotations

from typing import Sequence

import torch


def ema_update_factor(
    factor: torch.Tensor,
    new: torch.Tensor,
    alpha: float,
    first_update: bool | torch.Tensor,
) -> torch.Tensor:
    """Exponential moving average update of a Kronecker factor.

    On the first update the running average starts from the identity
    (all ones for a diagonal ``[n]`` factor), so the result is ``alpha * I + (1 - alpha) * new``; afterwards
    ``alpha * old + (1 - alpha) * new``.  ``first_update`` may be a
    0-d bool tensor (the health guardrails decide it on the device), in
    which case the identity is selected with ``torch.where``: the same
    bits as the host branch.
    """
    if isinstance(first_update, torch.Tensor):
        if new.ndim == 1:
            eye = torch.ones_like(factor)
        else:
            eye = torch.eye(
                new.shape[-1], dtype=factor.dtype, device=factor.device,
            ).expand_as(factor)
        old = torch.where(first_update, eye, factor)
    elif first_update and new.ndim == 1:  # a diagonal factor's identity
        old = torch.ones_like(factor)
    elif first_update:
        old = torch.eye(
            new.shape[-1], dtype=factor.dtype, device=factor.device,
        ).expand_as(factor)
    else:
        old = factor
    return alpha * old + (1.0 - alpha) * new.to(factor.dtype)


def lr_squared(lr: float | torch.Tensor) -> float | torch.Tensor:
    """``lr^2``: an f32 product of a canonical 0-d tensor (as JAX squares
    its canonical f32 scalar), a host product of a Python number."""
    if isinstance(lr, torch.Tensor):
        return lr ** 2
    return float(lr) ** 2


def grad_scale_sum(
    precond_grad: torch.Tensor, grad: torch.Tensor,
    lr: float | torch.Tensor,
) -> torch.Tensor:
    """One layer's term of ``sum(precon_grad * grad) * lr^2``, in f32."""
    return torch.sum(precond_grad.float() * grad.float()) * lr_squared(lr)


def kl_clip_scale(
    vg_terms: Sequence[torch.Tensor] | torch.Tensor,
    kl_clip: float | torch.Tensor,
) -> torch.Tensor:
    """Gradient scale factor from the kl-clip heuristic.

    ``scale = min(1, sqrt(kl_clip / |sum|))``, and ``1`` when the sum is
    exactly zero.  Terms are summed in the order given.
    """
    if isinstance(vg_terms, (list, tuple)):
        if not vg_terms:
            return torch.tensor(1.0, dtype=torch.float32)
        vg_sum = torch.sum(torch.stack([t.float() for t in vg_terms]))
    else:
        vg_sum = vg_terms.float()
    zero = vg_sum == 0.0
    safe = torch.where(zero, torch.ones_like(vg_sum), vg_sum.abs())
    scale = torch.clamp(torch.sqrt(kl_clip / safe), max=1.0)
    return torch.where(zero, torch.ones_like(scale), scale)
