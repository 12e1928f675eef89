"""Explicit-inverse K-FAC preconditioning math.

Port of ``kfac_pytorch_tpu/ops/inverse.py:18-108``: factors are inverted
with Tikhonov damping through a Cholesky solve in f32, and the gradient
is preconditioned as ``g_inv @ grad @ a_inv``.

``torch.linalg.cholesky`` raises on a factor that is not positive
definite, and on CUDA it synchronizes with the host to find out; JAX's
Cholesky returns NaN and carries on.  The batched inverse therefore
runs ``cholesky_ex(check_errors=False)`` and sets the slots whose
factorization failed to NaN on the device: the same non-finite result
as the JAX package, with no host synchronization per refresh.
"""
from __future__ import annotations

import torch

from kfac_pytorch_tpu_torch.ops.iterative import damped_stack


def batched_damped_inv(
    stack: torch.Tensor,
    damping: float | torch.Tensor,
) -> torch.Tensor:
    """``inv(F_l + damping I)`` of each slot of a ``[L, n, n]`` stack,
    in f32, symmetrized as ``(X + X^T) / 2``; NaN in every slot whose
    damped factor is not positive definite."""
    chol, info = torch.linalg.cholesky_ex(
        damped_stack(stack, damping), check_errors=False,
    )
    n = stack.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=stack.device)
    inv = torch.cholesky_solve(eye.expand_as(chol), chol)
    inv = torch.where(
        (info > 0)[..., None, None], torch.full_like(inv, float('nan')), inv,
    )
    return (inv + inv.mT) / 2.0


def compute_factor_inv(
    factor: torch.Tensor,
    damping: float | torch.Tensor = 0.001,
    inv_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Damped inverse of one symmetric factor, computed in f32 and
    returned in ``inv_dtype``."""
    return batched_damped_inv(factor[None], damping)[0].to(inv_dtype)


def compute_factor_inv_general(
    factor: torch.Tensor,
    damping: float | torch.Tensor = 0.001,
    inv_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Damped inverse of a possibly non-symmetric factor (an LU
    inverse, never symmetrized)."""
    return torch.linalg.inv(damped_stack(factor, damping)).to(inv_dtype)


def precondition_grad_inverse(
    grad: torch.Tensor, a_inv: torch.Tensor, g_inv: torch.Tensor,
) -> torch.Tensor:
    """``g_inv @ grad @ a_inv`` of a combined ``[out, in(+1)]`` gradient,
    in the inverses' dtype, returned in the gradient's."""
    return (g_inv @ grad.to(a_inv.dtype) @ a_inv).to(grad.dtype)


def precondition_grad_inverse_diag_a(
    grad: torch.Tensor,
    a_inv_diag: torch.Tensor,
    g_inv: torch.Tensor,
) -> torch.Tensor:
    """Inverse-method preconditioning with an exactly diagonal A:
    ``a_inv_diag`` is the refresh-time ``1 / (a + damping)``, so the
    right-hand product is a per-column scaling."""
    grad_dtype = grad.dtype
    grad = grad.to(g_inv.dtype)
    return (
        (g_inv @ grad) * a_inv_diag[None, :].to(g_inv.dtype)
    ).to(grad_dtype)
