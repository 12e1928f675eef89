"""Eigh-free inverse roots: batched coupled Newton–Schulz iteration.

Port of ``kfac_pytorch_tpu/ops/iterative.py`` (``compute_method=
'iterative'``).  The refresh is matmuls only over the ``[L, n, n]``
bucket stacks::

    S = F + damping I
    X_0 = warm root  (or  I / c,  c >= ||S||_2  on a cold start)
    M_0 = S X_0
    repeat k times:   T = 2I - M;   X <- X T;   M <- M T

``M_k = S X_k`` throughout, so ``X_k -> S^{-1}`` quadratically once
``||M_0 - I||_2 < 1``.  A warm seed is taken per slot only when its
residual ``||S X - I||_F`` is below the gate (an ordered comparison:
NaN seeds restart cold).  The trip count is fixed (a Python loop of
``torch.bmm``), and convergence is reported per slot instead.

On the card these are cuBLAS ``bmm`` calls, as the JAX package leaves
them to XLA; they must run in true f32 (TF32 off), or the residual
floor rises by orders of magnitude.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class IterativeConfig:
    """Static knobs of the Newton–Schulz refresh.

    Args:
        warm_iters: iterations per refresh once warm-started.
        bootstrap_iters: iterations of a cold start (the first refresh,
            and the first after a restore without a recompute).
        tol: per-slot convergence tolerance on ``||M - I||_F``
            (reported in ``unconverged_iters``; observational here).
        warm_restart_gate: a warm seed is taken per slot only when its
            residual is below this bound; the zero-initialized stacks
            (residual ``sqrt(n)``) restart cold.
        compute_dtype: matmul input dtype (``None`` = f32).
            ``torch.bfloat16`` rounds both operands to bf16 and
            multiplies in f32; residuals, seeds and the root stay f32.
    """

    warm_iters: int = 3
    bootstrap_iters: int = 30
    tol: float = 5e-2
    warm_restart_gate: float = 0.9
    compute_dtype: torch.dtype | None = None

    def __post_init__(self) -> None:
        if self.warm_iters < 0 or self.bootstrap_iters < 0:
            raise ValueError(
                'warm_iters/bootstrap_iters must be >= 0',
            )
        if self.tol <= 0:
            raise ValueError('tol must be > 0')
        if not 0 < self.warm_restart_gate < 1:
            raise ValueError(
                'warm_restart_gate must lie in (0, 1): Newton–Schulz '
                'diverges when the seed residual reaches 1',
            )


class NewtonSchulzResult(NamedTuple):
    """One side's batched Newton–Schulz refresh.

    ``inv [L, n, n]`` the symmetrized damped inverse, ``residual [L]``
    the final ``||M - I||_F``, ``bound [L]`` the spectral-norm bound of
    the cold normalization, ``unconverged_iters [L]`` (int32) the
    iterations whose post-update residual still exceeded ``tol``.
    """

    inv: torch.Tensor
    residual: torch.Tensor
    bound: torch.Tensor
    unconverged_iters: torch.Tensor


def damped_stack(
    stack: torch.Tensor, damping: float | torch.Tensor,
) -> torch.Tensor:
    """``F + damping I`` in f32 for a ``[..., n, n]`` stack: the one
    damping helper of the Cholesky and Newton–Schulz paths."""
    n = stack.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=stack.device)
    return stack.float() + damping * eye


def spectral_norm_bound(stack: torch.Tensor) -> torch.Tensor:
    """Per-slot upper bound on ``||S||_2`` of a symmetric ``[L, n, n]``
    stack: the max absolute row sum, floored at ``1e-30`` so an all-zero
    slot normalizes to a finite seed."""
    bound = stack.float().abs().sum(-1).amax(-1)
    return torch.clamp(bound, min=1e-30)


def _bmm(
    a: torch.Tensor, b: torch.Tensor, compute_dtype: torch.dtype | None,
) -> torch.Tensor:
    """Batched matmul of ``compute_dtype`` inputs with an f32 result:
    the operands are rounded, then multiplied in f32 (a product of two
    bf16 values is exact in f32), so the result is rounded once."""
    if compute_dtype is not None and compute_dtype != torch.float32:
        a = a.to(compute_dtype).float()
        b = b.to(compute_dtype).float()
    return torch.bmm(a, b)


def _frob_residual(m: torch.Tensor) -> torch.Tensor:
    """Per-slot ``||M - I||_F`` of a ``[L, n, n]`` stack."""
    n = m.shape[-1]
    d = m.float() - torch.eye(n, dtype=torch.float32, device=m.device)
    return torch.sqrt(torch.sum(d * d, dim=(-2, -1)))


def batched_newton_schulz_inverse(
    stack: torch.Tensor,
    damping: float | torch.Tensor,
    *,
    iters: int,
    warm_start: torch.Tensor | None = None,
    tol: float = 5e-2,
    warm_restart_gate: float = 0.9,
    compute_dtype: torch.dtype | None = None,
) -> NewtonSchulzResult:
    """Coupled Newton–Schulz ``(F + damping I)^{-1}`` over a stack.

    Args:
        stack: ``[L, n, n]`` symmetric PSD factor stack.
        damping: Tikhonov damping.
        iters: the fixed iteration count.
        warm_start: ``[L, n, n]`` previous roots, or ``None`` (cold
            everywhere); taken per slot only below the gate.
        tol: residual threshold of the ``unconverged_iters`` count.
        warm_restart_gate: the seed-residual gate.
        compute_dtype: matmul input dtype (``None`` = f32).
    """
    s = damped_stack(stack, damping)
    n = s.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=s.device)
    bound = spectral_norm_bound(s)
    cold_x = eye / bound[:, None, None]
    cold_m = s / bound[:, None, None]
    if warm_start is None:
        x, m = cold_x, cold_m
    else:
        wx = warm_start.float()
        wm = _bmm(s, wx, compute_dtype)
        # NaN residuals compare false: a poisoned seed restarts cold.
        sel = (_frob_residual(wm) < warm_restart_gate)[:, None, None]
        x = torch.where(sel, wx, cold_x)
        m = torch.where(sel, wm, cold_m)
    res = _frob_residual(m)
    stale = torch.zeros(s.shape[0], dtype=torch.int32, device=s.device)
    for _ in range(iters):
        t = 2.0 * eye - m
        x = _bmm(x, t, compute_dtype)
        m = _bmm(m, t, compute_dtype)
        res = _frob_residual(m)
        stale = stale + (res > tol).to(torch.int32)
    inv = (x + x.mT) / 2.0
    return NewtonSchulzResult(
        inv=inv, residual=res, bound=bound, unconverged_iters=stale,
    )


def batched_newton_schulz_inv_sqrt(
    stack: torch.Tensor,
    damping: float | torch.Tensor,
    *,
    iters: int,
    tol: float = 5e-2,
    compute_dtype: torch.dtype | None = None,
) -> NewtonSchulzResult:
    """Coupled Newton–Schulz ``(F + damping I)^{-1/2}`` over a stack
    (Denman–Beavers form, cold start only)::

        Y_0 = S / c,  Z_0 = I
        T = (3I - Z Y) / 2;   Y <- Y T;   Z <- T Z

    ``Z -> (S/c)^{-1/2}``, so the root is ``Z / sqrt(c)``.  ``residual``
    is ``||Z Y - I||_F`` of the returned iterate, and
    ``unconverged_iters`` is ``iters`` where it exceeds ``tol``, else 0.
    """
    s = damped_stack(stack, damping)
    n = s.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=s.device)
    bound = spectral_norm_bound(s)
    y = s / bound[:, None, None]
    z = eye.expand_as(s)
    for _ in range(iters):
        t = (3.0 * eye - _bmm(z, y, compute_dtype)) / 2.0
        y = _bmm(y, t, compute_dtype)
        z = _bmm(t, z, compute_dtype)
    res = _frob_residual(_bmm(z, y, compute_dtype))
    inv_sqrt = z / torch.sqrt(bound)[:, None, None]
    inv_sqrt = (inv_sqrt + inv_sqrt.mT) / 2.0
    return NewtonSchulzResult(
        inv=inv_sqrt,
        residual=res,
        bound=bound,
        unconverged_iters=torch.where(
            res > tol, iters, 0,
        ).to(torch.int32),
    )
