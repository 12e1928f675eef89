"""Eigendecomposition-based K-FAC preconditioning math.

Port of ``kfac_pytorch_tpu/ops/eigen.py``: decompositions in float32,
eigenvalues clamped to ``>= 0``, and the two-sided preconditioning
``qg @ ((qg^T @ grad @ qa) / (outer(dg, da) + damping)) @ qa^T``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class EigenFactors(NamedTuple):
    """Eigendecomposition of one Kronecker factor (Q, clamped eigenvalues)."""

    q: torch.Tensor
    d: torch.Tensor


def compute_factor_eigen(
    factor: torch.Tensor,
    inv_dtype: torch.dtype = torch.float32,
) -> EigenFactors:
    """Eigendecompose a symmetric factor (or a stack of them).

    ``torch.linalg.eigh`` in f32, cast to ``inv_dtype``, eigenvalues
    clamped at zero.
    """
    d, q = torch.linalg.eigh(factor.float())
    return EigenFactors(
        q=q.to(inv_dtype), d=torch.clamp(d.to(inv_dtype), min=0.0),
    )


def compute_dgda(
    dg: torch.Tensor, da: torch.Tensor, damping: float,
) -> torch.Tensor:
    """``dgda = 1 / (outer(dg, da) + damping)``, batched over leading dims."""
    return 1.0 / (dg[..., :, None] * da[..., None, :] + damping)


def precondition_grad_eigen(
    grad: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    da: torch.Tensor | None = None,
    dg: torch.Tensor | None = None,
    dgda: torch.Tensor | None = None,
    damping: float = 0.001,
) -> torch.Tensor:
    """Two-sided eigenbasis preconditioning of a combined gradient.

    ``grad`` has the combined layout ``[out_dim, in_dim(+1 if bias)]``,
    so G (``qg``) acts on the left and A (``qa``) on the right.  Either
    ``dgda`` or both ``da``/``dg`` must be given.
    """
    grad_dtype = grad.dtype
    grad = grad.to(qa.dtype)
    v1 = qg.mT @ grad @ qa
    if dgda is not None:
        v2 = v1 * dgda
    else:
        if da is None or dg is None:
            raise ValueError('da/dg must be provided when dgda is None')
        v2 = v1 / (dg[..., :, None] * da[..., None, :] + damping)
    return (qg @ v2 @ qa.mT).to(grad_dtype)
