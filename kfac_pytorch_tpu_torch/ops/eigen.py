"""Eigendecomposition-based K-FAC preconditioning math.

Port of ``kfac_pytorch_tpu/ops/eigen.py``: decompositions in float32,
eigenvalues clamped to ``>= 0``, and the two-sided preconditioning
``qg @ ((qg^T @ grad @ qa) / (outer(dg, da) + damping)) @ qa^T``.
:func:`compute_factor_eig_general` is the general-eig escape hatch of
helpers with non-symmetric factors.
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


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


def compute_factor_eig_general(
    factor: torch.Tensor,
    inv_dtype: torch.dtype = torch.float32,
) -> EigenFactors:
    """General (non-symmetric) eigendecomposition of one factor (JAX
    ``ops/eigen.py:56-123``): the real parts of ``numpy.linalg.eig``,
    eigenvalues clamped at zero, on the factor's device in ``inv_dtype``.

    The JAX package runs this on the host on purpose, a
    ``pure_callback`` into ``numpy.linalg.eig`` (complex general eig
    does not lower to the TPU), and the port keeps that design: the
    factor is copied to the host with an explicit ``.cpu()`` and the
    result copied back to the factor's device.  It serves custom helpers
    whose factors are genuinely non-symmetric, on the replicated engine
    (``bucketed=False``) only; every built-in helper is symmetric and
    takes :func:`compute_factor_eigen`.

    A non-finite input, or a non-finite result, is sanitized to all
    zeros (the layer's gradient then maps to zero: a skipped update,
    not a poisoned one), logged once per event and counted in
    ``compute_factor_eig_general.nonfinite``.
    """
    f = factor.detach().float().cpu().numpy()
    try:
        if not np.isfinite(f).all():
            raise np.linalg.LinAlgError('non-finite factor input')
        d, q = np.linalg.eig(f)
        d = d.real.astype(np.float32)
        q = q.real.astype(np.float32)
        if not (np.isfinite(d).all() and np.isfinite(q).all()):
            raise np.linalg.LinAlgError('non-finite eig output')
    except np.linalg.LinAlgError as exc:
        logger.warning(
            'general eigendecomposition produced/received non-finite '
            'values (%s); sanitizing to zeros: the layer skips '
            'preconditioning until its factor recovers', exc,
        )
        compute_factor_eig_general.nonfinite += 1
        n = f.shape[-1]
        d = np.zeros((n,), np.float32)
        q = np.zeros((n, n), np.float32)
    q = torch.from_numpy(q).to(factor.device).to(inv_dtype)
    d = torch.from_numpy(d).to(factor.device).to(inv_dtype)
    return EigenFactors(q=q, d=torch.clamp(d, min=0.0))


#: Sanitized general eigendecompositions so far (the JAX package counts
#: them as the ``eig_general_nonfinite`` event).
compute_factor_eig_general.nonfinite = 0


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


def precondition_grad_eigen_diag_a(
    grad: torch.Tensor,
    a_diag: torch.Tensor,
    qg: torch.Tensor,
    dg: torch.Tensor,
    damping: float = 0.001,
) -> torch.Tensor:
    """Eigen preconditioning with an exactly diagonal A factor.

    ``diag(a_diag)`` is its own eigendecomposition (identity rotation),
    so only the G side rotates: ``qg @ ((qg^T @ grad) / (dg ⊗ a_diag +
    damping))``, the division in f32.  ``grad`` is the combined
    ``[out, V]`` layout of an embedding.
    """
    grad_dtype = grad.dtype
    grad = grad.to(qg.dtype)
    v1 = qg.mT @ grad
    v2 = (
        v1.float()
        / (dg.float()[:, None] * a_diag.float()[None, :] + damping)
    ).to(qg.dtype)
    return (qg @ v2).to(grad_dtype)
