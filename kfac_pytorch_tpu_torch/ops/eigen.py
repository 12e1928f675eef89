"""Eigendecomposition-based K-FAC preconditioning math.

Port of ``kfac_pytorch_tpu/ops/eigen.py``: decompositions in float32,
eigenvalues clamped to ``>= 0``, and the two-sided preconditioning
``qg @ ((qg^T @ grad @ qa) / (outer(dg, da) + damping)) @ qa^T``.
:func:`compute_factor_eig_general` is the general-eig escape hatch of
helpers with non-symmetric factors.  Every symmetric decomposition goes
through :func:`symmetric_eigh`, which on CUDA checks each result and
redoes a failed matrix shifted by its mean eigenvalue (cuSOLVER's f32
``eigh`` fails on near-multiples of the identity).
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

logger = logging.getLogger(__name__)


class EigenFactors(NamedTuple):
    """Eigendecomposition of one Kronecker factor (Q, clamped eigenvalues)."""

    q: torch.Tensor
    d: torch.Tensor


def symmetric_eigh(
    m: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(eigenvalues, eigenvectors)`` of a symmetric matrix or stack, as
    ``torch.linalg.eigh`` returns them, with cuSOLVER's failures redone.

    cuSOLVER's f32 ``eigh`` returns a wrong decomposition of a matrix
    within ~1e-8 of a multiple of the identity, which is what a factor EMA
    is in its first steps from the identity seed, or for a layer whose
    output gradients are tiny: on an H100 a 1024-wide G factor of
    ResNet-50 whose eigenvalues all lie at 0.69834 came back with one at
    165.2 and an eigen-residual of 626 (``chip_smoke.py`` phase 24 found
    it through the Observe monitor's Kronecker extremes).  Decomposed as
    ``M - mu I``, ``mu`` its mean eigenvalue, with ``mu`` added back
    (:func:`_shifted_eigh`), the same matrix gives the float64 spectrum to
    1e-15.  So on a CUDA tensor each matrix is decomposed plainly and its
    residual ``max|M Q - Q diag(d)|`` computed in float64 (TF32 settings
    do not reach it); one whose residual exceeds ``max(1e-3, 8 n eps)`` of
    ``max|M|`` (a sound f32 decomposition stays near ``n eps``) is
    decomposed again shifted and counted in the ``eigh_shifted_redo``
    event.  The shift is kept for the failures: on the card it costs
    accuracy elsewhere, in the small eigenvalues' eigenvectors of
    well-spread factors (a damped inverse's action 1e-4 from float64
    instead of 1e-6, ResNet-32) and on factors within 1e-3 of a multiple
    of the identity that cuSOLVER decomposes soundly (a low-rank
    ResNet-50 bucket's exact side 2.3e-4 from float64 against under
    1e-4).  The check reads one flag back to the host per call (``eigh``
    synchronizes already).  A CPU tensor takes the plain call, which
    LAPACK gets right, so CPU results stay the JAX package's; so does a
    fake tensor (a contract dry run has no values to check).
    """
    if m.device.type != 'cuda' or is_fake(m):
        return torch.linalg.eigh(m)
    n = m.shape[-1]
    d, q = _checked_eigh(m.reshape(-1, n, n))
    return d.reshape(m.shape[:-1]), q.reshape(m.shape)


# The float64 residual and the read of the failed slots are the check
# itself: one read a refresh, where eigh synchronizes already.
def _checked_eigh(  # torchlint: allow(f64-promotion, host-sync)
    mb: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`symmetric_eigh`'s CUDA path on any device, for an ``[k, n,
    n]`` stack: ``torch.linalg.eigh``, then each matrix whose float64
    eigen-residual fails the bar decomposed again shifted."""
    n = mb.shape[-1]
    db, qb = torch.linalg.eigh(mb)
    bar = max(1e-3, 8 * n * float(torch.finfo(torch.float32).eps))
    # Chunks of at most 2^25 f64 elements (256 MB) a stack.
    step = max(1, (1 << 25) // (n * n))
    bad = []
    for i in range(0, mb.shape[0], step):
        m64, q64 = mb[i:i + step].double(), qb[i:i + step].double()
        resid = (m64 @ q64 - q64 * db[i:i + step].double()[:, None, :])
        bad.append(resid.abs().amax(dim=(1, 2))
                   > bar * m64.abs().amax(dim=(1, 2)))
    idx = torch.cat(bad).nonzero().flatten()
    if idx.numel() == 0:
        return db, qb
    from kfac_pytorch_tpu_torch import tracing

    tracing.count_event('eigh_shifted_redo', n=int(idx.numel()))
    ds, qs = _shifted_eigh(mb.index_select(0, idx))
    return (db.index_copy(0, idx, ds.to(db.dtype)),
            qb.index_copy(0, idx, qs.to(qb.dtype)))


def _shifted_eigh(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh(m - mu I)`` with ``mu``, the mean of each
    matrix's diagonal, added back to the eigenvalues (the eigenvectors are
    the same, the spectrum moves by ``mu``)."""
    mu = torch.diagonal(m, dim1=-2, dim2=-1).mean(-1)
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    d, q = torch.linalg.eigh(m - mu[..., None, None] * eye)
    return d + mu[..., None], q


def compute_factor_eigen(
    factor: torch.Tensor,
    inv_dtype: torch.dtype = torch.float32,
) -> EigenFactors:
    """Eigendecompose a symmetric factor (or a stack of them).

    :func:`symmetric_eigh` in f32, cast to ``inv_dtype``, eigenvalues
    clamped at zero.
    """
    d, q = symmetric_eigh(factor.float())
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
    # The general eig runs on the host by design (JAX: a pure_callback).
    f = factor.detach().float().cpu().numpy()  # torchlint: allow(host-sync)
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
