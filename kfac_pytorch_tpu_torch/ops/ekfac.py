"""EKFAC: per-step re-estimation of the curvature scales in the K-FAC
eigenbasis.

Port of ``kfac_pytorch_tpu/ops/ekfac.py`` (George et al. 2018).  The
Kronecker eigenbasis ``qa``/``qg`` is kept and refreshed rarely; the
eigenvalue grid ``outer(dg, da)`` is replaced by the second moment of
the per-row gradients projected into that basis,

    S[j, i] = E_rows[ (g_row^T qg_j)^2 * (a_row^T qa_i)^2 ],

which reduces to ``outer(dg, da)`` under K-FAC's independence
assumption, so the damping scale stays that of plain K-FAC.  Rows follow
:mod:`kfac_pytorch_tpu_torch.ops.cov`: raw per-example (dense) or
per-position (conv) vectors with a norm ``s`` such that ``A = rows^T
rows / (R s^2)``; the statistic divides by ``R * s_a^2 * s_g^2``.
Projections multiply f32 copies of the rows and of the basis rounded to
the rows' dtype (float64 rows stay float64, a reference evaluation).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in its own dtype if that is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _project_sq(rows: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``(rows @ basis)^2`` in f32 (f64 for f64 rows), the basis rounded
    to the rows' dtype."""
    return (_wide(rows) @ _wide(basis.to(rows.dtype))) ** 2


def ekfac_scale_contrib(
    a_rows: torch.Tensor,
    g_rows: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    a_norm: float = 1.0,
    g_norm: float = 1.0,
) -> torch.Tensor:
    """One batch's scale statistic ``[kg, ka]`` in a basis.

    ``a_rows [R, a_dim]`` and ``g_rows [R, g_dim]`` are row-aligned (the
    same example or position in each row); ``qa [a_dim, ka]`` and
    ``qg [g_dim, kg]`` the eigenvectors (a padded bucket's basis sliced
    to the layer's rows: zero-padding the rows and slicing the basis are
    the same contraction); ``a_norm``/``g_norm`` the rows' norms.
    Returns ``mean_rows outer((g̃^T qg)^2, (ã^T qa)^2)`` over
    normalized rows ``ã = a / a_norm``, ``g̃ = g / g_norm`` (f64 for f64
    rows).
    """
    if a_rows.shape[0] != g_rows.shape[0]:
        raise ValueError(
            'EKFAC rows must be aligned: got '
            f'{a_rows.shape[0]} A rows vs {g_rows.shape[0]} G rows',
        )
    pa = _project_sq(a_rows, qa)
    pg = _project_sq(g_rows, qg)
    scale = float(a_rows.shape[0]) * float(a_norm) ** 2 * float(g_norm) ** 2
    return pg.mT @ (pa / scale)


def ekfac_scale_contrib_stacked(
    a_rows: torch.Tensor,
    g_rows: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    count: float | int,
) -> torch.Tensor:
    """The lead-dim-batched statistic ``[L, kg, ka]`` of ``[L, R, d]``
    rows (masked rows zeroed) and ``[L, d, k]`` bases, each slice
    divided by ``count``, the valid-row count (the factor covariance's
    denominator)."""
    if a_rows.shape[:2] != g_rows.shape[:2]:
        raise ValueError(
            'EKFAC stacked rows must be aligned: got '
            f'{tuple(a_rows.shape[:2])} A rows vs '
            f'{tuple(g_rows.shape[:2])} G rows',
        )
    pa = _project_sq(a_rows, qa)
    pg = _project_sq(g_rows, qg)
    return pg.mT @ (pa / float(count))


def ekfac_divergence(
    entries: Sequence[tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
) -> torch.Tensor:
    """Relative Frobenius drift of the scales from their refresh seed:
    ``sqrt(sum ||S - dg ⊗ da||^2 / sum ||dg ⊗ da||^2)`` over per-layer
    ``(skron, da, dg)`` triples of full logical dims (any leading stack
    dims).  The bucketed stage has its own masked form
    (``BucketedSecondOrder.ekfac_divergence``)."""
    num = torch.zeros((), dtype=torch.float32)
    den = torch.zeros((), dtype=torch.float32)
    for skron, da, dg in entries:
        seed = dg.float()[..., :, None] * da.float()[..., None, :]
        drift = skron.float() - seed
        num = num.to(seed.device) + torch.sum(drift * drift)
        den = den.to(seed.device) + torch.sum(seed * seed)
    return torch.sqrt(num / (den + 1e-30))


def ekfac_divergence_info(states: Mapping) -> dict:
    """``{'ekfac_divergence': ...}`` of per-layer states that carry
    ``skron``, ``da`` and ``dg`` together."""
    return {'ekfac_divergence': ekfac_divergence([
        (st.skron, st.da, st.dg)
        for st in states.values()
        if getattr(st, 'skron', None) is not None
        and getattr(st, 'da', None) is not None
        and getattr(st, 'dg', None) is not None
    ])}
