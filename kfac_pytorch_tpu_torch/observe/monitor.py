"""Curvature and step statistics on the device: no extra decompositions,
no host reads.

Port of ``kfac_pytorch_tpu/observe/monitor.py`` as torch functions on
tensors.  With ``ObserveConfig(monitor=True)`` the engine computes these
on every step, from tensors the step already holds, and leaves them as
device tensors under ``last_step_info['observe/*']`` (one host read per
value read, at the caller's logging cadence, as for the ``health/*``
counters):

* gradient / preconditioned-gradient norms from the step's gradients;
* the kl-clip scale ``nu`` from the clip reduction the preconditioner
  already performs (on the fused path, the sum of the kernel's per-slot
  ``clip[l]`` terms);
* eigenvalue extremes and the damping-to-spectrum ratio from the
  decomposition stacks (``da``/``dg``, or inverted out of the prediv
  ``dgda = 1/(dg ⊗ da + damping)`` grid — never a fresh ``eigh``).
  Explicit-inverse slots carry no spectrum; Newton–Schulz (iterative)
  slots surface their convergence evidence instead under
  ``observe/iter_*`` (:func:`iterative_stack_stats`).

Nothing here calls ``.item()``, ``eigh`` or a collective.  With the
monitor off none of this runs and the step is the unobserved one, bit for
bit.
"""
from __future__ import annotations

from typing import Any, Iterable, Sequence

import torch

__all__ = [
    'eigen_masks',
    'eigen_stack_stats',
    'grad_stats',
    'iterative_stack_stats',
    'kl_nu_stat',
    'masked_extremes',
    'merge_extremes',
    'prediv_mask',
    'prediv_stack_stats',
    'support_mask',
    'tree_norm',
]


def tree_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """f32 global L2 norm of a sequence of tensors: the square root of the
    sum of their squared f32 norms, the norms from one
    ``torch._foreach_norm`` (a few launches, not one per tensor)."""
    leaves = [t if t.dtype == torch.float32 else t.float() for t in tensors]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = torch.stack(torch._foreach_norm(leaves))
    return torch.sqrt(torch.sum(norms * norms))


def grad_stats(
    raw_grads: Sequence[torch.Tensor], precond_grads: Sequence[torch.Tensor],
) -> dict[str, torch.Tensor]:
    """Norms of the raw and preconditioned gradients."""
    return {
        'observe/grad_norm': tree_norm(raw_grads),
        'observe/precond_grad_norm': tree_norm(precond_grads),
    }


def masked_extremes(
    values: torch.Tensor, mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of ``values`` over ``mask`` (f32; inf/-inf if empty)."""
    v = values.float()
    inf = torch.full((), float('inf'), dtype=torch.float32, device=v.device)
    lo = torch.min(torch.where(mask, v, inf)) if v.numel() else inf
    hi = torch.max(torch.where(mask, v, -inf)) if v.numel() else -inf
    return lo, hi


def support_mask(q: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """Which eigenpairs of a padded stack belong to the real factor.

    ``q [L, n, k]`` are eigenvector stacks of identity- (or zero-) padded
    factors and ``dims [L]`` the logical (unpadded) dims.  The pad block
    is block-diagonal, so pad eigenvectors carry all their mass on rows
    ``>= dims`` and real eigenvectors none; ``eigh`` sorts the pad's
    eigenvalue-1 entries into the middle of the spectrum, so masking by
    position is wrong and masking by support is exact: the mass of each
    eigenvector on the logical rows, thresholded at 1/2.
    """
    n = q.shape[-2]
    logical = (
        torch.arange(n, device=q.device)[None, :, None]
        < dims.to(q.device)[:, None, None]
    ).float()
    mass = torch.sum(torch.square(q.float()) * logical, dim=-2)
    return mass > 0.5  # [L, k]


def eigen_masks(
    qa: torch.Tensor,
    qg: torch.Tensor,
    a_dims: torch.Tensor,
    g_dims: torch.Tensor,
    occupied: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(a_mask [L, ka], g_mask [L, kg])``: the eigenpairs of occupied
    slots that belong to the real factors (:func:`support_mask`)."""
    occ = occupied[:, None]
    return (support_mask(qa, a_dims) & occ, support_mask(qg, g_dims) & occ)


def prediv_mask(
    qa: torch.Tensor,
    qg: torch.Tensor,
    a_dims: torch.Tensor,
    g_dims: torch.Tensor,
    occupied: torch.Tensor,
) -> torch.Tensor:
    """``[L, kg, ka]``: the entries of a prediv grid whose both
    eigenpairs belong to the real factors, in occupied slots."""
    return (
        support_mask(qg, g_dims)[:, :, None]
        & support_mask(qa, a_dims)[:, None, :]
        & occupied[:, None, None]
    )


def eigen_stack_stats(
    da: torch.Tensor,
    dg: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    a_dims: torch.Tensor,
    g_dims: torch.Tensor,
    occupied: torch.Tensor,
    *,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """Spectrum extremes of one bucket's eigenvalue stacks.

    ``da [L, ka]`` / ``dg [L, kg]`` are the per-slot factor spectra with
    ``qa``/``qg`` their eigenvector stacks; ``a_dims``/``g_dims`` the
    logical dims per slot and ``occupied`` the slot-occupancy mask.  Pad
    eigenpairs are excluded via :func:`support_mask`; ``masks`` passes
    :func:`eigen_masks` of the same stacks, computed once per refresh by
    a caller that keeps them.
    """
    if masks is None:
        masks = eigen_masks(qa, qg, a_dims, g_dims, occupied)
    a_mask, g_mask = masks
    a_lo, a_hi = masked_extremes(da, a_mask)
    g_lo, g_hi = masked_extremes(dg, g_mask)
    return {
        'eig_a_min': a_lo, 'eig_a_max': a_hi,
        'eig_g_min': g_lo, 'eig_g_max': g_hi,
        # The eigenvalues of A ⊗ G are the products da_i * dg_j, so the
        # extremes are the products of extremes (the spectra are clamped
        # at zero at decomposition time).
        'kron_min': a_lo * g_lo,
        'kron_max': a_hi * g_hi,
    }


def prediv_stack_stats(
    dgda: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    a_dims: torch.Tensor,
    g_dims: torch.Tensor,
    occupied: torch.Tensor,
    bake_damping: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Kronecker-spectrum extremes recovered from a prediv grid.

    ``dgda = 1 / (dg ⊗ da + bake_damping)`` elementwise, so the grid
    inverts back to the spectrum without a decomposition.  The inversion
    uses ``bake_damping``, the per-slot damping of each slot's last
    refresh, not the current step's: under a damping schedule or
    :class:`~kfac_pytorch_tpu_torch.adaptive.AdaptiveDamping` the two
    differ between refreshes.  Pad eigendirections are excluded per side
    via :func:`support_mask` (grid axis ``j``/``k`` indexes the
    ``qg``/``qa`` eigenpairs); ``mask`` passes :func:`prediv_mask` of the
    same stacks, computed once per refresh by a caller that keeps it.
    """
    if mask is None:
        mask = prediv_mask(qa, qg, a_dims, g_dims, occupied)
    kron = 1.0 / dgda.float() - bake_damping.float()[:, None, None]
    lo, hi = masked_extremes(kron, mask)
    return {
        'kron_min': torch.clamp(lo, min=0.0),
        'kron_max': hi,
    }


def iterative_stack_stats(
    res_a: torch.Tensor,
    res_g: torch.Tensor,
    bound_a: torch.Tensor,
    bound_g: torch.Tensor,
    stale_a: torch.Tensor,
    stale_g: torch.Tensor,
    occupied: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """Newton–Schulz convergence evidence of one iterative bucket, from
    the per-slot fields the refresh keeps (``iter_*``), pad slots masked
    out: the worst final residual (``iter_res_max``), the worst count of
    iterations still above tolerance (``iter_stale_max``) and the
    extremes of the spectral-norm bound of the cold normalization
    (``iter_bound_max``/``iter_bound_min``)."""
    res = torch.maximum(res_a.float(), res_g.float())
    stale = torch.maximum(stale_a, stale_g).float()
    b_lo_a, b_hi_a = masked_extremes(bound_a, occupied)
    b_lo_g, b_hi_g = masked_extremes(bound_g, occupied)
    _, res_hi = masked_extremes(res, occupied)
    _, stale_hi = masked_extremes(stale, occupied)
    return {
        'iter_res_max': res_hi,
        'iter_stale_max': stale_hi,
        'iter_bound_max': torch.maximum(b_hi_a, b_hi_g),
        'iter_bound_min': torch.minimum(b_lo_a, b_lo_g),
    }


def merge_extremes(
    per_bucket: list[dict[str, torch.Tensor]], damping: Any,
) -> dict[str, torch.Tensor]:
    """Reduce per-bucket stats to the global ``observe/*`` scalars (keys
    ending in ``_min`` by min, the rest by max), and add
    ``observe/damping_to_spectrum`` = ``damping / kron_max``: below 1 the
    damped solve is curvature-dominated, above it damping-dominated."""
    if not per_bucket:
        return {}
    keys = set(per_bucket[0])
    for stats in per_bucket[1:]:
        keys &= set(stats)
    out: dict[str, torch.Tensor] = {}
    for key in sorted(keys):
        stack = torch.stack([stats[key] for stats in per_bucket])
        out[f'observe/{key}'] = (
            torch.min(stack) if key.endswith('_min') else torch.max(stack)
        )
    if 'observe/kron_max' in out:
        # The damping filled on the device (no host copy), rounded to f32
        # as JAX's jnp.asarray(damping, f32) is, then an f32 division.
        kron_max = out['observe/kron_max']
        out['observe/damping_to_spectrum'] = (
            torch.full_like(kron_max, float(damping))
            / torch.clamp(kron_max, min=1e-30)
        )
    return out


def kl_nu_stat(scale: torch.Tensor | None) -> dict[str, torch.Tensor]:
    """The kl-clip scale applied this step (1.0 = no clip)."""
    nu = (
        torch.ones((), dtype=torch.float32) if scale is None
        else torch.as_tensor(scale).float()
    )
    return {'observe/kl_nu': nu}
