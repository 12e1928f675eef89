"""K-FAC preconditioner state.

Port of ``kfac_pytorch_tpu/state.py:19-54`` with the eigen fields only.
The JAX package threads immutable pytrees through jitted steps; here the
preconditioner owns its state and updates it between steps.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LayerKFACState:
    """Device state for one K-FAC layer.

    ``a_factor``/``g_factor`` are the EMA Kronecker factors, the only
    persistent state.  The eigen fields (``qa``/``qg`` eigenvectors,
    ``da``/``dg`` clamped eigenvalues or ``dgda`` the predivided outer
    product) are ``None`` when the decompositions live in stacked
    bucket state instead (the bucketed engine, the only one ported).
    """

    a_factor: torch.Tensor
    g_factor: torch.Tensor
    qa: torch.Tensor | None = None
    da: torch.Tensor | None = None
    qg: torch.Tensor | None = None
    dg: torch.Tensor | None = None
    dgda: torch.Tensor | None = None


def init_layer_state(
    a_dim: int,
    g_dim: int,
    *,
    factor_dtype: torch.dtype = torch.float32,
    device: torch.device | str = 'cpu',
) -> LayerKFACState:
    """Zeroed factors-only layer state."""
    return LayerKFACState(
        a_factor=torch.zeros((a_dim, a_dim), dtype=factor_dtype,
                             device=device),
        g_factor=torch.zeros((g_dim, g_dim), dtype=factor_dtype,
                             device=device),
    )
