"""K-FAC preconditioner state.

Port of ``kfac_pytorch_tpu/state.py:19-131``.  The JAX package threads
immutable pytrees through jitted steps; here the preconditioner owns its
state and updates it between steps.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LayerKFACState:
    """Device state for one K-FAC layer.

    ``a_factor``/``g_factor`` are the EMA Kronecker factors, the only
    persistent state.  A layer in the bucket stacks keeps its
    decompositions there, and every other field is ``None``.  A layer
    with a diagonal A factor (an embedding: ``a_factor`` is ``[V]``)
    sits outside the stacks and keeps its own: eigen ``qg``/``dg`` and
    ``da``, the ``[V]`` diagonal snapshotted at refresh; inverse (and
    iterative) ``g_inv`` and ``a_inv``, the refresh-time ``[V]``
    reciprocal ``1 / (a + damping)``.
    """

    a_factor: torch.Tensor
    g_factor: torch.Tensor
    qa: torch.Tensor | None = None
    da: torch.Tensor | None = None
    qg: torch.Tensor | None = None
    dg: torch.Tensor | None = None
    dgda: torch.Tensor | None = None
    a_inv: torch.Tensor | None = None
    g_inv: torch.Tensor | None = None

    def decompositions(self) -> dict[str, torch.Tensor]:
        """The decomposition fields that are set."""
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
            if f.name not in ('a_factor', 'g_factor')
            and getattr(self, f.name) is not None
        }


def init_layer_state(
    a_dim: int,
    g_dim: int,
    *,
    factor_dtype: torch.dtype = torch.float32,
    device: torch.device | str = 'cpu',
    diag_a: bool = False,
) -> LayerKFACState:
    """Zeroed factors-only layer state; ``diag_a`` keeps the A factor as
    its ``[a_dim]`` diagonal."""
    return LayerKFACState(
        a_factor=torch.zeros((a_dim,) if diag_a else (a_dim, a_dim),
                             dtype=factor_dtype, device=device),
        g_factor=torch.zeros((g_dim, g_dim), dtype=factor_dtype,
                             device=device),
    )
