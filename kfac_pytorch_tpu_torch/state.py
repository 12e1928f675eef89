"""K-FAC preconditioner state.

Port of ``kfac_pytorch_tpu/state.py:19-131``, with ``AccumState``
(``state.py:55``), with the EKFAC scale sums (``state.py:69``).  The
JAX package threads
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


@dataclasses.dataclass
class AccumState:
    """Micro-batch accumulation sums of one layer (``accumulation_steps
    > 1``; JAX ``AccumState``, ``kfac_pytorch_tpu/state.py:55``).

    ``a_batch``/``g_batch`` sum the per-micro-batch factor contributions
    (``None`` until the first fold); ``a_count``/``g_count`` count them,
    and the step divides each sum by its own count.  ``rows`` sums the
    micro-batches' activation rows, for the equal-local-batch check
    across ranks.  Under EKFAC ``s_batch`` sums the micro-batches'
    ``[g_pad, a_pad]`` scale contributions, each projected in the basis
    current at its fold, and ``s_count`` counts them.
    """

    a_batch: torch.Tensor | None = None
    g_batch: torch.Tensor | None = None
    a_count: int = 0
    g_count: int = 0
    rows: int = 0
    s_batch: torch.Tensor | None = None
    s_count: int = 0

    def add(self, a: torch.Tensor, g: torch.Tensor, rows: int,
            s: torch.Tensor | None = None) -> None:
        """Fold one micro-batch's contributions in (in place after the
        first); ``s`` is its EKFAC scale contribution, if any."""
        if self.a_batch is None:
            self.a_batch, self.g_batch = a, g
        else:
            self.a_batch.add_(a)
            self.g_batch.add_(g)
        self.a_count += 1
        self.g_count += 1
        self.rows += rows
        if s is not None:
            if self.s_batch is None:
                self.s_batch = s
            else:
                self.s_batch.add_(s)
            self.s_count += 1
