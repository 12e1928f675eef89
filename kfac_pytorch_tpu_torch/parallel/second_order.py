"""The bucketed second-order stage, on one device or across ranks.

Port of ``BucketedSecondOrder`` (``kfac_pytorch_tpu/parallel/
second_order.py``) for the eigen method with predivided eigenvalues,
over the KAISA grid of :mod:`~kfac_pytorch_tpu_torch.parallel.mesh`.
Each rank holds only its grid column's ``seg`` slots of every bucket;
the four phases of the JAX module run as explicit collectives
(:mod:`~kfac_pytorch_tpu_torch.parallel.collectives`):

1. **decompose** (:meth:`BucketedSecondOrder.compute`): the ``rows``
   ranks of a column split the column's slots; each stacks its share's
   factor EMAs, padded with identity blocks, runs one batched ``eigh``
   per side, clamps the eigenvalues at zero and predivides
   ``dgda = 1 / (dg ⊗ da + damping)``;
2. **gather the decompositions** over the column (none when
   ``rows == 1``, MEM-OPT);
3. **precondition** (:meth:`BucketedSecondOrder.precondition`): each
   rank rotates its column's gradient slots through
   :func:`~kfac_pytorch_tpu_torch.ops.fused_eigen_precondition_sharded`
   — the CUDA kernel on CUDA tensors, its plain version on CPU tensors;
4. **gather the gradients** and clip terms over the row (none when
   ``cols == 1``, COMM-OPT), then one global kl-clip scale whose terms
   are summed in plan order, so every rank computes the same bits.

On one device the grid is ``1 x 1`` and no collective runs.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.parallel import collectives
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketLayout
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketPlan
from kfac_pytorch_tpu_torch.parallel.mesh import KaisaGrid
from kfac_pytorch_tpu_torch.state import LayerKFACState


@dataclasses.dataclass
class BucketSecond:
    """Stacked second-order state for one bucket's slots on this rank
    (its grid column's ``seg`` slots; all ``L`` on one device).

    ``qa [seg, a, a]`` / ``qg [seg, g, g]`` eigenvector stacks and
    ``dgda [seg, g, a]`` the predivided eigenvalue outer product.
    """

    qa: torch.Tensor
    qg: torch.Tensor
    dgda: torch.Tensor


def _pad_factor(factor: torch.Tensor, pad: int) -> torch.Tensor:
    """Embed a factor in the top-left of a ``pad x pad`` identity."""
    d = factor.shape[-1]
    if d == pad:
        return factor
    out = torch.eye(pad, dtype=factor.dtype, device=factor.device)
    out[:d, :d] = factor
    return out


def _pad_grad(grad: torch.Tensor, g_pad: int, a_pad: int) -> torch.Tensor:
    """Zero-pad a combined ``[out, in(+1)]`` gradient to bucket shape."""
    go, ga = grad.shape
    if go == g_pad and ga == a_pad:
        return grad
    return torch.nn.functional.pad(grad, (0, a_pad - ga, 0, g_pad - go))


class BucketedSecondOrder:
    """Runs the bucketed second-order stage over a bucket plan.

    Args:
        plan: bucket/slot layout from :func:`make_bucket_plan`.
        inv_dtype: dtype of the decompositions.
        precond_dtype: operand dtype of the rotation chain (f32 or bf16;
            the chain accumulates in f32 either way).
        device: where the stacks live.
        grid: this rank's place on the KAISA grid (default: one device);
            ``grid.cols`` must equal ``plan.n_cols``.
    """

    def __init__(
        self,
        plan: BucketPlan,
        *,
        inv_dtype: torch.dtype = torch.float32,
        precond_dtype: torch.dtype = torch.float32,
        device: torch.device | str = 'cpu',
        grid: KaisaGrid | None = None,
    ) -> None:
        grid = KaisaGrid(rows=1, cols=1, rank=0) if grid is None else grid
        if grid.cols != plan.n_cols:
            raise ValueError(
                f'the plan has {plan.n_cols} column(s) but the grid '
                f'{grid.rows}x{grid.cols}',
            )
        self.plan = plan
        self.grid = grid
        self.inv_dtype = inv_dtype
        self.precond_dtype = precond_dtype
        self.device = torch.device(device)

    def local_slots(self, b: BucketLayout) -> tuple[str | None, ...]:
        """The slots of bucket ``b`` this rank holds: its column's."""
        return b.column_slots(self.grid.col)

    def _zero_stacks(self, b: BucketLayout, n: int) -> tuple:
        """``n`` zero slots of bucket ``b``'s ``(qa, qg, dgda)`` stacks."""
        a, g = b.a_pad, b.g_pad
        return tuple(
            torch.zeros(shape, dtype=self.inv_dtype, device=self.device)
            for shape in ((n, a, a), (n, g, g), (n, g, a))
        )

    def init_buckets(self) -> dict[str, BucketSecond]:
        """Zeroed stacked second-order state (this rank's slots)."""
        return {
            b.key: BucketSecond(*self._zero_stacks(b, b.seg))
            for b in self.plan.buckets
        }

    def _stack_bucket_factors(
        self,
        b: BucketLayout,
        slots: tuple[str | None, ...],
        layers: Mapping[str, LayerKFACState],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Padded ``(A, G)`` f32 factor stacks of ``slots`` of bucket
        ``b``; padding slots and padded dims get identity blocks (a
        well-conditioned ``eigh`` input that never reaches an unpadded
        result)."""
        a_list, g_list = [], []
        for name in slots:
            if name is None:
                a_list.append(torch.eye(b.a_pad, device=self.device))
                g_list.append(torch.eye(b.g_pad, device=self.device))
            else:
                st = layers[name]
                a_list.append(_pad_factor(st.a_factor.float(), b.a_pad))
                g_list.append(_pad_factor(st.g_factor.float(), b.g_pad))
        return torch.stack(a_list), torch.stack(g_list)

    def compute(
        self,
        layers: Mapping[str, LayerKFACState],
        damping: float,
    ) -> dict[str, BucketSecond]:
        """Recompute this rank's decompositions (inverse-update step):
        phase 1 on this rank's share of its column, phase 2 over the
        column."""
        grid = self.grid
        shares = []
        for b in self.plan.buckets:
            start, stop = collectives.share_bounds(b.seg, grid.rows, grid.row)
            mine = self.local_slots(b)[start:stop]
            if not mine:  # a short column: this rank's share is empty
                shares.append(self._zero_stacks(b, 0))
                continue
            A, G = self._stack_bucket_factors(b, mine, layers)
            qa, da = ops.compute_factor_eigen(A, self.inv_dtype)
            qg, dg = ops.compute_factor_eigen(G, self.inv_dtype)
            shares.append((qa, qg, ops.compute_dgda(dg, da, damping)))
        shares = collectives.all_gather_decompositions(
            shares, [b.seg for b in self.plan.buckets], grid.col_group,
        )
        return {
            b.key: BucketSecond(qa=qa, qg=qg, dgda=dgda)
            for b, (qa, qg, dgda) in zip(self.plan.buckets, shares)
        }

    def _rotate_bucket(
        self,
        b: BucketLayout,
        bs: BucketSecond,
        combined_grads: Mapping[str, torch.Tensor],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One bucket's phases 3 and 4: ``(pg [L, g, a] f32, <pg, g>)``
        over all ``L`` slots.

        The kl-clip term comes from the kernel's per-slot sums in the
        eigenbasis, gathered with ``pg`` and summed over the full stack
        in slot order; padded regions are zero in ``g``, so it equals
        the sum of the unpadded per-layer inner products.
        """
        g_list = []
        for name in self.local_slots(b):
            if name is None:
                g_list.append(torch.zeros(
                    (b.g_pad, b.a_pad), dtype=torch.float32,
                    device=self.device,
                ))
            else:
                g_list.append(_pad_grad(
                    combined_grads[name].float(), b.g_pad, b.a_pad,
                ))
        args = [
            t.to(self.precond_dtype).contiguous()
            for t in (torch.stack(g_list), bs.qa, bs.qg, bs.dgda)
        ]
        pg, clips = ops.fused_eigen_precondition_sharded(
            *args, group=self.grid.row_group,
        )
        return pg, torch.sum(clips)

    def precondition(
        self,
        buckets: Mapping[str, BucketSecond],
        combined_grads: Mapping[str, torch.Tensor],
        kl_clip: float | None,
        lr: float,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor | None]:
        """Precondition all layers' combined gradients at once.

        Returns ``(preconditioned grads by layer, kl-clip scale or
        None)``; the returned grads already carry the scale.  Every rank
        returns every layer.  Scaling after the row gather gives the
        same bits as scaling before it.
        """
        stacked = {}
        terms = []
        for b in self.plan.buckets:
            pg, term = self._rotate_bucket(b, buckets[b.key], combined_grads)
            stacked[b.key] = pg
            terms.append(term * float(lr) ** 2)
        scale = (
            ops.kl_clip_scale(terms, kl_clip) if kl_clip is not None
            else None
        )
        out = {}
        for b in self.plan.buckets:
            pg = stacked[b.key]
            if scale is not None:
                pg = pg * scale
            for i, name in enumerate(b.slots):
                if name is None:
                    continue
                go, ga = combined_grads[name].shape
                out[name] = pg[i, :go, :ga].to(combined_grads[name].dtype)
        return out, scale

    def memory_usage(self, buckets: Mapping[str, BucketSecond]) -> int:
        """Bytes of stacked second-order state on this rank."""
        return sum(
            t.numel() * t.element_size()
            for bs in buckets.values()
            for t in (bs.qa, bs.qg, bs.dgda)
        )
