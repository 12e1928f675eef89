"""The bucketed second-order stage on one device.

Port of ``BucketedSecondOrder`` (``kfac_pytorch_tpu/parallel/
second_order.py``) for the eigen method with predivided eigenvalues:

* :meth:`BucketedSecondOrder.compute` stacks each bucket's factor EMAs,
  padded with identity blocks (``:656-716``), runs one batched ``eigh``
  per side, clamps the eigenvalues at zero and predivides
  ``dgda = 1 / (dg ⊗ da + damping)`` (``:729-930``);
* :meth:`BucketedSecondOrder.precondition` rotates every bucket's
  gradient stack through :func:`~kfac_pytorch_tpu_torch.ops.
  fused_eigen_precondition` — the CUDA kernel on CUDA tensors, its plain
  version on CPU tensors — and applies one global kl-clip scale whose
  terms are summed in plan order (``:1479-1766``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketLayout
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketPlan
from kfac_pytorch_tpu_torch.state import LayerKFACState


@dataclasses.dataclass
class BucketSecond:
    """Stacked second-order state for one bucket.

    ``qa [L, a, a]`` / ``qg [L, g, g]`` eigenvector stacks and ``dgda
    [L, g, a]`` the predivided eigenvalue outer product.
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
    """

    def __init__(
        self,
        plan: BucketPlan,
        *,
        inv_dtype: torch.dtype = torch.float32,
        precond_dtype: torch.dtype = torch.float32,
        device: torch.device | str = 'cpu',
    ) -> None:
        self.plan = plan
        self.inv_dtype = inv_dtype
        self.precond_dtype = precond_dtype
        self.device = torch.device(device)

    def init_buckets(self) -> dict[str, BucketSecond]:
        """Zeroed stacked second-order state."""
        out = {}
        for b in self.plan.buckets:
            L, a, g = b.n_slots, b.a_pad, b.g_pad

            def zeros(*shape):
                return torch.zeros(
                    shape, dtype=self.inv_dtype, device=self.device,
                )

            out[b.key] = BucketSecond(
                qa=zeros(L, a, a), qg=zeros(L, g, g), dgda=zeros(L, g, a),
            )
        return out

    def _stack_bucket_factors(
        self,
        b: BucketLayout,
        layers: Mapping[str, LayerKFACState],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Padded ``(A, G)`` f32 factor stacks of one bucket; padding
        slots and padded dims get identity blocks (a well-conditioned
        ``eigh`` input that never reaches an unpadded result)."""
        a_list, g_list = [], []
        for name in b.slots:
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
        """Recompute every bucket's decompositions (inverse-update step)."""
        out = {}
        for b in self.plan.buckets:
            A, G = self._stack_bucket_factors(b, layers)
            qa, da = ops.compute_factor_eigen(A, self.inv_dtype)
            qg, dg = ops.compute_factor_eigen(G, self.inv_dtype)
            out[b.key] = BucketSecond(
                qa=qa, qg=qg, dgda=ops.compute_dgda(dg, da, damping),
            )
        return out

    def _rotate_bucket(
        self,
        b: BucketLayout,
        bs: BucketSecond,
        combined_grads: Mapping[str, torch.Tensor],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One bucket's rotation chain: ``(pg [L, g, a] f32, <pg, g>)``.

        The kl-clip term comes from the kernel's per-slot sums in the
        eigenbasis; padded regions are zero in ``g``, so it equals the
        sum of the unpadded per-layer inner products.
        """
        g_list = []
        for name in b.slots:
            if name is None:
                g_list.append(torch.zeros(
                    (b.g_pad, b.a_pad), dtype=torch.float32,
                    device=self.device,
                ))
            else:
                g_list.append(_pad_grad(
                    combined_grads[name].float(), b.g_pad, b.a_pad,
                ))
        pdt = self.precond_dtype
        g = torch.stack(g_list).to(pdt)
        pg, clips = ops.fused_eigen_precondition(
            g.contiguous(),
            bs.qa.to(pdt).contiguous(),
            bs.qg.to(pdt).contiguous(),
            bs.dgda.to(pdt).contiguous(),
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
        None)``; the returned grads already carry the scale.
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
