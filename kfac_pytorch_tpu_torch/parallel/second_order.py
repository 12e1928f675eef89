"""The bucketed second-order stage, on one device or across ranks.

Port of ``BucketedSecondOrder`` (``kfac_pytorch_tpu/parallel/
second_order.py``) over the KAISA grid of
:mod:`~kfac_pytorch_tpu_torch.parallel.mesh`, for three compute methods:
eigen (with the eigenvalue outer product predivided, or with the
clamped eigenvalues kept), inverse (damped Cholesky inverses) and
iterative (the same inverses by warm-started Newton–Schulz).  Each rank
holds only its grid column's ``seg`` slots of every bucket; the four
phases of the JAX module run as explicit collectives
(:mod:`~kfac_pytorch_tpu_torch.parallel.collectives`):

1. **decompose** (:meth:`BucketedSecondOrder.compute`): the ``rows``
   ranks of a column split the column's slots; each stacks its share's
   factor EMAs, padded with identity blocks, and runs the method's
   batched refresh (``second_order.py:808-899``);
2. **gather the decompositions** over the column (none when
   ``rows == 1``, MEM-OPT), whatever fields the method keeps;
3. **precondition** (:meth:`BucketedSecondOrder.precondition`): each
   rank rotates its column's gradient slots (``second_order.py:
   1683-1766``).  Prediv eigen runs
   :func:`~kfac_pytorch_tpu_torch.ops.fused_eigen_precondition_sharded`
   — the CUDA kernel on CUDA tensors, its plain version on CPU tensors.
   The other methods run matmul chains, as the JAX package runs them
   outside its Pallas kernel (its gate answers ``'no_prediv'``);
4. **gather the gradients** and per-slot clip terms over the row (none
   when ``cols == 1``, COMM-OPT), then one global kl-clip scale whose
   terms are summed in plan order, so every rank computes the same bits.

On one device the grid is ``1 x 1`` and no collective runs.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.enums import ComputeMethod
from kfac_pytorch_tpu_torch.parallel import collectives
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketLayout
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketPlan
from kfac_pytorch_tpu_torch.parallel.mesh import KaisaGrid
from kfac_pytorch_tpu_torch.scheduler import iterative_refresh_iters
from kfac_pytorch_tpu_torch.state import LayerKFACState

#: Fields padded with identity blocks when a column's share is gathered
#: (square stacks); every other field pads with zeros.
IDENTITY_PADDED = frozenset({'qa', 'qg', 'a_inv', 'g_inv'})


@dataclasses.dataclass
class BucketSecond:
    """Stacked second-order state for one bucket's slots on this rank
    (its grid column's ``seg`` slots; all ``L`` on one device).

    Eigen: ``qa [seg, a, a]`` / ``qg [seg, g, g]`` eigenvectors, and
    either ``dgda [seg, g, a]`` the predivided eigenvalue outer product
    with ``bake_damping [seg]`` the damping baked into it, or ``da
    [seg, a]`` / ``dg [seg, g]`` the clamped eigenvalues.  Inverse and
    iterative: ``a_inv [seg, a, a]`` / ``g_inv [seg, g, g]``.  Iterative
    also: per slot the final residual ``||M - I||_F``, the spectral-norm
    bound of the cold normalization and the iterations still above
    tolerance (``iter_*_a``/``iter_*_g``, ``[seg]``); the roots are the
    next refresh's warm seeds.  Fields a method does not use are
    ``None``.
    """

    qa: torch.Tensor | None = None
    qg: torch.Tensor | None = None
    da: torch.Tensor | None = None
    dg: torch.Tensor | None = None
    dgda: torch.Tensor | None = None
    bake_damping: torch.Tensor | None = None
    a_inv: torch.Tensor | None = None
    g_inv: torch.Tensor | None = None
    iter_res_a: torch.Tensor | None = None
    iter_res_g: torch.Tensor | None = None
    iter_bound_a: torch.Tensor | None = None
    iter_bound_g: torch.Tensor | None = None
    iter_stale_a: torch.Tensor | None = None
    iter_stale_g: torch.Tensor | None = None

    def tensors(self) -> dict[str, torch.Tensor]:
        """The fields that are set, in declaration order."""
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }


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
        compute_method: eigen, inverse or iterative.
        prediv_eigenvalues: eigen only: predivide
            ``dgda = 1 / (dg ⊗ da + damping)`` at refresh time (and run
            the fused kernel), or keep ``da``/``dg`` and divide by the
            live damping at every step.
        iterative_config: the Newton–Schulz knobs (iterative only;
            default ``IterativeConfig()``).
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
        compute_method: ComputeMethod = ComputeMethod.EIGEN,
        prediv_eigenvalues: bool = True,
        iterative_config: ops.IterativeConfig | None = None,
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
        if compute_method == ComputeMethod.ITERATIVE:
            if iterative_config is None:
                iterative_config = ops.IterativeConfig()
        else:
            iterative_config = None
        self.plan = plan
        self.grid = grid
        self.compute_method = compute_method
        self.prediv = (
            prediv_eigenvalues and compute_method == ComputeMethod.EIGEN
        )
        self.iterative = iterative_config
        self.inv_dtype = inv_dtype
        self.precond_dtype = precond_dtype
        self.device = torch.device(device)

    def local_slots(self, b: BucketLayout) -> tuple[str | None, ...]:
        """The slots of bucket ``b`` this rank holds: its column's."""
        return b.column_slots(self.grid.col)

    def _zero_fields(self, b: BucketLayout, n: int) -> dict[str, torch.Tensor]:
        """``n`` slots of bucket ``b``'s state, in the method's fields:
        zero stacks, with the iterative residuals at ``+inf`` (a zero
        would read as converged before any refresh ran)."""
        a, g = b.a_pad, b.g_pad

        def zeros(*shape, dtype=self.inv_dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if self.compute_method == ComputeMethod.EIGEN:
            out = dict(qa=zeros(n, a, a), qg=zeros(n, g, g))
            if self.prediv:
                out.update(dgda=zeros(n, g, a),
                           bake_damping=zeros(n, dtype=torch.float32))
            else:
                out.update(da=zeros(n, a), dg=zeros(n, g))
            return out
        out = dict(a_inv=zeros(n, a, a), g_inv=zeros(n, g, g))
        if self.compute_method == ComputeMethod.ITERATIVE:
            for side in ('a', 'g'):
                out[f'iter_res_{side}'] = torch.full(
                    (n,), float('inf'), device=self.device,
                )
                out[f'iter_bound_{side}'] = zeros(n, dtype=torch.float32)
                out[f'iter_stale_{side}'] = zeros(n, dtype=torch.int32)
        return out

    def init_buckets(self) -> dict[str, BucketSecond]:
        """Zeroed stacked second-order state (this rank's slots)."""
        return {
            b.key: BucketSecond(**self._zero_fields(b, b.seg))
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
        well-conditioned input that never reaches an unpadded result)."""
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

    def _decompose(
        self,
        A: torch.Tensor,
        G: torch.Tensor,
        damping: float,
        warm: tuple[torch.Tensor, torch.Tensor] | None,
        iters: int,
    ) -> dict[str, torch.Tensor]:
        """Phase 1 of one bucket share: the method's fields."""
        if self.compute_method == ComputeMethod.EIGEN:
            qa, da = ops.compute_factor_eigen(A, self.inv_dtype)
            qg, dg = ops.compute_factor_eigen(G, self.inv_dtype)
            if not self.prediv:
                return dict(qa=qa, qg=qg, da=da, dg=dg)
            return dict(
                qa=qa, qg=qg, dgda=ops.compute_dgda(dg, da, damping),
                bake_damping=torch.full(
                    (A.shape[0],), damping, device=A.device,
                ),
            )
        if self.compute_method == ComputeMethod.INVERSE:
            return dict(
                a_inv=ops.batched_damped_inv(A, damping).to(self.inv_dtype),
                g_inv=ops.batched_damped_inv(G, damping).to(self.inv_dtype),
            )
        cfg = self.iterative
        out = {}
        for side, stack, seed in zip('ag', (A, G), warm or (None, None)):
            r = ops.batched_newton_schulz_inverse(
                stack, damping, iters=iters,
                warm_start=None if seed is None else seed.float(),
                tol=cfg.tol, warm_restart_gate=cfg.warm_restart_gate,
                compute_dtype=cfg.compute_dtype,
            )
            out[f'{side}_inv'] = r.inv.to(self.inv_dtype)
            out[f'iter_res_{side}'] = r.residual
            out[f'iter_bound_{side}'] = r.bound
            out[f'iter_stale_{side}'] = r.unconverged_iters
        return out

    def compute(
        self,
        layers: Mapping[str, LayerKFACState],
        damping: float,
        prev: Mapping[str, BucketSecond] | None = None,
        bootstrap: bool = False,
    ) -> dict[str, BucketSecond]:
        """Recompute this rank's decompositions (inverse-update step):
        phase 1 on this rank's share of its column, phase 2 over the
        column.

        Iterative method: ``prev``'s roots are the Newton–Schulz warm
        seeds.  A rank's share is a slice of its own column's stacks, so
        no collective moves them; the per-slot gate rejects the zero
        stacks of the first refresh.  ``bootstrap`` selects the deep
        cold-capable iteration count over the warm one
        (:func:`~kfac_pytorch_tpu_torch.scheduler.iterative_refresh_iters`).
        """
        grid = self.grid
        iters = (
            iterative_refresh_iters(self.iterative, not bootstrap)
            if self.iterative is not None else 0
        )
        names = None
        shares = []
        for b in self.plan.buckets:
            start, stop = collectives.share_bounds(b.seg, grid.rows, grid.row)
            mine = self.local_slots(b)[start:stop]
            if not mine:  # a short column: this rank's share is empty
                fields = self._zero_fields(b, 0)
            else:
                A, G = self._stack_bucket_factors(b, mine, layers)
                warm = None
                if prev is not None and self.iterative is not None:
                    pb = prev[b.key]
                    warm = (pb.a_inv[start:stop], pb.g_inv[start:stop])
                fields = self._decompose(A, G, damping, warm, iters)
            # Declaration order, the same for every bucket and rank.
            share = BucketSecond(**fields).tensors()
            names = tuple(share)
            shares.append(tuple(share.values()))
        shares = collectives.all_gather_decompositions(
            shares, [b.seg for b in self.plan.buckets], grid.col_group,
            [n in IDENTITY_PADDED for n in names],
        )
        return {
            b.key: BucketSecond(**dict(zip(names, share)))
            for b, share in zip(self.plan.buckets, shares)
        }

    def _rotate_bucket(
        self,
        b: BucketLayout,
        bs: BucketSecond,
        combined_grads: Mapping[str, torch.Tensor],
        damping: float,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One bucket's phases 3 and 4: ``(pg [L, g, a] f32, clip [L])``
        over all ``L`` slots, ``clip[l] = <pg[l], g[l]>``.

        Prediv eigen takes the per-slot sums of the fused kernel (in the
        eigenbasis, ``Σ v1 ⊙ v2``); non-prediv eigen divides by
        ``dg ⊗ da + damping`` in f32 and sums ``v1 ⊙ v2`` the same way;
        inverse and iterative take ``pg = g_inv · g · a_inv`` and sum
        ``pg ⊙ g``.  Padded regions are zero in ``g``, so each term
        equals the unpadded layer's inner product.
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
        g = torch.stack(g_list)
        pdt = self.precond_dtype
        row = self.grid.row_group
        if bs.dgda is not None:
            args = [
                t.to(pdt).contiguous() for t in (g, bs.qa, bs.qg, bs.dgda)
            ]
            return ops.fused_eigen_precondition_sharded(*args, group=row)

        def rounded(t):  # pdt operands, f32 products
            return t.to(pdt).float()

        if bs.qa is not None:
            qa, qg = rounded(bs.qa), rounded(bs.qg)
            v1 = qg.mT @ rounded(g) @ qa
            v2 = rounded(v1 / (
                bs.dg.float()[:, :, None] * bs.da.float()[:, None, :]
                + damping
            ))
            pg = qg @ v2 @ qa.mT
            clip = torch.sum(v1 * v2, dim=(1, 2))
        else:
            pg = rounded(bs.g_inv) @ rounded(g) @ rounded(bs.a_inv)
            clip = torch.sum(pg * g, dim=(1, 2))
        return collectives.all_gather_preconditioned(pg, clip, row)

    def precondition(
        self,
        buckets: Mapping[str, BucketSecond],
        combined_grads: Mapping[str, torch.Tensor],
        damping: float,
        kl_clip: float | None,
        lr: float,
        extra_clip_terms: Sequence[torch.Tensor] = (),
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor | None]:
        """Precondition all layers' combined gradients at once.

        Returns ``(preconditioned grads by layer, kl-clip scale or
        None)``; the returned grads already carry the scale.  Every rank
        returns every layer.  ``damping`` is the live damping, which the
        non-prediv eigen path divides by.  Scaling after the row gather
        gives the same bits as scaling before it.
        ``extra_clip_terms`` are the ``<pg, g> * lr^2`` terms of layers
        preconditioned outside the stacks (diagonal A), summed after the
        buckets' terms, as ``second_order.py:1575`` of the JAX package
        sums them.
        """
        stacked = {}
        terms = []
        for b in self.plan.buckets:
            pg, clips = self._rotate_bucket(
                b, buckets[b.key], combined_grads, damping,
            )
            stacked[b.key] = pg
            terms.append(torch.sum(clips) * float(lr) ** 2)
        terms.extend(extra_clip_terms)
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
        """Bytes of stacked second-order state on this rank: every field
        that is set."""
        return sum(
            t.numel() * t.element_size()
            for bs in buckets.values()
            for t in bs.tensors().values()
        )
