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

Eigen also runs two additive variants of the JAX package: randomized
low-rank eigen (``lowrank_rank``: a bucket side at least twice the rank
keeps its top eigenpairs and the mean of its trailing spectrum,
:mod:`~kfac_pytorch_tpu_torch.ops.lowrank`; a bucket with a truncated
side is zero-padded, keeps ``da``/``dg`` and preconditions by thin
matmuls, while exact buckets keep ``dgda`` and the fused kernel) and
EKFAC (``ekfac``: every bucket keeps ``da``/``dg`` and a scale grid
``skron [seg, g, a]``, reseeded to ``dg ⊗ da`` at each refresh and moved
every factor step by :meth:`BucketedSecondOrder.ekfac_update`;
:mod:`~kfac_pytorch_tpu_torch.ops.ekfac`).  A rank captures rows for
every layer, but on a grid with several columns holds only its column's
bases, so under EKFAC each refresh also gathers every column's ``qa``
and ``qg`` over the grid row and keeps their occupied slots as
``basis_qa``/``basis_qg`` (the JAX program replicates ``qa[slot]`` for
each projection instead, ``second_order.py:1416-1417``); the scale
contributions then ride the factor all-reduce as under COMM-OPT, and
each rank keeps its column's scales.

With a :class:`~kfac_pytorch_tpu_torch.parallel.bucketing.StaggerPlan`
(``stagger_refresh``), :meth:`BucketedSecondOrder.compute_shard`
re-decomposes one shard's slots and scatters them into the existing
stacks (phases 1 and 2 on the shard's slots only).  Both build new
stacks and leave the ones they are given untouched, so a refresh can run
off the step (``overlap_comm``) while the step preconditions through the
old ones.

With ``pipeline_grads`` phases 3 and 4 run bucket by bucket in
:attr:`BucketedSecondOrder.pipeline_order` (JAX ``second_order.py:
1505-1600``): each bucket's row gather is issued asynchronously as soon
as its rotation is done, so the next bucket's rotation runs while it
moves; every handle is waited on before the kl-clip sum, whose terms are
added in plan order, so the result is the synchronous tail's, bit for
bit.

With a :class:`~kfac_pytorch_tpu_torch.health.HealthConfig` (``health``)
each exact bucket's decomposition runs under bounded, escalating retries
(:func:`~kfac_pytorch_tpu_torch.health.run_with_recovery`, JAX
``second_order.py:735-932``); a slot that still fails falls back to its
last-good decomposition and counts toward quarantine
(:func:`~kfac_pytorch_tpu_torch.health.merge_with_prev`).  The per-slot
verdicts and retry rounds ride the decomposition gather over the column,
so every rank of a column merges alike, and one small gather over the row
gives every rank the counters of every column.  A quarantined slot is
preconditioned by the identity (``pg = g``, clip term ``<g, g>``), on the
rank's column right after the fused kernel or the rotation and before the
row gather (:func:`~kfac_pytorch_tpu_torch.ops.fused_precond.\
substitute_quarantined`); with no slot quarantined the tail is bitwise
the unguarded one.  The consistency guard
(:mod:`~kfac_pytorch_tpu_torch.consistency`) keeps the same masks
(``quarantine_masks``), carried through every refresh without health.

On one device the grid is ``1 x 1`` and no collective runs.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping, Sequence

import numpy as np
import torch

from kfac_pytorch_tpu_torch import health as health_lib
from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.enums import ComputeMethod
from kfac_pytorch_tpu_torch.observe import monitor as observe_monitor
from kfac_pytorch_tpu_torch.observe import timeline as observe_timeline
from kfac_pytorch_tpu_torch.ops import lowrank as lowrank_ops
from kfac_pytorch_tpu_torch.parallel import collectives
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketLayout
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketPlan
from kfac_pytorch_tpu_torch.parallel.bucketing import make_pipeline_order
from kfac_pytorch_tpu_torch.parallel.bucketing import StaggerPlan
from kfac_pytorch_tpu_torch.parallel.mesh import KaisaGrid
from kfac_pytorch_tpu_torch.scheduler import iterative_refresh_iters
from kfac_pytorch_tpu_torch.state import LayerKFACState

#: Fields padded with identity blocks when a column's share is gathered
#: and its blocks are square; every other field, and the thin low-rank
#: eigenvector stacks, pad with zeros.
IDENTITY_PADDED = frozenset({'qa', 'qg', 'a_inv', 'g_inv'})
#: Fields rebuilt from the others (EKFAC's bases of every column's
#: occupied slots), which a checkpoint does not keep.
DERIVED_FIELDS = frozenset({'basis_qa', 'basis_qg'})


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
    next refresh's warm seeds.  Low-rank buckets: thin ``qa [seg, a,
    ka]`` / ``qg [seg, g, kg]`` (``k`` the rank on a truncated side, the
    padded dim on an exact one), ``da``/``dg`` and the trailing-spectrum
    means ``sa``/``sg`` ``[seg]`` of the truncated sides.  EKFAC:
    ``da``/``dg`` and ``skron [seg, g, a]`` (f32), the scale grid, and
    on a grid with several columns ``basis_qa [n, a, a]`` /
    ``basis_qg [n, g, g]``, the eigenvectors of the bucket's ``n``
    occupied slots in every column, which project the rows of every
    layer.  With health guardrails or the consistency guard:
    ``fail_count [seg] i32`` (consecutive failed refreshes),
    ``quarantined [seg] bool`` (identity preconditioning) and ``ever_ok
    [seg] bool`` (a refresh ever succeeded).  Fields a method does not
    use are ``None``.
    """

    qa: torch.Tensor | None = None
    qg: torch.Tensor | None = None
    da: torch.Tensor | None = None
    dg: torch.Tensor | None = None
    dgda: torch.Tensor | None = None
    bake_damping: torch.Tensor | None = None
    sa: torch.Tensor | None = None
    sg: torch.Tensor | None = None
    a_inv: torch.Tensor | None = None
    g_inv: torch.Tensor | None = None
    iter_res_a: torch.Tensor | None = None
    iter_res_g: torch.Tensor | None = None
    iter_bound_a: torch.Tensor | None = None
    iter_bound_g: torch.Tensor | None = None
    iter_stale_a: torch.Tensor | None = None
    iter_stale_g: torch.Tensor | None = None
    skron: torch.Tensor | None = None
    basis_qa: torch.Tensor | None = None
    basis_qg: torch.Tensor | None = None
    fail_count: torch.Tensor | None = None
    quarantined: torch.Tensor | None = None
    ever_ok: torch.Tensor | None = None

    def tensors(self) -> dict[str, torch.Tensor]:
        """The fields that are set, in declaration order."""
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }

    def stack_fields(self) -> dict[str, torch.Tensor]:
        """The set fields a checkpoint keeps: all but the
        :data:`DERIVED_FIELDS`, in declaration order (JAX's
        ``BucketSecond`` fields, by the same names)."""
        return {k: v for k, v in self.tensors().items()
                if k not in DERIVED_FIELDS}


class PendingGather:
    """A refresh whose shares are decomposed and whose column gather is
    still to come: calling it gathers (on the caller's thread and current
    stream) and returns the new stacks.  :meth:`tensors` lists the
    shares, so a caller on another stream can ``record_stream`` them."""

    def __init__(self, finish, shares) -> None:
        self._finish = finish
        self._shares = [t for share in shares for t in share]

    def tensors(self) -> dict[str, torch.Tensor]:
        return {str(i): t for i, t in enumerate(self._shares)}

    def __call__(self) -> dict[str, BucketSecond]:
        return self._finish()


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


def _eigh(stack: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`~kfac_pytorch_tpu_torch.ops.symmetric_eigh` of a stack under
    health: a slot whose decomposition raises (the solver did not
    converge) comes out NaN, as JAX's ``eigh`` leaves it, and the others
    are decomposed one by one."""
    try:
        return ops.symmetric_eigh(stack)
    except RuntimeError:
        ds, qs = [], []
        for f in stack:
            try:
                d, q = ops.symmetric_eigh(f)
            except RuntimeError:
                d = torch.full(f.shape[:1], float('nan'), device=f.device)
                q = torch.full_like(f, float('nan'))
            ds.append(d)
            qs.append(q)
        return torch.stack(ds), torch.stack(qs)


def _f32_add(a: float, b: float) -> float:
    """``a + b`` rounded in f32, as the JAX package adds two f32 scalars."""
    return float(np.float32(a) + np.float32(b))


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
        slot_dims: layer name -> logical ``(a_dim, g_dim)`` (default: the
            padded dims); ``sigma`` averages over them, and the EKFAC
            drift masks the padding with them.
        lowrank_rank: eigen only: truncate each bucket side whose padded
            dim engages (:func:`~kfac_pytorch_tpu_torch.ops.lowrank.\
lowrank_engages`) to its top ``lowrank_rank`` eigenpairs.
        lowrank_oversample, lowrank_power_iters: the sketch's extra
            columns and QR power iterations.
        ekfac: eigen only: EKFAC scale grids (exclusive with
            ``lowrank_rank``).
        stagger: the refresh shards of ``stagger_refresh``
            (:meth:`compute_shard`); exclusive with ``lowrank_rank``.
        pipeline_grads: run :meth:`precondition`'s tail bucket by bucket
            in :attr:`pipeline_order`, each row gather issued
            asynchronously after its bucket's rotation.
        health: the numerical-health knobs (exact methods; exclusive
            with ``lowrank_rank`` and ``stagger``).
        quarantine_masks: keep the per-slot quarantine masks without
            ``health`` (the consistency guard), carried through every
            refresh as they are.
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
        slot_dims: Mapping[str, tuple[int, int]] | None = None,
        lowrank_rank: int | None = None,
        lowrank_oversample: int = 32,
        lowrank_power_iters: int = 2,
        ekfac: bool = False,
        stagger: StaggerPlan | None = None,
        pipeline_grads: bool = False,
        health: health_lib.HealthConfig | None = None,
        quarantine_masks: bool = False,
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
        if lowrank_rank is not None and compute_method != ComputeMethod.EIGEN:
            raise ValueError('lowrank_rank requires the eigen method')
        if ekfac and compute_method != ComputeMethod.EIGEN:
            raise ValueError('ekfac requires the eigen method')
        if ekfac and lowrank_rank is not None:
            raise ValueError(
                'ekfac and lowrank_rank are mutually exclusive (EKFAC '
                'scales need the complete eigenvalue grid)',
            )
        if stagger is not None and lowrank_rank is not None:
            raise ValueError(
                'stagger_refresh and lowrank_rank are mutually exclusive',
            )
        if health is not None and (lowrank_rank is not None
                                   or stagger is not None):
            raise ValueError(
                'health guardrails cover the exact refresh of every slot; '
                'lowrank_rank and stagger_refresh are exclusive with them',
            )
        self.health = health
        #: Whether the buckets keep fail_count/quarantined/ever_ok.
        self.masks = health is not None or bool(quarantine_masks)
        self.stagger = stagger
        #: The pipelined tail's bucket issue order (``None``: the
        #: synchronous tail).
        self.pipeline_order = (
            make_pipeline_order(plan) if pipeline_grads else None
        )
        self.lowrank_rank = lowrank_rank
        self.lowrank_oversample = int(lowrank_oversample)
        self.lowrank_power_iters = int(lowrank_power_iters)
        self.ekfac = bool(ekfac)
        slot_dims = slot_dims or {}

        def engages(pad: int) -> bool:
            return lowrank_ops.lowrank_engages(
                pad, lowrank_rank, self.lowrank_oversample,
            )

        # Per bucket: which sides truncate, each slot's logical dims
        # (the padded dim for an empty slot) and a stable seed that
        # decorrelates the sketch draws across buckets.
        self._lowrank: dict[str, tuple[bool, bool]] = {}
        self._slot_dims: dict[str, tuple[tuple[int, ...], ...]] = {}
        self._bucket_seed: dict[str, int] = {}
        for b in plan.buckets:
            self._lowrank[b.key] = (engages(b.a_pad), engages(b.g_pad))
            dims = [slot_dims.get(n, (b.a_pad, b.g_pad)) if n else
                    (b.a_pad, b.g_pad) for n in b.slots]
            self._slot_dims[b.key] = (tuple(d[0] for d in dims),
                                      tuple(d[1] for d in dims))
            self._bucket_seed[b.key] = zlib.crc32(b.key.encode())
        #: Under EKFAC on a grid with several columns: each layer's
        #: index among its bucket's occupied slots, in slot order, which
        #: is its row of the gathered ``basis_qa``/``basis_qg``.
        self._basis_slot = {
            n: i for b in plan.buckets
            for i, n in enumerate(n for n in b.slots if n is not None)
        }
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
        #: ``record_function`` ranges around the refresh's and the
        #: precondition's parts (``ObserveConfig(annotate=True)``; set by
        #: the engine).
        self.annotate = False
        # The observe monitor's per-bucket constants: the column's logical
        # dims and occupancy on the device, and the support masks of the
        # current eigenvector stacks (_monitor_masks, _support_masks).
        self._masks: dict = {}
        self._support_cache: dict = {}

    def _scope(self, name: str):
        return observe_timeline.scope(name, self.annotate)

    def local_slots(self, b: BucketLayout) -> tuple[str | None, ...]:
        """The slots of bucket ``b`` this rank holds: its column's."""
        return b.column_slots(self.grid.col)

    def local_slot(self, name: str) -> tuple[str, int]:
        """``(bucket key, index among this rank's slots)`` of a layer
        in this rank's column."""
        key, slot = self.plan.slot_of[name]
        return key, slot - self.grid.col * self.plan.bucket(key).seg

    def lowrank_sides(self, key: str) -> tuple[bool, bool]:
        """``(A truncated, G truncated)`` of bucket ``key``."""
        if self.compute_method != ComputeMethod.EIGEN:
            return (False, False)
        return self._lowrank[key]

    def bucket_prediv(self, key: str) -> bool:
        """Whether bucket ``key`` keeps ``dgda`` and runs the fused
        kernel: prediv eigen, unless a side truncates (no dense
        ``[g, a]`` eigenvalue grid) or EKFAC (the scale grid moves every
        factor step, so a cached ``1 / (grid + damping)`` would be
        stale)."""
        return (self.prediv and not self.ekfac
                and not any(self._lowrank[key]))

    def _zero_fields(self, b: BucketLayout, n: int) -> dict[str, torch.Tensor]:
        """``n`` slots of bucket ``b``'s state, in the method's fields:
        zero stacks, with the iterative residuals at ``+inf`` (a zero
        would read as converged before any refresh ran)."""
        a, g = b.a_pad, b.g_pad

        def zeros(*shape, dtype=self.inv_dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if self.compute_method == ComputeMethod.EIGEN:
            lr_a, lr_g = self._lowrank[b.key]
            ka = self.lowrank_rank if lr_a else a
            kg = self.lowrank_rank if lr_g else g
            out = dict(qa=zeros(n, a, ka), qg=zeros(n, g, kg))
            if self.bucket_prediv(b.key):
                out.update(dgda=zeros(n, g, a),
                           bake_damping=zeros(n, dtype=torch.float32))
            else:
                out.update(da=zeros(n, ka), dg=zeros(n, kg))
            if lr_a:
                out['sa'] = zeros(n)
            if lr_g:
                out['sg'] = zeros(n)
            if self.ekfac:
                out['skron'] = zeros(n, g, a, dtype=torch.float32)
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
        """Zeroed stacked second-order state (this rank's slots; under
        EKFAC on a grid with several columns also the zero bases of every
        occupied slot, which the first factor step projects through, as
        the JAX program projects through its zero stacks)."""
        out = {
            b.key: BucketSecond(**self._zero_fields(b, b.seg))
            for b in self.plan.buckets
        }
        if self.masks:
            for b in self.plan.buckets:
                bs = out[b.key]
                bs.fail_count = torch.zeros(
                    (b.seg,), dtype=torch.int32, device=self.device)
                bs.quarantined = torch.zeros(
                    (b.seg,), dtype=torch.bool, device=self.device)
                bs.ever_ok = torch.zeros(
                    (b.seg,), dtype=torch.bool, device=self.device)
        if self.ekfac and self.grid.cols > 1:
            for b in self.plan.buckets:
                n = sum(name is not None for name in b.slots)
                out[b.key].basis_qa = torch.zeros(
                    (n, b.a_pad, b.a_pad), dtype=self.inv_dtype,
                    device=self.device,
                )
                out[b.key].basis_qg = torch.zeros(
                    (n, b.g_pad, b.g_pad), dtype=self.inv_dtype,
                    device=self.device,
                )
        return out

    def _stack_bucket_factors(
        self,
        b: BucketLayout,
        slots: tuple[str | None, ...],
        layers: Mapping[str, LayerKFACState],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Padded ``(A, G)`` f32 factor stacks of ``slots`` of bucket
        ``b``.  Exact buckets pad slots and dims with identity blocks (a
        well-conditioned input that never reaches an unpadded result);
        low-rank buckets with zeros, which land at the bottom of the
        spectrum, where an identity pad would add spurious eigenvalue-1
        directions to the truncated top and inflate ``sigma``."""
        zero_pad = any(self.lowrank_sides(b.key))

        def pad(factor, p):
            if not zero_pad:
                return _pad_factor(factor, p)
            d = factor.shape[-1]
            return torch.nn.functional.pad(factor, (0, p - d, 0, p - d))

        def fill(p):
            if zero_pad:
                return torch.zeros((p, p), device=self.device)
            return torch.eye(p, device=self.device)

        a_list, g_list = [], []
        for name in slots:
            if name is None:
                a_list.append(fill(b.a_pad))
                g_list.append(fill(b.g_pad))
            else:
                st = layers[name]
                a_list.append(pad(st.a_factor.float(), b.a_pad))
                g_list.append(pad(st.g_factor.float(), b.g_pad))
        return torch.stack(a_list), torch.stack(g_list)

    def _compute_lowrank(
        self,
        b: BucketLayout,
        A: torch.Tensor,
        G: torch.Tensor,
        slots: Sequence[int],
        sketch_step: int,
    ) -> dict[str, torch.Tensor]:
        """Phase 1 of one low-rank bucket share (``slots``: the share's
        indices in the whole bucket stack): each truncated side by
        :func:`~kfac_pytorch_tpu_torch.ops.lowrank.batched_randomized_eigh`
        with sketches drawn for (bucket seed, side, ``sketch_step``,
        slot), each exact side by a clamped ``eigh``."""
        a_dims, g_dims = self._slot_dims[b.key]
        out = {}
        for side, (name, stack, lowrank, dims) in enumerate((
            ('a', A, self._lowrank[b.key][0], a_dims),
            ('g', G, self._lowrank[b.key][1], g_dims),
        )):
            q, d, sigma = lowrank_ops.decompose_stack(
                stack, lowrank, self.lowrank_rank,
                oversample=self.lowrank_oversample,
                power_iters=self.lowrank_power_iters,
                seed=self._bucket_seed[b.key], side=side, step=sketch_step,
                slots=slots, effective_dims=[dims[i] for i in slots],
            )
            out[f'q{name}'] = q.to(self.inv_dtype)
            out[f'd{name}'] = d.to(self.inv_dtype)
            if lowrank:
                out[f's{name}'] = sigma.to(self.inv_dtype)
        return out

    def _decompose(
        self,
        b: BucketLayout,
        A: torch.Tensor,
        G: torch.Tensor,
        damping: float,
        warm: tuple[torch.Tensor, torch.Tensor] | None,
        iters: int,
        slots: Sequence[int],
        sketch_step: int,
    ) -> dict[str, torch.Tensor]:
        """Phase 1 of one bucket share: the method's fields."""
        if self.compute_method == ComputeMethod.EIGEN:
            if any(self._lowrank[b.key]):
                return self._compute_lowrank(b, A, G, slots, sketch_step)
            da, qa = ops.symmetric_eigh(A.float())
            dg, qg = ops.symmetric_eigh(G.float())
            return self._eigen_fields(b, qa, da, qg, dg, damping)
        if self.compute_method == ComputeMethod.INVERSE:
            return dict(
                a_inv=ops.batched_damped_inv(A, damping).to(self.inv_dtype),
                g_inv=ops.batched_damped_inv(G, damping).to(self.inv_dtype),
            )
        return self._iterative_fields(
            self._iterative_refresh(A, G, damping, warm, iters))

    def _eigen_fields(self, b, qa, da, qg, dg, damping):
        """The eigen fields of a share from its f32 eigenpairs: ``Q`` in
        ``inv_dtype``, eigenvalues cast and clamped at zero
        (:func:`~kfac_pytorch_tpu_torch.ops.compute_factor_eigen`), then
        EKFAC's reseeded scales, the kept eigenvalues, or ``dgda``.  The
        bases are kept row-major: cuSOLVER returns them column-major
        (and a shifted redo row-major), so every refresh would otherwise
        hand the tail stacks of another layout, which the kernel copies
        and a compiled tail recompiles for."""
        qa = qa.to(self.inv_dtype).contiguous()
        qg = qg.to(self.inv_dtype).contiguous()
        da = torch.clamp(da.to(self.inv_dtype), min=0.0)
        dg = torch.clamp(dg.to(self.inv_dtype), min=0.0)
        if self.ekfac:
            # The scale grid restarts at the Kronecker eigenvalue grid,
            # plain K-FAC's scales in the fresh basis (the old EMA lived
            # in the old basis).
            skron = dg.float()[:, :, None] * da.float()[:, None, :]
            return dict(qa=qa, qg=qg, da=da, dg=dg, skron=skron)
        if not self.bucket_prediv(b.key):
            return dict(qa=qa, qg=qg, da=da, dg=dg)
        return dict(
            qa=qa, qg=qg, dgda=ops.compute_dgda(dg, da, damping),
            bake_damping=torch.full(
                (qa.shape[0],), damping, device=qa.device,
            ),
        )

    def _iterative_refresh(self, A, G, damping, warm, iters):
        """One Newton–Schulz refresh of a share as JAX's flat 8-tuple
        ``(a_inv, g_inv, res_a, res_g, bound_a, bound_g, stale_a,
        stale_g)``, the form the health retries merge per slot."""
        cfg = self.iterative
        out = {}
        for side, stack, seed in zip('ag', (A, G), warm or (None, None)):
            out[side] = ops.batched_newton_schulz_inverse(
                stack, damping, iters=iters,
                warm_start=None if seed is None else seed.float(),
                tol=cfg.tol, warm_restart_gate=cfg.warm_restart_gate,
                compute_dtype=cfg.compute_dtype,
            )
        ra, rg = out['a'], out['g']
        return (ra.inv, rg.inv, ra.residual, rg.residual, ra.bound,
                rg.bound, ra.unconverged_iters, rg.unconverged_iters)

    def _iterative_fields(self, outs) -> dict[str, torch.Tensor]:
        a_inv, g_inv, res_a, res_g, bound_a, bound_g, stale_a, stale_g = outs
        return dict(
            a_inv=a_inv.to(self.inv_dtype), g_inv=g_inv.to(self.inv_dtype),
            iter_res_a=res_a, iter_res_g=res_g, iter_bound_a=bound_a,
            iter_bound_g=bound_g, iter_stale_a=stale_a, iter_stale_g=stale_g,
        )

    def _inject_mask(self, b: BucketLayout, first: int, n: int):
        """The health injection mask of a share (``n`` slots from global
        slot ``first`` of bucket ``b``): ``None`` when injection targets
        every slot, else host ``[n]`` bool (JAX ``_inject_mask``,
        ``second_order.py:630-654``)."""
        cfg = self.health
        if cfg.inject_eigh_layers is None:
            return None
        mask = np.zeros((b.n_slots,), bool)
        for key, slot in cfg.inject_eigh_layers:
            if key == b.key:
                mask[slot] = True
        return mask[first:first + n]

    def _decompose_guarded(
        self,
        b: BucketLayout,
        A: torch.Tensor,
        G: torch.Tensor,
        damping: float,
        warm: tuple[torch.Tensor, torch.Tensor] | None,
        iters: int,
        first: int,
        stats: dict,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """Phase 1 of one share under health (JAX ``second_order.py:
        808-899, 993-1060``): the method's fields from the best attempt
        per slot, and ``[n, 2]`` i32 ``(ok, rounds)`` per slot, ``rounds``
        the retry rounds the slot went into still failing.  Attempt 0 is
        the unguarded decomposition itself; a retry adds ``jitter`` to the
        diagonal (eigen, subtracted from the eigenvalues after) or to the
        damping (inverse, iterative).  The iterative verdict is finite
        roots and both residuals within ``tol``."""
        cfg = self.health
        n = A.shape[0]
        mask = self._inject_mask(b, first, n)
        verdict_fn = None
        if self.compute_method == ComputeMethod.EIGEN:
            eye_a = torch.eye(A.shape[-1], device=A.device)
            eye_g = torch.eye(G.shape[-1], device=G.device)

            def attempt(jitter):
                if jitter == 0.0:
                    da, qa = _eigh(A.float())
                    dg, qg = _eigh(G.float())
                    return da, qa, dg, qg
                da, qa = _eigh(A.float() + jitter * eye_a)
                dg, qg = _eigh(G.float() + jitter * eye_g)
                return da - jitter, qa, dg - jitter, qg
        elif self.compute_method == ComputeMethod.INVERSE:
            def attempt(jitter):
                d = damping if jitter == 0.0 else _f32_add(damping, jitter)
                return (ops.batched_damped_inv(A, d),
                        ops.batched_damped_inv(G, d))
        else:
            tol = self.iterative.tol

            def attempt(jitter):
                d = damping if jitter == 0.0 else _f32_add(damping, jitter)
                return self._iterative_refresh(A, G, d, warm, iters)

            def verdict_fn(outs):
                fin = health_lib.stacked_all_finite(outs[:2], n)
                return fin & (outs[2] <= tol) & (outs[3] <= tol)
        outs, ok, _ = health_lib.run_with_recovery(
            attempt, damping, cfg, n_layers=n, inject_mask=mask,
            verdict_fn=verdict_fn, stats=stats,
        )
        rounds = stats.pop('slot_rounds')
        if self.compute_method == ComputeMethod.EIGEN:
            da, qa, dg, qg = outs
            fields = self._eigen_fields(b, qa, da, qg, dg, damping)
        elif self.compute_method == ComputeMethod.INVERSE:
            fields = dict(a_inv=outs[0].to(self.inv_dtype),
                          g_inv=outs[1].to(self.inv_dtype))
        else:
            fields = self._iterative_fields(outs)
        return fields, torch.stack([ok.to(torch.int32), rounds], dim=1)

    def compute(
        self,
        layers: Mapping[str, LayerKFACState],
        damping: float,
        prev: Mapping[str, BucketSecond] | None = None,
        bootstrap: bool = False,
        sketch_step: int = 0,
        health_stats: dict | None = None,
        defer_gather: bool = False,
    ) -> dict[str, BucketSecond] | PendingGather:
        """Recompute this rank's decompositions (inverse-update step):
        phase 1 on this rank's share of its column, phase 2 over the
        column.  With ``defer_gather`` phase 2 is left to the caller: a
        :class:`PendingGather` whose call gathers and returns the stacks
        (the deferred refresh issues it on the main thread).

        Under health (``prev`` then required) each share runs
        :meth:`_decompose_guarded`; its per-slot ``(ok, rounds)`` ride the
        column gather, every rank of the column merges the column with
        ``prev`` (:func:`~kfac_pytorch_tpu_torch.health.merge_with_prev`),
        and ``health_stats`` receives the device counters of the whole
        bucket stacks, every column's slots (one gather over the row):
        ``retries`` (per bucket the most rounds any slot needed, summed),
        ``fallbacks`` (slots still failing) and ``quarantined`` (slots
        quarantined now), with ``host_reads``, the verdict reads of the
        retry rounds.  With the masks but no health (the consistency
        guard) ``prev``'s masks carry through as they are.

        Low-rank buckets draw their sketches for ``sketch_step`` (the
        inverse-update step) and each slot's index in the whole bucket
        stack, so every grid draws what one device draws.

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
        guarded = self.health is not None
        if self.masks and prev is None:
            raise ValueError(
                'compute() needs the prev buckets under health or the '
                'consistency guard (the fallback and the quarantine '
                'masks carry through the refresh)',
            )
        stats = {} if health_stats is None else health_stats
        names, shares = [], []
        for b in self.plan.buckets:
            start, stop = collectives.share_bounds(b.seg, grid.rows, grid.row)
            mine = self.local_slots(b)[start:stop]
            verdict = None
            if not mine:  # a short column: this rank's share is empty
                fields = self._zero_fields(b, 0)
                if guarded:
                    verdict = torch.zeros((0, 2), dtype=torch.int32,
                                          device=self.device)
            else:
                with self._scope('factor_stack_assembly'):
                    A, G = self._stack_bucket_factors(b, mine, layers)
                warm = None
                if prev is not None and self.iterative is not None:
                    pb = prev[b.key]
                    warm = (pb.a_inv[start:stop], pb.g_inv[start:stop])
                first = grid.col * b.seg + start
                with self._scope(self._method_scope()):
                    if guarded:
                        fields, verdict = self._decompose_guarded(
                            b, A, G, damping, warm, iters, first, stats,
                        )
                    else:
                        fields = self._decompose(
                            b, A, G, damping, warm, iters,
                            range(first, first + len(mine)), sketch_step,
                        )
            # Declaration order: a bucket's fields are the same on every
            # rank (low-rank and exact buckets keep different ones); the
            # health verdicts ride last.
            share = BucketSecond(**fields).tensors()
            if verdict is not None:
                share['verdict'] = verdict
            names.append(tuple(share))
            shares.append(tuple(share.values()))
        pending = PendingGather(
            lambda: self._finish_compute(names, shares, prev, stats),
            shares)
        return pending if defer_gather else pending()

    def _finish_compute(self, names, shares, prev, stats):
        """Phase 2 of :meth:`compute`: the column gather of every
        bucket's shares, the health merge, the EKFAC bases."""
        guarded = self.health is not None
        with self._scope('inverse_row_allgather'):
            shares = collectives.all_gather_decompositions(
                shares, [b.seg for b in self.plan.buckets],
                self.grid.col_group,
                [[n in IDENTITY_PADDED for n in ns] for ns in names],
            )
        out, columns = {}, []
        for b, ns, share in zip(self.plan.buckets, names, shares):
            fields = dict(zip(ns, share))
            verdict = fields.pop('verdict', None)
            bs = BucketSecond(**fields)
            if verdict is not None:
                ok = verdict[:, 0].bool()
                bs = health_lib.merge_with_prev(bs, prev[b.key], ok,
                                                self.health)
                columns.append(torch.stack(
                    [verdict[:, 0], verdict[:, 1],
                     bs.quarantined.to(torch.int32)], dim=1))
            elif self.masks:
                pb = prev[b.key]
                bs.fail_count = pb.fail_count
                bs.quarantined = pb.quarantined
                bs.ever_ok = pb.ever_ok
            out[b.key] = bs
        if guarded:
            stats.update(self._health_counters(columns))
        return self._with_ekfac_bases(
            out, [b.key for b in self.plan.buckets])

    def _health_counters(
        self, columns: Sequence[torch.Tensor],
    ) -> dict[str, torch.Tensor]:
        """The refresh's health counters over every slot of every bucket
        from each bucket's ``[seg, 3]`` ``(ok, rounds, quarantined)`` of
        this rank's column, gathered over the row (no collective with one
        column): the same device scalars on every rank."""
        (full,) = collectives.all_gather_stacks(
            [torch.cat(columns)], self.grid.row_group,
        )
        full = full.view(self.grid.cols, -1, 3)
        retries = torch.zeros((), dtype=torch.int32, device=self.device)
        offset = 0
        for b in self.plan.buckets:
            retries = retries + full[:, offset:offset + b.seg, 1].max()
            offset += b.seg
        return dict(
            retries=retries,
            fallbacks=(1 - full[..., 0]).sum().to(torch.int32),
            quarantined=full[..., 2].sum().to(torch.int32),
        )

    def compute_shard(
        self,
        layers: Mapping[str, LayerKFACState],
        damping: float,
        shard: int,
        prev: Mapping[str, BucketSecond],
        defer_gather: bool = False,
    ) -> dict[str, BucketSecond] | PendingGather:
        """Re-decompose one stagger shard's slots (JAX ``compute_shard``,
        ``second_order.py:1075-1230``) and scatter them into ``prev``'s
        stacks at their slot indices; every other slot passes through.

        The shard's slots are stacked through the same identity padding
        as :meth:`compute` and decomposed by the same method code, so a
        sweep of shards ``0..K-1`` over unchanged factors gives what one
        monolithic refresh gives: eigen with prediv ``qa``, ``qg``,
        ``dgda`` and ``bake_damping``; without it ``qa``, ``qg``, ``da``
        and ``dg``; EKFAC also ``skron`` reseeded to the fresh ``dg ⊗
        da``; inverse ``a_inv``/``g_inv``; iterative the roots and their
        residuals, always at warm depth from the slots' own roots (the
        monolithic bootstrap came first).

        On the KAISA grid a shard's slots lie in several columns: each
        rank takes the shard's slots of its own column, the column's
        ranks split them as :meth:`compute` splits a column, and gather
        them over the column.  Which collectives run depends on the grid
        and the shard index only, the same on every rank of a column.
        """
        if self.stagger is None:
            raise ValueError('compute_shard requires a StaggerPlan')
        if not 0 <= shard < self.stagger.n_shards:
            raise ValueError(
                f'shard {shard} out of range for '
                f'{self.stagger.n_shards} shards',
            )
        grid = self.grid
        iters = self.iterative.warm_iters if self.iterative is not None else 0
        picked, names, shares = [], [], []
        for b in self.plan.buckets:
            first = grid.col * b.seg
            local = [i - first for i in self.stagger.shards[shard].get(
                b.key, ()) if first <= i < first + b.seg]
            if not local:  # the same on every rank of this column
                continue
            start, stop = collectives.share_bounds(
                len(local), grid.rows, grid.row,
            )
            mine = local[start:stop]
            if not mine:
                fields = self._zero_fields(b, 0)
            else:
                column = self.local_slots(b)
                A, G = self._stack_bucket_factors(
                    b, tuple(column[i] for i in mine), layers,
                )
                warm = None
                if self.iterative is not None:
                    pb = prev[b.key]
                    sel = torch.tensor(mine, device=self.device)
                    warm = (pb.a_inv[sel], pb.g_inv[sel])
                with self._scope(f'{self._method_scope()}/shard{shard}'):
                    fields = self._decompose(
                        b, A, G, damping, warm, iters,
                        [first + i for i in mine], 0,
                    )
            share = BucketSecond(**fields).tensors()
            picked.append((b, local))
            names.append(tuple(share))
            shares.append(tuple(share.values()))
        pending = PendingGather(
            lambda: self._finish_shard(shard, picked, names, shares, prev),
            shares)
        return pending if defer_gather else pending()

    def _finish_shard(self, shard, picked, names, shares, prev):
        """Phase 2 of :meth:`compute_shard`: the column gather and the
        scatter into ``prev``'s stacks."""
        with self._scope('inverse_row_allgather'):
            shares = collectives.all_gather_decompositions(
                shares, [len(local) for _, local in picked],
                self.grid.col_group,
                [[n in IDENTITY_PADDED for n in ns] for ns in names],
            )
        out = dict(prev)
        for (b, local), ns, share in zip(picked, names, shares):
            bs = prev[b.key]
            sel = torch.tensor(local, device=self.device)
            out[b.key] = dataclasses.replace(bs, **{
                n: getattr(bs, n).index_copy(
                    0, sel, t.to(getattr(bs, n).dtype),
                )
                for n, t in zip(ns, share)
            })
        # The buckets the shard touches in any column: the same on every
        # rank, so the row gather of their bases is too.
        return self._with_ekfac_bases(out, [
            b.key for b in self.plan.buckets
            if self.stagger.shards[shard].get(b.key)
        ])

    def _with_ekfac_bases(
        self, buckets: dict[str, BucketSecond], keys: Sequence[str],
    ) -> dict[str, BucketSecond]:
        """Under EKFAC on a grid with several columns: ``buckets`` with
        every column's ``qa``/``qg`` of the buckets ``keys`` gathered
        over the grid row (one all-gather) and kept at their occupied
        slots only, in slot order, as ``basis_qa``/``basis_qg`` (a
        column's padding slots are zero blocks that no layer projects
        through); ``buckets`` as they are otherwise.  Which buckets are
        gathered depends on the plan and the shard only, so every rank
        issues the same gather."""
        if not (self.ekfac and self.grid.cols > 1) or not keys:
            return buckets
        stacks = [t for k in keys for t in (buckets[k].qa, buckets[k].qg)]
        full = collectives.all_gather_stacks(stacks, self.grid.row_group)
        out = dict(buckets)
        for i, k in enumerate(keys):
            occ = torch.tensor(
                [j for j, n in enumerate(self.plan.bucket(k).slots)
                 if n is not None], device=self.device,
            )
            out[k] = dataclasses.replace(
                buckets[k], basis_qa=full[2 * i].index_select(0, occ),
                basis_qg=full[2 * i + 1].index_select(0, occ),
            )
        return out

    def _grad_stack(
        self, b: BucketLayout, combined_grads: Mapping[str, torch.Tensor],
    ) -> torch.Tensor:
        """This rank's column of bucket ``b``'s gradients, ``[seg, g, a]``
        f32, zero-padded (zero slots for padding slots)."""
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
        return torch.stack(g_list)

    def _rotate_bucket(
        self,
        b: BucketLayout,
        bs: BucketSecond,
        g: torch.Tensor,
        damping: float,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Phase 3 of one bucket that keeps no ``dgda`` (JAX
        ``_rotate_bucket``, ``second_order.py:1602-1627``, shared by both
        tails): ``(pg [seg, g, a] f32, clip [seg])`` on this rank's
        column ``g``, ``clip[l] = <pg[l], g[l]>``.

        Non-prediv eigen divides by ``dg ⊗ da + damping`` in f32 and sums
        ``v1 ⊙ v2`` in the eigenbasis; EKFAC divides by ``skron +
        damping`` instead; low-rank buckets run
        :func:`~kfac_pytorch_tpu_torch.ops.lowrank.\
precondition_grad_lowrank` on every slot at once and sum ``pg ⊙ g``;
        inverse and iterative take ``pg = g_inv · g · a_inv`` and sum
        ``pg ⊙ g``.  Padded regions are zero in ``g``, so each term equals
        the unpadded layer's inner product.
        """
        pdt = self.precond_dtype

        def rounded(t):  # pdt operands, f32 products
            return t.to(pdt).float()

        lr_a, lr_g = self.lowrank_sides(b.key)
        if lr_a or lr_g:
            zeros = torch.zeros(g.shape[0], device=self.device)
            pg = lowrank_ops.precondition_grad_lowrank(
                g, (bs.qa, bs.da, zeros if bs.sa is None else bs.sa),
                (bs.qg, bs.dg, zeros if bs.sg is None else bs.sg), damping,
                lowrank_a=lr_a, lowrank_g=lr_g, compute_dtype=pdt,
            )
            clip = torch.sum(pg * g, dim=(1, 2))
        elif bs.qa is not None:
            qa, qg = rounded(bs.qa), rounded(bs.qg)
            v1 = qg.mT @ rounded(g) @ qa
            if bs.skron is not None:
                grid = bs.skron
            else:
                grid = bs.dg.float()[:, :, None] * bs.da.float()[:, None, :]
            v2 = rounded(v1 / (grid + damping))
            pg = qg @ v2 @ qa.mT
            clip = torch.sum(v1 * v2, dim=(1, 2))
        else:
            pg = rounded(bs.g_inv) @ rounded(g) @ rounded(bs.a_inv)
            clip = torch.sum(pg * g, dim=(1, 2))
        return pg, clip

    def _bucket_tail(
        self,
        b: BucketLayout,
        bs: BucketSecond,
        combined_grads: Mapping[str, torch.Tensor],
        damping: float,
        pipelined: bool,
    ):
        """One bucket's phases 3 and 4: ``(pg [L, g, a] f32, clip [L])``
        over all ``L`` slots, or with ``pipelined`` a handle whose
        ``wait()`` gives them (the gather issued asynchronously).  Prediv
        eigen goes through the fused kernel's sharded entry point, which
        takes the per-slot sums from the kernel (``Σ v1 ⊙ v2`` in the
        eigenbasis); every other bucket through :meth:`_rotate_bucket`
        and the row gather.  A quarantine mask (health, consistency)
        substitutes the identity on the column before the gather."""
        with self._scope('grad_stack_assembly'):
            g = self._grad_stack(b, combined_grads)
        row = self.grid.row_group
        if bs.dgda is not None:
            args = [
                t.to(self.precond_dtype).contiguous()
                for t in (g, bs.qa, bs.qg, bs.dgda)
            ]
            kw = dict(group=row, quarantined=bs.quarantined, raw=g)
            if pipelined:
                return ops.fused_eigen_precondition_sharded_async(
                    *args, **kw,
                )
            return ops.fused_eigen_precondition_sharded(*args, **kw)
        pg, clip = self._rotate_bucket(b, bs, g, damping)
        if bs.quarantined is not None:
            pg, clip = ops.substitute_quarantined(pg, clip, g, bs.quarantined)
        if pipelined:
            return collectives.all_gather_preconditioned_async(pg, clip, row)
        return collectives.all_gather_preconditioned(pg, clip, row)

    def precondition(
        self,
        buckets: Mapping[str, BucketSecond],
        combined_grads: Mapping[str, torch.Tensor],
        damping: float | torch.Tensor,
        kl_clip: float | torch.Tensor | None,
        lr: float | torch.Tensor,
        extra_clip_terms: Sequence[torch.Tensor] = (),
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor | None]:
        """Precondition all layers' combined gradients at once.

        Returns ``(preconditioned grads by layer, kl-clip scale or
        None)``; the returned grads already carry the scale.  Every rank
        returns every layer.  ``damping`` is the live damping, which the
        non-prediv eigen path divides by.  Scaling after the row gather
        gives the same bits as scaling before it.  The engine passes
        ``damping``, ``kl_clip`` and ``lr`` as canonical 0-d f32 tensors
        (:func:`~kfac_pytorch_tpu_torch.hyperparams.canonical_scalar`):
        the tail is one traceable program whatever their values.
        ``extra_clip_terms`` are the ``<pg, g> * lr^2`` terms of layers
        preconditioned outside the stacks (diagonal A), summed after the
        buckets' terms, as ``second_order.py:1575`` of the JAX package
        sums them.

        The synchronous tail rotates and gathers each bucket in plan
        order.  The pipelined one (``pipeline_order`` set) issues each
        bucket's gather asynchronously right after its rotation, in
        :attr:`pipeline_order`, and waits on every handle afterwards; the
        per-bucket work is the same code, and the clip terms are summed
        in plan order either way (float summation order is part of the
        bitwise equality of the two tails).
        """
        stacked, clips = {}, {}
        if self.pipeline_order is None:
            for b in self.plan.buckets:
                stacked[b.key], clips[b.key] = self._bucket_tail(
                    b, buckets[b.key], combined_grads, damping, False,
                )
        else:
            handles = {
                key: self._bucket_tail(
                    self.plan.bucket(key), buckets[key], combined_grads,
                    damping, True,
                )
                for key in self.pipeline_order
            }
            for key, handle in handles.items():
                stacked[key], clips[key] = handle.wait()
        lr2 = ops.lr_squared(lr)
        terms = [torch.sum(clips[b.key]) * lr2 for b in self.plan.buckets]
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

    # -- the observe monitor ---------------------------------------------

    def _method_scope(self) -> str:
        return {ComputeMethod.EIGEN: 'eigh',
                ComputeMethod.INVERSE: 'cholesky',
                ComputeMethod.ITERATIVE: 'newton_schulz'}[self.compute_method]

    def _bucket_stats(
        self, b: BucketLayout, bs: BucketSecond,
    ) -> tuple[str, dict[str, torch.Tensor]] | None:
        """``(kind, stats)`` of this rank's column of bucket ``b``
        (:mod:`~kfac_pytorch_tpu_torch.observe.monitor`), ``None`` for a
        bucket that carries no spectrum (inverse)."""
        a_dims, g_dims, occupied = self._monitor_masks(b)
        if bs.da is not None and bs.dg is not None:
            return 'eigen', observe_monitor.eigen_stack_stats(
                bs.da, bs.dg, bs.qa, bs.qg, a_dims, g_dims, occupied,
                masks=self._support_masks(b, bs, observe_monitor.eigen_masks))
        if bs.dgda is not None:
            return 'prediv', observe_monitor.prediv_stack_stats(
                bs.dgda, bs.qa, bs.qg, a_dims, g_dims, occupied,
                bs.bake_damping,
                mask=self._support_masks(b, bs, observe_monitor.prediv_mask))
        if bs.iter_res_a is not None:
            return 'iterative', observe_monitor.iterative_stack_stats(
                bs.iter_res_a, bs.iter_res_g, bs.iter_bound_a,
                bs.iter_bound_g, bs.iter_stale_a, bs.iter_stale_g,
                occupied)
        return None

    def _monitor_masks(self, b: BucketLayout):
        """``(a_dims, g_dims, occupied)`` of this rank's column of bucket
        ``b`` on the device, made once (a host copy each step would stall
        the host)."""
        cache = self._masks
        if b.key not in cache:
            first = self.grid.col * b.seg
            a_dims, g_dims = self._slot_dims[b.key]
            cache[b.key] = (
                torch.tensor(a_dims[first:first + b.seg], device=self.device),
                torch.tensor(g_dims[first:first + b.seg], device=self.device),
                torch.tensor([n is not None for n in self.local_slots(b)],
                             dtype=torch.bool, device=self.device),
            )
        return cache[b.key]

    def _support_masks(self, b: BucketLayout, bs: BucketSecond, make):
        """``make(qa, qg, a_dims, g_dims, occupied)`` of bucket ``b``, kept
        until its eigenvector stacks change (a refresh or an install gives
        new tensors, an in-place write moves their version counter): the
        support masks read every eigenvector once, which a step need not
        pay again between refreshes."""
        cache = self._support_cache
        hit = cache.get(b.key)
        stamp = (bs.qa._version, bs.qg._version)
        if hit is None or hit[0] is not bs.qa or hit[1] is not bs.qg or (
                hit[2] != stamp):
            hit = (bs.qa, bs.qg, stamp, make(bs.qa, bs.qg,
                                             *self._monitor_masks(b)))
            cache[b.key] = hit
        return hit[3]

    @staticmethod
    def _reduced_keys(kind: str, stats: Mapping[str, torch.Tensor]):
        """The keys of one bucket's stats reduced across the row: an
        eigen bucket's Kronecker extremes are products of its per-side
        extremes, so those are reduced and the products rebuilt."""
        return [k for k in sorted(stats)
                if not (kind == 'eigen' and k.startswith('kron_'))]

    def curvature_extremes_layout(
        self, buckets: Mapping[str, BucketSecond],
    ) -> list[tuple[str, str]]:
        """``(bucket key, stat)`` of each entry of the vector
        :meth:`curvature_stats` reduces over the row, in order (the same
        on every rank: it depends on the fields the method keeps)."""
        out = []
        for b in self.plan.buckets:
            kind_stats = self._bucket_stats(b, buckets[b.key])
            if kind_stats is not None:
                out += [(b.key, k) for k in self._reduced_keys(*kind_stats)]
        return out

    def curvature_stats(
        self, buckets: Mapping[str, BucketSecond], damping: float,
    ) -> dict[str, torch.Tensor]:
        """The ``observe/*`` spectrum statistics of every bucket (JAX
        ``second_order.py:1293-1345``), from the stacks the state holds —
        never a fresh ``eigh``: eigen buckets the per-side extremes
        (``observe/eig_{a,g}_{min,max}``) and the Kronecker extremes,
        prediv buckets the Kronecker extremes inverted out of ``dgda``
        with the per-slot ``bake_damping`` of their refresh, iterative
        buckets the Newton–Schulz evidence (``observe/iter_*``); inverse
        buckets carry no spectrum.  Pad dims and empty slots are masked.

        A rank holds only its grid column's slots, so with ``cols > 1``
        the per-bucket extremes (the minima negated) ride one
        ``all_reduce(MAX)`` of one ``[k]`` f32 vector over the grid row
        (:func:`~kfac_pytorch_tpu_torch.parallel.collectives.\
all_reduce_max`, the same order on every rank; billed as
        ``observe_extremes`` in the cost ledger), after which every rank
        holds JAX's global extremes; none with one column.  Device
        tensors, no host read.
        """
        per_bucket = []
        for b in self.plan.buckets:
            kind_stats = self._bucket_stats(b, buckets[b.key])
            if kind_stats is not None:
                per_bucket.append(kind_stats)
        if self.grid.cols > 1 and per_bucket:
            layout = [(i, k) for i, (kind, st) in enumerate(per_bucket)
                      for k in self._reduced_keys(kind, st)]
            vec = torch.stack([
                -per_bucket[i][1][k] if k.endswith('_min')
                else per_bucket[i][1][k] for i, k in layout
            ])
            vec = collectives.all_reduce_max(vec, self.grid.row_group)
            for j, (i, k) in enumerate(layout):
                per_bucket[i][1][k] = -vec[j] if k.endswith('_min') else vec[j]
            for kind, st in per_bucket:
                if kind == 'eigen':
                    st['kron_min'] = st['eig_a_min'] * st['eig_g_min']
                    st['kron_max'] = st['eig_a_max'] * st['eig_g_max']
        return observe_monitor.merge_extremes(
            [st for _, st in per_bucket], damping)

    # -- checkpoints ----------------------------------------------------

    def gather_stacks(
        self, buckets: Mapping[str, BucketSecond],
    ) -> dict[str, dict[str, torch.Tensor]]:
        """Every bucket's :meth:`BucketSecond.stack_fields` over all
        ``L`` slots: each rank's column gathered over its grid row in plan
        order (one all-gather per dtype, a collective every rank calls;
        none on a grid of one column).  Bool masks travel as ``uint8``."""
        names, stacks = [], []
        for b in self.plan.buckets:
            for field, t in buckets[b.key].stack_fields().items():
                names.append((b.key, field, t.dtype))
                stacks.append(t.to(torch.uint8) if t.dtype == torch.bool
                              else t)
        full = collectives.all_gather_stacks(stacks, self.grid.row_group)
        out: dict[str, dict[str, torch.Tensor]] = {}
        for (key, field, dtype), t in zip(names, full):
            out.setdefault(key, {})[field] = (
                t.bool() if dtype == torch.bool else t)
        return out

    def install_stacks(
        self,
        full: Mapping[str, Mapping[str, object]],
        like: Mapping[str, BucketSecond],
    ) -> dict[str, BucketSecond]:
        """Bucket stacks from every bucket's full ``[L, ...]`` saved
        fields (numpy arrays or tensors): this rank's column of each, in
        the dtype of ``like``'s field (a bf16 stack is saved widened to
        f32, so the cast back is exact) on :attr:`device`; under EKFAC on
        a grid with several columns the bases of the occupied slots are
        taken from the full ``qa``/``qg``, as a refresh gathers them.  No
        decomposition runs."""
        out = {}
        for b in self.plan.buckets:
            first = self.grid.col * b.seg
            tmpl = like[b.key]
            kw = {}
            for field, arr in full[b.key].items():
                t = torch.as_tensor(arr)
                kw[field] = t[first:first + b.seg].to(
                    device=self.device, dtype=getattr(tmpl, field).dtype,
                ).contiguous()
            if self.ekfac and self.grid.cols > 1:
                occ = [j for j, n in enumerate(b.slots) if n is not None]
                for side in ('qa', 'qg'):
                    kw[f'basis_{side}'] = torch.as_tensor(
                        full[b.key][side])[occ].to(
                        device=self.device, dtype=kw[side].dtype,
                    ).contiguous()
            out[b.key] = BucketSecond(**kw)
        return out

    # -- EKFAC scales ---------------------------------------------------

    def ekfac_contrib(
        self,
        bs: BucketSecond,
        name: str,
        calls: Sequence[tuple[torch.Tensor, torch.Tensor, float, float]],
    ) -> torch.Tensor:
        """Layer ``name``'s ``[g_pad, a_pad]`` scale contribution from
        its calls' ``(a_rows, g_rows, a_norm, g_norm)``, projected in its
        slot's current basis (any column's: on a grid with several
        columns its row of the gathered ``basis_qa``/``basis_qg``; ``bs``
        is its bucket's state); a module called several times contributes
        the mean over its calls.  The basis rows past the layer's dims
        are sliced off, which equals zero-padding the rows, so pure-pad
        directions get zero scale (their gradient is zero too)."""
        if bs.basis_qa is not None:
            i = self._basis_slot[name]
            qa, qg = bs.basis_qa[i], bs.basis_qg[i]
        else:
            _, slot = self.plan.slot_of[name]
            qa, qg = bs.qa[slot], bs.qg[slot]
        contribs = [
            ops.ekfac_scale_contrib(
                ar, gr, qa[:ar.shape[1]], qg[:gr.shape[1]],
                a_norm=an, g_norm=gn,
            )
            for ar, gr, an, gn in calls
        ]
        if len(contribs) == 1:
            return contribs[0]
        return torch.stack(contribs).mean(0)

    def ekfac_update(
        self,
        buckets: Mapping[str, BucketSecond],
        contribs: Mapping[str, torch.Tensor],
        decay: float,
        ok: torch.Tensor | None = None,
    ) -> None:
        """EMA of the scale grids, in place of each bucket's ``skron``:
        ``decay * old + (1 - decay) * contrib`` for every layer in
        ``contribs`` (its mean contribution of the step); a slot without
        one keeps its scales, and with the health verdict ``ok`` False
        every slot does."""
        for b in self.plan.buckets:
            bs = buckets[b.key]
            names = self.local_slots(b)
            if bs.skron is None or not any(n in contribs for n in names):
                continue
            new = torch.stack([
                decay * old + (1.0 - decay) * contribs[n]
                if n in contribs else old
                for n, old in zip(names, bs.skron)
            ])
            bs.skron = new if ok is None else torch.where(ok, new, bs.skron)

    def ekfac_divergence(
        self, buckets: Mapping[str, BucketSecond],
    ) -> torch.Tensor:
        """Relative Frobenius drift of the scale grids from their refresh
        seed, ``sqrt(sum ||S - dg ⊗ da||^2 / sum ||dg ⊗ da||^2)`` over
        the logical entries of occupied slots (a device scalar).  Padded
        dims are masked out: their seed is the identity pad's eigenvalue
        1 while their projections are zero, so they would read as drift.

        Each rank sums its column's slots per bucket, the ``(num, den)``
        pairs of every column are gathered over the grid row (a no-op on
        a grid of one column), and every rank adds them in (bucket,
        column) order: the same bits on every rank, so a drift-triggered
        refresh is decided alike everywhere.
        """
        parts = torch.stack(self._ekfac_drift_terms(buckets))
        (every,) = collectives.all_gather_stacks(
            [parts], self.grid.row_group,
        )
        every = every.view(self.grid.cols, *parts.shape)
        num = torch.zeros((), device=self.device)
        den = torch.zeros((), device=self.device)
        for i in range(parts.shape[0]):
            for c in range(self.grid.cols):
                num = num + every[c, i, 0]
                den = den + every[c, i, 1]
        return torch.sqrt(num / (den + 1e-30))

    def _ekfac_drift_terms(
        self, buckets: Mapping[str, BucketSecond],
    ) -> list[torch.Tensor]:
        """Per bucket with scales, ``[sum ||S - seed||^2, sum ||seed||^2]``
        over this rank's column slots (:meth:`ekfac_divergence`)."""
        terms = []
        for b in self.plan.buckets:
            bs = buckets[b.key]
            if bs.skron is None:
                continue
            names = self.local_slots(b)
            first = self.grid.col * b.seg
            a_dims, g_dims = self._slot_dims[b.key]
            occ = torch.tensor(
                [n is not None for n in names], device=self.device,
            )[:, None, None]
            ad = torch.tensor(a_dims[first:first + len(names)],
                              device=self.device)[:, None, None]
            gd = torch.tensor(g_dims[first:first + len(names)],
                              device=self.device)[:, None, None]
            mask = (
                (torch.arange(b.g_pad, device=self.device)[None, :, None]
                 < gd)
                & (torch.arange(b.a_pad, device=self.device)[None, None, :]
                   < ad)
                & occ
            ).float()
            seed = bs.dg.float()[:, :, None] * bs.da.float()[:, None, :]
            seed = seed * mask
            drift = bs.skron * mask - seed
            terms.append(torch.stack([torch.sum(drift * drift),
                                      torch.sum(seed * seed)]))
        return terms

    def memory_usage(self, buckets: Mapping[str, BucketSecond]) -> int:
        """Bytes of stacked second-order state on this rank: every field
        that is set."""
        return sum(
            t.numel() * t.element_size()
            for bs in buckets.values()
            for t in bs.tensors().values()
        )
