"""Megatron-style tensor parallelism over a ``model`` process group.

The counterpart of the JAX package's ``'model'`` mesh axis, which GSPMD
gives it through the logical axis rules of
``kfac_pytorch_tpu/models/gpt.py:42-49``: attention ``qkv`` and the MLP's
``fc_in`` are column-parallel (output features split over the group),
``proj`` and ``fc_out`` row-parallel (input features split).  Here the
split is explicit, as Megatron-LM writes it (Shoeybi et al., 2019):

* :class:`ColumnParallelDense` holds ``out / tp`` rows of the weight and
  its input goes through :func:`copy_to_region` (identity forward,
  all-reduce of the input gradient backward);
* :class:`RowParallelDense` holds ``in / tp`` columns of the weight and
  its partial products go through :func:`reduce_from_region` (all-reduce
  forward, identity backward), with the bias added once after it.

``qkv`` is split by heads (``parts=3``): rank ``r`` holds the q, k and v
columns of heads ``[r H/tp, (r + 1) H/tp)``, so its attention runs on its
own heads, and every gather of ``qkv``'s output side puts the columns
back in JAX's ``q|k|v`` order (:func:`gather_features`).

K-FAC sees the full layers (:mod:`~kfac_pytorch_tpu_torch.layers.tensor`):
the helpers gather the sharded side of each factor's statistics and of
each weight gradient over the group.  :data:`GATHER_STATS` counts the
gathers' bytes.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu_torch.parallel import collectives

#: Gathers made by the K-FAC helpers of the parallel layers: per kind
#: (``'factor'``, on factor steps; ``'grad'``, each step), the count and
#: the bytes of the gathered (full) tensors each rank receives.
GATHER_STATS: dict[str, list[int]] = {'factor': [0, 0], 'grad': [0, 0]}


def reset_gather_stats() -> None:
    """Set every count of :data:`GATHER_STATS` to 0."""
    for v in GATHER_STATS.values():
        v[0] = v[1] = 0


def group_rank_size(group: Any) -> tuple[int, int]:
    """``(rank in group, group size)``; ``(0, 1)`` for ``None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), collectives.group_extent(group)


def all_gather_first(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``[tp, *x.shape]``: every rank's ``x`` in group-rank order."""
    (full,) = collectives.all_gather_stacks([x[None]], group)
    return full


def gather_features(x: torch.Tensor, group: Any, parts: int = 1,
                    dim: int = -1, kind: str | None = None) -> torch.Tensor:
    """The full tensor from each rank's shard of dimension ``dim``.

    With ``parts > 1`` the dimension is ``parts`` blocks (``qkv``'s q, k
    and v) and each rank holds its slice of every block, so the result
    is ``[block 0 of ranks 0..tp-1 | block 1 ... ]``: the unsharded
    order.  ``kind`` counts the gathered bytes in :data:`GATHER_STATS`.
    """
    dim = dim % x.ndim
    full = all_gather_first(x, group)  # [tp, ..., local, ...]
    tp = full.shape[0]
    if kind is not None:
        GATHER_STATS[kind][0] += 1
        GATHER_STATS[kind][1] += full.numel() * full.element_size()
    local = x.shape[dim]
    # [tp, ..., parts, local / parts, ...] -> [..., parts, tp, local/parts]
    full = full.reshape(*full.shape[:dim + 1], parts, local // parts,
                        *full.shape[dim + 2:])
    full = full.movedim(0, dim + 1)
    return full.reshape(*x.shape[:dim], tp * local, *x.shape[dim + 1:])


def shard_features(x: torch.Tensor, rank: int, tp: int, parts: int = 1,
                   dim: int = -1) -> torch.Tensor:
    """Rank ``rank``'s shard of dimension ``dim`` (the inverse of
    :func:`gather_features`): its ``1 / tp`` slice of each of the
    ``parts`` blocks."""
    dim = dim % x.ndim
    size = x.shape[dim]
    if size % (parts * tp):
        raise ValueError(
            f'dim {dim} (size {size}) not divisible into {parts} part(s) '
            f'over {tp} ranks',
        )
    step = size // parts
    width = step // tp
    pieces = [x.narrow(dim, p * step + rank * width, width)
              for p in range(parts)]
    return torch.cat(pieces, dim=dim) if parts > 1 else pieces[0]


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromRegion(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_region(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's ``copy_to_tensor_model_parallel_region``."""
    if group_rank_size(group)[1] == 1:
        return x
    return _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's ``reduce_from_tensor_model_parallel_region``."""
    if group_rank_size(group)[1] == 1:
        return x
    return _ReduceFromRegion.apply(x, group)


class ParallelDense(nn.Linear):
    """Base of the two parallel layers: an ``nn.Linear`` holding this
    rank's shard, computing in ``compute_dtype`` as
    :class:`~kfac_pytorch_tpu_torch.models.layers.Dense` does.

    Attributes:
        full_in: the layer's unsharded input width.
        full_out: its unsharded output width.
        group: the model group.
        tp: the group's size; ``tp_rank`` this rank's index in it.
        parts: blocks of the split dimension (3 for ``qkv``).
    """

    def __init__(self, local_in: int, local_out: int, full_in: int,
                 full_out: int, compute_dtype: torch.dtype, group: Any,
                 parts: int = 1) -> None:
        super().__init__(local_in, local_out, bias=True)
        self.compute_dtype = compute_dtype
        self.full_in, self.full_out = full_in, full_out
        self.group = group
        self.tp_rank, self.tp = group_rank_size(group)
        self.parts = parts

    def _linear(self, x: torch.Tensor, bias: torch.Tensor | None):
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd),
                        None if bias is None else bias.to(cd))


class ColumnParallelDense(ParallelDense):
    """Output features split over the group: ``weight [out/tp, in]``,
    ``bias [out/tp]``; with ``parts`` blocks, each rank's slice of every
    block (:func:`shard_features`)."""

    split = 'column'

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype, group: Any,
                 parts: int = 1) -> None:
        _, tp = group_rank_size(group)
        if out_features % (parts * tp):
            raise ValueError(
                f'out_features {out_features} not divisible into {parts} '
                f'part(s) over {tp} ranks',
            )
        super().__init__(in_features, out_features // tp, in_features,
                         out_features, compute_dtype, group, parts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._linear(copy_to_region(x, self.group), self.bias)


class RowParallelDense(ParallelDense):
    """Input features split over the group: ``weight [out, in/tp]``; the
    partial products summed over the group, then the (replicated) bias
    added once."""

    split = 'row'

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype, group: Any) -> None:
        _, tp = group_rank_size(group)
        if in_features % tp:
            raise ValueError(
                f'in_features {in_features} not divisible over {tp} ranks',
            )
        super().__init__(in_features // tp, out_features, in_features,
                         out_features, compute_dtype, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_region(self._linear(x, None), self.group)
        return y + self.bias.to(self.compute_dtype)


def shard_dense_state(weight: torch.Tensor, bias: torch.Tensor,
                      split: str, rank: int, tp: int,
                      parts: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s ``(weight, bias)`` of a full ``[out, in]`` dense
    layer: rows (``'column'``, head-aware with ``parts``) or columns
    (``'row'``, the bias whole)."""
    if split == 'column':
        return (shard_features(weight, rank, tp, parts, dim=0),
                shard_features(bias, rank, tp, parts, dim=0))
    return shard_features(weight, rank, tp, dim=1), bias


def shard_state_dict(
    sd: dict[str, torch.Tensor], rank: int, tp: int,
    layers: tuple[tuple[str, str, int], ...],
) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s state dict of a ``tp``-way tensor-parallel model
    from the unsharded one: every dense layer whose name ends in a
    ``(suffix, split, parts)`` of ``layers`` is cut by
    :func:`shard_dense_state`; the rest stays whole."""
    out = dict(sd)
    for key in sd:
        for layer, split, parts in layers:
            if key.endswith(f'.{layer}.weight'):
                stem = key[:-len('weight')]
                w, b = shard_dense_state(sd[key], sd[stem + 'bias'], split,
                                         rank, tp, parts)
                out[key], out[stem + 'bias'] = w.contiguous(), b.contiguous()
    return out


def local_heads(n_heads: int, group: Any) -> int:
    """Heads a rank of ``group`` holds (``n_heads / tp``)."""
    _, tp = group_rank_size(group)
    if n_heads % tp:
        raise ValueError(f'n_heads {n_heads} not divisible over {tp} ranks')
    return n_heads // tp

