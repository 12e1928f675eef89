"""The KAISA collectives on explicit ``torch.distributed`` groups.

What GSPMD inserts for the JAX package when it reshards the bucket
stacks over the grid (``kfac_pytorch_tpu/parallel/second_order.py``,
phases 1-4), and what the original library's ``kfac/distributed.py``
issued by hand:

* :func:`all_reduce_mean` — the factor all-reduce over the world, all
  factors through one flat buffer per dtype;
* :func:`all_gather_decompositions` — phase 2: a column's ranks each
  decompose a share of the column's slots and gather the rest;
* :func:`all_gather_preconditioned` — phase 4: a row's ranks each
  precondition their column's slots and gather the other columns'.

Every all-gather moves equal sizes from every rank: uneven shares are
padded with identity slots (square eigenvector and inverse stacks) and
zero slots (eigenvalues, per-slot vectors, EKFAC scales and the thin
``[a, k]`` eigenvector stacks of low-rank buckets), and bucket plans
already pad every column to ``seg`` slots (zero gradient slots).  For
the all-gathers a group of ``None`` (a
grid axis of extent 1, which gets no group) or of one rank moves
nothing; for the all-reduce ``None`` is the default group, the world.
Collectives take CUDA tensors on NCCL and on gloo alike.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _group_size(group) -> int:
    """Ranks in ``group`` (``None``: the default group); 1 without
    ``torch.distributed``."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _gathers(group) -> bool:
    return group is not None and _group_size(group) > 1


def _by_dtype(tensors: Sequence[torch.Tensor]) -> dict:
    """dtype -> indices, in order of first appearance (the same on every
    rank when the tensor lists agree)."""
    out: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def all_reduce_mean(
    tensors: Sequence[torch.Tensor], group=None,
) -> list[torch.Tensor]:
    """Mean of each tensor over the ranks of ``group`` (default: the
    world), one ``all_reduce`` per dtype over a flat buffer."""
    n = _group_size(group)
    if n == 1:
        return list(tensors)
    out: list[torch.Tensor] = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)
        offset = 0
        for i in idx:
            numel = tensors[i].numel()
            out[i] = flat[offset:offset + numel].view(tensors[i].shape)
            offset += numel
    return out


def all_gather_stacks(
    stacks: Sequence[torch.Tensor], group,
) -> list[torch.Tensor]:
    """Concatenate every rank's ``[k, ...]`` stacks along dim 0, in
    group-rank order: ``[n * k, ...]`` each, one
    ``all_gather_into_tensor`` per dtype.  Every rank passes the same
    shapes."""
    if not _gathers(group):
        return list(stacks)
    n = _group_size(group)
    out: list[torch.Tensor] = [None] * len(stacks)
    for idx in _by_dtype(stacks).values():
        local = torch.cat([stacks[i].reshape(-1) for i in idx])
        gathered = torch.empty(
            n * local.numel(), dtype=local.dtype, device=local.device,
        )
        dist.all_gather_into_tensor(gathered, local, group=group)
        gathered = gathered.view(n, local.numel())
        offset = 0
        for i in idx:
            t = stacks[i]
            numel = t.numel()
            out[i] = gathered[:, offset:offset + numel].reshape(
                n * t.shape[0], *t.shape[1:],
            )
            offset += numel
    return out


def share_bounds(n_slots: int, parts: int, index: int) -> tuple[int, int]:
    """``[start, stop)`` of share ``index`` when ``n_slots`` split into
    ``parts`` shares of ``ceil(n_slots / parts)`` (the last ones may be
    short or empty)."""
    per = -(-n_slots // parts)
    start = min(index * per, n_slots)
    return start, min(start + per, n_slots)


def _pad_slots(x: torch.Tensor, per: int, identity: bool) -> torch.Tensor:
    """``x`` padded to ``per`` slots: identity blocks when ``identity``
    and the blocks are square, zeros otherwise (a thin ``[a, k]``
    low-rank eigenvector stack has no identity; its padding slots reach
    no result, so zeros serve)."""
    k = x.shape[0]
    if k == per:
        return x
    if identity and x.ndim == 3 and x.shape[-1] == x.shape[-2]:
        pad = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        pad = pad.expand(per - k, *x.shape[1:])
    else:
        pad = x.new_zeros((per - k, *x.shape[1:]))
    return torch.cat([x, pad])


def all_gather_decompositions(
    shares: Sequence[tuple[torch.Tensor, ...]],
    segs: Sequence[int],
    group,
    identity: Sequence[Sequence[bool]],
) -> list[tuple[torch.Tensor, ...]]:
    """Phase 2: every bucket's decomposition stacks over a grid column.

    ``shares[i]`` holds this rank's slots of bucket ``i``'s column slice
    (:func:`share_bounds` of ``segs[i]`` over the column's ranks): one
    ``[share, ...]`` stack per field of the method, such as ``(qa, qg,
    dgda)`` or ``(a_inv, g_inv)``.  ``identity[i][j]`` says whether
    field ``j`` of bucket ``i`` pads with identity blocks (square stacks:
    eigenvectors, inverses) or with zeros (eigenvalues, per-slot
    vectors; :func:`_pad_slots`).  Each share
    is padded to ``ceil(seg / rows)`` slots, all buckets go in one
    all-gather, and the result is trimmed back to ``seg`` slots.
    """
    if not _gathers(group):
        return [tuple(s) for s in shares]
    n = _group_size(group)
    flat: list[torch.Tensor] = []
    for share, seg, eyes in zip(shares, segs, identity):
        per = -(-seg // n)
        flat += [_pad_slots(t, per, eye) for t, eye in zip(share, eyes)]
    gathered = iter(all_gather_stacks(flat, group))
    return [
        tuple(next(gathered)[:seg] for _ in share)
        for share, seg in zip(shares, segs)
    ]


def all_gather_preconditioned(
    pg: torch.Tensor, clip: torch.Tensor, group,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 4: one bucket's ``pg [seg, gp, ap]`` and per-slot clip
    terms ``[seg]`` over a grid row, into the full ``[cols * seg, ...]``
    stacks in column order (the plan's slot order), in one all-gather."""
    if not _gathers(group):
        return pg, clip
    seg = pg.shape[0]
    packed = torch.cat([pg.reshape(seg, -1), clip[:, None]], dim=1)
    (full,) = all_gather_stacks([packed], group)
    return (
        full[:, :-1].reshape(full.shape[0], *pg.shape[1:]),
        full[:, -1].contiguous(),
    )
