"""The KAISA collectives on explicit ``torch.distributed`` groups.

What GSPMD inserts for the JAX package when it reshards the bucket
stacks over the grid (``kfac_pytorch_tpu/parallel/second_order.py``,
phases 1-4), and what the original library's ``kfac/distributed.py``
issued by hand:

* :func:`all_reduce_mean` — the factor all-reduce over the world, all
  factors through one flat buffer per dtype;
* :func:`all_reduce_sum_triu` — its compressed form
  (``factor_comm='bf16_triu'``): packed upper triangles summed in bf16;
* :func:`all_gather_decompositions` — phase 2: a column's ranks each
  decompose a share of the column's slots and gather the rest;
* :func:`all_gather_preconditioned` — phase 4: a row's ranks each
  precondition their column's slots and gather the other columns';
* :func:`all_reduce_max` — the observe monitor's spectrum extremes over a
  grid row (a rank holds only its column's slots).

:func:`all_gather_stacks_async` and :func:`all_gather_preconditioned_async`
issue the same gathers with ``async_op=True`` (``pipeline_grads``): they
return a :class:`GatherHandle` whose ``wait()`` gives what the
synchronous call returns, the same bytes in the same order.  Waiting on a
handle orders the caller's current CUDA stream after the gather (the
backend's work handle does that for NCCL and for gloo's CUDA path alike).
A backend that refuses an asynchronous gather raises; nothing falls back
to the synchronous call.

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


def group_size(group) -> int:
    """Ranks in ``group`` (``None``: the default group); 1 without
    ``torch.distributed``."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def group_extent(group) -> int:
    """Ranks in ``group``, where ``None`` is one rank (an axis of extent
    1 gets no group), unlike :func:`group_size`'s default group."""
    return 1 if group is None else group_size(group)


def mean_over(tensors: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """:func:`all_reduce_mean` over ``group``, where ``None`` is one rank
    (:func:`group_extent`): the tensors themselves."""
    if group_extent(group) == 1:
        return list(tensors)
    return all_reduce_mean(tensors, group)


def _gathers(group) -> bool:
    return group is not None and group_size(group) > 1


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
    n = group_size(group)
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


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``t`` over the ranks of ``group``, one
    ``all_reduce(MAX)`` (a new tensor); a group of ``None`` or of one rank
    moves nothing and returns ``t``."""
    if not _gathers(group):
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_reduce_sum_triu(
    factors: Sequence[torch.Tensor],
    group=None,
    comm_dtype: torch.dtype = torch.bfloat16,
) -> list[torch.Tensor]:
    """Sum of each symmetric ``[d, d]`` factor over the ranks of
    ``group`` (default: the world) on a compressed wire (the reduction
    of JAX ``ops.cov.cov_psum_compressed``): each factor is symmetrized,
    its upper triangle packed and cast to ``comm_dtype``, all of them go
    through one ``all_reduce(SUM)`` in ``comm_dtype``, and each comes
    back unpacked in f32.  The wire moves ``d(d+1)/2`` elements of 2
    bytes per factor instead of ``d^2`` of 4.

    The sum runs in ``comm_dtype`` on purpose.  A backend that refuses
    the dtype raises: an upcast to f32 would be a different, lossless
    result.
    """
    from kfac_pytorch_tpu_torch.ops.triu import fill_triu
    from kfac_pytorch_tpu_torch.ops.triu import get_triu

    packed = [get_triu(0.5 * (f + f.mT)).to(comm_dtype) for f in factors]
    flat = torch.cat(packed)
    if group_size(group) > 1:
        try:  # spmd: collective-safe(the handler re-raises at once with the backend named: no rank re-enters the collective)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        except (RuntimeError, ValueError) as exc:
            raise RuntimeError(
                f'the {dist.get_backend(group)} backend refused an '
                f'all_reduce in {comm_dtype} (factor_comm needs the sum '
                'on the wire in that dtype; an f32 upcast would be a '
                f'different, lossless result): {exc}',
            ) from exc
    out, offset = [], 0
    for f, p in zip(factors, packed):
        out.append(fill_triu(
            tuple(f.shape), flat[offset:offset + p.numel()].float(),
        ))
        offset += p.numel()
    return out


class GatherHandle:
    """An asynchronous gather: :meth:`wait` waits on the backend's work
    handles (none for a gather that moved nothing), then returns the
    result ``finish()`` builds from the gathered buffers."""

    def __init__(self, works: Sequence, finish) -> None:
        self._works = list(works)
        self._finish = finish
        self._done = False
        self._result = None

    def wait(self):
        if not self._done:
            for work in self._works:
                work.wait()
            self._result = self._finish()
            self._done = True
            self._works = []
            self._finish = None
        return self._result


def _gather_flat(stacks, group, async_op: bool):
    """The gathers of :func:`all_gather_stacks`: ``(works, finish)``,
    ``finish()`` slicing the gathered flat buffers back into stacks."""
    n = group_size(group)
    out: list[torch.Tensor] = [None] * len(stacks)
    works, pieces = [], []
    for idx in _by_dtype(stacks).values():
        local = torch.cat([stacks[i].reshape(-1) for i in idx])
        gathered = torch.empty(
            n * local.numel(), dtype=local.dtype, device=local.device,
        )
        if not async_op:
            dist.all_gather_into_tensor(gathered, local, group=group)
        else:
            try:  # spmd: collective-safe(the handler re-raises at once with the backend named: no rank re-enters the collective)
                work = dist.all_gather_into_tensor(
                    gathered, local, group=group, async_op=True,
                )
            except (RuntimeError, ValueError) as exc:
                raise RuntimeError(
                    f'the {dist.get_backend(group)} backend refused an '
                    f'asynchronous all_gather_into_tensor of '
                    f'{local.device.type} tensors (pipeline_grads issues '
                    'every gradient gather asynchronously and does not '
                    f'fall back to the synchronous call): {exc}',
                ) from exc
            if work is None:
                raise RuntimeError(
                    f'the {dist.get_backend(group)} backend returned no work '
                    'handle for an asynchronous all_gather_into_tensor',
                )
            # The buffers stay referenced until the handle is waited on.
            works.append(work)
        pieces.append((idx, local, gathered))

    def finish() -> list[torch.Tensor]:
        for idx, local, gathered in pieces:
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
    return works, finish


def all_gather_stacks(
    stacks: Sequence[torch.Tensor], group,
) -> list[torch.Tensor]:
    """Concatenate every rank's ``[k, ...]`` stacks along dim 0, in
    group-rank order: ``[n * k, ...]`` each, one
    ``all_gather_into_tensor`` per dtype.  Every rank passes the same
    shapes."""
    if not _gathers(group):
        return list(stacks)
    _, finish = _gather_flat(stacks, group, async_op=False)
    return finish()


def all_gather_stacks_async(
    stacks: Sequence[torch.Tensor], group,
) -> GatherHandle:
    """:func:`all_gather_stacks` issued with ``async_op=True``: a handle
    whose ``wait()`` returns the same stacks.  A group of ``None`` or of
    one rank gives a handle that is already done."""
    if not _gathers(group):
        return GatherHandle((), lambda: list(stacks))
    return GatherHandle(*_gather_flat(stacks, group, async_op=True))


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
    n = group_size(group)
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
    return _unpack_preconditioned(full, pg.shape)


def _unpack_preconditioned(full, shape) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        full[:, :-1].reshape(full.shape[0], *shape[1:]),
        full[:, -1].contiguous(),
    )


def all_gather_preconditioned_async(
    pg: torch.Tensor, clip: torch.Tensor, group,
) -> GatherHandle:
    """:func:`all_gather_preconditioned` issued with ``async_op=True``: a
    handle whose ``wait()`` returns the same ``(pg, clip)``, the same bytes
    in the same column order.  A group of ``None`` or of one rank gives a
    handle that is already done."""
    if not _gathers(group):
        return GatherHandle((), lambda: (pg, clip))
    seg = pg.shape[0]
    packed = torch.cat([pg.reshape(seg, -1), clip[:, None]], dim=1)
    works, finish = _gather_flat([packed], group, async_op=True)
    return GatherHandle(
        works, lambda: _unpack_preconditioned(finish()[0], pg.shape),
    )
