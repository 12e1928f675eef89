"""Ring attention: sequence-parallel causal self-attention.

Port of ``kfac_pytorch_tpu/parallel/ring_attention.py`` (Liu et al.,
"Ring Attention with Blockwise Transformers", 2023).  Each rank of a
sequence group holds one shard ``[B, T/n, H, D]`` of Q, K and V.  The
K/V shards rotate around the ring while each rank accumulates its Q
shard's attention over every K/V block with an online softmax in f32, so
the ``T x T`` score matrix never materializes.  The order is the JAX
package's: K/V start at the rank's own shard, and block ``j`` holds the
shard of rank ``(idx + j) % n`` (JAX's ``ppermute`` with ``perm = [(i,
(i - 1) % n)]``: every rank hands its block to ``idx - 1``), so the
accumulation order and the rounding are the same.  JAX's last rotation
is dead (its result is never read) and is skipped here.

The products are plain ``torch.einsum`` calls, as JAX computes them with
``jnp.einsum`` outside any Pallas kernel.

The rotation is a ``torch.autograd.Function``: the forward hands the
block to ``idx - 1`` and takes ``idx + 1``'s, the backward hands the
block's gradient the other way, so each rank's K/V gradient sums every
rank's loss through it.  :class:`RingLinks` picks the hand-off from the
backend, as :class:`~kfac_pytorch_tpu_torch.parallel.pipeline.PipeLinks`
does: on NCCL one ``batch_isend_irecv`` of a send and a receive; on
gloo, whose ``send``/``recv`` read a CUDA tensor's device pointer as
host memory (``chip_probes/p2p_probe.py``), one ``broadcast`` over each
two-rank edge group ``{e, e + 1 mod n}``: a rank issues its two edges'
broadcasts asynchronously, in ascending edge order, then waits for both.
Each edge group carries exactly one broadcast of its two ranks a
rotation, so no group waits on another.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

# Finite mask value: keeps the online-softmax max finite even for rows
# whose every key is masked (such rows renormalize to an all-zero
# contribution instead of NaN).
_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _block_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int,
    kv_offset: int,
    causal: bool,
    m: torch.Tensor,
    l: torch.Tensor,  # noqa: E741
    acc: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Accumulate one K/V block into the online-softmax state.

    ``q``: ``[B, Tq, H, D]``; ``k``/``v``: ``[B, Tk, H, D]``; the offsets
    are the blocks' global sequence positions.  State: running row max
    ``m`` ``[B, H, Tq]``, normalizer ``l`` ``[B, H, Tq]``, accumulator
    ``acc`` ``[B, Tq, H, D]``, all f32.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum('bqhd,bkhd->bhqk', (q * scale).float(), k.float())
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        logits = torch.where(mask[None, None], logits,
                             torch.full((), _MASK_VALUE, device=q.device))
    m_block = torch.amax(logits, dim=-1)
    m_new = torch.maximum(m, m_block)
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * alpha + torch.sum(p, dim=-1)
    pv = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    acc_new = acc * alpha.permute(0, 2, 1)[..., None] + pv
    return m_new, l_new, acc_new


def _finish(l: torch.Tensor, acc: torch.Tensor,  # noqa: E741
            dtype: torch.dtype) -> torch.Tensor:
    l = torch.clamp(l, min=1e-30)  # noqa: E741
    return (acc / l.permute(0, 2, 1)[..., None]).to(dtype)


def _init_state(q: torch.Tensor):
    B, t, H, _ = q.shape
    m = torch.full((B, H, t), _MASK_VALUE, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, t), dtype=torch.float32,  # noqa: E741
                    device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    return m, l, acc


class RingLinks:
    """The rotation hand-offs of one rank of a sequence group.

    Args:
        ranks: the global ranks of the group, by sequence index.
        index: this rank's sequence index.
        group: the sequence group.

    On gloo, :func:`sequence_links` makes the edge groups
    (collectively, in the same order on every rank of the world).
    ``sent_bytes`` adds up the bytes this rank handed on, forward and
    backward.
    """

    def __init__(self, ranks: Sequence[int], index: int,
                 group: Any = None) -> None:
        self.ranks = list(ranks)
        self.n = len(self.ranks)
        self.index = index
        self.group = group
        self.backend = dist.get_backend(group) if self.n > 1 else None
        #: gloo: the two-rank group of edge ``e = {e, e + 1 mod n}``.
        self.edges: list[Any] = [None] * self.n
        self.sent_bytes = 0
        self.rotations = 0

    def shift(self, t: torch.Tensor, toward_lower: bool) -> torch.Tensor:
        """``t`` handed to ``index - 1`` (``toward_lower``) or to
        ``index + 1``; returns the block the other neighbour handed."""
        t = t.contiguous()
        out = torch.empty_like(t)
        n, i = self.n, self.index
        self.sent_bytes += t.numel() * t.element_size()
        self.rotations += 1
        if self.backend == 'gloo':
            # Edge e joins e and e + 1; toward_lower, e + 1 is the source.
            works = []
            for e in sorted({(i - 1) % n, i}):
                src = (e + 1) % n if toward_lower else e
                buf = t if src == i else out
                works.append(dist.broadcast(buf, self.ranks[src],
                                            group=self.edges[e],
                                            async_op=True))
            for w in works:
                w.wait()
            return out
        dst = (i - 1) % n if toward_lower else (i + 1) % n
        src = (i + 1) % n if toward_lower else (i - 1) % n
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, self.ranks[dst], self.group),
            dist.P2POp(dist.irecv, out, self.ranks[src], self.group),
        ])
        for w in works:
            w.wait()
        return out


def sequence_links(grid: Any, axis: str | None = None) -> RingLinks:
    """This rank's :class:`RingLinks` along ``axis`` (default the inner
    one) of an :class:`~kfac_pytorch_tpu_torch.parallel.mesh.AxisGroups`
    grid: ``axis_groups(1, n)`` for a sequence world of ``n``,
    ``axis_groups(d, n, names=('data', 'seq'))`` for ``d`` data groups of
    ``n``.  On gloo every rank makes every edge group of every sequence
    group, in the same order (``dist.new_group`` is collective over the
    world)."""
    axis = grid.names[1] if axis is None else axis
    groups = grid.axis_ranks(axis)
    mine = next(r for r in groups if grid.rank in r)
    links = RingLinks(mine, mine.index(grid.rank), grid.group(axis))
    if links.backend == 'gloo':
        for ranks in groups:
            n = len(ranks)
            for e in range(n):
                g = dist.new_group(sorted({ranks[e], ranks[(e + 1) % n]}))
                if ranks == mine:
                    links.edges[e] = g
    return links


class _Rotate(torch.autograd.Function):
    """Forward: the block to ``idx - 1``, ``idx + 1``'s back; backward:
    the gradient to ``idx + 1``, ``idx - 1``'s back."""

    @staticmethod
    def forward(ctx, x, links):
        ctx.links = links
        return links.shift(x, toward_lower=True)

    @staticmethod
    def backward(ctx, grad):
        return ctx.links.shift(grad, toward_lower=False), None


def ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    links: RingLinks | None = None,
) -> torch.Tensor:
    """Causal self-attention, ring-parallel over a sequence group.

    Args:
        q/k/v: ``[batch, seq, heads, head_dim]``: this rank's shard of
            the sequence (``seq = T / n``, rank ``idx`` holding positions
            ``[idx * seq, (idx + 1) * seq)``), or the whole sequence when
            ``links`` is ``None``.
        causal: apply the autoregressive mask.
        links: the rank's :class:`RingLinks`; ``None`` (or a group of
            one) is the single-block path, the same arithmetic on one
            block.

    Returns the ``[batch, seq, heads, head_dim]`` output of this rank's
    shard in ``q``'s dtype.
    """
    m, l, acc = _init_state(q)  # noqa: E741
    if links is None or links.n == 1:
        m, l, acc = _block_attend(q, k, v, 0, 0, causal, m, l, acc)
        return _finish(l, acc, q.dtype)
    n, idx, t = links.n, links.index, q.shape[1]
    kv = torch.stack([k, v])
    for j in range(n):
        kv_offset = ((idx + j) % n) * t
        m, l, acc = _block_attend(q, kv[0], kv[1], idx * t, kv_offset,
                                  causal, m, l, acc)
        if j < n - 1:
            kv = _Rotate.apply(kv, links)
    return _finish(l, acc, q.dtype)
