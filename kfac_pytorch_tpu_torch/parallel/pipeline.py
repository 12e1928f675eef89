"""Pipeline parallelism: the GPipe schedule over a pipe process group.

Port of ``kfac_pytorch_tpu/parallel/pipeline.py``.  The JAX package runs
GPipe as a ``lax.scan`` over ``T = M + S - 1`` ticks whose hand-off is a
``ppermute`` ring shift, with the backward pipeline falling out of
autodiff; bubble ticks compute on garbage and K-FAC masks them with
:func:`valid_tick_mask`.  Here the schedule is explicit: stage ``s``
runs microbatch ``t - s`` at tick ``t`` only when that is a valid tick
and hands its activation to stage ``s + 1`` (:class:`PipeLinks`); after
all ``M`` forwards the last stage runs the loss and its backward, and
each stage hands every microbatch's input gradient to ``s - 1``, which
runs ``torch.autograd.backward`` on its output for that microbatch.
Bubble ticks compute nothing, so a stage's statistics are its ``M``
valid microbatches: JAX's masked statistics.

:class:`PipeLinks` picks the hand-off from the backend: on NCCL a
``send``/``recv`` pair; on gloo, whose ``send``/``recv`` read a CUDA
tensor's device pointer as host memory (``chip_probes/p2p_probe.py``),
a ``broadcast`` from ``s`` over the two-rank group ``{s, s + 1}``, one
group per edge, made once in the same order on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist


def num_ticks(n_stages: int, n_microbatches: int) -> int:
    """Length of the GPipe schedule: ``M + S - 1``."""
    return n_microbatches + n_stages - 1


def valid_tick_mask(n_stages: int, n_microbatches: int) -> torch.Tensor:
    """``[S, T]`` bool: stage ``s`` holds real data at tick ``t``
    (``0 <= t - s < M``); each stage has exactly ``M`` valid ticks."""
    ticks = torch.arange(num_ticks(n_stages, n_microbatches))
    stages = torch.arange(n_stages)[:, None]
    return (ticks >= stages) & (ticks - stages < n_microbatches)


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """``[B, ...] -> [M, B/M, ...]`` (leading-dim split, order kept)."""
    if x.shape[0] % n_microbatches != 0:
        raise ValueError(
            f'batch {x.shape[0]} not divisible by n_microbatches '
            f'{n_microbatches}',
        )
    return x.reshape(
        n_microbatches, x.shape[0] // n_microbatches, *x.shape[1:],
    )


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`microbatch`."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def stage_generator(seed: int, stage: int,
                    device: Any = 'cpu') -> torch.Generator:
    """The generator stage ``stage``'s parameters are drawn from: its own
    seed per stage, so a rank holding one stage draws what a process
    holding all of them draws for it (JAX splits one key per stage)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + int(stage))
    return gen


def stack_stage_init(
    init_fn: Callable[[int, torch.Generator], Any],
    seed: int,
    n_stages: int,
    stages: Sequence[int] | None = None,
    device: Any = 'cpu',
) -> list[Any]:
    """``[init_fn(s, stage_generator(seed, s)) for s in stages]``
    (default every stage): independent per-stage initializations, the
    counterpart of JAX's ``vmap`` over split keys."""
    stages = range(n_stages) if stages is None else stages
    return [init_fn(s, stage_generator(seed, s, device)) for s in stages]


class PipeLinks:
    """The hand-offs of one rank between adjacent pipe stages.

    Args:
        pipe_ranks: the global ranks of this rank's pipe group, by stage.
        stage: this rank's stage.
        group: the pipe group (for the collectives over all stages).

    Every rank of the world must build its links at the same point
    (on gloo :func:`build_pipe_links` makes the edge groups, collectively).
    ``handoff_bytes`` lists the bytes of every activation this rank
    sent forward.
    """

    def __init__(self, pipe_ranks: Sequence[int], stage: int,
                 group: Any = None) -> None:
        self.ranks = list(pipe_ranks)
        self.group = group
        self.n_stages = len(self.ranks)
        self.stage = stage
        self.handoff_bytes: list[int] = []
        self.backend = (dist.get_backend() if self.n_stages > 1
                        else None)
        # gloo: one two-rank group per edge, made by build_pipe_links.
        self.edges: list[Any] = [None] * (self.n_stages - 1)

    def _handoff(self, t: torch.Tensor, edge: int, src_stage: int) -> None:
        src = self.ranks[src_stage]
        if self.backend == 'gloo':
            dist.broadcast(t, src, group=self.edges[edge])
        elif self.stage == src_stage:
            dist.send(t, self.ranks[edge + 1 if src_stage == edge
                                    else edge])
        else:
            dist.recv(t, src)

    def send_next(self, t: torch.Tensor) -> None:
        """Hand this stage's activation to stage ``s + 1``."""
        t = t.detach().contiguous()
        self.handoff_bytes.append(t.numel() * t.element_size())
        self._handoff(t, self.stage, self.stage)

    def recv_prev(self, like: torch.Tensor) -> torch.Tensor:
        """The activation stage ``s - 1`` hands over (shaped ``like``)."""
        t = torch.empty_like(like)
        self._handoff(t, self.stage - 1, self.stage - 1)
        return t

    def send_prev(self, grad: torch.Tensor) -> None:
        """Hand an input gradient back to stage ``s - 1``."""
        self._handoff(grad.detach().contiguous(), self.stage - 1,
                      self.stage)

    def recv_next(self, like: torch.Tensor) -> torch.Tensor:
        """The output gradient stage ``s + 1`` hands back."""
        t = torch.empty_like(like)
        self._handoff(t, self.stage, self.stage + 1)
        return t


def build_pipe_links(grid: Any) -> PipeLinks:
    """:class:`PipeLinks` of this rank on a pipe-major
    :class:`~kfac_pytorch_tpu_torch.parallel.mesh.AxisGroups` grid
    (``outer`` the stage, ``inner`` the data index).  On gloo every rank
    makes every edge group of every pipe group, in the same order."""
    links = PipeLinks(grid.outer_ranks(), grid.outer, grid.outer_group)
    if links.backend == 'gloo':
        for i in range(grid.n_inner):
            ranks = [o * grid.n_inner + i for o in range(grid.n_outer)]
            for s in range(grid.n_outer - 1):
                g = dist.new_group([ranks[s], ranks[s + 1]])
                if i == grid.inner:
                    links.edges[s] = g
    return links


def gpipe(
    stage_fn: Callable[[torch.Tensor], torch.Tensor],
    first_input: Callable[[int], torch.Tensor],
    like: torch.Tensor,
    links: PipeLinks,
    n_microbatches: int,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The forward half of GPipe for this rank's stage.

    Args:
        stage_fn: this stage's blocks (``[mb, ...] -> [mb, ...]``, the
            same shape).
        first_input: ``m -> `` microbatch ``m``'s stage-0 input (called
            on stage 0 only).
        like: a tensor of one microbatch activation's shape, dtype and
            device (the receive buffers).
        links: the hand-offs.
        n_microbatches: ``M``.

    Returns:
        ``(inputs, outputs)``: per microbatch, the stage's input (a leaf
        that requires grad on stages after the first) and its output.
    """
    S, s, M = links.n_stages, links.stage, n_microbatches
    inputs: list[torch.Tensor] = []
    outputs: list[torch.Tensor] = []
    for t in range(num_ticks(S, M)):
        m = t - s
        if not 0 <= m < M:
            continue  # a bubble: nothing to compute
        if s == 0:
            x = first_input(m)
        else:
            x = links.recv_prev(like).requires_grad_(
                torch.is_grad_enabled())
        y = stage_fn(x)
        if s < S - 1:
            links.send_next(y)
        inputs.append(x)
        outputs.append(y)
    return inputs, outputs


def gpipe_backward(
    inputs: Sequence[torch.Tensor],
    outputs: Sequence[torch.Tensor],
    links: PipeLinks,
    loss: torch.Tensor | None = None,
) -> None:
    """The backward half: the last stage runs ``loss.backward()`` (over
    all its microbatches at once); every other stage takes each
    microbatch's output gradient from ``s + 1`` in microbatch order and
    runs ``torch.autograd.backward`` on that output; every stage after
    the first hands each input gradient to ``s - 1``."""
    S, s = links.n_stages, links.stage
    if s == S - 1:
        loss.backward()
        if s > 0:
            for x in inputs:
                links.send_prev(x.grad)
        return
    for x, y in zip(inputs, outputs):
        torch.autograd.backward(y, links.recv_next(y))
        if s > 0:
            links.send_prev(x.grad)
