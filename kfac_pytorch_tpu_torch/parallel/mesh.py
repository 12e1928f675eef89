"""The KAISA grid as ``torch.distributed`` process groups.

Port of ``kfac_pytorch_tpu/parallel/mesh.py``.  The ranks of the default
process group form an ``m x n`` grid, ``m = grad_workers`` rows
(gradient-receiver groups) and ``n = world / m`` columns
(gradient-worker groups).  Rank ``k`` sits at row ``k // n`` and column
``k % n`` — the partitions of
:meth:`~kfac_pytorch_tpu_torch.assignment.KAISAAssignment.\
partition_grad_workers` and ``partition_grad_receivers``.  Where the JAX
package reshards arrays over a device mesh and lets GSPMD insert the
collectives, the port issues them itself on two groups per rank: its
column (the decomposition all-gather) and its row (the preconditioned
gradient all-gather).

On a ``('data', 'model')`` grid (:func:`axis_groups`) the K-FAC world is
the data group: each model index has its own KAISA grid over its data
peers (``kaisa_grid(..., data_ranks=..., data_group=...)``; JAX's
``data_axes``), and the model peers hold replicas of the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch.assignment import KAISAAssignment


def data_world() -> int:
    """K-FAC world size: the default process group's size when
    ``torch.distributed`` is initialized, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def default_backend(world_size: int) -> str:
    """``'nccl'`` when every rank can have a card of its own
    (``torch.cuda.device_count() >= world_size``), else ``'gloo'``.

    NCCL refuses two ranks on one device; gloo takes CUDA tensors and
    moves them through host memory, so it runs any number of ranks on
    one card (a correctness path, not a scaling one).
    """
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return 'nccl'
    return 'gloo'


def grid_shape(
    world_size: int, grad_worker_fraction: float,
) -> tuple[int, int]:
    """``(rows, cols)`` of the KAISA grid for a fraction.

    ``rows = grad_workers = max(1, world * fraction)``; COMM-OPT
    (fraction 1) is one column of ``world`` rows, MEM-OPT (fraction
    ``1/world``) one row of ``world`` columns.
    """
    if not 0 <= grad_worker_fraction <= 1:
        raise ValueError('grad_worker_fraction must be in [0, 1]')
    rows = max(1, round(world_size * grad_worker_fraction))
    if world_size % rows != 0:
        raise ValueError(
            f'grad_worker_fraction {grad_worker_fraction} does not evenly '
            f'partition world size {world_size}',
        )
    return rows, world_size // rows


@dataclasses.dataclass(frozen=True)
class KaisaGrid:
    """One rank's place on the KAISA grid.

    Attributes:
        rows: gradient workers per column (grid rows).
        cols: gradient-worker columns.
        rank: this rank in the default process group.
        row_group: the ranks of this rank's row, ordered by column (the
            gradient all-gather); ``None`` when ``cols == 1``.
        col_group: the ranks of this rank's column, ordered by row (the
            decomposition all-gather); ``None`` when ``rows == 1``.
        group: the grid's world, over which the factors are averaged:
            ``None`` for the default group, else the data group.
    """

    rows: int
    cols: int
    rank: int
    row_group: Any = None
    col_group: Any = None
    group: Any = None

    @property
    def world(self) -> int:
        return self.rows * self.cols

    @property
    def row(self) -> int:
        return self.rank // self.cols

    @property
    def col(self) -> int:
        return self.rank % self.cols


def kaisa_grid(
    grad_worker_fraction: float,
    data_ranks: Sequence[Sequence[int]] | None = None,
    data_group: Any = None,
) -> KaisaGrid:
    """Build this rank's grid over the default process group, or over
    its data group.

    Args:
        grad_worker_fraction: the KAISA fraction.
        data_ranks: ``None`` (the default group is the K-FAC world), or
            every data group of the world, each listing its global ranks
            by data index (:meth:`AxisGroups.axis_ranks`); each gets a
            grid of its own, and the rank's position is its data index.
        data_group: this rank's data group (``None`` when it has one
            rank), over which the factors are averaged.

    Every rank creates every row group and then every column group of
    every data group, in the same order (``dist.new_group`` is
    collective over the world).  A grid axis of extent 1 needs no group
    and gets none; that depends on the grid only, so all ranks skip
    alike.  Without ``torch.distributed`` the grid is ``1 x 1``.
    """
    if data_ranks is None:
        world = data_world()
        data_ranks = [list(range(world))]
    data_ranks = [list(r) for r in data_ranks]
    world = len(data_ranks[0])
    rows, cols = grid_shape(world, grad_worker_fraction)
    if data_world() == 1:
        return KaisaGrid(rows=1, cols=1, rank=0)
    rank = dist.get_rank()
    mine = next(r for r in data_ranks if rank in r)
    # Rows are the gradient-receiver groups, columns the gradient-worker
    # groups; sorted, a row lists its ranks by column, a column by row.
    row_ranks = sorted(
        sorted(g) for g in KAISAAssignment.partition_grad_receivers(
            world, rows,
        )
    )
    col_ranks = sorted(
        sorted(g) for g in KAISAAssignment.partition_grad_workers(
            world, rows,
        )
    )
    row_group = col_group = None
    for ranks in data_ranks:
        if cols > 1:
            for idx in row_ranks:
                g = dist.new_group([ranks[i] for i in idx])
                if ranks == mine and mine.index(rank) in idx:
                    row_group = g
        if rows > 1:
            for idx in col_ranks:
                g = dist.new_group([ranks[i] for i in idx])
                if ranks == mine and mine.index(rank) in idx:
                    col_group = g
    return KaisaGrid(
        rows=rows, cols=cols, rank=mine.index(rank),
        row_group=row_group, col_group=col_group,
        group=None if len(data_ranks) == 1 else data_group,
    )


@dataclasses.dataclass(frozen=True)
class AxisGroups:
    """One rank's place on a two-axis ``[n_outer, n_inner]`` grid of the
    default process group: rank ``k`` sits at ``outer = k // n_inner``
    and ``inner = k % n_inner``, the order of JAX's
    ``Mesh(devices.reshape(n_outer, n_inner), (outer, inner))``.

    Attributes:
        outer_group: the ranks sharing this rank's ``inner`` index,
            ordered by ``outer``; ``None`` when ``n_outer == 1``.
        inner_group: the ranks sharing this rank's ``outer`` index,
            ordered by ``inner``; ``None`` when ``n_inner == 1``.
        names: the two axes' names (JAX's mesh axis names), e.g.
            ``('data', 'model')``.
    """

    n_outer: int
    n_inner: int
    rank: int = 0
    outer_group: Any = None
    inner_group: Any = None
    names: tuple[str, str] = ('outer', 'inner')

    @property
    def outer(self) -> int:
        return self.rank // self.n_inner

    @property
    def inner(self) -> int:
        return self.rank % self.n_inner

    def outer_ranks(self) -> list[int]:
        """The ranks of :attr:`outer_group`, by ``outer``."""
        return [o * self.n_inner + self.inner for o in range(self.n_outer)]

    def axis_index(self, axis: str) -> int:
        """``0`` for the outer axis's name, ``1`` for the inner's; a
        name not in :attr:`names` raises."""
        if axis not in self.names:
            raise ValueError(f'axis {axis!r} not in mesh axes {self.names}')
        return self.names.index(axis)

    def axis_ranks(self, axis: str) -> list[list[int]]:
        """Every group along ``axis`` (the ranks that differ only in
        that coordinate), each by its index on the axis, in the order
        :func:`axis_groups` makes them."""
        if self.axis_index(axis) == 0:
            return [[o * self.n_inner + i for o in range(self.n_outer)]
                    for i in range(self.n_inner)]
        return [[o * self.n_inner + i for i in range(self.n_inner)]
                for o in range(self.n_outer)]

    def group(self, axis: str) -> Any:
        """This rank's group along ``axis`` (``None``: extent 1)."""
        return (self.outer_group, self.inner_group)[self.axis_index(axis)]


def axis_groups(n_outer: int, n_inner: int,
                names: tuple[str, str] = ('outer', 'inner')) -> AxisGroups:
    """Build this rank's two axes over the default process group
    (``n_outer * n_inner`` must be its size), named ``names`` (a
    ``('data', 'model')`` grid for :class:`~kfac_pytorch_tpu_torch.gpt.\
GPTKFACPreconditioner`, ``(data, seq)`` for a sequence group beside a
    data one).  Every rank creates every outer group and then every inner
    group, in the same order; an axis of extent 1 gets none.  Without
    ``torch.distributed`` the grid must be ``1 x 1``."""
    names = tuple(names)
    world = data_world()
    if n_outer * n_inner != world:
        raise ValueError(
            f'a {n_outer} x {n_inner} grid needs {n_outer * n_inner} ranks, '
            f'the world has {world}',
        )
    if world == 1:
        return AxisGroups(1, 1, names=names)
    rank = dist.get_rank()
    outer_group = inner_group = None
    if n_outer > 1:
        for i in range(n_inner):
            ranks = [o * n_inner + i for o in range(n_outer)]
            g = dist.new_group(ranks)
            if rank in ranks:
                outer_group = g
    if n_inner > 1:
        for o in range(n_outer):
            ranks = [o * n_inner + i for i in range(n_inner)]
            g = dist.new_group(ranks)
            if rank in ranks:
                inner_group = g
    return AxisGroups(n_outer, n_inner, rank, outer_group, inner_group,
                      names)
