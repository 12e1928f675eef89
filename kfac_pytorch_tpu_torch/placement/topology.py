"""Two-level interconnect model of a GPU cluster: NVLink nodes on a network.

Port of ``kfac_pytorch_tpu/placement/topology.py``.  A cluster of H100
nodes is not the flat interconnect KAISA's ``grad_worker_fraction`` knob
was tuned for: the GPUs of one node share an NVLink domain, and the
nodes are joined by a network several times slower per GPU ("Scalable
K-FAC with Distributed Preconditioning", arxiv 2206.15143, makes the
same observation for GPU clusters).  :class:`PodTopology` models the two
facts the placement solver needs:

* which ranks share a link group (contiguous blocks of ``ici_size``
  ranks, the rank order of
  :func:`kfac_pytorch_tpu_torch.parallel.mesh.kaisa_grid`), and
* the per-GPU bandwidth of each link class.

The link classes keep the JAX package's names, so that a plan payload of
either package validates in the other:

* ``'ici'``: inside one link group, here one NVLink domain (the GPUs of
  one node);
* ``'dcn'``: across groups, here the network between nodes (InfiniBand).

A collective is priced through the **slowest link it traverses**: one
whose ranks stay inside one group moves at the NVLink rate, one that
spans groups is billed end to end at the network rate.  A single group
reproduces the flat model exactly
(``tests/test_torch_placement.py`` holds ``PodTopology.flat(w, bw).
ring_allreduce_seconds == ring_allreduce_bytes / bw``).

The byte models (:func:`~kfac_pytorch_tpu_torch.observe.costs.\
ring_allreduce_bytes`, :func:`~kfac_pytorch_tpu_torch.observe.costs.\
allgather_bytes`) are the observe ledger's, so the planner's objective
and the ledger read the same arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from kfac_pytorch_tpu_torch.observe.costs import allgather_bytes
from kfac_pytorch_tpu_torch.observe.costs import ring_allreduce_bytes

__all__ = [
    'DCN',
    'DEFAULT_DCN_GBYTES_PER_S',
    'DEFAULT_ICI_GBYTES_PER_S',
    'ICI',
    'PodTopology',
    'grid_col_ranks',
    'grid_row_ranks',
]

#: Link-class names of ledger rows and plans.  ``'flat'`` (no topology)
#: is not one: it marks the absence of a model, not a third class.
ICI = 'ici'
DCN = 'dcn'

# Data-sheet figures for an NVIDIA H100 SXM5 80GB node (700 W power
# limit), not measurements: NVLink 4 gives each GPU 900 GB/s
# bidirectional, 450 GB/s per direction (NVIDIA H100 Tensor Core GPU data
# sheet); between nodes, one 400 Gb/s NDR InfiniBand NIC per GPU gives
# 50 GB/s per direction.
DEFAULT_ICI_GBYTES_PER_S = 450.0
DEFAULT_DCN_GBYTES_PER_S = 50.0


def grid_row_ranks(rows: int, cols: int) -> tuple[tuple[int, ...], ...]:
    """Rank sets of the KAISA grid's rows (the gradient all-gather's
    groups): row ``r`` is ``[r*cols, (r+1)*cols)``, as
    :meth:`KAISAAssignment.partition_grad_receivers`."""
    return tuple(
        tuple(range(r * cols, (r + 1) * cols)) for r in range(rows)
    )


def grid_col_ranks(rows: int, cols: int) -> tuple[tuple[int, ...], ...]:
    """Rank sets of the KAISA grid's columns (the decomposition
    all-gather's groups): column ``c`` is ``{c, c+cols, ...}``, as
    :meth:`KAISAAssignment.partition_grad_workers`."""
    return tuple(
        tuple(range(c, rows * cols, cols)) for c in range(cols)
    )


@dataclasses.dataclass(frozen=True)
class PodTopology:
    """Two-level interconnect: link groups of ``ici_size`` GPUs (an
    NVLink node) joined by the network.

    Rank ``k`` of the K-FAC world belongs to group ``k // ici_size``; the
    world is ``ici_size * n_groups``.

    Args:
        ici_size: GPUs per link group (per node).
        n_groups: groups joined by the network (1: a flat single-group
            topology, where every price is the flat model's).
        ici_gbytes_per_s: per-GPU bandwidth inside a group (default the
            H100 SXM5's NVLink 4 rate per direction, a data-sheet
            figure).
        dcn_gbytes_per_s: per-GPU bandwidth once a collective crosses
            groups (default one 400 Gb/s NDR InfiniBand NIC per GPU, a
            data-sheet figure).
    """

    ici_size: int
    n_groups: int
    ici_gbytes_per_s: float = DEFAULT_ICI_GBYTES_PER_S
    dcn_gbytes_per_s: float = DEFAULT_DCN_GBYTES_PER_S

    def __post_init__(self) -> None:
        if self.ici_size < 1:
            raise ValueError(f'ici_size must be >= 1, got {self.ici_size}')
        if self.n_groups < 1:
            raise ValueError(f'n_groups must be >= 1, got {self.n_groups}')
        if self.ici_gbytes_per_s <= 0 or self.dcn_gbytes_per_s <= 0:
            raise ValueError(
                'bandwidths must be positive, got '
                f'ici={self.ici_gbytes_per_s} dcn={self.dcn_gbytes_per_s}',
            )

    # ------------------------------------------------------------------
    # structure
    # ------------------------------------------------------------------

    @property
    def world(self) -> int:
        return self.ici_size * self.n_groups

    @classmethod
    def flat(
        cls, world: int, gbytes_per_s: float = DEFAULT_ICI_GBYTES_PER_S,
    ) -> 'PodTopology':
        """One group with both classes at ``gbytes_per_s``: the flat
        model as a special case."""
        return cls(
            ici_size=world,
            n_groups=1,
            ici_gbytes_per_s=gbytes_per_s,
            dcn_gbytes_per_s=gbytes_per_s,
        )

    def with_world(self, world: int) -> 'PodTopology':
        """The same link classes for ``world`` GPUs: worlds up to
        ``ici_size`` are one group, larger ones fill whole groups."""
        if world <= self.ici_size:
            return dataclasses.replace(self, ici_size=world, n_groups=1)
        if world % self.ici_size != 0:
            raise ValueError(
                f'world {world} does not fill whole ICI groups of '
                f'{self.ici_size}',
            )
        return dataclasses.replace(self, n_groups=world // self.ici_size)

    def group_of(self, rank: int) -> int:
        if not 0 <= rank < self.world:
            raise ValueError(f'rank {rank} outside world {self.world}')
        return rank // self.ici_size

    def groups(self) -> tuple[frozenset[int], ...]:
        """Rank sets of the link groups, in group order."""
        return tuple(
            frozenset(range(g * self.ici_size, (g + 1) * self.ici_size))
            for g in range(self.n_groups)
        )

    def link_for(self, src_group: int, dst_group: int) -> str:
        """Link class between two groups (``'ici'`` within one)."""
        for g in (src_group, dst_group):
            if not 0 <= g < self.n_groups:
                raise ValueError(
                    f'group {g} outside topology with {self.n_groups} '
                    'groups',
                )
        return ICI if src_group == dst_group else DCN

    # ------------------------------------------------------------------
    # collective scoping and pricing
    # ------------------------------------------------------------------

    def scope_of(self, ranks: Iterable[int]) -> str:
        """Slowest link class a collective over ``ranks`` traverses."""
        groups = {self.group_of(r) for r in ranks}
        return ICI if len(groups) <= 1 else DCN

    def scope_of_sets(self, rank_sets: Sequence[Iterable[int]]) -> str:
        """Worst scope over concurrent collectives (the groups of one
        gather phase): ``'dcn'`` if any set crosses a group boundary."""
        scopes = {self.scope_of(rs) for rs in rank_sets} or {ICI}
        return DCN if DCN in scopes else ICI

    def bandwidth(self, scope: str) -> float:
        """Bytes/s of a link class (``'flat'`` prices at the
        intra-group rate, the single-link model)."""
        if scope == DCN:
            return self.dcn_gbytes_per_s * 1e9
        if scope in (ICI, 'flat'):
            return self.ici_gbytes_per_s * 1e9
        raise ValueError(f'unknown link scope {scope!r}')

    def ring_allreduce_seconds(
        self, payload: int, ranks: Iterable[int],
    ) -> float:
        """Ring all-reduce of ``payload`` bytes over ``ranks`` through
        the slowest traversed link."""
        ranks = tuple(ranks)
        wire = ring_allreduce_bytes(payload, len(ranks))
        return wire / self.bandwidth(self.scope_of(ranks))

    def allgather_seconds(
        self, payload: int, ranks: Iterable[int],
    ) -> float:
        """All-gather of ``payload`` bytes held in ``len(ranks)`` equal
        shards, through the slowest traversed link."""
        ranks = tuple(ranks)
        wire = allgather_bytes(payload, len(ranks))
        return wire / self.bandwidth(self.scope_of(ranks))

    def seconds_for(self, wire_bytes: float, scope: str) -> float:
        """Per-GPU wire bytes at a link class, in seconds."""
        return wire_bytes / self.bandwidth(scope)

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------

    def describe(self) -> dict:
        """JSON-ready summary (plan payloads)."""
        return {
            'ici_size': self.ici_size,
            'n_groups': self.n_groups,
            'world': self.world,
            'ici_gbytes_per_s': self.ici_gbytes_per_s,
            'dcn_gbytes_per_s': self.dcn_gbytes_per_s,
        }

    def __str__(self) -> str:
        return (
            f'{self.n_groups}x{self.ici_size} pod '
            f'({self.ici_gbytes_per_s:g} GB/s ICI, '
            f'{self.dcn_gbytes_per_s:g} GB/s DCN)'
        )
