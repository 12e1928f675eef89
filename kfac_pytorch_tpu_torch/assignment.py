"""Work assignment: KAISA gradient-worker/receiver placement.

Port of ``kfac_pytorch_tpu/assignment.py`` (itself the algorithm of the
original library's ``kfac/assignment.py``).  It is deterministic host
computation: every rank computes the same placement from the same
inputs.  Groups are plain rank ``frozenset``s; the process groups that
carry the collectives are built from the same partitions by
:func:`kfac_pytorch_tpu_torch.parallel.mesh.kaisa_grid`.

Grid semantics: ranks form an ``m x n`` grid with ``m = grad_workers``
rows and ``n = world / grad_workers`` columns; the *columns* are
gradient-worker groups (they share decompositions), the *rows* are
gradient-receiver groups (they share preconditioned gradients).
"""
from __future__ import annotations

from abc import ABCMeta
from abc import abstractmethod

Group = frozenset[int]


class WorkAssignment(metaclass=ABCMeta):
    """Abstract interface to a work assignment."""

    def __repr__(self) -> str:
        layer_strs = []
        for layer in self.get_layers():
            factors = self.get_factors(layer)
            invs = {
                factor: self.inv_worker(layer, factor) for factor in factors
            }
            layer_strs.append(
                f'  layer="{layer}": '
                f'is_grad_worker={self.is_grad_worker(layer)}, '
                f'src_grad_worker={self.src_grad_worker(layer)}, '
                f'inv_workers={invs}',
            )
        s = ',\n'.join(layer_strs)
        return f'{self.__class__.__name__}(\n{s}\n)'

    @abstractmethod
    def broadcast_gradients(self) -> bool:
        """Whether preconditioned gradients must be communicated."""
        raise NotImplementedError

    @abstractmethod
    def broadcast_inverses(self) -> bool:
        """Whether second-order results must be communicated."""
        raise NotImplementedError

    @abstractmethod
    def get_layers(self) -> tuple[str, ...]:
        """Layers assigned."""
        raise NotImplementedError

    @abstractmethod
    def get_factors(self, layer: str) -> tuple[str, ...]:
        """Factors associated with a layer."""
        raise NotImplementedError

    @abstractmethod
    def inv_worker(self, layer: str, factor: str) -> int:
        """Rank computing the second-order data of a layer's factor."""
        raise NotImplementedError

    @abstractmethod
    def is_grad_worker(self, layer: str) -> bool:
        """Whether this rank preconditions this layer's gradient."""
        raise NotImplementedError

    @abstractmethod
    def src_grad_worker(self, layer: str) -> int:
        """Rank sending this rank the layer's preconditioned gradient."""
        raise NotImplementedError

    @abstractmethod
    def factor_group(self, layer: str, factor: str) -> Group | None:
        """Ranks participating in the factor reduction."""
        raise NotImplementedError

    @abstractmethod
    def grad_worker_group(self, layer: str) -> Group | None:
        """Ranks receiving the layer's second-order data."""
        raise NotImplementedError

    @abstractmethod
    def grad_receiver_group(self, layer: str) -> Group | None:
        """Ranks receiving the layer's preconditioned gradient."""
        raise NotImplementedError


class KAISAAssignment(WorkAssignment):
    """KAISA work assignment.

    Args:
        work: ``{layer: {factor: cost}}`` load-balancing costs.
        local_rank: this process's rank.
        world_size: total ranks.
        grad_worker_fraction: fraction of ranks preconditioning each
            layer; ``grad_workers = max(1, world_size * fraction)``.
        colocate_factors: assign all of a layer's factors to one worker.
    """

    def __init__(
        self,
        work: dict[str, dict[str, float]],
        *,
        local_rank: int,
        world_size: int,
        grad_worker_fraction: float,
        colocate_factors: bool = True,
    ) -> None:
        if not 0 <= grad_worker_fraction <= 1:
            raise ValueError(
                'grad_worker_fraction must be in [0, 1]. '
                f'Got {grad_worker_fraction}.',
            )
        if local_rank < 0:
            raise ValueError('local_rank must be >= 0')
        if world_size <= 0:
            raise ValueError('world_size must be > 0')
        grad_workers = max(1, world_size * grad_worker_fraction)
        if grad_workers != int(grad_workers):
            raise ValueError(
                'world_size*grad_worker_fraction must produce an integer '
                f'value. Found {world_size}*{grad_worker_fraction}'
                f'={grad_workers}.',
            )
        grad_workers = int(grad_workers)
        if local_rank >= world_size:
            raise ValueError(
                f'local_rank={local_rank} larger than '
                f'world_size={world_size}',
            )
        self.local_rank = local_rank
        self.world_size = world_size
        self.grad_worker_fraction = grad_worker_fraction
        self.grad_workers = grad_workers
        self.colocate_factors = colocate_factors

        grad_worker_ranks = self.partition_grad_workers(
            world_size, grad_workers,
        )
        grad_receiver_ranks = self.partition_grad_receivers(
            world_size, grad_workers,
        )
        worker_groups = [
            sorted(ranks) for ranks in sorted(grad_worker_ranks, key=min)
        ]
        self._inv_assignments = self.planned_assignment(
            work, worker_groups, world_size, colocate_factors,
        )

        self._grad_worker_groups: dict[str, Group] = {}
        self._grad_receiver_groups: dict[str, Group] = {}
        for layer, factors in self._inv_assignments.items():
            inv_worker = next(iter(factors.values()))
            for ranks in grad_worker_ranks:
                if inv_worker in ranks:
                    self._grad_worker_groups[layer] = ranks
            for ranks in grad_receiver_ranks:
                if self.local_rank in ranks:
                    self._grad_receiver_groups[layer] = ranks

    @classmethod
    def planned_assignment(
        cls,
        work: dict[str, dict[str, float]],
        worker_groups: list[list[int]],
        world_size: int,
        colocate_factors: bool,
    ) -> dict[str, dict[str, int]]:
        """:meth:`greedy_assignment` through the native (C++) planner of
        :mod:`kfac_pytorch_tpu_torch._native` when it built, else (and
        for ragged groups) through its Python twin;
        ``tests/test_torch_native.py`` holds the two output-identical."""
        from kfac_pytorch_tpu_torch import _native

        native = _native.greedy_assignment(
            work, worker_groups, world_size, colocate_factors,
        )
        if native is not None:
            return native
        return cls.greedy_assignment(
            work, worker_groups, world_size, colocate_factors,
        )

    @staticmethod
    def greedy_assignment(
        work: dict[str, dict[str, float]],
        worker_groups: list[list[int]],
        world_size: int,
        colocate_factors: bool,
    ) -> dict[str, dict[str, int]]:
        """Greedy longest-processing-time constrained assignment.

        Layers in descending total cost; each layer goes to the
        least-loaded worker group; within the group, factors go to the
        least-loaded worker (all factors to one worker when
        ``colocate_factors``).
        """
        worker_loads = [0.0] * world_size
        assignments: dict[str, dict[str, int]] = {
            layer: dict.fromkeys(factors, -1)
            for layer, factors in work.items()
        }
        summed_work = {
            layer: sum(factors.values()) for layer, factors in work.items()
        }
        sorted_layers = [
            layer
            for layer, _ in sorted(
                summed_work.items(), key=lambda kv: kv[1], reverse=True,
            )
        ]
        for layer in sorted_layers:
            group_loads = [
                sum(worker_loads[i] for i in group)
                for group in worker_groups
            ]
            group = worker_groups[group_loads.index(min(group_loads))]
            if colocate_factors:
                loads = [worker_loads[i] for i in group]
                min_worker = group[loads.index(min(loads))]
                worker_loads[min_worker] += summed_work[layer]
                for factor in work[layer]:
                    assignments[layer][factor] = min_worker
            else:
                factors = sorted(
                    work[layer].items(),
                    key=lambda kv: (kv[1], kv[0]),
                    reverse=True,
                )
                for factor, cost in factors:
                    loads = [worker_loads[i] for i in group]
                    min_worker = group[loads.index(min(loads))]
                    worker_loads[min_worker] += cost
                    assignments[layer][factor] = min_worker
        for layer in assignments:
            for factor in assignments[layer]:
                assert assignments[layer][factor] >= 0
        return assignments

    @staticmethod
    def partition_grad_workers(
        world_size: int,
        grad_workers: int,
    ) -> set[Group]:
        """Gradient-worker groups = columns of the KAISA grid: with
        ``n = world/grad_workers`` columns, column ``i`` is
        ``{i, i+n, i+2n, ...}``."""
        if world_size <= 0:
            raise ValueError('world_size must be > 0')
        if world_size % grad_workers != 0:
            raise ValueError(
                'world_size must be an integer multiple of the gradient '
                'worker count',
            )
        partitions = world_size // grad_workers
        return {
            frozenset(range(i, world_size, partitions))
            for i in range(partitions)
        }

    @staticmethod
    def partition_grad_receivers(
        world_size: int,
        grad_workers: int,
    ) -> set[Group]:
        """Gradient-receiver groups = rows of the KAISA grid: row ``j``
        is ``{j*n, ..., (j+1)*n - 1}``."""
        if world_size <= 0:
            raise ValueError('world_size must be > 0')
        if world_size % grad_workers != 0:
            raise ValueError(
                'world_size must be an integer multiple of the gradient '
                'worker count',
            )
        partitions = world_size // grad_workers
        return {
            frozenset(range(i * partitions, (i + 1) * partitions))
            for i in range(grad_workers)
        }

    def broadcast_gradients(self) -> bool:
        """True unless COMM-OPT."""
        return self.grad_workers < self.world_size

    def broadcast_inverses(self) -> bool:
        """True unless MEM-OPT."""
        return self.grad_workers > 1

    def get_layers(self) -> tuple[str, ...]:
        return tuple(self._inv_assignments.keys())

    def get_factors(self, layer: str) -> tuple[str, ...]:
        return tuple(self._inv_assignments[layer].keys())

    def inv_worker(self, layer: str, factor: str) -> int:
        return self._inv_assignments[layer][factor]

    def is_grad_worker(self, layer: str) -> bool:
        return self.local_rank in self._grad_worker_groups[layer]

    def src_grad_worker(self, layer: str) -> int:
        """The intersection of this rank's receiver row with the layer's
        worker column."""
        return next(iter(
            self._grad_worker_groups[layer]
            & self._grad_receiver_groups[layer],
        ))

    def factor_group(self, layer: str, factor: str) -> Group | None:
        """Global group: KAISA assumes pure data-parallel factor
        contributions."""
        return None

    def grad_worker_group(self, layer: str) -> Group | None:
        return self._grad_worker_groups[layer]

    def grad_receiver_group(self, layer: str) -> Group | None:
        return self._grad_receiver_groups[layer]
