"""K-FAC enum types (PyTorch port of ``kfac_pytorch_tpu/enums.py``)."""
from __future__ import annotations

from enum import Enum


class AssignmentStrategy(Enum):
    """K-FAC factor distribution heuristic.

    COMPUTE weighs factors by the O(n^3) decomposition cost, MEMORY by
    the O(n^2) storage cost.  On one device the choice places nothing;
    it is kept so configurations carry over unchanged.
    """

    COMPUTE = 1
    MEMORY = 2


class ComputeMethod(Enum):
    """Second-order computation method.

    EIGEN preconditions in the factor eigenbasis; INVERSE uses explicit
    damped inverses; ITERATIVE computes the same inverses by
    Newton–Schulz.
    """

    EIGEN = 1
    INVERSE = 2
    ITERATIVE = 3


class DistributedStrategy(Enum):
    """KAISA distribution strategy shortcut.

      - COMM_OPT: grad_worker_fraction = 1
      - HYBRID_OPT: grad_worker_fraction = 0.5
      - MEM_OPT: grad_worker_fraction = 1 / world_size
    """

    COMM_OPT = 1
    MEM_OPT = 2
    HYBRID_OPT = 3


def resolve_grad_worker_fraction(
    grad_worker_fraction: 'DistributedStrategy | float',
    world_size: int,
) -> tuple[float, DistributedStrategy]:
    """Normalize the KAISA knob to ``(fraction, strategy)``.

    COMM_OPT=1, HYBRID_OPT=0.5, MEM_OPT=1/world; a float must lie in
    [0, 1] (0 coerces to MEM-OPT) and produce equal-size worker groups.
    """
    if isinstance(grad_worker_fraction, DistributedStrategy):
        strategy = grad_worker_fraction
        if strategy == DistributedStrategy.COMM_OPT:
            return 1.0, strategy
        if strategy == DistributedStrategy.HYBRID_OPT:
            if world_size % 2 != 0 and world_size != 1:
                raise ValueError(
                    f'HYBRID_OPT requires an even world size, got '
                    f'{world_size}',
                )
            return (0.5 if world_size != 1 else 1.0), strategy
        if strategy == DistributedStrategy.MEM_OPT:
            return 1.0 / world_size, strategy
        raise ValueError(f'Unknown strategy {grad_worker_fraction}')
    fraction = float(grad_worker_fraction)
    if not 0 <= fraction <= 1:
        raise ValueError('grad_worker_fraction must be in [0, 1]')
    if fraction == 0:
        fraction = 1.0 / world_size
    if world_size % max(1, round(world_size * fraction)) != 0:
        raise ValueError(
            'grad_worker_fraction must produce groups of equal size',
        )
    if fraction == 1:
        return 1.0, DistributedStrategy.COMM_OPT
    if fraction <= 1 / world_size:
        return fraction, DistributedStrategy.MEM_OPT
    return fraction, DistributedStrategy.HYBRID_OPT
