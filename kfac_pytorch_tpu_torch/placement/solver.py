"""Ledger-driven placement search over the KAISA grid family.

Port of ``kfac_pytorch_tpu/placement/solver.py``.  KAISA has one
placement knob, ``grad_worker_fraction``, and three hand-picked values
(COMM-OPT 1, HYBRID-OPT 0.5, MEM-OPT 1/world) tuned for a flat
interconnect.  On NVLink nodes joined by a network the right fraction
depends on where each collective lands against the bandwidth cliff: the
per-step gradient all-gather stays on NVLink exactly when the grid's
row groups fit inside nodes, while the decomposition gather's column
groups stride across nodes as soon as ``rows > 1`` spans them.
:func:`auto_placement` prices every legal grid (every divisor of the
world as the gradient-worker count) against the analytic byte ledger of
the observe layer (:func:`kfac_pytorch_tpu_torch.observe.costs.\
comm_ledger`, scope-tagged by the topology), plus an analytic compute
term per ``compute_method``, and returns the argmin as a
:class:`PlacementPlan`.  The rows and the arithmetic are the JAX
package's, so on the same problem and topology the two packages choose
the same grid and the same per-layer placement.

Inside a candidate grid the per-layer inverse workers come from the KAISA
greedy (:meth:`KAISAAssignment.planned_assignment`: the native planner
when it built) with the grid's column groups as the worker groups, as
``KAISAAssignment`` itself runs it; the compute term is the resulting
makespan, so a fraction whose greedy placement balances badly prices
badly.  The search is exhaustive over the divisors of the world, which
is what makes the brute-force parity test of
``tests/test_torch_placement.py`` meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from kfac_pytorch_tpu_torch.assignment import KAISAAssignment
from kfac_pytorch_tpu_torch.bench import BF16_PEAK_TFLOPS
from kfac_pytorch_tpu_torch.observe import costs
from kfac_pytorch_tpu_torch.parallel.bucketing import pad_dim
from kfac_pytorch_tpu_torch.placement.topology import PodTopology

__all__ = [
    'ASSUMED_PEAK_FRACTION',
    'CandidateEval',
    'DEFAULT_FLOPS_PER_SECOND',
    'PlacementPlan',
    'PlacementProblem',
    'auto_placement',
    'bucket_shapes_for',
    'candidate_grad_workers',
    'decomposition_flops',
    'evaluate_candidate',
    'precondition_flops',
    'problem_for',
    'strategy_name_of',
]

#: Analytic per-refresh decomposition cost coefficients (flops per n^3
#: per factor side), as the JAX package's: syevd ~9n^3, Cholesky inverse
#: (potrf+potri) ~1n^3, and the iterative refresh's 3 coupled
#: Newton-Schulz steps of ~3 batched matmuls (2n^3 flops each).
DECOMP_N3 = {
    'eigen': 9.0,
    'inverse': 1.0,
    'iterative': 3 * 3 * 2.0,
}

#: An assumed fraction of the card's peak for the analytic compute term,
#: not a measurement (the JAX package assumes the same 0.30).  Both terms
#: of every candidate share the constant, so it moves the balance
#: between communication and compute, not the ranking among compute
#: terms.
ASSUMED_PEAK_FRACTION = 0.30

#: Flops per second of the compute term: the H100 SXM5's dense BF16
#: peak from NVIDIA's data sheet (989 TFLOP/s at 700 W, the port bench's
#: ``BF16_PEAK_TFLOPS``) times :data:`ASSUMED_PEAK_FRACTION`.
DEFAULT_FLOPS_PER_SECOND = (
    BF16_PEAK_TFLOPS['NVIDIA H100 80GB HBM3'] * 1e12 * ASSUMED_PEAK_FRACTION
)


def decomposition_flops(a: int, g: int, compute_method: str) -> float:
    """Per-refresh decomposition flops of one layer's two factors."""
    try:
        coeff = DECOMP_N3[compute_method]
    except KeyError:
        raise ValueError(
            f'unknown compute_method {compute_method!r} '
            f'(expected one of {sorted(DECOMP_N3)})',
        ) from None
    return coeff * float(a) ** 3 + coeff * float(g) ** 3


def precondition_flops(
    a: int, g: int, compute_method: str, diag_a: bool = False,
) -> float:
    """Per-step preconditioning flops of one layer: four chained matmuls
    through both eigenbases (eigen), two through the damped inverses
    (inverse, iterative); a diagonal-A layer scales its A side
    elementwise."""
    a, g = float(a), float(g)
    matmuls = 4.0 if compute_method == 'eigen' else 2.0
    if diag_a:
        return (matmuls / 2.0) * g * g * a + g * a
    return matmuls * (g * g * a + g * a * a)


def bucket_shapes_for(
    layer_dims: Sequence[tuple[int, int]],
    n_cols: int,
    diag_a: Sequence[bool] | None = None,
) -> list[tuple[int, int, int]]:
    """``(n_slots, a_pad, g_pad)`` per bucket for a candidate grid: the
    rule of :func:`~kfac_pytorch_tpu_torch.parallel.bucketing.\
make_bucket_plan` (:func:`pad_dim` sizes, slot counts padded to a
    multiple of ``n_cols``) from bare layer dims; diagonal-A layers stay
    out of the buckets, as on the engine's side path."""
    grouped: dict[tuple[int, int], int] = {}
    for i, (a, g) in enumerate(layer_dims):
        if diag_a is not None and diag_a[i]:
            continue
        key = (pad_dim(a), pad_dim(g))
        grouped[key] = grouped.get(key, 0) + 1
    return [
        (-(-count // n_cols) * n_cols, a_pad, g_pad)
        for (a_pad, g_pad), count in sorted(grouped.items())
    ]


def candidate_grad_workers(world: int) -> list[int]:
    """Every legal gradient-worker count: the divisors of ``world``
    (1 = MEM-OPT, ``world`` = COMM-OPT)."""
    if world < 1:
        raise ValueError(f'world must be >= 1, got {world}')
    return [r for r in range(1, world + 1) if world % r == 0]


def strategy_name_of(grad_workers: int, world: int) -> str:
    """The named strategy of a grid, ``'auto'`` when it has none."""
    if grad_workers == world:
        return 'comm_opt'
    if grad_workers == 1:
        return 'mem_opt'
    if world > 1 and grad_workers * 2 == world:
        return 'hybrid_opt'
    return 'auto'


@dataclasses.dataclass(frozen=True)
class PlacementProblem:
    """Everything the solver needs to price a grid (the JAX dataclass,
    field for field).

    Args:
        layer_names: registered layer names (registration order).
        layer_dims: logical ``(a_dim, g_dim)`` per layer, aligned.
        world: K-FAC world size (the topology must match).
        factor_update_steps / inv_update_steps: the cadence the objective
            integrates over (one ``inv_update_steps`` interval).
        compute_method: ``'eigen'``, ``'inverse'`` or ``'iterative'``.
        prediv: ``compute_eigenvalue_outer_product`` (the decomposition
            payload depends on it).
        ekfac: EKFAC (the decomposition gather carries the scale grid).
        diag_a: per-layer diagonal-A flags (embeddings), or ``None``.
        call_counts: factor contributions per layer in the all-reduce,
            or ``None`` for one each.
        triu_bf16: per-layer ``factor_comm='bf16_triu'`` compression
            flags, or ``None``.
        assignment_strategy: ``'compute'`` (cost ``n^3``) or
            ``'memory'`` (``n^2``), the greedy's weights.
        colocate_factors: both factors of a layer on one worker.
        factor_itemsize / inv_itemsize / grad_itemsize: wire dtypes.
        flops_per_second: the rate converting the compute terms to
            seconds.
        adaptive: the drift-adaptive refresh (its digest row is billed).
        measured_rates: observed ``{cadence: events_per_step}``
            overrides (``inv_step`` of an adaptive run), or ``None``.
    """

    layer_names: tuple[str, ...]
    layer_dims: tuple[tuple[int, int], ...]
    world: int
    factor_update_steps: int
    inv_update_steps: int
    compute_method: str = 'eigen'
    prediv: bool = True
    ekfac: bool = False
    diag_a: tuple[bool, ...] | None = None
    call_counts: tuple[int, ...] | None = None
    triu_bf16: tuple[bool, ...] | None = None
    assignment_strategy: str = 'compute'
    colocate_factors: bool = True
    factor_itemsize: int = 4
    inv_itemsize: int = 4
    grad_itemsize: int = 4
    flops_per_second: float = DEFAULT_FLOPS_PER_SECOND
    adaptive: bool = False
    measured_rates: Mapping[str, float] | None = None

    def __post_init__(self) -> None:
        if len(self.layer_names) != len(self.layer_dims):
            raise ValueError(
                f'{len(self.layer_names)} names != '
                f'{len(self.layer_dims)} dims',
            )
        if not self.layer_dims:
            raise ValueError('placement problem has no layers')
        if self.world < 1:
            raise ValueError(f'world must be >= 1, got {self.world}')
        for field in ('diag_a', 'call_counts', 'triu_bf16'):
            flags = getattr(self, field)
            if flags is not None and len(flags) != len(self.layer_dims):
                raise ValueError(f'{field} misaligned with layer_dims')
        if self.assignment_strategy not in ('compute', 'memory'):
            raise ValueError(
                "assignment_strategy must be 'compute' or 'memory', "
                f'got {self.assignment_strategy!r}',
            )
        if self.compute_method not in DECOMP_N3:
            raise ValueError(
                f'unknown compute_method {self.compute_method!r}',
            )
        if self.flops_per_second <= 0:
            raise ValueError('flops_per_second must be positive')

    def work(self) -> dict[str, dict[str, float]]:
        """The greedy's costs, as the preconditioner builds them."""
        exp = 3 if self.assignment_strategy == 'compute' else 2
        return {
            name: {'A': float(a) ** exp, 'G': float(g) ** exp}
            for name, (a, g) in zip(self.layer_names, self.layer_dims)
        }


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def problem_of(
    helpers: Mapping[str, Any],
    *,
    world: int,
    factor_update_steps: int,
    inv_update_steps: int,
    compute_method: Any,
    prediv: bool,
    ekfac: bool,
    compressed: frozenset[str] | None,
    assignment_strategy: Any,
    colocate_factors: bool,
    factor_dtype: torch.dtype,
    inv_dtype: torch.dtype,
    adaptive: bool,
    measured_rates: Mapping[str, float] | None = None,
    flops_per_second: float = DEFAULT_FLOPS_PER_SECOND,
) -> PlacementProblem:
    """The problem of registered layer helpers under the engine's knobs
    (:func:`problem_for` of a built preconditioner, and the ``'auto'``
    path before the engine is built).  ``compressed`` holds the layers
    whose factors ride ``factor_comm='bf16_triu'`` (``None``: no
    compression).  Each layer counts one factor contribution: the port's
    all-reduce averages a layer's calls before it reduces them."""
    names = tuple(helpers)
    method = getattr(compute_method, 'name', str(compute_method)).lower()
    return PlacementProblem(
        layer_names=names,
        layer_dims=tuple(
            (h.a_factor_shape[0], h.g_factor_shape[0])
            for h in helpers.values()
        ),
        world=world,
        factor_update_steps=int(factor_update_steps),
        inv_update_steps=int(inv_update_steps),
        compute_method=method,
        # As the JAX engine keeps it: only the eigen method predivides.
        prediv=bool(prediv) and method == 'eigen',
        ekfac=bool(ekfac),
        diag_a=tuple(bool(h.diagonal_a) for h in helpers.values()),
        call_counts=(1,) * len(names),
        triu_bf16=(None if compressed is None
                   else tuple(n in compressed for n in names)),
        assignment_strategy=getattr(assignment_strategy, 'name',
                                    str(assignment_strategy)).lower(),
        colocate_factors=bool(colocate_factors),
        factor_itemsize=_itemsize(factor_dtype),
        inv_itemsize=_itemsize(inv_dtype),
        flops_per_second=flops_per_second,
        adaptive=bool(adaptive),
        measured_rates=measured_rates,
    )


def problem_for(
    precond: Any,
    *,
    flops_per_second: float = DEFAULT_FLOPS_PER_SECOND,
) -> PlacementProblem:
    """The placement problem of a built port preconditioner: its
    registered layers, its cadences at the current step, method, dtypes,
    ``factor_comm`` and the drift controller's measured refresh rate
    (:func:`~kfac_pytorch_tpu_torch.observe.costs.measured_rates_for`).
    The ``'auto'`` path solves the same problem before the engine is
    built (:func:`problem_of`)."""
    if not precond.helpers:
        raise ValueError('placement problem requires registered layers')
    return problem_of(
        precond.helpers,
        world=precond.grid.world,
        factor_update_steps=precond.factor_update_steps,
        inv_update_steps=precond.inv_update_steps,
        compute_method=precond.compute_method,
        prediv=precond.prediv_eigenvalues,
        ekfac=precond.ekfac,
        compressed=(precond._compressed
                    if precond.factor_comm == 'bf16_triu' else None),
        assignment_strategy=getattr(precond, 'assignment_strategy',
                                    'compute'),
        colocate_factors=getattr(precond, 'colocate_factors', True),
        factor_dtype=precond.factor_dtype,
        inv_dtype=precond.inv_dtype,
        adaptive=getattr(precond, '_adaptive_controller', None) is not None,
        measured_rates=costs.measured_rates_for(precond),
        flops_per_second=flops_per_second,
    )


@dataclasses.dataclass(frozen=True)
class CandidateEval:
    """One priced grid.  ``comm_seconds``/``compute_seconds``/
    ``interval_seconds`` are per ``inv_update_steps`` interval;
    ``bytes_by_scope`` the interval's per-GPU wire bytes by link class;
    ``scopes`` each ledger phase's link class."""

    grad_workers: int
    n_cols: int
    fraction: float
    strategy: str
    comm_seconds: float
    compute_seconds: float
    interval_seconds: float
    bytes_by_scope: Mapping[str, int]
    scopes: Mapping[str, str]
    assignment: Mapping[str, Mapping[str, int]]
    decomp_makespan_flops: float
    precond_makespan_flops: float

    def summary(self) -> dict[str, Any]:
        """JSON-ready row of the plan payload's candidate table."""
        return {
            'grad_workers': self.grad_workers,
            'n_cols': self.n_cols,
            'fraction': self.fraction,
            'strategy': self.strategy,
            'comm_seconds': self.comm_seconds,
            'compute_seconds': self.compute_seconds,
            'interval_seconds': self.interval_seconds,
            'bytes_by_scope': dict(self.bytes_by_scope),
            'scopes': dict(self.scopes),
        }


def _interval_events(cadence: str, problem: PlacementProblem) -> float:
    """Events of a ledger row per ``inv_update_steps`` interval."""
    return costs.cadence_events_per_step(
        cadence,
        problem.factor_update_steps,
        problem.inv_update_steps,
        measured_rates=problem.measured_rates,
    ) * max(problem.inv_update_steps, 1)


def evaluate_candidate(
    problem: PlacementProblem,
    topology: PodTopology,
    grad_workers: int,
) -> CandidateEval:
    """Price one grid: the scope-tagged ledger's communication plus the
    greedy placement's compute makespan.

    Each analytic ledger row of the ``(rows, cols)`` grid is priced at
    the link class its groups traverse, times its events per interval.
    The compute term is the most-loaded inverse worker's decomposition
    flops (once an interval) plus the most-loaded column's rotation
    flops (every step).
    """
    if problem.world % grad_workers != 0:
        raise ValueError(
            f'grad_workers {grad_workers} does not divide world '
            f'{problem.world}',
        )
    if topology.world != problem.world:
        raise ValueError(
            f'topology world {topology.world} != problem world '
            f'{problem.world}',
        )
    rows = grad_workers
    cols = problem.world // rows
    fraction = rows / problem.world

    worker_groups = [
        sorted(ranks)
        for ranks in sorted(
            KAISAAssignment.partition_grad_workers(problem.world, rows),
            key=min,
        )
    ]
    assignment = KAISAAssignment.planned_assignment(
        problem.work(),
        worker_groups,
        problem.world,
        problem.colocate_factors,
    )

    # The decomposition makespan (per interval): each factor decomposes
    # on its inverse worker, the interval waits for the most loaded.
    worker_flops = [0.0] * problem.world
    dims_of = dict(zip(problem.layer_names, problem.layer_dims))
    for layer, factors in assignment.items():
        a, g = dims_of[layer]
        per_factor = {
            'A': decomposition_flops(a, 0, problem.compute_method),
            'G': decomposition_flops(0, g, problem.compute_method),
        }
        for factor, worker in factors.items():
            worker_flops[worker] += per_factor[factor]
    decomp_makespan = max(worker_flops)

    # The per-step rotation makespan: a layer's rotations run on every
    # rank of its worker's column (worker w sits in column w % cols).
    col_flops = [0.0] * cols
    diag_of = dict(zip(
        problem.layer_names,
        problem.diag_a or (False,) * len(problem.layer_names),
    ))
    for layer, factors in assignment.items():
        a, g = dims_of[layer]
        col = next(iter(factors.values())) % cols
        col_flops[col] += precondition_flops(
            a, g, problem.compute_method, diag_a=diag_of[layer],
        )
    precond_makespan = max(col_flops)

    ledger = costs.comm_ledger(
        bucket_shapes_for(problem.layer_dims, cols, problem.diag_a),
        problem.layer_dims,
        rows,
        cols,
        compute_method=problem.compute_method,
        prediv=problem.prediv,
        ekfac=problem.ekfac,
        inv_itemsize=problem.inv_itemsize,
        factor_itemsize=problem.factor_itemsize,
        grad_itemsize=problem.grad_itemsize,
        diag_a=problem.diag_a,
        factor_comm_triu_bf16=(
            problem.triu_bf16 if problem.triu_bf16 is not None else False
        ),
        topology=topology,
        adaptive=problem.adaptive,
        call_counts=problem.call_counts,
    )
    comm_seconds = 0.0
    bytes_by_scope: dict[str, int] = {}
    scopes: dict[str, str] = {}
    for row in ledger:
        events = _interval_events(row.cadence, problem)
        scopes[row.phase] = row.scope
        if events == 0:
            continue
        interval_bytes = row.bytes_per_device * events
        if interval_bytes:
            bytes_by_scope[row.scope] = (
                bytes_by_scope.get(row.scope, 0)
                + int(round(interval_bytes))
            )
        comm_seconds += topology.seconds_for(interval_bytes, row.scope)

    compute_seconds = (
        decomp_makespan
        + max(problem.inv_update_steps, 1) * precond_makespan
    ) / problem.flops_per_second

    return CandidateEval(
        grad_workers=rows,
        n_cols=cols,
        fraction=fraction,
        strategy=strategy_name_of(rows, problem.world),
        comm_seconds=comm_seconds,
        compute_seconds=compute_seconds,
        interval_seconds=comm_seconds + compute_seconds,
        bytes_by_scope=bytes_by_scope,
        scopes=scopes,
        assignment={k: dict(v) for k, v in assignment.items()},
        decomp_makespan_flops=decomp_makespan,
        precond_makespan_flops=precond_makespan,
    )


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """The solver's output: the chosen grid and the evidence.

    ``predicted`` prices the chosen grid on the given topology,
    ``flat_predicted`` the same grid on the flat single-group model (what
    the topology bought), ``candidates`` every grid in ``grad_workers``
    order.
    """

    problem: PlacementProblem
    topology: PodTopology
    objective: str
    fraction: float
    grad_workers: int
    n_cols: int
    assignment: Mapping[str, Mapping[str, int]]
    predicted: CandidateEval
    flat_predicted: CandidateEval
    candidates: tuple[CandidateEval, ...]

    @property
    def strategy(self) -> str:
        return self.predicted.strategy

    def layer_column(self, layer: str) -> int:
        """Gradient-worker column of a layer under the plan."""
        return next(iter(self.assignment[layer].values())) % self.n_cols

    def best_fixed(self) -> CandidateEval:
        """The cheapest of the three named strategies on this topology."""
        fixed = [c for c in self.candidates if c.strategy != 'auto']
        return min(fixed, key=lambda c: c.interval_seconds)


def auto_placement(
    problem: PlacementProblem,
    topology: PodTopology,
    *,
    objective: str = 'interval_seconds',
) -> PlacementPlan:
    """Search the KAISA grid family for the cheapest placement.

    Every divisor of the world is priced by :func:`evaluate_candidate`;
    ties break toward fewer cross-network bytes, then toward the larger
    fraction.  The tie-break is deterministic, so every rank computes
    the same plan from the same inputs, as ``KAISAAssignment`` does.
    ``objective`` is ``'interval_seconds'``, the only one.
    """
    if objective != 'interval_seconds':
        raise ValueError(
            f"unknown objective {objective!r} (supported: "
            "'interval_seconds')",
        )
    evals = [
        evaluate_candidate(problem, topology, rows)
        for rows in candidate_grad_workers(problem.world)
    ]
    chosen = min(
        evals,
        key=lambda c: (
            getattr(c, objective),
            c.bytes_by_scope.get('dcn', 0),
            -c.fraction,
        ),
    )
    flat = evaluate_candidate(
        problem,
        PodTopology.flat(problem.world, topology.ici_gbytes_per_s),
        chosen.grad_workers,
    )
    return PlacementPlan(
        problem=problem,
        topology=topology,
        objective=objective,
        fraction=chosen.fraction,
        grad_workers=chosen.grad_workers,
        n_cols=chosen.n_cols,
        assignment=chosen.assignment,
        predicted=chosen,
        flat_predicted=flat,
        candidates=tuple(evals),
    )
