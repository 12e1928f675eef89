"""Lower a :class:`PlacementPlan` into the engine, the payload and a report.

Port of ``kfac_pytorch_tpu/placement/apply.py``.  Three consumers of a
solved plan:

* the **engine**: :func:`lower_plan` builds the plan as the
  :class:`~kfac_pytorch_tpu_torch.assignment.KAISAAssignment` the
  preconditioner stores, and :func:`verify_assignment` checks that the
  greedy reproduces the plan's per-layer placement (the plan is a
  prediction about the assignment; a drift between the two would void
  every priced number);
* the **payload**: :func:`plan_payload` is the JSON form of the plan,
  schema and keys as the JAX package's (a payload of either package
  validates in the other), :func:`validate_plan_payload` its check, and
  :func:`placement_scalars` the flat emitter form;
* the **reader**: :func:`format_placement` prints the candidate table
  and the chosen per-column layout.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

from kfac_pytorch_tpu_torch.assignment import KAISAAssignment
from kfac_pytorch_tpu_torch.placement.solver import PlacementPlan

__all__ = [
    'PLACEMENT_SCHEMA_VERSION',
    'format_placement',
    'lower_plan',
    'placement_scalars',
    'plan_payload',
    'validate_plan_payload',
    'verify_assignment',
]

PLACEMENT_SCHEMA_VERSION = 1


def verify_assignment(
    plan: PlacementPlan,
    assignment: KAISAAssignment,
) -> None:
    """Raise unless a live assignment equals the plan's, naming the first
    divergent layer and factor.

    Both sides are deterministic computations over the same work and the
    same greedy, so a mismatch means the solver priced a placement the
    engine will not run.  The one comparison loop, shared by
    :func:`lower_plan` and the preconditioner's ``'auto'`` path.
    """
    for layer in plan.assignment:
        for factor, worker in plan.assignment[layer].items():
            got = assignment.inv_worker(layer, factor)
            if got != worker:
                raise AssertionError(
                    f'plan/assignment divergence at layer {layer!r} '
                    f'factor {factor!r}: plan places the inverse on '
                    f'worker {worker} (KAISA grid column '
                    f'{worker % plan.n_cols} of {plan.n_cols}), '
                    f'KAISAAssignment computed worker {got} (grid column '
                    f'{got % plan.n_cols}): the plan prices a placement '
                    'the engine will not run',
                )


def lower_plan(
    plan: PlacementPlan,
    *,
    local_rank: int = 0,
) -> KAISAAssignment:
    """The plan as a :class:`KAISAAssignment`, built as the
    preconditioner builds it (same work, grid and greedy) and checked
    against the plan by :func:`verify_assignment`."""
    assignment = KAISAAssignment(
        plan.problem.work(),
        local_rank=local_rank,
        world_size=plan.problem.world,
        grad_worker_fraction=plan.fraction,
        colocate_factors=plan.problem.colocate_factors,
    )
    verify_assignment(plan, assignment)
    return assignment


def placement_scalars(plan: PlacementPlan) -> dict[str, float]:
    """Flat ``placement/*`` scalars for the observe emitters."""
    out = {
        'placement/grad_worker_fraction': plan.fraction,
        'placement/grad_workers': float(plan.grad_workers),
        'placement/n_cols': float(plan.n_cols),
        'placement/interval_seconds': plan.predicted.interval_seconds,
        'placement/flat_interval_seconds': (
            plan.flat_predicted.interval_seconds
        ),
        'placement/comm_seconds': plan.predicted.comm_seconds,
        'placement/compute_seconds': plan.predicted.compute_seconds,
    }
    for scope, b in plan.predicted.bytes_by_scope.items():
        out[f'placement/interval_bytes/{scope}'] = float(b)
    return out


def plan_payload(plan: PlacementPlan) -> dict[str, Any]:
    """The plan as a JSON-ready payload: the chosen fraction, the
    per-layer placement, the interval bytes by link class, the predicted
    interval seconds beside the flat model's price of the same grid, and
    the whole candidate table, enough to see why the planner chose its
    grid without running it again."""
    best_fixed = plan.best_fixed()
    return {
        'schema_version': PLACEMENT_SCHEMA_VERSION,
        'objective': plan.objective,
        'topology': plan.topology.describe(),
        'cadence': {
            'factor_update_steps': plan.problem.factor_update_steps,
            'inv_update_steps': plan.problem.inv_update_steps,
        },
        'compute_method': plan.problem.compute_method,
        'n_layers': len(plan.problem.layer_names),
        'chosen': {
            'grad_worker_fraction': plan.fraction,
            'grad_workers': plan.grad_workers,
            'n_cols': plan.n_cols,
            'strategy': plan.strategy,
            'interval_seconds': plan.predicted.interval_seconds,
            'comm_seconds': plan.predicted.comm_seconds,
            'compute_seconds': plan.predicted.compute_seconds,
            'bytes_by_scope': dict(plan.predicted.bytes_by_scope),
            'scopes': dict(plan.predicted.scopes),
            'flat_interval_seconds': (
                plan.flat_predicted.interval_seconds
            ),
        },
        'best_fixed': {
            'strategy': best_fixed.strategy,
            'grad_worker_fraction': best_fixed.fraction,
            'interval_seconds': best_fixed.interval_seconds,
        },
        'auto_vs_best_fixed': (
            plan.predicted.interval_seconds / best_fixed.interval_seconds
            if best_fixed.interval_seconds > 0 else None
        ),
        'per_layer': {
            layer: {
                'inv_workers': dict(factors),
                'column': plan.layer_column(layer),
            }
            for layer, factors in plan.assignment.items()
        },
        'candidates': [c.summary() for c in plan.candidates],
    }


def validate_plan_payload(payload: Any) -> list[str]:
    """The problems of a plan payload, empty when it is valid: required
    keys, finite numbers, per-link-class bytes as non-negative integers,
    candidate rows with both cost terms, and the chosen row the argmin of
    the candidate table."""
    problems: list[str] = []
    if not isinstance(payload, dict):
        return ['payload is not an object']
    for key in ('schema_version', 'objective', 'topology', 'chosen',
                'best_fixed', 'per_layer', 'candidates', 'cadence'):
        if key not in payload:
            problems.append(f'missing key: {key}')
    if problems:
        return problems
    if payload['schema_version'] != PLACEMENT_SCHEMA_VERSION:
        problems.append(
            f'schema_version {payload["schema_version"]} != '
            f'{PLACEMENT_SCHEMA_VERSION}',
        )
    topo = payload['topology']
    for key in ('ici_size', 'n_groups', 'world',
                'ici_gbytes_per_s', 'dcn_gbytes_per_s'):
        if key not in topo:
            problems.append(f'topology missing {key}')
    chosen = payload['chosen']
    for key in ('grad_worker_fraction', 'grad_workers', 'n_cols',
                'interval_seconds', 'comm_seconds', 'compute_seconds',
                'bytes_by_scope', 'scopes', 'flat_interval_seconds'):
        if key not in chosen:
            problems.append(f'chosen missing {key}')
    if problems:
        return problems
    for key in ('interval_seconds', 'comm_seconds', 'compute_seconds',
                'flat_interval_seconds'):
        v = chosen[key]
        if not isinstance(v, (int, float)) or not math.isfinite(v) \
                or v < 0:
            problems.append(f'chosen.{key} invalid: {v!r}')
    for scope, b in chosen['bytes_by_scope'].items():
        if not isinstance(b, int) or b < 0:
            problems.append(
                f'chosen.bytes_by_scope[{scope!r}] invalid: {b!r}',
            )
    cands = payload['candidates']
    if not isinstance(cands, list) or not cands:
        return problems + ['candidates missing/empty']
    best = None
    for row in cands:
        for key in ('grad_workers', 'n_cols', 'fraction', 'strategy',
                    'comm_seconds', 'compute_seconds',
                    'interval_seconds'):
            if key not in row:
                problems.append(f'candidate row missing {key}: {row}')
                break
        else:
            v = row['interval_seconds']
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                problems.append(
                    f'candidate interval_seconds invalid: {v!r}',
                )
            elif best is None or v < best:
                best = v
    if best is not None and math.isfinite(best):
        if chosen['interval_seconds'] > best * (1 + 1e-12):
            problems.append(
                f'chosen interval_seconds {chosen["interval_seconds"]} '
                f'exceeds candidate minimum {best} — the plan is not '
                'the argmin of its own table',
            )
    return problems


def format_placement(plan: PlacementPlan) -> str:
    """Printable placement report: candidate table + chosen layout."""
    p = plan.predicted
    lines = [
        f'auto-placement on {plan.topology} '
        f'(objective: {plan.objective})',
        f'{"grid":>10s} {"fraction":>9s} {"strategy":>11s} '
        f'{"comm ms":>10s} {"compute ms":>11s} {"interval ms":>12s} '
        f'{"dcn KiB":>10s}',
    ]
    for c in plan.candidates:
        mark = '*' if c.grad_workers == plan.grad_workers else ' '
        lines.append(
            f'{mark}{c.grad_workers:>4d}x{c.n_cols:<4d} '
            f'{c.fraction:>9.4f} {c.strategy:>11s} '
            f'{c.comm_seconds * 1e3:>10.3f} '
            f'{c.compute_seconds * 1e3:>11.3f} '
            f'{c.interval_seconds * 1e3:>12.3f} '
            f'{c.bytes_by_scope.get("dcn", 0) / 1024:>10.1f}',
        )
    lines.append(
        f'chosen: {plan.grad_workers}x{plan.n_cols} grid '
        f'(fraction {plan.fraction:g}, {plan.strategy}); '
        f'predicted {p.interval_seconds * 1e3:.3f} ms/interval '
        f'(flat model would price this grid at '
        f'{plan.flat_predicted.interval_seconds * 1e3:.3f} ms)',
    )
    lines.append(
        'phase scopes: ' + ', '.join(
            f'{phase}={scope}' for phase, scope in sorted(
                p.scopes.items(),
            ) if phase != 'checkpoint'
        ),
    )
    by_col: dict[int, list[str]] = {}
    for layer in plan.assignment:
        by_col.setdefault(plan.layer_column(layer), []).append(layer)
    for col in sorted(by_col):
        lines.append(
            f'  column {col}: ' + ', '.join(sorted(by_col[col])),
        )
    return '\n'.join(lines)
