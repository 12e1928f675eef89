"""Phase reports: printable tables, Amdahl breakdown, BENCH payloads.

Port of ``kfac_pytorch_tpu/observe/report.py``, host code only.  It turns
:func:`kfac_pytorch_tpu_torch.observe.timeline.profile_phases` output
into a human phase table (ms, share of total), an Amdahl breakdown (per
phase the amortized per-step share under the cadence, and the bound on
the whole-run speedup if that phase alone went to zero,
``1 / (1 - share)``) and a BENCH-schema payload
(``metric``/``value``/``unit``/``vs_baseline``/``detail``) whose
``detail.env`` is the port's
:func:`~kfac_pytorch_tpu_torch.utils.backend.environment_summary` (the
card's name and power limit).  :func:`validate_bench_payload` checks the
payload's contract.  Every number it reports is one the caller measured;
a payload built from a CPU run carries ``env.device == 'cpu'``.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

from kfac_pytorch_tpu_torch.observe.timeline import PHASES

# detail['phases_ms'] keys every BENCH profile payload must carry.
REQUIRED_PHASE_KEYS = PHASES


def format_placement(plan: Any) -> str:
    """The auto-placement report of a solved plan
    (:func:`kfac_pytorch_tpu_torch.placement.apply.format_placement`)."""
    from kfac_pytorch_tpu_torch.placement.apply import (
        format_placement as _format,
    )

    return _format(plan)


def phase_table(
    phases_s: Mapping[str, float],
    total_s: float | None = None,
) -> str:
    """Aligned per-phase table in ms with share-of-total percentages.

    ``total_s`` defaults to the sum of phases; passing the measured
    back-to-back chain instead surfaces fusion/dispatch slack as a
    total != 100% sum line.
    """
    phase_sum = sum(phases_s.values())
    denom = total_s if total_s else phase_sum
    lines = [f'{"phase":16s} {"ms":>10s} {"share":>8s}']
    for name, seconds in phases_s.items():
        share = seconds / denom if denom else 0.0
        lines.append(f'{name:16s} {seconds * 1e3:10.3f} {share:8.1%}')
    lines.append(f'{"sum":16s} {phase_sum * 1e3:10.3f}')
    if total_s is not None:
        lines.append(f'{"total (chained)":16s} {total_s * 1e3:10.3f}')
    return '\n'.join(lines)


def amortized_phase_share(
    phases_s: Mapping[str, float],
    factor_update_steps: int,
    inv_update_steps: int,
    plain_s: float | None = None,
) -> dict[str, float]:
    """Average per-step seconds attributed to each phase under a cadence.

    ``capture`` and ``factor_ema`` bill every ``factor_update_steps``
    steps, ``eigh_refresh`` every ``inv_update_steps``, and
    ``precondition`` every step.  ``plain_s`` (the capture-free
    forward/backward) bills the non-factor steps when provided; without
    it the capture forward/backward stands in for every step's
    forward/backward (an upper bound — capture is a superset of the
    plain program).
    """
    f = max(factor_update_steps, 1)
    i = max(inv_update_steps, 1)
    fwd = phases_s.get('capture', 0.0) if plain_s is None else plain_s
    out = {
        'forward_backward': fwd * (1 - 1 / f),
        'capture': phases_s.get('capture', 0.0) / f,
        'factor_ema': phases_s.get('factor_ema', 0.0) / f,
        'eigh_refresh': phases_s.get('eigh_refresh', 0.0) / i,
        'precondition': phases_s.get('precondition', 0.0),
    }
    return out


def amdahl_breakdown(
    phases_s: Mapping[str, float],
    factor_update_steps: int,
    inv_update_steps: int,
    plain_s: float | None = None,
) -> dict[str, dict[str, float]]:
    """Per-phase amortized share + Amdahl speedup bound.

    For each phase with amortized per-step share ``p``, the whole-run
    speedup from eliminating it entirely is bounded by
    ``1 / (1 - p)`` — the number that says where optimization effort
    pays and where it cannot.
    """
    amort = amortized_phase_share(
        phases_s, factor_update_steps, inv_update_steps, plain_s,
    )
    total = sum(amort.values())
    out: dict[str, dict[str, float]] = {}
    for name, seconds in amort.items():
        share = seconds / total if total else 0.0
        bound = 1.0 / (1.0 - share) if share < 1.0 else math.inf
        out[name] = {
            'amortized_ms': seconds * 1e3,
            'share': share,
            'amdahl_speedup_bound': bound,
        }
    return out


def amdahl_table(breakdown: Mapping[str, Mapping[str, float]]) -> str:
    """Printable form of :func:`amdahl_breakdown`."""
    lines = [
        f'{"phase":16s} {"amort ms/step":>14s} {"share":>8s} '
        f'{"max speedup":>12s}',
    ]
    for name, row in breakdown.items():
        lines.append(
            f'{name:16s} {row["amortized_ms"]:14.3f} {row["share"]:8.1%} '
            f'{row["amdahl_speedup_bound"]:11.2f}x',
        )
    return '\n'.join(lines)


def bench_payload(
    phases_s: Mapping[str, float],
    total_s: float,
    *,
    model: str,
    factor_update_steps: int,
    inv_update_steps: int,
    plain_s: float | None = None,
    extra_detail: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """BENCH-schema JSON for one phase profile.

    ``value`` is the amortized per-step ms under the cadence;
    ``detail.phases_ms`` carries the raw per-phase program times and
    ``detail.phase_sum_vs_total`` the decomposition honesty check
    (sum of separately-timed phases over the chained total).
    """
    from kfac_pytorch_tpu_torch.utils.backend import environment_summary

    breakdown = amdahl_breakdown(
        phases_s, factor_update_steps, inv_update_steps, plain_s,
    )
    amortized_ms = sum(row['amortized_ms'] for row in breakdown.values())
    phase_sum = sum(phases_s.values())
    return {
        'metric': f'kfac_phase_profile_{model}',
        'value': round(amortized_ms, 4),
        'unit': 'ms_per_step_amortized',
        'vs_baseline': None,
        'detail': {
            'phases_ms': {
                name: round(seconds * 1e3, 4)
                for name, seconds in phases_s.items()
            },
            'plain_ms': (
                None if plain_s is None else round(plain_s * 1e3, 4)
            ),
            'total_ms': round(total_s * 1e3, 4),
            'phase_sum_ms': round(phase_sum * 1e3, 4),
            'phase_sum_vs_total': (
                round(phase_sum / total_s, 4) if total_s else None
            ),
            'cadence': {
                'factor': factor_update_steps, 'inv': inv_update_steps,
            },
            'amdahl': breakdown,
            **(dict(extra_detail) if extra_detail else {}),
            'env': environment_summary(),
        },
    }


def validate_bench_payload(payload: Mapping[str, Any]) -> list[str]:
    """Contract check for a phase-profile BENCH payload.

    Returns a list of human-readable problems (empty = valid): missing
    top-level keys, missing required phase keys, or non-finite
    timings.
    """
    problems: list[str] = []
    for key in ('metric', 'value', 'unit', 'detail'):
        if key not in payload:
            problems.append(f'missing top-level key {key!r}')
    detail = payload.get('detail')
    if not isinstance(detail, Mapping):
        problems.append('detail is not a mapping')
        return problems
    phases = detail.get('phases_ms')
    if not isinstance(phases, Mapping):
        problems.append('detail.phases_ms missing')
        return problems
    for name in REQUIRED_PHASE_KEYS:
        if name not in phases:
            problems.append(f'detail.phases_ms missing phase {name!r}')
    numeric = dict(phases)
    numeric['total_ms'] = detail.get('total_ms')
    numeric['value'] = payload.get('value')
    for name, value in numeric.items():
        if not isinstance(value, (int, float)) or not math.isfinite(value):
            problems.append(f'non-finite timing {name}={value!r}')
        elif value < 0:
            problems.append(f'negative timing {name}={value!r}')
    return problems
