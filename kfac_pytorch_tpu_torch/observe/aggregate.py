"""Run-level aggregation: merge per-process observe shards (and any
postmortems) into one step-indexed run series.

Port of ``kfac_pytorch_tpu/observe/aggregate.py``, host code only.  The
emission layer (:mod:`~kfac_pytorch_tpu_torch.observe.emit`) writes one
``observe.p<idx>.jsonl`` per process; this module is the merge:

* :func:`merge_run_dir` / :func:`merge_shards` — step-join every shard's
  records (tolerant of the torn trailing line a killed writer leaves,
  :func:`~kfac_pytorch_tpu_torch.observe.emit.read_jsonl`) plus any
  ``postmortem*.json`` black boxes
  (:mod:`~kfac_pytorch_tpu_torch.observe.flight`), whose per-step series
  backfill the steps a killed process never emitted;
* :func:`run_spread` — per key, per step: min / median / max across
  processes;
* :func:`divergence_summary` — keys ranked by worst relative spread
  across processes (replicated scalars should agree to the bit);
* :func:`format_run_report` / :func:`run_payload` /
  :func:`validate_run_payload` — the human table and the BENCH-schema
  machine payload, in the JAX module's schema, so either package's
  validator reads the other's payloads.

Merging never invents values: the per-process series are kept verbatim
(``RunMerge.series[key][step][process]``).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
from typing import Any, Iterable, Mapping

import numpy as np

from kfac_pytorch_tpu_torch.observe.emit import read_jsonl

__all__ = [
    'RUN_SCHEMA',
    'RunMerge',
    'divergence_summary',
    'format_run_report',
    'merge_run_dir',
    'merge_shards',
    'run_payload',
    'run_spread',
    'validate_run_payload',
]

RUN_SCHEMA = 'kfac-run-aggregate-v1'

# Floor under relative spreads: replicated counters sit at exactly 0
# for long stretches; (max-min)/|median| must not blow up there.
_EPS = 1e-12

_SHARD_RE = re.compile(r'\.p(\d+)\.jsonl$')

# Record keys that are bookkeeping, not series values.
_META_KEYS = ('kind', 'step', 'time', 'process')


@dataclasses.dataclass
class RunMerge:
    """One run's merged, step-indexed scalar series.

    ``series[key][step][process] -> value`` keeps every process's
    record verbatim (the bitwise contract); the spread/divergence
    views are computed from it on demand.
    """

    processes: list[int]
    steps: list[int]
    series: dict[str, dict[int, dict[int, float]]]
    sources: dict[str, Any]
    torn_records: int = 0
    unstepped_records: int = 0
    duplicate_records: int = 0
    postmortems: list[dict[str, Any]] = dataclasses.field(
        default_factory=list,
    )

    def keys(self) -> list[str]:
        return sorted(self.series)

    def values_at(self, key: str, step: int) -> dict[int, float]:
        return self.series.get(key, {}).get(step, {})


def _ingest(
    merge: RunMerge,
    process: int,
    step: Any,
    values: Mapping[str, Any],
) -> None:
    if step is None:
        merge.unstepped_records += 1
        return
    step = int(step)
    for key, value in values.items():
        if key in _META_KEYS:
            continue
        if not isinstance(value, (int, float)):
            continue
        per_step = merge.series.setdefault(key, {})
        per_proc = per_step.setdefault(step, {})
        if process in per_proc:
            merge.duplicate_records += 1
        per_proc[process] = float(value)


def merge_shards(
    shards: Mapping[int, str] | Iterable[str],
    postmortems: Iterable[str] = (),
) -> RunMerge:
    """Merge explicit shard paths (``{process: path}`` or paths whose
    names carry the ``.p<idx>.jsonl`` suffix) plus postmortem files.

    Unparseable torn TRAILING records are skipped-and-counted
    (``torn_records``) — the crash signature the aggregator exists
    for; mid-stream corruption raises.  Postmortem step records merge
    under the postmortem's own process index, backfilling steps the
    killed process never emitted; JSONL records win ties (they were
    written live, the black box is a recovery copy).
    """
    if not isinstance(shards, Mapping):
        mapped: dict[int, str] = {}
        for path in shards:
            m = _SHARD_RE.search(os.path.basename(path))
            if not m:
                raise ValueError(
                    f'cannot infer process index from {path!r} — pass '
                    'a {process: path} mapping instead',
                )
            mapped[int(m.group(1))] = path
        shards = mapped

    merge = RunMerge(
        processes=[], steps=[], series={},
        sources={'shards': {}, 'postmortems': []},
    )
    for process in sorted(shards):
        path = shards[process]
        stats: dict[str, int] = {}
        records = read_jsonl(path, stats=stats)
        merge.torn_records += stats.get('torn_tail', 0)
        merge.sources['shards'][process] = {
            'path': path,
            'records': len(records),
            'torn_tail': stats.get('torn_tail', 0),
        }
        if process not in merge.processes:
            merge.processes.append(process)
        for rec in records:
            _ingest(merge, process, rec.get('step'), rec)

    for path in postmortems:
        with open(path) as fh:
            payload = json.load(fh)
        process = int(payload.get('process', 0))
        if process not in merge.processes:
            merge.processes.append(process)
        added = 0
        for rec in payload.get('steps', []):
            step = rec.get('step')
            if step is None:
                merge.unstepped_records += 1
                continue
            # Live JSONL records win ties: only backfill keys the
            # shard never delivered for this step.
            for key, value in rec.items():
                if key in ('step', 'time'):
                    continue
                if not isinstance(value, (int, float)):
                    continue
                per_proc = merge.series.setdefault(key, {}).setdefault(
                    int(step), {},
                )
                if process not in per_proc:
                    per_proc[process] = float(value)
                    added += 1
        summary = {
            'path': path,
            'process': process,
            'trigger': (payload.get('trigger') or {}).get('name'),
            'triggers': [
                t.get('name') for t in payload.get('triggers', [])
            ],
            'steps': len(payload.get('steps', [])),
            'values_backfilled': added,
        }
        merge.postmortems.append(summary)
        merge.sources['postmortems'].append(summary)

    merge.processes.sort()
    all_steps: set[int] = set()
    for per_step in merge.series.values():
        all_steps.update(per_step)
    merge.steps = sorted(all_steps)
    return merge


def merge_run_dir(
    log_dir: str,
    *,
    pattern: str = 'observe.p*.jsonl',
    postmortem_pattern: str = 'postmortem*.json',
) -> RunMerge:
    """Merge every shard (and postmortem) found under ``log_dir``."""
    shards = sorted(glob.glob(os.path.join(log_dir, pattern)))
    if not shards:
        raise FileNotFoundError(
            f'no {pattern!r} shards under {log_dir!r}',
        )
    postmortems = sorted(
        glob.glob(os.path.join(log_dir, postmortem_pattern)),
    )
    return merge_shards(shards, postmortems)


# ----------------------------------------------------------------------
# spread / divergence views
# ----------------------------------------------------------------------


def run_spread(
    merge: RunMerge,
) -> dict[str, dict[int, dict[str, float]]]:
    """Per key, per step: min / median / max / count across processes.

    The replica-spread view of the run — one series per key instead of
    one per (key, process).
    """
    out: dict[str, dict[int, dict[str, float]]] = {}
    for key, per_step in merge.series.items():
        rows: dict[int, dict[str, float]] = {}
        for step, per_proc in per_step.items():
            values = sorted(per_proc.values())
            rows[step] = {
                'min': values[0],
                'median': float(np.median(values)),
                'max': values[-1],
                'count': float(len(values)),
            }
        out[key] = rows
    return out


def divergence_summary(
    merge: RunMerge,
    top: int = 10,
) -> list[dict[str, Any]]:
    """Keys ranked by worst relative cross-process spread.

    For each (key, step) seen by >= 2 processes, the spread is
    ``(max - min) / max(|median|, eps)``; each key reports its worst
    step.  Keys only one process ever emitted (genuinely per-host
    facts, or a crashed peer) are excluded — spread over one sample is
    not divergence.  Non-finite disagreement (one host NaN, another
    finite) ranks as infinite spread.
    """
    rows: list[dict[str, Any]] = []
    for key, per_step in merge.series.items():
        worst: dict[str, Any] | None = None
        for step, per_proc in per_step.items():
            if len(per_proc) < 2:
                continue
            values = list(per_proc.values())
            if all(math.isfinite(v) for v in values):
                lo, hi = min(values), max(values)
                med = abs(float(np.median(values)))
                spread = (hi - lo) / max(med, _EPS)
                if hi == lo:
                    spread = 0.0
            elif len({repr(v) for v in values}) == 1:
                spread = 0.0      # all hosts agree, even on the NaN
            else:
                spread = float('inf')
                lo = hi = float('nan')
            if worst is None or spread > worst['rel_spread']:
                worst = {
                    'key': key,
                    'step': step,
                    'rel_spread': spread,
                    'min': min(values) if spread != float('inf')
                    else None,
                    'max': max(values) if spread != float('inf')
                    else None,
                    'processes': len(per_proc),
                }
        if worst is not None:
            rows.append(worst)
    rows.sort(key=lambda r: -r['rel_spread'])
    return rows[:top]


# ----------------------------------------------------------------------
# reports (the observe/report.py conventions)
# ----------------------------------------------------------------------


def format_run_report(merge: RunMerge, top: int = 10) -> str:
    """Printable run-level report: coverage header, worst-divergence
    table, per-key whole-run extremes."""
    lines = [
        f'run: processes={merge.processes} steps='
        f'[{merge.steps[0]}..{merge.steps[-1]}]' if merge.steps else
        f'run: processes={merge.processes} steps=[]',
    ]
    lines.append(
        f'records: torn_tails={merge.torn_records} '
        f'unstepped={merge.unstepped_records} '
        f'duplicates={merge.duplicate_records} '
        f'postmortems={len(merge.postmortems)}',
    )
    for pm in merge.postmortems:
        lines.append(
            f'  postmortem p{pm["process"]}: trigger='
            f'{pm["trigger"]} steps={pm["steps"]} '
            f'backfilled={pm["values_backfilled"]}',
        )
    div = divergence_summary(merge, top=top)
    if div:
        lines.append('')
        lines.append(
            f'{"worst cross-host divergence":40s} {"step":>6s} '
            f'{"rel spread":>12s}',
        )
        for row in div:
            lines.append(
                f'{row["key"]:40s} {row["step"]:6d} '
                f'{row["rel_spread"]:12.3e}',
            )
    spread = run_spread(merge)
    lines.append('')
    lines.append(
        f'{"series":40s} {"steps":>6s} {"min":>12s} {"median":>12s} '
        f'{"max":>12s}',
    )
    for key in sorted(spread):
        rows = spread[key]
        mins = [r['min'] for r in rows.values()]
        meds = [r['median'] for r in rows.values()]
        maxs = [r['max'] for r in rows.values()]
        lines.append(
            f'{key:40s} {len(rows):6d} {min(mins):12.5g} '
            f'{float(np.median(meds)):12.5g} {max(maxs):12.5g}',
        )
    return '\n'.join(lines)


def run_payload(merge: RunMerge, top: int = 10) -> dict[str, Any]:
    """BENCH-schema machine payload for one merged run.

    ``value`` is the headline honesty number — the worst finite-or-inf
    relative cross-host spread over every multi-process series (0.0
    for a perfectly-agreeing run); ``detail`` carries coverage,
    per-shard provenance, postmortem summaries and the top divergence
    rows.
    """
    div = divergence_summary(merge, top=top)
    worst = div[0]['rel_spread'] if div else 0.0
    return {
        'schema': RUN_SCHEMA,
        'metric': 'kfac_run_aggregate',
        'value': worst,
        'unit': 'max_relative_replica_spread',
        'vs_baseline': None,
        'detail': {
            'processes': list(merge.processes),
            'step_range': (
                [merge.steps[0], merge.steps[-1]] if merge.steps else []
            ),
            'n_steps': len(merge.steps),
            'n_series': len(merge.series),
            'torn_records': merge.torn_records,
            'unstepped_records': merge.unstepped_records,
            'duplicate_records': merge.duplicate_records,
            'sources': merge.sources,
            'postmortems': list(merge.postmortems),
            'divergence': div,
        },
    }


def validate_run_payload(payload: Mapping[str, Any]) -> list[str]:
    """Contract check for a run-aggregate payload (empty = valid)."""
    problems: list[str] = []
    if payload.get('schema') != RUN_SCHEMA:
        problems.append(
            f'schema {payload.get("schema")!r} != {RUN_SCHEMA!r}',
        )
    for key in ('metric', 'value', 'unit', 'detail'):
        if key not in payload:
            problems.append(f'missing top-level key {key!r}')
    value = payload.get('value')
    if not isinstance(value, (int, float)):
        problems.append(f'value is not numeric: {value!r}')
    elif value < 0 or math.isnan(value):
        problems.append(f'value is not a spread: {value!r}')
    detail = payload.get('detail')
    if not isinstance(detail, Mapping):
        problems.append('detail is not a mapping')
        return problems
    if not detail.get('processes'):
        problems.append('detail.processes missing/empty')
    if not isinstance(detail.get('n_steps'), int):
        problems.append('detail.n_steps missing')
    elif detail['n_steps'] < 1:
        problems.append('detail.n_steps < 1 (vacuous merge)')
    if not isinstance(detail.get('divergence'), list):
        problems.append('detail.divergence missing')
    return problems
