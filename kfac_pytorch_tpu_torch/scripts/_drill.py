"""The fault drills' shared artifact convention and pinned constants.

Port of ``scripts/fault_drill.py:116-380``.  Every drill artifact
carries ``(schema, schema_version, passed, config, phases)``; the shared
validator (:func:`validate_drill_artifact`) checks that shape once and
each drill's validator re-checks its pinned bounds on top, always
against the constants here, never the artifact's self-reported ones.
The constants keep the JAX drills' values, so the two packages' gates
hold a run to the same pins.

A "device" of the JAX drills' virtual CPU mesh is a rank of a
``torch.distributed`` world here: the drills' world sizes default to the
JAX device counts.
"""
from __future__ import annotations

import json
import os

import numpy as np

# Shared drill-artifact schema version.
DRILL_SCHEMA_VERSION = 2

# Elastic drill: one deterministic tiny-MLP trajectory.
KILL_SAVE_STEP = 6      # the save after step 5 (gen-00000006) is torn
SHORT_STEPS = 8         # same-world bitwise pin horizon
MID_STEPS = 12          # first resize horizon
FINAL_STEPS = 16        # second resize horizon
KILL_AFTER_SHARDS = 2   # shards written before the mid-save SIGKILL
INV_UPDATE_STEPS = 3
# The worlds of the elastic drill: the reference and same-world resume,
# then the two resizes (the JAX drill's 8 -> 4 -> 2 devices).
ELASTIC_WORLDS = (8, 4, 2)
# The layers-only save lands right after the refresh of step 9, so the
# restore's recompute rebuilds the stacks from the EMAs that made them.
LAYERS_ONLY_SAVE_STEP = 10
# Per-leg wall-clock ceiling: a wedged leg must fail the gate, not hang
# it.
LEG_TIMEOUT_S = 600
# Divergence bound of the resize chain against the uninterrupted
# reference (relative l2 per parameter): resharding the batch changes
# the all-reduce order, so the trajectories drift in the low bits.
RESIZE_REL_ERR_BOUND = 1e-2
ELASTIC_SCHEMA = 'kfac-elastic-drill-v1'
HEALTH_SCHEMA = 'kfac-health-drill-v1'

# Consistency drill: the tiny-MLP problem under COMM-OPT, so the
# decomposition stacks are replicated on every rank.
CONS_SCHEMA = 'kfac-consistency-drill-v1'
CONS_TOTAL_STEPS = 14
CONS_CADENCE = 3            # checks at steps 0, 3, 6, 9, 12
CONS_INJECT_STEP = 5        # corruption present from this step on
CONS_INV_UPDATE_STEPS = 4   # injection lands between refreshes
CONS_TARGET_REPLICA = 3     # the corrupted rank
CONS_WORLD = 8
# Exponent-bit flip (f32 bit 27 scales the hit element by 2^16): a
# corruption that preconditions harmfully, so the unguarded contrast
# measurably damages its trajectory.
CONS_FLIP_BIT = 27
# Rejoin bound of the repaired trajectory against the uncorrupted
# reference.
CONS_REJOIN_BOUND = 5e-2

# Trajectory-watchdog drill: COMM-OPT, kl_clip=None so the finite
# curvature poison really damages the trajectory.
WD_SCHEMA = 'kfac-watchdog-drill-v1'
WD_TOTAL_STEPS = 26
WD_INV_UPDATE_STEPS = 4
WD_INJECT_STEP = 16         # a refresh step
WD_POISON_SCALE = 1e-4      # finite multiply of one layer's factor EMAs
WD_WINDOW = 4
WD_CHECK_EVERY = 2
WD_SAVE_EVERY = 2
WD_CLEARANCE = WD_WINDOW + WD_CHECK_EVERY
WD_DETECT_BOUND = WD_WINDOW + WD_CHECK_EVERY
WD_REJOIN_BOUND = 3.0
WD_PROBE_MIN_DRIFT = 1e-2
WD_WORLD = 8

# Postmortem (flight-recorder) drill: health + watchdog + observe
# monitor on, so the black box records >= 3 subsystem series.
PM_SCHEMA = 'kfac-postmortem-drill-v1'
PM_TOTAL_STEPS = 16
PM_INV_UPDATE_STEPS = 4
PM_WINDOW = 8
PM_FLUSH_EVERY = 2
PM_KILL_STEP = 13           # SIGKILL before the 14th step, mid-interval
PM_NAN_STEP = 6             # the trigger leg's NaN batch
PM_MIN_OVERLAP_STEPS = 4
PM_MIN_SUBSYSTEMS = 3
PM_WORLD = 8

# Multi-process drill: the elastic drill's trajectory on worlds of real
# processes with the runtime installed.
MP_SCHEMA = 'kfac-multiproc-drill-v1'
MP_NPROCS = 2
# The JAX drill's virtual devices per process; a port process is one
# rank, so this stays in the artifact's config only.
MP_DEVICES_PER_RANK = 4
MP_WORLD_DEVICES = MP_NPROCS * MP_DEVICES_PER_RANK
MP_TOTAL_STEPS = SHORT_STEPS    # saves land at gens 2, 4, 6, 8
MP_SAVE_EVERY = 2
MP_KILL_SAVE_STEP = 6           # rank 1 dies entering the gen-6 save
MP_KILL_RANK = 1
MP_PARITY_REL_ERR_BOUND = 1e-4
MP_INIT_DEADLINE_S = 6.0
MP_INIT_WALL_CAP_S = 60.0
MP_BARRIER_TIMEOUT_S = 60.0
MP_HEARTBEAT_INTERVAL_S = 0.25
MP_HEARTBEAT_GRACE_S = 3.0
MP_DETECT_BOUND_S = 20.0
MP_FLIGHT_WINDOW = 8
MP_FLIGHT_FLUSH_EVERY = 2
# The runtime's EXIT_RANK_DEATH, kept here so the validators import
# nothing heavy; the orchestrator asserts they agree.
MP_EXIT_RANK_DEATH = 87
# Seeded rank-guarded barrier: flagged by the lint before any process
# spawns, then shown to wedge for this long on a live world.
MP_RANK_GUARD_TIMEOUT_S = 6.0
MP_RANK_GUARD_RULE = 'collective-under-rank-guard'


def drill_rel_err(a: dict, b: dict) -> float:
    """Worst per-key relative l2 error between two flat param dicts.

    A NaN or inf ratio returns ``inf`` at once: folding it through
    ``max()`` would drop NaN (``max(x, nan) == x``) and a trajectory
    that diverged to NaN would read as close.
    """
    worst = 0.0
    for k in a:
        diff = float(np.linalg.norm(a[k] - b[k]))
        den = float(np.linalg.norm(b[k])) + 1e-12
        ratio = diff / den
        if not np.isfinite(ratio):
            return float('inf')
        worst = max(worst, ratio)
    return worst


def drill_artifact(
    schema: str, passed: bool, config: dict, phases: dict,
) -> dict:
    """The shared artifact shape every drill writes."""
    return {
        'schema': schema,
        'schema_version': DRILL_SCHEMA_VERSION,
        'passed': passed,
        'config': config,
        'phases': phases,
    }


def write_drill_artifact(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
    print(f'wrote {path}')


def validate_drill_artifact(
    path: str,
    schema: str,
    required_phases: tuple[str, ...],
) -> tuple[dict | None, list[str]]:
    """Shared structural gate of any drill artifact: the schema string
    and version, every required phase present with ``ok: true``, the
    artifact marked passed.  Returns ``(payload, errors)``."""
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (OSError, ValueError) as exc:
        return None, [f'artifact unreadable: {exc}']
    errors = []
    if payload.get('schema') != schema:
        errors.append(f'schema {payload.get("schema")!r} != {schema!r}')
    if payload.get('schema_version') != DRILL_SCHEMA_VERSION:
        errors.append(
            f'schema_version {payload.get("schema_version")!r} != '
            f'{DRILL_SCHEMA_VERSION}',
        )
    phases = payload.get('phases', {})
    for name in required_phases:
        phase = phases.get(name)
        if not isinstance(phase, dict):
            errors.append(f'missing phase {name!r}')
            continue
        if phase.get('ok') is not True:
            errors.append(f'phase {name!r} not ok: {phase}')
    if payload.get('passed') is not True:
        errors.append('artifact not marked passed')
    return payload, errors
