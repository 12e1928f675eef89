"""Black-box flight recorder: a bounded per-step ring and crash-consistent
postmortem dumps.

Port of ``kfac_pytorch_tpu/observe/flight.py``.  Production runs die
unwatched: preempted, SIGKILLed, parked by the watchdog, quarantined by
the guards.  This keeps the last ``window`` steps of every subsystem's
scalars step-joined in one ring, snapshots it to disk crash-consistently,
and dumps a ``postmortem.json`` in the JAX module's schema
(:data:`POSTMORTEM_SCHEMA`, version 2) when the run dies or a subsystem
declares it dying, so either package's :func:`validate_postmortem`
checks the other's dumps.

Design contract:

* **the step is untouched** — the recorder only reads
  ``last_step_info`` (device tensors the step already produced) and host
  counters; flight on is bitwise flight off.
* **one batched host read per flush** — ring entries keep unsynced
  device references; each flush reads the pending batch back together:
  the pending scalar tensors widened to f64 (exact for the f32, bf16,
  int32 and bool scalars a step produces) and stacked, one ``.cpu()``
  per device that holds any (:attr:`FlightRecorder.host_syncs` counts
  them; a step's scalars on the card are one read).  Between
  flushes the recorder costs one dict append per step.
* **crash-consistent dumps** — temp write + fsync + ``os.replace`` +
  directory fsync (:func:`~kfac_pytorch_tpu_torch.utils.checkpoint.\
_fsync_dir`), so a kill mid-dump leaves the previous postmortem valid.
  With ``periodic=True`` every flush also snapshots: after a SIGKILL, the
  one signal no handler catches, the last snapshot is the black box.

Dump triggers: the subsystem terminals (the watchdog's park, checked
every step; health's non-finite step-skip and layer quarantine,
:data:`kfac_pytorch_tpu_torch.health.TERMINAL_TRIGGER_COUNTERS`, checked
at each flush over the freshly read counters; the consistency guard's
quarantine, every step), ``atexit`` and SIGTERM (armed by default, off
the main thread the SIGTERM handler is skipped: the ``overlap_comm``
worker is a thread), and a peer's death when a
:class:`~kfac_pytorch_tpu_torch.runtime.DistributedRuntime` is installed
(``on_peer_death``, trigger ``'peer_death'``).

The fingerprint's ``jit_cache_keys`` are the step variants the engine
has run (``step/plain``, ``step/factor``, ...): the port compiles no
programs, and these are the variants the JAX engine compiles one program
each for.
"""
from __future__ import annotations

import atexit
import dataclasses
import itertools
import json
import math
import os
import signal
import threading
import time
from typing import Any, Mapping

import numpy as np
import torch

from kfac_pytorch_tpu_torch import tracing
from kfac_pytorch_tpu_torch.health import terminal_triggers

__all__ = [
    'POSTMORTEM_SCHEMA',
    'POSTMORTEM_SCHEMA_VERSION',
    'SUBSYSTEM_PREFIXES',
    'FlightConfig',
    'FlightRecorder',
    'read_postmortem',
    'validate_postmortem',
]

POSTMORTEM_SCHEMA = 'kfac-postmortem-v1'
POSTMORTEM_SCHEMA_VERSION = 2

#: The subsystem series a postmortem can carry; the validator counts
#: the distinct prefixes present in the step records.
SUBSYSTEM_PREFIXES = (
    'observe/',
    'health/',
    'consistency/',
    'watchdog/',
)


@dataclasses.dataclass(frozen=True)
class FlightConfig:
    """Static knobs of the flight recorder
    (``KFACPreconditioner(flight=FlightConfig(path=...))``).

    Args:
        path: destination of ``postmortem.json``; every dump atomically
            replaces it (``postmortem.p<rank>.json`` per rank across
            several processes).
        window: ring size: how many trailing steps the box keeps.
        flush_every: steps between flushes.  Each flush is the
            recorder's one host read, the health-trigger check and, with
            ``periodic``, a crash-consistent snapshot.
        periodic: snapshot to ``path`` at every flush.
        arm_atexit: dump on interpreter exit.
        arm_sigterm: dump on SIGTERM, chaining any previous handler
            (skipped off the main thread).
        dump_on_trigger: dump the moment a subsystem terminal is seen;
            off, triggers still latch into the history.
    """

    path: str
    window: int = 64
    flush_every: int = 8
    periodic: bool = True
    arm_atexit: bool = True
    arm_sigterm: bool = True
    dump_on_trigger: bool = True

    def __post_init__(self) -> None:
        if not self.path:
            raise ValueError('FlightConfig.path must name the dump file')
        if self.window < 2:
            raise ValueError('window must be >= 2')
        if self.flush_every < 1:
            raise ValueError('flush_every must be >= 1')


def _is_host_value(value: Any) -> bool:
    """True for values readable without a device read (Python, numpy,
    CPU tensors)."""
    if isinstance(value, torch.Tensor):
        return value.device.type == 'cpu'
    return isinstance(value, (int, float, bool, np.generic, np.ndarray))


def _scalarish(value: Any) -> bool:
    """True for 0-d / size-1 values (the ring records scalars only)."""
    if isinstance(value, torch.Tensor):
        return value.numel() == 1
    if isinstance(value, (int, float, bool, np.generic)):
        return True
    shape = getattr(value, 'shape', None)
    return shape is not None and int(np.prod(shape, dtype=np.int64)) == 1


def _process_index() -> int:
    import torch.distributed as dist

    try:
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except (RuntimeError, ValueError):  # group torn down at exit
        pass
    return 0


def _process_count() -> int:
    import torch.distributed as dist

    try:
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
    except (RuntimeError, ValueError):
        pass
    return 1


class FlightRecorder:
    """Host-side black box bound to one preconditioner.

    Built by the engine from a :class:`FlightConfig` (``precond.flight``)
    and fed once per step through ``precond.flight_step(loss)``, after the
    optimizer step (and after ``watchdog_step``, so the ring sees the
    step's final counters); ``train_loop`` feeds it itself.
    """

    def __init__(self, config: FlightConfig, precond: Any) -> None:
        self.config = config
        self._precond = precond
        # Ring of {'step', 'time', 'values': {key: raw}, 'synced'}.
        self._ring: list[dict[str, Any]] = []
        self._fingerprint: dict[str, Any] | None = None
        self.triggers: list[dict[str, Any]] = []
        self._trigger_seen: set[tuple[str, int]] = set()
        # The last checked health snapshot and its step, carried across
        # flushes so each counter increase fires exactly once.
        self._last_health: dict[str, float] | None = None
        self._health_watermark = -1
        self.records_total = 0
        self.dumps_total = 0
        #: Batched reads of pending tensors (one per device holding any,
        #: per flush).
        self.host_syncs = 0
        self.last_dump: dict[str, Any] | None = None
        self._armed_atexit = False
        self._prev_sigterm: Any = None
        # Reentrant: a SIGTERM handler dumping while this thread is inside
        # an atexit or periodic dump must not deadlock.
        self._exit_lock = threading.RLock()
        # A unique temp name per dump: a signal handler may interrupt a
        # dump on the same pid.
        self._tmp_ids = itertools.count()
        self._resolved_path: str | None = None
        if config.arm_atexit or config.arm_sigterm:
            self.arm()
        from kfac_pytorch_tpu_torch import runtime

        rt = runtime.active()
        if rt is not None:
            rt.on_peer_death(self._on_peer_death)

    # -- arming ----------------------------------------------------------

    def arm(self) -> None:
        """Install the atexit/SIGTERM dump handlers (idempotent)."""
        cfg = self.config
        if cfg.arm_atexit and not self._armed_atexit:
            atexit.register(self._exit_dump, 'atexit')
            self._armed_atexit = True
        if (
            cfg.arm_sigterm
            and self._prev_sigterm is None
            and threading.current_thread() is threading.main_thread()
        ):
            try:
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, self._on_sigterm,
                )
            except (ValueError, OSError):
                self._prev_sigterm = None

    def disarm(self) -> None:
        """Remove the exit handlers."""
        if self._armed_atexit:
            atexit.unregister(self._exit_dump)
            self._armed_atexit = False
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None

    def _on_sigterm(self, signum: int, frame: Any) -> None:
        self._exit_dump('sigterm')
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # Re-deliver with the default disposition: a preempting
            # supervisor expects SIGTERM to terminate.
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    def _on_peer_death(self, dead: tuple[int, ...]) -> None:
        self._exit_dump('peer_death')

    def _exit_dump(self, trigger: str) -> None:
        """Best-effort dump on the way out (never raises)."""
        with self._exit_lock:
            try:
                self._latch(trigger, int(self._precond.steps))
                self.dump(trigger)
            except Exception:  # noqa: BLE001 — dying process, best effort
                pass

    # -- recording -------------------------------------------------------

    def record(self, loss: Any = None) -> None:
        """Observe one completed step (a host append, no read): keeps
        ``loss`` and every scalar of ``last_step_info`` as references,
        checks the host-visible triggers, and flushes when the step
        count crosses the flush cadence."""
        precond = self._precond
        step = int(precond.steps)
        values: dict[str, Any] = {}
        if loss is not None:
            values['loss'] = loss
        info = precond.last_step_info or {}
        for key, val in info.items():
            if _scalarish(val):
                values[key] = val
        self._ring.append({
            'step': step,
            'time': time.time(),
            'values': values,
            'synced': False,
        })
        if len(self._ring) > self.config.window:
            del self._ring[: len(self._ring) - self.config.window]
        self.records_total += 1

        fired = self._host_triggers(step, values)
        if step % self.config.flush_every == 0 or fired:
            self.flush(trigger_hint=fired[0] if fired else None)

    def flush(self, trigger_hint: str | None = None) -> None:
        """The host read: pending scalars, the health triggers, and a
        snapshot when periodic."""
        self._sync()
        fired = self._synced_triggers()
        name = trigger_hint or (fired[0] if fired else None)
        if name is not None and self.config.dump_on_trigger:
            self.dump(name)
        elif self.config.periodic:
            self.dump('periodic')

    # -- triggers --------------------------------------------------------

    def _latch(self, name: str, step: int, *, once: bool = False) -> bool:
        """Record one trigger observation; True if it is new (``once``:
        per name, for sticky states)."""
        key = (name, -1) if once else (name, step)
        if key in self._trigger_seen:
            return False
        self._trigger_seen.add(key)
        self.triggers.append({
            'name': name, 'step': step, 'time': time.time(),
        })
        tracing.count_event(f'flight_trigger_{name}', step=step)
        return True

    def _host_triggers(
        self, step: int, values: Mapping[str, Any],
    ) -> list[str]:
        """Terminals visible without a device read."""
        fired = []
        watchdog = getattr(self._precond, '_watchdog', None)
        if watchdog is not None and watchdog.parked:
            if self._latch('watchdog_park', step, once=True):
                fired.append('watchdog_park')
        quar = values.get('consistency/quarantines_total')
        if (
            quar is not None and _is_host_value(quar)
            and float(quar) > 0
        ):
            if self._latch('consistency_quarantine', step, once=True):
                fired.append('consistency_quarantine')
        return fired

    def _synced_triggers(self) -> list[str]:
        """Terminals only visible in the read-back health counters,
        each counter increase once, however the ring slides."""
        fired: list[str] = []
        for entry in self._ring:
            if not entry['synced'] or (
                entry['step'] <= self._health_watermark
            ):
                continue
            cur = {
                k: v for k, v in entry['values'].items()
                if k.startswith('health/')
            }
            if cur:
                for name in terminal_triggers(self._last_health, cur):
                    if self._latch(name, entry['step']):
                        fired.append(name)
                self._last_health = cur
            self._health_watermark = entry['step']
        return fired

    # -- sync ------------------------------------------------------------

    def _sync(self) -> None:
        """Read every pending scalar back: Python and numpy values as
        they are, the tensors widened to f64 and stacked, one read per
        device holding pending tensors (counted in :attr:`host_syncs`)."""
        pending = [e for e in self._ring if not e['synced']]
        if not pending:
            return
        by_device: dict[torch.device, list[tuple[dict, str, Any]]] = {}
        for entry in pending:
            for key, val in entry['values'].items():
                if isinstance(val, torch.Tensor):
                    by_device.setdefault(val.device, []).append(
                        (entry, key, val))
                else:
                    entry['values'][key] = float(np.asarray(val).reshape(()))
        for items in by_device.values():
            host = torch.stack([
                v.detach().reshape(()).to(torch.float64)
                for _, _, v in items
            ]).cpu().tolist()
            self.host_syncs += 1
            for (entry, key, _), value in zip(items, host):
                entry['values'][key] = value
        for entry in pending:
            entry['synced'] = True

    # -- fingerprint -----------------------------------------------------

    def _build_fingerprint(self) -> dict[str, Any]:
        """Run identity: config, topology, the step variants run, the
        comm-ledger rows, the environment (cached but for the variants
        and the ledger)."""
        precond = self._precond
        if self._fingerprint is None:
            cfg: dict[str, Any] = {
                'engine': type(precond).__name__,
                'window': self.config.window,
                'flush_every': self.config.flush_every,
            }
            for name in (
                'factor_update_steps', 'inv_update_steps', 'damping',
                'factor_decay', 'kl_clip', 'lr',
            ):
                value = getattr(precond, f'_{name}', None)
                if value is None or not callable(value):
                    cfg[name] = value
            for name in (
                '_stagger_refresh', '_overlap_comm', '_pipeline_grads',
            ):
                cfg[name.lstrip('_')] = getattr(precond, name, None)
            method = getattr(precond, 'compute_method', None)
            cfg['compute_method'] = (
                getattr(method, 'name', None) or str(method)
                if method is not None else None
            )
            try:
                from kfac_pytorch_tpu_torch.utils.backend import (
                    environment_summary,
                )

                env = environment_summary()
            except Exception:  # noqa: BLE001 — fingerprint best effort
                env = {}
            self._fingerprint = {
                'config': cfg,
                'topology': self._maybe(precond._topology_descriptor)
                if hasattr(precond, '_topology_descriptor') else None,
                'env': env,
            }
        out = dict(self._fingerprint)
        out['jit_cache_keys'] = sorted(
            f'step/{v}' for v in getattr(precond, '_variants_run', ()))
        out['ledger'] = self._ledger_rows()
        return out

    @staticmethod
    def _maybe(fn: Any) -> Any:
        try:
            return fn()
        except Exception:  # noqa: BLE001 — fingerprint best effort
            return None

    def _ledger_rows(self) -> list[dict[str, Any]] | None:
        from kfac_pytorch_tpu_torch.observe import costs

        try:
            rows = costs.ledger_for(self._precond)
        except Exception:  # noqa: BLE001 — replicated engine, torn group
            return None
        return [dataclasses.asdict(row) for row in rows]

    # -- dumping ---------------------------------------------------------

    def payload(self, trigger: str) -> dict[str, Any]:
        """Assemble the postmortem dict (reads the ring back first)."""
        self._sync()
        steps = []
        min_step = None
        for entry in self._ring:
            rec: dict[str, Any] = {
                'step': entry['step'], 'time': entry['time'],
            }
            rec.update(entry['values'])
            steps.append(rec)
            if min_step is None:
                min_step = entry['step']
        return {
            'schema': POSTMORTEM_SCHEMA,
            'schema_version': POSTMORTEM_SCHEMA_VERSION,
            'trigger': {
                'name': trigger,
                'step': int(self._precond.steps),
                'time': time.time(),
            },
            'triggers': [dict(t) for t in self.triggers],
            'process': int(_process_index()),
            'window': self.config.window,
            'steps': steps,
            'events': {
                'counts': tracing.get_events(),
                'step_events': tracing.get_step_events(
                    since_step=min_step,
                ),
            },
            'fingerprint': self._build_fingerprint(),
            'counters': {
                'records_total': self.records_total,
                'dumps_total': self.dumps_total,
            },
        }

    def _default_path(self) -> str:
        """The configured path, ``postmortem.p<rank>.json`` in a world of
        several processes (resolved once, so an exit-time dump after the
        group is torn down lands on this rank's file)."""
        if self._resolved_path is not None:
            return self._resolved_path
        path = self.config.path
        if _process_count() > 1:
            root, ext = os.path.splitext(path)
            path = f'{root}.p{_process_index()}{ext}'
        self._resolved_path = path
        return path

    def dump(
        self, trigger: str, path: str | None = None,
    ) -> dict[str, Any]:
        """Write the postmortem crash-consistently; returns the payload."""
        from kfac_pytorch_tpu_torch.utils.checkpoint import _fsync_dir

        payload = self.payload(trigger)
        out = os.path.abspath(path or self._default_path())
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f'{out}.tmp-{os.getpid()}-{next(self._tmp_ids)}'
        with open(tmp, 'w') as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, out)
        _fsync_dir(os.path.dirname(out))
        self.dumps_total += 1
        self.last_dump = {
            'trigger': trigger, 'path': out,
            'step': payload['trigger']['step'],
        }
        return payload


# ----------------------------------------------------------------------
# schema validation
# ----------------------------------------------------------------------


def read_postmortem(path: str) -> dict[str, Any]:
    """Load one postmortem file (raises on a torn one: dumps are atomic,
    so a torn postmortem is a bug, not a crash signature)."""
    with open(path) as fh:
        return json.load(fh)


def validate_postmortem(
    payload: Mapping[str, Any],
    *,
    min_subsystems: int = 3,
    expect_trigger: str | None = None,
) -> list[str]:
    """Contract check of a postmortem payload (empty list = valid), the
    JAX module's: schema and version, a named trigger, a non-empty
    ascending step series with numeric values (finite subsystem
    counters), at least ``min_subsystems`` subsystem series, and a
    fingerprint with its config and variant keys."""
    problems: list[str] = []
    if payload.get('schema') != POSTMORTEM_SCHEMA:
        problems.append(
            f'schema {payload.get("schema")!r} != {POSTMORTEM_SCHEMA!r}',
        )
    if payload.get('schema_version') != POSTMORTEM_SCHEMA_VERSION:
        problems.append(
            f'schema_version {payload.get("schema_version")!r} != '
            f'{POSTMORTEM_SCHEMA_VERSION}',
        )
    trigger = payload.get('trigger')
    if not isinstance(trigger, Mapping) or not trigger.get('name'):
        problems.append('trigger missing or unnamed')
    elif expect_trigger is not None and trigger['name'] != expect_trigger:
        problems.append(
            f'trigger {trigger["name"]!r} != expected {expect_trigger!r}',
        )
    steps = payload.get('steps')
    if not isinstance(steps, list) or not steps:
        problems.append('steps series missing or empty')
        return problems
    last = None
    seen_prefixes: set[str] = set()
    for i, rec in enumerate(steps):
        if not isinstance(rec, Mapping) or 'step' not in rec:
            problems.append(f'steps[{i}] is not a step record')
            continue
        s = rec['step']
        if last is not None and s <= last:
            problems.append(
                f'steps[{i}] step {s} not ascending (prev {last})',
            )
        last = s
        for key, value in rec.items():
            if key in ('step', 'time'):
                continue
            if not isinstance(value, (int, float)):
                problems.append(
                    f'steps[{i}].{key} is not numeric: {value!r}',
                )
            elif not math.isfinite(value) and key.startswith(
                ('health/', 'watchdog/', 'consistency/'),
            ):
                problems.append(
                    f'steps[{i}].{key} counter is non-finite',
                )
            for prefix in SUBSYSTEM_PREFIXES:
                if key.startswith(prefix):
                    seen_prefixes.add(prefix)
    if len(seen_prefixes) < min_subsystems:
        problems.append(
            f'only {len(seen_prefixes)} subsystem series present '
            f'({sorted(seen_prefixes)}) — need >= {min_subsystems} '
            'of ' + '/'.join(SUBSYSTEM_PREFIXES),
        )
    fp = payload.get('fingerprint')
    if not isinstance(fp, Mapping):
        problems.append('fingerprint missing')
    else:
        keys = fp.get('jit_cache_keys')
        if not isinstance(keys, list) or not keys:
            problems.append('fingerprint.jit_cache_keys missing/empty')
        if not isinstance(fp.get('config'), Mapping):
            problems.append('fingerprint.config missing')
    if not isinstance(payload.get('triggers'), list):
        problems.append('triggers history missing')
    events = payload.get('events')
    if not isinstance(events, Mapping) or 'counts' not in events:
        problems.append('events block missing')
    return problems
