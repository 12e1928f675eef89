"""Structured emission sinks for observability records.

Port of ``kfac_pytorch_tpu/observe/emit.py``.  The engine and the monitor
produce flat scalar dicts (stable keys through
:func:`kfac_pytorch_tpu_torch.utils.metrics.flatten_scalars`, the
flattener every emitter of the port uses).  This module fans them out:

* :class:`JsonlSink` — one JSON object per line, per process: every
  process writes its own ``observe.p<process_index>.jsonl`` (per-phase
  timings and communication volumes are per-process facts);
* :class:`CsvSink` — fixed-column CSV (columns frozen from the first
  record's keys);
* :class:`LoggerSink` — a rate-limited mirror to :mod:`logging`.

Every record carries ``kind``, ``step``, ``time`` and ``process``; the
sinks are line-buffered, so a killed run keeps everything emitted before
the kill.  The process index is the ``torch.distributed`` rank when the
default group is initialized, else 0.  The file formats are the JAX
module's, so :func:`read_jsonl` and the aggregation of either package
read the other's shards.
"""
from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Any, IO, Mapping

from kfac_pytorch_tpu_torch.utils.metrics import flatten_scalars

logger = logging.getLogger(__name__)


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class JsonlSink:
    """Append-only per-process JSONL sink.

    Args:
        log_dir: directory for the stream (created if needed).
        filename: base name; the process index is spliced in before the
            extension (``observe.jsonl`` -> ``observe.p0.jsonl``).
        process: explicit process index for the filename (default: the
            ``torch.distributed`` rank, 0 without a group).
        line_fsync: ``fsync`` after every record, so a SIGKILL loses at
            most the line being written (which :func:`read_jsonl` skips
            as a torn tail); one syscall per record.
    """

    def __init__(
        self,
        log_dir: str,
        filename: str = 'observe.jsonl',
        *,
        process: int | None = None,
        line_fsync: bool = False,
    ) -> None:
        os.makedirs(log_dir, exist_ok=True)
        stem, ext = os.path.splitext(filename)
        self.process = _process_index() if process is None else int(process)
        self.line_fsync = bool(line_fsync)
        self.path = os.path.join(
            log_dir, f'{stem}.p{self.process}{ext or ".jsonl"}',
        )
        self._fh: IO[str] | None = open(self.path, 'a', buffering=1)

    def write(self, record: Mapping[str, Any]) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(dict(record)) + '\n')
            if self.line_fsync:
                self._fh.flush()
                os.fsync(self._fh.fileno())

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class CsvSink:
    """Fixed-column CSV sink.

    Columns are frozen from the first record, or, when appending to a
    non-empty file of an earlier run, from its header line.  Later
    records drop unknown keys and blank missing ones; the drops are
    counted (``dropped_keys``, ``drops_total``) and the first one warns,
    naming the column.
    """

    def __init__(
        self,
        log_dir: str,
        filename: str = 'observe.csv',
        *,
        process: int | None = None,
    ) -> None:
        os.makedirs(log_dir, exist_ok=True)
        self.process = _process_index() if process is None else int(process)
        stem, ext = os.path.splitext(filename)
        self.path = os.path.join(
            log_dir, f'{stem}.p{self.process}{ext or ".csv"}',
        )
        self._columns: list[str] | None = None
        if os.path.isfile(self.path) and os.path.getsize(self.path) > 0:
            with open(self.path, newline='') as fh:
                header = next(csv.reader(fh), None)
            if header:
                self._columns = list(header)
        self._fh: IO[str] | None = open(self.path, 'a', buffering=1)
        self._writer: Any = None
        self.dropped_keys: dict[str, int] = {}
        self.drops_total = 0
        self._warned_drop = False

    def write(self, record: Mapping[str, Any]) -> None:
        if self._fh is None:
            return
        if self._writer is None:
            write_header = self._columns is None
            if self._columns is None:
                self._columns = list(record)
            self._writer = csv.DictWriter(
                self._fh, fieldnames=self._columns, extrasaction='ignore',
            )
            if write_header:
                self._writer.writeheader()
        extra = [k for k in record if k not in self._columns]
        if extra:
            for key in extra:
                self.dropped_keys[key] = self.dropped_keys.get(key, 0) + 1
            self.drops_total += len(extra)
            if not self._warned_drop:
                self._warned_drop = True
                logger.warning(
                    'CsvSink %s: dropping key %r (and %d other%s this '
                    'record) absent from the frozen header — the CSV '
                    'columns were fixed by the first record; check '
                    '.dropped_keys for the full tally',
                    self.path, extra[0], len(extra) - 1,
                    '' if len(extra) == 2 else 's',
                )
        self._writer.writerow(
            {col: record.get(col, '') for col in self._columns},
        )

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class LoggerSink:
    """Rate-limited mirror to :mod:`logging`: at most one line per
    ``min_interval_s`` (the first record always logs)."""

    def __init__(
        self,
        log: logging.Logger | None = None,
        level: int = logging.INFO,
        min_interval_s: float = 10.0,
    ) -> None:
        self._log = log or logger
        self._level = level
        self._interval = min_interval_s
        self._last = float('-inf')

    def write(self, record: Mapping[str, Any]) -> None:
        now = time.monotonic()
        if now - self._last < self._interval:
            return
        self._last = now
        kind = record.get('kind', 'observe')
        step = record.get('step')
        payload = {
            k: v for k, v in record.items()
            if k not in ('kind', 'step', 'time', 'process')
        }
        self._log.log(
            self._level, '%s step=%s %s', kind, step, json.dumps(payload),
        )

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class Emitter:
    """Fan-out of observability records to one or more sinks::

        with Emitter.to_dir('logs/run0', csv=True) as emit:
            for step, (x, y) in enumerate(batches):
                loss, _ = loop.step(x, loss_args=(y,))
                if step % 50 == 0:
                    emit.emit('step', {
                        'loss': loss,
                        **observe_scalars(precond.last_step_info),
                    }, step=step)
    """

    def __init__(self, sinks: list[Any]) -> None:
        self.sinks = list(sinks)
        self.process = _process_index()

    @classmethod
    def to_dir(
        cls,
        log_dir: str,
        *,
        jsonl: bool = True,
        csv: bool = False,
        log: bool = False,
        log_interval_s: float = 10.0,
    ) -> 'Emitter':
        sinks: list[Any] = []
        if jsonl:
            sinks.append(JsonlSink(log_dir))
        if csv:
            sinks.append(CsvSink(log_dir))
        if log:
            sinks.append(LoggerSink(min_interval_s=log_interval_s))
        return cls(sinks)

    def emit(
        self,
        kind: str,
        values: Mapping[str, Any],
        step: int | None = None,
    ) -> None:
        """Flatten ``values`` and write one record to every sink.  Device
        scalars are read here (one ``float()`` per value): call at the
        logging cadence, not every step."""
        record: dict[str, Any] = {
            'kind': kind,
            'step': None if step is None else int(step),
            'time': time.time(),
            'process': self.process,
        }
        record.update(flatten_scalars(values))
        for sink in self.sinks:
            sink.write(record)

    def flush(self) -> None:
        for sink in self.sinks:
            sink.flush()

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()

    def __enter__(self) -> 'Emitter':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def read_jsonl(
    path: str,
    *,
    strict: bool = False,
    stats: dict[str, int] | None = None,
) -> list[dict[str, Any]]:
    """Parse one JSONL stream back into records.

    A stream cut off by a kill ends in a torn final line.  The default
    mode skips an unparseable trailing record (counted in
    ``stats['torn_tail']`` when a dict is passed, and in the
    :func:`kfac_pytorch_tpu_torch.tracing.get_events` tally as
    ``observe_jsonl_torn_tail``), keeping every record before it.  A bad
    line with valid records after it is corruption and raises in both
    modes, naming the line; ``strict=True`` also raises on the torn
    tail.
    """
    from kfac_pytorch_tpu_torch import tracing

    out: list[dict[str, Any]] = []
    with open(path) as fh:
        for idx, line in enumerate(fh):
            stripped = line.strip()
            if not stripped:
                continue
            try:
                out.append(json.loads(stripped))
            except json.JSONDecodeError:
                trailing = all(not rest.strip() for rest in fh)
                if strict or not trailing:
                    raise json.JSONDecodeError(
                        f'{path}:{idx + 1}: unparseable JSONL record'
                        + ('' if trailing else
                           ' with valid records after it'
                           ' (mid-stream corruption, not a torn tail)'),
                        stripped, 0,
                    )
                if stats is not None:
                    stats['torn_tail'] = stats.get('torn_tail', 0) + 1
                tracing.count_event('observe_jsonl_torn_tail')
                logger.warning(
                    '%s: skipping torn trailing record (line %d) — '
                    'the crash-time signature of a killed writer',
                    path, idx + 1,
                )
                break
    return out
