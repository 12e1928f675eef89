"""Training-run scalars: a metrics writer and a progress meter.

Port of ``MetricsWriter`` and ``ProgressMeter``
(``kfac_pytorch_tpu/utils/metrics.py:113,272``): every scalar goes to an
append-only ``metrics.jsonl`` (``{"tag", "value", "step", "time"}`` per
line), mirrored to TensorBoard through ``torch.utils.tensorboard`` when
that imports; only rank 0 of ``torch.distributed`` writes.
:func:`health_scalars` and :func:`watchdog_scalars` flatten the
``health/*`` and ``watchdog/*`` counters of ``last_step_info`` for
``metrics.jsonl``, and :func:`observe_scalars` the ``observe/*``
monitor scalars (:mod:`kfac_pytorch_tpu_torch.observe`).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

import torch.distributed as dist


def flatten_scalars(
    values: Mapping[str, Any], prefix: str = '', sep: str = '/',
) -> dict[str, float]:
    """Nested mappings flattened to ``parent/child`` tags, every leaf
    through ``float()``."""
    out: dict[str, float] = {}
    for tag, value in values.items():
        key = f'{prefix}{sep}{tag}' if prefix else str(tag)
        if isinstance(value, Mapping):
            out.update(flatten_scalars(value, prefix=key, sep=sep))
        else:
            out[key] = float(value)
    return out


def _prefixed_scalars(
    last_step_info: Mapping[str, Any] | None, prefix: str,
) -> dict[str, float]:
    if not last_step_info:
        return {}
    return {
        tag: value
        for tag, value in flatten_scalars(last_step_info).items()
        if tag.startswith(prefix)
    }


def health_scalars(
    last_step_info: Mapping[str, Any] | None,
) -> dict[str, float]:
    """The ``health/*`` counters of ``precond.last_step_info`` as host
    floats (JAX ``utils/metrics.py:70-83``; one host read per value, so
    sample at the logging cadence), empty when the guardrails are off.
    Host-side events are tallied in :func:`kfac_pytorch_tpu_torch.\
tracing.get_events`."""
    return _prefixed_scalars(last_step_info, 'health/')


def observe_scalars(
    last_step_info: Mapping[str, Any] | None,
) -> dict[str, float]:
    """The ``observe/*`` monitor scalars of ``precond.last_step_info`` as
    host floats (JAX ``utils/metrics.py:85-95``; one host read per value),
    empty when the monitor is off."""
    return _prefixed_scalars(last_step_info, 'observe/')


def watchdog_scalars(
    last_step_info: Mapping[str, Any] | None,
) -> dict[str, float]:
    """The ``watchdog/*`` counters of ``precond.last_step_info`` as host
    floats (JAX ``utils/metrics.py:98-110``).  They are CPU tensors the
    host wrote, so reading them syncs no device; empty without a
    watchdog."""
    return _prefixed_scalars(last_step_info, 'watchdog/')


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class MetricsWriter:
    """Append-only scalar log (JSONL, and TensorBoard when it imports).

    Args:
        log_dir: directory of ``metrics.jsonl`` (created if needed).
        use_tensorboard: force the TensorBoard mirror on or off; ``None``
            uses it when ``torch.utils.tensorboard`` imports.
        filename: the JSONL file's name in ``log_dir``.
    """

    def __init__(self, log_dir: str, use_tensorboard: bool | None = None,
                 filename: str = 'metrics.jsonl') -> None:
        self.log_dir = log_dir
        self._fh = None
        self._tb = None
        self._use_tb = use_tensorboard
        if _rank() != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, 'a', buffering=1)  # line-buffered

    def _tb_writer(self):
        if self._use_tb is False:
            return None
        if self._tb is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(self.log_dir, 'tb'))
            except Exception:
                if self._use_tb:
                    raise
                self._use_tb = False
                return None
        return self._tb

    def scalar(self, tag: str, value: Any, step: int) -> None:
        """Record one scalar (a tensor is read with ``float()``)."""
        if self._fh is None:
            return
        value = float(value)
        self._fh.write(json.dumps({
            'tag': tag, 'value': value, 'step': int(step),
            'time': time.time(),
        }) + '\n')
        tb = self._tb_writer()
        if tb is not None:
            tb.add_scalar(tag, value, global_step=step)

    def scalars(self, values: Mapping[str, Any], step: int) -> None:
        """Record a dict of scalars (nested dicts as ``a/b`` tags)."""
        for tag, value in flatten_scalars(values).items():
            self.scalar(tag, value, step)

    def record(self, tag: str, payload: Mapping[str, Any]) -> None:
        """Append one non-scalar record (the environment, a config);
        JSONL only."""
        if self._fh is None:
            return
        self._fh.write(json.dumps({
            'tag': tag, 'time': time.time(), **dict(payload),
        }) + '\n')

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._fh is not None:
            self.flush()
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self) -> 'MetricsWriter':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class ProgressMeter:
    """Steps and samples per second since the last :meth:`reset`; call
    :meth:`tick` once per step with its number of samples."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._samples = 0

    def tick(self, n_samples: int = 0) -> None:
        self._steps += 1
        self._samples += n_samples

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self._steps / max(self.elapsed, 1e-9)

    @property
    def samples_per_sec(self) -> float:
        return self._samples / max(self.elapsed, 1e-9)
