"""Observability: timeline, cost/comm ledger, monitor, emission, flight
recorder.

Port of ``kfac_pytorch_tpu/observe``.  Opt-in: without an
:class:`ObserveConfig` the engine runs exactly the unobserved step (the
same bits, the same ``last_step_info`` keys, no profiler ranges, no
host reads).  With one:

* **timeline** (:mod:`~kfac_pytorch_tpu_torch.observe.timeline`) — per
  phase ``torch.profiler.record_function('kfac/<phase>')`` ranges, and
  whole-step times per variant with one synchronize a step;
* **costs** (:mod:`~kfac_pytorch_tpu_torch.observe.costs`) — counted
  step FLOPs and the KAISA communication ledger of the port's
  collectives;
* **monitor** (:mod:`~kfac_pytorch_tpu_torch.observe.monitor`) —
  curvature statistics (spectrum extremes, damping-to-spectrum ratio,
  gradient norms, the kl-clip ``nu``) under
  ``last_step_info['observe/*']``, as device tensors, with no extra
  decomposition;
* **emission** (:mod:`~kfac_pytorch_tpu_torch.observe.emit`,
  :mod:`~kfac_pytorch_tpu_torch.observe.report`,
  :mod:`~kfac_pytorch_tpu_torch.observe.aggregate`) — per-process
  JSONL/CSV/logger sinks, phase and Amdahl tables, BENCH-schema payloads
  and the run-level merge of the shards;
* **flight** (:mod:`~kfac_pytorch_tpu_torch.observe.flight`) — the black
  box: a ring of per-step scalars and crash-consistent postmortems.

Usage::

    from kfac_pytorch_tpu_torch.observe import Emitter, ObserveConfig

    precond = KFACPreconditioner(model, observe=ObserveConfig(),
                                 flight=FlightConfig(path='pm.json'))
    ...
    info = precond.last_step_info          # has 'observe/*' tensors
    emitter.emit('step', observe_scalars(info), step=precond.steps)
"""
from __future__ import annotations

import dataclasses

from kfac_pytorch_tpu_torch.observe import aggregate
from kfac_pytorch_tpu_torch.observe import costs
from kfac_pytorch_tpu_torch.observe import emit
from kfac_pytorch_tpu_torch.observe import flight
from kfac_pytorch_tpu_torch.observe import monitor
from kfac_pytorch_tpu_torch.observe import report
from kfac_pytorch_tpu_torch.observe import timeline
from kfac_pytorch_tpu_torch.observe.aggregate import format_run_report
from kfac_pytorch_tpu_torch.observe.aggregate import merge_run_dir
from kfac_pytorch_tpu_torch.observe.emit import Emitter
from kfac_pytorch_tpu_torch.observe.flight import FlightConfig
from kfac_pytorch_tpu_torch.observe.flight import FlightRecorder
from kfac_pytorch_tpu_torch.observe.timeline import PHASES
from kfac_pytorch_tpu_torch.observe.timeline import StepTimeline
from kfac_pytorch_tpu_torch.utils.metrics import observe_scalars


@dataclasses.dataclass(frozen=True)
class ObserveConfig:
    """Observability knobs.

    Attributes:
        monitor: compute the curvature and step statistics into
            ``last_step_info['observe/*']`` every step: a handful of
            reductions on the card (and, on a KAISA grid with several
            columns, one small all-reduce of the spectrum extremes over
            the grid row); no host read until a value is read.
        annotate: wrap the step's phases in
            ``torch.profiler.record_function('kfac/<phase>')`` ranges,
            so a profiler trace attributes each kernel to its phase
            (the fused kernel to ``kfac/precondition``, ``eigh`` to
            ``kfac/eigh_refresh``); never a numeric change.
        timeline: record whole-step wall times per variant
            (``step/plain|factor|inv``...) into ``precond.timeline``,
            which costs one ``torch.cuda.synchronize()`` a step; leave
            off for throughput runs and use
            :func:`~kfac_pytorch_tpu_torch.observe.timeline.\
profile_phases` offline instead.
        timeline_history: ring-buffer length per phase.
    """

    monitor: bool = True
    annotate: bool = True
    timeline: bool = False
    timeline_history: int = 512


__all__ = [
    'Emitter',
    'FlightConfig',
    'FlightRecorder',
    'ObserveConfig',
    'PHASES',
    'StepTimeline',
    'aggregate',
    'costs',
    'emit',
    'flight',
    'format_run_report',
    'merge_run_dir',
    'monitor',
    'observe_scalars',
    'report',
    'timeline',
]
