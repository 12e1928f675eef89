"""Static analysis of the port (JAX ``kfac_pytorch_tpu/analysis/``).

* **retrace guard** (:mod:`~kfac_pytorch_tpu_torch.analysis.retrace`):
  program accounting at the engine's dispatch point: per-variant
  abstract signatures of what each step variant reads, a declared
  ``compile_budget``, and per-leaf diffs (shape, dtype, a host scalar
  against a 0-d tensor, structure) on any retrace.
* **trace contracts** (:mod:`~kfac_pytorch_tpu_torch.analysis.contracts`):
  every step variant dry-run on fake tensors (``FakeTensorMode``): the
  state fixpoint and gradient contracts, per-layer factor, packed-triangle
  and bucket-plan arithmetic, the default-off observe parity pin, and the
  precondition tail's graph breaks under ``torch.compile``.
* **AST lint** (:mod:`~kfac_pytorch_tpu_torch.analysis.lint`): host
  syncs, default-dtype literals, unseeded RNG and host clocks, float64
  requests on the step's hot path, with ``# torchlint: allow(<rule>)``
  pragmas.
* **SPMD collective discipline**
  (:mod:`~kfac_pytorch_tpu_torch.analysis.collective`): the
  rank-divergence lint over ``torch.distributed`` call sites, with
  reasoned ``# spmd:`` pragmas.

* **collective audit** (:mod:`~kfac_pytorch_tpu_torch.analysis.audit`,
  the counterpart of JAX's ``hlo`` and ``audit``): every collective of
  each step variant recorded on gloo ranks, held to the comm ledger byte
  for byte per class, with the wire dtypes, the schedule digests across
  ranks and JAX's schedule pins, the interleaving of threads and
  communicators, placement containment and peak memory.  JAX's donation
  audit and HLO brackets have no counterpart (eager calls).

CLI: ``python -m kfac_pytorch_tpu_torch.scripts.lint_torch`` (``--check``
/ ``--contracts`` / ``--spmd`` / ``--list-rules`` / ``--comm-audit`` /
``--comm-audit-validate``).  JAX's sharding contracts (``sharding``)
read GSPMD layouts and have no counterpart here: the port has none.
"""
from __future__ import annotations

from kfac_pytorch_tpu_torch.analysis import audit
from kfac_pytorch_tpu_torch.analysis import collective
from kfac_pytorch_tpu_torch.analysis import contracts
from kfac_pytorch_tpu_torch.analysis import lint
from kfac_pytorch_tpu_torch.analysis import retrace
from kfac_pytorch_tpu_torch.analysis import signature
from kfac_pytorch_tpu_torch.analysis.contracts import ContractError
from kfac_pytorch_tpu_torch.analysis.retrace import CompileBudgetError
from kfac_pytorch_tpu_torch.analysis.retrace import JitCache
from kfac_pytorch_tpu_torch.analysis.retrace import RetraceError
from kfac_pytorch_tpu_torch.analysis.retrace import RetraceGuard
from kfac_pytorch_tpu_torch.analysis.retrace import attach_guard
from kfac_pytorch_tpu_torch.analysis.signature import abstract_signature
from kfac_pytorch_tpu_torch.analysis.signature import diff_signatures

__all__ = [
    'CompileBudgetError',
    'ContractError',
    'JitCache',
    'RetraceError',
    'RetraceGuard',
    'abstract_signature',
    'attach_guard',
    'audit',
    'collective',
    'contracts',
    'diff_signatures',
    'lint',
    'retrace',
    'signature',
]
