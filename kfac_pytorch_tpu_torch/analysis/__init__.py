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

CLI: ``python -m kfac_pytorch_tpu_torch.scripts.lint_torch`` (``--check``
/ ``--contracts`` / ``--spmd`` / ``--list-rules``).  JAX's compiled-HLO
audit (``hlo``, ``audit``) and sharding contracts (``sharding``) read
XLA programs and have no counterpart here.
"""
from __future__ import annotations

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
    'collective',
    'contracts',
    'diff_signatures',
    'lint',
    'retrace',
    'signature',
]
