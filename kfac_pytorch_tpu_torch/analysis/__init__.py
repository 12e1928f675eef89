"""Source analysis of the port (JAX ``kfac_pytorch_tpu/analysis/``).

* **SPMD collective discipline**
  (:mod:`~kfac_pytorch_tpu_torch.analysis.collective`): the
  rank-divergence lint over ``torch.distributed`` call sites.
  Collectives dominated by rank-divergent control flow (rank guards,
  except/retry bodies, conditional returns), rank-divergent collective
  arguments and the barrier-tag order, with interprocedural carrier
  propagation and reasoned ``# spmd:`` pragma exemptions.
  ``collective.lint_paths(['kfac_pytorch_tpu_torch'])`` sweeps the port.

The JAX package's retrace guard, trace contracts, AST lint and compiled
HLO audit are not ported yet.
"""
