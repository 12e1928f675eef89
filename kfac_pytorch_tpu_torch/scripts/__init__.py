"""The port's operational scripts (JAX ``scripts/``), run as modules:

* ``python -m kfac_pytorch_tpu_torch.scripts.fault_drill``: the health,
  elastic, consistency, watchdog, postmortem and multi-process drills,
  each with its artifact validator;
* ``python -m kfac_pytorch_tpu_torch.scripts.profile_step``: the
  per-variant step times (sgd, plain, factor, inv) and the smokes with
  their validators.

Every entry point takes ``--device`` (default ``cuda``; ``cuda`` without
a card raises).
"""
