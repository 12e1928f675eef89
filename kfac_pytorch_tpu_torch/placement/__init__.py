"""Ledger-driven auto-placement on NVLink nodes joined by a network.

Port of ``kfac_pytorch_tpu/placement/``.  It replaces KAISA's hand-tuned
``grad_worker_fraction`` with a topology-aware search: model the cluster
(:class:`PodTopology`: groups of GPUs on one NVLink domain joined by a
slower network), price every legal KAISA grid against the analytic
communication ledger of the observe layer plus an analytic compute term
(:func:`auto_placement`), and lower the winning :class:`PlacementPlan`
into the engine (:func:`lower_plan`, or
``KFACPreconditioner(grad_worker_fraction='auto', topology=...)``).

Usage, on two nodes of four H100s each (one rank per GPU)::

    from kfac_pytorch_tpu_torch.placement import PodTopology

    topo = PodTopology(ici_size=4, n_groups=2)
    precond = KFACPreconditioner(
        ddp_model, grad_worker_fraction='auto', topology=topo, ...)
    print(precond.placement_report())

``tests/test_torch_placement.py`` holds it against the JAX package on the
same problems (plans, payloads, scope-tagged ledgers, the engine's
``'auto'`` step).
"""
from __future__ import annotations

from kfac_pytorch_tpu_torch.placement.apply import format_placement
from kfac_pytorch_tpu_torch.placement.apply import lower_plan
from kfac_pytorch_tpu_torch.placement.apply import placement_scalars
from kfac_pytorch_tpu_torch.placement.apply import plan_payload
from kfac_pytorch_tpu_torch.placement.apply import validate_plan_payload
from kfac_pytorch_tpu_torch.placement.apply import verify_assignment
from kfac_pytorch_tpu_torch.placement.solver import auto_placement
from kfac_pytorch_tpu_torch.placement.solver import CandidateEval
from kfac_pytorch_tpu_torch.placement.solver import evaluate_candidate
from kfac_pytorch_tpu_torch.placement.solver import PlacementPlan
from kfac_pytorch_tpu_torch.placement.solver import PlacementProblem
from kfac_pytorch_tpu_torch.placement.solver import problem_for
from kfac_pytorch_tpu_torch.placement.topology import PodTopology

__all__ = [
    'CandidateEval',
    'PlacementPlan',
    'PlacementProblem',
    'PodTopology',
    'auto_placement',
    'evaluate_candidate',
    'format_placement',
    'lower_plan',
    'placement_scalars',
    'plan_payload',
    'problem_for',
    'validate_plan_payload',
    'verify_assignment',
]
