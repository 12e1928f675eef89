"""K-FAC preconditioner (main user entry point).

Port of ``kfac_pytorch_tpu/preconditioner.py`` for one device.  The
keyword names and defaults are the JAX package's; the call sequence is
PyTorch's own::

    model = resnet32()                     # on the GPU
    precond = KFACPreconditioner(
        model, factor_update_steps=1, inv_update_steps=10,
        damping=0.003, kl_clip=0.001, lr=0.1,
    )
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    for x, y in loader:
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        precond.step()                     # preconditions .grad in place
        opt.step()

Every JAX option this slice does not port raises ``NotImplementedError``
naming its ``ROADMAP.md`` item; none is silently ignored.  The JAX
``loss_fn``/``apply_kwargs`` have no counterpart: the caller runs the
forward and backward passes itself.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Sequence

import torch
from torch import nn

from kfac_pytorch_tpu_torch.base_preconditioner import BaseKFACPreconditioner
from kfac_pytorch_tpu_torch.capture import DEFAULT_LAYER_TYPES
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.enums import AssignmentStrategy
from kfac_pytorch_tpu_torch.enums import ComputeMethod
from kfac_pytorch_tpu_torch.enums import DistributedStrategy
from kfac_pytorch_tpu_torch.enums import resolve_grad_worker_fraction


def _unported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f'{option} is not ported to the PyTorch package yet '
        f'(ROADMAP.md {item})',
    )


class KFACPreconditioner(BaseKFACPreconditioner):
    """K-FAC preconditioner for ``nn.Linear``/``nn.Conv2d`` layers.

    Args:
        model: the module to precondition; the K-FAC state lives on the
            device of its parameters.
        factor_update_steps: steps between factor EMA updates (callable
            of the step for a schedule).
        inv_update_steps: steps between eigendecomposition refreshes.
        damping: Tikhonov damping (validated ``> 0`` at every step).
        factor_decay: running-average weight of the factor EMAs.
        kl_clip: kl-clip bound, ``None`` to disable the scaling.
        lr: learning rate used by the kl-clip scale.
        assignment_strategy, colocate_factors, grad_worker_fraction:
            KAISA placement knobs; on one device they place nothing.
        compute_method: ``'eigen'`` (the only method ported).
        compute_eigenvalue_outer_product: predivide
            ``1/(dg ⊗ da + damping)`` at refresh time (must be True).
        bucketed: the bucketed second-order stage (must be True or None).
        factor_dtype, inv_dtype: dtypes of the factor EMAs and of the
            decompositions (default f32).
        precond_dtype: operand dtype of the rotation chain (default f32;
            bf16 accumulates in f32).
        cov_dtype: input dtype of the covariance products (default
            ``factor_dtype``).
        skip_layers: regexes of layer names / class names to skip.
        layer_types: kinds to register (default ``{'linear', 'conv2d'}``).
    """

    def __init__(
        self,
        model: nn.Module,
        *,
        factor_update_steps: Callable[[int], int] | int = 1,
        inv_update_steps: Callable[[int], int] | int = 1,
        damping: Callable[[int], float] | float = 0.001,
        factor_decay: Callable[[int], float] | float = 0.95,
        kl_clip: Callable[[int], float] | float | None = 0.001,
        lr: Callable[[int], float] | float = 0.1,
        accumulation_steps: int = 1,
        assignment_strategy: (
            AssignmentStrategy | str
        ) = AssignmentStrategy.COMPUTE,
        colocate_factors: bool = True,
        compute_method: ComputeMethod | str = ComputeMethod.EIGEN,
        iterative_config: Any = None,
        compute_eigenvalue_outer_product: bool = True,
        grad_worker_fraction: (
            DistributedStrategy | float
        ) = DistributedStrategy.COMM_OPT,
        topology: Any = None,
        mesh: Any = None,
        bucketed: bool | None = None,
        factor_dtype: torch.dtype = torch.float32,
        inv_dtype: torch.dtype = torch.float32,
        precond_dtype: torch.dtype | None = None,
        skip_layers: Sequence[str] = (),
        layer_types: Sequence[str] | None = None,
        kfac_approx: Any = 'expand',
        tied_weights: Sequence[str] = (),
        use_pallas: bool | None = None,
        lowrank_rank: int | None = None,
        cov_dtype: torch.dtype | None = None,
        ekfac: bool = False,
        adaptive_refresh: Any = None,
        adaptive: Any = None,
        health: Any = None,
        observe: Any = None,
        compile_budget: int | None = None,
        stagger_refresh: int | None = None,
        overlap_comm: bool = False,
        pipeline_grads: bool = False,
        factor_comm: str | None = None,
        consistency: Any = None,
        watchdog: Any = None,
        flight: Any = None,
        loglevel: int = logging.DEBUG,
    ) -> None:
        if isinstance(assignment_strategy, str):
            assignment_strategy = AssignmentStrategy[
                assignment_strategy.upper()
            ]
        if isinstance(compute_method, str):
            compute_method = ComputeMethod[compute_method.upper()]
        if (
            compute_method == ComputeMethod.EIGEN
            and compute_eigenvalue_outer_product
            and not colocate_factors
        ):
            raise ValueError(
                'colocate_factors must be True to use '
                'compute_eigenvalue_outer_product',
            )
        if compute_method == ComputeMethod.INVERSE:
            raise _unported("compute_method='inverse'", 'Queue A item 8')
        if compute_method == ComputeMethod.ITERATIVE:
            raise _unported("compute_method='iterative'", 'Queue A item 9')
        unported = [
            ('iterative_config', iterative_config is not None, 'item 9'),
            ('compute_eigenvalue_outer_product=False',
             not compute_eigenvalue_outer_product, 'item 4b'),
            ('bucketed=False', bucketed is False, 'item 4b'),
            ('mesh', mesh is not None, 'item 7'),
            ('topology', topology is not None, 'item 29'),
            ('accumulation_steps > 1', accumulation_steps != 1, 'item 14'),
            ("kfac_approx other than 'expand'", kfac_approx != 'expand',
             'item 12'),
            ('tied_weights', bool(tied_weights), 'item 12'),
            ('lowrank_rank', lowrank_rank is not None, 'item 10'),
            ('ekfac', bool(ekfac), 'item 10'),
            ('adaptive_refresh', adaptive_refresh is not None, 'item 10'),
            ('adaptive', adaptive is not None, 'item 16'),
            ('stagger_refresh', stagger_refresh is not None, 'item 15'),
            ('overlap_comm', bool(overlap_comm), 'item 17'),
            ('pipeline_grads', bool(pipeline_grads), 'item 18'),
            ('factor_comm', factor_comm is not None, 'item 13'),
            ('health', health is not None, 'item 19'),
            ('consistency', consistency is not None, 'item 21'),
            ('watchdog', watchdog is not None, 'item 21'),
            ('observe', observe is not None, 'item 23'),
            ('flight', flight is not None, 'item 23'),
            ('compile_budget', compile_budget is not None, 'item 31'),
        ]
        for option, requested, item in unported:
            if requested:
                raise _unported(option, f'Queue A {item}')
        if use_pallas is not None:
            raise NotImplementedError(
                'use_pallas has no counterpart in the PyTorch package: '
                'CUDA tensors always run the fused CUDA kernel and CPU '
                'tensors its plain version (ROADMAP.md Queue B item 1)',
            )
        self.grad_worker_fraction, self.distributed_strategy = (
            resolve_grad_worker_fraction(grad_worker_fraction, 1)
        )
        self.assignment_strategy = assignment_strategy
        self.colocate_factors = colocate_factors
        self.compute_method = compute_method
        self.skip_layers = tuple(skip_layers)
        capture = ModelCapture(
            model,
            skip_layers=self.skip_layers,
            layer_types=(
                DEFAULT_LAYER_TYPES if layer_types is None else layer_types
            ),
        )
        super().__init__(
            capture,
            factor_update_steps=factor_update_steps,
            inv_update_steps=inv_update_steps,
            damping=damping,
            factor_decay=factor_decay,
            kl_clip=kl_clip,
            lr=lr,
            factor_dtype=factor_dtype,
            inv_dtype=inv_dtype,
            precond_dtype=(
                torch.float32 if precond_dtype is None else precond_dtype
            ),
            cov_dtype=cov_dtype,
            loglevel=loglevel,
        )
