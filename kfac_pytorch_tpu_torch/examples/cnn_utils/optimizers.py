"""Optimizer and preconditioner of the CNN trainers.

Port of ``examples/cnn_utils/optimizers.py``: SGD with momentum and
weight decay, a learning rate that warms up and decays by epoch (as a
function of the optimizer step, through ``LambdaLR``), an optional
``KFACPreconditioner`` whose kl-clip ``lr`` is the same schedule, and a
``LambdaParamScheduler`` that decays the damping and the update
intervals at the given epochs.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from kfac_pytorch_tpu_torch.examples.utils import create_lr_schedule
from kfac_pytorch_tpu_torch.preconditioner import KFACPreconditioner
from kfac_pytorch_tpu_torch.scheduler import LambdaParamScheduler


def get_optimizer(
    model: torch.nn.Module,
    args: Any,
    steps_per_epoch: int,
    world: int = 1,
) -> tuple[
    torch.optim.SGD,
    torch.optim.lr_scheduler.LambdaLR,
    KFACPreconditioner | None,
    LambdaParamScheduler | None,
    Callable[[int], float],
]:
    """``(optimizer, lr_scheduler, preconditioner, kfac_scheduler,
    lr_schedule)``.

    ``model`` is the module the optimizer steps, wrapped in
    ``DistributedDataParallel`` or bare; ``args`` carries the trainers'
    flags.  ``lr_schedule(step)`` is the learning rate at optimizer step
    ``step`` (epoch ``step // steps_per_epoch``): ``lr_scheduler``
    applies it to the optimizer (step it after each ``optimizer.step()``)
    and the preconditioner's kl-clip reads it at its own step count,
    which is the optimizer's.  ``--kfac-inv-update-steps 0`` gives no
    preconditioner.
    """
    scale_fn = create_lr_schedule(world, args.warmup_epochs, args.lr_decay)
    base_lr = args.base_lr * world

    def lr_schedule(step: int) -> float:
        return base_lr * scale_fn(step // steps_per_epoch)

    optimizer = torch.optim.SGD(
        model.parameters(), lr=base_lr, momentum=args.momentum,
        weight_decay=args.weight_decay,
    )
    lr_scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: scale_fn(step // steps_per_epoch),
    )
    if getattr(args, 'kfac_inv_update_steps', 0) <= 0:
        return optimizer, lr_scheduler, None, None, lr_schedule

    precond = KFACPreconditioner(
        model,
        factor_update_steps=args.kfac_factor_update_steps,
        inv_update_steps=args.kfac_inv_update_steps,
        damping=args.kfac_damping,
        factor_decay=args.kfac_factor_decay,
        kl_clip=args.kfac_kl_clip,
        lr=lr_schedule,
        accumulation_steps=getattr(args, 'batches_per_allreduce', 1),
        colocate_factors=args.kfac_colocate_factors,
        compute_method=getattr(args, 'kfac_compute_method', 'eigen'),
        grad_worker_fraction=args.kfac_worker_fraction,
        skip_layers=args.kfac_skip_layers,
        lowrank_rank=getattr(args, 'kfac_lowrank_rank', None),
        ekfac=getattr(args, 'kfac_ekfac', False),
    )

    def epoch_of(step: int) -> int:
        return step // max(1, steps_per_epoch)

    damping_decay = getattr(args, 'kfac_damping_decay', None) or []
    update_decay = getattr(args, 'kfac_update_steps_decay', None) or []
    damping_alpha = getattr(args, 'kfac_damping_alpha', 0.5)
    update_alpha = getattr(args, 'kfac_update_steps_alpha', 10)

    def decay_lambda(epochs, alpha):
        # The scheduler multiplies the stored value on every .step()
        # (once per epoch in the trainers), so the lambda gives alpha
        # only on entering a decay epoch and 1 otherwise.
        boundaries = set(epochs)

        def fn(step: int) -> float:
            return float(alpha) if epoch_of(step) in boundaries else 1.0
        return fn

    kfac_scheduler = LambdaParamScheduler(
        precond,
        damping_lambda=(decay_lambda(damping_decay, damping_alpha)
                        if damping_decay else None),
        factor_update_steps_lambda=(decay_lambda(update_decay, update_alpha)
                                    if update_decay else None),
        inv_update_steps_lambda=(decay_lambda(update_decay, update_alpha)
                                 if update_decay else None),
    )
    return optimizer, lr_scheduler, precond, kfac_scheduler, lr_schedule
