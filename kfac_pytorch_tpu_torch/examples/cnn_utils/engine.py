"""Epoch loops of the CNN trainers: K-FAC or first-order training, with
gradient accumulation, and evaluation.

Port of ``examples/cnn_utils/engine.py``.  A step is PyTorch's own:
forward, ``backward()``, ``precond.step()`` (which preconditions the
``.grad`` in place) and ``optimizer.step()``.  With
``accumulation_steps = N`` each micro-batch's loss is divided by ``N``
and ``backward()`` runs under ``model.no_sync()`` for every micro-batch
of a group but the last when the model is wrapped in
``DistributedDataParallel``; the preconditioner and the optimizer step
once per group.  A trailing partial group of ``m < N`` micro-batches
still reaches the optimizer (``engine.py:218-229`` of the JAX package),
its gradients scaled by ``N / m`` to the mean over its micro-batches.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from kfac_pytorch_tpu_torch.examples.utils import Metric
from kfac_pytorch_tpu_torch.examples.utils import accuracy
from kfac_pytorch_tpu_torch.utils.metrics import MetricsWriter
from kfac_pytorch_tpu_torch.utils.metrics import ProgressMeter


def to_device(
    batch: tuple[np.ndarray, np.ndarray], device: torch.device | str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A loader's ``([N, H, W, C] images, labels)`` as an NCHW float
    tensor and int64 labels on ``device``."""
    x, y = batch
    x = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    return (x.contiguous().to(device, non_blocking=True),
            torch.from_numpy(np.asarray(y)).long().to(device))


def train(
    epoch: int,
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    precond: Any,
    loader: Iterable,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    device: torch.device | str,
    lr_scheduler: Any = None,
    accumulation_steps: int = 1,
    log_every: int = 0,
    writer: MetricsWriter | None = None,
) -> tuple[Metric, Metric]:
    """One training epoch; ``precond`` is a ``KFACPreconditioner`` or
    ``None`` (first-order training).  ``model`` is the module the loss
    runs through, ``DistributedDataParallel`` or bare.  Returns the loss
    and accuracy metrics; with a ``writer``, the epoch's scalars are
    recorded under ``train/``."""
    if hasattr(loader, 'set_epoch'):
        loader.set_epoch(epoch)
    model.train()
    train_loss = Metric('train_loss')
    train_acc = Metric('train_accuracy')
    meter = ProgressMeter()
    n = max(1, accumulation_steps)
    ddp = isinstance(model, nn.parallel.DistributedDataParallel)
    n_batches = len(loader)
    micro = 0
    optimizer.zero_grad(set_to_none=True)
    for i, batch in enumerate(loader):
        x, y = to_device(batch, device)
        sync = micro + 1 == n or i + 1 == n_batches
        ctx = model.no_sync() if ddp and not sync else contextlib.nullcontext()
        with ctx:
            logits = model(x)
            loss = loss_fn(logits, y)
            (loss / n if n > 1 else loss).backward()
        micro += 1
        train_loss.update(loss.detach())
        train_acc.update(accuracy(logits.detach(), y))
        meter.tick(int(y.shape[0]))
        if sync:
            if micro < n:
                with torch.no_grad():
                    for p in model.parameters():
                        if p.grad is not None:
                            p.grad *= n / micro
            if precond is not None:
                precond.step()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            if lr_scheduler is not None:
                lr_scheduler.step()
            micro = 0
        if log_every and (i + 1) % log_every == 0:
            print(f'epoch {epoch} step {i + 1}: loss={train_loss.avg:.4f} '
                  f'acc={train_acc.avg:.4f} '
                  f'({meter.samples_per_sec:.1f} samples/s)', flush=True)
    _write_train_scalars(writer, epoch, train_loss, train_acc, meter)
    return train_loss, train_acc


def train_sgd(
    epoch: int,
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loader: Iterable,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    **kw: Any,
) -> tuple[Metric, Metric]:
    """One first-order training epoch (no preconditioner): the K-FAC
    trainers' ``--kfac-inv-update-steps 0`` baseline; takes the keywords
    of :func:`train`."""
    return train(epoch, model, optimizer, None, loader, loss_fn, **kw)


def _write_train_scalars(writer, epoch, train_loss, train_acc, meter):
    # Every rank reads the metrics (the read is a collective).
    scalars = {
        'train/loss': train_loss.avg,
        'train/accuracy': train_acc.avg,
        'train/steps_per_sec': meter.steps_per_sec,
        'train/samples_per_sec': meter.samples_per_sec,
    }
    if writer is not None:
        writer.scalars(scalars, step=epoch)


@torch.no_grad()
def evaluate(
    epoch: int,
    model: nn.Module,
    loader: Iterable,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    device: torch.device | str,
    writer: MetricsWriter | None = None,
) -> tuple[Metric, Metric]:
    """Evaluation epoch: loss and top-1 accuracy, BatchNorm on its
    running statistics."""
    model.eval()
    val_loss = Metric('val_loss')
    val_acc = Metric('val_accuracy')
    for batch in loader:
        x, y = to_device(batch, device)
        logits = model(x)
        val_loss.update(loss_fn(logits, y))
        val_acc.update(accuracy(logits, y))
    scalars = {'val/loss': val_loss.avg, 'val/accuracy': val_acc.avg}
    if writer is not None:
        writer.scalars(scalars, step=epoch)
    model.train()
    return val_loss, val_acc
