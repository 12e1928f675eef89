"""CIFAR-10 ResNet trainer with K-FAC, on the card.

Port of ``examples/cifar10_resnet.py``: the same flags and defaults
(``--model`` resnet20, resnet32 or vit_tiny; batch 128 per rank, lr
0.1 x world, decay at epochs 35, 75 and 90, 100 epochs, K-FAC
factor/inverse updates every 1/10 steps, damping 0.003),
plus ``--device``.  ``--batches-per-allreduce N`` accumulates N
micro-batches per optimizer step.  Training resumes from the newest
``checkpoint_{epoch}`` in ``--log-dir``, and the run's environment is the
first record of its ``metrics.jsonl``.  Without ``cifar-10-batches-py``
under ``--data-dir`` it trains on synthetic data of the same shape.

One card::

    python -m kfac_pytorch_tpu_torch.examples.cifar10_resnet

Across ranks (DDP; NCCL with a card per rank, gloo otherwise)::

    torchrun --nproc-per-node 4 -m kfac_pytorch_tpu_torch.examples.cifar10_resnet

``--device cpu`` runs on the CPU; without it the trainer needs a card.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Sequence

import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch import models
from kfac_pytorch_tpu_torch.examples import utils
from kfac_pytorch_tpu_torch.examples.cnn_utils import datasets
from kfac_pytorch_tpu_torch.examples.cnn_utils import engine
from kfac_pytorch_tpu_torch.examples.cnn_utils import optimizers
from kfac_pytorch_tpu_torch.utils.backend import environment_summary
from kfac_pytorch_tpu_torch.utils.metrics import MetricsWriter

CIFAR_MODELS = ('resnet20', 'resnet32', 'vit_tiny')


def add_kfac_args(p: argparse.ArgumentParser, *, inv: int, factor: int,
                  damping: float, update_decay) -> None:
    """The ``--kfac-*`` flags both trainers share (defaults differ)."""
    p.add_argument('--kfac-inv-update-steps', default=inv, type=int,
                   help='0 disables K-FAC')
    p.add_argument('--kfac-factor-update-steps', default=factor, type=int)
    p.add_argument('--kfac-update-steps-alpha', default=10, type=float)
    p.add_argument('--kfac-update-steps-decay', nargs='+', type=int,
                   default=update_decay)
    p.add_argument('--kfac-inv-method', action='store_true',
                   help='use the explicit-inverse method instead of eigen')
    p.add_argument('--kfac-factor-decay', default=0.95, type=float)
    p.add_argument('--kfac-damping', default=damping, type=float)
    p.add_argument('--kfac-damping-alpha', default=0.5, type=float)
    p.add_argument('--kfac-damping-decay', nargs='+', type=int,
                   default=None)
    p.add_argument('--kfac-lowrank-rank', default=None, type=int,
                   help='randomized low-rank eigen rank (sides at least '
                        'twice as wide truncate)')
    p.add_argument('--kfac-ekfac', action='store_true',
                   help='EKFAC scales in the eigenbasis (COMM-OPT only '
                        'across ranks)')
    p.add_argument('--kfac-kl-clip', default=0.001, type=float)
    p.add_argument('--kfac-skip-layers', nargs='+', type=str, default=[])
    p.add_argument('--kfac-colocate-factors', action='store_true',
                   default=True)
    p.add_argument('--kfac-worker-fraction', default=0.25, type=float)


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description='CIFAR-10 ResNet + K-FAC (PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument('--data-dir', default='/tmp/cifar10', type=str,
                   help='dir containing cifar-10-batches-py '
                        '(synthetic fallback if missing)')
    p.add_argument('--log-dir', default='./logs/cifar10', type=str)
    p.add_argument('--checkpoint-format',
                   default='checkpoint_{epoch}', type=str)
    p.add_argument('--seed', default=42, type=int)
    p.add_argument('--device', default=None, type=str,
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--bf16', action='store_true',
                   help='bf16 compute and activations (f32 parameters and '
                        'factor EMAs)')
    p.add_argument('--model', default='resnet32', type=str,
                   help='resnet20, resnet32 or vit_tiny (the 32x32 '
                        'ViT)')
    p.add_argument('--batch-size', default=128, type=int,
                   help='per-rank batch size')
    p.add_argument('--val-batch-size', default=128, type=int)
    p.add_argument('--batches-per-allreduce', default=1, type=int,
                   help='gradient accumulation micro-steps')
    p.add_argument('--epochs', default=100, type=int)
    p.add_argument('--base-lr', default=0.1, type=float)
    p.add_argument('--lr-decay', nargs='+', type=int, default=[35, 75, 90])
    p.add_argument('--warmup-epochs', default=5, type=int)
    p.add_argument('--momentum', default=0.9, type=float)
    p.add_argument('--weight-decay', default=5e-4, type=float)
    p.add_argument('--label-smoothing', default=0.0, type=float)
    add_kfac_args(p, inv=10, factor=1, damping=0.003, update_decay=None)
    return p.parse_args(argv)


def build_model(args, choices, device, **kw) -> torch.nn.Module:
    if args.model not in choices:
        raise ValueError(f'--model must be one of {choices}, got '
                         f'{args.model!r}')
    return getattr(models, args.model)(
        device=device, seed=args.seed,
        dtype=torch.bfloat16 if args.bf16 else torch.float32, **kw,
    )


def run(args, train_loader, val_loader, model, device, world, rank) -> None:
    """The epochs of a trainer: optimizer and preconditioner, auto-resume,
    train, evaluate, schedule, checkpoint.  Shared by both CLIs."""
    args.kfac_compute_method = 'inverse' if args.kfac_inv_method else 'eigen'
    n_accum = max(1, args.batches_per_allreduce)
    # Optimizer steps per epoch: one per accumulation group, the trailing
    # partial group included.
    steps_per_epoch = max(1, -(-len(train_loader) // n_accum))
    net = model
    if world > 1:
        net = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device] if device.type == 'cuda' else None,
        )
    optimizer, lr_scheduler, precond, kfac_scheduler, lr_schedule = (
        optimizers.get_optimizer(net, args, steps_per_epoch, world)
    )
    os.makedirs(args.log_dir, exist_ok=True)
    start_epoch = 0
    latest = utils.find_latest_checkpoint(args.log_dir)
    if latest is not None:
        epoch0, path = latest
        payload = utils.load_checkpoint(path)
        state = payload['train_state']
        model.load_state_dict(state['model'])
        optimizer.load_state_dict(state['optimizer'])
        lr_scheduler.load_state_dict(state['lr_scheduler'])
        if precond is not None and 'kfac' in payload:
            precond.load_state_dict(payload['kfac'])
        start_epoch = epoch0 + 1
        if rank == 0:
            print(f'resumed from {path} at epoch {start_epoch}', flush=True)

    def loss_fn(logits, y):
        return utils.label_smooth_loss(logits, y, args.label_smoothing)

    writer = MetricsWriter(args.log_dir)
    writer.record('env', environment_summary())
    if rank == 0:
        print(f'devices={world} device={device} model={args.model} '
              f'kfac={precond is not None} accumulation={n_accum}',
              flush=True)
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        train_loss, train_acc = engine.train(
            epoch, net, optimizer, precond, train_loader, loss_fn,
            device=device, lr_scheduler=lr_scheduler,
            accumulation_steps=n_accum, writer=writer,
        )
        val_loss, val_acc = engine.evaluate(
            epoch, net, val_loader, loss_fn, device=device, writer=writer,
        )
        if kfac_scheduler is not None:
            kfac_scheduler.step()
        dt = time.perf_counter() - t0
        line = (f'epoch {epoch}: train_loss={train_loss.avg:.4f} '
                f'train_acc={train_acc.avg:.4f} val_loss={val_loss.avg:.4f} '
                f'val_acc={val_acc.avg:.4f} '
                f'lr={lr_schedule((epoch + 1) * steps_per_epoch - 1):.5f} '
                f'({dt:.1f}s)')
        if rank == 0:
            print(line, flush=True)
            utils.save_checkpoint(
                args.log_dir, epoch,
                {'model': model.state_dict(),
                 'optimizer': optimizer.state_dict(),
                 'lr_scheduler': lr_scheduler.state_dict()},
                precond.state_dict() if precond is not None else None,
            )
        if world > 1:
            dist.barrier()
    writer.close()


def main(argv: Sequence[str] | None = None) -> None:
    args = parse_args(argv)
    device, world, rank = utils.setup(args.device)
    shard = datasets.ShardInfo.from_world()
    train_loader, val_loader = datasets.get_cifar(
        args.data_dir, args.batch_size, shard, seed=args.seed,
    )
    model = build_model(args, CIFAR_MODELS, device, num_classes=10)
    run(args, train_loader, val_loader, model, device, world, rank)


if __name__ == '__main__':
    main()
