"""ImageNet ResNet trainer with K-FAC, on the card.

Port of ``examples/imagenet_resnet.py``: the same flags and defaults
(resnet50, batch 32 per rank, lr 0.0125 x world, 55 epochs, decay at
epochs 25, 35, 40, 45 and 50, warmup 5, label smoothing 0.1, K-FAC
factor/inverse updates every 10/100 steps, damping 0.001, the update
intervals x10 at epoch 25), plus ``--device``.  It reads an ImageFolder
tree with ``train/`` and ``val/`` under ``--data-dir``; without one it
trains on synthetic 64x64 images of 100 classes.  Resume, accumulation
and the runs across ranks are those of
:mod:`~kfac_pytorch_tpu_torch.examples.cifar10_resnet`::

    python -m kfac_pytorch_tpu_torch.examples.imagenet_resnet
    torchrun --nproc-per-node 4 -m kfac_pytorch_tpu_torch.examples.imagenet_resnet
"""
from __future__ import annotations

import argparse
from typing import Sequence

from kfac_pytorch_tpu_torch.examples import utils
from kfac_pytorch_tpu_torch.examples.cifar10_resnet import add_kfac_args
from kfac_pytorch_tpu_torch.examples.cifar10_resnet import build_model
from kfac_pytorch_tpu_torch.examples.cifar10_resnet import run
from kfac_pytorch_tpu_torch.examples.cnn_utils import datasets

IMAGENET_MODELS = ('resnet50', 'resnet101', 'resnet152')


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description='ImageNet ResNet + K-FAC (PyTorch/CUDA)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument('--data-dir', default='/tmp/imagenet', type=str,
                   help='dir containing train/ and val/ ImageFolder trees '
                        '(synthetic fallback if missing)')
    p.add_argument('--log-dir', default='./logs/imagenet', type=str)
    p.add_argument('--seed', default=42, type=int)
    p.add_argument('--device', default=None, type=str,
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--bf16', action='store_true',
                   help='bf16 compute and activations (f32 parameters and '
                        'factor EMAs)')
    p.add_argument('--model', default='resnet50', type=str,
                   choices=list(IMAGENET_MODELS))
    p.add_argument('--image-size', default=224, type=int)
    p.add_argument('--num-classes', default=1000, type=int)
    p.add_argument('--batch-size', default=32, type=int,
                   help='per-rank batch size')
    p.add_argument('--val-batch-size', default=32, type=int)
    p.add_argument('--batches-per-allreduce', default=1, type=int)
    p.add_argument('--epochs', default=55, type=int)
    p.add_argument('--base-lr', default=0.0125, type=float)
    p.add_argument('--lr-decay', nargs='+', type=int,
                   default=[25, 35, 40, 45, 50])
    p.add_argument('--warmup-epochs', default=5, type=int)
    p.add_argument('--momentum', default=0.9, type=float)
    p.add_argument('--weight-decay', default=5e-5, type=float)
    p.add_argument('--label-smoothing', default=0.1, type=float)
    add_kfac_args(p, inv=100, factor=10, damping=0.001, update_decay=[25])
    return p.parse_args(argv)


def main(argv: Sequence[str] | None = None) -> None:
    args = parse_args(argv)
    device, world, rank = utils.setup(args.device)
    shard = datasets.ShardInfo.from_world()
    train_loader, val_loader = datasets.get_imagenet(
        args.data_dir, args.batch_size, shard, image_size=args.image_size,
        seed=args.seed,
    )
    model = build_model(args, IMAGENET_MODELS, device,
                        num_classes=args.num_classes)
    run(args, train_loader, val_loader, model, device, world, rank)


if __name__ == '__main__':
    main()
