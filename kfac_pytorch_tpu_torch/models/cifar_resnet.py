"""CIFAR-10 ResNets (resnet20, resnet32), NCHW.

Port of ``kfac_pytorch_tpu/models/cifar_resnet.py`` (the akamaster
CIFAR ResNets): 3x3 stem, three stages of BasicBlocks with widths
16/32/64, strided first block per stage with option-A (subsample and
zero-pad) shortcuts, global average pool, linear head.  Module names
(``conv1``, ``bn1``, ``layer{s}_{i}``, ``linear``) are the Flax model's,
so :mod:`kfac_pytorch_tpu_torch.convert` maps its variables one to one.
BatchNorm uses eps 1e-5 and momentum 0.1 (Flax ``momentum=0.9`` keeps
0.9 of the old running value; torch's ``momentum`` is the new value's
weight).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _bn(planes: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """Two 3x3 convs + BN with an option-A (identity) shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.pad = planes - in_planes
        self.conv1 = nn.Conv2d(
            in_planes, planes, 3, stride=stride, padding=1, bias=False,
        )
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.stride != 1 or self.pad != 0:
            # Option A: subsample spatially, zero-pad channels with
            # pad // 2 in front; parameter-free, so K-FAC sees no layer.
            sc = x[:, :, ::self.stride, ::self.stride]
            sc = F.pad(sc, (0, 0, 0, 0, self.pad // 2,
                            self.pad - self.pad // 2))
        else:
            sc = x
        return F.relu(y + sc)


class CifarResNet(nn.Module):
    """Stage-structured CIFAR ResNet; input ``[N, 3, H, W]``."""

    def __init__(self, layers: Sequence[int], num_classes: int = 10):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1, bias=False)
        self.bn1 = _bn(16)
        self.block_names: list[str] = []
        in_planes = 16
        for stage, (planes, blocks) in enumerate(zip((16, 32, 64), layers)):
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f'layer{stage + 1}_{i}'
                self.add_module(name, BasicBlock(in_planes, planes, stride))
                self.block_names.append(name)
                in_planes = planes
        self.linear = nn.Linear(64, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.linear(x.mean(dim=(2, 3)))


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize conv/linear weights from ``generator``.

    Kaiming-normal (fan-in) conv and linear kernels, zero biases, unit
    BN scales — the He initialization the CIFAR ResNets are trained
    with.  The generator must live on the parameters' device.
    """
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(
                    m.weight, mode='fan_in', nonlinearity='relu',
                    generator=generator,
                )
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()


def _build(
    layers: Sequence[int],
    num_classes: int,
    device: torch.device | str | None,
    seed: int,
) -> CifarResNet:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: pass device="cpu" to build the model '
                'on the CPU',
            )
        device = 'cuda'
    model = CifarResNet(layers, num_classes=num_classes).to(device)
    gen = torch.Generator(device=model.conv1.weight.device)
    gen.manual_seed(seed)
    init_weights(model, gen)
    return model


def resnet20(num_classes=10, device=None, seed=0) -> CifarResNet:
    return _build((3, 3, 3), num_classes, device, seed)


def resnet32(num_classes=10, device=None, seed=0) -> CifarResNet:
    return _build((5, 5, 5), num_classes, device, seed)

