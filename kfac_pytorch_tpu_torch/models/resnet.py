"""ImageNet ResNets (resnet50/101/152), NCHW.

Port of ``kfac_pytorch_tpu/models/resnet.py``: bottleneck-v1 blocks
with explicit symmetric padding (7x7/2 stem with pad 3, 3x3/2 max pool
with pad 1, padded with -inf), a 1x1 projection shortcut (stride 2 on
the first block of stages 2-4, no padding, as Flax's ``'SAME'`` pads a
1x1 kernel), BatchNorm with eps 1e-5 and torch ``momentum=0.1`` (Flax
``momentum=0.9`` keeps 0.9 of the old running value), ``bn3``'s scale
initialized to zero, and a biased ``fc`` head.  Module names
(``conv1``, ``bn1``, ``layer{s}_{i}.conv1`` ... ``downsample_bn``,
``fc``) are the Flax model's, so
:func:`~kfac_pytorch_tpu_torch.convert.flax_to_torch_state_dict` maps
its variables one to one.

``dtype`` is the compute dtype of the
:mod:`~kfac_pytorch_tpu_torch.models.layers` it is built from; the
logits come back in f32.  Parameters stay f32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu_torch.models.layers import BatchNorm2d
from kfac_pytorch_tpu_torch.models.layers import Conv2d
from kfac_pytorch_tpu_torch.models.layers import Dense
from kfac_pytorch_tpu_torch.models.layers import lecun_normal_
from kfac_pytorch_tpu_torch.models.layers import resolve_device


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut when the
    stride or the width changes."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(in_planes, planes, 1, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            compute_dtype=dtype)
        self.bn2 = BatchNorm2d(planes, dtype)
        self.conv3 = Conv2d(planes, out_ch, 1, compute_dtype=dtype)
        self.bn3 = BatchNorm2d(out_ch, dtype)
        self.project = stride != 1 or in_planes != out_ch
        if self.project:
            self.downsample_conv = Conv2d(in_planes, out_ch, 1,
                                          stride=stride, compute_dtype=dtype)
            self.downsample_bn = BatchNorm2d(out_ch, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = (self.downsample_bn(self.downsample_conv(x)) if self.project
              else x)
        return F.relu(y + sc)


class ResNet(nn.Module):
    """Bottleneck ResNet for ``[N, 3, 224, 224]`` inputs (any side that
    reaches layer4 works)."""

    def __init__(self, layers: Sequence[int], num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3,
                            compute_dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype)
        self.block_names: list[str] = []
        in_planes = 64
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f'layer{stage + 1}_{i}'
                self.add_module(name, Bottleneck(in_planes, planes, stride,
                                                 dtype))
                self.block_names.append(name)
                in_planes = planes * Bottleneck.expansion
        self.fc = Dense(in_planes, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3))).float()


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's initialization from ``generator``: ``lecun_normal`` conv and
    linear kernels, zero biases, unit BatchNorm scales except each
    block's ``bn3``, which starts at zero.  The generator must live on
    the parameters' device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.zero_()


def _build(layers: Sequence[int], num_classes: int, device, seed: int,
           dtype: torch.dtype) -> ResNet:
    model = ResNet(layers, num_classes=num_classes,
                   dtype=dtype).to(resolve_device(device))
    gen = torch.Generator(device=model.conv1.weight.device)
    gen.manual_seed(seed)
    init_weights(model, gen)
    return model


def resnet50(num_classes=1000, device=None, seed=0,
             dtype=torch.float32) -> ResNet:
    return _build((3, 4, 6, 3), num_classes, device, seed, dtype)


def resnet101(num_classes=1000, device=None, seed=0,
              dtype=torch.float32) -> ResNet:
    return _build((3, 4, 23, 3), num_classes, device, seed, dtype)


def resnet152(num_classes=1000, device=None, seed=0,
              dtype=torch.float32) -> ResNet:
    return _build((3, 8, 36, 3), num_classes, device, seed, dtype)
