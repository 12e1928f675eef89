"""Layers shared by the port's models, each computing in a compute dtype.

The compute dtype is written out in the modules as Flax applies its
``dtype``: a layer casts its input and parameters to ``compute_dtype``
before the product, BatchNorm normalizes in f32 and returns
``compute_dtype``, and the parameters stay f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (Flax ``Dense`` with
    ``dtype``): input, weight and bias are cast before the product."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype) -> None:
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` without bias computing in ``compute_dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, compute_dtype=torch.float32) -> None:
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv2d(x.to(cd), self.weight.to(cd), None, self.stride,
                        self.padding)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) normalizing in f32 and
    returning ``compute_dtype``.

    In training mode the running variance takes the biased batch
    variance, as Flax's ``BatchNorm`` updates it.  ``F.batch_norm``
    blends in the unbiased one, ``n / (n - 1)`` larger for ``n`` values
    per channel, so it blends into the running variance scaled by
    ``n / (n - 1)``, and the result is scaled back: one pass over the
    activations, as torch's own layer takes, and two kernels on the
    per-channel vector.
    """

    def __init__(self, planes: int, compute_dtype=torch.float32) -> None:
        super().__init__(planes, eps=1e-5, momentum=0.1)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return super().forward(x).to(self.compute_dtype)
        # (1 - m) k old + m var_u, scaled by 1 / k = (n - 1) / n, is
        # (1 - m) old + m var_b.  The op blends into a new tensor, which
        # autograd keeps, so the buffer can be overwritten afterwards.
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError(
                'Expected more than 1 value per channel when training, got '
                f'input size {tuple(x.shape)}',
            )
        blend = self.running_var * (n / (n - 1))
        y = F.batch_norm(x, self.running_mean, blend, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            torch.mul(blend, (n - 1) / n, out=self.running_var)
            self.num_batches_tracked.add_(1)
        return y.to(self.compute_dtype)
