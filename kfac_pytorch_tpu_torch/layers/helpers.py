"""Layer helpers: per-layer-type factor math and gradient (un)flattening.

Port of ``kfac_pytorch_tpu/layers/helpers.py``.  A helper records a
registered layer's static shape metadata and maps between the layer's
``.grad`` tensors and the combined ``[out_dim, in_dim(+1)]`` gradient the
K-FAC math works on (bias column appended).  PyTorch weights are already
``[out, in]`` (Linear) and OIHW (Conv2d), whose flattening
``[out, in * kh * kw]`` has the ``(in, kh, kw)`` feature order of
:func:`kfac_pytorch_tpu_torch.ops.cov.extract_patches`, so both
directions are plain reshapes.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from kfac_pytorch_tpu_torch.ops import cov


@dataclasses.dataclass(frozen=True, eq=False)
class LayerHelper:
    """Base helper.  One instance per registered layer.

    Attributes:
        name: layer name (``model.named_modules()`` name).
        module: the registered module.
        has_bias: whether the layer has a bias parameter.
        in_features: logical input feature dimension.
        out_features: logical output feature dimension.
    """

    name: str
    module: nn.Module
    has_bias: bool
    in_features: int
    out_features: int

    @property
    def a_factor_shape(self) -> tuple[int, int]:
        """Shape of the A (input covariance) factor."""
        d = self.in_features + int(self.has_bias)
        return (d, d)

    @property
    def g_factor_shape(self) -> tuple[int, int]:
        """Shape of the G (output-grad covariance) factor."""
        return (self.out_features, self.out_features)

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        """A-factor contribution from input activations."""
        raise NotImplementedError

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        """G-factor contribution from output gradients."""
        raise NotImplementedError

    def get_grad(self) -> torch.Tensor:
        """Combined ``[out, in(+1)]`` gradient from the module's ``.grad``."""
        w = self.module.weight.grad
        if w is None:
            raise RuntimeError(
                f'layer {self.name!r} has no gradient: call backward() '
                'before step()',
            )
        g = w.reshape(w.shape[0], -1)
        if self.has_bias:
            g = torch.cat([g, self.module.bias.grad[:, None]], dim=1)
        return g

    def set_grad(self, combined: torch.Tensor) -> None:
        """Write a combined gradient back into the module's ``.grad``."""
        w = self.module.weight
        if self.has_bias:
            w.grad.copy_(combined[:, :-1].reshape(w.shape))
            self.module.bias.grad.copy_(combined[:, -1])
        else:
            w.grad.copy_(combined.reshape(w.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class DenseHelper(LayerHelper):
    """Helper for ``nn.Linear`` (``LinearModuleHelper`` of the reference)."""

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        return cov.linear_a_factor(a, has_bias=self.has_bias)

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return cov.linear_g_factor(g)


@dataclasses.dataclass(frozen=True, eq=False)
class ConvHelper(LayerHelper):
    """Helper for ``nn.Conv2d`` (``Conv2dModuleHelper`` of the reference).

    Attributes:
        kernel_size: ``(kh, kw)``.
        strides: ``(sh, sw)``.
        padding: symmetric per-dimension padding ``(ph, pw)``.
    """

    kernel_size: tuple[int, int] = dataclasses.field()
    strides: tuple[int, int] = dataclasses.field()
    padding: tuple[int, int] = dataclasses.field()

    @property
    def a_factor_shape(self) -> tuple[int, int]:
        kh, kw = self.kernel_size
        d = self.in_features * kh * kw + int(self.has_bias)
        return (d, d)

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        return cov.conv2d_a_factor(
            a, self.kernel_size, self.strides, self.padding,
            has_bias=self.has_bias,
        )

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return cov.conv2d_g_factor(g)
