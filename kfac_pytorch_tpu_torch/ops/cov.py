"""Second-moment (Kronecker factor) statistics for K-FAC.

Port of ``kfac_pytorch_tpu/ops/cov.py``.  Activations and output
gradients arrive in PyTorch's layout (NCHW for convolutions); the
factor definitions, normalizations and feature orders are the JAX
package's, so factors from the same data agree between the two.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def append_bias_ones(x: torch.Tensor) -> torch.Tensor:
    """Append a column of ones to the last dimension of ``x``."""
    ones = torch.ones(
        x.shape[:-1] + (1,), dtype=x.dtype, device=x.device,
    )
    return torch.cat([x, ones], dim=-1)


def get_cov(
    a: torch.Tensor,
    b: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Empirical second moment of a 2D tensor.

    ``cov = a^T @ (a / scale)`` with ``scale`` defaulting to the number
    of rows, symmetrized as ``(C + C^T) / 2`` when ``b`` is None.
    bf16 inputs are contracted in f32 and divided afterwards: the
    products of two bf16 values are exact in f32, so upcasting before
    the matmul is the f32-accumulating contraction, rounded once.
    """
    if a.ndim != 2:
        raise ValueError(
            'Input tensor must have 2 dimensions. Got tensor with shape '
            f'{tuple(a.shape)}',
        )
    if b is not None and a.shape != b.shape:
        raise ValueError(
            f'Input tensors must have same shape. Got tensors of '
            f'shape {tuple(a.shape)} and {tuple(b.shape)}.',
        )
    if scale is None:
        scale = a.shape[0]
    if a.dtype == torch.bfloat16:
        af = a.float()
        rhs = af if b is None else b.float()
        cov_a = (af.T @ rhs) / scale
        if b is None:
            return (cov_a + cov_a.T) / 2.0
        return cov_a
    if b is None:
        cov_a = a.T @ (a / scale)
        return (cov_a + cov_a.T) / 2.0
    return a.T @ (b / scale)


def extract_patches(
    x: torch.Tensor,
    kernel_size: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int] | str,
) -> torch.Tensor:
    """Convolution patches of an NCHW feature map.

    Returns ``(N, out_h, out_w, C * kh * kw)``, the JAX package's output
    layout, with the feature dimension ordered ``(c_in, kh, kw)`` — the
    order of ``conv.weight.view(out, -1)``.  ``F.unfold`` produces
    exactly that order.

    Args:
        x: input feature maps ``(N, C, H, W)``.
        kernel_size: ``(kh, kw)``.
        stride: ``(sh, sw)``.
        padding: symmetric per-dimension padding ``(ph, pw)``, or
            ``'VALID'``.
    """
    kh, kw = int(kernel_size[0]), int(kernel_size[1])
    sh, sw = int(stride[0]), int(stride[1])
    if isinstance(padding, str):
        if padding.upper() != 'VALID':
            raise ValueError(
                "extract_patches only supports explicit padding or 'VALID'; "
                f'got {padding!r}',
            )
        ph = pw = 0
    else:
        ph, pw = int(padding[0]), int(padding[1])
    n, c, h, w = x.shape
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    cols = F.unfold(x, (kh, kw), padding=(ph, pw), stride=(sh, sw))
    # [N, C*kh*kw, oh*ow] -> [N, oh, ow, C*kh*kw]
    return cols.transpose(1, 2).reshape(n, oh, ow, c * kh * kw)


def expand_flatten(x: torch.Tensor) -> torch.Tensor:
    """Flatten every leading (batch + weight-sharing) dim into rows."""
    return x.reshape(-1, x.shape[-1])


def linear_a_rows(
    a: torch.Tensor, has_bias: bool = True,
) -> tuple[torch.Tensor, float]:
    """A-side rows for a dense layer: ``([N, in(+1)], norm=1)``."""
    a = expand_flatten(a)
    if has_bias:
        a = append_bias_ones(a)
    return a, 1.0


def linear_g_rows(g: torch.Tensor) -> tuple[torch.Tensor, float]:
    """G-side rows for a dense layer: ``([N, out], norm=1)``."""
    return expand_flatten(g), 1.0


def conv2d_a_rows(
    a: torch.Tensor,
    kernel_size: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int] | str,
    has_bias: bool = True,
) -> tuple[torch.Tensor, float]:
    """Per-position A-side rows for a conv layer from NCHW input.

    Returns ``(rows [N*oh*ow, C*kh*kw(+1)], norm=spatial_size)`` such
    that ``A == rows^T rows / (R * norm^2)``.
    """
    patches = extract_patches(a, kernel_size, stride, padding)
    spatial_size = patches.shape[1] * patches.shape[2]
    p = patches.reshape(-1, patches.shape[-1])
    if has_bias:
        p = append_bias_ones(p)
    return p, float(spatial_size)


def conv2d_g_rows(g: torch.Tensor) -> tuple[torch.Tensor, float]:
    """Per-position G-side rows for a conv layer from the NCHW output
    gradient: ``([N*H*W, out], norm=spatial_size)``."""
    n, c, h, w = g.shape
    return g.permute(0, 2, 3, 1).reshape(-1, c), float(h * w)


def cov_from_rows(rows: torch.Tensor, norm: float) -> torch.Tensor:
    """Covariance factor from a ``(rows, norm)`` pair:
    ``rows^T rows / (R * norm^2)``."""
    return get_cov(rows, scale=float(rows.shape[0]) * norm ** 2)


def linear_a_factor(a: torch.Tensor, has_bias: bool = True) -> torch.Tensor:
    """A factor for a dense layer from its input activations."""
    return cov_from_rows(*linear_a_rows(a, has_bias=has_bias))


def linear_g_factor(g: torch.Tensor) -> torch.Tensor:
    """G factor for a dense layer from the grad w.r.t. its output."""
    return cov_from_rows(*linear_g_rows(g))


def conv2d_a_factor(
    a: torch.Tensor,
    kernel_size: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int] | str,
    has_bias: bool = True,
) -> torch.Tensor:
    """A factor for a 2D conv layer from its NCHW input activations."""
    return cov_from_rows(*conv2d_a_rows(
        a, kernel_size, stride, padding, has_bias=has_bias,
    ))


def conv2d_g_factor(g: torch.Tensor) -> torch.Tensor:
    """G factor for a 2D conv layer from its NCHW output gradient."""
    return cov_from_rows(*conv2d_g_rows(g))
