"""Second-moment (Kronecker factor) statistics for K-FAC.

Port of ``kfac_pytorch_tpu/ops/cov.py``.  Activations and output
gradients arrive in PyTorch's layout (NCHW for convolutions); the
factor definitions, normalizations and feature orders are the JAX
package's, so factors from the same data agree between the two.

The transformer statistics of the full-coverage subsystem
(arXiv:2311.00636) are here too: the embedding's exact ``[V]``
diagonal A factor, the LayerNorm scale+bias ``[2, 2]`` A factor, a
tied embedding's attend-side contributions and the KFAC-reduce rows.
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


def reduce_sum_shared(x: torch.Tensor) -> torch.Tensor:
    """Sum a ``[batch, *shared, D]`` tensor over its shared axes (the
    KFAC-reduce reduction); a 2D input is returned untouched."""
    if x.ndim <= 2:
        return x
    return torch.sum(x, dim=tuple(range(1, x.ndim - 1)))


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


def linear_reduce_a_rows(
    a: torch.Tensor, has_bias: bool = True,
) -> tuple[torch.Tensor, float]:
    """KFAC-reduce A-side rows: the bias column is appended before the
    shared axes are summed, so it carries the shared-application count;
    on a 2D input this is the dense path's rows."""
    if has_bias:
        a = append_bias_ones(a)
    return reduce_sum_shared(a), 1.0


def linear_reduce_g_rows(g: torch.Tensor) -> tuple[torch.Tensor, float]:
    """KFAC-reduce G-side rows: ``([N, out], norm=1)``, shared summed."""
    return reduce_sum_shared(g), 1.0


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


def cov_psum_compressed(
    rows: torch.Tensor,
    norm: float,
    group=None,
    comm_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Covariance factor of the rows of every rank of ``group`` (default
    the world) through the compressed all-reduce (JAX
    ``ops/cov.py:423-496``, the ``factor_comm='bf16_triu'`` wire form).

    Each rank contracts its local ``[R, d]`` rows in f32 at the global
    scale ``world * R * norm^2`` (equal local batches), and
    :func:`~kfac_pytorch_tpu_torch.parallel.collectives.\
all_reduce_sum_triu` sums the ``comm_dtype`` packed upper triangles and
    returns the f32 ``[d, d]`` factor.  Lossy on the wire by design: the
    sum runs in ``comm_dtype``.
    """
    from kfac_pytorch_tpu_torch.parallel import collectives

    world = collectives.group_size(group)
    cov = get_cov(rows, scale=float(rows.shape[0]) * norm ** 2 * world)
    return collectives.all_reduce_sum_triu([cov], group, comm_dtype)[0]


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


def embed_a_diag(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Diagonal of the embedding A factor: the ``[V]`` token-frequency
    vector (the one-hot input covariance is exactly diagonal).

    The integer ids are counted as they are, never cast to a float, and
    clipped to ``[0, vocab)`` first, as the JAX package clips them.
    """
    flat = ids.reshape(-1).clamp(0, vocab_size - 1)
    counts = torch.bincount(flat, minlength=vocab_size)
    return counts.to(torch.float32) / flat.shape[0]


def layernorm_normalized(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """The normalized input ``x̂`` a LayerNorm's affine pair consumes,
    recomputed in f32 from the pre-normalization input with Flax's fast
    variance (``E[x^2] - E[x]^2``) over the last axis."""
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True) - mean.square()
    return (x - mean) * torch.rsqrt(var + epsilon)


def scale_bias_a_rows(
    x: torch.Tensor, epsilon: float,
) -> tuple[torch.Tensor, float]:
    """A-side rows of a LayerNorm scale+bias pair: ``([R, 2], 1.0)``,
    one row ``(x̂, 1)`` per (example, position, feature) site."""
    xhat = layernorm_normalized(x, epsilon)
    return append_bias_ones(xhat.reshape(-1, 1)), 1.0


def scale_bias_a_factor(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """``[2, 2]`` A factor of a LayerNorm scale+bias pair."""
    return cov_from_rows(*scale_bias_a_rows(x, epsilon))


#: Rows per chunk of :func:`attend_a_diag`'s reduction.
ATTEND_ROWS_PER_CHUNK = 1024


def attend_a_diag(cots: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Diagonal A contribution of a tied embedding's attend application:
    the mean over rows of the squared ``[..., V]`` output gradients, in
    f32 (in the lookup layout the roles swap, so the attend's cotangents
    feed the ``V`` side).

    Reduced over chunks of :data:`ATTEND_ROWS_PER_CHUNK` rows, each
    widened to f32 on its own, so a bf16 ``[B, T, V]`` cotangent is never
    copied whole.
    """
    rows = expand_flatten(cots)
    if rows.shape[-1] != vocab_size:
        raise ValueError(
            f'attend cotangents have {rows.shape[-1]} columns, expected '
            f'vocab_size={vocab_size}',
        )
    acc = torch.zeros(vocab_size, dtype=torch.float32, device=rows.device)
    for chunk in rows.split(ATTEND_ROWS_PER_CHUNK):
        acc += torch.sum(torch.square(chunk.float()), dim=0)
    return acc / rows.shape[0]


def attend_g_factor(x: torch.Tensor) -> torch.Tensor:
    """G contribution of a tied embedding's attend application: the
    covariance of its input activations (the out side in the lookup
    layout)."""
    return cov_from_rows(*linear_g_rows(x))
