"""Layers shared by the port's models, each computing in a compute dtype.

The compute dtype is written out in the modules as Flax applies its
``dtype``: a layer casts its input and parameters to ``compute_dtype``
before the product, BatchNorm and LayerNorm normalize in f32 and return
``compute_dtype``, and the parameters stay f32.

:class:`DenseGeneral` and :class:`MultiHeadDotProductAttention` are
Flax's modules of those names.  ``torch.nn.MultiheadAttention`` computes
its projections inside ``F.multi_head_attention_forward`` from the raw
weights, where module hooks see neither their inputs nor their output
gradients, so K-FAC cannot precondition them; these modules make each
projection a module call, with Flax's multi-axis kernels
(``layer_types=('dense_general',)``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

#: Standard deviation of a unit normal truncated to [-2, 2]: Flax's
#: truncated ``lecun_normal`` divides by it.
_TRUNC_STD = 0.87962566103423978


def resolve_device(device: Any) -> Any:
    """``device``, or ``'cuda'`` for ``None``: a factory builds on the
    card unless the caller names another device."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: pass device="cpu" to build the model on the '
            'CPU',
        )
    return 'cuda'


_REMAT = threading.local()


def recomputing() -> bool:
    """Whether this thread is inside a rematerialized block's recompute
    (:func:`remat_call`'s backward), where the K-FAC capture records
    nothing: the first forward already recorded the block's inputs and
    put its gradient hooks on the outputs that the backward reaches."""
    return getattr(_REMAT, 'depth', 0) > 0


@contextlib.contextmanager
def _recompute_scope():
    _REMAT.depth = getattr(_REMAT, 'depth', 0) + 1
    try:
        yield
    finally:
        _REMAT.depth -= 1


def _remat_contexts():
    return contextlib.nullcontext(), _recompute_scope()


def remat_call(module: nn.Module, *args: Any) -> Any:
    """``module(*args)`` under activation checkpointing, as Flax's
    ``nn.remat`` applies it to a block: only the inputs are kept, and the
    backward runs the forward again (``torch.utils.checkpoint`` without
    reentrancy), marked by :func:`recomputing` for the capture hooks."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=_remat_contexts)


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Flax's ``lecun_normal``: a normal of variance ``1 / fan_in``
    truncated at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def split_heads_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, n_heads: int, *,
                          is_causal: bool = False,
                          attn_mask: torch.Tensor | None = None,
                          ) -> torch.Tensor:
    """Softmax attention of ``[B, T, D]`` projections split into
    ``n_heads`` heads, as the JAX models compute it: ``q`` scaled by
    ``1 / sqrt(head_dim)`` in its own dtype, logits and softmax in f32
    (``scaled_dot_product_attention`` on f32 operands, with an additive
    f32 ``attn_mask`` broadcastable to ``[B, heads, T, T]``), the result
    ``[B, T, D]`` in ``q``'s dtype."""
    B, T, D = q.shape
    head_dim = D // n_heads

    def heads(t):
        return t.reshape(B, T, n_heads, head_dim).transpose(1, 2).float()

    out = F.scaled_dot_product_attention(
        heads(q * head_dim ** -0.5), heads(k), heads(v),
        attn_mask=attn_mask, is_causal=is_causal, scale=1.0,
    )
    return out.to(q.dtype).transpose(1, 2).reshape(B, T, D)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with Flax's epsilon (1e-6), normalizing in f32
    and returning ``compute_dtype``."""

    def __init__(self, features: int, compute_dtype: torch.dtype) -> None:
        super().__init__(features, eps=1e-6)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(self.compute_dtype)


class Embed(nn.Embedding):
    """``nn.Embedding`` returning ``compute_dtype``."""

    def __init__(self, num_embeddings: int, features: int,
                 compute_dtype: torch.dtype) -> None:
        super().__init__(num_embeddings, features)
        self.compute_dtype = compute_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (Flax ``Dense`` with
    ``dtype``): input, weight and bias are cast before the product."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype, bias: bool = True) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d``, without bias unless asked, computing in
    ``compute_dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, compute_dtype=torch.float32,
                 bias: bool = False) -> None:
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.conv2d(x.to(cd), self.weight.to(cd), bias, self.stride,
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


def _as_tuple(v: int | Sequence[int]) -> tuple[int, ...]:
    return (int(v),) if isinstance(v, int) else tuple(int(x) for x in v)


class DenseGeneral(nn.Module):
    """Flax's ``DenseGeneral``: contracts the input's ``axis`` with the
    leading axes of ``kernel [*in_shape, *features]`` and adds ``bias
    [*features]``, in ``compute_dtype``.  The output is the input's
    other axes, in order, then ``features``.

    The kernel keeps Flax's layout (so the weight bridge copies it as it
    is); ``axis`` counts from the end, as the input's rank is not known
    here, and is sorted as Flax sorts it.  K-FAC registers the module
    under ``'dense_general'`` when the axes are the trailing ones.

    Args:
        in_shape: the sizes of the contracted axes, in ``axis`` order.
        features: the output feature axes.
        axis: the contracted axes, negative.
        use_bias: whether to add ``bias``.
        compute_dtype: dtype of the input, kernel and bias in the
            product.
    """

    def __init__(self, in_shape: int | Sequence[int],
                 features: int | Sequence[int],
                 axis: int | Sequence[int] = -1, use_bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        in_shape, features = _as_tuple(in_shape), _as_tuple(features)
        axis = tuple(sorted(_as_tuple(axis)))
        if len(axis) != len(in_shape) or any(a >= 0 for a in axis):
            raise ValueError(
                f'axis {axis} must name one negative axis per in_shape '
                f'entry {in_shape}',
            )
        self.in_shape, self.features, self.axis = in_shape, features, axis
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(*in_shape, *features))
        self.bias = (nn.Parameter(torch.zeros(*features)) if use_bias
                     else None)
        lecun_normal_(self.kernel, math.prod(in_shape), None)

    @property
    def trailing(self) -> bool:
        """Whether ``axis`` is the input's last ``len(axis)`` axes."""
        return self.axis == tuple(range(-len(self.axis), 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        dims = [a % x.dim() for a in self.axis]
        y = torch.tensordot(x.to(cd), self.kernel.to(cd),
                            dims=(dims, list(range(len(dims)))))
        return y if self.bias is None else y + self.bias.to(cd)

    def extra_repr(self) -> str:
        return (f'in_shape={self.in_shape}, features={self.features}, '
                f'axis={self.axis}, use_bias={self.bias is not None}')


class MultiHeadDotProductAttention(nn.Module):
    """Flax's ``nn.MultiHeadDotProductAttention`` as self-attention (no
    mask, dropout or decoding cache): ``query``, ``key`` and ``value``
    are :class:`DenseGeneral` projections to ``[num_heads, head_dim]``
    (kernels ``[D, heads, head_dim]``), ``out`` maps ``[heads,
    head_dim]`` back to ``D`` (kernel ``[heads, head_dim, D]``).  The
    query is scaled by ``1 / sqrt(head_dim)`` and the softmax runs in
    f32.

    Args:
        in_features: ``D``, the size of the inputs' last axis.
        num_heads: number of heads.
        qkv_features: width of the projections (default ``D``).
        compute_dtype: dtype of the projections and the attention.
    """

    def __init__(self, in_features: int, num_heads: int,
                 qkv_features: int | None = None,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        qkv = in_features if qkv_features is None else qkv_features
        if qkv % num_heads:
            raise ValueError(
                f'qkv_features {qkv} is not a multiple of num_heads '
                f'{num_heads}',
            )
        self.head_dim = qkv // num_heads
        heads = (num_heads, self.head_dim)
        for name in ('query', 'key', 'value'):
            self.add_module(name, DenseGeneral(
                in_features, heads, compute_dtype=compute_dtype))
        self.out = DenseGeneral(heads, in_features, axis=(-2, -1),
                                compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.query(x)
        q = q / torch.tensor(math.sqrt(self.head_dim), dtype=q.dtype)
        k, v = self.key(x), self.value(x)
        logits = torch.einsum('...qhd,...khd->...hqk', q.float(), k.float())
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return self.out(torch.einsum('...hqk,...khd->...qhd', probs, v))
