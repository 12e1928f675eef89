"""Vision Transformer classifier.

Port of ``kfac_pytorch_tpu/models/vit.py``: a conv patchify stem
(kernel = stride = ``patch_size``, VALID padding, on NCHW images),
pre-LN encoder blocks of multi-head self-attention and a GELU MLP, a
learned position table ``pos_embed``, mean or ``cls`` pooling and a
linear head.  Module and parameter names are the Flax model's
(``block_0.qkv`` is ``block_0/qkv``), so
:func:`kfac_pytorch_tpu_torch.convert.flax_to_torch_state_dict` maps its
variables one to one.

Tokens are the stem's output positions in ``(h, w)`` row-major order,
the order of the Flax model's ``reshape`` of its NHWC output.  Compute
dtypes follow :mod:`kfac_pytorch_tpu_torch.models.gpt`: Dense and conv
layers cast to ``dtype``, LayerNorm (epsilon 1e-6) normalizes in f32,
attention takes its softmax in f32, GELU is the tanh approximation and
the logits are f32.  Every projection is a ``Dense`` and the stem a
conv, so the default ``layer_types`` register all of them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu_torch.models.layers import Conv2d
from kfac_pytorch_tpu_torch.models.layers import Dense
from kfac_pytorch_tpu_torch.models.layers import LayerNorm
from kfac_pytorch_tpu_torch.models.layers import lecun_normal_
from kfac_pytorch_tpu_torch.models.layers import resolve_device
from kfac_pytorch_tpu_torch.models.layers import split_heads_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT hyperparameters; :func:`vit_b16` is ViT-B/16."""

    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dropout_rate: float = 0.0
    pool: str = 'mean'  # 'mean' or 'cls'
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if self.pool not in ('mean', 'cls'):
            raise ValueError(
                f"pool must be 'mean' or 'cls', got {self.pool!r}",
            )
        if self.d_model % self.n_heads:
            raise ValueError(
                f'd_model {self.d_model} is not a multiple of n_heads '
                f'{self.n_heads}',
            )
        if self.image_size % self.patch_size:
            raise ValueError(
                f'image_size {self.image_size} is not a multiple of '
                f'patch_size {self.patch_size}',
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class ViTBlock(nn.Module):
    """Pre-LN encoder block: ``ln_attn``, ``qkv``, attention, ``proj``;
    ``ln_mlp``, ``fc_in``, tanh GELU, ``fc_out``."""

    def __init__(self, config: ViTConfig) -> None:
        super().__init__()
        self.config = config
        d, cd = config.d_model, config.dtype
        self.ln_attn = LayerNorm(d, cd)
        self.qkv = Dense(d, 3 * d, cd)
        self.proj = Dense(d, d, cd)
        self.drop_attn = nn.Dropout(config.dropout_rate)
        self.ln_mlp = LayerNorm(d, cd)
        self.fc_in = Dense(d, config.d_ff, cd)
        self.fc_out = Dense(config.d_ff, d, cd)
        self.drop_mlp = nn.Dropout(config.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        q, k, v = self.qkv(self.ln_attn(x)).split(cfg.d_model, dim=-1)
        out = split_heads_attention(q, k, v, cfg.n_heads)
        x = x + self.drop_attn(self.proj(out))
        h = F.gelu(self.fc_in(self.ln_mlp(x)), approximate='tanh')
        return x + self.drop_mlp(self.fc_out(h))


class ViT(nn.Module):
    """``forward(images [B, 3, H, W]) -> logits [B, num_classes]`` in
    f32."""

    def __init__(self, config: ViTConfig) -> None:
        super().__init__()
        self.config = config
        d, p, cd = config.d_model, config.patch_size, config.dtype
        self.patchify = Conv2d(3, d, p, stride=p, compute_dtype=cd,
                               bias=True)
        n_tok = config.n_patches + int(config.pool == 'cls')
        if config.pool == 'cls':
            self.cls = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, n_tok, d))
        self.block_names = [f'block_{i}' for i in range(config.n_layers)]
        for name in self.block_names:
            self.add_module(name, ViTBlock(config))
        self.ln_out = LayerNorm(d, cd)
        self.head = Dense(d, config.num_classes, cd)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.patchify(images.to(cfg.dtype))  # [B, D, H', W']
        x = x.flatten(2).transpose(1, 2)  # [B, H' W', D], (h, w) order
        if cfg.pool == 'cls':
            cls = self.cls.to(cfg.dtype).expand(x.shape[0], 1, cfg.d_model)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(cfg.dtype)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.ln_out(x)
        x = x[:, 0] if cfg.pool == 'cls' else x.mean(dim=1)
        return self.head(x).float()


def init_weights(model: ViT, generator: torch.Generator) -> None:
    """The JAX model's initialization from ``generator``: Dense kernels
    and ``pos_embed`` normal(0, 0.02), the stem Flax's ``lecun_normal``,
    zero biases and ``cls``, unit LayerNorm scales."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        model.pos_embed.normal_(0.0, 0.02, generator=generator)


def _build(config: ViTConfig, device: Any, seed: int) -> ViT:
    model = ViT(config).to(device=resolve_device(device),
                           dtype=config.param_dtype)
    gen = torch.Generator(device=model.pos_embed.device)
    gen.manual_seed(seed)
    init_weights(model, gen)
    return model


def vit_b16(device=None, seed: int = 0, **overrides: Any) -> ViT:
    """ViT-B/16: 224x224 images, 16x16 patches, 12 layers, 12 heads,
    ``d_model`` 768, ``d_ff`` 3072, 1000 classes, bf16 compute."""
    return _build(ViTConfig(**overrides), device, seed)


def vit_s16(device=None, seed: int = 0, **overrides: Any) -> ViT:
    """ViT-S/16: 6 heads, ``d_model`` 384, ``d_ff`` 1536."""
    defaults = dict(n_layers=12, n_heads=6, d_model=384, d_ff=1536)
    defaults.update(overrides)
    return _build(ViTConfig(**defaults), device, seed)


def vit_tiny(device=None, seed: int = 0, **overrides: Any) -> ViT:
    """Test scale: 32x32 images, 8x8 patches, 10 classes, 2 layers, 2
    heads, ``d_model`` 32, ``d_ff`` 64, f32 compute."""
    defaults = dict(image_size=32, patch_size=8, num_classes=10,
                    n_layers=2, n_heads=2, d_model=32, d_ff=64,
                    dtype=torch.float32)
    defaults.update(overrides)
    return _build(ViTConfig(**defaults), device, seed)
