"""GPT-style decoder-only transformer.

Port of ``kfac_pytorch_tpu/models/gpt.py``: pre-LN blocks of causal
multi-head self-attention and a GELU MLP, a learned positional table
``wpe`` and an LM head tied to the token embedding ``wte``.  Module
names are the Flax model's (``h_0.attn.qkv`` is ``h_0/attn/qkv``), so
:func:`kfac_pytorch_tpu_torch.convert.flax_to_torch_state_dict` maps its
variables one to one.

The compute dtype is written out in the modules, as Flax applies it,
so an f32 model and a bf16 one run the same code:

* :class:`~kfac_pytorch_tpu_torch.models.layers.Dense` casts its input,
  weight and bias to ``compute_dtype``;
* :class:`~kfac_pytorch_tpu_torch.models.layers.LayerNorm` normalizes
  in f32 with epsilon 1e-6 (Flax's, where torch's default is 1e-5) and
  returns ``compute_dtype``;
* :class:`~kfac_pytorch_tpu_torch.models.layers.Embed` looks up in the
  parameter dtype and returns ``compute_dtype``;
* attention takes its softmax in f32 (``scaled_dot_product_attention``
  on f32 operands, ``q`` scaled in its own dtype first);
* GELU is the tanh approximation (Flax ``nn.gelu``'s default);
* ``remat=True`` checkpoints each block (:func:`~kfac_pytorch_tpu_torch.\
models.layers.remat_call`, Flax's ``nn.remat(Block)``);
* the head casts ``x`` to the parameter dtype and then, as Flax's
  ``Embed.attend`` does, both operands to ``compute_dtype``; the logits
  are returned in f32.

Parameters are ``param_dtype`` (f32).  The head is a
:class:`~kfac_pytorch_tpu_torch.layers.TiedAttend` module, so K-FAC can
capture the tied call (``tied_weights=('wte',)``).

``attention_impl='ring'`` runs the attention of
:mod:`~kfac_pytorch_tpu_torch.parallel.ring_attention` (JAX's ``'dense'``
is that module's single-block path; the port's ``'dense'`` is
``scaled_dot_product_attention`` on the same f32 operands).  With
``seq_links`` (:func:`~kfac_pytorch_tpu_torch.parallel.ring_attention.\
sequence_links`, the counterpart of JAX's ``seq_axis``) each rank of the
sequence group holds the shard ``[B, T/n]`` of the tokens, adds the
positions ``wpe[idx T/n : (idx + 1) T/n]`` and rings K/V over the
group; ``seq_axis`` keeps its name for parity and needs ``'ring'``.

With ``tp_group`` the four dense layers of a block are Megatron's
(:mod:`~kfac_pytorch_tpu_torch.parallel.tensor`): ``qkv`` and ``fc_in``
column-parallel (``qkv`` split by heads), ``proj`` and ``fc_out``
row-parallel, each rank attending with its ``n_heads / tp`` heads; the
weights are the unsharded model's of the same seed, sharded
(:func:`shard_state_dict`).  Without a group the layers are the plain
:class:`~kfac_pytorch_tpu_torch.models.layers.Dense`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu_torch.layers.coverage import TiedAttend
from kfac_pytorch_tpu_torch.models.layers import Dense
from kfac_pytorch_tpu_torch.models.layers import Embed
from kfac_pytorch_tpu_torch.models.layers import LayerNorm
from kfac_pytorch_tpu_torch.models.layers import remat_call
from kfac_pytorch_tpu_torch.models.layers import resolve_device
from kfac_pytorch_tpu_torch.models.layers import split_heads_attention
from kfac_pytorch_tpu_torch.parallel.ring_attention import RingLinks
from kfac_pytorch_tpu_torch.parallel.ring_attention import \
    ring_self_attention
from kfac_pytorch_tpu_torch.parallel.tensor import ColumnParallelDense
from kfac_pytorch_tpu_torch.parallel.tensor import RowParallelDense
from kfac_pytorch_tpu_torch.parallel.tensor import group_rank_size
from kfac_pytorch_tpu_torch.parallel.tensor import local_heads
from kfac_pytorch_tpu_torch.parallel.tensor import \
    shard_state_dict as tensor_state_dict


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Model hyperparameters; :func:`gpt_125m` is the GPT-NeoX small
    configuration the JAX package mirrors."""

    vocab_size: int = 50304
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 2048
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    attention_impl: str = 'dense'
    seq_axis: str | None = None

    def __post_init__(self) -> None:
        if self.attention_impl not in ('dense', 'ring'):
            raise ValueError(
                "attention_impl must be 'dense' or 'ring', got "
                f'{self.attention_impl!r}',
            )
        if self.seq_axis is not None and self.attention_impl != 'ring':
            raise ValueError(
                "seq_axis requires attention_impl='ring' (dense attention "
                'never shards the sequence dimension)',
            )
        if self.d_model % self.n_heads:
            raise ValueError(
                f'd_model {self.d_model} is not a multiple of n_heads '
                f'{self.n_heads}',
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class Attention(nn.Module):
    """Causal multi-head self-attention: ``qkv`` projection, softmax
    attention in f32 (this rank's heads under ``tp_group``; ring
    attention over ``seq_links`` with ``attention_impl='ring'``),
    ``proj``."""

    def __init__(self, config: GPTConfig, seq_links: RingLinks | None = None,
                 tp_group: Any = None) -> None:
        super().__init__()
        self.config = config
        self.seq_links = seq_links
        d, cd = config.d_model, config.dtype
        self.n_heads = local_heads(config.n_heads, tp_group)
        self.width = self.n_heads * config.head_dim
        if tp_group is None:
            self.qkv = Dense(d, 3 * d, cd)
            self.proj = Dense(d, d, cd)
        else:
            self.qkv = ColumnParallelDense(d, 3 * d, cd, tp_group, parts=3)
            self.proj = RowParallelDense(d, d, cd, tp_group)
        self.drop = nn.Dropout(config.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        q, k, v = self.qkv(x).split(self.width, dim=-1)
        if cfg.attention_impl == 'ring':
            B, T, _ = q.shape
            shape = (B, T, self.n_heads, cfg.head_dim)
            out = ring_self_attention(
                q.reshape(shape), k.reshape(shape), v.reshape(shape),
                causal=True, links=self.seq_links,
            ).reshape(B, T, self.width)
        else:
            out = split_heads_attention(q, k, v, self.n_heads,
                                        is_causal=True)
        return self.drop(self.proj(out))


class MLP(nn.Module):
    """``fc_in``, tanh GELU, ``fc_out`` (column- and row-parallel under
    ``tp_group``)."""

    def __init__(self, config: GPTConfig, tp_group: Any = None) -> None:
        super().__init__()
        cd = config.dtype
        if tp_group is None:
            self.fc_in = Dense(config.d_model, config.d_ff, cd)
            self.fc_out = Dense(config.d_ff, config.d_model, cd)
        else:
            self.fc_in = ColumnParallelDense(config.d_model, config.d_ff,
                                             cd, tp_group)
            self.fc_out = RowParallelDense(config.d_ff, config.d_model, cd,
                                           tp_group)
        self.drop = nn.Dropout(config.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.fc_in(x), approximate='tanh')
        return self.drop(self.fc_out(h))


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, config: GPTConfig, seq_links: RingLinks | None = None,
                 tp_group: Any = None) -> None:
        super().__init__()
        self.ln_1 = LayerNorm(config.d_model, config.dtype)
        self.attn = Attention(config, seq_links, tp_group)
        self.ln_2 = LayerNorm(config.d_model, config.dtype)
        self.mlp = MLP(config, tp_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT(nn.Module):
    """Decoder-only LM: ``forward(tokens [B, T]) -> logits [B, T, V]``
    in f32 (with ``seq_links``, the rank's token shard and its logits).

    Args:
        config: the hyperparameters.
        seq_links: the rank's ring over its sequence group (``'ring'``
            only); ``None`` holds the whole sequence.
        tp_group: the model group of the tensor-parallel layers.
    """

    def __init__(self, config: GPTConfig, seq_links: RingLinks | None = None,
                 tp_group: Any = None) -> None:
        super().__init__()
        if seq_links is not None and config.attention_impl != 'ring':
            raise ValueError("seq_links requires attention_impl='ring'")
        self.config = config
        self.seq_links = seq_links
        self.tp_group = tp_group
        cd = config.dtype
        self.wte = Embed(config.vocab_size, config.d_model, cd)
        self.wpe = nn.Parameter(
            torch.empty(config.max_seq_len, config.d_model),
        )
        self.drop = nn.Dropout(config.dropout_rate)
        self.block_names = [f'h_{i}' for i in range(config.n_layers)]
        for name in self.block_names:
            self.add_module(name, Block(config, seq_links, tp_group))
        self.ln_f = LayerNorm(config.d_model, cd)
        self.head = TiedAttend('wte', dtype=cd)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        T = tokens.shape[1]
        at = 0 if self.seq_links is None else self.seq_links.index * T
        x = self.wte(tokens) + self.wpe[None, at:at + T].to(cfg.dtype)
        x = self.drop(x)
        for name in self.block_names:
            block = getattr(self, name)
            x = remat_call(block, x) if cfg.remat else block(x)
        x = self.ln_f(x)
        logits = self.head(x.to(cfg.param_dtype), self.wte.weight)
        return logits.float()


def init_weights(model: GPT, generator: torch.Generator) -> None:
    """The JAX model's initialization from ``generator``: dense kernels
    and the token table normal(0, 0.02), ``wpe`` normal(0, 0.01), zero
    biases, unit LayerNorm scales."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if isinstance(m, nn.Linear):
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        model.wpe.normal_(0.0, 0.01, generator=generator)


#: The tensor-parallel layers of a block: ``(name, split, parts)``.
TP_LAYERS = (('attn.qkv', 'column', 3), ('attn.proj', 'row', 1),
             ('mlp.fc_in', 'column', 1), ('mlp.fc_out', 'row', 1))


def shard_state_dict(sd: dict[str, torch.Tensor], rank: int,
                     tp: int) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s state dict of a ``tp``-way tensor-parallel GPT
    from the unsharded one: ``qkv`` split by heads, ``fc_in`` by rows,
    ``proj`` and ``fc_out`` by columns (biases whole); the rest whole."""
    return tensor_state_dict(sd, rank, tp, TP_LAYERS)


def _build(config: GPTConfig, device: Any, seed: int,
           seq_links: RingLinks | None = None, tp_group: Any = None) -> GPT:
    device = resolve_device(device)
    model = GPT(config, seq_links=seq_links, tp_group=tp_group).to(
        device=device, dtype=config.param_dtype)
    if tp_group is not None:
        # The unsharded model's draws, sharded: any tp gives the same
        # logical weights.
        full = _build(config, device, seed)
        rank, tp = group_rank_size(tp_group)
        model.load_state_dict(shard_state_dict(full.state_dict(), rank, tp))
        return model
    gen = torch.Generator(device=model.wpe.device)
    gen.manual_seed(seed)
    init_weights(model, gen)
    return model


def gpt_125m(device=None, seed: int = 0, seq_links: RingLinks | None = None,
             tp_group: Any = None, **overrides: Any) -> GPT:
    """GPT-NeoX small: vocab 50304, 12 layers, 12 heads, ``d_model``
    768, ``d_ff`` 3072, 2048 positions, bf16 compute."""
    return _build(GPTConfig(**overrides), device, seed, seq_links, tp_group)


def gpt_tiny(device=None, seed: int = 0, seq_links: RingLinks | None = None,
             tp_group: Any = None, **overrides: Any) -> GPT:
    """Test scale: vocab 256, 2 layers, 2 heads, ``d_model`` 32,
    ``d_ff`` 64, 128 positions, f32 compute."""
    defaults = dict(vocab_size=256, n_layers=2, n_heads=2, d_model=32,
                    d_ff=64, max_seq_len=128, dtype=torch.float32)
    defaults.update(overrides)
    return _build(GPTConfig(**defaults), device, seed, seq_links, tp_group)
