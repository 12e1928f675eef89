"""BERT-style encoder with a SQuAD span head.

Port of ``kfac_pytorch_tpu/models/bert.py``: token embedding ``wte``,
learned positions ``wpe``, an optional token-type embedding ``tte``,
``ln_embed``, post-LN encoder blocks and ``qa_head``, a Dense(2) giving
the start and end logits in f32.  Module and parameter names are the
Flax model's, so :func:`kfac_pytorch_tpu_torch.convert.\
flax_to_torch_state_dict` maps its variables one to one.

The Flax model creates ``tte`` only when ``init`` saw ``type_ids``; here
the factories' ``type_embedding`` flag decides, so the parameter set
matches the Flax variables it is compared with (``squad_bert.py`` passes
no type ids, so the default builds none).

With ``tp_group`` the four dense layers of a block are Megatron's
(:mod:`~kfac_pytorch_tpu_torch.parallel.tensor`), as
:mod:`~kfac_pytorch_tpu_torch.models.gpt` builds them and as the JAX
package's ``HIDDEN -> 'model'`` rules shard them: ``qkv`` (split by
heads) and ``fc_in`` column-parallel, ``proj`` and ``fc_out``
row-parallel, each rank attending with its ``n_heads / tp`` heads; the
embeddings, the LayerNorms and ``qa_head`` are whole on every rank.  The
weights are the unsharded model's of the same seed, sharded
(:func:`shard_state_dict`).

A boolean ``mask [B, T]`` (True where a token is real) puts ``-1e9``
into the masked keys' attention logits, as an additive f32 mask, and
into the masked positions' start and end logits.  ``remat=True``
checkpoints each block, as Flax's ``nn.remat(EncoderBlock)``.  Compute
dtypes follow
:mod:`kfac_pytorch_tpu_torch.models.gpt`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu_torch.models.layers import Dense
from kfac_pytorch_tpu_torch.models.layers import Embed
from kfac_pytorch_tpu_torch.models.layers import LayerNorm
from kfac_pytorch_tpu_torch.models.layers import remat_call
from kfac_pytorch_tpu_torch.models.layers import resolve_device
from kfac_pytorch_tpu_torch.models.layers import split_heads_attention
from kfac_pytorch_tpu_torch.parallel.tensor import ColumnParallelDense
from kfac_pytorch_tpu_torch.parallel.tensor import RowParallelDense
from kfac_pytorch_tpu_torch.parallel.tensor import group_rank_size
from kfac_pytorch_tpu_torch.parallel.tensor import local_heads
from kfac_pytorch_tpu_torch.parallel.tensor import \
    shard_state_dict as tensor_state_dict

#: What the JAX model writes into masked logits.
MASKED = -1e9


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Encoder hyperparameters; :func:`bert_large` is BERT-large."""

    vocab_size: int = 30522
    n_layers: int = 24
    n_heads: int = 16
    d_model: int = 1024
    d_ff: int = 4096
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

    def __post_init__(self) -> None:
        if self.d_model % self.n_heads:
            raise ValueError(
                f'd_model {self.d_model} is not a multiple of n_heads '
                f'{self.n_heads}',
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class EncoderBlock(nn.Module):
    """Post-LN encoder block: ``qkv``, attention, ``proj``, then
    ``ln_attn`` of the residual sum; ``fc_in``, tanh GELU, ``fc_out``,
    then ``ln_mlp`` of the residual sum (the dense layers tensor-parallel
    over ``tp_group``)."""

    def __init__(self, config: BertConfig, tp_group: Any = None) -> None:
        super().__init__()
        self.config = config
        d, cd = config.d_model, config.dtype
        self.n_heads = local_heads(config.n_heads, tp_group)
        self.width = self.n_heads * config.head_dim
        if tp_group is None:
            self.qkv = Dense(d, 3 * d, cd)
            self.proj = Dense(d, d, cd)
            self.fc_in = Dense(d, config.d_ff, cd)
            self.fc_out = Dense(config.d_ff, d, cd)
        else:
            self.qkv = ColumnParallelDense(d, 3 * d, cd, tp_group, parts=3)
            self.proj = RowParallelDense(d, d, cd, tp_group)
            self.fc_in = ColumnParallelDense(d, config.d_ff, cd, tp_group)
            self.fc_out = RowParallelDense(config.d_ff, d, cd, tp_group)
        self.drop_attn = nn.Dropout(config.dropout_rate)
        self.ln_attn = LayerNorm(d, cd)
        self.drop_mlp = nn.Dropout(config.dropout_rate)
        self.ln_mlp = LayerNorm(d, cd)

    def forward(self, x: torch.Tensor,
                attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        q, k, v = self.qkv(x).split(self.width, dim=-1)
        out = split_heads_attention(q, k, v, self.n_heads,
                                    attn_mask=attn_mask)
        x = self.ln_attn(x + self.drop_attn(self.proj(out)))
        h = F.gelu(self.fc_in(x), approximate='tanh')
        return self.ln_mlp(x + self.drop_mlp(self.fc_out(h)))


class BertForQA(nn.Module):
    """``forward(tokens [B, T], type_ids=None, mask=None) ->
    (start_logits [B, T], end_logits [B, T])``, f32.

    Args:
        config: the hyperparameters.
        type_embedding: build ``tte`` (needs ``type_vocab_size``); a
            model without it raises when given ``type_ids``.
        tp_group: the model group of the tensor-parallel layers.
    """

    def __init__(self, config: BertConfig, type_embedding: bool = False,
                 tp_group: Any = None) -> None:
        super().__init__()
        self.config = config
        d, cd = config.d_model, config.dtype
        self.wte = Embed(config.vocab_size, d, cd)
        self.wpe = nn.Parameter(torch.empty(config.max_seq_len, d))
        if type_embedding:
            if not config.type_vocab_size:
                raise ValueError('type_embedding needs type_vocab_size > 0')
            self.tte = Embed(config.type_vocab_size, d, cd)
        else:
            self.tte = None
        self.ln_embed = LayerNorm(d, cd)
        self.block_names = [f'h_{i}' for i in range(config.n_layers)]
        for name in self.block_names:
            self.add_module(name, EncoderBlock(config, tp_group))
        self.qa_head = Dense(d, 2, cd)

    def forward(self, tokens: torch.Tensor,
                type_ids: torch.Tensor | None = None,
                mask: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        T = tokens.shape[1]
        x = self.wte(tokens) + self.wpe[None, :T].to(cfg.dtype)
        if type_ids is not None:
            if self.tte is None:
                raise ValueError(
                    'type_ids given to a model built without tte (build it '
                    'with type_embedding=True)',
                )
            x = x + self.tte(type_ids)
        x = self.ln_embed(x)
        attn_mask = None
        if mask is not None:
            attn_mask = torch.zeros(mask.shape, dtype=torch.float32,
                                    device=mask.device)
            attn_mask = attn_mask.masked_fill(~mask, MASKED)[:, None, None]
        for name in self.block_names:
            block = getattr(self, name)
            x = (remat_call(block, x, attn_mask) if cfg.remat
                 else block(x, attn_mask))
        spans = self.qa_head(x).float()
        start, end = spans[..., 0], spans[..., 1]
        if mask is not None:
            start = start.masked_fill(~mask, MASKED)
            end = end.masked_fill(~mask, MASKED)
        return start, end


def init_weights(model: BertForQA, generator: torch.Generator) -> None:
    """The JAX model's initialization from ``generator``: Dense kernels
    and ``wte`` normal(0, 0.02), ``wpe`` normal(0, 0.01), ``tte``
    normal(0, 1 / sqrt(d_model)) (Flax's default embedding init), zero
    biases, unit LayerNorm scales."""
    d = model.config.d_model
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                std = 0.02 if m is not model.tte else d ** -0.5
                m.weight.normal_(0.0, std, generator=generator)
                if isinstance(m, nn.Linear):
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        model.wpe.normal_(0.0, 0.01, generator=generator)


#: The tensor-parallel layers of a block: ``(name, split, parts)``.
TP_LAYERS = (('qkv', 'column', 3), ('proj', 'row', 1),
             ('fc_in', 'column', 1), ('fc_out', 'row', 1))


def shard_state_dict(sd: dict[str, torch.Tensor], rank: int,
                     tp: int) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s state dict of a ``tp``-way tensor-parallel
    ``BertForQA`` from the unsharded one: ``qkv`` split by heads,
    ``fc_in`` by rows, ``proj`` and ``fc_out`` by columns (biases whole);
    the rest whole."""
    return tensor_state_dict(sd, rank, tp, TP_LAYERS)


def _build(config: BertConfig, device: Any, seed: int,
           type_embedding: bool, tp_group: Any = None) -> BertForQA:
    model = BertForQA(config, type_embedding, tp_group).to(
        device=resolve_device(device), dtype=config.param_dtype)
    if tp_group is not None:
        # The unsharded model's draws, sharded: any tp gives the same
        # logical weights.
        full = _build(config, model.wpe.device, seed, type_embedding)
        rank, tp = group_rank_size(tp_group)
        model.load_state_dict(shard_state_dict(full.state_dict(), rank, tp))
        return model
    gen = torch.Generator(device=model.wpe.device)
    gen.manual_seed(seed)
    init_weights(model, gen)
    return model


def bert_large(device=None, seed: int = 0, type_embedding: bool = False,
               tp_group: Any = None, **overrides: Any) -> BertForQA:
    """BERT-large: vocab 30522, 24 layers, 16 heads, ``d_model`` 1024,
    ``d_ff`` 4096, 512 positions, bf16 compute."""
    return _build(BertConfig(**overrides), device, seed, type_embedding,
                  tp_group)


def bert_base(device=None, seed: int = 0, type_embedding: bool = False,
              tp_group: Any = None, **overrides: Any) -> BertForQA:
    """BERT-base: 12 layers, 12 heads, ``d_model`` 768, ``d_ff`` 3072."""
    defaults = dict(n_layers=12, n_heads=12, d_model=768, d_ff=3072)
    defaults.update(overrides)
    return _build(BertConfig(**defaults), device, seed, type_embedding,
                  tp_group)


def bert_tiny(device=None, seed: int = 0, type_embedding: bool = False,
              tp_group: Any = None, **overrides: Any) -> BertForQA:
    """Test scale: vocab 256, 2 layers, 2 heads, ``d_model`` 32, ``d_ff``
    64, 64 positions, f32 compute."""
    defaults = dict(vocab_size=256, n_layers=2, n_heads=2, d_model=32,
                    d_ff=64, max_seq_len=64, dtype=torch.float32)
    defaults.update(overrides)
    return _build(BertConfig(**defaults), device, seed, type_embedding,
                  tp_group)
