"""Pipeline-stage-partitioned decoder LM.

Port of ``kfac_pytorch_tpu/models/pipeline.py``: the transformer trunk
is ``n_stages`` stages of ``blocks_per_stage`` pre-LN GPT blocks
(:class:`StageCore`, built from the port's
:class:`~kfac_pytorch_tpu_torch.models.gpt.Block`); the embedding and
the head (an f32 LayerNorm with epsilon 1e-6, then the tied ``wte``) sit
outside the pipeline and K-FAC leaves them alone.

Where the JAX package stacks the stages' parameters ``[S, ...]`` and
shards them over ``'pipe'``, a :class:`PipelineLM` holds the stages
named in ``stages`` (default all) under ``stages.<s>``: a pipe rank holds
its own, a process holding all of them runs :meth:`PipelineLM.\
apply_sequential`, the semantic spec.  Every pipe rank holds ``embed``
and ``head`` (JAX replicates them over ``'pipe'``).

:meth:`PipelineLM.pipelined_loss` is the training step's forward and
backward on a ``[pipe, data]`` grid (rank ``r`` is stage ``r // D``,
data index ``r % D``, the order of JAX's ``Mesh(devices.reshape(n_pipe,
n_data))``): stage 0 embeds, the GPipe schedule
(:mod:`kfac_pytorch_tpu_torch.parallel.pipeline`) runs the stages, the
last stage runs the head and the loss; then the ``embed``/``head``
gradients are summed over the pipe group (``wte`` gets the lookup's part
and the head's, JAX's replicated gradient) and every gradient is
averaged over the data group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch import nn

from kfac_pytorch_tpu_torch.models.gpt import Block
from kfac_pytorch_tpu_torch.models.gpt import GPTConfig
from kfac_pytorch_tpu_torch.models.layers import resolve_device
from kfac_pytorch_tpu_torch.parallel import pipeline as pp
from kfac_pytorch_tpu_torch.parallel.collectives import mean_over
from kfac_pytorch_tpu_torch.parallel.collectives import group_extent


@dataclasses.dataclass(frozen=True)
class PipeLMConfig:
    """Pipeline LM hyperparameters (``n_layers = n_stages *
    blocks_per_stage``; the block geometry is a
    :class:`~kfac_pytorch_tpu_torch.models.gpt.GPTConfig`'s)."""

    vocab_size: int = 256
    n_stages: int = 4
    blocks_per_stage: int = 1
    n_heads: int = 2
    d_model: int = 32
    d_ff: int = 64
    max_seq_len: int = 128
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def block_config(self) -> GPTConfig:
        return GPTConfig(
            vocab_size=self.vocab_size,
            n_layers=self.n_stages * self.blocks_per_stage,
            n_heads=self.n_heads, d_model=self.d_model, d_ff=self.d_ff,
            max_seq_len=self.max_seq_len, dtype=self.dtype,
            param_dtype=self.param_dtype,
        )


class StageCore(nn.Module):
    """One pipeline stage: ``blocks_per_stage`` blocks ``b_0, b_1, ...``."""

    def __init__(self, config: PipeLMConfig) -> None:
        super().__init__()
        cfg = config.block_config
        self.block_names = [f'b_{i}' for i in range(config.blocks_per_stage)]
        for name in self.block_names:
            self.add_module(name, Block(cfg))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class Embedding(nn.Module):
    """``wte [V, D]`` and ``wpe [L, D]`` as bare parameters (JAX's
    ``params['embed']``)."""

    def __init__(self, config: PipeLMConfig) -> None:
        super().__init__()
        self.wte = nn.Parameter(torch.empty(config.vocab_size,
                                            config.d_model))
        self.wpe = nn.Parameter(torch.empty(config.max_seq_len,
                                            config.d_model))


class Head(nn.Module):
    """The final LayerNorm's ``scale`` and ``bias`` (JAX's
    ``params['head']``)."""

    def __init__(self, config: PipeLMConfig) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(config.d_model))
        self.bias = nn.Parameter(torch.zeros(config.d_model))


class PipelineLM(nn.Module):
    """Decoder LM bundle: embed -> stages -> tied head.

    Args:
        config: the hyperparameters.
        stages: the stages this process holds (default all).
    """

    def __init__(self, config: PipeLMConfig,
                 stages: Sequence[int] | None = None) -> None:
        super().__init__()
        self.config = config
        held = range(config.n_stages) if stages is None else stages
        self.embed = Embedding(config)
        self.stages = nn.ModuleDict(
            {str(s): StageCore(config) for s in held})
        self.head = Head(config)

    # -- pieces ----------------------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """``[..., T]`` token ids -> ``[..., T, D]`` activations."""
        T = tokens.shape[-1]
        x = self.embed.wte[tokens] + self.embed.wpe[:T]
        return x.to(self.config.dtype)

    def apply_head(self, h: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and tied-embedding logits, in f32."""
        h = h.float()
        mu = torch.mean(h, dim=-1, keepdim=True)
        var = torch.mean((h - mu) ** 2, dim=-1, keepdim=True)
        h = (h - mu) * torch.rsqrt(var + 1e-6)
        h = h * self.head.scale + self.head.bias
        return h @ self.embed.wte.float().T

    def apply_stage(self, stage: int, x: torch.Tensor) -> torch.Tensor:
        """One stage's blocks."""
        return self.stages[str(stage)](x)

    def apply_sequential(self, tokens: torch.Tensor) -> torch.Tensor:
        """Stage by stage in one process (every stage held): the spec the
        pipelined execution matches."""
        x = self.embed_tokens(tokens)
        for s in range(self.config.n_stages):
            x = self.apply_stage(s, x)
        return self.apply_head(x)

    # -- the pipelined step ------------------------------------------------

    def _check_grid(self, links: pp.PipeLinks) -> None:
        if links.n_stages != self.config.n_stages:
            raise ValueError(
                f'the pipe group has {links.n_stages} ranks but the model '
                f'has n_stages={self.config.n_stages}; the GPipe schedule '
                'needs exactly one stage per pipe rank',
            )
        if list(self.stages) != [str(links.stage)]:
            raise ValueError(
                f'pipe rank of stage {links.stage} holds stages '
                f'{list(self.stages)}',
            )

    def _run(self, tokens, n_microbatches, links):
        cfg = self.config
        tokens_mb = pp.microbatch(tokens, n_microbatches)
        like = torch.empty(
            (tokens_mb.shape[1], tokens_mb.shape[2], cfg.d_model),
            dtype=cfg.dtype, device=tokens.device)
        return pp.gpipe(
            lambda x: self.apply_stage(links.stage, x),
            lambda m: self.embed_tokens(tokens_mb[m]),
            like, links, n_microbatches,
        )

    def _last_stage_logits(self, outputs) -> torch.Tensor:
        return self.apply_head(torch.cat(list(outputs), dim=0))

    @torch.no_grad()
    def apply_pipelined(self, tokens: torch.Tensor, *, n_microbatches: int,
                        links: pp.PipeLinks) -> torch.Tensor:
        """The GPipe forward; every pipe rank returns the ``[B, T, V]``
        logits of its tokens (broadcast from the last stage over the pipe
        group)."""
        self._check_grid(links)
        _, outputs = self._run(tokens, n_microbatches, links)
        shape = (*tokens.shape, self.config.vocab_size)
        if links.stage == links.n_stages - 1:
            logits = self._last_stage_logits(outputs)
        else:
            logits = torch.empty(shape, device=tokens.device)
        if links.n_stages > 1:
            dist.broadcast(logits, links.ranks[-1], group=links.group)
        return logits

    def pipelined_loss(
        self,
        tokens: torch.Tensor,
        loss_fn: Callable[..., torch.Tensor],
        loss_args: tuple = (),
        *,
        n_microbatches: int,
        links: pp.PipeLinks,
        data_group: Any = None,
    ) -> torch.Tensor:
        """Forward and backward of ``loss_fn(logits [B, T, V],
        *loss_args)`` on this rank's tokens through the GPipe schedule;
        gradients land in ``.grad`` (module docstring).  Returns the loss
        averaged over the data group, on every rank (detached)."""
        self._check_grid(links)
        inputs, outputs = self._run(tokens, n_microbatches, links)
        last = links.stage == links.n_stages - 1
        loss = (loss_fn(self._last_stage_logits(outputs), *loss_args)
                if last else None)
        pp.gpipe_backward(inputs, outputs, links, loss)
        shared = [*self.embed.parameters(), *self.head.parameters()]
        for p in shared:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if links.n_stages > 1:
            flat = torch.cat([p.grad.reshape(-1) for p in shared])
            dist.all_reduce(flat, group=links.group)
            offset = 0
            for p in shared:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
        if group_extent(data_group) > 1:
            grads = [p.grad for p in self.parameters() if p.grad is not None]
            for g, mean in zip(grads, mean_over(grads, data_group)):
                g.copy_(mean)
        return self._shared_loss(loss, tokens, links, data_group)

    @torch.no_grad()
    def pipelined_loss_only(
        self,
        tokens: torch.Tensor,
        loss_fn: Callable[..., torch.Tensor],
        loss_args: tuple = (),
        *,
        n_microbatches: int,
        links: pp.PipeLinks,
        data_group: Any = None,
    ) -> torch.Tensor:
        """:meth:`pipelined_loss`'s forward ticks and loss alone, with no
        backward tick and no gradient: the loss averaged over the data
        group, on every rank."""
        self._check_grid(links)
        _, outputs = self._run(tokens, n_microbatches, links)
        loss = (loss_fn(self._last_stage_logits(outputs), *loss_args)
                if links.stage == links.n_stages - 1 else None)
        return self._shared_loss(loss, tokens, links, data_group)

    @staticmethod
    def _shared_loss(loss, tokens, links, data_group) -> torch.Tensor:
        """The last stage's loss broadcast over the pipe group, then
        averaged over the data group (detached)."""
        value = (loss.detach().float().reshape(()) if loss is not None
                 else torch.zeros((), device=tokens.device))
        if links.n_stages > 1:
            dist.broadcast(value, links.ranks[-1], group=links.group)
        if group_extent(data_group) > 1:
            value = mean_over([value], data_group)[0]
        return value


def init_weights(model: PipelineLM, seed: int) -> None:
    """JAX's initialization scheme from ``seed``: ``wte`` normal(0,
    0.02), ``wpe`` normal(0, 0.01), each held stage from its own
    generator (:func:`~kfac_pytorch_tpu_torch.parallel.pipeline.\
stage_generator`) with Dense kernels normal(0, 0.02), zero biases and
    unit LayerNorm scales, the head LayerNorm at one and zero."""
    device = model.embed.wte.device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        model.embed.wte.normal_(0.0, 0.02, generator=gen)
        model.embed.wpe.normal_(0.0, 0.01, generator=gen)
        for s, core in model.stages.items():
            stage_gen = pp.stage_generator(seed, int(s), device)
            for m in core.modules():
                if isinstance(m, nn.Linear):
                    m.weight.normal_(0.0, 0.02, generator=stage_gen)
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
        model.head.scale.fill_(1.0)
        model.head.bias.zero_()


def pipeline_lm(config: PipeLMConfig, *, grid: Any = None,
                device: Any = None, seed: int = 0) -> PipelineLM:
    """A :class:`PipelineLM` on ``device`` (the card by default),
    initialized from ``seed``.  With ``grid`` (a pipe-major
    :class:`~kfac_pytorch_tpu_torch.parallel.mesh.AxisGroups`) it holds
    the rank's stage; without, every stage."""
    stages = None if grid is None else [grid.outer]
    model = PipelineLM(config, stages).to(resolve_device(device))
    init_weights(model, seed)
    return model
