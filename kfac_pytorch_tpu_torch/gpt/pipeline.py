"""K-FAC for pipeline-parallel LMs (stage-sharded factors).

Port of ``kfac_pytorch_tpu/gpt/pipeline.py``.  The JAX package holds
every layer's factors and decompositions as ``[S, ...]`` stacks sharded
over ``'pipe'``; here a pipe rank holds its stage's, the ``[s]`` slice,
as a stack of one, and a process holding every stage of a
:class:`~kfac_pytorch_tpu_torch.models.pipeline.PipelineLM` (no pipe
group) holds all ``S`` and runs :meth:`~kfac_pytorch_tpu_torch.models.\
pipeline.PipelineLM.apply_sequential`: the JAX statistics on one device.
Dense layers only (the stage's GPT blocks), like JAX; ``embed`` and
``head`` train on their raw gradients.

The statistics of a stage are its ``M`` microbatches' activation and
output-gradient rows (the GPipe schedule computes no bubble tick), over
``M * mb * T`` rows, JAX's masked normalization; the output gradients
are of the rank's own mean loss, so they are scaled by ``1 / D`` and the
factors averaged over the stage's data group.  The kl-clip sum is
all-reduced over the pipe group, since JAX's terms span every stage.
The engine is :class:`~kfac_pytorch_tpu_torch.gpt.stacked.StackedKFAC`.

Usage on a ``[pipe, data]`` grid of ``S * D`` ranks::

    grid = parallel.mesh.axis_groups(S, D)
    model = models.pipeline.pipeline_lm(config, grid=grid, seed=0)
    precond = PipelineKFACPreconditioner(model, loss_fn, grid=grid,
                                         n_microbatches=4)
    loss = precond.step(tokens, labels)   # .grad preconditioned
"""
from __future__ import annotations

import logging
from typing import Any, Callable

import torch

from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.engine import _split_loss
from kfac_pytorch_tpu_torch.gpt.stacked import StackedKFAC
from kfac_pytorch_tpu_torch.gpt.stacked import StackSpec
from kfac_pytorch_tpu_torch.layers.helpers import DenseHelper
from kfac_pytorch_tpu_torch.models.pipeline import PipelineLM
from kfac_pytorch_tpu_torch.parallel import pipeline as pp
from kfac_pytorch_tpu_torch.parallel.collectives import group_extent
from kfac_pytorch_tpu_torch.parallel.mesh import AxisGroups

logger = logging.getLogger(__name__)


def _stage_spec(name, helpers, offset, total) -> StackSpec:
    h0 = helpers[0]

    def set_grad(c):
        for i, h in enumerate(helpers):
            h.set_grad(c[i])

    return StackSpec(
        name=name, din=h0.a_factor_shape[0], dout=h0.g_factor_shape[0],
        stack=len(helpers), offset=offset, total=total, sharded=True,
        get_grad=lambda: torch.stack([h.get_grad() for h in helpers]),
        set_grad=set_grad,
        params=tuple(p for h in helpers for p in h.module.parameters()),
    )


class PipelineKFACPreconditioner(StackedKFAC):
    """K-FAC for a :class:`~kfac_pytorch_tpu_torch.models.pipeline.\
PipelineLM` (module docstring).

    Args:
        model: the LM, holding this rank's stage (on a grid) or every
            stage (no grid).
        loss_fn: ``loss_fn(logits [B, T, V], *loss_args) -> scalar``.
        n_microbatches: GPipe's ``M``.
        grid: the pipe-major :class:`~kfac_pytorch_tpu_torch.parallel.\
mesh.AxisGroups` (``outer`` the stage, ``inner`` the data index);
            ``None``: one process.  Its pipe extent must be
            ``n_stages`` (or 1 with every stage held).
        The rest: the JAX keyword names and defaults.
    """

    def __init__(
        self,
        model: PipelineLM,
        loss_fn: Callable[..., Any],
        *,
        n_microbatches: int,
        grid: AxisGroups | None = None,
        factor_update_steps: Any = 10,
        inv_update_steps: Any = 100,
        damping: Any = 0.001,
        factor_decay: Any = 0.95,
        kl_clip: Any = 0.001,
        lr: Any = 0.1,
        factor_dtype: torch.dtype = torch.float32,
        inv_dtype: torch.dtype = torch.float32,
        accumulation_steps: int = 1,
        lowrank_rank: int | None = None,
        lowrank_oversample: int = 32,
        lowrank_power_iters: int = 2,
        ekfac: bool = False,
        adaptive_refresh: Any = None,
        loglevel: int = logging.DEBUG,
    ) -> None:
        cfg = model.config
        grid = AxisGroups(1, 1) if grid is None else grid
        S = cfg.n_stages
        if grid.n_outer not in (1, S) or (
                grid.n_outer == 1 and len(model.stages) != S):
            raise ValueError(
                f'pipe extent {grid.n_outer} != n_stages {S} (one process '
                'must hold every stage)',
            )
        self.n_microbatches = n_microbatches
        self.grid = grid
        self.links = (pp.build_pipe_links(grid) if grid.n_outer > 1
                      else None)
        held = sorted(int(s) for s in model.stages)
        self._captures = [ModelCapture(model.stages[str(s)]) for s in held]
        for name, h in self._captures[0].helpers.items():
            if type(h) is not DenseHelper:
                raise ValueError(
                    'PipelineKFACPreconditioner supports Dense layers only '
                    f'(got {type(h).__name__} for {name})',
                )
        specs = [
            _stage_spec(name, [c.helpers[name] for c in self._captures],
                        held[0], S)
            for name in self._captures[0].helpers
        ]
        self._init_stacked(
            model, loss_fn, specs,
            device=model.embed.wte.device,
            factor_group=grid.inner_group, shard_group=grid.outer_group,
            factor_update_steps=factor_update_steps,
            inv_update_steps=inv_update_steps, damping=damping,
            factor_decay=factor_decay, kl_clip=kl_clip, lr=lr,
            lowrank_rank=lowrank_rank,
            lowrank_oversample=lowrank_oversample,
            lowrank_power_iters=lowrank_power_iters,
            factor_dtype=factor_dtype, inv_dtype=inv_dtype,
            accumulation_steps=accumulation_steps, ekfac=ekfac,
            adaptive_refresh=adaptive_refresh,
        )
        logger.log(loglevel, 'Registered %d pipeline K-FAC layers x %d '
                   'stage(s) here: %s', len(specs), len(held),
                   [s.name for s in specs])

    def step(self, tokens: torch.Tensor, *loss_args: Any) -> torch.Tensor:
        """One K-FAC step (JAX ``step(params, state, tokens,
        *loss_args)``); returns the loss."""
        return super().step(tokens, loss_args=loss_args)

    def accumulate(self, tokens: torch.Tensor,
                   *loss_args: Any) -> torch.Tensor:
        """One micro-batch (:meth:`StackedKFAC.accumulate`)."""
        return super().accumulate(tokens, loss_args=loss_args)

    def _param_sharded(self, name: str) -> bool:
        return name.startswith('stages.')

    def _arm_capture(self, on: bool) -> None:
        self._armed = on
        for c in self._captures:
            c.armed = on

    def _take_rows(self) -> dict[str, tuple]:
        D = group_extent(self.grid.inner_group)
        per_stage = [c.take() for c in self._captures]
        rows = {}
        for name in self.specs:
            a_rows, g_rows = [], []
            for caps in per_stage:
                (helper, acts, grads), = caps[name]
                a_rows.append(torch.cat(
                    [helper.get_a_rows(x)[0] for x in acts]))
                g_rows.append(torch.cat(
                    [helper.get_g_rows(x)[0] for x in grads]).float() / D)
            a, g = torch.stack(a_rows), torch.stack(g_rows)
            rows[name] = (a, g, a.shape[1])
        return rows

    def _forward_backward(self, args, loss_args, loss_fn, scale=1.0):
        (tokens,) = args
        if self.links is None:
            loss, aux = _split_loss(loss_fn(
                self.model.apply_sequential(tokens), *loss_args))
            (loss if scale == 1.0 else loss * scale).backward()
            return loss.detach().float().reshape(()), aux

        def scaled(logits, *a):
            loss, _ = _split_loss(loss_fn(logits, *a))
            return loss if scale == 1.0 else loss * scale

        loss = self.model.pipelined_loss(
            tokens, scaled, loss_args, n_microbatches=self.n_microbatches,
            links=self.links, data_group=self.grid.inner_group,
        )
        return loss / scale, None

    def _forward_loss(self, args, loss_args, loss_fn):
        (tokens,) = args

        def loss_of(logits, *a):
            return _split_loss(loss_fn(logits, *a))[0]

        if self.links is None:
            return loss_of(self.model.apply_sequential(tokens),
                           *loss_args).float().reshape(())
        return self.model.pipelined_loss_only(
            tokens, loss_of, loss_args, n_microbatches=self.n_microbatches,
            links=self.links, data_group=self.grid.inner_group,
        )

    def _topology_descriptor(self) -> str | None:
        return (f'pipe {self.grid.n_outer} x data {self.grid.n_inner}, '
                f'{self.model.config.n_stages} stage(s)')
