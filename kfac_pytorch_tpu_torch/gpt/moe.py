"""K-FAC for Mixture-of-Experts models (expert-sharded factors).

Port of ``kfac_pytorch_tpu/gpt/moe.py``.  Every expert FFN layer of a
:class:`~kfac_pytorch_tpu_torch.models.moe.MoEMLP` is a Dense layer and
the experts of one MoE layer share shapes, so their Kronecker factors
stack: ``<path>::fc_in`` and ``<path>::fc_out`` hold ``[E/X, d, d]``
factors with ``d = d_in + 1`` (the bias column), each rank the experts
whose weights it holds, decomposed by one batched ``eigh``.  The model's
other Dense layers (the router, projections, heads) are captured by the
port's :class:`~kfac_pytorch_tpu_torch.capture.ModelCapture` hooks and
kept as stacks of one.  The engine is
:class:`~kfac_pytorch_tpu_torch.gpt.stacked.StackedKFAC`.

Across ranks the groups are the model's (:class:`~kfac_pytorch_tpu_\
torch.models.moe.MoEMLP`'s ``expert_group`` and ``data_group``):

* expert capacity slots are the expert layers' rows (empty slots are
  zero rows; the count is the capacity ``C``), and the router sees every
  data shard's tokens, so their output gradients, which on each data
  rank cover its own tokens, are averaged over the data group before the
  covariance: the global batch's rows;
* the other Dense layers see the rank's own tokens; their output
  gradients, of the rank's own mean loss, are scaled by ``1 / D``;
* then every factor is averaged over the data group, and every
  parameter gradient too (the forward and backward here does it, as
  ``DistributedDataParallel`` would);
* the kl-clip sum adds the dense terms once and sums the expert terms
  over the expert group.

Usage (the JAX call shape: the preconditioner runs the forward and
backward)::

    precond = MoEKFACPreconditioner(model, loss_fn, inv_update_steps=10)
    for x, y in batches:
        loss = precond.step(x, loss_args=(y,))  # .grad preconditioned
        opt.step()
"""
from __future__ import annotations

import logging
from typing import Any, Callable

import torch

from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.engine import _split_loss
from kfac_pytorch_tpu_torch.gpt.stacked import StackedKFAC
from kfac_pytorch_tpu_torch.gpt.stacked import StackSpec
from kfac_pytorch_tpu_torch.models.layers import recomputing
from kfac_pytorch_tpu_torch.models.moe import EXPERT_LAYERS
from kfac_pytorch_tpu_torch.models.moe import MoEMLP
from kfac_pytorch_tpu_torch.ops.cov import append_bias_ones
from kfac_pytorch_tpu_torch.parallel.collectives import mean_over
from kfac_pytorch_tpu_torch.parallel.collectives import group_extent

logger = logging.getLogger(__name__)


def _expert_spec(name, moe, sub, w, b) -> StackSpec:
    cfg = moe.config
    din = (cfg.d_model if sub == 'fc_in' else cfg.d_ff) + 1
    dout = cfg.d_ff if sub == 'fc_in' else cfg.d_model
    weight, bias = getattr(moe, w), getattr(moe, b)

    def get_grad():
        g = weight.grad.mT  # [E/X, out, in]
        return torch.cat([g, bias.grad[:, :, None]], dim=2)

    def set_grad(c):
        weight.grad.copy_(c[:, :, :-1].mT)
        bias.grad.copy_(c[:, :, -1])

    return StackSpec(
        name=name, din=din, dout=dout, stack=moe.local_experts,
        offset=moe.expert_offset, total=cfg.n_experts, sharded=True,
        get_grad=get_grad, set_grad=set_grad, params=(weight, bias),
    )


def _dense_spec(name, helper) -> StackSpec:
    return StackSpec(
        name=name, din=helper.a_factor_shape[0],
        dout=helper.g_factor_shape[0], stack=1, offset=0, total=0,
        sharded=False,
        get_grad=lambda: helper.get_grad()[None],
        set_grad=lambda c: helper.set_grad(c[0]),
        params=tuple(helper.module.parameters()),
    )


class MoEKFACPreconditioner(StackedKFAC):
    """K-FAC for a model holding :class:`~kfac_pytorch_tpu_torch.models.\
moe.MoEMLP` layers (module docstring).

    Args:
        model: the module; ``loss_fn(model(*args), *loss_args)`` is the
            loss (the model's output carries the aux loss, which
            ``loss_fn`` adds if it wants it).
        loss_fn: as above; may return ``(loss, aux)``.
        The rest: the JAX keyword names and defaults (``lowrank_rank``
        and ``ekfac`` are mutually exclusive; ``adaptive_refresh`` needs
        ``ekfac``).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn: Callable[..., Any],
        *,
        factor_update_steps: Any = 10,
        inv_update_steps: Any = 100,
        damping: Any = 0.001,
        factor_decay: Any = 0.95,
        kl_clip: Any = 0.001,
        lr: Any = 0.1,
        lowrank_rank: int | None = None,
        lowrank_oversample: int = 32,
        lowrank_power_iters: int = 2,
        factor_dtype: torch.dtype = torch.float32,
        inv_dtype: torch.dtype = torch.float32,
        accumulation_steps: int = 1,
        ekfac: bool = False,
        adaptive_refresh: Any = None,
        loglevel: int = logging.DEBUG,
    ) -> None:
        self._moe = {name: m for name, m in model.named_modules()
                     if isinstance(m, MoEMLP)}
        groups = {(id(m.expert_group), id(m.data_group))
                  for m in self._moe.values()}
        if len(groups) > 1:
            raise ValueError('every MoEMLP must share one expert group and '
                             'one data group')
        first = next(iter(self._moe.values()), None)
        self.expert_group = None if first is None else first.expert_group
        self.data_group = None if first is None else first.data_group
        self._capture = ModelCapture(model)
        self._routers = {f'{path}.router' for path in self._moe}
        specs = [_dense_spec(n, h) for n, h in self._capture.helpers.items()]
        for path, moe in self._moe.items():
            moe.kfac_capture = self._capture_expert
            specs += [_expert_spec(f'{path}::{sub}', moe, sub, w, b)
                      for sub, w, b in EXPERT_LAYERS]
        self._expert_acts: dict[str, torch.Tensor] = {}
        self._expert_grads: dict[str, torch.Tensor] = {}
        self._moe_names = {id(m): p for p, m in self._moe.items()}
        self._init_stacked(
            model, loss_fn, specs,
            device=next(model.parameters()).device,
            factor_group=self.data_group, shard_group=self.expert_group,
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
        logger.log(loglevel, 'Registered %d dense + %d MoE K-FAC layers: '
                   '%s + %s', len(self._capture.helpers), len(self._moe),
                   list(self._capture.helpers), list(self._moe))

    # -- capture ---------------------------------------------------------

    def _arm_capture(self, on: bool) -> None:
        self._armed = on
        self._capture.armed = on

    def _capture_expert(self, module: MoEMLP, sub: str, x: torch.Tensor,
                        y: torch.Tensor) -> None:
        """The expert layers' capture point (``MoEMLP.kfac_capture``)."""
        if not (self._armed and module.training and torch.is_grad_enabled()
                and not recomputing() and y.requires_grad):
            return
        name = f'{self._moe_names[id(module)]}::{sub}'
        self._expert_acts[name] = x.detach()

        def hook(grad):
            self._expert_grads[name] = grad.detach()
        y.register_hook(hook)

    def _take_rows(self) -> dict[str, tuple]:
        D = group_extent(self.data_group)
        rows = {}
        for name, roles in self._capture.take().items():
            (helper, acts, grads), = roles
            a = torch.cat([helper.get_a_rows(x)[0] for x in acts])
            g = torch.cat([helper.get_g_rows(x)[0] for x in grads]).float()
            if name in self._routers:
                g = mean_over([g], self.data_group)[0]
            else:
                g = g / D
            rows[name] = (a[None], g[None], a.shape[0])
        for name in sorted(self._expert_acts):
            if name not in self._expert_grads:
                raise RuntimeError(
                    f'expert layer {name!r} has no output gradient on a '
                    'factor-update step; run forward and backward in '
                    'training mode before step()',
                )
            a = append_bias_ones(self._expert_acts[name])
            g = mean_over([self._expert_grads[name].float()],
                                self.data_group)[0]
            rows[name] = (a, g, a.shape[1])
        self._expert_acts, self._expert_grads = {}, {}
        return rows

    def _forward_backward(self, args, loss_args, loss_fn, scale=1.0):
        loss, aux = _split_loss(loss_fn(self.model(*args), *loss_args))
        (loss if scale == 1.0 else loss * scale).backward()
        loss = loss.detach().float().reshape(())
        if group_extent(self.data_group) > 1:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            for g, mean in zip(grads, mean_over(grads,
                                                      self.data_group)):
                g.copy_(mean)
            loss = mean_over([loss], self.data_group)[0]
        return loss, aux

    def _forward_loss(self, args, loss_args, loss_fn):
        # The model's forward issues the step's collectives in its order:
        # the data group's token gather, then the expert group's rows.
        loss, _ = _split_loss(loss_fn(self.model(*args), *loss_args))
        loss = loss.float().reshape(())
        if group_extent(self.data_group) > 1:
            loss = mean_over([loss], self.data_group)[0]
        return loss

    def _topology_descriptor(self) -> str | None:
        return (f'experts over {group_extent(self.expert_group)} rank(s), '
                f'data over {group_extent(self.data_group)}')
