"""Mixture-of-Experts FFN with expert-parallel sharding.

Port of ``kfac_pytorch_tpu/models/moe.py``: a top-1 (switch) router,
capacity ``ceil(N * capacity_factor / E)`` with overflow tokens dropped,
JAX's dense one-hot dispatch and combine einsums (the cumsum fixes each
token's slot; the einsums move rows exactly), the gated combine and the
switch load-balancing loss ``E * sum(frac_routed * mean_prob)``.  The
expert weights keep JAX's ``[E, D, F]`` layout as raw parameters
``w_in``, ``b_in``, ``w_out``, ``b_out``; the router is a bias-free
:class:`~kfac_pytorch_tpu_torch.models.layers.Dense` (K-FAC preconditions
it through the standard capture).

**Expert sharding** stands for JAX's ``'expert'`` mesh axis. The
``expert_group`` of ``X`` ranks sees the same tokens, and each rank
holds ``E / X`` experts (rank ``i`` of the group the experts ``[i E/X,
(i+1) E/X)``): every rank routes and dispatches all tokens (replicated),
runs its experts on its rows of ``xin``, and all-gathers the expert
outputs ``[E/X, C, D]`` over the group (:class:`GatherRows`, whose
backward takes the rank's slice of the incoming gradient, identical on
every rank of the group); the tokens' gradient through the experts is
summed over the group (:class:`SumGrads`). The combine, the gate and the
aux loss then run replicated, so router gradients come out identical on
every rank of the group.

**A data group** (JAX's ``'data'`` axis) holds ranks with different
tokens.  JAX's program routes the global batch: capacity, slots and the
aux loss's means are over every data shard's tokens, and ``xin`` is
replicated over ``'data'``.  The port does the same: the tokens are
all-gathered over the data group (in group order, JAX's data-shard
order) and every rank dispatches all of them, runs its experts on every
data shard's rows and combines only its own tokens.  That gather's
backward sums the group's gradients before taking the rank's rows, so
with each rank's loss the mean over its own tokens and the parameter
gradients averaged over the data group, every gradient is the global
batch's.

**K-FAC capture.**  A preconditioner sets :attr:`MoEMLP.kfac_capture` to
a callable; the forward then calls it as ``capture(module, sub, x, y)``
for ``sub`` ``'fc_in'`` (``x = xin [E/X, C, D]``, ``y`` the pre-GELU
``[E/X, C, F]``) and ``'fc_out'`` (``x`` the GELU output, ``y`` the
expert outputs ``[E/X, C, D]``) — JAX's ``moe_capture`` sow and output
probes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu_torch.models.layers import Dense
from kfac_pytorch_tpu_torch.models.layers import lecun_normal_
from kfac_pytorch_tpu_torch.models.layers import resolve_device
from kfac_pytorch_tpu_torch.parallel.collectives import group_extent

#: The expert parameters, in the order the K-FAC expert stacks use them:
#: ``(sub, weight, bias)``.
EXPERT_LAYERS = (('fc_in', 'w_in', 'b_in'), ('fc_out', 'w_out', 'b_out'))


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """MoE layer hyperparameters (``capacity = ceil(tokens * capacity_
    factor / n_experts)``)."""

    n_experts: int = 8
    d_model: int = 64
    d_ff: int = 256
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32


def capacity(config: MoEConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` routed tokens (JAX's
    ``int(-(-n * cf // E))``)."""
    return int(-(-n_tokens * config.capacity_factor // config.n_experts))


def probe_shapes(
    config: MoEConfig, n_tokens: int,
) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The expert layers' output shapes for ``n_tokens`` routed tokens
    (JAX ``MoEMLP.probe_shapes``): ``fc_in [E, C, d_ff]``, ``fc_out
    [E, C, d_model]``."""
    E, C = config.n_experts, capacity(config, n_tokens)
    return {
        'fc_in': ((E, C, config.d_ff), config.dtype),
        'fc_out': ((E, C, config.d_model), config.dtype),
    }


def group_rank(group) -> int:
    """This rank's index in ``group`` (0 for ``None`` or one rank)."""
    if group_extent(group) == 1:
        return 0
    return dist.get_rank(group)


class GatherRows(torch.autograd.Function):
    """All-gather ``x`` along dim 0 over ``group`` (in group order).

    The backward gives this rank's rows of the incoming gradient; with
    ``sum_grads`` the group's gradients are summed first (the gather's
    adjoint when the ranks' gradients differ), without it they must
    already be equal on every rank.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any,
                sum_grads: bool) -> torch.Tensor:
        n = group_extent(group)
        ctx.group, ctx.sum_grads = group, sum_grads
        ctx.rows, ctx.index = x.shape[0], group_rank(group)
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if ctx.sum_grads:
            grad = grad.contiguous()
            dist.all_reduce(grad, group=ctx.group)
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


class SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``
    (each rank's experts see part of every token's gradient)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather_rows(x: torch.Tensor, group: Any, sum_grads: bool) -> torch.Tensor:
    """:class:`GatherRows` (``x`` itself for a group of one rank)."""
    if group_extent(group) == 1:
        return x
    return GatherRows.apply(x, group, sum_grads)


class MoEMLP(nn.Module):
    """Top-1 (switch) MoE FFN: ``forward(x [B, T, D]) -> (y [B, T, D],
    aux)``.

    Args:
        config: the layer's hyperparameters.
        expert_group: the ranks sharing the experts (``None``: this rank
            holds all ``E``); its size must divide ``n_experts``.
        data_group: the ranks holding other tokens (``None``: one).
    """

    def __init__(self, config: MoEConfig, expert_group: Any = None,
                 data_group: Any = None) -> None:
        super().__init__()
        E, D, Fd = config.n_experts, config.d_model, config.d_ff
        X = group_extent(expert_group)
        if E % X:
            raise ValueError(
                f'{E} experts do not split over an expert group of {X}',
            )
        self.config = config
        self.expert_group = expert_group
        self.data_group = data_group
        self.local_experts = E // X
        #: First expert this rank holds.
        self.expert_offset = group_rank(expert_group) * self.local_experts
        self.router = Dense(D, E, config.dtype, bias=False)
        El = self.local_experts
        self.w_in = nn.Parameter(torch.zeros(El, D, Fd))
        self.b_in = nn.Parameter(torch.zeros(El, Fd))
        self.w_out = nn.Parameter(torch.zeros(El, Fd, D))
        self.b_out = nn.Parameter(torch.zeros(El, D))
        #: ``capture(module, sub, x, y)`` or ``None`` (module docstring).
        self.kfac_capture: Callable[..., None] | None = None

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg, cd = self.config, self.config.dtype
        B, T, D = x.shape
        E = cfg.n_experts
        own = x.reshape(B * T, D)
        tokens = gather_rows(own, self.data_group, sum_grads=True)
        N = tokens.shape[0]
        C = capacity(cfg, N)

        logits = self.router(tokens)
        probs = torch.softmax(logits.float(), dim=-1)
        expert_idx = torch.argmax(probs, dim=-1)
        gate = torch.gather(probs, 1, expert_idx[:, None])[:, 0]
        # Each token's slot in its expert's buffer; overflow is dropped.
        onehot = F.one_hot(expert_idx, E)
        slot = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1
        keep = slot < C
        dispatch = (
            onehot.to(cd)[:, :, None]
            * F.one_hot(torch.where(keep, slot, 0), C).to(cd)[:, None, :]
            * keep[:, None, None].to(cd)
        )
        lo, El = self.expert_offset, self.local_experts
        # Each rank's experts take part of every token's gradient.
        routed = (tokens if group_extent(self.expert_group) == 1
                  else SumGrads.apply(tokens, self.expert_group))
        xin = torch.einsum('nec,nd->ecd', dispatch[:, lo:lo + El], routed)
        h = (torch.einsum('ecd,edf->ecf', xin, self.w_in.to(cd))
             + self.b_in[:, None, :].to(cd))
        if self.kfac_capture is not None:
            self.kfac_capture(self, 'fc_in', xin, h)
        h = F.gelu(h, approximate='tanh')
        yout = (torch.einsum('ecf,efd->ecd', h, self.w_out.to(cd))
                + self.b_out[:, None, :].to(cd))
        if self.kfac_capture is not None:
            self.kfac_capture(self, 'fc_out', h, yout)
        yout = gather_rows(yout, self.expert_group, sum_grads=False)

        n0 = group_rank(self.data_group) * own.shape[0]
        rows = slice(n0, n0 + own.shape[0])
        y = torch.einsum('nec,ecd->nd', dispatch[rows], yout)
        y = y * gate[rows, None].to(cd)
        frac_routed = torch.mean(onehot.float(), dim=0)
        mean_prob = torch.mean(probs, dim=0)
        aux = E * torch.sum(frac_routed * mean_prob)
        return y.reshape(B, T, D), aux


class TinyMoEModel(nn.Module):
    """``inproj`` Dense -> :class:`MoEMLP` (residual) -> ``head`` Dense
    on the first position: the JAX package's MoE test harness
    (``tests/test_moe.py:21``).  ``forward(x [B, T, in]) -> (logits
    [B, n_classes], aux)``."""

    def __init__(self, config: MoEConfig, in_features: int,
                 n_classes: int = 8, expert_group: Any = None,
                 data_group: Any = None) -> None:
        super().__init__()
        self.inproj = Dense(in_features, config.d_model, config.dtype)
        self.moe = MoEMLP(config, expert_group, data_group)
        self.head = Dense(config.d_model, n_classes, config.dtype)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.inproj(x)
        y, aux = self.moe(h)
        h = h + y
        return self.head(h[:, 0]), aux


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX initializers from ``generator``: Dense kernels Flax's
    ``lecun_normal``, the router and the expert weights normal(0, 0.02),
    zero biases.  Expert weights are drawn for all ``E`` experts and a
    sharded :class:`MoEMLP` keeps its rows, so every expert group size
    gives the same experts."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MoEMLP):
                m.router.weight.normal_(0.0, 0.02, generator=generator)
                cfg = m.config
                E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
                rows = slice(m.expert_offset,
                             m.expert_offset + m.local_experts)
                for name, shape in (('w_in', (E, D, Fd)),
                                    ('w_out', (E, Fd, D))):
                    full = torch.empty(shape, device=m.w_in.device)
                    full.normal_(0.0, 0.02, generator=generator)
                    getattr(m, name).copy_(full[rows])
                m.b_in.zero_()
                m.b_out.zero_()
            elif isinstance(m, nn.Linear) and not any(
                    m is sub.router for sub in model.modules()
                    if isinstance(sub, MoEMLP)):
                lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()


def tiny_moe_model(config: MoEConfig, in_features: int, n_classes: int = 8,
                   device: Any = None, seed: int = 0,
                   expert_group: Any = None,
                   data_group: Any = None) -> TinyMoEModel:
    """A :class:`TinyMoEModel` on ``device`` (the card by default),
    initialized from ``seed``."""
    model = TinyMoEModel(config, in_features, n_classes, expert_group,
                         data_group).to(resolve_device(device))
    gen = torch.Generator(device=model.head.weight.device)
    gen.manual_seed(seed)
    init_weights(model, gen)
    return model

