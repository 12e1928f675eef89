"""K-FAC over per-layer stacks: the engine the MoE and pipeline flavours
share.

The JAX package's MoE and pipeline preconditioners keep, per layer, a
:class:`~kfac_pytorch_tpu.state.LayerKFACState` whose arrays carry a
leading stack dimension (experts ``[E, ...]``, stages ``[S, ...]``;
dense MoE layers none) and run the same EMA, refresh and
preconditioning code over it (``gpt/moe.py:461-801``,
``gpt/pipeline.py:425-621``).  Here a rank holds its part of each stack,
``[L, ...]``: ``E / X`` experts, its one stage, or ``L = 1`` for a dense
layer, in a :class:`StackState`, and :class:`StackedKFAC` is the shared
code, plugged into :class:`~kfac_pytorch_tpu_torch.engine.\
KFACEngineMixin` for cadence, hyperparameters, accumulation, checkpoints
and ``train_loop``.

A flavour describes its layers as :class:`StackSpec` entries and
supplies ``_take_rows()``, each layer's row-aligned activation and
output-gradient rows ``[L, R, d]`` of the step with their count (empty
slots and bubble ticks contribute zero rows or none), already scaled so
that the factor covariances averaged over ``factor_group`` are the JAX
package's global ones.  Then:

* factors: ``A = a^T a / count``, ``G = g^T g / count``, symmetrized,
  averaged over the factor (data) group in one all-reduce, EMA'd from
  the identity seed;
* refresh: batched ``eigh`` over the stack with eigenvalues clamped at
  zero, then the predivided grid ``1 / (dg da^T + damping)``; under
  EKFAC the scale grid reseeded to ``dg da^T`` with ``da``/``dg`` kept;
  with ``lowrank_rank`` the randomized decomposition, each slot drawing
  the sketch of its global index in the stack (``-1`` for a dense
  layer, which JAX decomposes unstacked);
* preconditioning: the eigen-prediv branch runs
  :func:`~kfac_pytorch_tpu_torch.ops.fused_eigen_precondition` on the
  ``[L, dout, din]`` stack (the hand-written kernel on CUDA tensors, its
  plain version on the CPU) and takes the kl-clip term from the kernel's
  per-slot ``clip``.  A stack whose ``dout`` or ``din`` is not a multiple
  of 8 (the MoE experts' and the GPipe stages' bias column: ``din`` 769,
  3073) reaches the kernel zero-padded to the next multiple of 8, where
  it takes the kernel's aligned load path: ``qa``, ``qg`` and ``dgda``
  padded once a refresh (a cache beside the layer state, which stays
  unpadded, as the JAX-format checkpoints are), the gradient padded and
  ``pg`` sliced back each step.  The padding is exact: padded rows and
  columns of ``qgᵀ·g·qa`` meet zero ``dgda``, so ``pg`` and ``clip`` are
  the unpadded ones.  The low-rank and EKFAC branches are the JAX
  package's matmul chains; the kl-clip sum adds the replicated layers'
  terms once and all-reduces the sharded layers' over ``shard_group``.

The damping is resolved each step, so an
:class:`~kfac_pytorch_tpu_torch.adaptive.AdaptiveDamping` in the slot
works as on the bucketed engine: the refresh folds the value in force
into ``dgda`` (a new tensor, so the padded cache is rebuilt), and
``make_train_step``/``train_loop`` feed the controller from the
flavour's loss-only forward (:meth:`StackedKFAC._loss_only`), the same
values on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.engine import KFACEngineMixin
from kfac_pytorch_tpu_torch.engine import unpack_factor
from kfac_pytorch_tpu_torch.ops.ekfac import ekfac_scale_contrib_stacked
from kfac_pytorch_tpu_torch.ops.lowrank import decompose_stack
from kfac_pytorch_tpu_torch.ops.lowrank import lowrank_engages
from kfac_pytorch_tpu_torch.ops.lowrank import precondition_grad_lowrank
from kfac_pytorch_tpu_torch.ops.lowrank import thin_eigen_fields
from kfac_pytorch_tpu_torch.parallel.collectives import mean_over
from kfac_pytorch_tpu_torch.parallel.collectives import group_extent


@dataclasses.dataclass
class StackState:
    """One layer's stacked state (``[L, ...]`` leading dimension): the
    factor EMAs and, once refreshed, the decomposition (``dgda`` for the
    eigen-prediv branch, ``skron``/``da``/``dg`` under EKFAC, thin
    ``qa``/``qg``/``da``/``dg`` with ``sa``/``sg`` under low-rank)."""

    a_factor: torch.Tensor
    g_factor: torch.Tensor
    qa: torch.Tensor | None = None
    qg: torch.Tensor | None = None
    da: torch.Tensor | None = None
    dg: torch.Tensor | None = None
    dgda: torch.Tensor | None = None
    skron: torch.Tensor | None = None
    sa: torch.Tensor | None = None
    sg: torch.Tensor | None = None

    def tensors(self) -> dict[str, torch.Tensor]:
        """Every field that is set."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


@dataclasses.dataclass(eq=False)
class StackSpec:
    """One registered layer of a stacked flavour.

    Attributes:
        din: A-side width (with the bias column).
        dout: G-side width.
        stack: ``L``, the slots this rank holds.
        offset: global index of the first slot.
        total: the whole stack's length as a checkpoint stores it (``0``
            for a dense layer, stored without a stack dimension).
        sharded: the stack is split over the flavour's shard group (else
            every rank of it holds the same layer).
        get_grad: ``() -> [L, dout, din]`` combined gradient.
        set_grad: writes a combined gradient back into ``.grad``.
        params: the parameters whose gradients it combines.
    """

    name: str
    din: int
    dout: int
    stack: int
    offset: int
    total: int
    sharded: bool
    get_grad: Callable[[], torch.Tensor]
    set_grad: Callable[[torch.Tensor], None]
    params: tuple = ()


class StackedKFAC(KFACEngineMixin):
    """The shared engine of :class:`~kfac_pytorch_tpu_torch.gpt.\
MoEKFACPreconditioner` and :class:`~kfac_pytorch_tpu_torch.gpt.\
PipelineKFACPreconditioner` (module docstring).

    The public calls: :meth:`step` (``(*args, loss_args=()) -> loss``:
    the forward and backward and the K-FAC step, preconditioned
    gradients left in ``.grad``), :meth:`accumulate` and :meth:`finalize`
    (``accumulation_steps > 1``), and the engine's ``make_train_step``,
    ``train_loop``, ``state_dict``/``load_state_dict`` and
    :meth:`memory_usage`.
    """

    def _init_stacked(
        self,
        model: torch.nn.Module,
        loss_fn: Callable[..., torch.Tensor],
        specs: list[StackSpec],
        *,
        device: torch.device,
        factor_group: Any,
        shard_group: Any,
        factor_update_steps: Any,
        inv_update_steps: Any,
        damping: Any,
        factor_decay: Any,
        kl_clip: Any,
        lr: Any,
        lowrank_rank: int | None,
        lowrank_oversample: int,
        lowrank_power_iters: int,
        factor_dtype: torch.dtype,
        inv_dtype: torch.dtype,
        accumulation_steps: int,
        ekfac: bool,
        adaptive_refresh: Any,
    ) -> None:
        if ekfac and lowrank_rank is not None:
            raise ValueError('ekfac and lowrank_rank are mutually exclusive')
        if adaptive_refresh is not None and not ekfac:
            raise ValueError('adaptive_refresh requires ekfac=True')
        if accumulation_steps < 1:
            raise ValueError('accumulation_steps must be >= 1')
        if lowrank_rank is not None and lowrank_rank < 1:
            raise ValueError('lowrank_rank must be >= 1')
        self.model = model
        self._train_module = model
        self.loss_fn = loss_fn
        self.ekfac = ekfac
        self.lowrank_rank = lowrank_rank
        self.lowrank_oversample = lowrank_oversample
        self.lowrank_power_iters = lowrank_power_iters
        self.factor_dtype = factor_dtype
        self.inv_dtype = inv_dtype
        self.accumulation_steps = int(accumulation_steps)
        self.device = device
        #: layer -> ``((qa, qg, dgda), padded copies)`` (:meth:`_fused`).
        self._padded: dict[str, tuple] = {}
        self.factor_group = factor_group
        self.shard_group = shard_group
        self.specs = {s.name: s for s in specs}
        covered = {id(p) for s in specs for p in s.params}
        #: The parameters outside every layer, ``(replicated, sharded
        #: over the shard group)``: ``vg_sum`` takes them as ``|g|^2``.
        self._uncovered: tuple[list, list] = ([], [])
        for name, p in model.named_parameters():
            if id(p) not in covered and p.requires_grad:
                self._uncovered[self._param_sharded(name)].append(p)
        self.layers: dict[str, StackState] = {}
        for s in specs:
            self.layers[s.name] = self._zero_state(s)
        self._accum: dict[str, list] = {}
        self._init_engine(
            factor_update_steps=factor_update_steps,
            inv_update_steps=inv_update_steps, damping=damping,
            factor_decay=factor_decay, kl_clip=kl_clip, lr=lr,
            adaptive_refresh=adaptive_refresh,
        )

    def _zero_state(self, spec: StackSpec) -> StackState:
        """Zeroed factors and decomposition (JAX ``_eigen_state_fields``:
        thin fields when a side truncates; under EKFAC the scale grid
        and the eigenvalues instead of the predivided grid), so a step
        before the first refresh preconditions to zero, as in JAX."""
        L, da, dg = spec.stack, spec.din, spec.dout

        def zeros(*shape, dtype=self.inv_dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        st = StackState(a_factor=zeros(L, da, da, dtype=self.factor_dtype),
                        g_factor=zeros(L, dg, dg, dtype=self.factor_dtype))
        thin = thin_eigen_fields((L,), da, dg, self.lowrank_rank,
                                 self.lowrank_oversample, self.inv_dtype,
                                 self.device)
        if thin is not None:
            for k, v in thin.items():
                setattr(st, k, v)
            return st
        st.qa, st.qg = zeros(L, da, da), zeros(L, dg, dg)
        if self.ekfac:
            st.skron = zeros(L, dg, da, dtype=torch.float32)
            st.da, st.dg = zeros(L, da), zeros(L, dg)
        else:
            st.dgda = zeros(L, dg, da)
        return st

    # -- what a flavour supplies ---------------------------------------

    def _take_rows(self) -> dict[str, tuple]:
        """``{name: (a_rows [L, R, din], g_rows [L, R, dout], count)}``
        of the captured step (module docstring); clears the capture."""
        raise NotImplementedError

    def _forward_backward(self, args: tuple, loss_args: tuple,
                          loss_fn: Callable[..., Any],
                          scale: float = 1.0) -> tuple[torch.Tensor, Any]:
        """Forward and backward of ``loss_fn(...) * scale`` (the engine's
        hook, with the micro-batch scale); returns the unscaled ``(loss,
        aux)``, the loss detached and averaged over the data group, with
        every gradient averaged over it."""
        raise NotImplementedError

    def _forward_loss(self, args: tuple, loss_args: tuple,
                      loss_fn: Callable[..., Any]) -> torch.Tensor:
        """The forward of :meth:`_forward_backward` alone, with its
        collectives in its order (called under ``torch.no_grad()``):
        the loss, averaged over the data group, on every rank."""
        raise NotImplementedError

    def _param_sharded(self, name: str) -> bool:
        """Whether parameter ``name`` is split over the shard group (each
        rank holds its own); the default, replicated."""
        return False

    # -- public calls ----------------------------------------------------

    def _lowrank_sides(self, spec: StackSpec) -> tuple[bool, bool]:
        k, m = self.lowrank_rank, self.lowrank_oversample
        return (lowrank_engages(spec.din, k, m),
                lowrank_engages(spec.dout, k, m))

    def step(self, *args: Any, loss_args: tuple = ()) -> torch.Tensor:
        """One K-FAC step on the batch ``args`` (JAX ``step``): the
        gradients are set to this batch's, then preconditioned in
        ``.grad``; returns the loss (detached)."""
        if self.accumulation_steps != 1:
            raise RuntimeError(
                'with accumulation_steps > 1 call accumulate() per '
                'micro-batch and then finalize()',
            )
        self.model.zero_grad(set_to_none=True)
        loss, _ = self._forward_backward(args, loss_args, self.loss_fn)
        super().step()
        return loss

    def make_train_step(self, optimizer: torch.optim.Optimizer,
                        loss_fn: Callable[..., Any] | None = None,
                        merge_updates: Any = None):
        """The engine's fused step (``optimizer.zero_grad()``, this
        flavour's forward and backward, the K-FAC step,
        ``optimizer.step()``); ``loss_fn`` defaults to the
        preconditioner's."""
        return super().make_train_step(
            optimizer, loss_fn or self.loss_fn, merge_updates)

    def train_loop(self, optimizer: torch.optim.Optimizer,
                   loss_fn: Callable[..., Any] | None = None,
                   merge_updates: Any = None):
        """The engine's loop over :meth:`make_train_step`."""
        return super().train_loop(
            optimizer, loss_fn or self.loss_fn, merge_updates)

    def accumulate(self, *args: Any, loss_args: tuple = ()) -> torch.Tensor:
        """One micro-batch's forward and backward (JAX ``accumulate``):
        its loss divided by ``accumulation_steps`` is backpropagated, so
        after ``N`` calls ``.grad`` holds the micro-batches' average
        (zero the gradients before the first); on a factor step its
        factor contributions, taken from its own loss, are summed.
        Returns the micro-batch's loss."""
        n = self.accumulation_steps
        loss, _ = self._forward_backward(args, loss_args, self.loss_fn,
                                         1.0 / n)
        if self._step_gating()[0]:
            for name, (a, g, count) in self._take_rows().items():
                entry = self._contrib(name, a, g * n, count)
                acc = self._accum.setdefault(name, [0, None])
                acc[0] += 1
                acc[1] = (list(entry) if acc[1] is None
                          else [x + y if x is not None else None
                                for x, y in zip(acc[1], entry)])
        return loss

    def finalize(self) -> None:
        """Fold the accumulated factors, refresh on cadence and
        precondition ``.grad`` (JAX ``finalize``)."""
        super().step()

    def reset_batch(self) -> None:
        """Drop the accumulated micro-batch sums."""
        self._accum = {}

    def memory_usage(self) -> dict[str, int]:
        """Bytes of this rank's factor and second-order state."""
        sizes = {'a_factors': 0, 'g_factors': 0, 'second_order': 0}
        for st in self.layers.values():
            for f, t in st.tensors().items():
                key = {'a_factor': 'a_factors',
                       'g_factor': 'g_factors'}.get(f, 'second_order')
                sizes[key] += t.numel() * t.element_size()
        sizes['total'] = sum(sizes.values())
        return sizes

    # -- factors ---------------------------------------------------------

    def _contrib(self, name: str, a: torch.Tensor, g: torch.Tensor,
                 count: int) -> tuple:
        """``(A, G, S or None)`` of one layer's rows, S the EKFAC scale
        statistic in the current basis."""
        a, g = a.float(), g.float()
        A = a.mT @ a / count
        G = g.mT @ g / count
        A = (A + A.mT) / 2.0
        G = (G + G.mT) / 2.0
        S = None
        if self.ekfac:
            st = self.layers[name]
            S = ekfac_scale_contrib_stacked(a, g, st.qa, st.qg, count=count)
        return A, G, S

    def _update_factors(self, first_update: bool) -> None:
        if self.accumulation_steps > 1:
            contribs = {}
            for name, (n, entry) in self._accum.items():
                contribs[name] = tuple(
                    None if x is None else x / n for x in entry)
            self._accum = {}
        else:
            contribs = {name: self._contrib(name, *rows)
                        for name, rows in self._take_rows().items()}
        names = sorted(contribs)
        flat = [t for n in names for t in contribs[n] if t is not None]
        flat = iter(mean_over(flat, self.factor_group))
        decay = self.factor_decay
        for name in names:
            A, G, S = (None if t is None else next(flat)
                       for t in contribs[name])
            st = self.layers[name]
            st.a_factor = ops.ema_update_factor(
                st.a_factor, A, decay, first_update)
            st.g_factor = ops.ema_update_factor(
                st.g_factor, G, decay, first_update)
            if S is not None and st.skron is not None:
                st.skron = decay * st.skron + (1.0 - decay) * S

    # -- second order ----------------------------------------------------

    def _refresh(self, damping: float) -> None:
        step = self._last_inv_step
        for li, name in enumerate(sorted(self.layers)):
            spec, st = self.specs[name], self.layers[name]
            A, G = st.a_factor.float(), st.g_factor.float()
            lr_a, lr_g = self._lowrank_sides(spec)
            if lr_a or lr_g:
                slots = ([-1] if spec.total == 0 else
                         list(range(spec.offset, spec.offset + spec.stack)))
                out = []
                for side, (stack, lowrank) in enumerate(
                        ((A, lr_a), (G, lr_g))):
                    out.append(decompose_stack(
                        stack, lowrank, self.lowrank_rank,
                        oversample=self.lowrank_oversample,
                        power_iters=self.lowrank_power_iters,
                        seed=2 * li + side, side=side, step=step,
                        slots=slots,
                    ))
                (qa, da, sa), (qg, dg, sg) = out
                cast = (lambda t: t.to(self.inv_dtype))  # noqa: E731
                st.qa, st.da, st.qg, st.dg = cast(qa), cast(da), cast(qg), \
                    cast(dg)
                st.sa = cast(sa) if lr_a else None
                st.sg = cast(sg) if lr_g else None
                continue
            da, qa = ops.symmetric_eigh(A)
            dg, qg = ops.symmetric_eigh(G)
            da = torch.clamp(da, min=0.0)
            dg = torch.clamp(dg, min=0.0)
            st.qa, st.qg = qa.to(self.inv_dtype), qg.to(self.inv_dtype)
            grid = dg[..., :, None] * da[..., None, :]
            if self.ekfac:
                st.skron = grid
                st.da, st.dg = da.to(self.inv_dtype), dg.to(self.inv_dtype)
            else:
                st.dgda = (1.0 / (grid + damping)).to(self.inv_dtype)

    # -- preconditioning -------------------------------------------------

    def _precondition(self, damping: float, kl_clip: float | None,
                      lr: float) -> torch.Tensor:
        """Precondition every layer's ``.grad`` in place and return
        ``vg_sum``: the f32 ``<raw grad, final grad>`` over every
        trainable parameter (JAX ``_tree_vdot``), a layer's taken on its
        combined gradient (``<g, pg>`` times the kl-clip scale), each
        other parameter's as ``|g|^2``; the sharded layers' and
        parameters' terms summed over the shard group."""
        pre: dict[str, torch.Tensor] = {}
        # [kl-clip terms, <g, pg>] of the replicated and sharded layers.
        replicated: list[tuple[torch.Tensor, torch.Tensor]] = []
        sharded: list[tuple[torch.Tensor, torch.Tensor]] = []
        lr2 = float(lr) ** 2
        for name, spec in self.specs.items():
            st = self.layers[name]
            g = spec.get_grad().float().contiguous()
            qa, qg = st.qa.float(), st.qg.float()
            lr_a, lr_g = self._lowrank_sides(spec)
            if lr_a or lr_g:
                zeros = torch.zeros(spec.stack, device=g.device)
                pg = precondition_grad_lowrank(
                    g,
                    (qa, st.da.float(),
                     st.sa.float() if st.sa is not None else zeros),
                    (qg, st.dg.float(),
                     st.sg.float() if st.sg is not None else zeros),
                    damping, lowrank_a=lr_a, lowrank_g=lr_g,
                )
                dot = torch.sum(pg * g)
            elif st.skron is not None:
                v1 = qg.mT @ g @ qa
                pg = qg @ (v1 / (st.skron + damping)) @ qa.mT
                dot = torch.sum(pg * g)
            else:
                pg, clip = self._fused(name, st, g)
                dot = torch.sum(clip)
            pre[name] = pg
            (sharded if spec.sharded else replicated).append(
                (dot * lr2, dot))
        # [kl-clip sum, <g, pg>, |g|^2 of the other parameters]: the
        # replicated terms once, the sharded ones summed over the group.
        rep = self._vg_totals(replicated, self._uncovered[0])
        part = self._vg_totals(sharded, self._uncovered[1])
        if group_extent(self.shard_group) > 1:
            dist.all_reduce(part, group=self.shard_group)
        clip_sum, dots, squares = rep + part
        scale = None
        if kl_clip is not None:
            scale = ops.kl_clip_scale(clip_sum, kl_clip)
        for name, pg in pre.items():
            self.specs[name].set_grad(pg if scale is None else pg * scale)
        return (dots if scale is None else dots * scale) + squares

    def _vg_totals(self, layers: list, params: list) -> torch.Tensor:
        """``[sum of kl-clip terms, sum of <g, pg>, sum of |g|^2]`` of
        ``layers`` (``(term, dot)`` pairs) and ``params``."""
        out = torch.zeros(3, device=self.device)
        for term, dot in layers:
            out[0] += term
            out[1] += dot
        grads = [p.grad.reshape(-1).float() for p in params
                 if p.grad is not None]
        if grads:
            out[2] = torch.sum(torch.stack(torch._foreach_norm(grads)) ** 2)
        return out

    def _fused(self, name: str, st: StackState,
               g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The fused kernel on one layer's stack, zero-padded to
        multiples of 8 where ``g``'s sides are not (module docstring).
        The padded ``qa``, ``qg`` and ``dgda`` are cached per layer and
        rebuilt when the state holds other decompositions (a refresh or a
        restore installs new tensors)."""
        gp, ap = g.shape[-2:]
        pad_g, pad_a = -gp % 8, -ap % 8
        if not (pad_g or pad_a):
            return ops.fused_eigen_precondition(
                g, st.qa.float().contiguous(), st.qg.float().contiguous(),
                st.dgda.float().contiguous())
        key = (st.qa, st.qg, st.dgda)
        hit = self._padded.get(name)
        if hit is None or any(a is not b for a, b in zip(hit[0], key)):
            pad = torch.nn.functional.pad
            hit = (key, (
                pad(st.qa.float(), (0, pad_a, 0, pad_a)).contiguous(),
                pad(st.qg.float(), (0, pad_g, 0, pad_g)).contiguous(),
                pad(st.dgda.float(), (0, pad_a, 0, pad_g)).contiguous(),
            ))
            self._padded[name] = hit
        qa, qg, dgda = hit[1]
        g = torch.nn.functional.pad(g, (0, pad_a, 0, pad_g))
        pg, clip = ops.fused_eigen_precondition(g, qa, qg, dgda)
        return pg[..., :gp, :ap], clip

    def _ekfac_divergence(self) -> torch.Tensor | None:
        """JAX ``ekfac_divergence_info`` over the whole stacks: the
        sharded layers' sums all-reduced over the shard group."""
        if not self.ekfac:
            return None
        sums = torch.zeros(4, device=self.device)
        for name, st in self.layers.items():
            if st.skron is None or st.da is None:
                continue
            seed = st.dg.float()[..., :, None] * st.da.float()[..., None, :]
            drift = st.skron.float() - seed
            i = 2 if self.specs[name].sharded else 0
            sums[i] += torch.sum(drift * drift)
            sums[i + 1] += torch.sum(seed * seed)
        if group_extent(self.shard_group) > 1:
            part = sums[2:].clone()
            dist.all_reduce(part, group=self.shard_group)
            sums[2:] = part
        num, den = sums[0] + sums[2], sums[1] + sums[3]
        return torch.sqrt(num / (den + 1e-30))

    # -- checkpoints -----------------------------------------------------

    def _full(self, t: torch.Tensor, spec: StackSpec) -> torch.Tensor:
        """A local stack as a checkpoint holds it: gathered over the
        shard group, or without the stack dimension for a dense layer."""
        if spec.total == 0:
            return t[0]
        if spec.sharded and group_extent(self.shard_group) > 1:
            out = t.new_empty((group_extent(self.shard_group) * t.shape[0],
                               *t.shape[1:]))
            dist.all_gather_into_tensor(out, t.contiguous(),
                                        group=self.shard_group)
            return out
        return t

    def _local(self, t: torch.Tensor, spec: StackSpec) -> torch.Tensor:
        """Inverse of :meth:`_full` for this rank."""
        if spec.total == 0:
            return t[None]
        return t[spec.offset:spec.offset + spec.stack]

    def _checkpoint_layer_states(self) -> Mapping[str, Any]:
        # Collective across the shard group: every rank saves the JAX
        # payload, the whole stacks.
        return {
            name: StackState(self._full(st.a_factor, self.specs[name]),
                             self._full(st.g_factor, self.specs[name]))
            for name, st in sorted(self.layers.items())
        }

    def _restore_factors(self, layers: Mapping[str, Any]) -> None:
        for name, saved in layers.items():
            spec, st = self.specs[name], self.layers[name]
            st.a_factor = self._local(unpack_factor(
                saved['A'], self.factor_dtype, self.device), spec)
            st.g_factor = self._local(unpack_factor(
                saved['G'], self.factor_dtype, self.device), spec)

    def _symmetric_layers(self) -> set[str]:
        return set(self.layers)

    def _ekfac_scales(self) -> Mapping[str, torch.Tensor] | None:
        if not self.ekfac:
            return None
        return {name: self._full(st.skron, self.specs[name])
                for name, st in sorted(self.layers.items())
                if st.skron is not None} or None

    def _ekfac_scale_shapes(self) -> Mapping[str, tuple[int, ...]]:
        out = {}
        for name, spec in self.specs.items():
            lead = () if spec.total == 0 else (spec.total,)
            out[name] = (*lead, spec.dout, spec.din)
        return out

    def _with_ekfac_scales(self, scales: Mapping[str, Any]) -> None:
        for name, saved in scales.items():
            t = torch.as_tensor(saved).to(device=self.device,
                                          dtype=torch.float32)
            self.layers[name].skron = self._local(t, self.specs[name])

    # -- AdaptiveDamping's feed -----------------------------------------

    @torch.no_grad()
    def _loss_only(self, args: tuple, loss_args: tuple,
                   loss_fn: Callable[..., Any]) -> torch.Tensor:
        """The loss at the updated parameters on the step's batch (JAX
        ``_loss_only``: the flavour's plain forward), through the
        flavour's own forward (:meth:`_forward_loss`) with the capture
        disarmed, so no factor row, accumulator or hook records
        anything, and the buffers a training-mode forward moves restored
        bit for bit."""
        saved = [(b, b.clone()) for b in self._bn_buffers()]
        armed = self._armed
        self._arm_capture(False)
        try:
            loss = self._forward_loss(args, loss_args, loss_fn)
        finally:
            self._arm_capture(armed)
            for b, v in saved:
                b.copy_(v)
        return loss.detach()

    def _adapt_inputs(self, losses: torch.Tensor,
                      vg_sum: torch.Tensor) -> tuple[float, float, float]:
        """Every rank already holds the global losses (averaged over the
        data group; the pipe's broadcast from its last stage) and the
        whole ``vg_sum`` (the sharded terms summed over the shard group),
        so rank 0's three values are broadcast over the world: every
        rank feeds the controller the same bits."""
        values = torch.cat([losses.float(), vg_sum.float().reshape(1)])
        if dist.is_available() and dist.is_initialized() and (
                dist.get_world_size() > 1):
            dist.broadcast(values, 0)
        before, after, vg = values.tolist()
        return before, after, vg

    def _bn_buffers(self) -> list[torch.Tensor]:
        norm = torch.nn.modules.batchnorm._NormBase
        return [b for m in self.model.modules()
                if isinstance(m, norm) for b in m.buffers(recurse=False)]

    # -- engine hooks: the model, and no health guardrails ---------------

    def _arm_capture(self, on: bool) -> None:
        self._armed = on

    def _capture_module(self) -> torch.nn.Module:
        return self.model

    def _health_config(self) -> Any:
        return None

    def _health_state(self) -> Any:
        return None
