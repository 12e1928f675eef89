"""K-FAC preconditioner core, on one device or data-parallel.

Port of the bucketed path of ``BaseKFACPreconditioner``
(``kfac_pytorch_tpu/base_preconditioner.py``): registration through
:class:`~kfac_pytorch_tpu_torch.capture.ModelCapture`, per-layer factor
EMAs, the bucketed second-order stage on the KAISA grid (eigen,
inverse or iterative), the write-back of the preconditioned gradients
into each layer's ``.grad``, and the checkpoint hooks of the engine.
State lives on the device of the model's parameters.

Layers with a diagonal A factor (embeddings) sit outside the bucket
stacks, as in ``base_preconditioner.py:683-821`` of the JAX package:
every rank refreshes and preconditions them itself (a real ``eigh`` or
inverse of G, a snapshot of the ``[V]`` diagonal), their factors ride
the same factor all-reduce, and their kl-clip terms join the one global
sum after the buckets'.  A tied embedding's factors are the mean of the
lookup's and the attend call's contributions, the attend's with the
roles swapped.

Across ranks the world is the default ``torch.distributed`` group (or
the data group of :class:`~kfac_pytorch_tpu_torch.gpt.\
GPTKFACPreconditioner`: ``grid.group``), and
every rank is assumed to differentiate the mean loss of its own local
batch, as under ``DistributedDataParallel``.  Its captured output
gradients are then ``world`` times those of the global batch's mean
loss, so the G side is scaled by ``1 / world`` (as ``1 / world^2`` on
the factor, which is quadratic in the gradients); the
factors of every rank are then averaged before the EMA, which gives the
global batch's factors when the local batches have equal size (checked
on every factor update).

Gradient accumulation (``accumulation_steps = N > 1``) follows the
original torch library's idiom: the caller runs N forward/backward
passes, each loss divided by N (under ``model.no_sync()`` for all but
the last when wrapped in DDP), then calls :meth:`~kfac_pytorch_tpu_torch.
engine.KFACEngineMixin.step` once, which is the JAX ``finalize``
(``kfac_pytorch_tpu/engine.py:2250``).  Each finished micro-batch's
factor contributions are folded into per-layer sums
(:class:`~kfac_pytorch_tpu_torch.state.AccumState`) at the next
forward, so no micro-batch's activations outlive it; the step divides
each sum by its count, runs the factor all-reduce once on the averages
and leaves a layer with count 0 untouched (``engine.py:2374-2400``).
The output gradients the hooks see are those of the loss divided by N,
so the G side is scaled by N as well as by ``1 / world``.

EKFAC (``ekfac=True``) builds each call's A and G rows once, derives the
factors from them (``ops.cov_from_rows``, the same algebra) and projects
the rows in the current eigenbasis into the layer's ``[g_pad, a_pad]``
scale contribution, which is quadratic in the G rows and takes the G
side's scale; under accumulation each micro-batch is projected at its
fold, as ``_ekfac_accum_contribs`` (``base_preconditioner.py:1950``)
does.  The contributions ride the factor all-reduce, and the scale EMA
runs after the factor EMA and before the step's refresh, which reseeds
the scales (``_apply_ema``, ``base_preconditioner.py:1544``).

Under ``stagger_refresh=K`` the bucket slots are split into ``K`` LPT
shards (:func:`~kfac_pytorch_tpu_torch.parallel.bucketing.\
make_stagger_plan`) and a shard step re-decomposes one of them
(``BucketedSecondOrder.compute_shard``); the diagonal-A layers refresh
with shard 0 (``base_preconditioner.py:1663-1697``).  With ``adaptive``
every factor step feeds the controller the per-layer drift of
:func:`~kfac_pytorch_tpu_torch.adaptive.drift_info`.

``factor_comm='bf16_triu'`` reduces the factors of the row-statistics
layers (linear, conv2d) as bf16 packed upper triangles
(:func:`~kfac_pytorch_tpu_torch.parallel.collectives.\
all_reduce_sum_triu`); everything else rides the dense all-reduce.

``bucketed=False`` is the replicated engine (``base_preconditioner.py:
1310-1340, 1436-1481``): no bucket stacks; every rank decomposes and
preconditions every layer itself, the decompositions held in its
:class:`~kfac_pytorch_tpu_torch.state.LayerKFACState`, and a helper
with non-symmetric factors takes the general eig or an LU inverse.

``overlap_comm`` defers each due refresh but the bootstrap by one step:
the refresh is built from a snapshot of the factor references into new
bucket stacks and new diagonal-A fields on a side stream
(:mod:`~kfac_pytorch_tpu_torch.overlap`), and installed at the top of
the next step; ``pipeline_grads`` issues each bucket's gradient gather
as soon as the bucket is rotated (``BucketedSecondOrder.precondition``).
Both need the bucketed stage; ``overlap_comm`` excludes ``lowrank_rank``
and ``ekfac`` (JAX ``base_preconditioner.py:293-336``).

``health`` (:mod:`~kfac_pytorch_tpu_torch.health`) gates every factor
update on a finiteness verdict over the step's gradients (and the loss
on the fused path with one rank) and the factor means after the factor
all-reduce, the same tensors on every rank, so every rank reaches the
same verdict; a bad step leaves the EMAs bitwise, zeroes the gradients
before the precondition and counts the skip.  At refresh time a
non-finite EMA is reset to its identity seed, and the decompositions run
under bounded retries with fallback and quarantine
(``BucketedSecondOrder.compute``; a diagonal-A layer falls back to its
last good ``G`` decomposition, or to the identity).  ``consistency``
(:mod:`~kfac_pytorch_tpu_torch.consistency`) digests and compares the
replicated state at its cadence (the engine walks the ladder), and the
trajectory watchdog (:mod:`~kfac_pytorch_tpu_torch.watchdog`) parks the
model through the same quarantine masks.
"""
from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from kfac_pytorch_tpu_torch import adaptive as adaptive_lib
from kfac_pytorch_tpu_torch import consistency as consistency_lib
from kfac_pytorch_tpu_torch import health as health_lib
from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.engine import KFACEngineMixin
from kfac_pytorch_tpu_torch.engine import unpack_factor
from kfac_pytorch_tpu_torch.engine import validate_adaptive
from kfac_pytorch_tpu_torch.enums import ComputeMethod
from kfac_pytorch_tpu_torch.overlap import DeferredRefresh
from kfac_pytorch_tpu_torch.parallel import collectives
from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan
from kfac_pytorch_tpu_torch.parallel.bucketing import make_stagger_plan
from kfac_pytorch_tpu_torch.parallel.mesh import kaisa_grid
from kfac_pytorch_tpu_torch.parallel.second_order import BucketedSecondOrder
from kfac_pytorch_tpu_torch.scheduler import AdaptiveRefreshController
from kfac_pytorch_tpu_torch.state import AccumState
from kfac_pytorch_tpu_torch.state import LayerKFACState
from kfac_pytorch_tpu_torch.state import init_layer_state

logger = logging.getLogger(__name__)


def validate_overlap(
    overlap_comm: bool,
    pipeline_grads: bool,
    *,
    bucketed: bool,
    lowrank_rank: int | None,
    ekfac: bool,
) -> None:
    """The JAX engine's checks of ``overlap_comm`` and ``pipeline_grads``
    (``base_preconditioner.py:293-336``; ``health`` is checked by the
    front end, which holds it)."""
    if overlap_comm:
        if not bucketed:
            raise ValueError(
                'overlap_comm requires the bucketed second-order '
                'stage (the deferred refresh is the bucket-stack '
                'program)',
            )
        if lowrank_rank is not None:
            raise ValueError(
                'overlap_comm and lowrank_rank are mutually '
                'exclusive: the randomized sketch draw is keyed to '
                'the refresh step, which deferral would shift',
            )
        if ekfac:
            raise ValueError(
                'overlap_comm and ekfac are mutually exclusive: the '
                'EKFAC scale re-seed must stay atomic with the EMA '
                'projection of the step that triggered the refresh',
            )
    if pipeline_grads and not bucketed:
        raise ValueError(
            'pipeline_grads requires the bucketed second-order '
            'stage (the pipelined tail is bucket-granular by '
            'construction) — drop bucketed=False or pipeline_grads',
        )


def compressed_layers(helpers: Any, factor_comm: str | None) -> frozenset:
    """The layers whose factors ``factor_comm`` compresses: the linear
    and conv2d layers (JAX ``base_preconditioner.py:886-911``)."""
    return frozenset(
        name for name, h in helpers.items()
        if factor_comm is not None and h.supports_ekfac
        and h.symmetric_factors and not h.diagonal_a
    )


class BaseKFACPreconditioner(KFACEngineMixin):
    """K-FAC over the layers a :class:`ModelCapture` registered.

    Attributes:
        layers: layer name -> :class:`LayerKFACState` (the factor EMAs).
        grid: this rank's place on the KAISA grid
            (:class:`~kfac_pytorch_tpu_torch.parallel.mesh.KaisaGrid`).
        plan: the bucket plan, with ``grid.cols`` columns (``None`` on
            the replicated engine).
        buckets: bucket key -> this rank's stacked decompositions
            (:class:`~kfac_pytorch_tpu_torch.parallel.second_order.\
BucketSecond`; empty on the replicated engine).
        stagger: the :class:`~kfac_pytorch_tpu_torch.parallel.bucketing.\
StaggerPlan` of ``stagger_refresh`` (``None`` without).
        last_kl_scale: the kl-clip scale applied by the latest step
            (a device scalar), or ``None`` with ``kl_clip=None``.
        accumulation_steps: forward/backward passes per :meth:`step`.
    """

    def __init__(
        self,
        capture: ModelCapture,
        *,
        factor_update_steps,
        inv_update_steps,
        damping,
        factor_decay,
        kl_clip,
        lr,
        accumulation_steps: int = 1,
        factor_dtype: torch.dtype = torch.float32,
        inv_dtype: torch.dtype = torch.float32,
        precond_dtype: torch.dtype = torch.float32,
        cov_dtype: torch.dtype | None = None,
        grad_worker_fraction: float = 1.0,
        compute_method: ComputeMethod = ComputeMethod.EIGEN,
        prediv_eigenvalues: bool = True,
        iterative_config: ops.IterativeConfig | None = None,
        lowrank_rank: int | None = None,
        lowrank_oversample: int = 32,
        lowrank_power_iters: int = 2,
        ekfac: bool = False,
        adaptive_refresh: Any = None,
        bucketed: bool = True,
        stagger_refresh: int | None = None,
        adaptive: Any = None,
        factor_comm: str | None = None,
        overlap_comm: bool = False,
        pipeline_grads: bool = False,
        health: health_lib.HealthConfig | None = None,
        consistency: consistency_lib.ConsistencyConfig | None = None,
        watchdog: Any = None,
        observe: Any = None,
        flight: Any = None,
        compile_budget: int | None = None,
        loglevel: int = logging.DEBUG,
    ) -> None:
        if accumulation_steps < 1:
            raise ValueError('accumulation_steps must be >= 1')
        validate_adaptive(adaptive, stagger_refresh, adaptive_refresh)
        validate_overlap(overlap_comm, pipeline_grads, bucketed=bucketed,
                         lowrank_rank=lowrank_rank, ekfac=ekfac)
        self.bucketed = bool(bucketed)
        self.factor_comm = factor_comm
        if ekfac:
            for name, helper in capture.helpers.items():
                if not helper.supports_ekfac:
                    raise ValueError(
                        f'ekfac: layer {name!r} ({type(helper).__name__}) '
                        'has no EKFAC row statistics (supported: linear, '
                        'conv2d)',
                    )
        self.ekfac = bool(ekfac)
        self.lowrank_rank = lowrank_rank
        self._capture = capture
        self.accumulation_steps = int(accumulation_steps)
        self._accum: dict[str, AccumState] = {}
        if self.accumulation_steps > 1:
            capture.fold = self._fold_captures
        self.compute_method = compute_method
        self.factor_dtype = factor_dtype
        self.inv_dtype = inv_dtype
        self.precond_dtype = precond_dtype
        self.cov_dtype = factor_dtype if cov_dtype is None else cov_dtype
        params = list(capture.model.parameters())
        self.device = params[0].device if params else torch.device('cpu')
        self.helpers = capture.helpers
        for name, helper in self.helpers.items():
            logger.log(loglevel, f'Registered name="{name}": {helper!r}')
        for base, (head, helper) in capture.attend.items():
            logger.log(
                loglevel,
                f'Registered name="{head}" as the attend call of the tied '
                f'embedding "{base}": {helper!r}',
            )
        for name in capture.skipped:
            logger.log(loglevel, f'Skipped name="{name}" (skip_layers)')
        for name, reason in capture.rejected.items():
            logger.log(loglevel, f'Rejected name="{name}": {reason}')
        logger.log(
            loglevel,
            f'Registration summary: {len(self.helpers)} registered, '
            f'{len(capture.skipped)} skipped, {len(capture.rejected)} '
            'rejected',
        )
        cov_rep = capture.coverage
        logger.log(
            loglevel,
            'Coverage: %.2f%% of parameters preconditioned (%d/%d '
            'elements); uncovered: %s',
            100.0 * cov_rep['param_fraction'], cov_rep['params_covered'],
            cov_rep['params_total'], cov_rep['uncovered'] or 'none',
        )
        self.layers: dict[str, LayerKFACState] = {
            name: init_layer_state(
                h.a_factor_shape[0], h.g_factor_shape[0],
                factor_dtype=factor_dtype, device=self.device,
                diag_a=h.diagonal_a,
            )
            for name, h in self.helpers.items()
        }
        # Sorted: the order of their kl-clip terms in the global sum.
        self.diag_layers = tuple(sorted(
            name for name, h in self.helpers.items() if h.diagonal_a
        ))
        self.prediv_eigenvalues = bool(prediv_eigenvalues)
        # Non-symmetric custom helpers (the general-eig escape hatch)
        # need the replicated engine; a diagonal-A layer's side path
        # takes the general decomposition itself.
        asym = sorted(
            name for name, h in self.helpers.items()
            if not h.symmetric_factors and not h.diagonal_a
        )
        if asym and self.bucketed:
            raise ValueError(
                f'layers {asym} have non-symmetric factors; the bucketed '
                'engine batches symmetric eigh: use bucketed=False for '
                'the general-eig escape hatch',
            )
        self._compressed = compressed_layers(self.helpers, factor_comm)
        self.grid = self._make_grid(grad_worker_fraction)
        self.plan = None
        self._second_order = None
        self.stagger = None
        self.iterative_config = iterative_config
        self.buckets = {}
        controller = None
        if self.bucketed:
            self.plan = make_bucket_plan(
                {n: h for n, h in self.helpers.items() if not h.diagonal_a},
                n_cols=self.grid.cols,
            )
            if stagger_refresh is not None:
                self.stagger = make_stagger_plan(self.plan, stagger_refresh)
            self._second_order = BucketedSecondOrder(
                self.plan, compute_method=compute_method,
                prediv_eigenvalues=prediv_eigenvalues,
                iterative_config=iterative_config, inv_dtype=inv_dtype,
                precond_dtype=precond_dtype, device=self.device,
                grid=self.grid,
                slot_dims={
                    n: (h.a_factor_shape[0], h.g_factor_shape[0])
                    for n, h in self.helpers.items()
                },
                lowrank_rank=lowrank_rank,
                lowrank_oversample=lowrank_oversample,
                lowrank_power_iters=lowrank_power_iters, ekfac=ekfac,
                stagger=self.stagger, pipeline_grads=pipeline_grads,
                health=health,
                # The consistency guard's and the watchdog's quarantine.
                quarantine_masks=(consistency is not None
                                  or watchdog is not None),
            )
            self.iterative_config = self._second_order.iterative
            self.buckets = self._second_order.init_buckets()
            if adaptive is not None:
                controller = self._adaptive_controller_for(adaptive)
        self.last_kl_scale: torch.Tensor | None = None
        #: The health knobs (``None``: the guardrails are off) and their
        #: device counters.
        self.health = health
        self._health = (health_lib.init_health_state(self.device)
                        if health is not None else None)
        # The fused path's forward module (the front end puts a
        # DistributedDataParallel wrapper here), and the parameters
        # outside every registered layer, which join vg_sum as |g|^2.
        self._train_module = capture.model
        uncovered = set(cov_rep['uncovered'])
        self._uncovered_params = [
            p for n, p in capture.model.named_parameters() if n in uncovered
        ]
        self._init_engine(
            factor_update_steps=factor_update_steps,
            inv_update_steps=inv_update_steps,
            damping=damping,
            factor_decay=factor_decay,
            kl_clip=kl_clip,
            lr=lr,
            adaptive_refresh=adaptive_refresh,
            stagger_refresh=stagger_refresh,
            adaptive_controller=controller,
            overlap_comm=overlap_comm,
            consistency=consistency,
            watchdog=watchdog,
            observe=observe,
            flight=flight,
            compile_budget=compile_budget,
        )
        if self._second_order is not None:
            self._second_order.annotate = self._annotate()
        # The side stream of the deferred refresh, made at its first use.
        self._side_stream = None

    def _adaptive_controller_for(self, config) -> AdaptiveRefreshController:
        """The drift-adaptive controller of the stagger plan (JAX
        ``_install_adaptive_controller``): each shard's layers are its
        slots' (padding dropped), the diagonal-A layers ride shard 0,
        and the rows are ``sorted(self.helpers)``, the order of
        :func:`~kfac_pytorch_tpu_torch.adaptive.drift_info`."""
        shard_layers = []
        for k, shard in enumerate(self.stagger.shards):
            names = [
                self.plan.bucket(key).slots[i]
                for key, slots in shard.items() for i in slots
                if self.plan.bucket(key).slots[i] is not None
            ]
            if k == 0:
                names.extend(self.diag_layers)
            shard_layers.append(tuple(sorted(set(names))))
        return AdaptiveRefreshController(
            config, layer_names=tuple(sorted(self.helpers)),
            shard_layers=shard_layers,
        )

    def _make_grid(self, grad_worker_fraction: float):
        """The KAISA grid over the default process group (a flavour
        with a data group builds it over that)."""
        return kaisa_grid(grad_worker_fraction)

    def __repr__(self) -> str:
        return '\n'.join([
            f'{type(self).__name__}(',
            f'  steps={self._steps},',
            f'  layers={list(self.helpers)},',
            f'  grid={self.grid.rows}x{self.grid.cols},',
            f'  factor_update_steps={self._factor_update_steps},',
            f'  inv_update_steps={self._inv_update_steps},',
            ')',
        ])

    def _arm_capture(self, on: bool) -> None:
        self._capture.armed = on
        if not on:
            self._capture.clear()

    def _capture_armed(self, on: bool) -> bool:
        """Switch the capture hooks without dropping what they hold;
        returns the previous switch."""
        was, self._capture.armed = self._capture.armed, on
        return was

    def _capture_module(self) -> torch.nn.Module:
        return self._capture.model

    def _bn_buffers(self) -> list[torch.Tensor]:
        """The buffers of the model's batch-norm modules (running
        statistics, batch counters), which a training-mode forward
        moves."""
        norm = torch.nn.modules.batchnorm._NormBase
        return [b for m in self._capture.model.modules()
                if isinstance(m, norm) for b in m.buffers(recurse=False)]

    def reset_batch(self) -> None:
        """Drop the micro-batch sums and any held captures (JAX
        ``reset_batch``, ``kfac_pytorch_tpu/engine.py:2472``)."""
        self._capture.clear()
        self._accum = {}

    @torch.no_grad()
    def _fold_captures(self) -> None:
        """Fold the captured forward/backward pass into the micro-batch
        sums, one contribution per layer.

        A module applied several times contributes the mean of its
        per-call factors, and a tied embedding the mean over its lookup
        and attend calls (the attend's A from its output gradients, its
        G from its inputs).  Float captures are cast to ``cov_dtype``
        before the covariance, integer token ids never; factors are kept
        in ``factor_dtype``.  The output-gradient side is scaled by
        ``(accumulation_steps / world)^2``: every factor is quadratic in
        the output gradients, so this equals scaling the gradients by
        ``accumulation_steps / world`` without copying them.  Under
        EKFAC the layer's scale contribution is folded too
        (:meth:`_ekfac_fold`).
        """
        device_type = self.device.type
        with torch.autocast(device_type, enabled=False):
            captured = self._capture.take()
            scale = (self.accumulation_steps / self.grid.world) ** 2
            for name in self.helpers:
                if self.ekfac:
                    self._ekfac_fold(name, captured[name], scale)
                    continue
                a_list, g_list, n_rows = [], [], 0
                for helper, acts, grads in captured[name]:
                    a_src, g_src = ((grads, acts) if helper.swap_capture
                                    else (acts, grads))
                    a_f = [
                        helper.get_a_factor(self._cov_input(a, helper))
                        .to(self.factor_dtype) for a in a_src
                    ]
                    g_f = [
                        helper.get_g_factor(g.to(self.cov_dtype))
                        .to(self.factor_dtype) for g in g_src
                    ]
                    if scale != 1:
                        # The attend call's A comes from its output
                        # gradients, every other role's G does.
                        if helper.swap_capture:
                            a_f = [f * scale for f in a_f]
                        else:
                            g_f = [f * scale for f in g_f]
                    a_list += a_f
                    g_list += g_f
                    n_rows += sum(a.shape[0] for a in acts)
                self._accum.setdefault(name, AccumState()).add(
                    torch.stack(a_list).mean(0),
                    torch.stack(g_list).mean(0), n_rows,
                )

    def _ekfac_fold(self, name: str, roles, scale: float) -> None:
        """:meth:`_fold_captures` of one EKFAC layer: each call's rows
        once, the factors from them, and the scale contribution in the
        slot's current basis (``BucketedSecondOrder.ekfac_contrib``),
        the G factor and the scales times ``scale``."""
        a_list, g_list, calls, n_rows = [], [], [], 0
        for helper, acts, grads in roles:
            for a, g in zip(acts, grads):
                a_rows, a_norm = helper.get_a_rows(self._cov_input(a, helper))
                g_rows, g_norm = helper.get_g_rows(g.to(self.cov_dtype))
                a_list.append(ops.cov_from_rows(a_rows, a_norm)
                              .to(self.factor_dtype))
                g_list.append(ops.cov_from_rows(g_rows, g_norm)
                              .to(self.factor_dtype))
                calls.append((a_rows, g_rows, a_norm, g_norm))
                n_rows += a.shape[0]
        key, _ = self.plan.slot_of[name]
        contrib = self._second_order.ekfac_contrib(
            self.buckets[key], name, calls,
        )
        g_new = torch.stack(g_list).mean(0)
        if scale != 1:
            g_new = g_new * scale
            contrib = contrib * scale
        self._accum.setdefault(name, AccumState()).add(
            torch.stack(a_list).mean(0), g_new, n_rows, contrib,
        )

    @torch.no_grad()
    def _update_factors(
        self, first_update: bool, loss: torch.Tensor | None = None,
    ) -> torch.Tensor | None:
        """Fold the step's statistics into the factor EMAs: the last
        captured pass first, then each layer's mean over its
        micro-batches.  Across ranks the means are averaged over the
        world (one fused all-reduce, once per step), and every rank
        checks that the local batches, counted over every micro-batch,
        were equal.  A layer with no micro-batch (count 0, e.g. after
        :meth:`reset_batch`) keeps its EMA.  Under EKFAC the layers'
        mean scale contributions ride the same all-reduce, and the scale
        EMA follows the factor EMA (a count of 0 keeps the scales).

        Under health the step's verdict (:meth:`_health_verdict` over the
        gradients, ``loss`` and the averaged contributions) gates every
        EMA with ``torch.where`` (a bad step leaves them bitwise), the
        identity seed is chosen on the device from
        ``factor_updates_applied``, and the verdict is returned (``None``
        without health).
        """
        if self.accumulation_steps == 1 or self._capture.pending():
            self._fold_captures()
        accum, self._accum = self._accum, {}
        decay = self.factor_decay
        world = self.grid.world
        new_a, new_g, new_s, rows, counts = [], [], [], [], []
        for name in self.helpers:
            st = self.layers[name]
            acc = accum.get(name, AccumState())
            new_a.append(self._mean(acc.a_batch, acc.a_count, st.a_factor))
            new_g.append(self._mean(acc.g_batch, acc.g_count, st.g_factor))
            rows.append(acc.rows)
            counts.append((acc.a_count, acc.g_count))
            if self.ekfac:
                key, _ = self.plan.slot_of[name]
                like = self.buckets[key].skron[0]
                new_s.append(self._mean(acc.s_batch, acc.s_count, like))
                counts[-1] += (acc.s_count,)
        if world > 1:
            # The row counts and their squares ride in the all-reduce
            # (f64: exact sums), so every rank reaches the same verdict:
            # world * sum(r^2) == sum(r)^2 iff every rank's r is equal.
            # So do the micro-batch counts, which decide the zero-count
            # guard the same way on every rank.
            flat = [c for pair in counts for c in pair]
            # f64 on purpose: exact integer sums (only with world > 1).
            stats = torch.tensor(  # torchlint: allow(f64-promotion)
                rows + [r * r for r in rows] + flat, dtype=torch.float64,
                device=self.device,
            )
            n = len(rows)
            comp = [i for i, name in enumerate(self.helpers)
                    if name in self._compressed]
            if comp:
                # factor_comm: each rank's share of the mean, summed as
                # bf16 packed triangles.  Dividing by a power-of-two
                # world is exact, so each share's bf16 value is the one
                # a JAX shard gets from contracting its local rows at
                # the global scale.
                packed = collectives.all_reduce_sum_triu(
                    [new_a[i] / world for i in comp]
                    + [new_g[i] / world for i in comp],
                    group=self.grid.group,
                )
                for j, i in enumerate(comp):
                    new_a[i] = packed[j].to(new_a[i].dtype)
                    new_g[i] = packed[len(comp) + j].to(new_g[i].dtype)
            dense = [i for i in range(n) if i not in comp]
            *factors, stats = collectives.all_reduce_mean(
                [new_a[i] for i in dense] + [new_g[i] for i in dense]
                + new_s + [stats], self.grid.group,
            )
            # The cross-rank batch check: one read of the summed counts a
            # factor step across ranks (JAX checks them in its program).
            sums = [round(v * world)
                    for v in stats.tolist()]  # torchlint: allow(host-sync)
            if any(world * s2 != s1 * s1
                   for s1, s2 in zip(sums[:n], sums[n:2 * n])):
                raise RuntimeError(
                    'local batch sizes differ across ranks (this rank: '
                    f'{rows}, sum over ranks: {sums[:n]}); K-FAC across '
                    'ranks needs equal local batches',
                )
            k = len(counts[0])
            m = len(dense)
            for j, i in enumerate(dense):
                new_a[i], new_g[i] = factors[j], factors[m + j]
            new_s = factors[2 * m:]
            counts = [tuple(sums[2 * n + i * k:2 * n + (i + 1) * k])
                      for i in range(n)]
        ok = None
        if self.health is not None:
            h = self._health
            ok = self._health_verdict(loss, [new_a, new_g, new_s])
            first_update = h.factor_updates_applied == 0
            h.factor_updates_applied = (
                h.factor_updates_applied + ok.to(torch.int32))

        def ema(old, new):
            out = ops.ema_update_factor(old, new, decay, first_update)
            return out if ok is None else torch.where(ok, out, old)

        for name, a_new, g_new, (a_count, g_count, *_) in zip(
            self.helpers, new_a, new_g, counts,
        ):
            st = self.layers[name]
            if a_count > 0:
                st.a_factor = ema(st.a_factor, a_new)
            if g_count > 0:
                st.g_factor = ema(st.g_factor, g_new)
        if self.ekfac:
            self._second_order.ekfac_update(self.buckets, {
                name: s_new for name, s_new, c in zip(
                    self.helpers, new_s, counts) if c[2] > 0
            }, decay, **({} if ok is None else {'ok': ok}))
        return ok

    def _param_grads(self) -> list[torch.Tensor]:
        """The gradients of every parameter of the model that has one."""
        return [p.grad for p in self._capture.model.parameters()
                if p.grad is not None]

    def _health_verdict(
        self, loss: torch.Tensor | None, extra: Any = (),
    ) -> torch.Tensor:
        """The step's finiteness verdict (a 0-d bool on the device, one
        fused reduction: :func:`~kfac_pytorch_tpu_torch.health.\
tree_all_finite`) over the gradients, ``extra`` (the averaged factor
        contributions on factor steps) and the loss.  Across ranks the
        gradients and the contributions are the same on every rank (DDP's
        all-reduce and the factor all-reduce carry a bad local batch to
        all of them), so the verdict is too; the loss is local, so it
        joins the verdict on one rank only."""
        tree = [self._param_grads(), extra]
        if loss is not None and self.grid.world == 1:
            tree.append(loss)
        return health_lib.tree_all_finite(tree, device=self.device)

    @staticmethod
    def _mean(total, count: int, like: torch.Tensor) -> torch.Tensor:
        """A micro-batch sum over its count; zeros of ``like``'s shape
        for a count of 0 (so every rank all-reduces the same tensors)."""
        if count == 0:
            return torch.zeros_like(like)
        return total if count == 1 else total / count

    def _cov_input(self, x: torch.Tensor, helper) -> torch.Tensor:
        """A capture as the A-side covariance input: integer token ids
        as they are; the attend call's output gradients as they are when
        ``cov_dtype`` is no narrower (the widening is exact, and
        :func:`~kfac_pytorch_tpu_torch.ops.attend_a_diag` widens them
        chunk by chunk instead of copying the ``[B, T, V]`` tensor);
        anything else cast to ``cov_dtype``."""
        if not x.is_floating_point():
            return x
        if (helper.swap_capture
                and x.dtype.itemsize <= self.cov_dtype.itemsize):
            return x
        return x.to(self.cov_dtype)

    @torch.no_grad()
    def _refresh(self, damping: float) -> None:
        """Recompute the second-order state: the diagonal-A layers' own,
        then the buckets'; the iterative method warm-starts from the
        current roots, and low-rank buckets draw their sketches for the
        inverse-update step ``_last_inv_step``.  The replicated engine
        decomposes every layer in turn instead."""
        if not self.bucketed:
            self._refresh_replicated(damping)
            return
        args = (self.layers, self.buckets, damping, None,
                self._refresh_needs_bootstrap(), self._last_inv_step)
        if self.health is None:
            self._install_refresh(self._refresh_state(*args))
            return
        self._sanitize_factor_emas()
        stats = {}
        self._install_refresh(self._refresh_state(*args, health_stats=stats))
        h = self._health
        h.eigh_retries = h.eigh_retries + stats['retries']
        h.eigh_fallbacks = h.eigh_fallbacks + stats['fallbacks']
        # The current count (a successful refresh lifts a quarantine),
        # not a tally.
        h.quarantined_layers = stats['quarantined']
        self._health_host_syncs += stats.get('host_reads', 0)

    def _sanitize_factor_emas(self) -> None:
        """Factor self-healing at refresh time (JAX
        ``_sanitize_factor_emas``, ``base_preconditioner.py:1039-1081``):
        a non-finite EMA (a poisoned restore, f32 overflow) is reset to
        its identity seed (ones for a diagonal A) and counted in
        ``factor_resets``.  One fused verdict over every factor and one
        host read of it (counted), the refresh being a host sync point
        anyway; the EMAs are the same on every rank, so is the reset."""
        factors = [t for st in self.layers.values()
                   for t in (st.a_factor, st.g_factor)]
        norms = torch.stack(torch._foreach_norm(factors, ord=float('inf')))
        # The reset verdict's one read a refresh (counted).
        finite = torch.isfinite(norms)
        bad = (~finite).cpu().tolist()  # torchlint: allow(host-sync)
        self._health_host_syncs += 1
        resets = 0
        for i, (name, st) in enumerate(self.layers.items()):
            for side, flag in zip(('a', 'g'), bad[2 * i:2 * i + 2]):
                if not flag:
                    continue
                f = getattr(st, f'{side}_factor')
                seed = (torch.ones_like(f) if f.ndim == 1 else torch.eye(
                    f.shape[-1], dtype=f.dtype, device=f.device))
                setattr(st, f'{side}_factor', seed)
                resets += 1
        if resets:
            self._health.factor_resets = self._health.factor_resets + resets

    @torch.no_grad()
    def _refresh_shard(self, damping: float, shard: int) -> None:
        """Re-decompose one stagger shard's slots; the diagonal-A layers
        ride shard 0, so they keep the once-per-interval staleness of
        every slot."""
        self._install_refresh(self._refresh_state(
            self.layers, self.buckets, damping, shard,
        ))

    def _refresh_state(
        self,
        layers,
        prev,
        damping: float,
        shard: int | None = None,
        bootstrap: bool = False,
        sketch_step: int = 0,
        health_stats: dict | None = None,
        defer_gather: bool = False,
    ) -> tuple[dict, Any]:
        """``(diagonal-A fields by layer, bucket stacks)`` of a refresh
        from ``layers``' factor EMAs and the ``prev`` stacks (the
        monolithic refresh, or stagger shard ``shard``), built into new
        objects: nothing of ``self`` is read or written but the plan and
        the method.  Under health ``health_stats`` receives the refresh's
        counters (``BucketedSecondOrder.compute``), the diagonal-A
        layers' retries and fallbacks added.  With ``defer_gather`` the
        stacks are a :class:`~kfac_pytorch_tpu_torch.parallel.\
second_order.PendingGather` whose call runs the column gather."""
        diag = {}
        guard = {} if health_stats is None else {
            'health_stats': health_stats}
        if shard is None or shard == 0:
            diag = {name: self._diag_fields(name, layers[name], damping,
                                            **guard)
                    for name in self.diag_layers}
        if shard is None:
            bucket_stats = {}
            buckets = self._second_order.compute(
                layers, damping, prev=prev, bootstrap=bootstrap,
                sketch_step=sketch_step, defer_gather=defer_gather,
                **({} if health_stats is None else {
                    'health_stats': bucket_stats}),
            )
            if health_stats is not None:
                for key in ('retries', 'fallbacks'):
                    bucket_stats[key] = (bucket_stats[key]
                                         + health_stats.get(key, 0))
                bucket_stats['host_reads'] = (
                    bucket_stats.get('host_reads', 0)
                    + health_stats.get('host_reads', 0))
                health_stats.update(bucket_stats)
        else:
            buckets = self._second_order.compute_shard(
                layers, damping, shard, prev, defer_gather=defer_gather,
            )
        return diag, buckets

    def _install_refresh(self, state: tuple[dict, dict]) -> None:
        """Install a :meth:`_refresh_state`: the diagonal-A layers'
        fields, then the bucket stacks."""
        diag, buckets = state
        for name, fields in diag.items():
            for field, t in fields.items():
                setattr(self.layers[name], field, t)
        self.buckets = buckets

    def _issue_deferred_refresh(
        self, pending: tuple, damping: float,
    ) -> DeferredRefresh:
        """Start the refresh ``pending`` (``('inv',)`` or ``('shard',
        k)``) off the step: the factor references and the current stacks
        are taken now (the factor update rebinds the EMAs, so the refresh
        reads the ones this step left), and the new state is built on a
        worker thread, on the side stream on CUDA.  A deferred monolithic
        refresh is never the bootstrap, so the iterative method runs it
        at warm depth.

        The worker decomposes this rank's shares only; the column gather
        runs in :meth:`DeferredRefresh.wait`, on the thread that collects
        (the main thread at the collect point), so every rank issues it
        at the same place in its own sequence of collectives (NCCL
        launches the kernels of different communicators in one order on
        every rank; from the worker it raced DDP's all-reduce)."""
        layers = {
            name: LayerKFACState(a_factor=st.a_factor, g_factor=st.g_factor)
            for name, st in self.layers.items()
        }
        shard = None if pending[0] == 'inv' else pending[1]
        args = (layers, self.buckets, damping, shard,
                self._refresh_needs_bootstrap(), self._last_inv_step)
        stream = None
        if self.device.type == 'cuda':
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(self.device)
            stream = self._side_stream
        name = ('overlap/refresh' if shard is None
                else f'overlap/refresh/shard{shard}')

        def run():
            with self._scope(name):
                # health_stats None (no health under overlap_comm), the
                # gather deferred to the collect point.
                return self._refresh_state(*args, None, True)

        def gather(state):
            diag, pending = state
            with self._scope(name):
                return diag, pending()

        return DeferredRefresh(run, self.device, stream, finish=gather)

    def _stagger_shard_empty(self, shard: int) -> bool:
        """Whether a stagger shard holds nothing to refresh (shard 0 is
        never empty while diagonal-A layers are registered)."""
        if self.stagger is None:
            return False
        if shard == 0 and self.diag_layers:
            return False
        return not self.stagger.shards[shard]

    def _adaptive_drift_emit(self) -> dict[str, torch.Tensor]:
        """The drift feed of every layer's factor-EMA state
        (:func:`~kfac_pytorch_tpu_torch.adaptive.drift_info`), one
        ``all_reduce(MAX)`` across ranks."""
        return adaptive_lib.drift_info(
            self.layers, self.buckets, self.plan.buckets, self.grid,
        )

    def _refresh_replicated(self, damping: float) -> None:
        """The replicated engine's refresh (JAX ``base_preconditioner.
        py:1310-1340``): per layer, eigen (``qa``/``qg`` and ``dgda``, or
        ``da``/``dg`` without prediv) or damped inverses; a helper with
        non-symmetric factors takes the general eig or an LU inverse."""
        for name, helper in self.helpers.items():
            if helper.diagonal_a:
                self._refresh_diag(name, damping)
                continue
            st = self.layers[name]
            sym = helper.symmetric_factors
            if self.compute_method == ComputeMethod.EIGEN:
                eig = (ops.compute_factor_eigen if sym
                       else ops.compute_factor_eig_general)
                st.qa, da = eig(st.a_factor, self.inv_dtype)
                st.qg, dg = eig(st.g_factor, self.inv_dtype)
                if self.prediv_eigenvalues:
                    st.dgda = ops.compute_dgda(dg, da, damping)
                else:
                    st.da, st.dg = da, dg
            else:
                inv = (ops.compute_factor_inv if sym
                       else ops.compute_factor_inv_general)
                st.a_inv = inv(st.a_factor, damping, self.inv_dtype)
                st.g_inv = inv(st.g_factor, damping, self.inv_dtype)

    def _refresh_diag(self, name: str, damping: float) -> None:
        """Refresh one diagonal-A layer's decompositions in place
        (:meth:`_diag_fields`)."""
        for field, t in self._diag_fields(
                name, self.layers[name], damping).items():
            setattr(self.layers[name], field, t)

    def _diag_fields(
        self, name: str, st: LayerKFACState, damping: float,
        health_stats: dict | None = None,
    ) -> dict[str, torch.Tensor]:
        """One diagonal-A layer's decompositions from ``st``'s factors:
        G by ``eigh`` (eigen) or a damped Cholesky inverse (inverse and
        iterative, as the JAX package does), the general eig or an LU
        inverse for a helper with non-symmetric factors; the ``[V]``
        diagonal is snapshotted (``da``, or ``a_inv = 1 / (a +
        damping)``), so until the next refresh the layer preconditions
        with it and not with the moving EMA.  Under health the G side
        runs :meth:`_diag_fields_guarded`."""
        if health_stats is not None:
            return self._diag_fields_guarded(name, st, damping,
                                             health_stats)
        sym = self.helpers[name].symmetric_factors
        if self.compute_method == ComputeMethod.EIGEN:
            eig = (ops.compute_factor_eigen if sym
                   else ops.compute_factor_eig_general)
            qg, dg = eig(st.g_factor, self.inv_dtype)
            return dict(qg=qg, dg=dg,
                        da=st.a_factor.to(self.inv_dtype, copy=True))
        inv = (ops.compute_factor_inv if sym
               else ops.compute_factor_inv_general)
        return dict(
            g_inv=inv(st.g_factor, damping, self.inv_dtype),
            a_inv=(1.0 / (st.a_factor.float() + damping)).to(self.inv_dtype),
        )

    def _diag_fields_guarded(
        self, name: str, st: LayerKFACState, damping: float, stats: dict,
    ) -> dict[str, torch.Tensor]:
        """:meth:`_diag_fields` under health (JAX ``refresh_diag_guarded``,
        ``base_preconditioner.py:1150-1270``): the G decomposition runs
        under bounded retries and falls back to the layer's last good one;
        with none (never refreshed, or a general eig sanitized to zeros)
        to the identity, so the layer keeps the per-column ``A`` scaling
        instead of freezing.  Targeted injection (``inject_eigh_layers``)
        speaks bucket coordinates and leaves these layers alone."""
        import dataclasses

        sym = self.helpers[name].symmetric_factors
        cfg = self.health
        if cfg.inject_eigh_layers is not None:
            cfg = dataclasses.replace(cfg, inject_eigh_failures=0)
        g = st.g_factor
        eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
        if self.compute_method == ComputeMethod.EIGEN:
            eig = (ops.compute_factor_eigen if sym
                   else ops.compute_factor_eig_general)

            def attempt(jitter):
                if jitter == 0.0:
                    q, d = eig(g, self.inv_dtype)
                else:
                    q, d = eig(g + jitter * eye, self.inv_dtype)
                    d = torch.clamp(d.float() - jitter, min=0.0).to(
                        self.inv_dtype)
                if not sym:
                    # The general eig sanitizes its failures to zeros; a
                    # zero Q is no eigenbasis, so it reads as a failure.
                    dead = torch.all(q == 0)
                    q = torch.where(dead, torch.full_like(q, float('nan')),
                                    q)
                    d = torch.where(dead, torch.full_like(d, float('nan')),
                                    d)
                return d, q

            (dg, qg), ok, r = health_lib.run_with_recovery(
                attempt, damping, cfg, stats=stats,
            )
            fb_q = torch.eye(qg.shape[-1], dtype=qg.dtype, device=qg.device)
            fb_d = torch.ones_like(dg)
            if st.qg is not None:
                dead = torch.all(st.qg == 0)
                fb_q = torch.where(dead, fb_q, st.qg)
                fb_d = torch.where(dead, fb_d, st.dg)
            fields = dict(qg=torch.where(ok, qg, fb_q),
                          dg=torch.where(ok, dg, fb_d),
                          da=st.a_factor.to(self.inv_dtype, copy=True))
        else:
            inv = (ops.compute_factor_inv if sym
                   else ops.compute_factor_inv_general)

            def attempt(jitter):
                d = damping if jitter == 0.0 else float(
                    np.float32(damping) + np.float32(jitter))
                return (inv(g, d, self.inv_dtype),)

            (g_inv,), ok, r = health_lib.run_with_recovery(
                attempt, damping, cfg, stats=stats,
            )
            fb = eye.to(g_inv.dtype)
            if st.g_inv is not None:
                fb = torch.where(torch.all(st.g_inv == 0), fb, st.g_inv)
            fields = dict(
                g_inv=torch.where(ok, g_inv, fb),
                a_inv=(1.0 / (st.a_factor.float() + damping)).to(
                    self.inv_dtype),
            )
        stats['retries'] = stats.get('retries', 0) + r
        stats['fallbacks'] = stats.get('fallbacks', 0) + (~ok).to(
            torch.int32)
        return fields

    def _refresh_needs_bootstrap(self) -> bool:
        """Whether the next refresh runs the iterative method's deep
        cold-capable depth: until the first refresh of a run, and after
        a restore without a recompute.  Always False for the other
        methods."""
        return (
            self.compute_method == ComputeMethod.ITERATIVE
            and not self._iter_bootstrapped
        )

    @torch.no_grad()
    def _precondition(
        self, damping: float, kl_clip: float | None, lr: float,
        step_ok: torch.Tensor | None = None,
        return_info: bool = False,
    ) -> Any:
        """Precondition every registered layer's ``.grad`` in place, and
        return ``vg_sum``: the f32 ``<raw grad, final grad>`` over every
        trainable parameter (JAX ``_tree_vdot``, ``engine.py:74-90``),
        each registered layer's taken on its combined gradient before
        the write-back, each other parameter's as ``|g|^2`` (its gradient
        is final as it is), the squares of one ``_foreach_norm`` over
        them all (a few launches for ResNet-50's 107 BatchNorm
        parameters, not one each); terms summed in one reduction,
        registered layers first.

        With the health verdict ``step_ok`` every gradient is zeroed
        before the precondition when it is False (JAX
        ``_health_finish_step``): the combined gradients and the other
        parameters' ``.grad``, one select per dtype
        (:func:`~kfac_pytorch_tpu_torch.health.zero_unless`), so a bad
        batch gives a zero update and ``vg_sum`` 0; bitwise unchanged
        when True.

        With ``return_info`` (the observe monitor) it returns ``(vg_sum,
        info)``, ``info`` the ``observe/*`` side statistics (JAX
        ``base_preconditioner.py:1384-1474`` and ``engine.py:1547``):
        ``observe/kl_nu``, the kl-clip scale the step applied (on the
        fused path the scale built from the kernel's ``clip[l]`` sums: no
        second reduction), and ``observe/grad_norm`` /
        ``observe/precond_grad_norm`` over every parameter's raw and
        final gradient (a registered layer's as its combined gradient)."""
        combined = {
            name: helper.get_grad() for name, helper in self.helpers.items()
        }
        if step_ok is not None:
            names = list(combined)
            combined = dict(zip(names, health_lib.zero_unless(
                step_ok, [combined[n] for n in names])))
            rest = [p.grad for p in self._uncovered_params
                    if p.grad is not None]
            if rest:
                torch._foreach_copy_(rest,
                                     health_lib.zero_unless(step_ok, rest))
        out, scale = self.precondition_combined(
            combined, damping, kl_clip, lr,
        )
        terms = [torch.vdot(combined[name].reshape(-1).float(),
                            out[name].reshape(-1).float())
                 for name in self.helpers]
        rest = [p.grad.reshape(-1).float() for p in self._uncovered_params
                if p.grad is not None]
        if rest:
            norms = torch.stack(torch._foreach_norm(rest))
            terms.append(torch.sum(norms * norms))
        info = {}
        if return_info:
            from kfac_pytorch_tpu_torch.observe import monitor

            rest = [p.grad for p in self._uncovered_params
                    if p.grad is not None]
            info = monitor.kl_nu_stat(scale)
            info.update(monitor.grad_stats(
                [combined[n] for n in self.helpers] + rest,
                [out[n] for n in self.helpers] + rest,
            ))
        for name, helper in self.helpers.items():
            helper.set_grad(out[name])
        self.last_kl_scale = scale
        vg_sum = (torch.stack(terms).sum() if terms
                  else torch.zeros((), device=self.device))
        return (vg_sum, info) if return_info else vg_sum

    def precondition_combined(
        self,
        combined: dict[str, torch.Tensor],
        damping: float,
        kl_clip: float | None,
        lr: float,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor | None]:
        """Preconditioned, kl-clip-scaled copies of the combined
        gradients ``{layer: [out, in(+1)]}`` from the current
        decompositions, and the scale (``None`` without kl-clip); no
        ``.grad`` is touched."""
        if not self.bucketed:
            return self._precondition_replicated(
                combined, damping, kl_clip, lr,
            )
        diag_pg, extra = {}, []
        for name in self.diag_layers:
            g = combined[name]
            pg = self._precondition_diag(self.layers[name], g, damping)
            diag_pg[name] = pg
            if kl_clip is not None:
                extra.append(ops.grad_scale_sum(pg, g, lr))
        out, scale = self._second_order.precondition(
            self.buckets,
            {n: g for n, g in combined.items() if n not in diag_pg},
            damping, kl_clip, lr, extra_clip_terms=extra,
        )
        for name, pg in diag_pg.items():
            out[name] = (pg if scale is None
                         else (pg.float() * scale).to(pg.dtype))
        return out, scale

    def _precondition_replicated(
        self,
        combined: dict[str, torch.Tensor],
        damping: float,
        kl_clip: float | None,
        lr: float,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor | None]:
        """The replicated engine's preconditioning (JAX
        ``base_preconditioner.py:1436-1481``): each layer by its own
        decompositions through the matmul chain (the fused kernel is a
        bucket-stack kernel and is not launched, as in JAX), the kl-clip
        terms summed in registration order."""
        out = {}
        for name, helper in self.helpers.items():
            st, g = self.layers[name], combined[name]
            if helper.diagonal_a:
                out[name] = self._precondition_diag(st, g, damping)
            elif self.compute_method == ComputeMethod.EIGEN:
                out[name] = ops.precondition_grad_eigen(
                    g, st.qa, st.qg, da=st.da, dg=st.dg, dgda=st.dgda,
                    damping=damping,
                )
            else:
                out[name] = ops.precondition_grad_inverse(
                    g, st.a_inv, st.g_inv,
                )
        if kl_clip is None:
            return out, None
        scale = ops.kl_clip_scale(
            [ops.grad_scale_sum(out[n], combined[n], lr) for n in out],
            kl_clip,
        )
        return {n: pg * scale for n, pg in out.items()}, scale

    def _precondition_diag(
        self, st: LayerKFACState, g: torch.Tensor, damping: float,
    ) -> torch.Tensor:
        """One diagonal-A layer's preconditioned gradient, from the
        refresh-time snapshot of its A diagonal."""
        if self.compute_method == ComputeMethod.EIGEN:
            return ops.precondition_grad_eigen_diag_a(
                g, st.da, st.qg, st.dg, damping,
            )
        return ops.precondition_grad_inverse_diag_a(g, st.a_inv, st.g_inv)

    def _checkpoint_layer_states(self) -> dict[str, LayerKFACState]:
        return self.layers

    def _layer_field_shapes(self, name: str) -> dict[str, tuple[int, ...]]:
        """The decompositions layer ``name`` keeps outside the bucket
        stacks, by shape (in ``inv_dtype``; a streaming checkpoint
        installs them as they are): a diagonal-A layer's ``qg``/``dg``/
        ``da`` (eigen) or ``g_inv``/``a_inv``; on the replicated engine
        every layer's ``qa``/``qg`` with ``dgda`` or ``da``/``dg``
        (eigen), or ``a_inv``/``g_inv``; none for a layer of the
        stacks."""
        st = self.layers[name]
        a, g = st.a_factor.shape[0], st.g_factor.shape[0]
        eigen = self.compute_method == ComputeMethod.EIGEN
        if self.helpers[name].diagonal_a:
            return ({'qg': (g, g), 'dg': (g,), 'da': (a,)} if eigen
                    else {'g_inv': (g, g), 'a_inv': (a,)})
        if self.bucketed:
            return {}
        if not eigen:
            return {'a_inv': (a, a), 'g_inv': (g, g)}
        if self.prediv_eigenvalues:
            return {'qa': (a, a), 'qg': (g, g), 'dgda': (g, a)}
        return {'qa': (a, a), 'qg': (g, g), 'da': (a,), 'dg': (g,)}

    def _health_config(self) -> health_lib.HealthConfig | None:
        return self.health

    def _health_state(self) -> health_lib.HealthState | None:
        return self._health

    def _consistency_check(
        self, hp: dict[str, float],
    ) -> consistency_lib.CheckResult:
        """Digest and compare every replicated surface: the layer states
        over the world, each bucket slot over its grid column
        (:func:`~kfac_pytorch_tpu_torch.consistency.check`, one
        all-gather, collective)."""
        return consistency_lib.check(
            self.layers, self.buckets, self.plan, hp, self.grid,
            include_hp=self._consistency.include_hyperparams,
        )

    def _consistency_repair(self, result: consistency_lib.CheckResult):
        """Broadcast the canonical replica of every divergent surface
        (collective); returns ``(layer mask, {bucket: [L] mask})``.

        A rank that preconditioned through the divergent state since the
        last check stepped differently, and this step's gradients were
        preconditioned through it too: the model's parameters and their
        gradients are voted on and repaired the same way
        (:func:`~kfac_pytorch_tpu_torch.consistency.repair_replicated`),
        so every rank takes the same optimizer step.  An optimizer's own
        state (momentum, moments) is not the guard's to repair."""
        masks = consistency_lib.repair_state(
            result, self.layers, self.buckets, self.plan, self.grid,
        )
        params = [p.detach() for p in self._capture.model.parameters()]
        grads = [p.grad.detach() for p in self._capture.model.parameters()
                 if p.grad is not None]
        consistency_lib.repair_replicated(params + grads)
        return masks

    def _consistency_quarantine(self, masks: dict) -> None:
        consistency_lib.apply_quarantine(self.buckets, masks, self.grid)

    def _symmetric_layers(self) -> set[str]:
        return {n for n, h in self.helpers.items() if h.symmetric_factors}

    def _ekfac_divergence(self) -> torch.Tensor | None:
        """The scale grids' drift from their refresh seed (a device
        scalar), ``None`` without EKFAC."""
        if not self.ekfac:
            return None
        return self._second_order.ekfac_divergence(self.buckets)

    def _ekfac_scales(self) -> dict[str, torch.Tensor] | None:
        """The scale grids by bucket key, every slot of the bucket
        (``[L, g, a]``), ``None`` without EKFAC.  On a grid with several
        columns each rank holds its column's, so the grids are gathered
        over the grid row: a collective every rank must call."""
        if not self.ekfac:
            return None
        keys = [b.key for b in self.plan.buckets
                if self.buckets[b.key].skron is not None]
        full = collectives.all_gather_stacks(
            [self.buckets[k].skron for k in keys], self.grid.row_group,
        )
        return dict(zip(keys, full)) or None

    def _ekfac_scale_shapes(self) -> dict[str, tuple[int, ...]]:
        """The shapes :meth:`_ekfac_scales` returns, without a
        collective."""
        if not self.ekfac:
            return {}
        return {b.key: (b.n_slots, b.g_pad, b.a_pad)
                for b in self.plan.buckets
                if self.buckets[b.key].skron is not None}

    def _with_ekfac_scales(self, scales) -> None:
        """Install saved scale grids (checked by the engine, every slot
        of each bucket) on ``self.device``: this rank's column of
        them."""
        for key, skron in scales.items():
            seg = self.plan.bucket(key).seg
            first = self.grid.col * seg
            self.buckets[key].skron = torch.as_tensor(skron)[
                first:first + seg
            ].to(device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def _restore_factors(self, layers) -> None:
        """Load checkpointed factor EMAs onto ``self.device`` in
        ``factor_dtype``.  A dense ``[V, V]`` A of a diagonal-A layer (a
        checkpoint from before the diagonal storage) loads through its
        diagonal, which is the whole factor."""
        for base, factors in layers.items():
            st = self.layers[base]
            a = unpack_factor(factors['A'], self.factor_dtype, self.device)
            if st.a_factor.ndim == 1 and a.ndim == 2:
                a = torch.diagonal(a).clone()
            st.a_factor = a
            st.g_factor = unpack_factor(
                factors['G'], self.factor_dtype, self.device,
            )

    def _topology_descriptor(self) -> str:
        """World and bucket layout, e.g. ``'world=4 grid=2x2
        buckets=[a576g64:10 slots, ...]'``, which a mismatched restore
        names; `` pod=<topology>`` follows under a topology."""
        if self.plan is None:
            buckets = 'replicated'
        else:
            buckets = ', '.join(
                f'{b.key}:{b.n_slots} slots' for b in self.plan.buckets
            )
        desc = (
            f'world={self.grid.world} grid={self.grid.rows}x'
            f'{self.grid.cols} buckets=[{buckets}]'
        )
        if self.topology is not None:
            desc += f' pod={self.topology}'
        return desc

    def memory_usage(self) -> dict[str, int]:
        """Bytes of K-FAC state on this rank: the factor EMAs, and this
        rank's slice of the stacked decompositions with the diagonal-A
        layers' own."""
        sizes = {
            'a_factors': sum(
                st.a_factor.numel() * st.a_factor.element_size()
                for st in self.layers.values()
            ),
            'g_factors': sum(
                st.g_factor.numel() * st.g_factor.element_size()
                for st in self.layers.values()
            ),
            'second_order': sum(
                t.numel() * t.element_size()
                for name in (self.diag_layers if self.bucketed
                             else self.layers)
                for t in self.layers[name].decompositions().values()
            ) + (self._second_order.memory_usage(self.buckets)
                 if self.bucketed else 0),
        }
        sizes['total'] = sum(sizes.values())
        return sizes

    def coverage_report(self) -> dict[str, Any]:
        """Structured preconditioned-parameter coverage of the model
        (:meth:`~kfac_pytorch_tpu_torch.capture.ModelCapture.\
_coverage_report`): registered / skipped / unsupported counters, the
        tied-head count, and the preconditioned-parameter fraction with
        every uncovered parameter named.  Registration runs when the
        preconditioner is built, so the report is never empty here."""
        return dict(self._capture.coverage)

    def _step_info_static(self) -> dict[str, torch.Tensor]:
        """The coverage report's headline numbers as ``observe/coverage/*``
        constants (JAX ``base_preconditioner.py:1779-1815``), only when
        the full-coverage helpers are registered.  The engine adds them
        only under ``observe`` (JAX adds them on every step of such a
        registration), so an unobserved step keeps its key set.  There is
        no ``observe/pallas_fallback`` key: the CUDA kernel never falls
        back."""
        cov_rep = self._capture.coverage
        if not (cov_rep and self._uses_coverage_helpers()):
            return {}
        return {
            'observe/coverage/registered': torch.tensor(
                cov_rep['registered'], dtype=torch.int32),
            'observe/coverage/skipped': torch.tensor(
                cov_rep['skipped'], dtype=torch.int32),
            'observe/coverage/unsupported': torch.tensor(
                cov_rep['unsupported'], dtype=torch.int32),
            'observe/coverage/tied': torch.tensor(
                cov_rep['tied'], dtype=torch.int32),
            'observe/coverage/param_fraction': torch.tensor(
                cov_rep['param_fraction'], dtype=torch.float32),
        }

    def _observe_state_stats(self, damping: float) -> dict[str, Any]:
        """Spectrum extremes off the bucket stacks (JAX
        ``base_preconditioner.py:1993``; never a fresh decomposition;
        meaningful after the first refresh), none on the replicated
        engine."""
        if not self.bucketed:
            return {}
        return self._second_order.curvature_stats(self.buckets, damping)

    def _uses_coverage_helpers(self) -> bool:
        """Whether any registered layer rides the full-coverage helpers
        (LayerNorm, tied embedding, DenseGeneral, an explicit
        expand/reduce choice); False for every default registration."""
        from kfac_pytorch_tpu_torch.layers import coverage as cov_layers

        kinds = (
            cov_layers.ScaleBiasHelper,
            cov_layers.TiedEmbedHelper,
            cov_layers.DenseGeneralHelper,
            cov_layers.KfacReduceHelper,
            cov_layers.KfacExpandHelper,
        )
        return bool(self._capture.attend) or any(
            isinstance(h, kinds) for h in self.helpers.values()
        )
