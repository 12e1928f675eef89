"""K-FAC preconditioner (main user entry point).

Port of ``kfac_pytorch_tpu/preconditioner.py``.  The keyword names and
defaults are the JAX package's; the call sequence is PyTorch's own::

    model = resnet32()                     # on the GPU
    precond = KFACPreconditioner(
        model, factor_update_steps=1, inv_update_steps=10,
        damping=0.003, kl_clip=0.001, lr=0.1,
    )
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    for x, y in loader:
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        precond.step()                     # preconditions .grad in place
        opt.step()

Gradient accumulation (``accumulation_steps=N``) is the original torch
library's idiom; ``step()`` is the JAX ``finalize``::

    for i, (x, y) in enumerate(micro_batches):          # N of them
        ctx = ddp.no_sync() if i < N - 1 else nullcontext()
        with ctx:
            (F.cross_entropy(ddp(x), y) / N).backward()
    precond.step()                         # folds the N micro-batches
    opt.step()

``precond.reset_batch()`` drops the micro-batch sums.

Two additive eigen variants of the JAX package: ``lowrank_rank=k``
(randomized low-rank eigen on every bucket side at least ``2k`` wide;
exact buckets keep the fused kernel) and ``ekfac=True`` (per-step
re-estimated scales in the K-FAC eigenbasis), the latter with an
optional drift-triggered refresh::

    precond = KFACPreconditioner(
        model, ekfac=True, inv_update_steps=100,
        adaptive_refresh=AdaptiveRefresh(threshold=0.25, min_interval=10),
    )

Checkpoints are the stateful calls of the original torch library::

    torch.save({'precond': precond.state_dict(), ...}, path)
    precond.load_state_dict(torch.load(path)['precond'])  # recomputes

Across ranks (``torchrun --nproc-per-node N``), initialize
``torch.distributed``, wrap the model in ``DistributedDataParallel`` and
pass the wrapper or the bare module; ``grad_worker_fraction`` picks
COMM-OPT, HYBRID-OPT or MEM-OPT on the KAISA grid of the default group.
Every rank must take a local batch of the same size.

``stagger_refresh=K`` spreads each refresh over ``K`` steps, with an
optional drift-adaptive choice of the shard::

    precond = KFACPreconditioner(
        model, inv_update_steps=10, stagger_refresh=5,
        adaptive=AdaptiveRefreshConfig(threshold=0.2, staleness_factor=3),
    )

Two schedules hide communication and refresh time behind the step:
``overlap_comm=True`` runs each due refresh but the first one step late,
on a side CUDA stream while the next forward and backward are enqueued
(the due step preconditions through the previous decompositions), and
``pipeline_grads=True`` issues each bucket's gradient gather across
ranks as soon as that bucket is rotated.

The guardrails of the JAX package run on the same main path, the fused
kernel included::

    precond = KFACPreconditioner(
        model, health=HealthConfig(),            # step-skip, retries,
        consistency=ConsistencyConfig(cadence=10),  # cross-rank checks
        watchdog=WatchdogConfig(save_dir='gens', save_every=50),
    )

Observability (:mod:`~kfac_pytorch_tpu_torch.observe`) and the flight
recorder run on the same path, the fused kernel inside
``kfac/precondition``::

    precond = KFACPreconditioner(
        model, observe=ObserveConfig(monitor=True, annotate=True),
        flight=FlightConfig(path='logs/postmortem.json'),
    )
    ...                                    # each step, after opt.step():
    precond.flight_step(loss)              # train_loop does it itself
    observe_scalars(precond.last_step_info)   # 'observe/*' as floats

Streaming checkpoints (``elastic.save_streaming`` /
``restore_streaming``: no recompute on restore, any world size) and the
monolithic rotation (``utils.checkpoint.save_rotating`` /
``restore_latest_valid``) save and restore the preconditioner.

Every JAX option this slice does not port raises ``NotImplementedError``
naming its ``ROADMAP.md`` item; none is silently ignored.  The JAX
``loss_fn``/``apply_kwargs`` have no counterpart: the caller runs the
forward and backward passes itself.
"""
from __future__ import annotations

import logging
import warnings
from typing import Any, Callable, Sequence

import torch
from torch import nn

from kfac_pytorch_tpu_torch.assignment import KAISAAssignment
from kfac_pytorch_tpu_torch.base_preconditioner import BaseKFACPreconditioner
from kfac_pytorch_tpu_torch.capture import DEFAULT_LAYER_TYPES
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.consistency import ConsistencyConfig
from kfac_pytorch_tpu_torch.enums import AssignmentStrategy
from kfac_pytorch_tpu_torch.enums import ComputeMethod
from kfac_pytorch_tpu_torch.enums import DistributedStrategy
from kfac_pytorch_tpu_torch.enums import resolve_grad_worker_fraction
from kfac_pytorch_tpu_torch.health import HealthConfig
from kfac_pytorch_tpu_torch.ops import IterativeConfig
from kfac_pytorch_tpu_torch.parallel.mesh import data_world

logger = logging.getLogger(__name__)


def _unported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f'{option} is not ported to the PyTorch package yet '
        f'(ROADMAP.md {item})',
    )


class KFACPreconditioner(BaseKFACPreconditioner):
    """K-FAC preconditioner for ``nn.Linear``/``nn.Conv2d`` layers, and
    on request ``nn.Embedding`` (diagonal A) and ``nn.LayerNorm``
    (scale+bias) layers and a tied LM head.

    Args:
        model: the module to precondition, bare or wrapped in
            ``DistributedDataParallel`` (layer names are the inner
            module's either way); the K-FAC state lives on the device of
            its parameters.
        factor_update_steps: steps between factor EMA updates (callable
            of the step for a schedule).
        inv_update_steps: steps between eigendecomposition refreshes.
        damping: Tikhonov damping (validated ``> 0`` at every step).
        factor_decay: running-average weight of the factor EMAs.
        kl_clip: kl-clip bound, ``None`` to disable the scaling.
        lr: learning rate used by the kl-clip scale.
        accumulation_steps: forward/backward passes per :meth:`step`
            (gradient accumulation, see below).
        assignment_strategy, colocate_factors: KAISA placement knobs of
            the JAX package; the bucket plan places layers by cost
            either way.
        grad_worker_fraction: the KAISA knob (a
            :class:`DistributedStrategy` or a float), resolved at the
            world size of ``torch.distributed``'s default group (1 when
            it is not initialized), or ``'auto'``: with ``topology``,
            every rank solves the grid on the analytic comm ledger before
            the bucket plan and the grid are built
            (:mod:`kfac_pytorch_tpu_torch.placement`; the plan is
            ``placement_plan``, its report ``placement_report()``, and
            the live ``assignment`` is checked against it); without one
            it warns and takes HYBRID-OPT.
        topology: a :class:`~kfac_pytorch_tpu_torch.placement.\
PodTopology` of the world (GPUs of one NVLink node joined by the
            network), or ``None``; it scope-tags the comm ledger and
            prices ``'auto'``.  Its world must be the data world.
        compute_method: ``'eigen'`` (eigenbasis preconditioning),
            ``'inverse'`` (damped Cholesky inverses) or ``'iterative'``
            (the same inverses by warm-started Newton–Schulz, matmuls
            only; needs the bucketed stage).
        iterative_config: the Newton–Schulz knobs
            (:class:`~kfac_pytorch_tpu_torch.ops.IterativeConfig`;
            default ``IterativeConfig()``); only with
            ``compute_method='iterative'``.
        compute_eigenvalue_outer_product: eigen only: predivide
            ``1/(dg ⊗ da + damping)`` at refresh time and run the fused
            kernel (requires ``colocate_factors``), or keep the clamped
            eigenvalues and divide by the live damping every step.
        bucketed: the bucketed second-order stage (default), or with
            ``False`` the replicated engine: every rank refreshes and
            preconditions every layer by itself, per layer (the fused
            kernel is not launched, as in JAX), and custom helpers with
            non-symmetric factors take the general eig
            (:func:`~kfac_pytorch_tpu_torch.ops.\
compute_factor_eig_general`, on the host as in JAX) or an LU inverse.
            Eigen (prediv or not) and inverse only.
        factor_dtype, inv_dtype: dtypes of the factor EMAs and of the
            decompositions (default f32).
        precond_dtype: operand dtype of the rotation chain (default f32;
            bf16 accumulates in f32).
        cov_dtype: input dtype of the covariance products (default
            ``factor_dtype``).
        skip_layers: regexes of layer names / class names to skip.
        layer_types: kinds to register (default ``{'linear', 'conv2d'}``;
            also ``'embedding'``, ``'layernorm'`` and ``'dense_general'``,
            the projections of
            :class:`~kfac_pytorch_tpu_torch.models.layers.\
MultiHeadDotProductAttention`; the ``nn.Linear`` inside
            ``torch.nn.MultiheadAttention`` is rejected with a warning,
            as its forward runs no module call).
        kfac_approx: ``'expand'``, ``'reduce'`` or a ``{regex: mode}``
            mapping on linear and ``dense_general`` layers' names and
            class names.
        tied_weights: names of ``nn.Embedding`` modules shared with a
            :class:`~kfac_pytorch_tpu_torch.layers.TiedAttend` head
            (needs ``'embedding'``): one factor set for both calls.
        lowrank_rank: eigen only: truncate every bucket side whose padded
            dim is at least ``2 * lowrank_rank`` (and above ``rank +
            oversample``) to its top eigenpairs by randomized subspace
            iteration (:mod:`~kfac_pytorch_tpu_torch.ops.lowrank`); such
            buckets precondition by thin matmuls, the others keep the
            exact path.  Runs on every KAISA grid.
        lowrank_oversample, lowrank_power_iters: the sketch's extra
            columns (default 32) and QR power iterations (default 2).
        ekfac: eigen only: EKFAC (:mod:`~kfac_pytorch_tpu_torch.ops.\
ekfac`), the eigenbasis refreshed at the cadence and the scales
            re-estimated from each factor step's rows; linear and conv2d
            layers only; exclusive with ``lowrank_rank``.  Runs on every
            KAISA grid: with several columns each refresh also gathers
            every column's eigenbases over the grid row, so a rank
            projects the rows of every layer it captured
            (:class:`~kfac_pytorch_tpu_torch.parallel.second_order.\
BucketedSecondOrder`), and ``state_dict(include_ekfac_scales=True)``
            gathers the scales (every rank calls it).
        adaptive_refresh: an :class:`~kfac_pytorch_tpu_torch.adaptive.\
AdaptiveRefresh` that requests a refresh when the EKFAC scales drift
            (needs ``ekfac``).
        stagger_refresh: ``K`` refresh shards: after the monolithic
            first refresh, interval phase ``p < K`` re-decomposes shard
            ``p`` (an LPT partition of every bucket slot,
            :func:`~kfac_pytorch_tpu_torch.parallel.bucketing.\
make_stagger_plan`), so the refresh spike spreads over ``K`` steps;
            ``1 <= K <= inv_update_steps``, bucketed only, exclusive with
            ``lowrank_rank``.
        adaptive: an :class:`~kfac_pytorch_tpu_torch.scheduler.\
AdaptiveRefreshConfig` (needs ``stagger_refresh``, exclusive with
            ``adaptive_refresh``): each opportunity step refreshes the
            shard whose factors drifted most, or none, under the budget
            and staleness contracts of
            :class:`~kfac_pytorch_tpu_torch.scheduler.\
AdaptiveRefreshController`.
        overlap_comm: defer every due refresh but the bootstrap by one
            step (:func:`~kfac_pytorch_tpu_torch.scheduler.\
overlap_defer_action`): it is issued at the end of the due step's
            :meth:`step`, after the step counter moved (so it takes the
            next step's damping), runs on a worker thread and, on CUDA, a
            side stream (:mod:`~kfac_pytorch_tpu_torch.overlap`), reading
            the factor EMAs the due step left, and is installed at the
            top of the next :meth:`step`, whose ``last_refresh`` reads
            ``'overlap_inv'`` or ``'overlap_shard<k>'``.  The due step
            preconditions through the previous decompositions; from the
            next step on the trajectory is the synchronous one.  Composes
            with ``stagger_refresh`` (each shard defers by one step),
            ``adaptive``, ``compute_method='iterative'`` (a deferred
            refresh runs at warm depth), accumulation and
            ``pipeline_grads``; bucketed only, exclusive with
            ``lowrank_rank``, ``ekfac`` and ``health``.  A restore drops
            a pending refresh.
        pipeline_grads: issue each bucket's gradient gather over the
            grid row asynchronously right after its rotation, buckets in
            :func:`~kfac_pytorch_tpu_torch.parallel.bucketing.\
make_pipeline_order`'s order (descending gather bytes), so the next
            bucket's rotation runs while it moves; the kl-clip scale is
            applied after every gather is waited on, with the clip terms
            summed in plan order, so the result is the synchronous
            tail's bit for bit.  Bucketed only.
        health: a :class:`~kfac_pytorch_tpu_torch.health.HealthConfig`
            turns on the numerical-health guardrails
            (:mod:`~kfac_pytorch_tpu_torch.health`): a non-finite step
            is skipped (the factor EMAs kept bitwise, the gradients
            zeroed; on the fused path no optimizer step either), a failed
            decomposition retries with escalated jitter, falls back to
            the last good one and quarantines its slot to SGD, and a
            non-finite factor EMA is reset at refresh time; counters in
            ``last_step_info['health/*']``.  The fused kernel stays on:
            a quarantined slot's output is replaced after it.  Bucketed
            only; exclusive with ``lowrank_rank``, ``stagger_refresh``
            and ``overlap_comm``.
        consistency: a :class:`~kfac_pytorch_tpu_torch.consistency.\
ConsistencyConfig` turns on the cross-replica consistency guard: every
            ``cadence`` steps the replicated state is digested and
            compared across ranks, and a divergence is repaired by
            broadcast, re-bootstrapped and, if it persists, quarantined
            (``last_step_info['consistency/*']``).  Bucketed only;
            exclusive with ``lowrank_rank``.
        watchdog: a :class:`~kfac_pytorch_tpu_torch.watchdog.\
WatchdogConfig` turns on the trajectory watchdog
            (:mod:`~kfac_pytorch_tpu_torch.watchdog`): fed each step by
            :meth:`watchdog_step` (``train_loop`` feeds it itself), it
            softens damping and kl-clip, rolls back to the newest
            ``healthy`` streaming generation, or parks the model on SGD
            through the quarantine masks (``last_step_info['watchdog/*']``).
            Bucketed only; exclusive with ``lowrank_rank`` and with a
            callable ``damping`` or ``kl_clip``.
        observe: an :class:`~kfac_pytorch_tpu_torch.observe.ObserveConfig`
            turns on the profiler ranges of the step's phases
            (``annotate``), the ``observe/*`` statistics in
            ``last_step_info`` (``monitor``) and the whole-step timeline
            (``timeline``, one synchronize a step).  Off, the step is the
            unobserved one bit for bit.
        flight: a :class:`~kfac_pytorch_tpu_torch.observe.flight.\
FlightConfig` installs the flight recorder (``precond.flight``), fed by
            :meth:`flight_step` (``train_loop`` feeds it itself).
        factor_comm: ``'bf16_triu'`` reduces the symmetric factors of
            linear and conv2d layers as packed upper triangles summed in
            bf16 (lossy; about a quarter of the dense bytes); other
            layers, the diagonal-A ``[V]`` vectors and the row-count
            check stay dense.  Exclusive with ``ekfac``; ignored with a
            warning on one rank.

    A transformer with full coverage, as ``examples/tiny_gpt_lm.py``
    configures it::

        model = kt.models.gpt_125m()
        precond = KFACPreconditioner(
            model, layer_types=('linear', 'conv2d', 'embedding',
                                'layernorm'),
            tied_weights=('wte',),
        )

    ``precond.coverage_report()`` says which parameters the registration
    covers.
    """

    def __init__(
        self,
        model: nn.Module,
        *,
        factor_update_steps: Callable[[int], int] | int = 1,
        inv_update_steps: Callable[[int], int] | int = 1,
        damping: Callable[[int], float] | float = 0.001,
        factor_decay: Callable[[int], float] | float = 0.95,
        kl_clip: Callable[[int], float] | float | None = 0.001,
        lr: Callable[[int], float] | float = 0.1,
        accumulation_steps: int = 1,
        assignment_strategy: (
            AssignmentStrategy | str
        ) = AssignmentStrategy.COMPUTE,
        colocate_factors: bool = True,
        compute_method: ComputeMethod | str = ComputeMethod.EIGEN,
        iterative_config: Any = None,
        compute_eigenvalue_outer_product: bool = True,
        grad_worker_fraction: (
            DistributedStrategy | float | str
        ) = DistributedStrategy.COMM_OPT,
        topology: Any = None,
        mesh: Any = None,
        bucketed: bool | None = None,
        factor_dtype: torch.dtype = torch.float32,
        inv_dtype: torch.dtype = torch.float32,
        precond_dtype: torch.dtype | None = None,
        skip_layers: Sequence[str] = (),
        layer_types: Sequence[str] | None = None,
        kfac_approx: Any = 'expand',
        tied_weights: Sequence[str] = (),
        use_pallas: bool | None = None,
        lowrank_rank: int | None = None,
        lowrank_oversample: int = 32,
        lowrank_power_iters: int = 2,
        cov_dtype: torch.dtype | None = None,
        ekfac: bool = False,
        adaptive_refresh: Any = None,
        adaptive: Any = None,
        health: Any = None,
        observe: Any = None,
        compile_budget: int | None = None,
        stagger_refresh: int | None = None,
        overlap_comm: bool = False,
        pipeline_grads: bool = False,
        factor_comm: str | None = None,
        consistency: Any = None,
        watchdog: Any = None,
        flight: Any = None,
        loglevel: int = logging.DEBUG,
    ) -> None:
        if isinstance(assignment_strategy, str):
            assignment_strategy = AssignmentStrategy[
                assignment_strategy.upper()
            ]
        if isinstance(compute_method, str):
            compute_method = ComputeMethod[compute_method.upper()]
        if (
            compute_method == ComputeMethod.EIGEN
            and compute_eigenvalue_outer_product
            and not colocate_factors
        ):
            raise ValueError(
                'colocate_factors must be True to use '
                'compute_eigenvalue_outer_product',
            )
        if compute_method == ComputeMethod.ITERATIVE:
            if bucketed is False:
                raise ValueError(
                    "compute_method='iterative' requires the bucketed "
                    'second-order stage: the Newton–Schulz refresh is a '
                    'batched matmul iteration over the bucket stacks',
                )
            if iterative_config is None:
                iterative_config = IterativeConfig()
            elif not isinstance(iterative_config, IterativeConfig):
                raise TypeError(
                    'iterative_config must be an IterativeConfig or '
                    f'None, got {type(iterative_config).__name__}',
                )
        elif iterative_config is not None:
            raise ValueError(
                "iterative_config requires compute_method='iterative'",
            )
        # The JAX validation of the eigen variants
        # (base_preconditioner.py:440-475).
        if adaptive_refresh is not None and not ekfac:
            raise ValueError(
                'adaptive_refresh requires ekfac=True (the drift signal '
                'is the EKFAC scale EMA divergence)',
            )
        if lowrank_rank is not None:
            if compute_method != ComputeMethod.EIGEN:
                raise ValueError('lowrank_rank requires the EIGEN method')
            if bucketed is False:
                raise ValueError(
                    'lowrank_rank requires the bucketed second-order stage',
                )
            if lowrank_rank < 1:
                raise ValueError('lowrank_rank must be >= 1')
        if ekfac:
            if compute_method != ComputeMethod.EIGEN:
                raise ValueError('ekfac requires the EIGEN method')
            if lowrank_rank is not None:
                raise ValueError(
                    'ekfac and lowrank_rank are mutually exclusive',
                )
            if bucketed is False:
                raise ValueError(
                    'ekfac requires the bucketed second-order stage',
                )
        if stagger_refresh is not None:
            # JAX base_preconditioner.py:247-300: the shards are slices
            # of the bucket stacks; paths with more per-refresh state
            # are excluded.
            if stagger_refresh < 1:
                raise ValueError(
                    f'stagger_refresh must be >= 1, got {stagger_refresh}',
                )
            if bucketed is False:
                raise ValueError(
                    'stagger_refresh requires the bucketed second-order '
                    'stage (the shards are slices of the bucket stacks)',
                )
            if lowrank_rank is not None:
                raise ValueError(
                    'stagger_refresh and lowrank_rank are mutually '
                    'exclusive',
                )
            if health is not None:
                raise ValueError(
                    'stagger_refresh and health guardrails are mutually '
                    'exclusive',
                )
            if callable(inv_update_steps):
                interval = f'inv_update_steps(0)={inv_update_steps(0)!r}'
                at0 = inv_update_steps(0)
            else:
                interval = f'inv_update_steps={inv_update_steps}'
                at0 = inv_update_steps
            if stagger_refresh > at0:
                raise ValueError(
                    f'stagger_refresh={stagger_refresh} exceeds {interval}: '
                    'shard phases beyond the interval would never run',
                )
        if overlap_comm and health is not None:
            # JAX base_preconditioner.py:325-330; the rest of the
            # overlap_comm and pipeline_grads checks are the engine's
            # (base_preconditioner.validate_overlap).
            raise ValueError(
                'overlap_comm and health guardrails are mutually '
                'exclusive (the retry/fallback verdict ordering is '
                'defined for the in-band refresh only)',
            )
        # The compressed factor collective (JAX
        # base_preconditioner.py:474-499).
        if factor_comm not in (None, 'bf16_triu'):
            raise ValueError(
                "factor_comm must be None or 'bf16_triu', got "
                f'{factor_comm!r}',
            )
        if factor_comm is not None:
            if ekfac:
                raise ValueError(
                    'factor_comm and ekfac are mutually exclusive: the '
                    'EKFAC scale contributions would still reduce '
                    'dense, mixing compressed and uncompressed '
                    'statistics of the same rows',
                )
            if self._data_world() == 1:
                warnings.warn(
                    'factor_comm has no collective to compress without '
                    'several torch.distributed ranks; ignoring.',
                    stacklevel=2,
                )
                factor_comm = None
        # The guardrails' exclusions (JAX base_preconditioner.py:337-385).
        if health is not None:
            if bucketed is False:
                raise ValueError(
                    'health guardrails require the bucketed second-'
                    'order stage (the per-slot quarantine masks live in '
                    'the bucket stacks) — drop bucketed=False or '
                    'health',
                )
            if lowrank_rank is not None:
                raise ValueError(
                    'health and lowrank_rank are mutually exclusive: '
                    'the randomized decomposition is not health-'
                    'instrumented yet',
                )
            if not isinstance(health, HealthConfig):
                raise TypeError(
                    f'health must be a HealthConfig or None, got '
                    f'{type(health).__name__}',
                )
        if consistency is not None:
            if not isinstance(consistency, ConsistencyConfig):
                raise TypeError(
                    'consistency must be a ConsistencyConfig or None, '
                    f'got {type(consistency).__name__}',
                )
            if bucketed is False:
                raise ValueError(
                    'the consistency guard requires the bucketed '
                    'second-order stage (its digests and quarantine '
                    'masks live in the bucket stacks) — drop '
                    'bucketed=False or consistency',
                )
            if lowrank_rank is not None:
                raise ValueError(
                    'consistency and lowrank_rank are mutually '
                    'exclusive: the truncated decomposition path has '
                    'no per-slot quarantine masks',
                )
        if watchdog is not None:
            # The JAX checks (base_preconditioner.py:384-427): the park
            # rung quarantines through the bucket stacks' masks, and the
            # soften rung writes the stored constant hyperparameters.
            from kfac_pytorch_tpu_torch.watchdog import WatchdogConfig

            if not isinstance(watchdog, WatchdogConfig):
                raise TypeError(
                    'watchdog must be a WatchdogConfig or None, got '
                    f'{type(watchdog).__name__}',
                )
            if bucketed is False:
                raise ValueError(
                    'the trajectory watchdog requires the bucketed '
                    'second-order stage (its park rung quarantines '
                    'through the bucket stacks) — drop bucketed=False '
                    'or watchdog',
                )
            if lowrank_rank is not None:
                raise ValueError(
                    'watchdog and lowrank_rank are mutually exclusive: '
                    'the truncated decomposition path has no per-slot '
                    'quarantine masks to park through',
                )
            if callable(damping):
                raise ValueError(
                    'the watchdog softens damping in place (rung 1 / '
                    'escalated re-entry), which a callable damping — a '
                    'schedule or AdaptiveDamping — would overwrite '
                    'each step; pass a constant damping or drop the '
                    'watchdog',
                )
            if callable(kl_clip):
                raise ValueError(
                    'the watchdog tightens kl_clip in place (rung 1), '
                    'which a callable kl_clip would overwrite each '
                    'step; pass a constant (or None) kl_clip or drop '
                    'the watchdog',
                )
        if observe is not None:
            from kfac_pytorch_tpu_torch.observe import ObserveConfig

            if not isinstance(observe, ObserveConfig):
                raise TypeError(
                    'observe must be an ObserveConfig or None, got '
                    f'{type(observe).__name__}',
                )
        if flight is not None:
            from kfac_pytorch_tpu_torch.observe.flight import FlightConfig

            if not isinstance(flight, FlightConfig):
                raise TypeError(
                    'flight must be a FlightConfig or None, got '
                    f'{type(flight).__name__}',
                )
        if compile_budget is not None:
            raise _unported('compile_budget', 'Queue A item 31')
        if mesh is not None:
            raise NotImplementedError(
                'mesh has no counterpart in the PyTorch package: the port '
                'takes its world from the default torch.distributed '
                'process group (wrap the model in DistributedDataParallel '
                'and pick the strategy with grad_worker_fraction; '
                'ROADMAP.md Queue A item 7)',
            )
        if use_pallas is not None:
            raise NotImplementedError(
                'use_pallas has no counterpart in the PyTorch package: '
                'CUDA tensors always run the fused CUDA kernel and CPU '
                'tensors its plain version (ROADMAP.md Queue B item 1)',
            )
        # 'auto' is solved below, once the layers are registered; the
        # always-legal COMM-OPT stands in until then.
        auto = False
        if isinstance(grad_worker_fraction, str):
            if grad_worker_fraction != 'auto':
                raise ValueError(
                    'grad_worker_fraction must be a float, a '
                    "DistributedStrategy or the string 'auto'; got "
                    f'{grad_worker_fraction!r}',
                )
            if topology is None:
                warnings.warn(
                    "grad_worker_fraction='auto' needs a topology="
                    'PodTopology to price grids against; falling back to '
                    'HYBRID_OPT',
                    stacklevel=2,
                )
                grad_worker_fraction = DistributedStrategy.HYBRID_OPT
            else:
                auto = True
                grad_worker_fraction = DistributedStrategy.COMM_OPT
        if topology is not None:
            from kfac_pytorch_tpu_torch.placement import PodTopology

            if not isinstance(topology, PodTopology):
                raise TypeError(
                    'topology must be a PodTopology or None, got '
                    f'{type(topology).__name__}',
                )
            if topology.world != self._data_world():
                raise ValueError(
                    f'topology models {topology.world} devices '
                    f'({topology}) but the torch.distributed data world '
                    f'is {self._data_world()}',
                )
        self.topology = topology
        self.grad_worker_fraction, self.distributed_strategy = (
            resolve_grad_worker_fraction(grad_worker_fraction,
                                         self._data_world())
        )
        self.assignment_strategy = assignment_strategy
        self.colocate_factors = colocate_factors
        self.skip_layers = tuple(skip_layers)
        wrapper = model
        if isinstance(model, nn.parallel.DistributedDataParallel):
            model = model.module
        capture = ModelCapture(
            model,
            skip_layers=self.skip_layers,
            layer_types=(
                DEFAULT_LAYER_TYPES if layer_types is None else layer_types
            ),
            kfac_approx=kfac_approx,
            tied_weights=tied_weights,
        )
        if auto:
            self._solve_placement(
                capture, factor_update_steps=factor_update_steps,
                inv_update_steps=inv_update_steps,
                compute_method=compute_method,
                prediv=compute_eigenvalue_outer_product, ekfac=ekfac,
                factor_comm=factor_comm, factor_dtype=factor_dtype,
                inv_dtype=inv_dtype,
                adaptive=adaptive is not None and bucketed is not False,
                loglevel=loglevel,
            )
        super().__init__(
            capture,
            factor_update_steps=factor_update_steps,
            inv_update_steps=inv_update_steps,
            damping=damping,
            factor_decay=factor_decay,
            kl_clip=kl_clip,
            lr=lr,
            accumulation_steps=accumulation_steps,
            factor_dtype=factor_dtype,
            inv_dtype=inv_dtype,
            precond_dtype=(
                torch.float32 if precond_dtype is None else precond_dtype
            ),
            cov_dtype=cov_dtype,
            grad_worker_fraction=self.grad_worker_fraction,
            compute_method=compute_method,
            prediv_eigenvalues=compute_eigenvalue_outer_product,
            iterative_config=iterative_config,
            lowrank_rank=lowrank_rank,
            lowrank_oversample=lowrank_oversample,
            lowrank_power_iters=lowrank_power_iters,
            ekfac=ekfac,
            adaptive_refresh=adaptive_refresh,
            bucketed=bucketed is not False,
            stagger_refresh=stagger_refresh,
            adaptive=adaptive,
            factor_comm=factor_comm,
            overlap_comm=overlap_comm,
            pipeline_grads=pipeline_grads,
            health=health,
            consistency=consistency,
            watchdog=watchdog,
            observe=observe,
            flight=flight,
            loglevel=loglevel,
        )
        # The fused path's forward and backward go through the wrapper.
        self._train_module = wrapper
        cost = 3 if assignment_strategy == AssignmentStrategy.COMPUTE else 2
        # The KAISA inverse-worker placement of the layers, this rank's
        # view (JAX keeps rank 0's: its processes share one program).
        self.assignment = KAISAAssignment(
            {name: {'A': float(h.a_factor_shape[0]) ** cost,
                    'G': float(h.g_factor_shape[0]) ** cost}
             for name, h in self.helpers.items()},
            local_rank=self.grid.rank,
            world_size=self.grid.world,
            grad_worker_fraction=self.grad_worker_fraction,
            colocate_factors=self.colocate_factors,
        )
        if self.placement_plan is not None:
            from kfac_pytorch_tpu_torch.placement.apply import (
                verify_assignment,
            )

            verify_assignment(self.placement_plan, self.assignment)

    def _solve_placement(
        self, capture: ModelCapture, *, factor_update_steps,
        inv_update_steps, compute_method, prediv, ekfac, factor_comm,
        factor_dtype, inv_dtype, adaptive, loglevel,
    ) -> None:
        """Solve ``grad_worker_fraction='auto'`` on the registered layers,
        before the engine builds its bucket plan and grid from the
        fraction; every rank solves the same plan from the same inputs.
        The problem is :func:`~kfac_pytorch_tpu_torch.placement.solver.\
problem_for` of the engine that this builds."""
        from kfac_pytorch_tpu_torch.base_preconditioner import (
            compressed_layers,
        )
        from kfac_pytorch_tpu_torch.hyperparams import resolve
        from kfac_pytorch_tpu_torch.placement.apply import format_placement
        from kfac_pytorch_tpu_torch.placement.solver import auto_placement
        from kfac_pytorch_tpu_torch.placement.solver import problem_of

        problem = problem_of(
            capture.helpers,
            world=self._data_world(),
            factor_update_steps=resolve(factor_update_steps, 0),
            inv_update_steps=resolve(inv_update_steps, 0),
            compute_method=compute_method,
            prediv=prediv,
            ekfac=ekfac,
            compressed=(compressed_layers(capture.helpers, factor_comm)
                        if factor_comm == 'bf16_triu' else None),
            assignment_strategy=self.assignment_strategy,
            colocate_factors=self.colocate_factors,
            factor_dtype=factor_dtype,
            inv_dtype=inv_dtype,
            adaptive=adaptive,
        )
        plan = auto_placement(problem, self.topology)
        self.placement_plan = plan
        self.grad_worker_fraction, self.distributed_strategy = (
            resolve_grad_worker_fraction(plan.fraction, problem.world)
        )
        logger.log(loglevel, 'auto-placement solved:\n%s',
                   format_placement(plan))

    def _data_world(self) -> int:
        """The K-FAC world's size: the default process group's (a
        flavour with a data group counts that)."""
        return data_world()
