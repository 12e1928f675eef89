"""The K-FAC step engine: cadence, hyperparameters, the step body and
checkpoints.

Port of the single-device core of ``KFACEngineMixin``
(``kfac_pytorch_tpu/engine.py``).  The JAX engine dispatches one of four
compiled programs per step; here the step body runs eagerly, in the
order of ``engine.py:1463-1556``:

1. on factor-update steps, factor contributions from the captured
   activations and output gradients, folded into the EMAs (the first
   update starts from the identity);
2. on inverse-update steps, the bucketed second-order refresh;
3. every step, preconditioning of each layer's gradient and one global
   kl-clip scale, written back into the layers' ``.grad``.

Under ``stagger_refresh=K`` step 2 is planned by
:meth:`KFACEngineMixin._refresh_plan` (``engine.py:776-825``): the
first refresh is monolithic, after which interval phase ``p < K``
refreshes shard ``p``; with ``adaptive`` the
:class:`~kfac_pytorch_tpu_torch.scheduler.AdaptiveRefreshController`
picks the shard (or none) from the drift read back at the decision,
and commits the decision only after the step's work ran.

Under ``overlap_comm`` :meth:`KFACEngineMixin._overlap_plan`
(``engine.py:825-876``) defers every due refresh but the bootstrap by one
step (:func:`~kfac_pytorch_tpu_torch.scheduler.overlap_defer_action`): it
is issued at the end of the due step's :meth:`KFACEngineMixin.step`, runs
on a worker thread and a side stream
(:mod:`~kfac_pytorch_tpu_torch.overlap`) while the next step's forward
and backward are enqueued, and is installed at the top of the next
:meth:`KFACEngineMixin.step`.

The call sequence is PyTorch's: ``loss.backward(); precond.step();
optimizer.step()``.  Every step leaves :attr:`KFACEngineMixin.\
last_step_info`, device tensors read back only when the caller reads
them: ``vg_sum`` (``<raw grad, final grad>`` over every trainable
parameter, ``engine.py:74-90``), and on factor steps ``ekfac_divergence``
under EKFAC and the adaptive cadence's drift feed.  The fused path
(:meth:`KFACEngineMixin.make_train_step`, :meth:`KFACEngineMixin.\
train_loop`; ``engine.py:2027-2125, 2746-2899``) runs the forward,
backward, this step and the optimizer step in one call and feeds an
:class:`~kfac_pytorch_tpu_torch.adaptive.AdaptiveDamping` in the
``damping`` slot.  Under EKFAC the step's factor update also moves the
scale grids, and with an :class:`~kfac_pytorch_tpu_torch.adaptive.
AdaptiveRefresh` the drift read after a factor step can request a
refresh at the next step, off the cadence (``engine.py:733-738,
1368-1390``).  Under health (:mod:`~kfac_pytorch_tpu_torch.health`) each step's
verdict gates the factor EMAs and zeroes a bad step's gradients before
the precondition (no host read on :meth:`KFACEngineMixin.step`; the
fused path reads it once to skip the optimizer step), and ``health/*``
counters join ``last_step_info``.  Under the consistency guard
(:mod:`~kfac_pytorch_tpu_torch.consistency`) every ``cadence``-th step
ends with a cross-replica check, and :meth:`KFACEngineMixin.\
_consistency_finish` walks the repair ladder (``engine.py:920-1075``).
Checkpoints follow ``engine.py:102-292,2482-2700``:
:meth:`KFACEngineMixin.state_dict` holds the step counter, the
non-callable hyperparameters and the factor EMAs (never the
decompositions, which a restore recomputes), in the JAX payload's keys;
the streaming generations of :mod:`~kfac_pytorch_tpu_torch.elastic` keep
the decompositions too.  With a trajectory watchdog
(:mod:`~kfac_pytorch_tpu_torch.watchdog`) the caller feeds
:meth:`KFACEngineMixin.watchdog_step` after each step, and
:class:`KFACTrainLoop` does it itself.

Observability (:mod:`~kfac_pytorch_tpu_torch.observe`, JAX
``engine.py:1436-1556``): with ``ObserveConfig(annotate=True)`` the
step's phases run inside ``torch.profiler.record_function('kfac/<phase>')``
ranges (``capture`` or ``forward_backward`` on the fused path,
``factor_ema``, ``eigh_refresh``, ``precondition``, the deferred
refresh's ``overlap/refresh`` and ``overlap/collect``), with
``monitor=True`` the ``observe/*`` statistics join ``last_step_info``
(device tensors: the kl-clip ``nu`` read off the clip reduction the step
already performs, the gradient norms, the spectrum extremes of the
stacks), and with ``timeline=True`` every step is timed under its variant
with one synchronize.  A flight recorder (``flight=``) is fed by
:meth:`KFACEngineMixin.flight_step` (and by :class:`KFACTrainLoop`).
With neither, the step is the unobserved one, bit for bit, with the same
``last_step_info`` keys.  The engine's cross-process commit points
(:func:`~kfac_pytorch_tpu_torch.runtime.commit_point`) are no-ops
without an installed runtime.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch import consistency as consistency_lib
from kfac_pytorch_tpu_torch import health as health_lib
from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch import runtime
from kfac_pytorch_tpu_torch import tracing
from kfac_pytorch_tpu_torch.adaptive import AdaptiveDamping
from kfac_pytorch_tpu_torch.hyperparams import resolve
from kfac_pytorch_tpu_torch.hyperparams import validate_damping
from kfac_pytorch_tpu_torch.observe import timeline as observe_timeline
from kfac_pytorch_tpu_torch.scheduler import AdaptiveRefreshConfig
from kfac_pytorch_tpu_torch.scheduler import overlap_defer_action
from kfac_pytorch_tpu_torch.scheduler import post_restore_bootstrapped
from kfac_pytorch_tpu_torch.scheduler import stagger_refresh_action

logger = logging.getLogger(__name__)

#: The schedulable hyperparameters a checkpoint holds (when not callable).
HYPERPARAM_KEYS = (
    'factor_update_steps',
    'inv_update_steps',
    'damping',
    'factor_decay',
    'kl_clip',
    'lr',
)


def save_hyperparams(precond: Any, sd: dict[str, Any]) -> None:
    """Write the non-callable hyperparameters of ``precond`` into ``sd``."""
    for name in HYPERPARAM_KEYS:
        value = getattr(precond, f'_{name}')
        if not callable(value):
            sd[name] = value


def load_hyperparams(precond: Any, sd: Mapping[str, Any]) -> None:
    """Restore hyperparameters saved by :func:`save_hyperparams`."""
    for name in HYPERPARAM_KEYS:
        if name in sd:
            setattr(precond, f'_{name}', sd[name])


def pack_factor(factor: torch.Tensor, compress_symmetric: bool) -> Any:
    """Checkpoint encoding of one factor EMA: a CPU tensor, or with
    ``compress_symmetric`` the packed upper triangle
    ``{'triu': [n(n+1)/2], 'dim': n}``."""
    if compress_symmetric and factor.ndim >= 2:
        return {
            'triu': ops.get_triu(factor).cpu(),
            'dim': int(factor.shape[-1]),
        }
    return factor.detach().cpu().clone()


def unpack_factor(
    packed: Any, dtype: torch.dtype, device: torch.device | str = 'cpu',
) -> torch.Tensor:
    """Inverse of :func:`pack_factor`, onto ``device`` in ``dtype``."""
    if isinstance(packed, Mapping) and 'triu' in packed:
        triu = torch.as_tensor(packed['triu'], device=device)
        dim = int(packed['dim'])
        shape = tuple(triu.shape[:-1]) + (dim, dim)
        return ops.fill_triu(shape, triu).to(dtype)
    return torch.as_tensor(packed).to(device=device, dtype=dtype)


def saved_factor_shape(packed: Any) -> tuple[int, ...]:
    """Logical (unpacked) shape of one checkpointed factor entry,
    without unpacking it."""
    if isinstance(packed, Mapping) and 'triu' in packed:
        dim = int(packed['dim'])
        return tuple(np.shape(packed['triu'])[:-1]) + (dim, dim)
    return tuple(np.shape(packed))


def validate_saved_factor_shapes(
    layers: Mapping[str, Any],
    registered: Mapping[str, Any],
    saved_topology: str | None = None,
    expected_topology: str | None = None,
) -> None:
    """Raise a per-layer error on factor-shape mismatches, naming the
    saved and live topologies when they are known."""
    def topology_hint() -> str:
        parts = []
        if saved_topology is not None:
            parts.append(f'saved topology: {saved_topology}')
        if expected_topology is not None:
            parts.append(f'live topology: {expected_topology}')
        return ' [' + '; '.join(parts) + ']' if parts else ''

    for base, factors in layers.items():
        st = registered[base]
        for key, attr in (('A', 'a_factor'), ('G', 'g_factor')):
            if not isinstance(factors, Mapping) or key not in factors:
                continue
            packed = factors[key]
            if isinstance(packed, Mapping) and 'triu' in packed:
                dim = int(packed['dim'])
                expect = dim * (dim + 1) // 2
                got = np.shape(packed['triu'])[-1]
                if got != expect:
                    raise ValueError(
                        'checkpoint factor payload corrupt for layer '
                        f'{base!r} (factor {key}): packed triu length '
                        f'{got} != dim*(dim+1)/2 = {expect} for '
                        f'dim={dim}' + topology_hint(),
                    )
            saved = saved_factor_shape(packed)
            want = tuple(getattr(st, attr).shape)
            # A dense [V, V] A of a diagonal-A layer (a checkpoint from
            # before the diagonal storage) loads through its diagonal.
            legacy_diag = key == 'A' and len(want) == 1 and saved == want * 2
            if saved != want and not legacy_diag:
                raise ValueError(
                    f'checkpoint factor shape mismatch for layer {base!r} '
                    f'(factor {key}): saved {saved} vs expected {want} — '
                    'was this state dict saved under a different model '
                    'configuration or world size / bucket layout?'
                    + topology_hint(),
                )


def begin_load_state_dict(
    precond: Any,
    state_dict: Mapping[str, Any],
    registered: Mapping[str, Any],
    compute_inverses: bool,
) -> Mapping[str, Any] | None:
    """The head of ``load_state_dict``: restores the step counter and
    hyperparameters, then returns the validated ``layers`` payload, or
    ``None`` for a dict saved with ``include_factors=False`` (which
    raises if ``compute_inverses``)."""
    precond._steps = int(state_dict['steps'])
    precond._last_inv_step = int(
        state_dict.get('sketch_step', state_dict['steps']),
    )
    load_hyperparams(precond, state_dict)
    layers = state_dict.get('layers')
    if layers is None:
        if compute_inverses:
            raise ValueError(
                'Cannot compute inverses from a state dict saved with '
                'include_factors=False',
            )
        return None
    unknown = set(layers) - set(registered)
    if unknown:
        raise ValueError(
            f'state dict contains unregistered layers {sorted(unknown)}'
            f' (registered: {sorted(registered)})',
        )
    validate_saved_factor_shapes(
        layers, registered,
        saved_topology=state_dict.get('topology'),
        expected_topology=precond._topology_descriptor(),
    )
    return layers


def validate_adaptive(
    adaptive: Any, stagger_refresh: int | None, adaptive_refresh: Any,
) -> None:
    """The JAX engine's checks of ``adaptive`` (``engine.py:391-410``)."""
    if adaptive is None:
        return
    if not isinstance(adaptive, AdaptiveRefreshConfig):
        raise TypeError(
            'adaptive must be a scheduler.AdaptiveRefreshConfig, '
            f'got {type(adaptive).__name__}',
        )
    if stagger_refresh is None:
        raise ValueError(
            'adaptive refresh is a per-stagger-shard cadence: pass '
            'stagger_refresh=K (K >= 1) alongside '
            'adaptive=AdaptiveRefreshConfig(...)',
        )
    if adaptive_refresh is not None:
        raise ValueError(
            'adaptive and adaptive_refresh are two cadence controllers '
            'fighting over the same refresh schedule: pass one or the '
            'other',
        )


class KFACEngineMixin:
    """Step cadence, hyperparameter resolution and checkpoints.

    Subclasses provide ``_update_factors(first_update)``,
    ``reset_batch()``, ``_refresh(damping)`` (whose low-rank sketches
    are drawn for ``_last_inv_step``), ``_precondition(damping, kl_clip,
    lr)``, ``_checkpoint_layer_states()``,
    ``_restore_factors(layers)`` and ``_topology_descriptor()``, under
    EKFAC ``_ekfac_divergence()``, ``_ekfac_scales()`` and
    ``_with_ekfac_scales(scales)``, under ``stagger_refresh``
    ``_refresh_shard(damping, shard)`` and ``_stagger_shard_empty(
    shard)``, under ``adaptive`` ``_adaptive_drift_emit()``, under
    ``overlap_comm`` ``_issue_deferred_refresh(pending, damping)`` and
    ``_install_refresh(state)``, and arm their capture through
    ``_arm_capture(bool)``.  ``_precondition`` returns the step's
    ``vg_sum``; ``_ekfac_scale_shapes()`` gives the shapes of
    ``_ekfac_scales()`` without a collective; the fused path runs the
    module ``_train_module`` and switches the capture through
    ``_capture_armed(bool)``, which holds no capture, and
    ``_bn_buffers()`` lists the buffers a training-mode forward moves.

    These are JAX's flavour hooks (``engine.py:14-40``) in torch form:
    ``_update_factors`` is ``_apply_ema`` over the captured
    contributions, ``_refresh`` ``_second_order_refresh``,
    ``_precondition`` ``_precondition_grads``, ``_restore_factors`` and
    ``_checkpoint_layer_states`` the same, and ``_forward_backward(args,
    loss_args, loss_fn)`` the fused path's ``_loss_grads_and_captured``/
    ``_loss_and_grads_plain`` (the bucketed engine runs the module and
    ``loss.backward()``; the MoE and pipeline flavours of
    :mod:`kfac_pytorch_tpu_torch.gpt` run their own forward and backward
    and share this engine's cadence, hyperparameters, accumulation,
    checkpoints and ``train_loop``).
    """

    #: The two-level interconnect model
    #: (:class:`~kfac_pytorch_tpu_torch.placement.PodTopology`) that
    #: scope-tags the comm ledger, or ``None``; host-side only.
    topology: Any = None
    #: The solved auto-placement plan of ``grad_worker_fraction='auto'``
    #: (:mod:`kfac_pytorch_tpu_torch.placement`), ``None`` for a numeric
    #: fraction: no step reads it.
    placement_plan: Any = None

    def placement_report(self) -> str:
        """The auto-placement report of a planner-solved engine: the
        candidate table, the chosen grid, the per-phase link scopes and
        the per-column layout
        (:func:`kfac_pytorch_tpu_torch.placement.apply.format_placement`),
        then the scope-tagged comm ledger of the port's own collectives.
        Raises ``ValueError`` without a solved plan (a numeric
        ``grad_worker_fraction``)."""
        if self.placement_plan is None:
            raise ValueError(
                'no placement plan: this engine was built with a '
                "numeric grad_worker_fraction (pass grad_worker_"
                "fraction='auto' with a topology= to solve one)",
            )
        from kfac_pytorch_tpu_torch.observe.costs import format_ledger
        from kfac_pytorch_tpu_torch.observe.costs import ledger_for
        from kfac_pytorch_tpu_torch.placement.apply import format_placement

        report = format_placement(self.placement_plan)
        try:
            ledger = ledger_for(self)
        except ValueError:
            return report
        return report + '\n' + format_ledger(
            ledger, self.factor_update_steps, self.inv_update_steps,
            consistency_steps=(
                self._consistency.cadence
                if self._consistency is not None else None
            ),
            watchdog_steps=(
                self._watchdog_config.check_every
                if self._watchdog_config is not None else None
            ),
        )

    def _init_engine(
        self,
        *,
        factor_update_steps: Callable[[int], int] | int,
        inv_update_steps: Callable[[int], int] | int,
        damping: Callable[[int], float] | float,
        factor_decay: Callable[[int], float] | float,
        kl_clip: Callable[[int], float] | float | None,
        lr: Callable[[int], float] | float,
        adaptive_refresh: Any = None,
        stagger_refresh: int | None = None,
        adaptive_controller: Any = None,
        overlap_comm: bool = False,
        consistency: Any = None,
        watchdog: Any = None,
        observe: Any = None,
        flight: Any = None,
    ) -> None:
        if not callable(damping):
            validate_damping(damping)
        # Observability (None: off, the unobserved step).  The whole-step
        # timeline exists only under timeline=True: its honest timing
        # costs one synchronize a step.
        self._observe = observe
        self._timeline = (
            observe_timeline.StepTimeline(observe.timeline_history)
            if observe is not None and observe.timeline else None
        )
        # The step variants run so far (host names, JAX's step/<variant>
        # without the prefix) and the latest one.
        self._variants_run: set[str] = set()
        self._last_variant: str | None = None
        # The cross-replica consistency guard: its knobs, the ladder of
        # consecutive disagreeing checks per surface, and the host
        # counters surfaced as consistency/*_total on check steps.
        self._consistency = consistency
        self._consistency_ladder = (
            health_lib.EscalationLadder(consistency.quarantine_after)
            if consistency is not None else None
        )
        self._consistency_totals = {
            'checks': 0, 'detections': 0, 'repairs': 0, 'quarantines': 0,
        }
        #: The latest check's verdicts (``consistency.CheckResult``).
        self.last_consistency_check = None
        # Host reads of the health verdicts: the retry rounds and the
        # factor reset at refresh time, the fused path's skip decision.
        self._health_host_syncs = 0
        # LM damping feedback: an AdaptiveDamping in the damping slot is
        # fed by the fused path (make_train_step, train_loop); step()
        # says once that it does not feed it.
        self._adaptive_damping = (
            damping if isinstance(damping, AdaptiveDamping) else None
        )
        self._warned_adaptive_unfed = False
        self._last_step_info: dict[str, torch.Tensor] | None = None
        # The deferred refresh (overlap_comm): the descriptor the last
        # step deferred, ('inv',) or ('shard', k), and its work in
        # flight, issued at that step's end and installed at the top of
        # the next step; the bootstrap flag gates deferral like
        # _stagger_bootstrapped (set by any in-band monolithic refresh,
        # reset by a restore without a recompute).
        self._overlap_comm = bool(overlap_comm)
        self._overlap_pending: tuple | None = None
        self._overlap_inflight: Any = None
        self._overlap_bootstrapped = False
        # The staggered refresh: False until the first monolithic
        # refresh (and again after a restore without a recompute).
        self._stagger_refresh = stagger_refresh
        self._stagger_bootstrapped = False
        # The drift-adaptive cadence: the controller, and the latest
        # drift feed as device tensors, read back to the host only at an
        # opportunity step (counted in _adaptive_host_syncs).
        self._adaptive_controller = adaptive_controller
        self._adaptive_last_drift: tuple | None = None
        self._adaptive_host_syncs = 0
        self._last_refresh: str | int | None = None
        # The drift-triggered refresh (EKFAC only): fed the scale drift
        # after every factor step; a request runs the refresh at the
        # next step once factors exist.
        self._adaptive_refresh = adaptive_refresh
        self._refresh_requested = False
        self._last_ekfac_divergence: torch.Tensor | None = None
        self._factor_update_steps = factor_update_steps
        self._inv_update_steps = inv_update_steps
        self._damping = damping
        self._factor_decay = factor_decay
        self._kl_clip = kl_clip
        self._lr = lr
        self._steps = 0
        self._last_inv_step = 0
        self._factors_initialized = False
        # The iterative method's warm-start flag: False until a refresh
        # has produced roots in every slot (scheduler.
        # iterative_refresh_iters reads it; inert for the other methods).
        self._iter_bootstrapped = False
        # The trajectory watchdog (None: off), fed by watchdog_step.
        self._watchdog_config = watchdog
        self._watchdog = None
        if watchdog is not None:
            from kfac_pytorch_tpu_torch.watchdog import TrajectoryWatchdog

            self._watchdog = TrajectoryWatchdog(watchdog, self)
        # The flight recorder (None: off), fed by flight_step.
        self._flight_config = flight
        self._flight = None
        if flight is not None:
            from kfac_pytorch_tpu_torch.observe.flight import FlightRecorder

            self._flight = FlightRecorder(flight, self)
        self._arm_capture(self._step_gating()[0])

    @property
    def observe(self) -> Any:
        """The :class:`~kfac_pytorch_tpu_torch.observe.ObserveConfig`
        (``None``: observability off)."""
        return self._observe

    @property
    def timeline(self) -> Any:
        """The whole-step :class:`~kfac_pytorch_tpu_torch.observe.\
StepTimeline` (``None`` unless ``ObserveConfig(timeline=True)``)."""
        return self._timeline

    @property
    def flight(self) -> Any:
        """The :class:`~kfac_pytorch_tpu_torch.observe.flight.\
FlightRecorder` (``None``: flight recording off)."""
        return self._flight

    def flight_step(self, loss: Any = None) -> None:
        """Feed the flight recorder one completed step (JAX
        ``engine.py:613-625``): call it once a step after the optimizer
        step (and after :meth:`watchdog_step`, so the ring records the
        step's final counters).  ``loss`` may be a device scalar: the
        recorder keeps it unread until its next flush.  A no-op without
        ``flight=``."""
        if self._flight is not None:
            self._flight.record(loss)

    def _annotate(self) -> bool:
        return self._observe is not None and self._observe.annotate

    def _scope(self, name: str):
        """``record_function('kfac/<name>')`` under annotate, else a
        no-op."""
        return observe_timeline.scope(name, self._annotate())

    @staticmethod
    def _step_variant(
        update_factors: bool,
        update_inverses: bool,
        refresh_shard: int | None = None,
        deferred: tuple | None = None,
        check_consistency: bool = False,
    ) -> str:
        """The JAX engine's step-variant name (``engine.py:1843-1866``):
        ``inv``, or ``plain``/``factor`` with ``+shard<k>``,
        ``+overlap_inv`` or ``+overlap_shard<k>``; ``+consistency`` on a
        check step."""
        if update_inverses:
            name = 'inv'
        else:
            base = 'factor' if update_factors else 'plain'
            if refresh_shard is not None:
                name = f'{base}+shard{refresh_shard}'
            elif deferred is not None:
                suffix = (
                    'overlap_inv' if deferred[0] == 'inv'
                    else f'overlap_shard{deferred[1]}'
                )
                name = f'{base}+{suffix}'
            else:
                name = base
        if check_consistency:
            name += '+consistency'
        return name

    def _timed(self, fn: Callable[..., Any], *args: Any) -> Any:
        """Run one step, recording it in the timeline when there is one:
        a ``kfac/step`` range, one synchronize, the wall time under
        ``step/<variant>`` of the step that ran.  A bare call otherwise."""
        tl = self._timeline
        if tl is None:
            return fn(*args)
        with observe_timeline.annotation('step'):
            t0 = time.perf_counter()
            out = fn(*args)
            tl.sync()
            tl.record('step/' + self._last_variant, time.perf_counter() - t0)
        return out

    @property
    def watchdog(self) -> Any:
        """The :class:`~kfac_pytorch_tpu_torch.watchdog.\
TrajectoryWatchdog` (``None`` without ``watchdog=``)."""
        return self._watchdog

    def watchdog_step(
        self, loss: Any,
        extras: (Mapping[str, Any] | Callable[[], Mapping[str, Any]]
                 | None) = None,
    ) -> dict[str, Any] | None:
        """Feed the trajectory watchdog one completed step (JAX
        ``engine.py:582-604``): call it once a step after the optimizer
        step, with the step's loss (a device scalar is fine: it is read
        back at the check cadence) and, when the watchdog saves, the flat
        ``str -> tensor`` ``extras`` to keep in each generation (the
        model's ``state_dict()``, the optimizer's moments), or a
        zero-argument callable returning them, called only on a step
        that saves.  Returns
        ``None``, or after a rung-2 rollback its info: the step counter
        is the restored one and ``info['extras']`` holds the restored
        arrays for the caller to load back.  ``None`` without a
        watchdog."""
        if self._watchdog is None:
            return None
        return self._watchdog.update(loss, extras)

    @property
    def steps(self) -> int:
        """Completed :meth:`step` calls."""
        return self._steps

    @property
    def last_step_info(self) -> dict[str, torch.Tensor] | None:
        """Device tensors of the latest step (no host sync until a value
        is read), ``None`` before the first: ``vg_sum``, the f32
        ``<raw grad, final grad>`` over every trainable parameter (the
        final gradient carries the kl-clip scale; a parameter the
        preconditioner does not register contributes ``|g|^2``), the
        kl-clip and quadratic-model inner product; on factor steps
        ``ekfac_divergence`` under EKFAC and the drift feed
        (``adaptive/checked``, ``adaptive/sketch``, ``adaptive/digest``)
        under the adaptive cadence, whose counters
        (``adaptive/*_total``, ``adaptive/shard<k>/*``) ride every
        step; under health the ``health/*`` counters
        (:data:`~kfac_pytorch_tpu_torch.health.HEALTH_INFO_KEYS`) every
        step, and under the consistency guard the ``consistency/*``
        verdict and ladder counters on check steps."""
        return self._last_step_info

    @property
    def health_host_syncs(self) -> int:
        """Host reads of the health verdicts so far: one per bucket and
        retry round plus one for the factor reset at each refresh, and
        one a step on the fused path (whether to run the optimizer)."""
        return self._health_host_syncs

    @property
    def last_ekfac_divergence(self) -> torch.Tensor | None:
        """The latest EKFAC scale drift (a device scalar, from the last
        factor step), kept across steps; ``None`` before the first
        factor step or without EKFAC."""
        return self._last_ekfac_divergence

    @property
    def last_refresh(self) -> str | int | None:
        """What the latest :meth:`step` refreshed: ``'full'``, a stagger
        shard index, or ``None``; under ``overlap_comm`` the step that
        installs a deferred refresh reports ``'overlap_inv'`` or
        ``'overlap_shard<k>'`` (the JAX step variants' names)."""
        return self._last_refresh

    @property
    def overlap_pending(self) -> tuple | None:
        """The refresh the latest step deferred (``('inv',)`` or
        ``('shard', k)``), in flight until the next :meth:`step` installs
        it; ``None`` without ``overlap_comm``."""
        return self._overlap_pending

    @property
    def adaptive_controller(self) -> Any:
        """The :class:`~kfac_pytorch_tpu_torch.scheduler.\
AdaptiveRefreshController` (``None`` without ``adaptive``)."""
        return self._adaptive_controller

    @property
    def factor_update_steps(self) -> int:
        return int(resolve(self._factor_update_steps, self._steps))

    @property
    def inv_update_steps(self) -> int:
        return int(resolve(self._inv_update_steps, self._steps))

    @property
    def damping(self) -> float:
        return validate_damping(
            resolve(self._damping, self._steps),
            origin=f'damping (at step {self._steps})',
        )

    @property
    def factor_decay(self) -> float:
        return float(resolve(self._factor_decay, self._steps))

    @property
    def kl_clip(self) -> float | None:
        v = resolve(self._kl_clip, self._steps)
        return None if v is None else float(v)

    @property
    def lr(self) -> float:
        return float(resolve(self._lr, self._steps))

    def _step_gating(self) -> tuple[bool, bool]:
        """``(update_factors, update_inverses)`` for the current step.

        Inverses never update before the first factor update
        (decomposing zeros is meaningless); a refresh the drift
        controller requested runs once factors exist.
        """
        fus = self.factor_update_steps
        ius = self.inv_update_steps
        update_factors = fus > 0 and self._steps % fus == 0
        have_factors = self._factors_initialized or update_factors
        update_inverses = (
            ius > 0 and self._steps % ius == 0 and have_factors
        )
        if self._refresh_requested and have_factors:
            update_inverses = True
        return update_factors, update_inverses

    def _refresh_plan(self) -> tuple[bool, bool, int | None]:
        """``(update_factors, update_inverses, refresh_shard)`` of the
        current step (JAX ``engine.py:776-825``).

        Without ``stagger_refresh`` this is :meth:`_step_gating` with no
        shard.  With it, :func:`~kfac_pytorch_tpu_torch.scheduler.\
stagger_refresh_action` keeps the first due refresh monolithic and then
        gives each interval phase below ``K`` its shard; under
        ``adaptive`` the controller picks the shard (or none) at those
        same steps, from the drift read back here, as a pending decision
        that :meth:`step` commits after the step's work.  An empty shard
        runs a plain step.
        """
        update_factors, update_inverses = self._step_gating()
        if self._stagger_refresh is None:
            return update_factors, update_inverses, None
        action = stagger_refresh_action(
            self._steps,
            self.inv_update_steps,
            self._stagger_refresh,
            factors_ready=self._factors_initialized or update_factors,
            monolithic_due=update_inverses,
            bootstrapped=self._stagger_bootstrapped,
        )
        ctl = self._adaptive_controller
        if ctl is not None:
            if action == 'full':
                sketch, digest = self._adaptive_drift_host()
                ctl.note_full(self._steps, sketch=sketch, digest=digest)
            elif action is not None:
                sketch, digest = self._adaptive_drift_host()
                action = ctl.decide(
                    self._steps, self.inv_update_steps,
                    sketch=sketch, digest=digest,
                )
        if action == 'full':
            return update_factors, True, None
        if action is None or self._stagger_shard_empty(action):
            return update_factors, False, None
        return update_factors, False, action

    def _overlap_plan(
        self,
    ) -> tuple[bool, bool, int | None, tuple | None, tuple | None]:
        """``(update_factors, update_inverses, refresh_shard, deferred,
        pending)`` (JAX ``engine.py:825-863``).

        Without ``overlap_comm`` this is :meth:`_refresh_plan` with
        ``deferred = pending = None``.  With it,
        :func:`~kfac_pytorch_tpu_torch.scheduler.overlap_defer_action`
        keeps the bootstrap in band and turns every other due refresh
        into ``pending``, which the step defers; ``deferred`` is the
        previous step's, which this step installs.  No state changes
        here: :meth:`_overlap_commit` takes ``pending`` only after the
        step's work ran.
        """
        update_factors, update_inverses, shard = self._refresh_plan()
        if not self._overlap_comm:
            return update_factors, update_inverses, shard, None, None
        deferred = self._overlap_pending
        in_band, pending = overlap_defer_action(
            monolithic_due=update_inverses,
            shard_due=shard,
            bootstrapped=self._overlap_bootstrapped,
        )
        if in_band:
            if deferred is not None:
                raise RuntimeError(
                    f'a deferred refresh {deferred} is pending on an engine '
                    'that is not bootstrapped',
                )
            return update_factors, True, None, None, None
        return update_factors, False, None, deferred, pending

    def _overlap_commit(self, pending: tuple | None) -> None:
        """Take the step's deferral (after its work ran; JAX
        ``engine.py:865-876``) and commit the adaptive controller's
        pending decision, which advances its ages by one step."""
        self._overlap_pending = pending
        if self._adaptive_controller is not None:
            self._adaptive_controller.commit(self._steps)

    def _overlap_collect(self, deferred: tuple) -> None:
        """Install the refresh the previous step deferred: wait for its
        work (the current stream waits on the side stream) and install
        the new state.  Once installed it is no longer pending, so a step
        that raises after this point does not run it again."""
        if not self._overlap_bootstrapped:
            raise RuntimeError(
                f'a deferred refresh {deferred} is pending on an engine '
                'that is not bootstrapped',
            )
        work, self._overlap_inflight = self._overlap_inflight, None
        if work is None:
            raise RuntimeError(
                f'the deferred refresh {deferred} is pending but was never '
                'issued',
            )
        self._overlap_pending = None
        self._install_refresh(work.wait())

    def join_deferred_refresh(self) -> None:
        """Wait until the deferred refresh in flight (``overlap_comm``)
        has run on its worker; the next :meth:`step` still installs it.
        Call it after the last step, before ``torch.distributed`` is torn
        down or the process ends: across ranks the refresh runs column
        gathers of its own."""
        if self._overlap_inflight is not None:
            self._overlap_inflight.join()

    def _overlap_drop(self) -> None:
        """Drop a pending refresh (a restore): its work is waited on, so
        no collective or kernel of it is left running, and its state,
        or the error it raised, is discarded."""
        work, self._overlap_inflight = self._overlap_inflight, None
        self._overlap_pending = None
        if work is not None:
            with contextlib.suppress(RuntimeError):
                work.wait()

    def _adaptive_drift_host(self) -> tuple[Any, Any]:
        """Host copies of the latest drift feed, ``(sketch, digest)``
        numpy arrays, or ``(None, None)`` before the first factor step
        fed one.  This read is the adaptive cadence's one host sync,
        made only at opportunity steps."""
        if self._adaptive_last_drift is None:
            return None, None
        self._adaptive_host_syncs += 1
        sketch, digest = self._adaptive_last_drift
        return sketch.cpu().numpy(), digest.cpu().numpy()

    @property
    def adaptive_host_syncs(self) -> int:
        """Host reads of the drift feed so far (one per opportunity step
        after the first factor step)."""
        return self._adaptive_host_syncs

    def step(self) -> None:
        """Precondition the gradients now in the registered layers'
        ``.grad`` (call after ``backward()``, before the optimizer).

        Under ``overlap_comm`` it first installs the refresh the previous
        step deferred, and it ends by issuing the one this step defers.
        An :class:`~kfac_pytorch_tpu_torch.adaptive.AdaptiveDamping` is
        not fed here (the step never sees the updated parameters); the
        first call says so once (JAX ``engine.py:1902-1920``)."""
        self._timed(self._step)
        self._warn_adaptive_unfed(
            'step()' if getattr(self, 'accumulation_steps', 1) == 1
            else 'accumulated step()',
        )

    def _step(self, loss: torch.Tensor | None = None) -> None:
        """The body of :meth:`step`, shared with the fused path (which
        passes the step's ``loss`` for the health verdict)."""
        update_factors, update_inverses, shard, deferred, pending = (
            self._overlap_plan()
        )
        check = self._consistency_due()
        self._last_variant = self._step_variant(
            update_factors, update_inverses, shard, deferred, check)
        self._variants_run.add(self._last_variant)
        monitor = self._observe is not None and self._observe.monitor
        # The collect point of a deferred refresh: its install and the
        # precondition that first reads it (range only).
        collect = (self._scope('overlap/collect') if deferred is not None
                   else contextlib.nullcontext())
        if deferred is not None:
            with collect:
                self._overlap_collect(deferred)
        ok = None
        guarded = self._health_config() is not None
        if update_factors:
            first_update = not self._factors_initialized
            with self._scope('factor_ema'):
                if guarded:
                    ok = self._update_factors(first_update, loss=loss)
                else:
                    self._update_factors(first_update=first_update)
            self._factors_initialized = True
        elif guarded:
            ok = self._health_verdict(loss)
        if update_inverses:
            # Recorded first: the refresh draws its low-rank sketches
            # for this step, and a checkpoint keeps it to draw them again.
            self._last_inv_step = self._steps
            with self._scope('eigh_refresh'):
                self._refresh(self.damping)
            self._iter_bootstrapped = True
        elif shard is not None:
            with self._scope(f'eigh_refresh/shard{shard}'):
                self._refresh_shard(self.damping, shard)
        if ok is not None:
            # JAX _health_finish_step: the skip counter and the verdict;
            # the gradients are zeroed by the precondition below.
            h = self._health_state()
            h.steps_skipped = h.steps_skipped + (~ok).to(torch.int32)
            h.last_step_ok = ok
        # The verdict is passed only under health, so the unguarded call
        # keeps its signature.
        extra = {} if ok is None else {'step_ok': ok}
        if monitor:
            extra['return_info'] = True
        with collect, self._scope('precondition'):
            out = self._precondition(
                self.damping, self.kl_clip, self.lr, **extra,
            )
        vg_sum, obs_info = out if monitor else (out, {})
        info = {'vg_sum': vg_sum}
        if self._observe is not None:
            info.update(self._step_info_static())
        if ok is not None:
            info.update(health_lib.step_info(self._health_state()))
        if monitor:
            info.update(obs_info)
            info.update(self._observe_state_stats(self.damping))
        if check:
            # Over the final state: what the next cadence window
            # preconditions through.
            with self._scope('consistency'):
                self.last_consistency_check = self._consistency_check({
                    'damping': self.damping,
                    'factor_decay': self.factor_decay,
                    'kl_clip': self.kl_clip, 'lr': self.lr,
                })
            info.update(self.last_consistency_check.info())
        if self._adaptive_controller is not None and update_factors:
            # The factor EMAs move only on factor steps.
            with self._scope('adaptive'):
                drift = self._adaptive_drift_emit()
            if drift:
                self._adaptive_last_drift = (
                    drift['adaptive/sketch'], drift['adaptive/digest'],
                )
                info.update(drift)
        self._overlap_commit(pending)
        if update_inverses:
            self._stagger_bootstrapped = True
            self._overlap_bootstrapped = True
        # After the bootstrap flags: a repair's forced bootstrap must not
        # be undone by the refresh bookkeeping of this step.
        info = self._consistency_finish(info)
        if deferred is not None:
            self._last_refresh = (
                'overlap_inv' if deferred[0] == 'inv'
                else f'overlap_shard{deferred[1]}'
            )
        else:
            self._last_refresh = 'full' if update_inverses else shard
        divergence = self._ekfac_divergence() if update_factors else None
        if divergence is not None:
            info['ekfac_divergence'] = divergence
        self._last_step_info = self._adaptive_finish(info)
        step_index = self._steps
        self._steps += 1
        self._post_step_refresh_feed(
            divergence, step_index, update_factors,
            update_inverses or deferred is not None,
        )
        # Arm (or disarm) the hooks for the NEXT forward/backward.
        self._arm_capture(self._step_gating()[0])
        if pending is not None and self._overlap_pending is not None:
            # The issue point: after the counter moved, so the deferred
            # refresh takes the next step's damping, as the JAX refresh
            # reads the hyperparameters of the program it runs in.
            self._overlap_inflight = self._issue_deferred_refresh(
                pending, self.damping,
            )

    def _consistency_due(self) -> bool:
        """Whether this step ends with a cross-replica check (every
        ``cadence``-th step; never without the guard)."""
        c = self._consistency
        return c is not None and self._steps % c.cadence == 0

    def _consistency_finish(
        self, info: dict[str, torch.Tensor],
    ) -> dict[str, torch.Tensor]:
        """Walk the repair ladder after a check (JAX ``engine.py:
        963-1075``); ``info`` as it is on other steps.

        The verdict is already on the host (the check's one read).  On a
        state mismatch: with ``repair='broadcast'`` the canonical replica
        of every divergent surface is broadcast, and the next refresh is
        forced to a monolithic bootstrap (the stagger, warm-start and
        deferral flags drop, a pending deferred refresh is dropped);
        then per slot the strikes of consecutive disagreeing checks are
        noted, and a slot that crosses ``quarantine_after`` is
        quarantined to SGD.  A hyperparameter-only mismatch is counted,
        never repaired (host values).  Every rank walks the same ladder
        from the same verdicts.  Adds ``consistency/*_total`` and
        ``consistency/strikes_max``, and counts ``tracing`` events."""
        cfg = self._consistency
        if cfg is None or 'consistency/mismatches' not in info:
            return info
        # The cross-process commit point: every rank is about to walk the
        # same ladder from the same verdict (its repairs are collective).
        runtime.commit_point('consistency/host_sync')
        result = self.last_consistency_check
        ladder = self._consistency_ladder
        totals = self._consistency_totals
        totals['checks'] += 1
        mismatches = int(info['consistency/mismatches'])
        hp_mismatches = int(info['consistency/hp_mismatches'])
        if mismatches == 0:
            ladder.reset_all()
        elif mismatches == hp_mismatches:
            totals['detections'] += 1
            tracing.count_event('consistency_mismatch')
            tracing.count_event('consistency_hp_mismatch')
        else:
            totals['detections'] += 1
            tracing.count_event('consistency_mismatch')
            if hp_mismatches:
                tracing.count_event('consistency_hp_mismatch')
            if cfg.repair == 'broadcast':
                layer_mask, bucket_masks = self._consistency_repair(result)
                totals['repairs'] += 1
                tracing.count_event('consistency_repair')
                self._stagger_bootstrapped = False
                self._iter_bootstrapped = False
                self._overlap_bootstrapped = False
                self._overlap_pending = None
            else:
                layer_mask, bucket_masks, _ = consistency_lib.mismatch_masks(
                    result)
            for i, name in enumerate(result.layer_names):
                ladder.note(('layer', name), bool(layer_mask[i]))
            for i, key in enumerate(result.basis_keys):
                ladder.note(('basis', key), bool(result.basis_mask[i]))
            crossed = {}
            for key, mask in bucket_masks.items():
                q = np.zeros(mask.shape, bool)
                for slot in range(mask.shape[0]):
                    if ladder.note(('bucket', key, slot), bool(mask[slot])):
                        q[slot] = True
                if q.any():
                    crossed[key] = q
            if crossed:
                self._consistency_quarantine(crossed)
                totals['quarantines'] += int(
                    sum(int(m.sum()) for m in crossed.values()))
                tracing.count_event('consistency_quarantine')
        info = dict(info)
        info.update({
            f'consistency/{k}_total': torch.tensor(v, dtype=torch.int32)
            for k, v in totals.items()
        })
        info['consistency/strikes_max'] = torch.tensor(
            ladder.max_strikes(), dtype=torch.int32)
        return info

    def _adaptive_finish(
        self, info: dict[str, torch.Tensor],
    ) -> dict[str, torch.Tensor]:
        """The adaptive cadence's decision counters added to the step's
        info (JAX ``_adaptive_finish``, ``engine.py:895-918``); ``info``
        as it is without the controller."""
        ctl = self._adaptive_controller
        if ctl is None:
            return info
        totals = ctl.counters()
        for name in ('skipped', 'early', 'forced', 'scheduled'):
            info[f'adaptive/{name}_total'] = totals[name]
        info['adaptive/budget_clamped_total'] = totals['budget_clamped']
        for k in range(ctl.n_shards):
            info[f'adaptive/shard{k}/skipped'] = ctl.skipped[k]
            info[f'adaptive/shard{k}/early'] = ctl.early[k]
            info[f'adaptive/shard{k}/forced'] = ctl.forced[k]
            info[f'adaptive/shard{k}/age'] = ctl.ages[k]
        return info

    def _warn_adaptive_unfed(self, path: str) -> None:
        """One-time warning (JAX ``engine.py:1902-1920``): an
        AdaptiveDamping adapts only on the fused path, where the updated
        parameters are visible; on ``step()`` the optimizer update
        happens outside the engine, so the controller must be fed by
        hand, and silently frozen damping is the failure this flags."""
        if self._adaptive_damping is None or self._warned_adaptive_unfed:
            return
        self._warned_adaptive_unfed = True
        logger.warning(
            'damping=AdaptiveDamping(...) is not auto-fed on the %s '
            'path (the engine never sees the updated parameters). '
            'Either use make_train_step()/train_loop(), or call '
            'controller.update(observed_reduction, predicted_reduction) '
            'yourself each interval using last_step_info["vg_sum"] '
            '(predicted = (-lr + lr**2/2) * vg_sum); otherwise damping '
            'stays frozen at its current value.', path,
        )

    # -- the fused training path ------------------------------------------

    def make_train_step(
        self,
        optimizer: torch.optim.Optimizer,
        loss_fn: Callable[..., Any],
        merge_updates: Any = None,
    ) -> Callable[..., tuple[torch.Tensor, Any]]:
        """The K-FAC step and the optimizer step in one call (JAX
        ``make_train_step``, ``engine.py:2027-2125``).

        ``loss_fn(model_output, *loss_args)`` returns the loss or
        ``(loss, aux)``, as the JAX ``loss_fn`` does.  The returned
        ``train_step(*args, loss_args=()) -> (loss, aux)`` runs, in
        order: ``optimizer.zero_grad()``, the forward ``model(*args)``
        (through the ``DistributedDataParallel`` wrapper when the
        preconditioner was given one), the backward, :meth:`step`'s body
        and ``optimizer.step()``; then it feeds an
        :class:`~kfac_pytorch_tpu_torch.adaptive.AdaptiveDamping` in the
        ``damping`` slot at its adaptation steps (:meth:`_maybe_adapt_\
damping`).  The returned loss is the step's (detached), before the
        update.

        JAX's ``merge_updates`` has no counterpart: BatchNorm's running
        statistics update in place during the forward.  Gradient
        accumulation runs through the backward passes and :meth:`step`
        (``accumulation_steps > 1`` raises here, as in JAX).

        Under health a step whose verdict fails leaves the parameters,
        the optimizer state and BatchNorm's running buffers bitwise as
        they were (JAX ``engine.py:1982-2020``): the buffers are
        snapshotted before the forward, the verdict is read on the host
        once a step (``health_host_syncs``), and on a bad step
        ``optimizer.step()`` is not run and the buffers are restored.
        """
        if merge_updates is not None:
            raise NotImplementedError(
                'merge_updates has no counterpart in the PyTorch package: '
                "a module's mutable state (BatchNorm's running statistics) "
                'updates in place during the forward, so there is nothing '
                'to merge',
            )
        def train_step(*args: Any, loss_args: tuple = ()):
            return self._timed(run, args, loss_args)

        def run(args: tuple, loss_args: tuple):
            if getattr(self, 'accumulation_steps', 1) != 1:
                raise RuntimeError(
                    'make_train_step runs one forward and backward per '
                    'step: with accumulation_steps > 1 run the backward '
                    'passes yourself and call step()',
                )
            optimizer.zero_grad()
            guarded = self._health_config() is not None
            saved = self._buffer_snapshot() if guarded else None
            with self._scope('capture' if self._step_gating()[0]
                             else 'forward_backward'):
                loss, aux = self._forward_backward(args, loss_args, loss_fn)
            step_index = self._steps
            self._step(loss=loss.detach())
            if not guarded:
                optimizer.step()
            else:
                self._health_host_syncs += 1
                if bool(self._health_state().last_step_ok):
                    optimizer.step()
                else:
                    bufs, copies = saved
                    if bufs:
                        torch._foreach_copy_(bufs, copies)
            loss = loss.detach()
            self._maybe_adapt_damping(
                step_index, loss, self._last_step_info, args, loss_args,
                loss_fn,
            )
            return loss, aux

        return train_step

    def _forward_backward(
        self, args: tuple, loss_args: tuple, loss_fn: Callable[..., Any],
    ) -> tuple[torch.Tensor, Any]:
        """The fused step's forward and backward, ``(loss, aux)``: the
        flavour hook of JAX's ``_loss_grads_and_captured`` and
        ``_loss_and_grads_plain`` (the capture records only when armed,
        on factor steps).  The bucketed engine runs ``model(*args)``
        (through the ``DistributedDataParallel`` wrapper when given one)
        and ``loss.backward()``; the MoE and pipeline flavours
        (:mod:`kfac_pytorch_tpu_torch.gpt`) run their own."""
        loss, aux = _split_loss(
            loss_fn(self._train_module(*args), *loss_args))
        loss.backward()
        return loss, aux

    def train_loop(
        self,
        optimizer: torch.optim.Optimizer,
        loss_fn: Callable[..., Any],
        merge_updates: Any = None,
    ) -> 'KFACTrainLoop':
        """The fused path as a loop object (JAX ``train_loop``,
        ``engine.py:2127``)::

            loop = precond.train_loop(optimizer, loss_fn)
            for x, y in batches:
                loss, aux = loop.step(x, loss_args=(y,))
            model_sd, optimizer_sd, kfac_sd = loop.carry
        """
        return KFACTrainLoop(self, optimizer, loss_fn, merge_updates)

    @torch.no_grad()
    def _buffer_snapshot(self) -> tuple[list, list]:
        """``(buffers, copies)`` of the buffers a training-mode forward
        moves, the copies by one ``_foreach_mul`` by 1 per dtype (bitwise;
        a few launches instead of one per buffer)."""
        bufs = self._bn_buffers()
        copies: list = [None] * len(bufs)
        groups: dict = {}
        for i, b in enumerate(bufs):
            groups.setdefault((b.device, b.dtype), []).append(i)
        for idx in groups.values():
            for i, c in zip(idx, torch._foreach_mul(
                    [bufs[i] for i in idx], 1)):
                copies[i] = c
        return bufs, copies

    @torch.no_grad()
    def _loss_only(
        self, args: tuple, loss_args: tuple, loss_fn: Callable[..., Any],
    ) -> torch.Tensor:
        """The loss at the current (updated) parameters on ``args``, with
        no gradient, no capture and no trace in the model's state: the
        capture is switched off for the forward, and the buffers a
        training-mode forward moves (BatchNorm's running statistics and
        counters) are restored bit for bit afterwards, as Flax's
        loss-only pass discards its batch-stat updates.  The forward
        runs the bare module, not a ``DistributedDataParallel`` wrapper,
        so it issues no collective of its own."""
        module = self._capture_module()
        saved = [(b, b.clone()) for b in self._bn_buffers()]
        armed = self._capture_armed(False)
        try:
            loss, _ = _split_loss(loss_fn(module(*args), *loss_args))
        finally:
            self._capture_armed(armed)
            for b, v in saved:
                b.copy_(v)
        return loss.detach()

    def _maybe_adapt_damping(
        self,
        step_index: int,
        loss_before: torch.Tensor,
        info: Mapping[str, torch.Tensor],
        args: tuple,
        loss_args: tuple,
        loss_fn: Callable[..., Any],
    ) -> None:
        """Feed the LM controller at its adaptation steps (JAX
        ``engine.py:1930-1961``).

        Observed reduction: the same batch's loss at the updated
        parameters (:meth:`_loss_only`) minus the step's loss.  Predicted
        reduction: ``(-lr + lr^2/2) * vg_sum`` from the damped quadratic
        model, with the ``lr`` of the step that made the update (the
        counter has already moved).  Across ranks every rank feeds the
        controller the same numbers (:meth:`_adapt_inputs`) and keeps the
        same damping.
        """
        ad = self._adaptive_damping
        if ad is None or not ad.should_adapt(step_index):
            return
        losses = torch.stack([
            loss_before.float().reshape(()),
            self._loss_only(args, loss_args, loss_fn).float().reshape(()),
        ])
        before, after, vg_sum = self._adapt_inputs(losses, info['vg_sum'])
        lr = float(resolve(self._lr, step_index))
        predicted = (-lr + 0.5 * lr * lr) * vg_sum
        ad.update(after - before, predicted)

    def _adapt_inputs(
        self, losses: torch.Tensor, vg_sum: torch.Tensor,
    ) -> tuple[float, float, float]:
        """``(loss before, loss after, vg_sum)`` on the host, the same on
        every rank: each rank's losses are of its own batch, so both are
        averaged over the world (one all-reduce)."""
        if dist.is_available() and dist.is_initialized():
            dist.all_reduce(losses)
            losses = losses / dist.get_world_size()
        before, after = losses.tolist()
        return before, after, float(vg_sum)

    def _post_step_refresh_feed(
        self,
        divergence: torch.Tensor | None,
        step_index: int,
        update_factors: bool,
        update_inverses: bool,
    ) -> None:
        """Feed the drift controller after a step
        (``_post_step_refresh_feed``, ``engine.py:1368-1390``): a
        refresh clears a pending request and resets the controller's
        clock; after a factor step the drift, read back to the host only
        when a controller is set, may request the next refresh."""
        if divergence is not None:
            self._last_ekfac_divergence = divergence
        ar = self._adaptive_refresh
        if update_inverses:
            self._refresh_requested = False
            if ar is not None:
                ar.note_refresh(step_index)
        if ar is None or not update_factors or divergence is None:
            return
        if ar.update(float(divergence), step_index):
            self._refresh_requested = True

    # -- checkpoints ----------------------------------------------------

    def state_dict(
        self,
        include_factors: bool = True,
        compress_symmetric: bool = False,
        include_ekfac_scales: bool = False,
        include_topology: bool = False,
    ) -> dict[str, Any]:
        """A checkpointable dict, in the JAX payload's keys.

        ``steps``, ``sketch_step`` (the last inverse-update step, whose
        sketches a restore draws again), the non-callable
        hyperparameters, the drift controller's state
        (``adaptive_refresh``) and the adaptive cadence's counters
        (``adaptive``) when they are set, and, with
        ``include_factors``, ``layers: {name: {'A', 'G'}}`` — CPU
        tensors, or with ``compress_symmetric`` packed upper triangles
        ``{'triu', 'dim'}``.  ``include_ekfac_scales`` also keeps the
        EKFAC scale grids by bucket key (``ekfac_scales``), so a resume
        continues their EMA instead of reseeding it; they live in the
        basis of the saved factors, so this needs ``include_factors``.
        ``include_topology`` records the world and bucket layout under
        ``topology``, which a mismatched restore names.  Across ranks
        every rank holds the same averaged factor EMAs, so every rank's
        dict is the same.
        """
        sd: dict[str, Any] = {
            'steps': self._steps,
            'sketch_step': self._last_inv_step,
        }
        save_hyperparams(self, sd)
        if include_topology:
            sd['topology'] = self._topology_descriptor()
        if self._adaptive_refresh is not None:
            sd['adaptive_refresh'] = self._adaptive_refresh.state_dict()
        if self._adaptive_controller is not None:
            # Counters only: ages and references describe the live
            # stacks, which a restore recomputes.
            sd['adaptive'] = self._adaptive_controller.state_dict()
        if include_factors:
            # A helper with non-symmetric factors keeps them dense: the
            # restore mirrors a packed upper triangle.
            sym = self._symmetric_layers()
            sd['layers'] = {
                base: {
                    'A': pack_factor(st.a_factor,
                                     compress_symmetric and base in sym),
                    'G': pack_factor(st.g_factor,
                                     compress_symmetric and base in sym),
                }
                for base, st in self._checkpoint_layer_states().items()
            }
        if include_ekfac_scales:
            if not include_factors:
                raise ValueError(
                    'include_ekfac_scales requires include_factors: the '
                    'scales live in the eigenbasis of the saved factors',
                )
            scales = self._ekfac_scales()
            if scales is None:
                raise ValueError(
                    'include_ekfac_scales: this preconditioner has no '
                    'EKFAC scale state (ekfac=False or unsupported '
                    'flavour)',
                )
            sd['ekfac_scales'] = {
                k: v.detach().cpu().clone() for k, v in scales.items()
            }
        return sd

    def load_state_dict(
        self,
        state_dict: Mapping[str, Any],
        compute_inverses: bool = True,
    ) -> None:
        """Restore from :meth:`state_dict` (or from a JAX checkpoint
        carried across by :func:`~kfac_pytorch_tpu_torch.convert.
        jax_kfac_state_dict_to_torch`).

        Factor EMAs load by layer name.  With ``compute_inverses`` the
        second-order state is recomputed at once, the iterative method
        at its bootstrap depth, after which its refreshes run warm;
        without, the next refresh runs at bootstrap depth.  Across ranks
        this is collective: every rank calls it, and the recompute runs
        the column gather.  The recompute draws the low-rank sketches of
        the saved ``sketch_step``, so it reproduces the decompositions
        the saving run held.  A staggered engine then resumes on the
        shard cadence (the recompute is its bootstrap); without the
        recompute its next due refresh is monolithic.  The adaptive
        cadence keeps its counters and restarts its ages and references.
        Saved EKFAC scales are installed after it
        (and rejected without ``compute_inverses``: they need the
        recomputed basis).  The capture hooks are re-armed for the next
        step.  Micro-batch sums are not checkpointed (as in the JAX
        package); a restore drops them, a pending drift-triggered
        refresh and a pending deferred refresh (``overlap_comm``: its
        work is joined and discarded); the next due refresh defers only
        if the restore recomputed.
        """
        scales = state_dict.get('ekfac_scales')
        if scales is not None and not compute_inverses:
            raise ValueError(
                'state_dict carries ekfac_scales but '
                'compute_inverses=False: the scales can only be applied '
                'on top of a recomputed basis',
            )
        ar_sd = state_dict.get('adaptive_refresh')
        if ar_sd is not None and self._adaptive_refresh is not None:
            self._adaptive_refresh.load_state_dict(ar_sd)
        self._refresh_requested = False
        # Consistency strikes count consecutive live checks; a restore
        # replaces the state, so the streak restarts (JAX engine.py:2620).
        if self._consistency_ladder is not None:
            self._consistency_ladder.reset_all()
        # A pending deferred refresh was scheduled against the state
        # before the restore: it is dropped, never checkpointed (JAX
        # engine.py:2599-2604), and the restore invariant below decides
        # whether the next due refresh may defer.
        self._overlap_drop()
        ctl = self._adaptive_controller
        if ctl is not None:
            # Ages and references never survive a restore; the counters
            # are run statistics and do (engine.py:2605-2616).
            ctl.reset()
            if state_dict.get('adaptive') is not None:
                ctl.load_state_dict(state_dict['adaptive'])
            self._adaptive_last_drift = None
        self.reset_batch()
        layers = begin_load_state_dict(
            self, state_dict, self._checkpoint_layer_states(),
            compute_inverses,
        )
        if layers is not None:
            self._restore_factors(layers)
            self._factors_initialized = True
            h = self._health_state()
            if h is not None:
                # The restored EMAs are running averages: the next factor
                # step must not reseed them from the identity (JAX
                # engine.py:2629-2640).
                h.factor_updates_applied = torch.clamp(
                    h.factor_updates_applied, min=1)
            if compute_inverses:
                self._iter_bootstrapped = False
                self._refresh(self.damping)
                if scales is not None:
                    self._restore_ekfac_scales(scales)
            # The restore invariant: only a restore-time recompute lets
            # the shard cadence and the warm start resume; otherwise the
            # next due refresh is the monolithic bootstrap.
            self._iter_bootstrapped = post_restore_bootstrapped(
                full_recompute=compute_inverses,
            )
            self._stagger_bootstrapped = post_restore_bootstrapped(
                full_recompute=compute_inverses,
            )
            self._overlap_bootstrapped = post_restore_bootstrapped(
                full_recompute=compute_inverses,
            )
        self._arm_capture(self._step_gating()[0])

    def _restore_ekfac_scales(self, scales: Mapping[str, Any]) -> None:
        """Check saved scale grids against this configuration's both
        ways (a slot left at the reseed would be an unsignalled mixed
        state; ``engine.py:1300-1337``) and install them."""
        current = self._ekfac_scale_shapes()
        missing = set(current) - set(scales)
        if missing:
            raise ValueError(
                'ekfac_scales: saved dict does not cover bucket(s) '
                f'{sorted(missing)} present in this configuration (layer '
                'set / bucket plan changed?)',
            )
        for name, saved in scales.items():
            slot = current.get(name)
            if slot is None:
                raise ValueError(
                    'ekfac_scales: no EKFAC scale slot for bucket '
                    f'{name!r} in this configuration',
                )
            if tuple(slot) != tuple(np.shape(saved)):
                raise ValueError(
                    f'ekfac_scales: shape mismatch for bucket {name!r}: '
                    f'saved {tuple(np.shape(saved))} vs state '
                    f'{tuple(slot)}',
                )
        self._with_ekfac_scales(scales)

    # -- hooks the preconditioner provides ------------------------------

    def _arm_capture(self, on: bool) -> None:
        raise NotImplementedError

    def _update_factors(self, first_update: bool) -> None:
        raise NotImplementedError

    def reset_batch(self) -> None:
        raise NotImplementedError

    def _refresh(self, damping: float) -> None:
        raise NotImplementedError

    def _precondition(
        self, damping: float, kl_clip: float | None, lr: float,
    ) -> None:
        raise NotImplementedError

    def _checkpoint_layer_states(self) -> Mapping[str, Any]:
        raise NotImplementedError

    def _restore_factors(self, layers: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def _topology_descriptor(self) -> str | None:
        raise NotImplementedError

    def _ekfac_divergence(self) -> torch.Tensor | None:
        return None

    def _symmetric_layers(self) -> set[str]:
        return set(self._checkpoint_layer_states())

    def _refresh_shard(self, damping: float, shard: int) -> None:
        raise NotImplementedError

    def _stagger_shard_empty(self, shard: int) -> bool:
        return False

    def _issue_deferred_refresh(self, pending: tuple, damping: float) -> Any:
        raise NotImplementedError

    def _install_refresh(self, state: Any) -> None:
        raise NotImplementedError

    def _adaptive_drift_emit(self) -> dict[str, torch.Tensor]:
        return {}

    def _capture_module(self) -> torch.nn.Module:
        raise NotImplementedError

    def _capture_armed(self, on: bool) -> bool:
        raise NotImplementedError

    def _bn_buffers(self) -> list[torch.Tensor]:
        return []

    def _health_config(self) -> Any:
        return None

    def _health_state(self) -> Any:
        return None

    def _health_verdict(self, loss: torch.Tensor | None) -> torch.Tensor:
        raise NotImplementedError

    def _consistency_check(self, hp: dict[str, float]) -> Any:
        raise NotImplementedError

    def _consistency_repair(self, result: Any) -> Any:
        raise NotImplementedError

    def _consistency_quarantine(self, masks: dict) -> None:
        raise NotImplementedError

    def _ekfac_scales(self) -> Mapping[str, torch.Tensor] | None:
        return None

    def _step_info_static(self) -> dict[str, torch.Tensor]:
        return {}

    def _observe_state_stats(self, damping: float) -> dict[str, Any]:
        return {}

    def _ekfac_scale_shapes(self) -> Mapping[str, tuple[int, ...]]:
        return {}

    def _with_ekfac_scales(self, scales: Mapping[str, Any]) -> None:
        raise NotImplementedError


def _split_loss(result: Any) -> tuple[torch.Tensor, Any]:
    """``loss_fn``'s result as ``(loss, aux)``, ``aux`` ``None`` when it
    returned the loss alone (JAX ``base_preconditioner.py:1495-1498``)."""
    if isinstance(result, tuple):
        return result
    return result, None


def training_extras(
    model: torch.nn.Module, optimizer: torch.optim.Optimizer,
) -> dict[str, torch.Tensor]:
    """The model's ``state_dict()`` (``model/<name>``) and the tensors of
    the optimizer's per-parameter state (``opt/<index>/<key>``, the index
    counting the parameters of every group in order), as the flat
    ``extras`` of a streaming generation: references, nothing copied."""
    out = {f'model/{k}': v for k, v in model.state_dict().items()}
    params = [p for g in optimizer.param_groups for p in g['params']]
    for i, p in enumerate(params):
        for k, v in optimizer.state.get(p, {}).items():
            if isinstance(v, torch.Tensor):
                out[f'opt/{i}/{k}'] = v
    return out


@torch.no_grad()
def load_training_extras(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    extras: Mapping[str, torch.Tensor],
) -> None:
    """Load :func:`training_extras` back: the model strictly, and each
    parameter's optimizer state tensors (a parameter whose state the
    extras do not hold loses its tensors, as it had none then)."""
    model.load_state_dict({k[len('model/'):]: v for k, v in extras.items()
                           if k.startswith('model/')})
    params = [p for g in optimizer.param_groups for p in g['params']]
    saved: dict[int, dict[str, torch.Tensor]] = {}
    for k, v in extras.items():
        if k.startswith('opt/'):
            _, i, key = k.split('/', 2)
            saved.setdefault(int(i), {})[key] = v
    for i, p in enumerate(params):
        state = optimizer.state.get(p)
        if state is None:
            if i not in saved:
                continue
            state = optimizer.state[p] = {}
        for key in [k for k, v in state.items()
                    if isinstance(v, torch.Tensor) and k not in
                    saved.get(i, {})]:
            del state[key]
        for key, v in saved.get(i, {}).items():
            live = state.get(key)
            if isinstance(live, torch.Tensor) and live.shape == v.shape:
                live.copy_(v)
            else:
                state[key] = v.to(p.device).clone()


class KFACTrainLoop:
    """The fused training path as a loop (JAX ``KFACTrainLoop``,
    ``engine.py:2746-2899``).

    The JAX loop carries ``(variables, opt_state, kfac_state)`` as a flat
    tuple of leaves so each step dispatches one compiled program.  Torch
    keeps that state in place, in the model, the optimizer and the
    preconditioner, so there is no carry to build: :meth:`step` is
    :meth:`KFACEngineMixin.make_train_step`'s step, the same code, and
    :attr:`carry` returns the three state dicts.

    With a trajectory watchdog the loop feeds it after every step
    (:meth:`KFACEngineMixin.watchdog_step`, with the model and optimizer
    state as the generation's extras, :func:`training_extras`) and loads
    a rollback's extras back into the model and the optimizer, which the
    JAX loop leaves to its caller; :attr:`last_rollback` holds the
    latest rollback's info.  With a flight recorder the loop then feeds
    it the step's loss (:meth:`KFACEngineMixin.flight_step`).
    """

    def __init__(
        self,
        precond: KFACEngineMixin,
        optimizer: torch.optim.Optimizer,
        loss_fn: Callable[..., Any],
        merge_updates: Any = None,
    ) -> None:
        if getattr(precond, 'accumulation_steps', 1) != 1:
            raise RuntimeError(
                'train_loop runs one forward and backward per step: with '
                'accumulation_steps > 1 run the backward passes yourself '
                'and call step()',
            )
        self._precond = precond
        self._optimizer = optimizer
        self._step_fn = precond.make_train_step(
            optimizer, loss_fn, merge_updates,
        )
        self.last_rollback: dict[str, Any] | None = None

    def step(self, *args: Any, loss_args: tuple = ()) -> tuple[Any, Any]:
        """One fused K-FAC + optimizer step; returns ``(loss, aux)``.
        With a watchdog, the step then feeds it, and a rollback loads the
        restored model and optimizer state back."""
        loss, aux = self._step_fn(*args, loss_args=loss_args)
        p = self._precond
        if p.watchdog is not None:
            model = p._capture_module()
            rolled = p.watchdog_step(
                loss, extras=lambda: training_extras(model, self._optimizer),
            )
            if rolled is not None:
                self.last_rollback = rolled
                if rolled.get('extras') is not None:
                    load_training_extras(model, self._optimizer,
                                         rolled['extras'])
        p.flight_step(loss)
        return loss, aux

    @property
    def carry(self) -> tuple[dict, dict, dict]:
        """``(model state dict, optimizer state dict, preconditioner
        state dict)``."""
        p = self._precond
        return (p._capture_module().state_dict(),
                self._optimizer.state_dict(), p.state_dict())
