"""K-FAC preconditioner core, on one device or data-parallel.

Port of the bucketed path of ``BaseKFACPreconditioner``
(``kfac_pytorch_tpu/base_preconditioner.py``): registration through
:class:`~kfac_pytorch_tpu_torch.capture.ModelCapture`, per-layer factor
EMAs, the bucketed second-order stage on the KAISA grid (eigen,
inverse or iterative), the write-back of the preconditioned gradients
into each layer's ``.grad``, and the checkpoint hooks of the engine.
State lives on the device of the model's parameters.

Across ranks the world is the default ``torch.distributed`` group, and
every rank is assumed to differentiate the mean loss of its own local
batch, as under ``DistributedDataParallel``.  Its captured output
gradients are then ``world`` times those of the global batch's mean
loss, so they are scaled by ``1 / world`` before the G covariance; the
factors of every rank are then averaged before the EMA, which gives the
global batch's factors when the local batches have equal size (checked
on every factor update).
"""
from __future__ import annotations

import logging

import torch

from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.engine import KFACEngineMixin
from kfac_pytorch_tpu_torch.engine import unpack_factor
from kfac_pytorch_tpu_torch.enums import ComputeMethod
from kfac_pytorch_tpu_torch.parallel import collectives
from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan
from kfac_pytorch_tpu_torch.parallel.mesh import kaisa_grid
from kfac_pytorch_tpu_torch.parallel.second_order import BucketedSecondOrder
from kfac_pytorch_tpu_torch.state import LayerKFACState
from kfac_pytorch_tpu_torch.state import init_layer_state

logger = logging.getLogger(__name__)


class BaseKFACPreconditioner(KFACEngineMixin):
    """K-FAC over the layers a :class:`ModelCapture` registered.

    Attributes:
        layers: layer name -> :class:`LayerKFACState` (the factor EMAs).
        grid: this rank's place on the KAISA grid
            (:class:`~kfac_pytorch_tpu_torch.parallel.mesh.KaisaGrid`).
        plan: the bucket plan, with ``grid.cols`` columns.
        buckets: bucket key -> this rank's stacked decompositions
            (:class:`~kfac_pytorch_tpu_torch.parallel.second_order.\
BucketSecond`).
        last_kl_scale: the kl-clip scale applied by the latest step
            (a device scalar), or ``None`` with ``kl_clip=None``.
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
        factor_dtype: torch.dtype = torch.float32,
        inv_dtype: torch.dtype = torch.float32,
        precond_dtype: torch.dtype = torch.float32,
        cov_dtype: torch.dtype | None = None,
        grad_worker_fraction: float = 1.0,
        compute_method: ComputeMethod = ComputeMethod.EIGEN,
        prediv_eigenvalues: bool = True,
        iterative_config: ops.IterativeConfig | None = None,
        loglevel: int = logging.DEBUG,
    ) -> None:
        self._capture = capture
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
        self.layers: dict[str, LayerKFACState] = {
            name: init_layer_state(
                h.a_factor_shape[0], h.g_factor_shape[0],
                factor_dtype=factor_dtype, device=self.device,
            )
            for name, h in self.helpers.items()
        }
        self.grid = kaisa_grid(grad_worker_fraction)
        self.plan = make_bucket_plan(self.helpers, n_cols=self.grid.cols)
        self._second_order = BucketedSecondOrder(
            self.plan, compute_method=compute_method,
            prediv_eigenvalues=prediv_eigenvalues,
            iterative_config=iterative_config, inv_dtype=inv_dtype,
            precond_dtype=precond_dtype, device=self.device, grid=self.grid,
        )
        self.iterative_config = self._second_order.iterative
        self.buckets = self._second_order.init_buckets()
        self.last_kl_scale: torch.Tensor | None = None
        self._init_engine(
            factor_update_steps=factor_update_steps,
            inv_update_steps=inv_update_steps,
            damping=damping,
            factor_decay=factor_decay,
            kl_clip=kl_clip,
            lr=lr,
        )

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

    @torch.no_grad()
    def _update_factors(self, first_update: bool) -> None:
        """Fold this step's captured statistics into the factor EMAs.

        A module applied several times contributes the mean of its
        per-call factors.  Captures are cast to ``cov_dtype`` before the
        covariance; factors are kept in ``factor_dtype``.  Across ranks
        the output gradients are scaled by ``1 / world`` and the new
        factors are averaged over the world (one fused all-reduce).
        """
        captured = self._capture.take()
        decay = self.factor_decay
        world = self.grid.world
        new_a, new_g, rows = [], [], []
        for name, helper in self.helpers.items():
            acts, grads = captured[name]
            if world > 1:
                grads = [g / world for g in grads]
            new_a.append(torch.stack([
                helper.get_a_factor(a.to(self.cov_dtype))
                .to(self.factor_dtype) for a in acts
            ]).mean(0))
            new_g.append(torch.stack([
                helper.get_g_factor(g.to(self.cov_dtype))
                .to(self.factor_dtype) for g in grads
            ]).mean(0))
            rows.append(sum(a.shape[0] for a in acts))
        if world > 1:
            # The row counts and their squares ride in the all-reduce
            # (f64: exact sums), so every rank reaches the same verdict:
            # world * sum(r^2) == sum(r)^2 iff every rank's r is equal.
            counts = torch.tensor(
                rows + [r * r for r in rows], dtype=torch.float64,
                device=self.device,
            )
            *factors, counts = collectives.all_reduce_mean(
                new_a + new_g + [counts],
            )
            sums = [round(v * world) for v in counts.tolist()]
            n = len(rows)
            if any(world * s2 != s1 * s1
                   for s1, s2 in zip(sums[:n], sums[n:])):
                raise RuntimeError(
                    'local batch sizes differ across ranks (this rank: '
                    f'{rows}, sum over ranks: {sums[:n]}); K-FAC across '
                    'ranks needs equal local batches',
                )
            new_a, new_g = factors[:len(new_a)], factors[len(new_a):]
        for name, a_new, g_new in zip(self.helpers, new_a, new_g):
            st = self.layers[name]
            st.a_factor = ops.ema_update_factor(
                st.a_factor, a_new, decay, first_update,
            )
            st.g_factor = ops.ema_update_factor(
                st.g_factor, g_new, decay, first_update,
            )

    @torch.no_grad()
    def _refresh(self, damping: float) -> None:
        """Recompute the bucketed second-order state; the iterative
        method warm-starts from the current roots."""
        self.buckets = self._second_order.compute(
            self.layers, damping, prev=self.buckets,
            bootstrap=self._refresh_needs_bootstrap(),
        )

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
    ) -> None:
        """Precondition every registered layer's ``.grad`` in place."""
        combined = {
            name: helper.get_grad() for name, helper in self.helpers.items()
        }
        out, scale = self._second_order.precondition(
            self.buckets, combined, damping, kl_clip, lr,
        )
        for name, helper in self.helpers.items():
            helper.set_grad(out[name])
        self.last_kl_scale = scale

    def _checkpoint_layer_states(self) -> dict[str, LayerKFACState]:
        return self.layers

    @torch.no_grad()
    def _restore_factors(self, layers) -> None:
        """Load checkpointed factor EMAs onto ``self.device`` in
        ``factor_dtype``."""
        for base, factors in layers.items():
            st = self.layers[base]
            st.a_factor = unpack_factor(
                factors['A'], self.factor_dtype, self.device,
            )
            st.g_factor = unpack_factor(
                factors['G'], self.factor_dtype, self.device,
            )

    def _topology_descriptor(self) -> str:
        """World and bucket layout, e.g. ``'world=4 grid=2x2
        buckets=[a576g64:10 slots, ...]'``, which a mismatched restore
        names."""
        buckets = ', '.join(
            f'{b.key}:{b.n_slots} slots' for b in self.plan.buckets
        )
        return (
            f'world={self.grid.world} grid={self.grid.rows}x'
            f'{self.grid.cols} buckets=[{buckets}]'
        )

    def memory_usage(self) -> dict[str, int]:
        """Bytes of K-FAC state on this rank: the factor EMAs and this
        rank's slice of the stacked decompositions."""
        sizes = {
            'a_factors': sum(
                st.a_factor.numel() * st.a_factor.element_size()
                for st in self.layers.values()
            ),
            'g_factors': sum(
                st.g_factor.numel() * st.g_factor.element_size()
                for st in self.layers.values()
            ),
            'second_order': self._second_order.memory_usage(self.buckets),
        }
        sizes['total'] = sum(sizes.values())
        return sizes
