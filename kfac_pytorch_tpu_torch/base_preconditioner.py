"""Single-device K-FAC preconditioner core.

Port of the bucketed single-device path of ``BaseKFACPreconditioner``
(``kfac_pytorch_tpu/base_preconditioner.py``): registration through
:class:`~kfac_pytorch_tpu_torch.capture.ModelCapture`, per-layer factor
EMAs, the bucketed second-order stage, and the write-back of the
preconditioned gradients into each layer's ``.grad``.  State lives on
the device of the model's parameters.
"""
from __future__ import annotations

import logging

import torch

from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.engine import KFACEngineMixin
from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan
from kfac_pytorch_tpu_torch.parallel.second_order import BucketedSecondOrder
from kfac_pytorch_tpu_torch.state import LayerKFACState
from kfac_pytorch_tpu_torch.state import init_layer_state

logger = logging.getLogger(__name__)


class BaseKFACPreconditioner(KFACEngineMixin):
    """K-FAC over the layers a :class:`ModelCapture` registered.

    Attributes:
        layers: layer name -> :class:`LayerKFACState` (the factor EMAs).
        buckets: bucket key -> stacked decompositions
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
        loglevel: int = logging.DEBUG,
    ) -> None:
        self._capture = capture
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
        self.plan = make_bucket_plan(self.helpers, n_cols=1)
        self._second_order = BucketedSecondOrder(
            self.plan, inv_dtype=inv_dtype,
            precond_dtype=precond_dtype, device=self.device,
        )
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
        covariance; factors are kept in ``factor_dtype``.
        """
        captured = self._capture.take()
        decay = self.factor_decay
        for name, helper in self.helpers.items():
            acts, grads = captured[name]
            a_new = torch.stack([
                helper.get_a_factor(a.to(self.cov_dtype))
                .to(self.factor_dtype) for a in acts
            ]).mean(0)
            g_new = torch.stack([
                helper.get_g_factor(g.to(self.cov_dtype))
                .to(self.factor_dtype) for g in grads
            ]).mean(0)
            st = self.layers[name]
            st.a_factor = ops.ema_update_factor(
                st.a_factor, a_new, decay, first_update,
            )
            st.g_factor = ops.ema_update_factor(
                st.g_factor, g_new, decay, first_update,
            )

    @torch.no_grad()
    def _refresh(self, damping: float) -> None:
        """Recompute the bucketed eigendecompositions."""
        self.buckets = self._second_order.compute(self.layers, damping)

    @torch.no_grad()
    def _precondition(self, kl_clip: float | None, lr: float) -> None:
        """Precondition every registered layer's ``.grad`` in place."""
        combined = {
            name: helper.get_grad() for name, helper in self.helpers.items()
        }
        out, scale = self._second_order.precondition(
            self.buckets, combined, kl_clip, lr,
        )
        for name, helper in self.helpers.items():
            helper.set_grad(out[name])
        self.last_kl_scale = scale
