"""The K-FAC step engine: cadence, hyperparameters and the step body.

Port of the single-device core of ``KFACEngineMixin``
(``kfac_pytorch_tpu/engine.py``).  The JAX engine dispatches one of four
compiled programs per step; here the step body runs eagerly, in the
order of ``engine.py:1463-1556``:

1. on factor-update steps, factor contributions from the captured
   activations and output gradients, folded into the EMAs (the first
   update starts from the identity);
2. on inverse-update steps, the bucketed eigendecomposition refresh;
3. every step, preconditioning of each layer's gradient and one global
   kl-clip scale, written back into the layers' ``.grad``.

The call sequence is PyTorch's: ``loss.backward(); precond.step();
optimizer.step()``.
"""
from __future__ import annotations

from typing import Callable

from kfac_pytorch_tpu_torch.hyperparams import resolve
from kfac_pytorch_tpu_torch.hyperparams import validate_damping


class KFACEngineMixin:
    """Step cadence and hyperparameter resolution.

    Subclasses provide ``_update_factors(first_update)``,
    ``_refresh(damping)`` and ``_precondition(kl_clip, lr)``,
    and arm their capture through ``_arm_capture(bool)``.
    """

    def _init_engine(
        self,
        *,
        factor_update_steps: Callable[[int], int] | int,
        inv_update_steps: Callable[[int], int] | int,
        damping: Callable[[int], float] | float,
        factor_decay: Callable[[int], float] | float,
        kl_clip: Callable[[int], float] | float | None,
        lr: Callable[[int], float] | float,
    ) -> None:
        if not callable(damping):
            validate_damping(damping)
        self._factor_update_steps = factor_update_steps
        self._inv_update_steps = inv_update_steps
        self._damping = damping
        self._factor_decay = factor_decay
        self._kl_clip = kl_clip
        self._lr = lr
        self._steps = 0
        self._factors_initialized = False
        self._arm_capture(self._step_gating()[0])

    @property
    def steps(self) -> int:
        """Completed :meth:`step` calls."""
        return self._steps

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
        (decomposing zeros is meaningless).
        """
        fus = self.factor_update_steps
        ius = self.inv_update_steps
        update_factors = fus > 0 and self._steps % fus == 0
        update_inverses = (
            ius > 0
            and self._steps % ius == 0
            and (self._factors_initialized or update_factors)
        )
        return update_factors, update_inverses

    def step(self) -> None:
        """Precondition the gradients now in the registered layers'
        ``.grad`` (call after ``backward()``, before the optimizer)."""
        update_factors, update_inverses = self._step_gating()
        if update_factors:
            self._update_factors(first_update=not self._factors_initialized)
            self._factors_initialized = True
        if update_inverses:
            self._refresh(self.damping)
        self._precondition(self.kl_clip, self.lr)
        self._steps += 1
        # Arm (or disarm) the hooks for the NEXT forward/backward.
        self._arm_capture(self._step_gating()[0])

    # -- hooks the preconditioner provides ------------------------------

    def _arm_capture(self, on: bool) -> None:
        raise NotImplementedError

    def _update_factors(self, first_update: bool) -> None:
        raise NotImplementedError

    def _refresh(self, damping: float) -> None:
        raise NotImplementedError

    def _precondition(self, kl_clip: float | None, lr: float) -> None:
        raise NotImplementedError
