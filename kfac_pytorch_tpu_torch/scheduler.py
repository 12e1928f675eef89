"""Hyperparameter scheduling and the iterative method's warm-start rule.

Port of part of ``kfac_pytorch_tpu/scheduler.py``:
:func:`iterative_refresh_iters` (``:614-634``),
:func:`post_restore_bootstrapped` (``:472-500``, the inputs a restore
through ``load_state_dict`` needs) and :class:`LambdaParamScheduler`
(``:637-734``, without the ``stagger_refresh`` clause: staggering is not
ported).
"""
from __future__ import annotations

from typing import Any, Callable

_INT_PARAMS = ('factor_update_steps', 'inv_update_steps')


def post_restore_bootstrapped(*, full_recompute: bool) -> bool:
    """Whether a just-restored engine may run the short warm-started
    Newton–Schulz refresh next.

    Only when every slot verifiably holds a converged root: a full
    restore-time recompute (itself run at bootstrap depth) qualifies; a
    restore without one does not, and the next refresh runs at bootstrap
    depth.  (The JAX function's other inputs describe the verbatim root
    installs and resizes of the elastic restore, which is not ported.)
    """
    return bool(full_recompute)


def iterative_refresh_iters(config: Any, bootstrapped: bool) -> int:
    """Newton–Schulz iterations of the next refresh:
    ``config.bootstrap_iters`` for the first refresh of a run and the
    first after a restore without a recompute, ``config.warm_iters``
    after that.

    Args:
        config: an :class:`~kfac_pytorch_tpu_torch.ops.iterative.
            IterativeConfig`.
        bootstrapped: the engine's warm-start flag
            (``precond._iter_bootstrapped``).
    """
    return config.warm_iters if bootstrapped else config.bootstrap_iters


class LambdaParamScheduler:
    """Multiplicative lambda scheduler for K-FAC hyperparameters.

    Each lambda maps the preconditioner's step count to a factor that
    multiplies the stored constant value; step intervals are cast to
    ``int`` and kept ``>= 1``.  Call :meth:`step` after
    ``preconditioner.step()``.

    Raises:
        ValueError: for a lambda on a parameter that is already a
            callable on the preconditioner (the two scheduling idioms
            exclude each other), or on one that is ``None`` (disabled).
    """

    def __init__(
        self,
        preconditioner: Any,
        *,
        factor_update_steps_lambda: Callable[[int], float] | None = None,
        inv_update_steps_lambda: Callable[[int], float] | None = None,
        damping_lambda: Callable[[int], float] | None = None,
        factor_decay_lambda: Callable[[int], float] | None = None,
        kl_clip_lambda: Callable[[int], float] | None = None,
        lr_lambda: Callable[[int], float] | None = None,
    ) -> None:
        self._preconditioner = preconditioner
        self._lambdas: dict[str, Callable[[int], float]] = {}
        provided = {
            'factor_update_steps': factor_update_steps_lambda,
            'inv_update_steps': inv_update_steps_lambda,
            'damping': damping_lambda,
            'factor_decay': factor_decay_lambda,
            'kl_clip': kl_clip_lambda,
            'lr': lr_lambda,
        }
        for name, lam in provided.items():
            if lam is None:
                continue
            current = getattr(preconditioner, f'_{name}')
            if callable(current):
                raise ValueError(
                    f'preconditioner.{name} is already a callable and '
                    'cannot be updated by the LambdaParamScheduler.',
                )
            if current is None:
                raise ValueError(
                    f'preconditioner.{name} is None (disabled) and '
                    'cannot be scheduled.',
                )
            self._lambdas[name] = lam

    def step(self, step: int | None = None) -> None:
        """Scale the scheduled hyperparameters in place.

        Args:
            step: the step passed to the lambdas (default: the
                preconditioner's step count).
        """
        at = step if step is not None else self._preconditioner.steps
        for name, lam in self._lambdas.items():
            new = getattr(self._preconditioner, f'_{name}') * lam(at)
            if name in _INT_PARAMS:
                new = max(1, int(new))
            setattr(self._preconditioner, f'_{name}', new)
