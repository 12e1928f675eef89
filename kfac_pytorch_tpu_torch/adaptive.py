"""Curvature-drift-driven eigenbasis refresh (EKFAC only).

Port of ``AdaptiveRefresh`` (``kfac_pytorch_tpu/adaptive.py:154-251``).
A fixed ``inv_update_steps`` answers "how stale is the basis?" with a
clock.  EKFAC's scale grid answers it with a measurement: ``skron``
starts at the refresh seed ``dg ⊗ da`` and drifts as the projected
gradient second moments move, so the relative Frobenius drift

    divergence = ||S - dg ⊗ da||_F / ||dg ⊗ da||_F

(masked to the logical factor dims; ``precond.last_ekfac_divergence``)
estimates how far the frozen basis is from the live curvature.  The
controller requests a refresh at the next step whenever the drift
exceeds :attr:`AdaptiveRefresh.threshold`, so ``inv_update_steps`` can
be large (a cost ceiling) and ``eigh`` runs when the curvature moved::

    precond = KFACPreconditioner(
        model, ekfac=True, inv_update_steps=1000,
        adaptive_refresh=AdaptiveRefresh(threshold=0.25, min_interval=10),
    )

The preconditioner feeds it after every factor step (the drift is read
back to the host there, and only when a controller is set).
"""
from __future__ import annotations

import math


class AdaptiveRefresh:
    """Requests an eigenbasis refresh when the EKFAC drift is large.

    Args:
        threshold: relative drift above which a refresh is requested.
        min_interval: least steps between refreshes (a noisy
            small-batch drift estimate must not re-trigger every step).
    """

    def __init__(
        self,
        threshold: float = 0.25,
        *,
        min_interval: int = 10,
    ) -> None:
        if threshold <= 0.0:
            raise ValueError(f'threshold must be > 0, got {threshold}')
        if min_interval < 1:
            raise ValueError(
                f'min_interval must be >= 1, got {min_interval}',
            )
        self.threshold = float(threshold)
        self.min_interval = int(min_interval)
        self._last_refresh = -1
        #: Last observed divergence (``None`` until the first factor step).
        self.divergence: float | None = None
        #: Drift-triggered refresh requests so far.
        self.triggers = 0

    def note_refresh(self, step: int) -> None:
        """Record a refresh at ``step`` (scheduled or triggered: both
        reset the drift clock)."""
        self._last_refresh = int(step)

    def update(self, divergence: float, step: int) -> bool:
        """Feed one drift reading; ``True`` requests a refresh at the
        next step."""
        self.divergence = divergence
        if not math.isfinite(divergence):
            return False
        if divergence <= self.threshold:
            return False
        if step - self._last_refresh < self.min_interval:
            return False
        self.triggers += 1
        return True

    def state_dict(self) -> dict:
        """The controller's state for a checkpoint.  The clock counts
        the preconditioner's steps, which the checkpoint keeps; without
        it a resume would restart the clock at ``-1`` and could refresh
        at once."""
        return {
            'last_refresh': self._last_refresh,
            'triggers': self.triggers,
            'divergence': self.divergence,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore from :meth:`state_dict` (missing keys keep the
        defaults)."""
        self._last_refresh = int(sd.get('last_refresh', -1))
        self.triggers = int(sd.get('triggers', 0))
        d = sd.get('divergence')
        self.divergence = None if d is None else float(d)

    def __repr__(self) -> str:
        d = self.divergence
        return (
            f'AdaptiveRefresh(threshold={self.threshold}, '
            f'min_interval={self.min_interval}, '
            f'divergence={None if d is None else round(d, 4)}, '
            f'triggers={self.triggers})'
        )
