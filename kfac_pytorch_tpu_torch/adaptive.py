"""Feedback controllers: Levenberg–Marquardt damping, the EKFAC
drift-triggered refresh and the per-layer drift feed of the adaptive
staggered refresh.

Port of ``AdaptiveDamping`` (``kfac_pytorch_tpu/adaptive.py:36-148``),
``AdaptiveRefresh`` (``:154-251``) and ``drift_info`` (``:272-394``),
with the port's own copy of the digest helpers of
``kfac_pytorch_tpu/consistency.py:167-262``.

:class:`AdaptiveDamping` is the LM rule of Martens & Grosse (2015,
§6.5): compare the *observed* loss change of a step with the change the
damped quadratic model *predicts*, and lower the damping when the model
is trustworthy (``rho`` near 1) or raise it when it is not.  With the
update ``delta = -lr * pg``, ``pg = (F + lambda I)^-1 g``,

    M(delta) - M(0) = -lr * <g, pg> + 0.5 * lr^2 * <pg, (F+lambda I) pg>
                    = (-lr + 0.5 * lr^2) * <g, pg>

because ``(F + lambda I) pg = g``; ``<g, pg>`` is
``precond.last_step_info['vg_sum']``.  (Under kl-clip the identity is
approximate.)  The controller is a callable ``(step) -> float``, so it
takes the ``damping`` slot; ``make_train_step`` and ``train_loop`` feed
it (one loss-only forward on the same batch every ``interval`` steps),
``step()`` does not, and says so once.
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

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist


class AdaptiveDamping:
    """LM damping controller: ``damping=AdaptiveDamping(...)``.

    Every :attr:`interval` steps the fused training path evaluates the
    loss at the updated parameters on the same batch and calls
    :meth:`update` with the observed and predicted reductions.  The rule
    (Martens & Grosse 2015, §6.5, eq. 32):

    * ``rho = observed / predicted``  (both negative for a good step)
    * ``rho > 3/4``  -> damping ``*= decay``  (model trusted; default
      ``decay = 0.95 ** interval`` mirrors the paper's per-step
      ``omega1`` applied once per adaptation window)
    * ``rho < 1/4``  -> damping ``/= decay``
    * otherwise unchanged.

    A non-finite or positive-predicted ratio (numerical trouble) raises
    damping, the conservative direction.

    Args:
        initial: starting damping value.
        interval: adaptation period in steps (T in the paper, their
            experiments use 5).  Each adaptation costs one loss-only
            forward; its share of a step on the card is measured by
            ``chip_smoke.py`` phase 19 (``PERF.md``).  Raise it to
            cheapen.
        decay: multiplicative decrease factor in (0, 1); ``None`` uses
            ``0.95 ** interval``.
        min_damping / max_damping: clamp bounds.
        lower / upper: the ``rho`` thresholds (1/4, 3/4 in the paper).
    """

    def __init__(
        self,
        initial: float = 0.001,
        *,
        interval: int = 5,
        decay: float | None = None,
        min_damping: float = 1e-8,
        max_damping: float = 10.0,
        lower: float = 0.25,
        upper: float = 0.75,
    ) -> None:
        if interval < 1:
            raise ValueError(f'interval must be >= 1, got {interval}')
        if decay is not None and not 0.0 < decay < 1.0:
            raise ValueError(f'decay must be in (0, 1), got {decay}')
        if not 0.0 < min_damping <= initial <= max_damping:
            raise ValueError(
                f'need 0 < min_damping <= initial <= max_damping, got '
                f'{min_damping} / {initial} / {max_damping}',
            )
        self._damping = float(initial)
        self.interval = int(interval)
        self.decay = float(decay) if decay is not None else 0.95 ** interval
        self.min_damping = float(min_damping)
        self.max_damping = float(max_damping)
        self.lower = float(lower)
        self.upper = float(upper)
        #: Last observed reduction ratio (None until the first update).
        self.rho: float | None = None

    @property
    def damping(self) -> float:
        return self._damping

    def __call__(self, step: int) -> float:
        """Callable-hyperparameter protocol: current damping value."""
        return self._damping

    def should_adapt(self, step: int) -> bool:
        """True when the engine should observe this step (0-indexed;
        step ``interval-1, 2*interval-1, ...`` so the first window has a
        full interval of training behind it)."""
        return (step + 1) % self.interval == 0

    def update(
        self,
        observed_reduction: float,
        predicted_reduction: float,
    ) -> float:
        """Apply the LM rule; returns the new damping value.

        Args:
            observed_reduction: ``f(theta + delta) - f(theta)``
                (negative when the step reduced the loss).
            predicted_reduction: ``M(delta) - M(0)`` from the damped
                quadratic model (see the module docstring), negative for
                any descent direction.
        """
        if (
            not math.isfinite(observed_reduction)
            or not math.isfinite(predicted_reduction)
            or predicted_reduction >= 0.0
        ):
            # Model predicts non-descent or numbers went bad: distrust.
            self.rho = None
            self._damping = min(
                self._damping / self.decay, self.max_damping,
            )
            return self._damping
        rho = observed_reduction / predicted_reduction
        self.rho = rho
        if rho > self.upper:
            self._damping = max(
                self._damping * self.decay, self.min_damping,
            )
        elif rho < self.lower:
            self._damping = min(
                self._damping / self.decay, self.max_damping,
            )
        return self._damping

    def __repr__(self) -> str:
        return (
            f'AdaptiveDamping(damping={self._damping:.3g}, '
            f'interval={self.interval}, decay={self.decay:.3g}, '
            f'rho={None if self.rho is None else round(self.rho, 4)})'
        )


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


# -- the drift feed of the adaptive staggered refresh --------------------
#
# Per layer, a digest of the factor-EMA state (exact: equal digests mean
# bitwise equal state) and an f32 sketch ``(fro², max-abs,
# ns_residual)``, which :class:`~kfac_pytorch_tpu_torch.scheduler.
# AdaptiveRefreshController` turns into a per-shard drift.  The digest
# is u32 arithmetic in the JAX package; torch has little of it, so the
# port holds each u32 value in an int64 and masks the modular sum to 32
# bits.

_NAN_SENTINEL = 1.5e38
_POSINF_SENTINEL = 2.5e38
_NEGINF_SENTINEL = -2.5e38
_U32 = 0xFFFFFFFF


def sanitize(x: torch.Tensor) -> torch.Tensor:
    """f32 copy of ``x`` with NaN and infinities mapped to finite
    sentinels (JAX ``consistency.sanitize``)."""
    return torch.nan_to_num(
        x.float(), nan=_NAN_SENTINEL, posinf=_POSINF_SENTINEL,
        neginf=_NEGINF_SENTINEL,
    )


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The f32 bit patterns of ``x`` as int32 (the u32 patterns modulo
    2^32)."""
    return x.float().contiguous().view(torch.int32)


def _maxabs_bits(s: torch.Tensor) -> torch.Tensor:
    """The bit pattern of ``max(|s|)`` (0 for an empty ``s``) as an
    int64; nonnegative f32 values order as their bit patterns do."""
    m = s.abs().max() if s.numel() else s.new_zeros(())
    return m.reshape(1).view(torch.int32).to(torch.int64)[0]


def array_digest(x: torch.Tensor) -> torch.Tensor:
    """``[2]`` int64 digest of one array (JAX ``array_digest``): the sum
    of the f32 bit patterns modulo 2^32 (any flipped bit changes it)
    and the bit pattern of the sanitized max-abs."""
    total = torch.sum(_bits(x), dtype=torch.int64) & _U32
    return torch.stack([total, _maxabs_bits(sanitize(x))])


def _fold(digests: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fold per-array digests: the sums add modulo 2^32, the maxes max."""
    out = digests[0]
    for d in digests[1:]:
        out = torch.stack([(out[0] + d[0]) & _U32, torch.maximum(out[1], d[1])])
    return out


def _array_fields(node: Any) -> list[tuple[str, torch.Tensor]]:
    """The set tensor fields of a state dataclass, sorted by name."""
    out = []
    for f in sorted(dataclasses.fields(node), key=lambda f: f.name):
        v = getattr(node, f.name)
        if isinstance(v, torch.Tensor):
            out.append((f.name, v))
    return out


def drift_info(
    layer_states: Mapping[str, Any],
    buckets: Mapping[str, Any],
    layouts: Sequence[Any],
    grid: Any = None,
) -> dict[str, torch.Tensor]:
    """Per-layer drift signals of the adaptive cadence (JAX
    ``adaptive.drift_info``), as device tensors:

    * ``adaptive/digest``: ``[n, 2]`` int64 holding u32 values, the
      ``(bit-pattern sum, max-abs)`` digest of each layer's factor-EMA
      state (every set field of its ``LayerKFACState``, sorted by name;
      a diagonal-A layer's decompositions included, as in JAX);
    * ``adaptive/sketch``: ``[n, 3]`` f32 ``(fro², max-abs,
      ns_residual)``, the last the layer's Newton–Schulz residual under
      ``compute_method='iterative'`` (its bucket slot's, the larger of
      the A and G sides), else 0;
    * ``adaptive/checked``: a 1, the emission marker.

    Layers go in ``sorted(layer_states)`` order.  ``buckets`` are this
    rank's stacks of the bucket ``layouts`` (its grid column's slots).
    Across ranks (``grid.world > 1``) both ride one ``all_reduce(MAX)``
    of their int64 view over the world (the sketch as its f32 bit
    patterns, which order as the nonnegative values do): it assembles
    the residuals of every column and gives every rank the same
    decision inputs.
    """
    names = tuple(sorted(layer_states))
    n = len(names)
    world = 1 if grid is None else grid.world
    if n == 0:
        if world > 1:
            raise ValueError(
                'drift_info: no layer to digest on a grid of '
                f'{world} ranks (an empty drift feed would make every '
                "rank's adaptive decision blind)",
            )
        return {}
    row_of = {name: i for i, name in enumerate(names)}
    col = 0 if grid is None else grid.col
    digests, fro2, mx = [], [], []
    for name in names:
        arrays = [a for _, a in _array_fields(layer_states[name])]
        digests.append(_fold([array_digest(a) for a in arrays]))
        s = [sanitize(a) for a in arrays]
        total = None
        for v in s:
            term = torch.sum(v * v)
            total = term if total is None else total + term
        fro2.append(total)
        mx.append(torch.max(torch.stack([
            v.abs().max() if v.numel() else v.new_zeros(()) for v in s
        ])))
    device = fro2[0].device
    residual = torch.zeros(n + 1, device=device)  # row n: dropped
    for b in layouts:
        bs = buckets[b.key]
        if getattr(bs, 'iter_res_a', None) is None:
            continue
        rows = torch.tensor(
            [row_of.get(s, n) if s is not None else n
             for s in b.column_slots(col)],
            device=device,
        )
        res = torch.maximum(bs.iter_res_a, bs.iter_res_g).float()
        residual = residual.scatter_reduce(0, rows, res, reduce='amax')
    digest = torch.stack(digests)
    sketch = torch.stack(
        [torch.stack(fro2), torch.stack(mx), residual[:n]], dim=1,
    ).float()
    if world > 1:
        vec = torch.cat([
            digest.reshape(-1),
            sketch.contiguous().view(torch.int32).to(torch.int64)
            .reshape(-1),
        ])
        dist.all_reduce(vec, op=dist.ReduceOp.MAX)
        digest = vec[:2 * n].reshape(n, 2)
        sketch = vec[2 * n:].to(torch.int32).view(torch.float32).reshape(n, 3)
    return {
        'adaptive/checked': torch.ones((), dtype=torch.int32, device=device),
        'adaptive/digest': digest,
        'adaptive/sketch': sketch,
    }
