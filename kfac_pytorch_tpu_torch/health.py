"""Numerical-health guardrails: verdicts, recovery, self-healing state.

Port of ``kfac_pytorch_tpu/health.py``.  K-FAC's second-order state is
fragile: one non-finite batch poisons the factor EMAs through the
running average, and one failed ``eigh`` (an ill-conditioned factor in
f32) corrupts the preconditioner for every later step.  The policies,
wired into the engine (:mod:`kfac_pytorch_tpu_torch.engine`) and the
bucketed second-order stage
(:mod:`kfac_pytorch_tpu_torch.parallel.second_order`):

1. **step-skip** — a non-finite loss/gradient/factor-contribution
   verdict skips both the factor-EMA update and the parameter update.
   On :meth:`~kfac_pytorch_tpu_torch.engine.KFACEngineMixin.step` the
   EMAs and the gradients are selected with ``torch.where`` on the
   device verdict (no host read); the fused path
   (``make_train_step``/``train_loop``) reads the verdict once a step to
   decide whether ``optimizer.step()`` runs.
2. **per-slot quarantine with damping escalation** — a slot whose
   ``eigh``/Cholesky output goes non-finite retries with escalated
   jitter (bounded attempts; exact for symmetric factors: ``eigh(A + jI)
   == (d + j, Q)``), falls back to the last-good decomposition, and
   after ``quarantine_after`` consecutive failures is quarantined to
   identity preconditioning (plain SGD for that layer) while the rest
   of the model keeps K-FAC.  A later successful refresh lifts it.
3. **factor self-healing** — a factor EMA that went non-finite anyway
   (a poisoned checkpoint, f32 overflow) is reset to its identity seed
   at refresh time.

The JAX module runs the retry rounds under ``lax.cond`` on the device;
the eager port decides each round on the host, one boolean read per
round (:func:`run_with_recovery`'s ``stats['host_reads']``).  The no-fault
path reads once per bucket and runs no retry.  The counters are device
scalars (:class:`HealthState`) surfaced through ``last_step_info``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

__all__ = [
    'EscalationLadder',
    'HealthConfig',
    'HealthState',
    'init_health_state',
    'tree_all_finite',
    'array_all_finite',
    'stacked_all_finite',
    'run_with_recovery',
    'merge_with_prev',
    'step_info',
    'HEALTH_INFO_KEYS',
    'TERMINAL_TRIGGER_COUNTERS',
    'terminal_triggers',
    'zero_unless',
]


class EscalationLadder:
    """Host-side consecutive-failure ladder (JAX ``health.py:66-152``).

    N consecutive failures of the same unit cross a threshold; any
    success resets the count.  The cross-replica consistency guard
    (:mod:`kfac_pytorch_tpu_torch.consistency`) tracks its per-slot
    disagreement strikes here.  Keys are arbitrary hashables
    (``('bucket', key, slot)``, ``('layer', name)``).  :meth:`note`
    returns True exactly when this failure made the unit CROSS the
    threshold.  ``reset_all(prefix=...)`` clears only the keys under a
    prefix, so consumers sharing one instance keep their histories
    apart; ``reset_all()`` clears everything.
    """

    def __init__(self, threshold: int) -> None:
        if threshold < 1:
            raise ValueError('threshold must be >= 1')
        self.threshold = threshold
        self.strikes: dict[Any, int] = {}

    def note(self, key: Any, failed: bool) -> bool:
        """Record one verdict for ``key``; True on threshold crossing."""
        if not failed:
            self.strikes.pop(key, None)
            return False
        n = self.strikes.get(key, 0) + 1
        self.strikes[key] = n
        return n == self.threshold

    def strikes_for(self, key: Any) -> int:
        """Current consecutive-failure count of one unit (0 = clean)."""
        return self.strikes.get(key, 0)

    def reset(self, key: Any) -> None:
        """Clear one unit's consecutive count."""
        self.strikes.pop(key, None)

    def reset_all(self, prefix: tuple | None = None) -> None:
        """A fully clean check: every count restarts, or with ``prefix``
        only the tuple keys whose leading elements equal it."""
        if prefix is None:
            self.strikes.clear()
            return
        n = len(prefix)
        for key in [
            k for k in self.strikes
            if isinstance(k, tuple) and k[:n] == tuple(prefix)
        ]:
            del self.strikes[key]

    def max_strikes(self) -> int:
        return max(self.strikes.values(), default=0)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Static knobs of the numerical-health subsystem (JAX
    ``health.py:155-200``).

    Passing an instance (even ``HealthConfig()``) to a preconditioner
    enables the guardrails; ``None`` (the default) keeps the unguarded
    engine with no added state or work.

    Args:
        max_eigh_retries: bounded retry attempts per decomposition
            failure, each with escalated jitter; the no-fault path runs
            none.
        jitter_scale: the first retry adds ``jitter_scale * damping`` to
            the factor diagonal; for ``eigh`` the shift is subtracted
            back out exactly, for Cholesky and Newton–Schulz it is extra
            Tikhonov damping.
        jitter_growth: multiplicative escalation per retry.
        quarantine_after: consecutive failed refreshes before a slot is
            quarantined to identity preconditioning.  A successful
            refresh resets the count and lifts the quarantine.
        inject_eigh_failures: TESTING ONLY — the first N decomposition
            attempts of every refresh return NaN.
        inject_eigh_layers: TESTING ONLY — restrict injection to
            ``(bucket_key, slot)`` pairs, slots indexed in the whole
            bucket stack (``precond.plan.slot_of[name]``); ``None`` =
            every slot.
    """

    max_eigh_retries: int = 2
    jitter_scale: float = 10.0
    jitter_growth: float = 10.0
    quarantine_after: int = 3
    inject_eigh_failures: int = 0
    inject_eigh_layers: tuple[tuple[str, int], ...] | None = None

    def __post_init__(self) -> None:
        if self.max_eigh_retries < 0:
            raise ValueError('max_eigh_retries must be >= 0')
        if self.jitter_scale <= 0 or self.jitter_growth <= 0:
            raise ValueError('jitter_scale/jitter_growth must be > 0')
        if self.quarantine_after < 1:
            raise ValueError('quarantine_after must be >= 1')


@dataclasses.dataclass
class HealthState:
    """Device-side recovery counters (0-d tensors; JAX ``health.py:
    203-249``).

    ``factor_updates_applied`` drives the ``first_update`` decision on
    the device: if the very first factor batch is skipped as non-finite,
    the next good batch still seeds the EMA from the identity.
    """

    steps_skipped: torch.Tensor           # i32: cumulative bad batches
    last_step_ok: torch.Tensor            # bool: this step's verdict
    factor_updates_applied: torch.Tensor  # i32: EMA updates applied
    eigh_retries: torch.Tensor            # i32: retry rounds run
    eigh_fallbacks: torch.Tensor          # i32: slot refreshes that fell back
    factor_resets: torch.Tensor           # i32: non-finite EMAs reset
    quarantined_layers: torch.Tensor      # i32: slots quarantined now


def init_health_state(device: torch.device | str = 'cpu') -> HealthState:
    """Zeroed counters (``last_step_ok`` starts True), each its own
    buffer."""
    def zero():
        return torch.zeros((), dtype=torch.int32, device=device)

    return HealthState(
        steps_skipped=zero(),
        last_step_ok=torch.ones((), dtype=torch.bool, device=device),
        factor_updates_applied=zero(),
        eigh_retries=zero(),
        eigh_fallbacks=zero(),
        factor_resets=zero(),
        quarantined_layers=zero(),
    )


HEALTH_INFO_KEYS = (
    'health/step_ok',
    'health/steps_skipped',
    'health/factor_updates_applied',
    'health/eigh_retries',
    'health/eigh_fallbacks',
    'health/factor_resets',
    'health/quarantined_layers',
)


def step_info(h: HealthState) -> dict[str, torch.Tensor]:
    """``last_step_info`` entries for the recovery counters."""
    return {
        'health/step_ok': h.last_step_ok,
        'health/steps_skipped': h.steps_skipped,
        'health/factor_updates_applied': h.factor_updates_applied,
        'health/eigh_retries': h.eigh_retries,
        'health/eigh_fallbacks': h.eigh_fallbacks,
        'health/factor_resets': h.factor_resets,
        'health/quarantined_layers': h.quarantined_layers,
    }


#: Cumulative health counters whose increase is a terminal event: a
#: skipped step (the batch was thrown away) and a slot crossing into
#: quarantine.  Retries, fallbacks and resets are recoveries.
TERMINAL_TRIGGER_COUNTERS = {
    'health/steps_skipped': 'health_step_skip',
    'health/quarantined_layers': 'health_quarantine',
}


def terminal_triggers(
    prev: dict[str, float] | None,
    cur: dict[str, float],
) -> list[str]:
    """Trigger names between two ``health/*`` snapshots (host floats);
    ``prev=None`` counts every counter from zero.  Order follows
    :data:`TERMINAL_TRIGGER_COUNTERS`."""
    fired = []
    for key, name in TERMINAL_TRIGGER_COUNTERS.items():
        if key not in cur:
            continue
        before = 0.0 if prev is None else float(prev.get(key, 0.0))
        if float(cur[key]) > before:
            fired.append(name)
    return fired


# ----------------------------------------------------------------------
# verdicts
# ----------------------------------------------------------------------


def array_all_finite(x: torch.Tensor) -> torch.Tensor:
    """0-d bool: every element of one tensor is finite (integer and bool
    tensors are finite by construction)."""
    if not (x.is_floating_point() or x.is_complex()):
        return torch.ones((), dtype=torch.bool, device=x.device)
    return torch.isfinite(x).all()


def _leaves(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def tree_all_finite(
    tree: Any, device: torch.device | str | None = None,
) -> torch.Tensor:
    """0-d bool: every float tensor of a nested structure (tensors,
    dicts, lists, tuples, dataclasses) is finite.

    One fused reduction, not a launch per tensor: the max-abs of every
    tensor by ``torch._foreach_norm(ord=inf)`` (per device and dtype),
    then one ``isfinite`` over the stacked maxima.  A max-abs is finite
    exactly when every element is (NaN and inf propagate into it; no
    finite value overflows a max).  ``device`` places the result when
    the structure holds no float tensor."""
    groups: dict[tuple, list[torch.Tensor]] = {}
    for t in _leaves(tree):
        if t.is_floating_point() and t.numel() > 0:
            groups.setdefault((t.device, t.dtype), []).append(t)
    if not groups:
        return torch.ones((), dtype=torch.bool, device=device)
    ok = None
    for (dev, _), ts in groups.items():
        norms = torch._foreach_norm(ts, ord=float('inf'))
        verdict = torch.isfinite(torch.stack(norms)).all()
        if device is not None:
            verdict = verdict.to(device)
        ok = verdict if ok is None else ok & verdict.to(ok.device)
    return ok


def stacked_all_finite(
    arrays: Sequence[torch.Tensor], n_layers: int,
) -> torch.Tensor:
    """``[n_layers]`` bool: per-slot finiteness of leading-L stacks."""
    ok = None
    for a in arrays:
        fin = torch.isfinite(a).reshape(n_layers, -1).all(dim=1)
        ok = fin if ok is None else ok & fin
    if ok is None:
        return torch.ones((n_layers,), dtype=torch.bool)
    return ok


# ----------------------------------------------------------------------
# bounded-retry recovery (one host read per round)
# ----------------------------------------------------------------------


def _corrupt(
    outputs: tuple[torch.Tensor, ...],
    attempt: int,
    cfg: HealthConfig,
    inject_mask: np.ndarray | None,
    n_layers: int | None,
) -> tuple[torch.Tensor, ...]:
    """Fault injection: NaN the float outputs of attempt ``attempt``.

    ``inject_mask`` (``[L]`` bool, host) restricts the corruption to
    slots; ``None`` corrupts every slot.  A no-op outside the configured
    attempt window, so production configs do no extra work."""
    if attempt >= cfg.inject_eigh_failures:
        return outputs
    if inject_mask is not None and not inject_mask.any():
        return outputs
    out = []
    for o in outputs:
        if not o.is_floating_point():
            # Integer evidence (unconverged-iteration counters) has no
            # NaN; the float outputs carry the corruption.
            out.append(o)
            continue
        if inject_mask is None or n_layers is None:
            out.append(torch.full_like(o, float('nan')))
        else:
            mask = torch.as_tensor(inject_mask, device=o.device).reshape(
                (n_layers,) + (1,) * (o.ndim - 1),
            )
            out.append(torch.where(mask, torch.full_like(o, float('nan')),
                                   o))
    return tuple(out)


def run_with_recovery(
    attempt_fn: Callable[[float], tuple[torch.Tensor, ...]],
    damping: float,
    cfg: HealthConfig,
    *,
    n_layers: int | None = None,
    inject_mask: np.ndarray | None = None,
    verdict_fn: Callable[[tuple[torch.Tensor, ...]], torch.Tensor]
    | None = None,
    stats: dict[str, int] | None = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """Run a decomposition with bounded, escalating retries (JAX
    ``health.py:393-486``).

    Args:
        attempt_fn: ``jitter -> outputs``, the decomposition at a
            diagonal jitter (``0.0`` is the plain attempt, which callers
            run exactly as the unguarded path).  Outputs share leading
            dim ``n_layers`` when given.
        damping: current damping; retry ``i`` uses ``damping *
            jitter_scale * jitter_growth**i`` (rounded in f32, as JAX).
        cfg: knobs (retry bound, escalation, injection).
        n_layers: leading stack dim for per-slot verdicts, or ``None``
            for one whole-output verdict (the diagonal-A side path).
        inject_mask: host ``[n_layers]`` bool restricting injection.
        verdict_fn: custom success predicate over one attempt's outputs
            (the iterative method's residual gate; must be NaN-robust).
        stats: ``stats['host_reads']`` is increased by one for every
            host read of the verdict (one per round that could retry);
            with ``n_layers``, ``stats['slot_rounds']`` is set to the
            ``[n_layers]`` i32 count of rounds each slot went into still
            failing, whose maximum over a stack is ``retries``.

    Returns:
        ``(outputs, ok, retries)``: the outputs merged per slot across
        attempts (a slot keeps the first attempt that passed), the final
        verdict, and the retry rounds run (an i32 0-d tensor).  Slots
        still failing keep their non-finite values; callers fall back
        through :func:`merge_with_prev`.

    JAX decides each round with ``lax.cond(all(ok))``; here the host
    reads ``ok.all()`` before each round, so the no-fault path costs one
    decomposition, the verdict and one read.
    """

    def verdict(outs):
        if verdict_fn is not None:
            return verdict_fn(outs)
        if n_layers is None:
            return tree_all_finite(outs)
        return stacked_all_finite(outs, n_layers)

    outs = _corrupt(attempt_fn(0.0), 0, cfg, inject_mask, n_layers)
    ok = verdict(outs)
    retries = 0
    rounds = torch.zeros(ok.shape, dtype=torch.int32, device=ok.device)
    for i in range(cfg.max_eigh_retries):
        if stats is not None:
            stats['host_reads'] = stats.get('host_reads', 0) + 1
        if bool(ok.all()):
            break
        jitter = float(
            np.float32(damping)
            * np.float32(cfg.jitter_scale * cfg.jitter_growth ** i),
        )
        new = _corrupt(attempt_fn(jitter), i + 1, cfg, inject_mask,
                       n_layers)
        new_ok = verdict(new)
        if n_layers is None:
            merged = tuple(torch.where(ok, o, m) for o, m in zip(outs, new))
        else:
            merged = tuple(
                torch.where(ok.reshape((n_layers,) + (1,) * (o.ndim - 1)),
                            o, m)
                for o, m in zip(outs, new)
            )
        rounds = rounds + (~ok).to(torch.int32)
        outs, ok, retries = merged, ok | new_ok, retries + 1
    if stats is not None and n_layers is not None:
        stats['slot_rounds'] = rounds
    return outs, ok, torch.tensor(retries, dtype=torch.int32,
                                  device=ok.device)


#: The per-slot health fields of a bucket state, which
#: :func:`merge_with_prev` recomputes instead of selecting.
HEALTH_FIELDS = ('fail_count', 'quarantined', 'ever_ok')


def merge_with_prev(new: Any, prev: Any, ok: torch.Tensor,
                    cfg: HealthConfig) -> Any:
    """Per-slot fallback merge of a stacked decomposition dataclass
    (JAX ``health.py:489-525``).

    ``new``/``prev`` are same-type dataclasses whose tensor fields carry
    a leading slot dim (``BucketSecond``).  Slots with ``ok == False``
    keep ``prev``'s last-good decomposition (``torch.where`` never
    propagates NaN from the unselected side); ``fail_count``,
    ``quarantined`` and ``ever_ok`` are recomputed from consecutive
    failures.  A slot that fails with no prior success is quarantined at
    once: identity preconditioning is better than freezing the layer at
    the zero-initialized state."""
    kw: dict[str, torch.Tensor | None] = {}
    for f in dataclasses.fields(new):
        if f.name in HEALTH_FIELDS:
            continue
        n = getattr(new, f.name)
        if n is None:
            kw[f.name] = None
            continue
        p = getattr(prev, f.name)
        if p is None or p.shape[0] != ok.shape[0]:
            # A field without a per-slot leading dim (the EKFAC bases
            # of every occupied slot) is not a slot stack: new as is.
            kw[f.name] = n
            continue
        sel = ok.reshape(ok.shape + (1,) * (n.ndim - 1))
        kw[f.name] = torch.where(sel, n, p.to(n.dtype))
    one = torch.ones((), dtype=torch.int32, device=ok.device)
    fail = torch.where(ok, torch.zeros_like(one), prev.fail_count + one)
    ever_ok = prev.ever_ok | ok
    kw['fail_count'] = fail
    kw['quarantined'] = (fail >= cfg.quarantine_after) | (~ok & ~ever_ok)
    kw['ever_ok'] = ever_ok
    return type(new)(**kw)


def zero_unless(ok: torch.Tensor,
                tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``torch.where(ok, t, 0)`` of every tensor, with one select per
    device and dtype instead of one per tensor: the tensors are packed
    into a flat buffer, selected, and returned as views of it.  Bitwise
    ``t`` where ``ok`` (a step that passed its verdict), zeros otherwise
    (NaN does not leak from the unselected side)."""
    out: list[torch.Tensor | None] = [None] * len(tensors)
    groups: dict[tuple, list[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for (device, dtype), idx in groups.items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = torch.where(ok.to(device), flat,
                           torch.zeros((), dtype=dtype, device=device))
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out
