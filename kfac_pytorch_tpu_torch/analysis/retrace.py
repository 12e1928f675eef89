"""Retrace guard: program accounting at the engine's dispatch point.

Port of ``kfac_pytorch_tpu/analysis/retrace.py``.  The JAX engine
compiles one program per step variant and dispatches it through a
program cache; the port runs its step eagerly, but keeps the same
dispatch point (``KFACEngineMixin._dispatch``, JAX's ``_cached_jit``)
and JAX's cache keys: a tuple per step variant (``(update_factors,
update_inverses, refresh_shard, deferred, check_consistency)``), a
string per service call (``'restore_refresh'``, ``'loss_only'``), and
JAX's tuples ``('consistency', 'repair' | 'masks' | 'quarantine')`` for
the consistency guard's repair ladder.  What a variant reads (the
registered layers' gradients, the factor and decomposition state, the
canonical hyperparameters) is its program's input, so an engine with ``factor_update_steps=F`` and
``inv_update_steps=I`` runs its declared variants over inputs of one
abstract signature each, and a compiled consumer of those inputs (the
precondition tail under ``torch.compile``) compiles exactly once per
variant.  A drifting dtype, a ragged batch or a Python-number
hyperparameter shows up here first.

:class:`RetraceGuard` makes that a checked property, with JAX's
semantics:

* every dispatch records the abstract signature of its inputs
  (:mod:`kfac_pytorch_tpu_torch.analysis.signature`) under its key;
* a new key is a **new-static-key** event; a new signature under a
  known key is a **retrace** event with a per-leaf diff;
* ``strict=True`` raises :class:`RetraceError` on any retrace, and a
  ``budget`` raises :class:`CompileBudgetError` (with the registry) when
  the step-variant programs would exceed it.  String keys are service
  programs: recorded and retrace-checked, never counted in the budget.
  The guard enforces before it records, and before the dispatch runs,
  so a retried drifted dispatch raises again.

Attach with ``precond.enable_retrace_guard(...)`` or :func:`attach_guard`,
or declare ``KFACPreconditioner(..., compile_budget=N)``.  Detached, the
dispatch point gathers no inputs and calls the step: no cost and the
same bits.  Attached, it only observes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from kfac_pytorch_tpu_torch.analysis.signature import (
    LeafSig,
    SigDiff,
    abstract_signature,
    diff_signatures,
    format_diffs,
)

__all__ = [
    'CompileBudgetError',
    'CompileEvent',
    'JitCache',
    'RetraceError',
    'RetraceGuard',
    'attach_guard',
    'detach_guard',
]


class RetraceError(RuntimeError):
    """A known program's inputs changed signature (strict guard)."""


class CompileBudgetError(RuntimeError):
    """The step-variant programs exceeded the declared budget."""


@dataclasses.dataclass(frozen=True)
class CompileEvent:
    """One new program the guard observed.

    ``kind`` is ``'new-static-key'`` (the first signature under a new
    key: a step variant running for the first time) or ``'retrace'`` (a
    new signature under a known key: expected never; ``diffs`` names
    the changed leaves against the closest recorded signature).
    """

    key: Any
    kind: str
    diffs: tuple[SigDiff, ...] = ()

    def format(self) -> str:
        head = f'[{self.kind}] key={self.key!r}'
        if not self.diffs:
            return head
        return head + '\n' + format_diffs(list(self.diffs))


class RetraceGuard:
    """Records programs per dispatch key; enforces budget and strictness.

    Args:
        budget: most distinct step-variant programs (tuple keys;
            ``None``: unlimited).  String-keyed service programs are
            recorded and retrace-checked but not counted: a restore must
            not abort halfway through an engine whose budget states its
            step variants.  Exceeding it raises
            :class:`CompileBudgetError`, naming the event that tipped it
            and the whole registry, before the program is recorded.
        strict: raise :class:`RetraceError` on any retrace, with the
            per-leaf diff, before the drifted dispatch runs; a retry of
            the same drifted dispatch raises again.
    """

    def __init__(
        self, budget: int | None = None, strict: bool = False,
    ) -> None:
        if budget is not None and budget < 1:
            raise ValueError('budget must be >= 1')
        self.budget = budget
        self.strict = strict
        # key -> {fingerprint: signature}
        self._variants: dict[Any, dict[tuple, dict[str, LeafSig]]] = {}
        self.events: list[CompileEvent] = []
        # (key, fingerprint) of strict raises already logged: a retried
        # drift raises every time but logs one event.
        self._strict_seen: set[tuple] = set()

    @property
    def compiles(self) -> int:
        """Distinct programs observed (every key, services included)."""
        return sum(len(v) for v in self._variants.values())

    @property
    def retraces(self) -> int:
        return sum(1 for e in self.events if e.kind == 'retrace')

    def variants(self, key: Any) -> int:
        """Distinct signatures recorded under one key."""
        return len(self._variants.get(key, {}))

    def keys(self) -> list[Any]:
        """The recorded keys, in first-dispatch order."""
        return list(self._variants)

    @staticmethod
    def _is_service_key(key: Any) -> bool:
        """Whether a key names a service program (a string): the restore
        refresh, the loss-only forward, the consistency repair; step
        variants are tuples."""
        return isinstance(key, str)

    def observe_call(self, key: Any, args: tuple, kwargs: dict) -> None:
        """Record one dispatch; enforcement comes first, so a raise
        leaves the registry as it was and ``compiles`` never counts a
        program the raise prevented."""
        wrapped = dict(
            {f'arg{i}': a for i, a in enumerate(args)},
            **{f'kwarg:{k}': v for k, v in kwargs.items()},
        )
        sig = abstract_signature(wrapped)
        fp = tuple(sig.items())
        entry = self._variants.get(key)
        if entry is not None and fp in entry:
            return
        if entry is None:
            event = CompileEvent(key, 'new-static-key')
            self._check_budget(event, key)
            self.events.append(event)
            self._variants[key] = {fp: sig}
            return
        diffs = min(
            (diff_signatures(prev, sig) for prev in entry.values()),
            key=len,
        )
        event = CompileEvent(key, 'retrace', tuple(diffs))
        if self.strict:
            if (key, fp) not in self._strict_seen:
                self._strict_seen.add((key, fp))
                self.events.append(event)
            raise RetraceError(
                'unexpected retrace of an already-compiled program\n'
                + event.format()
                + '\nEvery leaf above changed the traced signature; fix '
                'the caller (canonicalize dtypes/shapes) or raise the '
                'compile budget if this specialization is intended.',
            )
        self._check_budget(event, key)
        self.events.append(event)
        entry[fp] = sig

    def _check_budget(self, event: CompileEvent, key: Any) -> None:
        if (
            self.budget is not None
            and not self._is_service_key(key)
            and self._budgeted_compiles() + 1 > self.budget
        ):
            raise CompileBudgetError(
                f'compile budget exceeded: '
                f'{self._budgeted_compiles() + 1} compiled '
                f'programs > declared budget {self.budget}\n'
                f'tipping event:\n{event.format()}\n'
                f'program registry:\n{self.report()}',
            )

    def _budgeted_compiles(self) -> int:
        return sum(
            len(v) for k, v in self._variants.items()
            if not self._is_service_key(k)
        )

    def report(self) -> str:
        """Readable registry of every observed program."""
        if not self._variants:
            return '  (no compiled programs observed)'
        lines = []
        for key, entry in self._variants.items():
            lines.append(f'  key={key!r}: {len(entry)} signature(s)')
        for e in self.events:
            if e.kind == 'retrace':
                lines.append('  retrace ' + e.format().replace('\n', '\n  '))
        return '\n'.join(lines)


#: JAX's program cache, kept for its name.  The port's step runs
#: eagerly: there is no compiled program to cache, and the guard
#: observes the dispatch point itself (``KFACEngineMixin._dispatch``).
JitCache = dict


def attach_guard(
    engine: Any, budget: int | None = None, strict: bool = False,
) -> RetraceGuard:
    """Install a fresh :class:`RetraceGuard` at an engine's dispatch
    point (every :class:`~kfac_pytorch_tpu_torch.engine.KFACEngineMixin`
    flavour)."""
    guard = RetraceGuard(budget=budget, strict=strict)
    engine._retrace_guard = guard
    return guard


def detach_guard(engine: Any) -> None:
    """Remove an installed guard (plain dispatch again)."""
    engine._retrace_guard = None
