"""SPMD collective-discipline lint: rank divergence as checked rules.

Port of ``kfac_pytorch_tpu/analysis/collective.py`` with its registry
rewritten for ``torch.distributed``.  Every rank of a process group must
issue the same collectives in the same order; a collective reached by
some ranks and not others (a ``dist.get_rank() == 0`` guard, a
host-exception retry loop, a conditional early return) leaves the others
waiting in it until a timeout kills the job.  The port issues
collectives on the world and on its data, column, row, expert, pipe,
sequence and model groups, from the main thread and from the
``overlap.py`` worker; this module checks every call site over the
package's AST, without running anything.

**Collective inference.**  A call site is a *collective* when its last
name is in the registry (:data:`COLLECTIVE_NAMES`: the tensor
collectives of ``torch.distributed``, the port's wrappers of
``parallel/collectives.py``, which are called across modules, the host
collectives, the runtime's barrier surface and the streaming-save entry
points), or when it resolves module-locally (bare name or
``self.``-method) to a function that transitively calls a collective:
interprocedural propagation to a fixpoint, so any function that issues a
collective is a collective to its callers.

**Rules** (every exemption needs a same-line pragma with a reason:
``# spmd: proc0(<reason>)`` names a deliberate rank-0 contract,
``# spmd: collective-safe(<reason>)`` exempts any rule; a reasonless
pragma is itself a finding and suppresses nothing):

===================================  =================================
``collective-under-rank-guard``      a collective dominated by
                                     rank-conditioned control flow
                                     (``get_rank()`` / ``rank`` /
                                     ``is_writer`` tests): only some
                                     ranks reach it.
``collective-in-except-or-retry``    a collective lexically inside a
                                     ``try`` with handlers, or a
                                     collective-carrying function
                                     handed to a bounded-retry wrapper
                                     (``retry_transient_save``): one
                                     rank's host exception re-enters
                                     collectives its peers never join.
``collective-after-conditional-``    a rank-divergent early
``return``                           ``return``/``raise`` above a
                                     collective in the same function.
``rank-divergent-argument``          a rank-derived value (``rank``,
                                     ``get_rank()``, pid, hostname,
                                     clock) feeding a tensor
                                     collective's arguments: ranks
                                     issue different collectives.  The
                                     peer of a point-to-point ``send``
                                     / ``recv`` is rank-derived by
                                     design and not checked.
``barrier-tag-consistency``          every ``commit_point(tag)`` /
                                     runtime ``barrier(tag)`` tag must
                                     be a string literal, registered in
                                     :data:`BARRIER_TAG_ORDER`, and
                                     issued in the declared total order
                                     within a function (``dist.
                                     barrier()`` takes no tag).
``spmd-pragma-reason``               an ``# spmd:`` pragma without a
                                     reason (unsuppressible).
===================================  =================================

Pure source analysis: it imports neither ``torch`` nor the package under
lint.  ``lint_paths([<package dir>])`` sweeps a tree.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Iterator

from ._ast import _dotted
from ._ast import _last
from ._ast import _ModuleIndex

__all__ = [
    'BARRIER_TAG_ORDER',
    'COLLECTIVE_NAMES',
    'HOST_COLLECTIVES',
    'SPMD_RULES',
    'SpmdFinding',
    'TRACED_COLLECTIVES',
    'WRAPPER_COLLECTIVES',
    'collective_sites',
    'lint_file',
    'lint_paths',
    'lint_source',
]

SPMD_RULES: dict[str, str] = {
    'collective-under-rank-guard':
        'collective dominated by rank-conditioned control flow',
    'collective-in-except-or-retry':
        'collective inside try/except or a bounded-retry wrapper',
    'collective-after-conditional-return':
        'rank-divergent early return/raise above a collective',
    'rank-divergent-argument':
        'rank-derived value feeding a tensor collective argument',
    'barrier-tag-consistency':
        'barrier tag unregistered, non-literal, or out of declared order',
    'spmd-pragma-reason':
        'spmd pragma without a reason (pragma suppresses nothing)',
}

# Tensor collectives of torch.distributed: every rank of the group issues
# them, so rank-divergent control flow or arguments around them is the
# deadlock / mismatched-collective class.
TRACED_COLLECTIVES: frozenset[str] = frozenset({
    'all_reduce', 'all_gather', 'all_gather_into_tensor',
    'reduce_scatter_tensor', 'all_to_all_single', 'broadcast',
    'send', 'recv', 'batch_isend_irecv',
})

# The port's collective wrappers (parallel/collectives.py): called from
# other modules, where module-local propagation cannot see inside them.
WRAPPER_COLLECTIVES: frozenset[str] = frozenset({
    'all_reduce_mean', 'all_reduce_max', 'all_reduce_sum_triu',
    'all_gather_stacks', 'all_gather_stacks_async',
    'all_gather_decompositions', 'all_gather_preconditioned',
    'all_gather_preconditioned_async',
})

# Host collectives: every process must call them, in the same order, or
# the job wedges in the store or the object gather.
HOST_COLLECTIVES: frozenset[str] = frozenset({
    'barrier', 'broadcast_object_list', 'all_gather_object',
    'commit_point',
    # The streaming-save entry points gather inside ("every rank calls
    # this": elastic.save_streaming's docstring).
    'save_streaming', 'restore_streaming', 'save_rotating',
})

#: The seed registry; interprocedural propagation extends it
#: module-locally.
COLLECTIVE_NAMES: frozenset[str] = (
    TRACED_COLLECTIVES | WRAPPER_COLLECTIVES | HOST_COLLECTIVES
)

# Barrier tags, in their one declared total order (the JAX package's).
BARRIER_TAG_ORDER: tuple[str, ...] = (
    'drill/start',
    'elastic/stamp',
    'elastic/commit',
    'consistency/host_sync',
    'watchdog/rollback',
    'drill/end',
)

# Bounded-retry wrappers: handing them a collective-carrying callable
# re-enters collectives on one rank only.
_RETRY_WRAPPERS: frozenset[str] = frozenset({
    'retry_transient_save',
})

# Rank-divergence sources.  get_world_size() is deliberately absent: it
# is the same on every rank.
_RANK_CALLS: frozenset[str] = frozenset({
    'get_rank', 'process_index', 'process_id', 'getpid', 'gethostname',
    'uuid4', 'monotonic', 'perf_counter',
})
_RANK_NAMES: frozenset[str] = frozenset({
    'rank', 'local_rank', 'proc_id', 'process_id', 'process_index',
    'is_writer', 'is_coordinator', 'is_owner', 'is_primary', 'is_proc0',
})

# The peer of a point-to-point call is rank-derived by design.
_P2P: frozenset[str] = frozenset({'send', 'recv'})
_P2P_PEER_KEYWORDS: frozenset[str] = frozenset({
    'dst', 'src', 'group_dst', 'group_src',
})

# torch.distributed's own barrier takes a group, not a tag.
_UNTAGGED_BARRIERS: frozenset[str] = frozenset({
    'dist.barrier', 'torch.distributed.barrier',
})

SPMD_PRAGMA_RE = re.compile(
    r'#\s*spmd:\s*(proc0|collective-safe)\s*\(([^)]*)\)',
)

# proc0 names a deliberate rank-0 contract: it exempts the control-flow
# divergence rules (the contract is the divergence), but not a divergent
# argument or a broken barrier order.
_PROC0_RULES: frozenset[str] = frozenset({
    'collective-under-rank-guard',
    'collective-after-conditional-return',
    'collective-in-except-or-retry',
})


@dataclasses.dataclass(frozen=True)
class SpmdFinding:
    """One SPMD-discipline finding (sortable, pragma-suppressible)."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    func_line: int | None = None
    guard_line: int | None = None

    def format(self) -> str:
        return f'{self.path}:{self.line}:{self.col}: [{self.rule}] ' \
            f'{self.message}'


@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One collective call site (registry or derived carrier)."""

    path: str
    line: int
    col: int
    name: str
    kind: str  # 'traced' | 'host' | 'derived'


def _rank_divergent(expr: ast.AST) -> str | None:
    """The rank-divergence source named in ``expr``, or None."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            d = _dotted(n.func)
            if d is not None and _last(d) in _RANK_CALLS:
                return d
        elif isinstance(n, ast.Name):
            if n.id.lstrip('_') in _RANK_NAMES:
                return n.id
        elif isinstance(n, ast.Attribute):
            if n.attr.lstrip('_') in _RANK_NAMES:
                return n.attr
    return None


# ----------------------------------------------------------------------
# carrier propagation
# ----------------------------------------------------------------------


def _direct_collective(call_dotted: str | None) -> bool:
    return call_dotted is not None and (
        _last(call_dotted) in COLLECTIVE_NAMES
    )


def _carrier_set(
    index: '_ModuleIndex',
    exempt_lines: set[int],
) -> set:
    """Module-local fixpoint: functions that transitively issue a
    collective.  A function whose ``def`` line carries an spmd pragma
    is contractually exempt and does not propagate."""
    carriers = set()
    for f in index.funcs:
        if f.lineno in exempt_lines:
            continue
        if any(_direct_collective(d) for d, _ in f.calls):
            carriers.add(f)
    changed = True
    while changed:
        changed = False
        for f in index.funcs:
            if f in carriers or f.lineno in exempt_lines:
                continue
            for dotted, _call in f.calls:
                if dotted is None:
                    continue
                parts = dotted.split('.')
                if len(parts) == 1:
                    cands = index.by_name.get(parts[0], [])
                elif len(parts) == 2 and parts[0] in ('self', 'cls'):
                    cands = index.by_name.get(parts[1], [])
                else:
                    continue
                if any(c in carriers for c in cands):
                    carriers.add(f)
                    changed = True
                    break
    return carriers


def _call_is_collective(
    index: '_ModuleIndex',
    carriers: set,
    dotted: str | None,
) -> str | None:
    """'traced' | 'host' | 'derived' | None for one call."""
    if dotted is None:
        return None
    last = _last(dotted)
    if last in TRACED_COLLECTIVES or last in WRAPPER_COLLECTIVES:
        return 'traced'
    if last in HOST_COLLECTIVES:
        return 'host'
    parts = dotted.split('.')
    if len(parts) == 1:
        cands = index.by_name.get(parts[0], [])
    elif len(parts) == 2 and parts[0] in ('self', 'cls'):
        cands = index.by_name.get(parts[1], [])
    else:
        return None
    if any(c in carriers for c in cands):
        return 'derived'
    return None


# ----------------------------------------------------------------------
# context-tracking statement walk
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Guard:
    line: int
    divergent: str | None  # the rank source named in the test, if any


@dataclasses.dataclass(frozen=True)
class _Site:
    """One call with its dominating control-flow context."""

    dotted: str | None
    call: ast.Call
    guards: tuple[_Guard, ...]
    try_line: int | None  # innermost try-with-handlers


class _StmtWalker:
    """Walks one function body (nested defs excluded) collecting every
    call with its guard/try context, plus rank-divergent early exits."""

    def __init__(self) -> None:
        self.sites: list[_Site] = []
        # (if-line, rank source, guarded-branch last line)
        self.divergent_exits: list[tuple[int, str, int]] = []

    def walk(self, stmts: Iterable[ast.stmt]) -> None:
        self._stmts(list(stmts), (), None)

    def _stmts(
        self,
        stmts: list[ast.stmt],
        guards: tuple[_Guard, ...],
        try_line: int | None,
    ) -> None:
        for st in stmts:
            self._stmt(st, guards, try_line)

    def _stmt(
        self,
        st: ast.stmt,
        guards: tuple[_Guard, ...],
        try_line: int | None,
    ) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # separate analysis units
        if isinstance(st, ast.If):
            src = _rank_divergent(st.test)
            self._exprs([st.test], guards, try_line)
            g = guards + (_Guard(st.lineno, src),)
            self._stmts(st.body, g, try_line)
            self._stmts(st.orelse, g, try_line)
            if src is not None:
                for branch in (st.body, st.orelse):
                    if branch and isinstance(
                        branch[-1], (ast.Return, ast.Raise, ast.Continue),
                    ):
                        self.divergent_exits.append(
                            (st.lineno, src, branch[-1].lineno),
                        )
            return
        if isinstance(st, ast.Try):
            inner = st.lineno if st.handlers else try_line
            self._stmts(st.body, guards, inner)
            for h in st.handlers:
                self._stmts(h.body, guards, inner)
            self._stmts(st.orelse, guards, try_line)
            self._stmts(st.finalbody, guards, try_line)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._exprs([st.iter], guards, try_line)
            self._stmts(st.body, guards, try_line)
            self._stmts(st.orelse, guards, try_line)
            return
        if isinstance(st, ast.While):
            src = _rank_divergent(st.test)
            self._exprs([st.test], guards, try_line)
            g = guards + ((_Guard(st.lineno, src),) if src else ())
            self._stmts(st.body, g, try_line)
            self._stmts(st.orelse, guards, try_line)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            self._exprs(
                [item.context_expr for item in st.items], guards, try_line,
            )
            self._stmts(st.body, guards, try_line)
            return
        self._exprs(list(ast.iter_child_nodes(st)), guards, try_line)

    def _exprs(
        self,
        nodes: list[ast.AST],
        guards: tuple[_Guard, ...],
        try_line: int | None,
    ) -> None:
        stack = list(nodes)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(n, ast.Call):
                self.sites.append(
                    _Site(_dotted(n.func), n, guards, try_line),
                )
            stack.extend(ast.iter_child_nodes(n))


# ----------------------------------------------------------------------
# rules
# ----------------------------------------------------------------------


def _barrier_tag(call: ast.Call) -> tuple[str | None, bool]:
    """(literal tag or None, had_any_tag_expr) for a barrier call."""
    expr: ast.AST | None = None
    if call.args:
        expr = call.args[0]
    else:
        for kw in call.keywords:
            if kw.arg in ('name', 'tag'):
                expr = kw.value
                break
    if expr is None:
        return None, False
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value, True
    return None, True


def _check_function(
    index: '_ModuleIndex',
    carriers: set,
    name: str,
    lineno: int | None,
    body: list[ast.stmt],
    path: str,
) -> Iterator[SpmdFinding]:
    walker = _StmtWalker()
    walker.walk(body)

    def finding(
        rule: str,
        message: str,
        call: ast.Call,
        guard_line: int | None = None,
    ) -> SpmdFinding:
        return SpmdFinding(
            path, call.lineno, call.col_offset, rule, message,
            func_line=lineno, guard_line=guard_line,
        )

    barrier_calls: list[tuple[ast.Call, str]] = []
    collective_sites: list[tuple[_Site, str]] = []
    for site in walker.sites:
        kind = _call_is_collective(index, carriers, site.dotted)
        if kind is not None:
            collective_sites.append((site, kind))

    for site, kind in collective_sites:
        call = site.call
        dotted = site.dotted or '<call>'
        last = _last(dotted)

        # collective-under-rank-guard: innermost divergent guard.
        for g in reversed(site.guards):
            if g.divergent is not None:
                yield finding(
                    'collective-under-rank-guard',
                    f'{dotted}() is dominated by rank-divergent '
                    f'control flow on {g.divergent!r} (guard at line '
                    f'{g.line}): only some ranks reach this collective '
                    '— the rest deadlock waiting for them; hoist the '
                    'collective above the guard or name the contract '
                    'with # spmd: proc0(<reason>)',
                    call, guard_line=g.line,
                )
                break

        # collective-in-except-or-retry (lexical form).
        if site.try_line is not None:
            yield finding(
                'collective-in-except-or-retry',
                f'{dotted}() inside try/except (try at line '
                f'{site.try_line}): a rank whose attempt raises '
                're-enters the collective alone — its peers already '
                'left; move the collective out of the retried region',
                call, guard_line=site.try_line,
            )

        # rank-divergent-argument (tensor collectives: every rank must
        # issue the same one; a point-to-point peer is exempt).
        if kind == 'traced':
            args = list(call.args)
            keywords = list(call.keywords)
            if last in _P2P:
                args = args[:1] + args[2:]
                keywords = [kw for kw in keywords
                            if kw.arg not in _P2P_PEER_KEYWORDS]
            for arg in args + [kw.value for kw in keywords]:
                src = _rank_divergent(arg)
                if src is not None:
                    yield finding(
                        'rank-divergent-argument',
                        f'{dotted}() takes a rank-derived value '
                        f'({src!r}): ranks would issue different '
                        'collectives; thread a world-uniform value '
                        'instead',
                        call,
                    )
                    break

        # barrier-tag-consistency: literal, registered, ordered.
        if (last in ('commit_point', 'barrier')
                and dotted not in _UNTAGGED_BARRIERS):
            tag, present = _barrier_tag(call)
            if not present:
                pass  # no tag argument at all (e.g. a re-export def)
            elif tag is None:
                yield finding(
                    'barrier-tag-consistency',
                    f'{dotted}() tag is not a string literal: the '
                    'barrier protocol is only checkable when every '
                    'tag is spelled in source (BARRIER_TAG_ORDER)',
                    call,
                )
            elif tag not in BARRIER_TAG_ORDER:
                yield finding(
                    'barrier-tag-consistency',
                    f'{dotted}({tag!r}) is not a registered barrier '
                    'tag; add it to analysis.collective.'
                    'BARRIER_TAG_ORDER at its protocol position',
                    call,
                )
            else:
                barrier_calls.append((call, tag))

    # collective-in-except-or-retry (wrapper form): a collective
    # carrier handed to a bounded-retry wrapper.
    for site in walker.sites:
        if site.dotted is None or _last(site.dotted) not in (
                _RETRY_WRAPPERS):
            continue
        for arg in site.call.args:
            cands = index.resolve(arg)
            if any(c in carriers for c in cands):
                cname = _dotted(arg) or '<callable>'
                yield SpmdFinding(
                    path, site.call.lineno, site.call.col_offset,
                    'collective-in-except-or-retry',
                    f'{_last(site.dotted)}({cname}) retries a '
                    'collective-carrying callable: one process '
                    're-enters collectives its peers never join; '
                    'gate the retry to one process or make the body '
                    'collective-free',
                    func_line=lineno,
                )
                break

    # collective-after-conditional-return: a rank-divergent early exit
    # above a collective the exiting ranks then skip.
    for if_line, src, exit_line in walker.divergent_exits:
        for site, _kind in collective_sites:
            call = site.call
            if call.lineno <= exit_line:
                continue
            if any(g.line == if_line for g in site.guards):
                continue  # inside the guard itself: rank-guard's job
            yield SpmdFinding(
                path, call.lineno, call.col_offset,
                'collective-after-conditional-return',
                f'{site.dotted or "<call>"}() is skipped by the '
                f'rank-divergent early exit at line {exit_line} '
                f'(on {src!r}): the exiting ranks never reach this '
                'collective; restructure so every rank passes '
                'through, or name the contract with '
                '# spmd: proc0(<reason>)',
                func_line=lineno, guard_line=if_line,
            )
            break  # first downstream collective names the bug

    # barrier-tag-consistency: declared total order within a function.
    order = {t: i for i, t in enumerate(BARRIER_TAG_ORDER)}
    barrier_calls.sort(key=lambda item: item[0].lineno)
    for (_c1, t1), (c2, t2) in zip(barrier_calls, barrier_calls[1:]):
        if order[t2] < order[t1]:
            yield SpmdFinding(
                path, c2.lineno, c2.col_offset,
                'barrier-tag-consistency',
                f'barrier tag {t2!r} issued after {t1!r} violates the '
                'declared protocol order '
                f'({" -> ".join(BARRIER_TAG_ORDER)}): two ranks '
                'arriving by different paths would meet at different '
                'barriers',
                func_line=lineno,
            )


# ----------------------------------------------------------------------
# pragmas and the entry points
# ----------------------------------------------------------------------


def _pragmas(
    source_lines: list[str],
) -> dict[int, list[tuple[str, str]]]:
    """line -> [(kind, reason)] for every spmd pragma in the module."""
    out: dict[int, list[tuple[str, str]]] = {}
    for i, text in enumerate(source_lines, start=1):
        for m in SPMD_PRAGMA_RE.finditer(text):
            out.setdefault(i, []).append(
                (m.group(1), m.group(2).strip()),
            )
    return out


def _suppressed(
    finding: SpmdFinding,
    pragmas: dict[int, list[tuple[str, str]]],
) -> bool:
    lines = {finding.line, finding.guard_line, finding.func_line}
    lines.discard(None)
    for ln in lines:
        for kind, reason in pragmas.get(ln, []):  # type: ignore[arg-type]
            if not reason:
                continue  # a reasonless pragma suppresses nothing
            if kind == 'collective-safe':
                return True
            if kind == 'proc0' and finding.rule in _PROC0_RULES:
                return True
    return False


def collective_sites(
    source: str, path: str = '<memory>',
) -> list[CollectiveSite]:
    """Inventory of every collective call site in one module."""
    tree = ast.parse(source, filename=path)
    index = _ModuleIndex(tree)
    lines = source.splitlines()
    exempt = {
        ln for ln, ps in _pragmas(lines).items()
        if any(reason for _kind, reason in ps)
    }
    carriers = _carrier_set(index, exempt)
    out: list[CollectiveSite] = []
    units: list[list[ast.stmt]] = [tree.body]
    units.extend(
        f.node.body for f in index.funcs if not f.is_lambda
    )
    for body in units:
        walker = _StmtWalker()
        walker.walk(body)
        for site in walker.sites:
            kind = _call_is_collective(index, carriers, site.dotted)
            if kind is not None:
                out.append(CollectiveSite(
                    path, site.call.lineno, site.call.col_offset,
                    site.dotted or '<call>', kind,
                ))
    out.sort(key=lambda s: (s.line, s.col))
    # A call can be collected from both the module unit and a nested
    # function unit; report it once.
    seen: set[tuple[int, int]] = set()
    deduped = []
    for s in out:
        if (s.line, s.col) not in seen:
            seen.add((s.line, s.col))
            deduped.append(s)
    return deduped


def lint_source(
    source: str, path: str = '<memory>',
) -> list[SpmdFinding]:
    """SPMD-lint one module's source; returns pragma-filtered findings."""
    tree = ast.parse(source, filename=path)
    index = _ModuleIndex(tree)
    lines = source.splitlines()
    pragmas = _pragmas(lines)
    exempt = {
        ln for ln, ps in pragmas.items()
        if any(reason for _kind, reason in ps)
    }
    carriers = _carrier_set(index, exempt)

    findings: list[SpmdFinding] = []
    findings.extend(
        _check_function(index, carriers, '<module>', None, tree.body,
                        path),
    )
    for f in index.funcs:
        if f.is_lambda:
            continue
        findings.extend(
            _check_function(
                index, carriers, f.name, f.lineno, f.node.body, path,
            ),
        )

    for ln, ps in sorted(pragmas.items()):
        for kind, reason in ps:
            if not reason:
                findings.append(SpmdFinding(
                    path, ln, 0, 'spmd-pragma-reason',
                    f'# spmd: {kind}() pragma has no reason; every '
                    'exemption must name its contract '
                    f'(# spmd: {kind}(<why this is rank-safe>))',
                ))

    kept = [fd for fd in findings if not _suppressed(fd, pragmas)]
    kept.sort(key=lambda fd: (fd.path, fd.line, fd.col, fd.rule))
    out, seen = [], set()
    for fd in kept:
        key = (fd.path, fd.line, fd.col, fd.rule, fd.message)
        if key not in seen:
            seen.add(key)
            out.append(fd)
    return out


def lint_file(path: str, root: str | None = None) -> list[SpmdFinding]:
    rel = os.path.relpath(path, root) if root else path
    with open(path, encoding='utf-8') as fh:
        source = fh.read()
    return lint_source(source, rel)


def lint_paths(paths: Iterable[str]) -> list[SpmdFinding]:
    """SPMD-lint files and/or directory trees (__pycache__ skipped)."""
    findings: list[SpmdFinding] = []
    for p in paths:
        if os.path.isdir(p):
            root = os.path.dirname(os.path.abspath(p.rstrip('/')))
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [
                    d for d in sorted(dirnames) if d != '__pycache__'
                ]
                for fn in sorted(filenames):
                    if fn.endswith('.py'):
                        findings.extend(
                            lint_file(os.path.join(dirpath, fn), root),
                        )
        else:
            findings.extend(lint_file(p, None))
    return findings
