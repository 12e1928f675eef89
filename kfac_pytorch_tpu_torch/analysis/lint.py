"""K-FAC/torch-aware AST lint: the step's host syncs and traps as rules.

Port of ``kfac_pytorch_tpu/analysis/lint.py`` with torch's meaning.  A
general linter cannot tell ``float(x)`` on the host from ``float(x)`` on
the step's hot path, where it waits for the card; this rule engine knows
which of the port's functions run on every step.

**Hot-path inference** (JAX's traced inference, for eager torch).  A
function is *hot* when it is (a) named in :data:`DEFAULT_HOT_NAMES`: the
dispatch point's step body and the stage methods it runs
(``engine.KFACEngineMixin._step_body``: the factor update, the refresh
and its shards, the deferred refresh, the precondition tail, the health
verdict, the consistency check, the adaptive drift feed); (b) passed to
``torch.compile`` or decorated with it (a compiled function is torch's
traced code), including through a factory call
(``torch.compile(build())`` marks what ``build`` defines); (c) defined
at the top level of a module under ``ops/`` (the step's numerics); or
(d) nested in or called (module-locally, by bare name or ``self.``
method; a call of the function's own parameter is not resolved) from a
hot function, to a fixpoint.  A function handed to
``torch.compiler.disable`` (or decorated with it, or with
``torch._dynamo.disable``) runs eagerly outside the graph, and is host
code however it is reached.

**Rules** (suppress a deliberate finding with a same-line or
``def``-line ``# torchlint: allow(<rule>[, <rule>...]) <reason>``):

========================  ============================================
``host-sync``             ``.item()`` / ``.tolist()`` / ``.numpy()`` /
                          ``.cpu()`` (not of a numpy value),
                          ``float()``/``int()``/``bool()`` of a tensor
                          (a ``torch`` call's result, a local assigned
                          from one, a parameter annotated ``Tensor``;
                          shape and metadata arithmetic is exempt),
                          ``nonzero()`` (its shape is the data's) and
                          ``synchronize()``, on the hot path: each waits
                          for the card.
``weak-literal``          ``torch.tensor``/``torch.as_tensor`` of a float
                          literal or a hyperparameter-named value
                          without ``dtype=``: its dtype follows
                          ``torch.get_default_dtype()``, and a compiled
                          consumer sees a new input type when it moves
                          (see ``hyperparams.canonical_scalar``).
``nondeterminism``        ``time.*`` / ``random.*`` / ``np.random.*`` /
                          ``datetime.*`` / ``uuid.*`` on the hot path,
                          and ``torch.rand*``/``randn``/``randint``/
                          ``randperm``/``normal``/``bernoulli`` or an
                          in-place ``normal_``/``uniform_``/``random_``/
                          ``bernoulli_``/``exponential_`` without
                          ``generator=``: the global generator's state
                          differs across ranks and runs.  Also, in a
                          function that issues a collective
                          (:data:`DEFAULT_COLLECTIVE_NAMES`), a host clock
                          (``time.time``/``monotonic``/``perf_counter``)
                          feeding a ``torch`` call or a collective: rank
                          clocks diverge.
``f64-promotion``         ``.double()``, ``torch.float64``/``torch.double``
                          and ``np.float64(...)`` on the hot path: twice
                          the bytes, and on the card a float64 rate a
                          fraction of the float32 one.
========================  ============================================

JAX's ``cond-structure`` and ``jit-no-donate`` have no counterpart:
eager ``if`` has no branch structure to mismatch, and eager torch has no
buffer donation.  The CLI is ``kfac_pytorch_tpu_torch/scripts/
lint_torch.py``; this module imports neither torch nor the package under
lint (its one import of the package is :mod:`._ast`, relative), so
``--check`` runs anywhere.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Iterator

from ._ast import _dotted
from ._ast import _Func
from ._ast import _last
from ._ast import _ModuleIndex
from .collective import COLLECTIVE_NAMES

__all__ = [
    'DEFAULT_COLLECTIVE_NAMES',
    'DEFAULT_HOT_NAMES',
    'Finding',
    'RULES',
    'lint_file',
    'lint_paths',
    'lint_source',
]

RULES: dict[str, str] = {
    'host-sync': 'host read of a device value on the step\'s hot path',
    'weak-literal': 'tensor of a float literal whose dtype is the '
                    'default dtype\'s',
    'nondeterminism': 'host clock / unseeded RNG on the hot path',
    'f64-promotion': 'float64 request on the hot path',
}

# The dispatch point's step body and the stage methods it runs
# (engine._step_body and each flavour's implementation of them), plus
# the bucketed tail.  A function of one of these names is hot wherever
# it is defined: the K-FAC-aware part of the lint.
DEFAULT_HOT_NAMES: frozenset[str] = frozenset({
    # the dispatch point and the step body
    '_step',
    '_step_body',
    # the stage methods (engine hooks)
    '_update_factors',
    '_refresh',
    '_refresh_shard',
    '_issue_deferred_refresh',
    '_install_refresh',
    '_overlap_collect',
    '_precondition',
    'precondition_combined',
    '_health_verdict',
    '_consistency_check',
    '_adaptive_drift_emit',
    '_ekfac_divergence',
    # the bucketed second order
    'compute',
    'compute_shard',
    'precondition',
})

#: The collective registry, the SPMD lint's
#: (:data:`~kfac_pytorch_tpu_torch.analysis.collective.COLLECTIVE_NAMES`).
DEFAULT_COLLECTIVE_NAMES: frozenset[str] = COLLECTIVE_NAMES

_CLOCK_CALLS = frozenset({
    'time', 'monotonic', 'perf_counter',
    'time_ns', 'monotonic_ns', 'perf_counter_ns',
})

# Module paths whose top-level functions are the step's numerics.
ALL_HOT_PATH_RE = re.compile(r'(^|[/\\])ops[/\\][^/\\]+\.py$')

PRAGMA_RE = re.compile(r'#\s*torchlint:\s*allow\(([^)]*)\)')

_HYPERPARAM_NAMES = frozenset({
    'damping', 'lr', 'learning_rate', 'kl_clip', 'factor_decay',
    'weight_decay', 'momentum', 'eps', 'epsilon', 'decay', 'clip',
})
# torch calls whose result lives on the host.
_HOST_TORCH_CALLS = frozenset({
    'finfo', 'iinfo', 'device', 'Size', 'dtype', 'get_default_dtype',
    'is_tensor', 'is_floating_point', 'is_grad_enabled', 'device_count',
    'is_available', 'is_initialized', 'get_rank', 'get_world_size',
    'current_device', 'get_device_name', 'promote_types',
})
# Tensor methods whose result lives on the host (metadata).
_HOST_METHODS = frozenset({
    'numel', 'dim', 'size', 'element_size', 'nelement', 'data_ptr',
    'is_contiguous', 'stride', 'get_device', 'is_floating_point',
    'storage_offset',
})
_SHAPE_ATTRS = frozenset({
    'shape', 'ndim', 'dtype', 'device', 'is_cuda', 'layout', 'itemsize',
    'requires_grad',
})
_SYNC_METHODS = frozenset({'item', 'tolist', 'numpy', 'cpu'})
_RNG_CALLS = frozenset({
    'rand', 'rand_like', 'randn', 'randn_like', 'randint', 'randint_like',
    'randperm', 'normal', 'bernoulli', 'multinomial', 'poisson',
})
_RNG_METHODS = frozenset({
    'normal_', 'uniform_', 'random_', 'bernoulli_', 'exponential_',
    'geometric_', 'log_normal_', 'cauchy_',
})
_F64_NAMES = frozenset({'float64', 'double'})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding (sortable, pragma-suppressible)."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    func_line: int | None = None

    def format(self) -> str:
        return (f'{self.path}:{self.line}:{self.col}: [{self.rule}] '
                f'{self.message}')


def _is_compile(dotted: str) -> bool:
    return dotted in ('torch.compile', 'compile') or dotted.endswith(
        '.compile') and dotted.split('.')[0] == 'torch'


def _is_disable(dotted: str) -> bool:
    return dotted.endswith('compiler.disable') or dotted.endswith(
        '_dynamo.disable')


def _decorator_kind(dec: ast.AST) -> str | None:
    d = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
    if d is None:
        return None
    if _is_compile(d):
        return 'hot'
    if _is_disable(d):
        return 'host'
    return None


def _hot_set(
    index: _ModuleIndex,
    hot_names: frozenset[str],
    all_hot: bool,
) -> set[_Func]:
    hot: set[_Func] = set()
    host: set[_Func] = set()

    all_calls = list(index.module_calls)
    for f in index.funcs:
        all_calls.extend(f.calls)
        if f.name in hot_names:
            hot.add(f)
        if not f.is_lambda:
            for dec in f.node.decorator_list:  # type: ignore[attr-defined]
                kind = _decorator_kind(dec)
                if kind == 'hot':
                    hot.add(f)
                elif kind == 'host':
                    host.add(f)
        if all_hot and f.parent is None and not f.is_lambda:
            hot.add(f)

    for dotted, call in all_calls:
        if dotted is None or not call.args:
            continue
        if _is_compile(dotted):
            hot.update(index.resolve(call.args[0]))
        elif _is_disable(dotted):
            host.update(index.resolve(call.args[0]))

    changed = True
    while changed:
        changed = False
        for f in list(hot):
            for child in f.children:
                if child not in hot:
                    hot.add(child)
                    changed = True
            for dotted, _call in f.calls:
                if dotted is None:
                    continue
                parts = dotted.split('.')
                if len(parts) == 1:
                    if parts[0] in f.params:
                        # A callable the caller passed in (the dispatch
                        # point's ``run()``), not a module function.
                        continue
                    cands = index.by_name.get(parts[0], [])
                elif len(parts) == 2 and parts[0] in ('self', 'cls'):
                    cands = index.by_name.get(parts[1], [])
                else:
                    continue
                for c in cands:
                    if c not in hot:
                        hot.add(c)
                        changed = True

    for h in list(host):
        host.update(h.descendants())
    return hot - host


# ----------------------------------------------------------------------
# rules
# ----------------------------------------------------------------------


def _assigned_names(f: _Func, pred) -> set[str]:
    """Names assigned (transitively) from expressions ``pred`` accepts."""
    env: set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(f.node):
            if isinstance(node, ast.Assign) and pred(node.value, env):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and n.id not in env:
                            env.add(n.id)
                            changed = True
    return env


def _devicey_env(f: _Func) -> set[str]:
    """Names holding tensors within ``f``: parameters annotated as
    tensors, and locals assigned from ``torch`` calls (or from other
    such locals)."""
    env = {
        name for name, ann in f.param_annotations.items()
        if ann is not None and ann.rsplit('.', 1)[-1] == 'Tensor'
    }
    return env | _assigned_names(
        f, lambda v, e: _is_devicey(v, env | e))


def _is_devicey(expr: ast.AST, env: set[str]) -> bool:
    """Whether an expression produces a tensor (against host shape or
    config arithmetic, which ``int()``/``float()`` read for free)."""
    if isinstance(expr, ast.Call):
        d = _dotted(expr.func)
        if d is not None:
            parts = d.split('.')
            if parts[0] == 'torch':
                return parts[-1] not in _HOST_TORCH_CALLS
            if parts[-1] in _HOST_METHODS:
                return False
        if isinstance(expr.func, ast.Attribute):
            return _is_devicey(expr.func.value, env)
        return False
    if isinstance(expr, ast.Name):
        return expr.id in env
    if isinstance(expr, ast.Attribute):
        if expr.attr in _SHAPE_ATTRS:
            return False
        return _is_devicey(expr.value, env)
    if isinstance(expr, ast.Subscript):
        return _is_devicey(expr.value, env)
    if isinstance(expr, ast.BinOp):
        return _is_devicey(expr.left, env) or _is_devicey(expr.right, env)
    if isinstance(expr, ast.UnaryOp):
        return _is_devicey(expr.operand, env)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(_is_devicey(e, env) for e in expr.elts)
    return False


def _is_numpy(expr: ast.AST, env: set[str]) -> bool:
    """Whether an expression is a numpy (host) value."""
    if isinstance(expr, ast.Call):
        d = _dotted(expr.func)
        if d is not None and d.split('.')[0] in ('np', 'numpy'):
            return True
        if isinstance(expr.func, ast.Attribute):
            return _is_numpy(expr.func.value, env)
        return False
    if isinstance(expr, ast.Name):
        return expr.id in env
    if isinstance(expr, (ast.Attribute, ast.Subscript)):
        return _is_numpy(expr.value, env)
    return False


def _names_f64(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value in ('float64', 'double')
    d = _dotted(expr)
    return (d is not None and d.split('.')[0] in ('torch', 'np', 'numpy')
            and _last(d) in _F64_NAMES)


def _check_hot_calls(f: _Func, path: str) -> Iterator[Finding]:
    env = _devicey_env(f)
    np_env = {
        name for name, ann in f.param_annotations.items()
        if ann is not None and ann.split('.')[0] in ('np', 'numpy')
    } | _assigned_names(f, _is_numpy)
    for dotted, call in f.calls:
        if dotted is None:
            # A method on an expression (``x[i].double()``).
            if not isinstance(call.func, ast.Attribute):
                continue
            dotted = f'<expr>.{call.func.attr}'
        parts = dotted.split('.')
        last = parts[-1]

        def finding(rule: str, message: str) -> Finding:
            return Finding(path, call.lineno, call.col_offset, rule,
                           message, func_line=f.lineno)

        receiver = (call.func.value if isinstance(call.func, ast.Attribute)
                    else None)
        if (last in _SYNC_METHODS and receiver is not None
                and not _is_numpy(receiver, np_env)
                and parts[0] not in ('np', 'numpy')):
            yield finding(
                'host-sync',
                f'.{last}() on the hot path reads a device value on the '
                'host (the host waits for the card); keep the value on '
                'the device or move this off the step',
            )
        elif dotted in ('float', 'int', 'bool') and call.args and (
                _is_devicey(call.args[0], env)):
            yield finding(
                'host-sync',
                f'{dotted}() of a tensor on the hot path reads it on the '
                'host (the host waits for the card); keep it a 0-d tensor',
            )
        elif last == 'nonzero' and (receiver is not None
                                    or parts[0] == 'torch'):
            yield finding(
                'host-sync',
                'nonzero() on the hot path: its output shape is the '
                "data's, so the host waits for the card to size it",
            )
        elif last == 'synchronize' and len(parts) > 1:
            yield finding(
                'host-sync',
                f'{dotted}() on the hot path blocks the host until the '
                'card drains',
            )

        if last == 'double' and receiver is not None and not call.args:
            yield finding(
                'f64-promotion',
                '.double() on the hot path: twice the bytes and the '
                "card's float64 rate; thread the dtype from config",
            )
        elif last == 'float64' and parts[0] in ('np', 'numpy', 'torch'):
            yield finding(
                'f64-promotion',
                f'{dotted}(...) on the hot path requests float64',
            )
        elif any(_names_f64(a) for a in call.args) or any(
                kw.arg == 'dtype' and _names_f64(kw.value)
                for kw in call.keywords):
            yield finding(
                'f64-promotion',
                f'{dotted}(..., float64) on the hot path: twice the bytes '
                "and the card's float64 rate",
            )

        if parts[0] in ('time', 'random', 'datetime', 'uuid') and len(
                parts) > 1:
            yield finding(
                'nondeterminism',
                f'{dotted}() on the hot path: a host clock or the host '
                'RNG differs across ranks and runs; pass it in',
            )
        elif len(parts) >= 3 and parts[0] in ('np', 'numpy') and (
                parts[1] == 'random'):
            yield finding(
                'nondeterminism',
                f'{dotted}() on the hot path: the host RNG differs across '
                'ranks and runs; use a seeded torch.Generator',
            )
        elif ((parts[0] == 'torch' and last in _RNG_CALLS)
              or (last in _RNG_METHODS and receiver is not None)) and not any(
                kw.arg == 'generator' for kw in call.keywords):
            yield finding(
                'nondeterminism',
                f'{dotted}() without generator= on the hot path draws from '
                "the global generator, whose state is the process's",
            )


def _is_clock_call(expr: ast.AST) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    d = _dotted(expr.func)
    return (d is not None and d.split('.')[0] == 'time'
            and _last(d) in _CLOCK_CALLS)


def _check_clock_near_collectives(
    f: _Func, path: str,
) -> Iterator[Finding]:
    """A host clock feeding a ``torch`` call or a collective argument in
    a function that issues a collective: each rank would put its own
    clock into the cross-rank value.  Clock reads kept on the host
    (timeouts, logging) are fine."""
    if not any(d is not None and _last(d) in DEFAULT_COLLECTIVE_NAMES
               for d, _ in f.calls):
        return
    tainted: set[str] = set()
    for node in ast.walk(f.node):
        if isinstance(node, ast.Assign) and _is_clock_call(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    tainted.add(t.id)
    for dotted, call in f.calls:
        if dotted is None:
            continue
        sink = dotted.split('.')[0] == 'torch' or (
            _last(dotted) in DEFAULT_COLLECTIVE_NAMES)
        if not sink:
            continue
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            hit = None
            for n in ast.walk(arg):
                if isinstance(n, ast.Name) and n.id in tainted:
                    hit = n.id
                    break
                if _is_clock_call(n):
                    hit = _dotted(n.func)  # type: ignore[union-attr]
                    break
            if hit is not None:
                yield Finding(
                    path, call.lineno, call.col_offset, 'nondeterminism',
                    f'host clock value ({hit}) feeds {dotted}() in a '
                    'function that issues a collective: rank clocks '
                    'diverge, so the cross-rank value does too; broadcast '
                    "one rank's stamp instead",
                    func_line=f.lineno,
                )
                break


def _check_weak_literals(
    calls: Iterable[tuple[str | None, ast.Call, int | None]], path: str,
) -> Iterator[Finding]:
    for dotted, call, func_line in calls:
        if dotted is None:
            continue
        parts = dotted.split('.')
        if not (parts[0] == 'torch' and parts[-1] in ('tensor', 'as_tensor')
                and len(parts) == 2):
            continue
        has_dtype = any(kw.arg == 'dtype' for kw in call.keywords) or (
            parts[-1] == 'as_tensor' and len(call.args) >= 2)
        if has_dtype or not call.args:
            continue
        arg = call.args[0]
        name = None
        if isinstance(arg, ast.Constant) and isinstance(arg.value, float):
            name = repr(arg.value)
        else:
            d = _dotted(arg)
            if d is not None and _last(d).lstrip('_') in _HYPERPARAM_NAMES:
                name = d
        if name is not None:
            yield Finding(
                path, call.lineno, call.col_offset, 'weak-literal',
                f'{dotted}({name}) without dtype= takes '
                'torch.get_default_dtype(), so its dtype (and a compiled '
                "consumer's input type) moves with it; pass "
                'dtype=torch.float32 (see hyperparams.canonical_scalar)',
                func_line=func_line,
            )


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------


def _allowed(source_lines: list[str], line: int) -> frozenset[str]:
    if not 1 <= line <= len(source_lines):
        return frozenset()
    m = PRAGMA_RE.search(source_lines[line - 1])
    if not m:
        return frozenset()
    return frozenset(
        r.strip() for r in m.group(1).split(',') if r.strip()
    )


def lint_source(
    source: str,
    path: str = '<memory>',
    *,
    hot_names: frozenset[str] = DEFAULT_HOT_NAMES,
    all_hot: bool = False,
) -> list[Finding]:
    """Lint one module's source; returns the pragma-filtered findings."""
    tree = ast.parse(source, filename=path)
    index = _ModuleIndex(tree)
    hot = _hot_set(index, hot_names, all_hot)

    findings: list[Finding] = []
    for f in hot:
        findings.extend(_check_hot_calls(f, path))
    for f in index.funcs:
        if f not in hot:
            findings.extend(_check_clock_near_collectives(f, path))
    all_calls: list[tuple[str | None, ast.Call, int | None]] = [
        (d, c, None) for d, c in index.module_calls
    ]
    for f in index.funcs:
        all_calls.extend((d, c, f.lineno) for d, c in f.calls)
    findings.extend(_check_weak_literals(all_calls, path))

    lines = source.splitlines()
    kept = []
    for fd in findings:
        allowed = _allowed(lines, fd.line)
        if fd.func_line is not None:
            allowed = allowed | _allowed(lines, fd.func_line)
        if fd.rule in allowed or 'all' in allowed:
            continue
        kept.append(fd)
    kept.sort(key=lambda fd: (fd.path, fd.line, fd.col, fd.rule))
    out, seen = [], set()
    for fd in kept:
        key = (fd.path, fd.line, fd.col, fd.rule)
        if key not in seen:
            seen.add(key)
            out.append(fd)
    return out


def lint_file(
    path: str,
    root: str | None = None,
    *,
    hot_names: frozenset[str] = DEFAULT_HOT_NAMES,
) -> list[Finding]:
    rel = os.path.relpath(path, root) if root else path
    with open(path, encoding='utf-8') as fh:
        source = fh.read()
    return lint_source(source, rel, hot_names=hot_names,
                       all_hot=bool(ALL_HOT_PATH_RE.search(rel)))


def lint_paths(
    paths: Iterable[str],
    *,
    hot_names: frozenset[str] = DEFAULT_HOT_NAMES,
) -> list[Finding]:
    """Lint files and directory trees (``__pycache__`` and the kernel
    build directory skipped)."""
    findings: list[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            root = os.path.dirname(os.path.abspath(p.rstrip('/')))
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in sorted(dirnames)
                               if d not in ('__pycache__', '_build')]
                for fn in sorted(filenames):
                    if fn.endswith('.py'):
                        findings.extend(lint_file(
                            os.path.join(dirpath, fn), root,
                            hot_names=hot_names))
        else:
            findings.extend(lint_file(p, None, hot_names=hot_names))
    return findings
