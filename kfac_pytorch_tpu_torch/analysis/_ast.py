"""Module index for the source analyses: functions, their calls, and
name lookup for one parsed module.

The port's own copy of ``_dotted``, ``_ModuleIndex`` and ``_last`` from
``kfac_pytorch_tpu/analysis/lint.py:215-325``: pure ``ast``, no import
of the code under analysis.
"""
from __future__ import annotations

import ast
from typing import Iterator


class _Func:
    """One function/lambda with its own (non-nested) calls."""

    __slots__ = (
        'node', 'name', 'parent', 'children', 'calls', 'params',
        'param_annotations', 'lineno', 'is_lambda',
    )

    def __init__(self, node: ast.AST, parent: '_Func | None') -> None:
        self.node = node
        self.is_lambda = isinstance(node, ast.Lambda)
        self.name = ('<lambda>' if self.is_lambda
                     else node.name)  # type: ignore[attr-defined]
        self.parent = parent
        self.children: list[_Func] = []
        self.calls: list[tuple[str | None, ast.Call]] = []
        args = node.args  # type: ignore[attr-defined]
        arg_nodes = list(args.posonlyargs) + list(args.args)
        self.params = [a.arg for a in arg_nodes]
        self.param_annotations = {
            a.arg: _annotation_str(a.annotation)
            for a in arg_nodes
            if a.annotation is not None
        }
        self.lineno = node.lineno  # type: ignore[attr-defined]
        if parent is not None:
            parent.children.append(self)

    def descendants(self) -> Iterator['_Func']:
        for c in self.children:
            yield c
            yield from c.descendants()


def _annotation_str(ann: ast.AST) -> str | None:
    """Dotted form of a parameter annotation (handles string forms)."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value
    return _dotted(ann)


def _dotted(expr: ast.AST) -> str | None:
    """``a.b.c`` for a chain of attributes on a name, else ``None``."""
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    else:
        return None
    return '.'.join(reversed(parts))


class _ModuleIndex:
    """Functions, per-function calls and name lookup for one module."""

    def __init__(self, tree: ast.Module) -> None:
        self.funcs: list[_Func] = []
        self.by_node: dict[int, _Func] = {}
        self.by_name: dict[str, list[_Func]] = {}
        self.module_calls: list[tuple[str | None, ast.Call]] = []
        self._walk(tree, None)

    def _register(self, node: ast.AST, owner: _Func | None) -> _Func:
        info = _Func(node, owner)
        self.funcs.append(info)
        self.by_node[id(node)] = info
        self.by_name.setdefault(info.name, []).append(info)
        return info

    def _walk(self, node: ast.AST, owner: _Func | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
            ):
                info = self._register(child, owner)
                self._walk(child, info)
                continue
            if isinstance(child, ast.Call):
                record = (
                    owner.calls if owner is not None
                    else self.module_calls
                )
                record.append((_dotted(child.func), child))
            self._walk(child, owner)

    def resolve(self, expr: ast.AST) -> list[_Func]:
        """Function candidates an fn-expression may refer to.

        A Call expression is a *factory*: ``wrap(make_body(...))`` runs
        whatever ``make_body`` returns, so every function nested inside
        it is a candidate.
        """
        if isinstance(expr, ast.Lambda):
            info = self.by_node.get(id(expr))
            return [info] if info is not None else []
        if isinstance(expr, ast.Name):
            return list(self.by_name.get(expr.id, []))
        if isinstance(expr, ast.Attribute):
            return list(self.by_name.get(expr.attr, []))
        if isinstance(expr, ast.Call):
            out: list[_Func] = []
            for factory in self.resolve(expr.func):
                out.extend(factory.descendants())
            return out
        return []


def _last(dotted: str) -> str:
    return dotted.rsplit('.', 1)[-1]
