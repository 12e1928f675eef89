"""Abstract signatures of nested tensors and their structured diffs.

Port of ``kfac_pytorch_tpu/analysis/signature.py``.  What a step
variant reads is identified by its *abstract signature*: for every leaf
of the nested inputs, its shape, dtype and device (a tensor), or that it
is a Python number (a host scalar: the torch counterpart of JAX's weak
type, since a compiled consumer specializes on its value), or its
``repr`` (anything else, as a static cache key sees it).  Two dispatches
with one signature run the same program; a changed signature is a new
program.  :func:`diff_signatures` classifies every changed leaf (shape
drift, dtype change, a host scalar against a 0-d tensor, structure), the
vocabulary of the retrace guard
(:mod:`kfac_pytorch_tpu_torch.analysis.retrace`) and the contract pass
(:mod:`kfac_pytorch_tpu_torch.analysis.contracts`).

A signature is ``dict[path, LeafSig]``; paths are JAX's ``keystr`` form
(``['grads']['linear1'][0]``, ``.a_factor`` for an attribute).  It works
on real and fake tensors alike, and reads no tensor's values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping

import torch

__all__ = [
    'LeafSig',
    'SigDiff',
    'abstract_signature',
    'diff_signatures',
    'flatten',
    'format_diffs',
    'format_signature',
]


@dataclasses.dataclass(frozen=True)
class LeafSig:
    """Trace-relevant traits of one leaf.

    Attributes:
        kind: ``'array'`` (a tensor, real or fake), ``'py-scalar'`` (a
            Python ``bool``/``int``/``float``/``complex``: a host scalar,
            specialized on by value), or ``'static'`` (any other leaf,
            by ``repr``).
        shape: the tensor's shape (``()`` for scalars and statics).
        dtype: the dtype name without ``torch.`` (``'float32'``), the
            Python type name of a host scalar, or a static's ``repr``.
        weak: whether the leaf is a host scalar (JAX's weak type).
        device: the tensor's device type (``'cpu'``, ``'cuda'``,
            ``'meta'``), ``'host'`` for a numpy array, ``''`` otherwise.
        layout: ``''`` for a contiguous tensor, else its strides
            (``'strides(1, 64)'``): a compiled consumer guards on them,
            so a tensor that changes layout is a new program.
    """

    kind: str
    shape: tuple[int, ...]
    dtype: str
    weak: bool
    device: str = ''
    layout: str = ''

    def describe(self) -> str:
        if self.kind == 'static':
            return f'static {self.dtype}'
        weak = ' (weak)' if self.weak else ''
        if self.kind == 'py-scalar':
            return f'py-scalar {self.dtype}{weak}'
        dev = f' @{self.device}' if self.device else ''
        layout = f' {self.layout}' if self.layout else ''
        return f'{self.dtype}{list(self.shape)}{weak}{dev}{layout}'


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix('torch.')


def _leaf_sig(x: Any) -> LeafSig:
    if isinstance(x, torch.Tensor):
        return LeafSig(
            kind='array',
            shape=tuple(int(d) for d in x.shape),
            dtype=_dtype_name(x.dtype),
            weak=False,
            device=x.device.type,
            layout=('' if x.is_contiguous()
                    else f'strides{tuple(x.stride())}'),
        )
    if isinstance(x, (bool, int, float, complex)):
        return LeafSig(kind='py-scalar', shape=(), dtype=type(x).__name__,
                       weak=True)
    if hasattr(x, 'shape') and hasattr(x, 'dtype'):  # numpy, on the host
        return LeafSig(kind='array', shape=tuple(int(d) for d in x.shape),
                       dtype=str(x.dtype), weak=False, device='host')
    return LeafSig(kind='static', shape=(), dtype=repr(x), weak=False)


def flatten(tree: Any, path: str = '') -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested structure, in JAX's order: a
    mapping by sorted key, a list or tuple by index, a dataclass by
    field; ``None`` is an empty subtree, anything else a leaf."""
    if tree is None:
        return
    if isinstance(tree, Mapping):
        for k in sorted(tree, key=repr):
            yield from flatten(tree[k], f'{path}[{k!r}]')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f'{path}[{i}]')
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from flatten(getattr(tree, f.name), f'{path}.{f.name}')
    else:
        yield path, tree


def abstract_signature(tree: Any) -> dict[str, LeafSig]:
    """Leaf path -> :class:`LeafSig` of a nested structure."""
    return {path: _leaf_sig(leaf) for path, leaf in flatten(tree)}


@dataclasses.dataclass(frozen=True)
class SigDiff:
    """One changed leaf between two signatures.

    ``kind`` says why the leaf makes a new program: ``'shape'`` (shape
    drift, e.g. a ragged last batch), ``'dtype'`` (e.g. f32 turned
    bf16), ``'weak-type'`` (same dtype, the host-scalar flag flipped),
    ``'device'`` (same shape and dtype on another device type),
    ``'layout'`` (same shape, dtype and device, other strides),
    ``'kind'`` (a leaf changed category: a Python number against a 0-d
    tensor), ``'static'`` (a static leaf's value changed), ``'added'`` /
    ``'removed'`` (the structure changed).
    """

    path: str
    kind: str
    old: LeafSig | None
    new: LeafSig | None

    def format(self) -> str:
        old = self.old.describe() if self.old is not None else '<absent>'
        new = self.new.describe() if self.new is not None else '<absent>'
        return f'{self.path}: {self.kind}: {old} -> {new}'


def diff_signatures(
    old: Mapping[str, LeafSig],
    new: Mapping[str, LeafSig],
) -> list[SigDiff]:
    """Classified per-leaf differences between two signatures."""
    diffs: list[SigDiff] = []
    for path in sorted(set(old) | set(new)):
        a, b = old.get(path), new.get(path)
        if a == b:
            continue
        if a is None:
            diffs.append(SigDiff(path, 'added', None, b))
        elif b is None:
            diffs.append(SigDiff(path, 'removed', a, None))
        elif a.kind != b.kind:
            diffs.append(SigDiff(path, 'kind', a, b))
        elif a.kind == 'static':
            diffs.append(SigDiff(path, 'static', a, b))
        elif a.shape != b.shape:
            diffs.append(SigDiff(path, 'shape', a, b))
        elif a.dtype != b.dtype:
            diffs.append(SigDiff(path, 'dtype', a, b))
        elif a.device != b.device:
            diffs.append(SigDiff(path, 'device', a, b))
        elif a.layout != b.layout:
            diffs.append(SigDiff(path, 'layout', a, b))
        else:
            diffs.append(SigDiff(path, 'weak-type', a, b))
    return diffs


def format_diffs(diffs: list[SigDiff], indent: str = '  ') -> str:
    return '\n'.join(indent + d.format() for d in diffs)


def format_signature(
    sig: Mapping[str, LeafSig], indent: str = '  ',
) -> str:
    return '\n'.join(
        f'{indent}{path}: {leaf.describe()}'
        for path, leaf in sorted(sig.items())
    )
