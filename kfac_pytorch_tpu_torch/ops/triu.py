"""Symmetric-matrix upper-triangle packing.

Port of ``kfac_pytorch_tpu/ops/triu.py``: the storage encoding of
``state_dict(compress_symmetric=True)`` (factor checkpoints halve).
Works batched over leading stack dimensions.
"""
from __future__ import annotations

import torch


class NonSquareTensorError(Exception):
    """Matrix is not square."""


def _check_square(t: torch.Tensor) -> int:
    if t.ndim < 2 or t.shape[-1] != t.shape[-2]:
        raise NonSquareTensorError(
            f'tensor must have two equal trailing dims, got {tuple(t.shape)}',
        )
    return t.shape[-1]


def get_triu(t: torch.Tensor) -> torch.Tensor:
    """Flattened upper triangle: ``[..., n, n] -> [..., n(n+1)/2]``,
    row by row (the order of ``numpy.triu_indices``)."""
    n = _check_square(t)
    rows, cols = torch.triu_indices(n, n, device=t.device)
    return t[..., rows, cols]


def fill_triu(shape: tuple[int, ...], triu: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix of full shape ``shape`` (trailing dims
    ``(n, n)``) whose packed upper triangle is ``triu``."""
    shape = tuple(shape)
    if len(shape) < 2 or shape[-1] != shape[-2]:
        raise NonSquareTensorError(
            f'shape must have two equal trailing dims, got {shape}',
        )
    n = shape[-1]
    rows, cols = torch.triu_indices(n, n, device=triu.device)
    out = torch.zeros(shape, dtype=triu.dtype, device=triu.device)
    out[..., rows, cols] = triu
    out[..., cols, rows] = triu  # the mirror; the diagonal is written twice
    return out
