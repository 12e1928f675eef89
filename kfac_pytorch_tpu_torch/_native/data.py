"""Native (C++) fused data-pipeline kernels, loaded through ``ctypes``.

Port of ``kfac_pytorch_tpu/_native/data.py``.  ``libkfac_data.so`` is
compiled from the port's ``kfac_data.cc`` at its first use, by the
build of :mod:`kfac_pytorch_tpu_torch._native` (with ``-pthread``).
Every entry point has a numpy twin in the trainers' ``ArrayLoader``
(:mod:`kfac_pytorch_tpu_torch.examples.cnn_utils.datasets`); the
randomness (crop offsets, flips) is drawn in Python, so the two paths
are bit-identical under the same draws (``tests/test_torch_native.py``).
:data:`calls` counts the native calls.
"""
from __future__ import annotations

import contextlib
import ctypes
import os

import numpy as np

from kfac_pytorch_tpu_torch._native import NativeLibrary

#: Native data-kernel calls that returned a batch.
calls = 0

_forced_numpy = False


def _bind(lib: ctypes.CDLL) -> None:
    f32 = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    i64 = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
    i32 = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    u8 = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
    lib.kfac_gather_crop_flip.restype = None
    lib.kfac_gather_crop_flip.argtypes = [
        f32, i64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i32, i32, u8, f32, ctypes.c_int64,
    ]
    lib.kfac_gather.restype = None
    lib.kfac_gather.argtypes = [
        f32, i64, ctypes.c_int64, ctypes.c_int64, f32, ctypes.c_int64,
    ]


library = NativeLibrary('kfac_data', ('-pthread',), _bind)


def _load() -> ctypes.CDLL | None:
    return None if _forced_numpy else library.load()


def available() -> bool:
    """Whether the native data kernels built and loaded."""
    return _load() is not None


@contextlib.contextmanager
def force_numpy():
    """Turn the native kernels off inside the context, so a caller times
    or compares the numpy twin without touching module internals."""
    global _forced_numpy
    saved = _forced_numpy
    _forced_numpy = True
    try:
        yield
    finally:
        _forced_numpy = saved


def _check_index(idx: np.ndarray, n: int) -> None:
    """The C++ reads ``images[idx]`` unchecked: every index must lie in
    ``[0, n)``, as numpy's fancy indexing would demand."""
    idx = np.asarray(idx)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f'image index out of range [0, {n})')


def _threads() -> int:
    return min(8, os.cpu_count() or 1)


def gather_crop_flip(
    images: np.ndarray,
    idx: np.ndarray,
    pad: int,
    ys: np.ndarray,
    xs: np.ndarray,
    flips: np.ndarray,
) -> np.ndarray | None:
    """Fused gather, reflect-pad crop and horizontal flip; ``None``
    without the library or for images that are not C-contiguous f32.

    ``images``: ``[N, H, W, C]`` f32; ``idx``/``ys``/``xs``/``flips``:
    one draw per output image (``ys``/``xs`` in ``[0, 2*pad]``).
    """
    global calls
    lib = _load()
    if lib is None:
        return None
    if images.dtype != np.float32 or not images.flags.c_contiguous:
        return None
    b = len(idx)
    n, h, w, c = images.shape
    _check_index(idx, n)
    ys, xs = np.asarray(ys), np.asarray(xs)
    if not (len(ys) == len(xs) == len(flips) == b and 0 <= pad < min(h, w)
            and ((ys >= 0) & (ys <= 2 * pad)).all()
            and ((xs >= 0) & (xs <= 2 * pad)).all()):
        raise ValueError(
            f'gather_crop_flip: {b} images need {b} draws each with offsets '
            f'in [0, {2 * pad}] and a pad below the image size {h}x{w}')
    out = np.empty((b, h, w, c), np.float32)
    lib.kfac_gather_crop_flip(
        images,
        np.ascontiguousarray(idx, np.int64),
        b, h, w, c, pad,
        np.ascontiguousarray(ys, np.int32),
        np.ascontiguousarray(xs, np.int32),
        np.ascontiguousarray(flips, np.uint8),
        out,
        _threads(),
    )
    calls += 1
    return out


def gather(images: np.ndarray, idx: np.ndarray) -> np.ndarray | None:
    """The batch gather ``images[idx]``; ``None`` without the library or
    for images that are not C-contiguous f32."""
    global calls
    lib = _load()
    if lib is None:
        return None
    if images.dtype != np.float32 or not images.flags.c_contiguous:
        return None
    b = len(idx)
    _check_index(idx, images.shape[0])
    item = int(np.prod(images.shape[1:]))
    out = np.empty((b,) + images.shape[1:], np.float32)
    lib.kfac_gather(
        images, np.ascontiguousarray(idx, np.int64), b, item, out,
        _threads(),
    )
    calls += 1
    return out
