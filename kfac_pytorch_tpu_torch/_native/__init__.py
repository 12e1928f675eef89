"""Native (C++) host planners of the port, loaded through ``ctypes``.

Port of ``kfac_pytorch_tpu/_native/__init__.py``, with its own copies of
the C++ sources (``kfac_planner.cc`` here, ``kfac_data.cc`` for
:mod:`.data`).  Each library is compiled with ``g++ -O3 -shared -fPIC
-std=c++17`` at its first use, never at import, into
``kfac_pytorch_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``),
where ``<hash>`` covers the source, the compiler and the flags: an edited
source builds anew, an unchanged one loads the library already there.
The compiler writes a temporary file that is renamed into place, so
processes that build at once (pytest-xdist workers, spawned ranks) never
load a torn library.

Every entry point has a Python twin, :meth:`~kfac_pytorch_tpu_torch.\
assignment.KAISAAssignment.greedy_assignment` and the column loop of
:func:`~kfac_pytorch_tpu_torch.parallel.bucketing.make_bucket_plan`;
``tests/test_torch_native.py`` holds the two output-identical, so the
callers take the twin whenever a native call returns ``None``.  Where the
JAX package degrades quietly, a failed build here is logged at WARNING
once and stays readable (:func:`available`, :func:`build_error`), and
:data:`calls` counts the native calls, so a run can show that the native
path ran.

API:
    ``available()`` — whether the planner library built and loaded.
    ``build_error()`` — the compiler's or loader's message, or ``None``.
    ``build_seconds()`` — the compile time of this process's build
    (``0.0`` when the library was already built, ``None`` before a load).
    ``greedy_assignment(...)`` — KAISA LPT assignment (or ``None``).
    ``bucket_columns(...)`` — bucket column packing (or ``None``).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Mapping, Sequence

import numpy as np

logger = logging.getLogger(__name__)

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_ROOT = NATIVE_DIR.parent / '_build'
#: The host compiler.
COMPILER = 'g++'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')
BUILD_TIMEOUT_S = 120

#: Native planner calls that returned a result (both entry points).
calls = 0

_lock = threading.Lock()


class NativeLibrary:
    """One C++ source's build, load and failure state.

    ``bind(lib)`` sets the ``ctypes`` signatures of the loaded library.
    The first :meth:`load` builds (when no library for this source,
    compiler and flags exists yet) and loads; a failure is kept in
    :attr:`error` and logged at WARNING once, and later loads return
    ``None`` without running the compiler again.
    """

    def __init__(
        self,
        stem: str,
        extra_flags: Sequence[str],
        bind: Callable[[ctypes.CDLL], None],
    ) -> None:
        self.stem = stem
        self.source = NATIVE_DIR / f'{stem}.cc'
        self.extra_flags = tuple(extra_flags)
        self.bind = bind
        self.lib: ctypes.CDLL | None = None
        self.error: str | None = None
        self.seconds: float | None = None

    def flags(self) -> tuple[str, ...]:
        return CXX_FLAGS + self.extra_flags

    @property
    def path(self) -> Path:
        """The library for the source, compiler and flags as they are
        now, built or not."""
        h = hashlib.sha256(
            ' '.join((COMPILER,) + self.flags()).encode())
        h.update(self.source.read_bytes())
        return BUILD_ROOT / h.hexdigest()[:16] / f'lib{self.stem}.so'

    def _build(self, path: Path) -> float:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=f'lib{self.stem}.', suffix='.so.tmp', dir=path.parent)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            out = subprocess.run(
                [COMPILER, *self.flags(), '-o', tmp, str(self.source)],
                capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
            )
            if out.returncode != 0:
                raise RuntimeError(
                    f'{COMPILER} exited {out.returncode} on '
                    f'{self.source.name}:\n{out.stderr.strip()}')
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return time.perf_counter() - t0

    def load(self) -> ctypes.CDLL | None:
        with _lock:
            if self.lib is not None or self.error is not None:
                return self.lib
            try:
                path = self.path
                seconds = 0.0 if path.is_file() else self._build(path)
                lib = ctypes.CDLL(str(path))
                self.bind(lib)
            except (OSError, subprocess.SubprocessError,
                    RuntimeError) as exc:
                self.error = f'{type(exc).__name__}: {exc}'
                logger.warning(
                    'native library %s did not build or load; the Python '
                    'twin runs instead: %s', self.stem, self.error)
                return None
            self.lib, self.seconds = lib, seconds
            return lib


def _bind_planner(lib: ctypes.CDLL) -> None:
    i32 = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    f64 = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
    lib.kfac_greedy_assignment.restype = ctypes.c_int
    lib.kfac_greedy_assignment.argtypes = [
        ctypes.c_int32, ctypes.c_int32, f64, i32,
        ctypes.c_int32, ctypes.c_int32, i32,
        ctypes.c_int32, ctypes.c_int32, i32,
    ]
    lib.kfac_bucket_columns.restype = ctypes.c_int
    lib.kfac_bucket_columns.argtypes = [
        ctypes.c_int32, i32, f64, ctypes.c_int32, i32,
    ]


planner = NativeLibrary('kfac_planner', (), _bind_planner)


def available() -> bool:
    """Whether the planner library built and loaded."""
    return planner.load() is not None


def build_error() -> str | None:
    """Why the planner library did not build or load, or ``None``."""
    planner.load()
    return planner.error


def build_seconds() -> float | None:
    """Seconds this process spent compiling the planner library."""
    planner.load()
    return planner.seconds


def greedy_assignment(
    work: Mapping[str, Mapping[str, float]],
    worker_groups: Sequence[Sequence[int]],
    world_size: int,
    colocate_factors: bool,
) -> dict[str, dict[str, int]] | None:
    """Native KAISA greedy assignment, the contract of
    ``KAISAAssignment.greedy_assignment``; ``None`` without the library
    or with ragged worker groups (the Python twin takes those)."""
    global calls
    lib = planner.load()
    if lib is None:
        return None
    layers = list(work)
    factor_names = sorted({f for fs in work.values() for f in fs})
    n_layers, n_factors = len(layers), max(1, len(factor_names))
    costs = np.full((n_layers, n_factors), -1.0, np.float64)
    # Python breaks equal-cost factor ties by name, descending (sorted
    # by (cost, name), reverse=True): the rank of the name in ascending
    # order, higher first.
    tie = np.zeros((n_layers, n_factors), np.int32)
    for li, layer in enumerate(layers):
        for fi, f in enumerate(factor_names):
            if f in work[layer]:
                costs[li, fi] = float(work[layer][f])
                tie[li, fi] = fi
    rows = [sorted(g) for g in worker_groups]
    if len({len(r) for r in rows}) > 1:
        return None
    if any(not 0 <= w < world_size for r in rows for w in r):
        # The C++ indexes its loads by rank; the twin raises here.
        return None
    groups = np.ascontiguousarray(np.asarray(rows, np.int32))
    out = np.empty((n_layers, n_factors), np.int32)
    rc = lib.kfac_greedy_assignment(
        n_layers, n_factors, costs, tie,
        groups.shape[0], groups.shape[1], groups,
        world_size, int(colocate_factors), out,
    )
    if rc != 0:
        return None
    calls += 1
    return {
        layer: {
            f: int(out[li, fi])
            for fi, f in enumerate(factor_names)
            if f in work[layer]
        }
        for li, layer in enumerate(layers)
    }


def bucket_columns(
    bucket_sizes: Sequence[int],
    bucket_costs: Sequence[float],
    n_cols: int,
) -> list[int] | None:
    """Native bucket column packing: per layer, in the order the buckets
    and their layers are given, the least-loaded column (the lowest on
    ties); ``None`` without the library."""
    global calls
    lib = planner.load()
    if lib is None:
        return None
    sizes = np.ascontiguousarray(bucket_sizes, np.int32)
    costs = np.ascontiguousarray(bucket_costs, np.float64)
    out = np.empty(int(sizes.sum()), np.int32)
    rc = lib.kfac_bucket_columns(len(sizes), sizes, costs, int(n_cols), out)
    if rc != 0:
        return None
    calls += 1
    return out.tolist()
