"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes``.  The build
runs at first CUDA use, never at import, into
``kfac_pytorch_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``),
where ``<hash>`` covers the sources and the compiler flags: an edited
source builds anew, an unchanged one loads the library already there.
All sources compile at once, one ``nvcc`` process each.  A failed build
raises; nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_ROOT = PACKAGE_DIR / '_build'
#: ``--split-compile=0`` runs the device code's optimisation and
#: assembly on every core: the fused kernel's source, with its fourteen
#: ``wgmma`` pass instantiations, took about twice as long to build
#: without it on the H100 machine's 8 cores (``chip_smoke.py``'s
#: ``build:`` line, ``PERF.md``), to the same registers and no spills.
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
    '--split-compile=0',
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
#: Per-source build record: ``{'seconds', 'path', 'log', 'built'}``.
build_log: dict[str, dict] = {}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob('*.cu'))


def _source_hash(sources: list[Path]) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    candidates = []
    for env in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(env):
            candidates.append(Path(os.environ[env]) / 'bin' / 'nvcc')
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin '
            'and PATH): the CUDA kernels cannot be built',
        )
    return found


def library_paths() -> dict[str, Path]:
    """``{stem: library path}`` of every ``csrc/*.cu`` for the sources
    as they are now, built or not."""
    sources = _sources()
    out_dir = BUILD_ROOT / _source_hash(sources)
    return {src.stem: out_dir / f'lib{src.stem}.so' for src in sources}


def build_all() -> dict[str, Path]:
    """Build every ``csrc/*.cu`` that has no library yet; return
    ``{stem: library path}``.  Raises ``RuntimeError`` on a failed build.
    """
    sources = _sources()
    libs = library_paths()
    out_dir = next(iter(libs.values())).parent if libs else BUILD_ROOT
    todo = [src for src in sources if not libs[src.stem].is_file()]
    for src in sources:
        if src not in todo:
            build_log.setdefault(src.stem, {
                'seconds': 0.0, 'path': str(libs[src.stem]), 'log': '',
                'built': False,
            })
    if not todo:
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # Build timing on the host, at first use: never in a step.
    t0 = time.perf_counter()  # torchlint: allow(nondeterminism)
    procs = []
    for src in todo:
        # Build into a temporary name and rename: a concurrent build
        # or an interrupted build never leaves a torn library behind.
        fd, tmp = tempfile.mkstemp(
            prefix=f'lib{src.stem}.', suffix='.so.tmp', dir=out_dir,
        )
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        # The build's seconds, for its log line.
        seconds = time.perf_counter() - t0  # torchlint: allow(nondeterminism)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f'{src.name} (exit {proc.returncode}):\n{log}')
            continue
        os.replace(tmp, libs[src.stem])
        build_log[src.stem] = {
            'seconds': seconds, 'path': str(libs[src.stem]), 'log': log,
            'built': True,
        }
    if failures:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failures))
    return libs


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use)."""
    with _lock:
        lib = _libraries.get(stem)
        if lib is None:
            libs = build_all()
            if stem not in libs:
                raise RuntimeError(f'no kernel source csrc/{stem}.cu')
            lib = ctypes.CDLL(str(libs[stem]))
            _libraries[stem] = lib
        return lib
