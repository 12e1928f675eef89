"""Isolation guard: the PyTorch port never imports JAX or the JAX package.

An AST scan of every module of ``kfac_pytorch_tpu_torch/`` and of
``chip_smoke.py`` fails on any import of ``jax``, ``jaxlib``, ``flax``,
``optax`` or ``kfac_pytorch_tpu[.*]``; a fresh interpreter that imports
the whole port must add neither ``jax`` nor ``kfac_pytorch_tpu`` to
``sys.modules``.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'kfac_pytorch_tpu')


def _port_files() -> list[Path]:
    files = sorted((ROOT / 'kfac_pytorch_tpu_torch').rglob('*.py'))
    return files + [ROOT / 'chip_smoke.py']


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or '')
    return names


def _forbidden(name: str) -> bool:
    root = name.split('.')[0]
    return root in FORBIDDEN


def test_scan_finds_the_port():
    files = _port_files()
    assert len(files) > 15
    assert all(f.is_file() for f in files)


@pytest.mark.parametrize(
    'path', _port_files(), ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_imports(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f'{path.relative_to(ROOT)} imports {bad}'


def test_scanner_catches_forbidden_imports(tmp_path):
    src = tmp_path / 'm.py'
    src.write_text(
        'import os\nimport jax.numpy as jnp\n'
        'from kfac_pytorch_tpu.ops import cov\n'
        'from kfac_pytorch_tpu_torch import ops\n',
    )
    assert [n for n in _imported_modules(src) if _forbidden(n)] == [
        'jax.numpy', 'kfac_pytorch_tpu.ops',
    ]


def test_importing_the_port_loads_no_jax():
    code = (
        'import sys, pkgutil, importlib\n'
        'before = set(sys.modules)\n'
        'import kfac_pytorch_tpu_torch as kt\n'
        'for m in pkgutil.walk_packages(kt.__path__, kt.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = sorted(n for n in set(sys.modules) - before\n'
        '             if n.split(".")[0] in ("jax", "kfac_pytorch_tpu"))\n'
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n'
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, '-c', code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
