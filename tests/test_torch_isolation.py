"""Isolation guard: the PyTorch port never imports JAX or the JAX package.

An AST scan of every module of ``kfac_pytorch_tpu_torch/`` (the
trainers and the bench included), of ``chip_smoke.py`` and of the chip
probes in ``chip_probes/`` fails on any
import of ``jax``, ``jaxlib``, ``flax``, ``optax`` or
``kfac_pytorch_tpu[.*]``; a fresh interpreter that imports the whole
port, or parses the trainers' and the bench's command lines, must add
neither ``jax`` nor ``kfac_pytorch_tpu`` to ``sys.modules``.  The port's
host C++ (``_native``) builds and loads from its own sources and build
directory, never from ``kfac_pytorch_tpu/``.
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
    return (files + [ROOT / 'chip_smoke.py']
            + sorted((ROOT / 'chip_probes').glob('*.py')))


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
    port = ROOT / 'kfac_pytorch_tpu_torch'
    for module in ('layers/coverage.py', 'models/gpt.py', 'models/resnet.py',
                   'models/layers.py', 'models/vit.py', 'models/bert.py',
                   'bench.py', 'utils/backend.py', 'utils/metrics.py',
                   'examples/utils.py', 'examples/cifar10_resnet.py',
                   'examples/imagenet_resnet.py',
                   'examples/tiny_gpt_lm.py', 'examples/squad_bert.py',
                   'examples/cnn_utils/datasets.py',
                   'examples/cnn_utils/engine.py',
                   'examples/cnn_utils/optimizers.py', 'ops/lowrank.py',
                   'ops/ekfac.py', 'adaptive.py', 'health.py',
                   'consistency.py', 'tracing.py', 'testing.py',
                   'elastic.py', 'watchdog.py', 'utils/checkpoint.py',
                   'placement/__init__.py', 'placement/topology.py',
                   'placement/solver.py', 'placement/apply.py',
                   '_native/__init__.py', '_native/data.py'):
        assert port / module in files, module


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


def test_native_loads_only_the_ports_files():
    """The port's host C++ builds from its own sources into its own build
    directory: in a fresh interpreter both libraries load, and no file
    under ``kfac_pytorch_tpu/`` is mapped into the process."""
    code = (
        'import sys\n'
        'from kfac_pytorch_tpu_torch import _native\n'
        'from kfac_pytorch_tpu_torch._native import data\n'
        'assert _native.available() and data.available()\n'
        'for lib in (_native.planner, data.library):\n'
        '    print(lib.source)\n'
        '    print(lib.path)\n'
        '    print(lib.lib._name)\n'
        'maps = open("/proc/self/maps").read().split()\n'
        'print("\\n".join(m for m in maps if m.endswith(".so")))\n'
        'print("jax:", [n for n in sys.modules\n'
        '               if n.split(".")[0] in ("jax", "kfac_pytorch_tpu")])\n'
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, '-c', code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.split('\n')
    assert lines[-2] == 'jax: []'
    port = ROOT / 'kfac_pytorch_tpu_torch'
    for path in lines[:6]:
        assert Path(path).resolve().is_relative_to(port), path
    jax_package = str(ROOT / 'kfac_pytorch_tpu') + os.sep
    assert not [p for p in lines if p.startswith(jax_package)]
    assert sorted((port / '_native').glob('*.cc')) == [
        port / '_native' / 'kfac_data.cc',
        port / '_native' / 'kfac_planner.cc']


def test_entry_points_load_no_jax():
    """The trainers' and the bench's command lines parse, and the help of
    each prints, in a fresh interpreter that loads neither JAX nor the
    JAX package."""
    code = (
        'import sys, contextlib, io\n'
        'from kfac_pytorch_tpu_torch import bench\n'
        'from kfac_pytorch_tpu_torch.examples import cifar10_resnet\n'
        'from kfac_pytorch_tpu_torch.examples import imagenet_resnet\n'
        'from kfac_pytorch_tpu_torch.examples import squad_bert\n'
        'from kfac_pytorch_tpu_torch.examples import tiny_gpt_lm\n'
        'cifar10_resnet.parse_args([])\n'
        'imagenet_resnet.parse_args([])\n'
        'squad_bert.parse_args([])\n'
        'tiny_gpt_lm.parse_args([])\n'
        'for main in (bench.main, cifar10_resnet.parse_args,\n'
        '             imagenet_resnet.parse_args, squad_bert.parse_args,\n'
        '             tiny_gpt_lm.parse_args):\n'
        '    with contextlib.redirect_stdout(io.StringIO()):\n'
        '        try:\n'
        '            main(["--help"])\n'
        '        except SystemExit as e:\n'
        '            assert e.code == 0, e.code\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "flax", "optax",\n'
        '                                    "kfac_pytorch_tpu"))\n'
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n'
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, '-c', code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
