"""The port's native (C++) host planners and data kernels.

The ``ctypes`` libraries of ``kfac_pytorch_tpu_torch/_native``, built
here with ``g++`` from the port's own sources, must be output-identical
to their Python and numpy twins (``KAISAAssignment.greedy_assignment``,
the bucket column loop, the loader's crop and flip), and to the JAX
package's Python outputs on the same work: the 11 tests of
``tests/test_native.py``, on the port.  Besides: a failed build (a bad
compiler path) is not silent (``available()`` false, ``build_error()``,
a WARNING), two processes that build at once both load, and the native
calls are counted.
"""
from __future__ import annotations

import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kfac_pytorch_tpu_torch import _native
from kfac_pytorch_tpu_torch._native import data as native_data
from kfac_pytorch_tpu_torch.assignment import KAISAAssignment
from kfac_pytorch_tpu_torch.examples.cnn_utils.datasets import ArrayLoader
from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent


def worker_groups(world, grad_workers):
    return [
        sorted(ranks)
        for ranks in sorted(
            KAISAAssignment.partition_grad_workers(world, grad_workers),
            key=min,
        )
    ]


def jax_greedy(work, groups, world, colocate):
    from kfac_pytorch_tpu.assignment import KAISAAssignment as JaxAssignment

    return JaxAssignment.greedy_assignment(work, groups, world, colocate)


class TestNativeGreedyAssignment:
    @pytest.mark.parametrize('colocate', [True, False])
    @pytest.mark.parametrize('seed', range(5))
    def test_matches_python(self, colocate, seed):
        rng = np.random.default_rng(seed)
        world = int(rng.choice([1, 2, 4, 8]))
        grad_workers = int(rng.choice(
            [w for w in (1, 2, 4, 8) if w <= world],
        ))
        n_layers = int(rng.integers(1, 12))
        work = {
            f'layer{i}': {
                f: float(rng.choice([64, 128, 256, 512]) ** 3)
                for f in ('A', 'G')
            }
            for i in range(n_layers)
        }
        groups = worker_groups(world, grad_workers)
        expected = KAISAAssignment.greedy_assignment(
            work, groups, world, colocate,
        )
        got = _native.greedy_assignment(work, groups, world, colocate)
        assert got == expected
        assert got == jax_greedy(work, groups, world, colocate)

    def test_equal_cost_tiebreak(self):
        # Equal-cost factors: Python orders them by name, descending.
        work = {'l0': {'A': 8.0, 'G': 8.0}, 'l1': {'A': 8.0, 'G': 8.0}}
        groups = [[0, 1, 2, 3]]
        expected = KAISAAssignment.greedy_assignment(work, groups, 4, False)
        got = _native.greedy_assignment(work, groups, 4, False)
        assert got == expected == jax_greedy(work, groups, 4, False)

    def test_single_factor_layers(self):
        work = {'a': {'A': 27.0}, 'b': {'A': 8.0, 'G': 1.0}}
        groups = [[0], [1]]
        expected = KAISAAssignment.greedy_assignment(work, groups, 2, True)
        got = _native.greedy_assignment(work, groups, 2, True)
        assert got == expected == jax_greedy(work, groups, 2, True)


class TestNativeBucketColumns:
    @pytest.mark.parametrize('n_cols', [1, 2, 4])
    def test_matches_python_loop(self, n_cols):
        sizes = [5, 3, 1, 8]
        costs = [512.0 ** 3, 256.0 ** 3, 128.0 ** 3, 64.0 ** 3]
        got = _native.bucket_columns(sizes, costs, n_cols)
        col_loads = [0.0] * n_cols
        expected = []
        for size, cost in zip(sizes, costs):
            for _ in range(size):
                c = min(range(n_cols), key=lambda i: (col_loads[i], i))
                expected.append(c)
                col_loads[c] += cost
        assert got == expected


class TestAssignmentUsesNative:
    """``KAISAAssignment`` is the same with and without the library, and
    the JAX package's on the same work."""

    def test_end_to_end_consistency(self, monkeypatch):
        from kfac_pytorch_tpu.assignment import KAISAAssignment as JaxAsg

        work = {
            f'l{i}': {'A': float((i + 1) ** 3), 'G': float((i + 2) ** 3)}
            for i in range(7)
        }
        kw = dict(local_rank=0, world_size=8, grad_worker_fraction=0.5,
                  colocate_factors=True)
        before = _native.calls
        a1 = KAISAAssignment(work, **kw)
        assert _native.calls == before + 1
        monkeypatch.setattr(
            _native, 'greedy_assignment', lambda *a, **k: None,
        )
        a2 = KAISAAssignment(work, **kw)
        assert a1._inv_assignments == a2._inv_assignments
        assert a1._inv_assignments == JaxAsg(work, **kw)._inv_assignments


class TestBucketPlanUsesNative:
    def test_plan_identical_without_native(self, monkeypatch):
        from kfac_pytorch_tpu.layers.helpers import DenseHelper as JaxDense
        from kfac_pytorch_tpu.parallel.bucketing import (
            make_bucket_plan as jax_plan,
        )

        from kfac_pytorch_tpu_torch.layers.helpers import DenseHelper

        helpers = {
            f'd{i}': DenseHelper(
                name=f'd{i}', module=None, has_bias=True,
                in_features=32 * (i + 1), out_features=16,
            )
            for i in range(6)
        }
        before = _native.calls
        p1 = make_bucket_plan(helpers, n_cols=4)
        assert _native.calls == before + 1
        monkeypatch.setattr(
            _native, 'bucket_columns', lambda *a, **k: None,
        )
        p2 = make_bucket_plan(helpers, n_cols=4)
        assert p1 == p2
        want = jax_plan({
            f'd{i}': JaxDense(
                name=f'd{i}', path=('d', str(i)), has_bias=True,
                in_features=32 * (i + 1), out_features=16,
            )
            for i in range(6)
        }, n_cols=4)
        assert [(b.key, b.slots, b.seg) for b in p1.buckets] == [
            (b.key, b.slots, b.seg) for b in want.buckets]


class TestNativeRaggedGroups:
    def test_ragged_groups_fall_back(self):
        work = {'a': {'A': 1.0}}
        assert _native.greedy_assignment(work, [[0], [1, 2]], 3, True) is None
        got = KAISAAssignment.planned_assignment(work, [[0], [1, 2]], 3,
                                                 True)
        assert got == KAISAAssignment.greedy_assignment(
            work, [[0], [1, 2]], 3, True)


class TestNativeDataKernels:
    """The fused C++ gather, crop and flip against the numpy twin."""

    def test_available(self):
        assert native_data.available()
        with native_data.force_numpy():
            assert not native_data.available()
        assert native_data.available()

    def test_gather_parity(self):
        rng = np.random.default_rng(0)
        images = rng.standard_normal((50, 8, 8, 3)).astype(np.float32)
        idx = rng.integers(0, 50, size=17)
        before = native_data.calls
        out = native_data.gather(images, idx)
        assert out is not None and native_data.calls == before + 1
        np.testing.assert_array_equal(out, images[idx])

    def test_gather_crop_flip_parity(self):
        from examples.cnn_utils.datasets import ArrayLoader as JaxLoader

        rng = np.random.default_rng(1)
        images = rng.standard_normal((40, 32, 32, 3)).astype(np.float32)
        labels = rng.integers(0, 10, size=40)
        loader = ArrayLoader(images, labels, 16, augment=True)
        idx = rng.integers(0, 40, size=16)
        ys, xs, flips = loader._draw_augment(16, rng)
        native = native_data.gather_crop_flip(
            images, idx, ArrayLoader.PAD, ys, xs, flips,
        )
        assert native is not None
        ref = loader._augment_numpy(images[idx], ys, xs, flips)
        np.testing.assert_array_equal(native, ref)
        jax_ref = JaxLoader(images, labels, 16, augment=True)._augment_numpy(
            images[idx], ys, xs, flips)
        np.testing.assert_array_equal(native, jax_ref)

    def test_loader_epoch_determinism_with_native(self):
        rng = np.random.default_rng(2)
        images = rng.standard_normal((64, 32, 32, 3)).astype(np.float32)
        labels = rng.integers(0, 10, size=64)
        loader = ArrayLoader(images, labels, 32, augment=True, seed=7)
        loader.set_epoch(3)
        before = native_data.calls
        a = [x.copy() for x, _ in loader]
        assert native_data.calls == before + len(a)
        loader.set_epoch(3)
        b = [x.copy() for x, _ in loader]
        with native_data.force_numpy():
            c = [x.copy() for x, _ in loader]
        for xa, xb, xc in zip(a, b, c):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(xa, xc)


    def test_out_of_range_inputs_raise(self):
        # The C++ reads unchecked; the wrappers check first, as numpy's
        # indexing would, and the planner leaves bad ranks to the twin.
        images = np.zeros((4, 8, 8, 3), np.float32)
        for idx in ([4], [-1]):
            with pytest.raises(IndexError, match='out of range'):
                native_data.gather(images, np.array(idx))
            with pytest.raises(IndexError, match='out of range'):
                native_data.gather_crop_flip(images, np.array(idx), 2,
                                             [0], [0], [0])
        with pytest.raises(ValueError, match='offsets'):
            native_data.gather_crop_flip(images, np.array([0]), 2, [5],
                                         [0], [0])
        work = {'a': {'A': 1.0}}
        assert _native.greedy_assignment(work, [[0], [5]], 2, True) is None
        with pytest.raises(IndexError):
            KAISAAssignment.planned_assignment(work, [[0], [5]], 2, True)


class TestBuild:
    def test_library_builds_from_the_port(self):
        assert _native.available() and _native.build_error() is None
        assert _native.build_seconds() is not None
        port = ROOT / 'kfac_pytorch_tpu_torch'
        for lib in (_native.planner, native_data.library):
            assert lib.source.is_relative_to(port / '_native')
            assert lib.path.is_relative_to(port / '_build')
            assert lib.path.is_file()

    def test_failed_build_is_not_silent(self, monkeypatch, caplog):
        monkeypatch.setattr(_native, 'COMPILER',
                            str(ROOT / 'no-such-dir' / 'g++'))
        broken = _native.NativeLibrary(
            'kfac_planner', (), _native._bind_planner)
        monkeypatch.setattr(_native, 'planner', broken)
        with caplog.at_level(logging.WARNING, logger=_native.__name__):
            assert not _native.available()
            assert not _native.available()
        assert 'no-such-dir' in _native.build_error()
        warnings = [r for r in caplog.records
                    if r.levelno == logging.WARNING]
        assert len(warnings) == 1 and 'kfac_planner' in warnings[0].message
        # The Python twin takes over.
        work = {'l0': {'A': 8.0, 'G': 1.0}, 'l1': {'A': 27.0, 'G': 1.0}}
        assert _native.greedy_assignment(work, [[0], [1]], 2, True) is None
        got = KAISAAssignment(work, local_rank=0, world_size=2,
                              grad_worker_fraction=1.0)
        assert got._inv_assignments == KAISAAssignment.greedy_assignment(
            work, [[0], [1]], 2, True)

    def test_two_processes_build_at_once(self, tmp_path):
        code = (
            'import sys\n'
            'from pathlib import Path\n'
            'from kfac_pytorch_tpu_torch import _native\n'
            '_native.BUILD_ROOT = Path(sys.argv[1])\n'
            'ok = _native.available()\n'
            'print(ok, _native.build_error())\n'
            'sys.exit(0 if ok else 1)\n'
        )
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        procs = [subprocess.Popen(
            [sys.executable, '-c', code, str(tmp_path)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for _ in range(2)]
        outs = [p.communicate(timeout=180)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0], outs
        built = sorted(p.name for p in tmp_path.rglob('*') if p.is_file())
        assert built == ['libkfac_planner.so'], built
