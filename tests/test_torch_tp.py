"""The port's tensor-parallel layers and ``gpt.mpu``, on the CPU.

* Four gloo ranks (subprocesses of this file) on a ``('data', 'model')``
  grid of ``2 x 2``: ``ColumnParallelDense`` (``qkv``'s head-aware split,
  ``parts=3``, and the plain one) and ``RowParallelDense`` at ``tp = 2``
  against the full ``Dense`` from the same weights: the output, the
  input gradient and each rank's weight and bias gradients; their K-FAC
  helpers: the full combined gradient, the gathered G (column) and A
  (row) factors, ``set_grad`` writing back the rank's slice; the
  tensor-parallel ``gpt_tiny`` against the unsharded one (logits, and
  each layer's combined gradient through the helpers); the gather and
  scatter of ``mpu`` over either axis.
* ``mpu``'s nine cases of ``tests/test_mpu.py`` (the split, the gather
  and the scatter, the axis checks, coordinates and peers).
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch import KFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.gpt import mpu  # noqa: E402
from kfac_pytorch_tpu_torch.layers.tensor import parallel_dense_helper  # noqa
from kfac_pytorch_tpu_torch.models import gpt_tiny  # noqa: E402
from kfac_pytorch_tpu_torch.models.layers import Dense  # noqa: E402
from kfac_pytorch_tpu_torch.ops import cov  # noqa: E402
from kfac_pytorch_tpu_torch.parallel import tensor as tp_lib  # noqa: E402
from kfac_pytorch_tpu_torch.parallel.mesh import AxisGroups  # noqa: E402
from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

WORLD = 4
TP = 2
#: name -> (in, out, split, parts)
LAYERS = {'qkv': (8, 12, 'column', 3), 'fc_in': (8, 16, 'column', 1),
          'proj': (8, 6, 'row', 1)}
X_SHAPE = (2, 5)
SPAWN_TIMEOUT_S = 300
NAMES = ('data', 'model')


def layer_data(name):
    n_in, n_out, _, _ = LAYERS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return dict(
        w=rng.standard_normal((n_out, n_in)).astype(np.float32),
        b=rng.standard_normal(n_out).astype(np.float32),
        x=rng.standard_normal(X_SHAPE + (n_in,)).astype(np.float32),
        cot=rng.standard_normal(X_SHAPE + (n_out,)).astype(np.float32),
    )


def full_dense(name):
    """The full layer's output, input gradient, combined gradient
    ``[out, in + 1]`` and A/G factors under ``sum(y * cot)``."""
    d = layer_data(name)
    n_in, n_out, _, _ = LAYERS[name]
    layer = Dense(n_in, n_out, torch.float32)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(d['w']))
        layer.bias.copy_(torch.from_numpy(d['b']))
    x = torch.from_numpy(d['x']).requires_grad_()
    y = layer(x)
    (y * torch.from_numpy(d['cot'])).sum().backward()
    combined = torch.cat([layer.weight.grad, layer.bias.grad[:, None]], 1)
    return dict(y=y.detach(), dx=x.grad, combined=combined,
                A=cov.linear_a_factor(x.detach()),
                G=cov.linear_g_factor(torch.from_numpy(d['cot'])))


def mpu_data():
    return torch.arange(32.0).reshape(4, 8)


# -- the worker ranks --------------------------------------------------------


def parallel_layer(name, group, rank):
    n_in, n_out, split, parts = LAYERS[name]
    d = layer_data(name)
    if split == 'column':
        layer = tp_lib.ColumnParallelDense(n_in, n_out, torch.float32,
                                           group, parts=parts)
    else:
        layer = tp_lib.RowParallelDense(n_in, n_out, torch.float32, group)
    w, b = tp_lib.shard_dense_state(torch.from_numpy(d['w']),
                                    torch.from_numpy(d['b']), split, rank,
                                    TP, parts)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    return layer


def run_layer(name, group, rank):
    """The rank's side of one layer: output, input gradient, local
    weight and bias gradients, the helper's combined gradient and
    factor, and the ``.grad`` a ``set_grad`` of twice the combined
    gradient leaves."""
    _, _, split, parts = LAYERS[name]
    d = layer_data(name)
    layer = parallel_layer(name, group, rank)
    x = torch.from_numpy(d['x'])
    cot = torch.from_numpy(d['cot'])
    if split == 'row':
        x = tp_lib.shard_features(x, rank, TP)
    else:
        cot = tp_lib.shard_features(cot, rank, TP, parts)
    x = x.clone().requires_grad_()
    y = layer(x)
    (y * cot).sum().backward()
    helper = parallel_dense_helper(name, layer)
    combined = helper.get_grad()
    factor = (helper.get_g_factor(cot) if split == 'column'
              else helper.get_a_factor(x.detach()))
    out = dict(y=y.detach(), dx=x.grad, w_grad=layer.weight.grad.clone(),
               b_grad=layer.bias.grad.clone(), combined=combined,
               factor=factor)
    helper.set_grad(2 * combined)
    out['set_w'] = layer.weight.grad.clone()
    out['set_b'] = layer.bias.grad.clone()
    return out


def run_gpt(grid, rank):
    """The tensor-parallel ``gpt_tiny``'s logits and every registered
    layer's combined gradient of the mean logit."""
    model = gpt_tiny(device='cpu', tp_group=grid.group('model'))
    precond = KFACPreconditioner(model)
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, 12))).long()
    logits = model(tokens)
    F.cross_entropy(logits[:, :-1].reshape(-1, 256),
                    tokens[:, 1:].reshape(-1)).backward()
    return dict(logits=logits.detach(), combined={
        n: h.get_grad() for n, h in precond.helpers.items()})


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init}', rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    grid = axis_groups(2, 2, names=NAMES)
    group = grid.group('model')
    res = {name: run_layer(name, group, grid.inner) for name in LAYERS}
    res['gpt'] = run_gpt(grid, rank)
    x = mpu_data()
    for axis in NAMES:
        shard = mpu.scatter_to_model_parallel_region(x, grid, axis)
        res[('mpu', axis)] = dict(
            shard=shard,
            gathered=mpu.gather_from_model_parallel_region(shard, grid,
                                                           axis),
            peers=mpu.axis_peers(grid, axis),
            coords=mpu.axis_coords(grid))
    torch.save(res, out / f'rank{rank}.pt')
    dist.destroy_process_group()


def spawn(out: Path) -> list[subprocess.Popen]:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    return [
        subprocess.Popen(
            [sys.executable, __file__, '--worker', str(rank), str(WORLD),
             str(out / 'pg_init'), str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(WORLD)
    ]


def join(procs, deadline) -> None:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail('worker ranks timed out and were killed')
    bad = [(i, p.returncode, log[-3000:])
           for i, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        pytest.fail(f'worker ranks failed: {bad}')


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp('tp')
    deadline = time.time() + SPAWN_TIMEOUT_S
    join(spawn(out), deadline)
    return [torch.load(out / f'rank{r}.pt', weights_only=False)
            for r in range(WORLD)]


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=atol)


@pytest.mark.parametrize('name', list(LAYERS))
def test_parallel_layer_matches_full_dense(ranks, name):
    """Forward and backward of each rank against the full layer's slice:
    the output (a column layer's shard, a row layer's whole), the input
    gradient (whole, or the row layer's shard) and the weight and bias
    gradients."""
    _, _, split, parts = LAYERS[name]
    want = full_dense(name)
    for r, res in enumerate(ranks):
        got, i = res[name], r % TP
        if split == 'column':
            close(got['y'], tp_lib.shard_features(want['y'], i, TP, parts))
            close(got['dx'], want['dx'])
            mine = tp_lib.shard_features(want['combined'], i, TP, parts, 0)
            close(got['w_grad'], mine[:, :-1])
            close(got['b_grad'], mine[:, -1])
        else:
            close(got['y'], want['y'])
            close(got['dx'], tp_lib.shard_features(want['dx'], i, TP))
            close(got['w_grad'],
                  tp_lib.shard_features(want['combined'][:, :-1], i, TP))
            close(got['b_grad'], want['combined'][:, -1])


@pytest.mark.parametrize('name', list(LAYERS))
def test_helpers_see_the_full_layer(ranks, name):
    """The helper's combined gradient is the full layer's on every rank,
    its gathered factor the full layer's (G of a column layer, A of a
    row layer), and ``set_grad`` writes the rank's slice back."""
    _, _, split, parts = LAYERS[name]
    want = full_dense(name)
    for r, res in enumerate(ranks):
        got, i = res[name], r % TP
        close(got['combined'], want['combined'])
        close(got['factor'], want['G' if split == 'column' else 'A'])
        if split == 'column':
            mine = tp_lib.shard_features(2 * want['combined'], i, TP,
                                         parts, 0)
            close(got['set_w'], mine[:, :-1])
            close(got['set_b'], mine[:, -1])
        else:
            close(got['set_w'], tp_lib.shard_features(
                2 * want['combined'][:, :-1], i, TP))
            close(got['set_b'], 2 * want['combined'][:, -1])


def test_tp_gpt_matches_unsharded(ranks):
    """``gpt_tiny(tp_group=...)`` from the same seed: the unsharded
    model's logits, and through the helpers every Dense layer's full
    combined gradient, on every rank."""
    model = gpt_tiny(device='cpu')
    precond = KFACPreconditioner(model)
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, 12))).long()
    logits = model(tokens)
    F.cross_entropy(logits[:, :-1].reshape(-1, 256),
                    tokens[:, 1:].reshape(-1)).backward()
    want = {n: h.get_grad() for n, h in precond.helpers.items()}
    for res in ranks:
        close(res['gpt']['logits'], logits.detach())
        assert set(res['gpt']['combined']) == set(want)
        for n, g in want.items():
            close(res['gpt']['combined'][n], g)


def test_split_values():
    x = torch.arange(24.0).reshape(2, 12)
    parts = mpu.split_tensor_along_dim(x, 1, 3)
    assert len(parts) == 3
    assert all(p.shape == (2, 4) for p in parts)
    assert torch.equal(torch.cat(parts, dim=1), x)


def test_split_indivisible():
    with pytest.raises(ValueError, match='not divisible'):
        mpu.split_tensor_along_dim(torch.zeros(2, 10), 1, 3)


def test_gather_replicates(ranks):
    """The scatter's shards gathered give every rank the full array,
    over either axis."""
    for res in ranks:
        for axis in NAMES:
            assert torch.equal(res[('mpu', axis)]['gathered'], mpu_data())


def test_scatter_shards(ranks):
    """Rank ``(d, m)`` holds the ``m``-th half of the columns over
    ``'model'`` and the ``d``-th over ``'data'``."""
    x = mpu_data()
    for r, res in enumerate(ranks):
        d, m = divmod(r, 2)
        assert torch.equal(res[('mpu', 'model')]['shard'],
                           x[:, 4 * m:4 * m + 4])
        assert torch.equal(res[('mpu', 'data')]['shard'],
                           x[:, 4 * d:4 * d + 4])
        assert res[('mpu', 'model')]['coords'] == {'data': d, 'model': m}
        assert res[('mpu', 'model')]['peers'] == [2 * d, 2 * d + 1]
        assert res[('mpu', 'data')]['peers'] == [m, 2 + m]


def mesh_2d(rank=0):
    """A ``4 x 2`` ``('data', 'model')`` grid's coordinates (no groups
    are needed for them)."""
    return AxisGroups(4, 2, rank=rank, names=NAMES)


def test_scatter_indivisible():
    with pytest.raises(ValueError, match='not divisible'):
        mpu.scatter_to_model_parallel_region(torch.zeros(4, 7), mesh_2d(),
                                             'model')


def test_unknown_axis():
    with pytest.raises(ValueError, match='not in mesh'):
        mpu.gather_from_model_parallel_region(torch.zeros(4, 8), mesh_2d(),
                                              'expert')


def test_axis_coords():
    assert mpu.axis_coords(mesh_2d(), 5) == {'data': 2, 'model': 1}


def test_axis_peers():
    mesh = mesh_2d(rank=5)
    peers = mpu.axis_peers(mesh, 'model')
    assert peers == [4, 5]
    assert all(mpu.axis_coords(mesh, p)['data'] == 2 for p in peers)
    rows = mpu.axis_peers(mesh, 'data', 5)
    assert rows == [1, 3, 5, 7]
    assert all(mpu.axis_coords(mesh, p)['model'] == 1 for p in rows)


def test_device_not_in_mesh():
    mesh = AxisGroups(4, 1, names=('data', 'model'))
    with pytest.raises(ValueError, match='not in mesh'):
        mpu.axis_coords(mesh, 5)


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
