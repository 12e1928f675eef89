"""The port's trainers and bench on the CPU, and their helpers against
the JAX package's.

* ``label_smooth_loss``, ``accuracy`` and ``create_lr_schedule`` against
  ``examples/utils.py`` (``rtol 1e-6``); ``synthetic_dataset`` and the
  ``ArrayLoader`` batches (shuffled, sharded, augmented) equal to
  ``examples/cnn_utils/datasets.py``'s; the optimizer's learning rate
  per step equal to the JAX ``lr_schedule``, the K-FAC damping decayed
  at its epoch.
* The CIFAR trainer's ``main`` runs one epoch of 3 synthetic batches of
  16 (the synthetic set cut to 48 training and 16 test images) on
  ``--device cpu`` with ``resnet20``, with 1 and 2 micro-batches per
  step (a trailing partial group), and a second call resumes from the
  newest checkpoint; one epoch with ``--model vit_tiny``; an unported
  model raises.
* ``bench.measure`` at ``device='cpu'`` on a tiny configuration gives
  finite positive times, and the result line carries ``bench.py``'s
  keys; the ``micro_mlp``, ``inverse_root`` and
  ``secondary_rn50_inverse`` stages at tiny sizes carry the JAX stages'
  keys.
* Without a card and without ``--device cpu`` the trainers and the bench
  raise.
"""
from __future__ import annotations

import argparse
import functools
import json
import math

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch import bench
from kfac_pytorch_tpu_torch.examples import cifar10_resnet
from kfac_pytorch_tpu_torch.examples import imagenet_resnet
from kfac_pytorch_tpu_torch.examples import utils
from kfac_pytorch_tpu_torch.examples.cnn_utils import datasets
from kfac_pytorch_tpu_torch.examples.cnn_utils import engine
from kfac_pytorch_tpu_torch.examples.cnn_utils import optimizers
from kfac_pytorch_tpu_torch.models import TinyModel
from kfac_pytorch_tpu_torch.utils.backend import environment_summary
from kfac_pytorch_tpu_torch.utils.metrics import MetricsWriter

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port


# -- helpers against the JAX package --------------------------------------

@pytest.mark.parametrize('smoothing', [0.0, 0.1])
def test_label_smooth_loss_and_accuracy_match_jax(smoothing):
    import jax.numpy as jnp
    from examples import utils as jax_utils

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=16)
    got = utils.label_smooth_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels), smoothing)
    want = jax_utils.label_smooth_loss(jnp.asarray(logits),
                                       jnp.asarray(labels), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(utils.accuracy(torch.from_numpy(logits),
                             torch.from_numpy(labels))),
        float(jax_utils.accuracy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


@pytest.mark.parametrize('world,warmup', [(1, 5), (4, 5), (4, 0)])
def test_lr_schedule_matches_jax(world, warmup):
    from examples import utils as jax_utils

    got = utils.create_lr_schedule(world, warmup, [35, 75, 90])
    want = jax_utils.create_lr_schedule(world, warmup, [35, 75, 90])
    for epoch in (0, 1, 2.5, 4, 5, 34, 35, 80, 99):
        np.testing.assert_allclose(got(epoch), float(want(epoch)), rtol=1e-6)


def test_synthetic_data_and_loader_batches_match_jax():
    from examples.cnn_utils import datasets as jax_datasets

    got = datasets.synthetic_dataset(64, 16, (8, 8, 3), 10, seed=3)
    want = jax_datasets.synthetic_dataset(64, 16, (8, 8, 3), 10, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    x, y = got[0], got[1]
    for augment in (False, True):
        for index in range(2):
            kw = dict(batch_size=8, shuffle=True, augment=augment, seed=5)
            port = datasets.ArrayLoader(
                x, y, shard=datasets.ShardInfo(index, 2), **kw)
            ref = jax_datasets.ArrayLoader(
                x, y, shard=jax_datasets.ShardInfo(index, 2), **kw)
            port.set_epoch(1)
            ref.set_epoch(1)
            assert len(port) == len(ref) == 4
            for (gx, gy), (wx, wy) in zip(port, ref):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)


def _args(**overrides):
    ns = argparse.Namespace(
        base_lr=0.1, lr_decay=[2, 4], warmup_epochs=2, momentum=0.9,
        weight_decay=5e-4, label_smoothing=0.0, batches_per_allreduce=1,
        kfac_inv_update_steps=2, kfac_factor_update_steps=1,
        kfac_update_steps_alpha=10, kfac_update_steps_decay=None,
        kfac_compute_method='eigen', kfac_factor_decay=0.95,
        kfac_damping=0.003, kfac_damping_alpha=0.5,
        kfac_damping_decay=[1], kfac_kl_clip=0.001, kfac_skip_layers=[],
        kfac_colocate_factors=True, kfac_worker_fraction=0.25,
        kfac_lowrank_rank=None, kfac_ekfac=False,
    )
    for k, v in overrides.items():
        setattr(ns, k, v)
    return ns


def test_optimizer_lr_and_kfac_schedules_match_jax():
    from examples.cnn_utils import optimizers as jax_optimizers
    from kfac_pytorch_tpu.models import TinyModel as JaxTiny

    args = _args()
    model = TinyModel()
    opt, sched, precond, kfac_sched, lr_schedule = optimizers.get_optimizer(
        model, args, steps_per_epoch=3, world=2)
    *_, jax_lr = jax_optimizers.get_optimizer(JaxTiny(), _args(), 3)
    for step in range(12):
        # The JAX mesh-less factory runs at world 1; compare the port's
        # world-2 schedule with the JAX formula at world 2.
        want = 0.2 * float(utils.create_lr_schedule(2, 2, [2, 4])(step // 3))
        assert opt.param_groups[0]['lr'] == pytest.approx(want, rel=1e-6)
        assert lr_schedule(step) == pytest.approx(want, rel=1e-6)
        opt.step()
        sched.step()
    single = optimizers.get_optimizer(TinyModel(), _args(), 3, world=1)[4]
    for step in range(12):
        assert single(step) == pytest.approx(float(jax_lr(step)), rel=1e-6)
    assert precond.lr == lr_schedule(0)
    damping = precond.damping
    precond._steps = 3  # epoch 1: the damping decay epoch
    kfac_sched.step()
    assert precond.damping == pytest.approx(damping * 0.5)
    lowrank = optimizers.get_optimizer(
        TinyModel(), _args(kfac_lowrank_rank=4), 3)[2]
    assert lowrank.lowrank_rank == 4 and not lowrank.ekfac
    assert optimizers.get_optimizer(
        TinyModel(), _args(kfac_ekfac=True), 3)[2].ekfac
    no_kfac = optimizers.get_optimizer(
        TinyModel(), _args(kfac_inv_update_steps=0), 3)
    assert no_kfac[2] is None and no_kfac[3] is None


def test_trailing_partial_group_reaches_the_optimizer():
    """Three micro-batches at N=2: two optimizer and K-FAC steps, the
    second on one micro-batch, its gradient the micro-batch's own."""
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((4, 1, 1, 10)).astype(np.float32)
                .reshape(4, 1, 1, 10), rng.integers(0, 10, size=4))
               for _ in range(3)]

    class Flat(TinyModel):
        def forward(self, x):
            return super().forward(x.reshape(x.shape[0], -1))

    model = Flat()
    ref = Flat()
    ref.load_state_dict(model.state_dict())
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    seen = []
    orig = opt.step

    def step(*a, **k):
        seen.append(model.linear1.weight.grad.clone())
        return orig(*a, **k)
    opt.step = step
    loss_fn = torch.nn.functional.cross_entropy
    engine.train(0, model, opt, None, batches, loss_fn, device='cpu',
                 accumulation_steps=2)
    assert len(seen) == 2
    x, y = engine.to_device(batches[2], 'cpu')
    loss_fn(ref(x), y).backward()
    torch.testing.assert_close(seen[1], ref.linear1.weight.grad)


def test_metric_writer_and_environment(tmp_path):
    m = utils.Metric('loss')
    for v in (1.0, 2.0, torch.tensor(6.0)):
        m.update(v)
    assert m.avg == 3.0
    env = environment_summary()
    assert {'python', 'torch', 'cuda', 'device_count', 'nvidia_smi',
            'kernels_built'} <= set(env)
    assert env['kernels_built'] == {'fused_eigen_precond': False} or all(
        isinstance(v, bool) for v in env['kernels_built'].values())
    with MetricsWriter(str(tmp_path), use_tensorboard=False) as w:
        w.record('env', env)
        w.scalars({'train': {'loss': torch.tensor(0.5)}}, step=3)
    lines = [json.loads(ln) for ln in
             (tmp_path / 'metrics.jsonl').read_text().splitlines()]
    assert lines[0]['tag'] == 'env' and lines[0]['torch'] == torch.__version__
    assert lines[1]['tag'] == 'train/loss' and lines[1]['value'] == 0.5
    assert lines[1]['step'] == 3


def test_checkpoint_round_trip_and_scan(tmp_path):
    assert utils.find_latest_checkpoint(str(tmp_path / 'none')) is None
    for epoch in (0, 3, 11):
        utils.save_checkpoint(str(tmp_path), epoch,
                              {'w': torch.full((2,), float(epoch))},
                              {'steps': epoch})
    epoch, path = utils.find_latest_checkpoint(str(tmp_path))
    assert epoch == 11
    payload = utils.load_checkpoint(path)
    assert payload['epoch'] == 11 and payload['kfac'] == {'steps': 11}
    assert torch.equal(payload['train_state']['w'], torch.full((2,), 11.0))


# -- the trainers ----------------------------------------------------------

@pytest.fixture
def small_cifar(monkeypatch):
    real = datasets.synthetic_dataset

    def small(n_train, n_test, shape, classes, seed=0):
        return real(48, 16, shape, classes, seed=seed)

    monkeypatch.setattr(datasets, 'synthetic_dataset', small)
    monkeypatch.setattr(cifar10_resnet, 'MetricsWriter',
                        functools.partial(MetricsWriter,
                                          use_tensorboard=False))


def _cifar(tmp_path, *extra):
    return ['--device', 'cpu', '--model', 'resnet20', '--batch-size', '16',
            '--val-batch-size', '16', '--epochs', '1', '--warmup-epochs',
            '0', '--data-dir', str(tmp_path / 'no-data'), '--log-dir',
            str(tmp_path / 'log'), *extra]


@pytest.mark.parametrize('n_accum', [1, 2])
def test_cifar_trainer_runs_one_epoch(tmp_path, small_cifar, capsys,
                                      n_accum):
    cifar10_resnet.main(_cifar(tmp_path, '--batches-per-allreduce',
                               str(n_accum)))
    out = capsys.readouterr().out
    assert 'epoch 0: train_loss=' in out
    loss = float(out.split('train_loss=')[1].split()[0])
    assert math.isfinite(loss)
    payload = utils.load_checkpoint(str(tmp_path / 'log' / 'checkpoint_0'))
    # 3 batches: 3 steps, or 2 with a trailing partial group.
    assert payload['kfac']['steps'] == (3 if n_accum == 1 else 2)
    lines = (tmp_path / 'log' / 'metrics.jsonl').read_text().splitlines()
    assert json.loads(lines[0])['tag'] == 'env'


@pytest.mark.parametrize('flags,want', [
    (('--kfac-lowrank-rank', '16'), dict(lowrank_rank=16, ekfac=False)),
    (('--kfac-ekfac',), dict(lowrank_rank=None, ekfac=True)),
], ids=['lowrank', 'ekfac'])
def test_cifar_trainer_runs_eigen_variants(tmp_path, small_cifar, capsys,
                                           monkeypatch, flags, want):
    """One synthetic epoch with ``--kfac-lowrank-rank`` (ResNet-20's wide
    conv buckets truncate) and with ``--kfac-ekfac``."""
    made = []
    real = optimizers.KFACPreconditioner

    def spy(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(optimizers, 'KFACPreconditioner', spy)
    cifar10_resnet.main(_cifar(tmp_path, *flags))
    out = capsys.readouterr().out
    assert math.isfinite(float(out.split('train_loss=')[1].split()[0]))
    (precond,) = made
    assert {k: getattr(precond, k) for k in want} == want
    assert precond.steps == 3
    so = precond._second_order
    if want['lowrank_rank']:
        assert any(any(so.lowrank_sides(b.key)) for b in precond.plan.buckets)
    else:
        assert all(bs.skron is not None for bs in precond.buckets.values())
    payload = utils.load_checkpoint(str(tmp_path / 'log' / 'checkpoint_0'))
    assert payload['kfac']['steps'] == 3


def test_cifar_trainer_resumes_from_the_newest_checkpoint(
        tmp_path, small_cifar, capsys):
    cifar10_resnet.main(_cifar(tmp_path))
    capsys.readouterr()
    args = _cifar(tmp_path)
    args[args.index('--epochs') + 1] = '2'
    cifar10_resnet.main(args)
    out = capsys.readouterr().out
    assert 'resumed from' in out and 'at epoch 1' in out
    assert 'epoch 0:' not in out and 'epoch 1: train_loss=' in out
    payload = utils.load_checkpoint(str(tmp_path / 'log' / 'checkpoint_1'))
    assert payload['kfac']['steps'] == 6
    assert payload['train_state']['lr_scheduler']['last_epoch'] == 6


def test_cifar_trainer_rejects_unported_models(tmp_path, small_cifar):
    args = _cifar(tmp_path)
    args[args.index('--model') + 1] = 'resnet56'
    with pytest.raises(ValueError, match='vit_tiny'):
        cifar10_resnet.main(args)


def test_cifar_trainer_runs_vit_tiny(tmp_path, small_cifar, capsys):
    """``--model vit_tiny``, the JAX trainer's choice: one synthetic
    epoch with the default K-FAC registration (patchify, 8 Dense
    layers, head)."""
    args = _cifar(tmp_path)
    args[args.index('--model') + 1] = 'vit_tiny'
    cifar10_resnet.main(args)
    out = capsys.readouterr().out
    assert 'model=vit_tiny' in out
    assert math.isfinite(float(out.split('train_loss=')[1].split()[0]))
    payload = utils.load_checkpoint(str(tmp_path / 'log' / 'checkpoint_0'))
    assert payload['kfac']['steps'] == 3
    assert len(payload['kfac']['layers']) == 10
    assert 'block_1.fc_out.weight' in payload['train_state']['model']


def test_trainer_flags_and_defaults_match_jax(monkeypatch):
    import sys

    from examples import cifar10_resnet as jax_cifar
    from examples import imagenet_resnet as jax_imagenet

    for port, ref in ((cifar10_resnet, jax_cifar),
                      (imagenet_resnet, jax_imagenet)):
        monkeypatch.setattr(sys, 'argv', ['prog'])
        want = vars(ref.parse_args())
        got = vars(port.parse_args([]))
        assert got['device'] is None
        for key, value in want.items():
            if key in ('multihost',):
                continue
            assert got[key] == value, (port.__name__, key)


# -- the bench -------------------------------------------------------------

def test_bench_measures_on_the_cpu():
    cfg = dict(model='resnet20', batch=4, image=16, classes=10,
               factor_steps=1, inv_steps=2, damping=0.003, lr=0.1,
               sgd_iters=2, cycles=1)
    res = bench.measure(cfg, 'cpu')
    assert res['sgd_ms'] > 0 and res['kfac_ms'] > 0
    assert all(math.isfinite(res[k]) for k in ('sgd_ms', 'kfac_ms'))
    line = bench.result_line(
        {'resnet50': res, 'resnet32_cifar': res, 'gpt125m': None},
        environment_summary())
    assert set(line) == {'metric', 'value', 'unit', 'vs_baseline', 'detail'}
    assert line['metric'] == 'kfac_step_overhead_resnet50_imagenet_b32'
    assert line['unit'] == 'x_sgd_step_time'
    assert line['value'] == pytest.approx(res['kfac_ms'] / res['sgd_ms'])
    assert line['vs_baseline'] == pytest.approx(1.5 / line['value'])
    d = line['detail']
    for name in ('resnet50', 'resnet32_cifar', 'gpt125m'):
        assert {f'{name}_sgd_ms', f'{name}_kfac_ms_amortized',
                f'{name}_ratio'} <= set(d)
    assert d['gpt125m_ratio'] is None and 'nvidia_smi' in d['env']
    json.dumps(line)


@pytest.mark.parametrize('name', ['resnet50_lowrank512', 'resnet50_ekfac'])
def test_bench_eigen_variants_on_the_cpu(name, monkeypatch):
    """The bench's low-rank and EKFAC configurations at a tiny size (the
    headline's cadence cut to inv 2, rank 512 cut to 16 so ResNet-20's
    wide buckets still truncate): finite times under their own keys, and
    outside the default set."""
    cfg = dict(bench.CONFIGS[name], model='resnet20', batch=4, image=16,
               classes=10, factor_steps=1, inv_steps=2, sgd_iters=2)
    if 'lowrank' in name:
        cfg['kfac_kw'] = dict(lowrank_rank=16)
    assert name not in bench.DEFAULT_CONFIGS
    monkeypatch.setitem(bench.CONFIGS, name, cfg)
    line = bench.run([name], 'cpu')
    d = line['detail']
    assert d[f'{name}_sgd_ms'] > 0 and d[f'{name}_kfac_ms_amortized'] > 0
    assert math.isfinite(d[f'{name}_ratio'])
    assert line['value'] is None


def test_bench_micro_mlp_on_the_cpu(monkeypatch):
    """The JAX bench's ``micro_mlp`` stage at a tiny size (the MLP cut
    to widths 16, inv 2): the JAX stage's keys, finite times."""
    monkeypatch.setattr(bench, 'MICRO_MLP', dict(
        bench.MICRO_MLP, width=16, features=(16, 16, 10), batch=8,
        factor_steps=1, inv_steps=2, sgd_iters=2, cycles=1))
    d = bench.run(['micro_mlp'], 'cpu')['detail']['micro_mlp']
    assert set(d) == {'config', 'sgd_ms', 'kfac_ms', 'ratio'}
    assert d['sgd_ms'] > 0 and d['kfac_ms'] > 0
    assert d['ratio'] == pytest.approx(d['kfac_ms'] / d['sgd_ms'])
    assert bench.MICRO_MLP['factor_steps'] == 1
    json.dumps(d)


def test_bench_inverse_root_on_the_cpu():
    """The JAX bench's ``inverse_root`` stage at two tiny stacks: the
    JAX stage's keys, finite times, both Newton–Schulz roots within the
    iteration's tolerance."""
    d = bench.measure_inverse_root('cpu', shapes=((2, 8), (1, 16)),
                                   iters=1)
    assert set(d) == {'config', 'shapes', 'warm_vs_eigh_speedup_min',
                      'warm_vs_eigh_speedup_max', 'tol'}
    assert [s['shape'] for s in d['shapes']] == ['[2, 8, 8]',
                                                  '[1, 16, 16]']
    for s in d['shapes']:
        assert set(s) == {'shape', 'eigh_ms', 'cholesky_ms', 'ns_cold_ms',
                          'ns_warm_ms', 'ns_cold_res', 'ns_warm_res',
                          'ns_warm_iters', 'ns_bootstrap_iters'}
        assert all(s[k] > 0 for k in ('eigh_ms', 'cholesky_ms',
                                      'ns_cold_ms', 'ns_warm_ms'))
        assert s['ns_cold_res'] < d['tol'] and s['ns_warm_res'] < d['tol']
    assert d['warm_vs_eigh_speedup_min'] <= d['warm_vs_eigh_speedup_max']
    assert 'inverse_root' in bench.STAGES
    json.dumps(d)


def test_bench_secondary_rn50_inverse_on_the_cpu(monkeypatch):
    """The JAX bench's ``secondary_rn50_inverse`` stage with the headline
    cut to ResNet-20 at batch 4 on 16x16, inv 2: ``kfac_ms`` and no SGD
    run."""
    monkeypatch.setitem(bench.CONFIGS, 'resnet50', dict(
        bench.CONFIGS['resnet50'], model='resnet20', batch=4, image=16,
        classes=10, factor_steps=1, inv_steps=2))
    d = bench.run(['secondary_rn50_inverse'], 'cpu')['detail'][
        'secondary_rn50_inverse']
    assert set(d) == {'config', 'kfac_ms'}
    assert d['kfac_ms'] > 0 and "'inverse'" in d['config']


# -- no card ---------------------------------------------------------------

@pytest.mark.parametrize('entry', ['cifar', 'imagenet', 'bench'])
def test_entry_points_raise_without_a_card(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    main = {'cifar': cifar10_resnet.main, 'imagenet': imagenet_resnet.main,
            'bench': bench.main}[entry]
    argv = ([] if entry == 'bench'
            else ['--log-dir', str(tmp_path), '--data-dir', str(tmp_path)])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main(argv)
    assert not (tmp_path / 'metrics.jsonl').exists()
