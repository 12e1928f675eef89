"""The port's streaming checkpoints (``elastic``) against the JAX
package's, on the CPU.

* ``layout_signature`` is JAX's for the same model and column count
  (ResNet-20 at 1, 2 and 4 columns; layer names read ``.`` for ``/``).
* The format: every shard in the manifest with its bytes and CRC32,
  generations born ``pending``, a stamp that still verifies, the
  retention window (torn generations hold no slot), a re-save of a
  committed step that keeps it valid.
* The corruption matrix: a torn manifest, a truncated shard, a zero-byte
  file, a CRC mismatch, a whole generation cut short
  (``testing.corrupt_checkpoint``) and a NaN-poisoned stack are each
  skipped and named, the restore falling back to the previous
  generation, and so is one the install refuses (a layer without its
  factor EMAs); a pinned target never falls back; a failed candidate
  leaves the preconditioner as it was.
* A same-world resume (LeNet at 12x12, SGD with momentum, the model and
  optimizer in the generation's extras) is the uninterrupted run bit for
  bit, for eigen, eigen without prediv, inverse, iterative, EKFAC and
  health, and runs no ``eigh`` before the first resumed step.
* A JAX generation saved on a 4-device mesh (MEM-OPT, four columns),
  carried by ``convert.jax_generation_to_torch`` and restored in one
  port process (a transplant to one column): factors within 1e-6 of
  JAX's, and the next step's preconditioned gradients within 1e-5 of
  JAX's own one-device restore of the same generation; saved without
  its decompositions, both restores recompute them, and the gradients
  agree as closely.
* Four gloo ranks (subprocesses of this file) save at MEM-OPT (1x4),
  two of them restore at HYBRID-OPT (1x2): the factor EMAs and every
  transplanted slot are the saved values bit for bit, the next refresh
  is forced to a monolithic bootstrap, and the first resumed step's
  gradients agree with a one-process restore of the same generation.
  Before that, rank 1 alone fails to read the newest generation, and
  both ranks fall back to the older one together, naming rank 1.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

import kfac_pytorch_tpu_torch as kt  # noqa: E402
from kfac_pytorch_tpu_torch import elastic  # noqa: E402
from kfac_pytorch_tpu_torch import tracing  # noqa: E402
from kfac_pytorch_tpu_torch.engine import load_training_extras  # noqa: E402
from kfac_pytorch_tpu_torch.engine import training_extras  # noqa: E402
from kfac_pytorch_tpu_torch.models import LeNet  # noqa: E402
from kfac_pytorch_tpu_torch.parallel import bucketing  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

HP = dict(factor_update_steps=1, inv_update_steps=3, damping=0.003,
          kl_clip=0.001, lr=0.1)


def data(n=8, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12, 12, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,))
    return x, y


def nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- the layout signature ----------------------------------------------------


@pytest.mark.parametrize('n_cols', [1, 2, 4])
def test_layout_signature_equals_jax(n_cols):
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu.capture import ModelCapture as JaxCapture
    from kfac_pytorch_tpu.models import resnet20 as jax_resnet20
    from kfac_pytorch_tpu.parallel import bucketing as jax_bucketing

    model = jax_resnet20(num_classes=10)
    x = jnp.zeros((2, 32, 32, 3))
    variables = model.init(jax.random.PRNGKey(0), x, train=True)
    specs = JaxCapture(model).register(variables, x, train=True,
                                       mutable=['batch_stats'])
    helpers = {'/'.join(s.helper.path): s.helper for s in specs.values()}
    want = jax_bucketing.layout_signature(
        jax_bucketing.make_bucket_plan(helpers, n_cols=n_cols))
    precond = kt.KFACPreconditioner(kt.models.resnet20(device='cpu'))
    plan = bucketing.make_bucket_plan(
        {n: h for n, h in precond.helpers.items()}, n_cols=n_cols)
    got = bucketing.layout_signature(plan)
    for b in got['buckets']:
        b['slots'] = [None if s is None else s.replace('.', '/')
                      for s in b['slots']]
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    slot_of = bucketing.signature_slot_map(bucketing.layout_signature(plan))
    assert slot_of == dict(plan.slot_of)


# -- the format ----------------------------------------------------------------


def lenet_engine(seed=0, **kw):
    torch.manual_seed(seed)
    model = LeNet(image_size=12)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    precond = kt.KFACPreconditioner(model, **dict(HP, **kw))
    return model, opt, precond


def train(model, opt, precond, steps, batches=None):
    batches = batches or [data(seed=s) for s in range(16)]
    for _ in range(steps):
        x, y = batches[precond.steps % len(batches)]
        opt.zero_grad()
        F.cross_entropy(model(nchw(x)), torch.from_numpy(y)).backward()
        precond.step()
        opt.step()


@pytest.fixture
def two_gens(tmp_path):
    """A LeNet engine trained past two saves: ``gen-2`` and ``gen-4``."""
    model, opt, precond = lenet_engine()
    for _ in range(2):
        train(model, opt, precond, 2)
        elastic.save_streaming(str(tmp_path), precond,
                               extras=training_extras(model, opt))
    return precond, str(tmp_path)


def test_manifest_covers_every_shard(two_gens):
    precond, directory = two_gens
    gens = elastic.list_generations(directory)
    assert [elastic.generation_step(g) for g in gens] == [2, 4]
    gen = gens[-1]
    with open(os.path.join(gen, elastic.MANIFEST_NAME)) as fh:
        manifest = json.load(fh)
    files = set(os.listdir(gen)) - {elastic.MANIFEST_NAME}
    assert set(manifest['shards']) == files
    assert files == {'layers.npz', 'extras.npz', elastic.META_NAME} | {
        f'bucket-{b.key}.npz' for b in precond.plan.buckets}
    for name, entry in manifest['shards'].items():
        raw = open(os.path.join(gen, name), 'rb').read()
        assert entry == {'bytes': len(raw), 'crc32': zlib.crc32(raw)}
    assert elastic.generation_bytes(gen) == sum(
        e['bytes'] for e in manifest['shards'].values())
    with open(os.path.join(gen, elastic.META_NAME)) as fh:
        meta = json.load(fh)
    assert meta['steps'] == 4 and meta['health_stamp'] == 'pending'
    assert meta['topology']['signature'] == bucketing.layout_signature(
        precond.plan)
    with np.load(os.path.join(gen, f'bucket-{precond.plan.buckets[0].key}'
                              '.npz')) as npz:
        assert set(npz.files) == set(precond.buckets[
            precond.plan.buckets[0].key].stack_fields())


def test_stamps_rewrite_meta_and_still_verify(two_gens):
    _, directory = two_gens
    old, new = elastic.list_generations(directory)
    elastic.stamp_generation(old)
    assert elastic.list_generations(directory, stamps=True) == [
        (old, 'healthy'), (new, 'pending')]
    elastic._verify_generation(old)
    os.remove(os.path.join(new, elastic.MANIFEST_NAME))
    with pytest.raises(elastic.ElasticCheckpointError, match='torn'):
        elastic.stamp_generation(new)
    with pytest.raises(ValueError):
        elastic.generation_step(os.path.join(directory, 'ckpt-1'))


def test_retention_and_resave(tmp_path):
    model, opt, precond = lenet_engine()
    directory = str(tmp_path)
    os.makedirs(os.path.join(directory, 'gen-00000001'))  # torn, older
    for _ in range(4):
        train(model, opt, precond, 1)
        elastic.save_streaming(directory, precond, retain=2)
    assert [elastic.generation_step(g) for g in
            elastic.list_generations(directory)] == [3, 4]
    # A re-save of a committed step replaces it and stays valid.
    path = elastic.save_streaming(directory, precond, retain=2)
    assert elastic.generation_step(path) == 4
    elastic._verify_generation(path)
    assert not [n for n in os.listdir(directory) if '.resave-' in n]


def _truncate(gen, name):
    path = os.path.join(gen, name)
    with open(path, 'r+b') as fh:
        fh.truncate(os.path.getsize(path) // 2)


def _zero(gen, name):
    open(os.path.join(gen, name), 'wb').close()


def _flip(gen, name):
    path = os.path.join(gen, name)
    raw = bytearray(open(path, 'rb').read())
    raw[len(raw) // 2] ^= 0x10
    open(path, 'wb').write(bytes(raw))


def _recommit(gen, name, edit):
    """``edit`` the arrays of shard ``name`` and re-commit it with a valid
    manifest, so only a check past the CRC can refuse it."""
    path = os.path.join(gen, name)
    with np.load(path) as npz:
        arrays = {k: np.array(npz[k]) for k in npz.files}
    edit(arrays)
    with open(path, 'wb') as fh:
        np.savez(fh, **arrays)
    mpath = os.path.join(gen, elastic.MANIFEST_NAME)
    manifest = json.load(open(mpath))
    raw = open(path, 'rb').read()
    manifest['shards'][name] = {'bytes': len(raw), 'crc32': zlib.crc32(raw)}
    json.dump(manifest, open(mpath, 'w'))


CORRUPTIONS = {
    'torn_manifest': (lambda g, b: os.remove(
        os.path.join(g, elastic.MANIFEST_NAME)), 'MANIFEST.json'),
    'truncated_shard': (lambda g, b: _truncate(g, 'layers.npz'),
                        'layers.npz.*truncated'),
    'zero_byte': (lambda g, b: _zero(g, f'bucket-{b}.npz'),
                  f'bucket-.*npz: 0 bytes'),
    'crc_mismatch': (lambda g, b: _flip(g, 'extras.npz'),
                     'extras.npz: CRC32'),
    'corrupt_checkpoint': (lambda g, b: kt.testing.corrupt_checkpoint(g),
                           'gen-00000004'),
    'nan_stack': (lambda g, b: _recommit(
        g, f'bucket-{b}.npz', lambda a: a['qa'].__setitem__(
            (0, 0, 0), np.nan)), 'non-finite'),
    'missing_factor_ema': (lambda g, b: _recommit(
        g, 'layers.npz', lambda a: a.pop('fc1::g_factor')),
        "'fc1' is missing its factor EMAs"),
}


@pytest.mark.parametrize('kind', sorted(CORRUPTIONS))
def test_corruption_is_skipped_and_named(two_gens, kind):
    import re

    precond, directory = two_gens
    fault, pattern = CORRUPTIONS[kind]
    newest = elastic.list_generations(directory)[-1]
    fault(newest, precond.plan.buckets[0].key)
    tracing.clear_trace()
    _, _, fresh = lenet_engine(seed=1)
    info = elastic.restore_streaming(directory, fresh)
    assert info['generation'] == 'gen-00000002' and fresh.steps == 2
    (skip,) = info['skipped']
    assert skip['generation'] == 'gen-00000004'
    assert re.search(pattern, skip['error']), skip['error']
    assert tracing.get_events()['elastic_restore_fallback'] == 1
    with pytest.raises(elastic.ElasticCheckpointError, match='pinned'):
        elastic.restore_streaming(directory, fresh, target_step=4)


def test_failures_raise_and_leave_state_alone(two_gens, tmp_path):
    precond, directory = two_gens
    _, _, fresh = lenet_engine(seed=1)
    before = {n: st.a_factor.clone() for n, st in fresh.layers.items()}
    for gen in elastic.list_generations(directory):
        _truncate(gen, 'layers.npz')
    with pytest.raises(elastic.ElasticCheckpointError,
                       match='no valid streaming generation'):
        elastic.restore_streaming(directory, fresh)
    assert fresh.steps == 0 and not fresh._factors_initialized
    assert all(torch.equal(fresh.layers[n].a_factor, a)
               for n, a in before.items())
    with pytest.raises(elastic.ElasticCheckpointError, match='does not exist'):
        elastic.restore_streaming(directory, fresh, target_step=3)
    with pytest.raises(elastic.ElasticCheckpointError, match='health stamp'):
        elastic.restore_streaming(directory, fresh, require_stamp='healthy')
    with pytest.raises(elastic.ElasticCheckpointError, match='no streaming'):
        elastic.restore_any(str(tmp_path / 'empty'), fresh)


def test_config_mismatch_propagates(two_gens):
    _, directory = two_gens
    _, _, other = lenet_engine(compute_method='inverse')
    with pytest.raises(elastic.ElasticCompatibilityError,
                       match='stack fields differ'):
        elastic.restore_streaming(directory, other)
    assert other.steps == 0


# -- same-world resume ---------------------------------------------------------

RESUME = {
    'eigen': {},
    'eigen_noprediv': dict(compute_eigenvalue_outer_product=False),
    'inverse': dict(compute_method='inverse'),
    'iterative': dict(compute_method='iterative'),
    'ekfac': dict(ekfac=True),
    'health': dict(health=kt.HealthConfig()),
}


@pytest.mark.parametrize('method', sorted(RESUME))
def test_same_world_resume_is_bitwise(tmp_path, method, monkeypatch):
    kw = RESUME[method]
    batches = [data(seed=s) for s in range(16)]
    model, opt, precond = lenet_engine(**kw)
    train(model, opt, precond, 4, batches)
    elastic.save_streaming(str(tmp_path), precond,
                           extras=training_extras(model, opt))
    train(model, opt, precond, 4, batches)
    want = [p.detach().clone() for p in model.parameters()]
    m2, o2, p2 = lenet_engine(seed=7, **kw)
    calls = []
    real = torch.linalg.eigh
    monkeypatch.setattr(torch.linalg, 'eigh',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    info = elastic.restore_streaming(str(tmp_path), p2)
    load_training_extras(m2, o2, info['extras'])
    assert info['decompositions_installed'] and not info['resized']
    assert not info['recomputed']
    train(m2, o2, p2, 1, batches)  # step 4: no refresh (inv 3)
    assert not calls
    monkeypatch.setattr(torch.linalg, 'eigh', real)
    train(m2, o2, p2, 3, batches)
    assert p2.steps == 8
    assert all(torch.equal(a, b) for a, b in zip(want, m2.parameters()))


def test_restore_any_reads_the_monolithic_rotation(tmp_path):
    from kfac_pytorch_tpu_torch.utils import checkpoint as ckpt

    model, opt, precond = lenet_engine()
    train(model, opt, precond, 3)
    ckpt.save_rotating(str(tmp_path), precond)
    _, _, fresh = lenet_engine(seed=1)
    info = elastic.restore_any(str(tmp_path), fresh)
    assert info['loader'] == 'monolithic' and info['recomputed']
    assert fresh.steps == 3
    elastic.save_streaming(str(tmp_path), precond)
    assert elastic.restore_any(str(tmp_path), fresh)['loader'] == 'streaming'


# -- a JAX generation ------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_lenet():
    """A JAX LeNet preconditioner trained four steps on a 4-device mesh
    (MEM-OPT, four columns), and a one-device loader of the same model."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    x, y = data(n=8)
    variables = jax.tree.map(
        np.asarray, JaxLeNet().init(jax.random.PRNGKey(4), x))
    mesh = Mesh(np.array(jax.devices()[:4]), ('data',))
    shard = NamedSharding(mesh, P('data'))
    saver = JaxPreconditioner(JaxLeNet(), loss_fn=xent, mesh=mesh,
                              grad_worker_fraction=0.25, **HP)
    xs, ys = jax.device_put(x, shard), jax.device_put(jnp.asarray(y), shard)
    state = saver.init(variables, xs)
    for _ in range(4):
        _, _, _, state = saver.step(variables, state, xs, loss_args=(ys,))
    assert saver._second_order.plan.n_cols == 4
    loader = JaxPreconditioner(JaxLeNet(), loss_fn=xent, **HP)
    return dict(saver=saver, state=state, loader=loader,
                variables=variables, x=x, y=y)


def jax_restore_and_port(tmp_path, jl, **save_kw):
    """Save ``jl``'s state as a JAX generation, restore it with JAX on
    one device and step, carry it by ``jax_generation_to_torch`` into a
    one-process port and step: ``(gen, jinfo, info, precond, net,
    want)``, ``want`` JAX's gradients by port name."""
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu import elastic as jel
    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
    from kfac_pytorch_tpu_torch.convert import jax_generation_to_torch

    x, y, variables, loader = jl['x'], jl['y'], jl['variables'], jl['loader']
    gen = jel.save_streaming(str(tmp_path / 'jax'), jl['saver'], jl['state'],
                             **save_kw)
    lstate, jinfo = jel.restore_streaming(
        str(tmp_path / 'jax'), loader, loader.init(variables, x))
    _, _, grads, _ = loader.step(variables, lstate, x,
                                 loss_args=(jnp.asarray(y),))
    want = flax_to_torch_state_dict({'params': jax.tree.map(np.asarray,
                                                            grads)})
    out = jax_generation_to_torch(gen, str(tmp_path / 'port'))
    net = LeNet(image_size=12)
    net.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    precond = kt.KFACPreconditioner(net, **HP)
    info = elastic.restore_streaming(str(tmp_path / 'port'), precond)
    assert info['generation'] == os.path.basename(out) == os.path.basename(
        gen)
    assert precond.steps == 4
    for name, st in precond.layers.items():
        for side in ('a_factor', 'g_factor'):
            np.testing.assert_allclose(
                getattr(st, side).numpy(),
                np.asarray(getattr(jl['state'][name.replace('.', '/')],
                                   side)),
                rtol=0, atol=1e-6)
    F.cross_entropy(net(nchw(x)), torch.from_numpy(y)).backward()
    precond.step()
    for name, p in net.named_parameters():
        err = rel_err(p.grad.numpy(), want[name].numpy())
        assert err <= 1e-5, (name, err)
    return gen, jinfo, info


def test_jax_generation_restores_in_the_port(tmp_path, jax_lenet):
    # JAX's own restore on one device is a transplant to one column.
    gen, jinfo, info = jax_restore_and_port(tmp_path, jax_lenet)
    assert jinfo['resized'] and info['resized'] and not info['recomputed']
    # A corrupt JAX generation is refused by the bridge, named.
    from kfac_pytorch_tpu_torch.convert import jax_generation_to_torch

    _truncate(gen, 'layers.npz')
    with pytest.raises(elastic.ElasticCheckpointError, match='layers.npz'):
        jax_generation_to_torch(gen, str(tmp_path / 'port2'))


def test_jax_generation_without_stacks_recomputes(tmp_path, jax_lenet):
    """A JAX generation saved without its decompositions has no stacks
    to install: the port's restore runs the monolithic refresh, as
    JAX's does."""
    gen, jinfo, info = jax_restore_and_port(
        tmp_path, jax_lenet, include_decompositions=False)
    assert not [n for n in os.listdir(gen) if n.startswith('bucket-')]
    assert jinfo['recomputed'] and info['recomputed']
    assert not info['resized'] and not info['decompositions_installed']


# -- a world-size resize across ranks ----------------------------------------------

SAVE_WORLD, RESTORE_WORLD = 4, 2
RESIZE_HP = dict(HP, stagger_refresh=2)
SPAWN_TIMEOUT_S = 120


def global_batch(step):
    return data(n=8, seed=100 + step)


def resize_rank(rank, world, init, out):
    """Ranks 0-3 train at MEM-OPT (1x4) and save at steps 2 and 4;
    ranks 0-1 then restore at HYBRID-OPT (1x2), first with rank 1 unable
    to read ``gen-4`` (both land on ``gen-2``), then ``gen-4``, and run
    steps 4-6."""
    torch.set_num_threads(1)
    gen_dir = str(out / 'gens')
    dist.init_process_group(
        'gloo', init_method=f'file://{init}-a', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    torch.manual_seed(0)
    model = LeNet(image_size=12)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    precond = kt.KFACPreconditioner(
        ddp, grad_worker_fraction=kt.DistributedStrategy.MEM_OPT,
        **RESIZE_HP)
    q = 8 // world
    for step in range(4):
        x, y = global_batch(step)
        ddp.zero_grad()
        F.cross_entropy(ddp(nchw(x[rank * q:(rank + 1) * q])),
                        torch.from_numpy(y[rank * q:(rank + 1) * q])
                        ).backward()
        precond.step()
        if step in (1, 3):
            elastic.save_streaming(gen_dir, precond, extras=training_extras(
                model, torch.optim.SGD(model.parameters(), lr=0.1)))
    rec = {'cols_saved': precond.grid.cols}
    dist.barrier()
    dist.destroy_process_group()
    if rank >= RESTORE_WORLD:
        torch.save(rec, out / f'rank{rank}.pt')
        return
    dist.init_process_group(
        'gloo', init_method=f'file://{init}-b', rank=rank,
        world_size=RESTORE_WORLD, timeout=datetime.timedelta(seconds=60),
    )
    torch.manual_seed(5)
    model = LeNet(image_size=12)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    precond = kt.KFACPreconditioner(
        ddp, grad_worker_fraction=kt.DistributedStrategy.HYBRID_OPT,
        **RESIZE_HP)
    real_load = elastic._load_generation

    def unreadable_newest(gen):
        if rank == 1 and gen.endswith('gen-00000004'):
            raise OSError(f'{gen}: read failed')
        return real_load(gen)

    elastic._load_generation = unreadable_newest
    try:
        fell_back = elastic.restore_streaming(gen_dir, precond)
    finally:
        elastic._load_generation = real_load
    rec['fallback'] = (fell_back['generation'], fell_back['skipped'],
                       precond.steps)
    info = elastic.restore_streaming(gen_dir, precond)
    model.load_state_dict({k[len('model/'):]: v for k, v in
                           info['extras'].items() if k.startswith('model/')})
    rec.update(
        info={k: v for k, v in info.items() if k != 'extras'},
        cols=precond.grid.cols, col=precond.grid.col,
        flags=(precond._stagger_bootstrapped, precond._iter_bootstrapped,
               precond._overlap_bootstrapped),
        factors={n: (st.a_factor.clone(), st.g_factor.clone())
                 for n, st in precond.layers.items()},
        stacks={k: {f: t.clone() for f, t in bs.tensors().items()}
                for k, bs in precond.buckets.items()},
        refresh=[], grads=None,
    )
    q = 8 // RESTORE_WORLD
    for step in range(4, 7):
        x, y = global_batch(step)
        ddp.zero_grad()
        F.cross_entropy(ddp(nchw(x[rank * q:(rank + 1) * q])),
                        torch.from_numpy(y[rank * q:(rank + 1) * q])
                        ).backward()
        precond.step()
        rec['refresh'].append(precond.last_refresh)
        if step == 4:
            rec['grads'] = {n: p.grad.clone()
                            for n, p in model.named_parameters()}
    torch.save(rec, out / f'rank{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()


def test_world_four_to_two_resize(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, '--worker', str(r), str(SAVE_WORLD),
             str(tmp_path / 'pg_init'), str(tmp_path)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for r in range(SAVE_WORLD)
    ]
    deadline = time.time() + SPAWN_TIMEOUT_S
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
    assert not bad, bad
    ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
             for r in range(RESTORE_WORLD)]
    gen = elastic.list_generations(str(tmp_path / 'gens'))[-1]
    meta, shards = elastic._load_generation(gen)
    saved_slot = bucketing.signature_slot_map(meta['topology']['signature'])
    assert meta['topology']['signature']['n_cols'] == 4
    for rep in ranks:
        # Rank 1's failed read made both ranks skip gen-4 together.
        generation, skipped, steps = rep['fallback']
        assert generation == 'gen-00000002' and steps == 2
        assert [s['generation'] for s in skipped] == ['gen-00000004']
        assert skipped[0]['error'].startswith('rank 1: '), skipped
        assert 'read failed' in skipped[0]['error']
        assert rep['cols_saved'] == 4 and rep['cols'] == 2
        assert rep['info']['resized'] and not rep['info']['recomputed']
        assert rep['flags'] == (False, False, False)
        # The next due refresh (step 6) is the monolithic bootstrap, not
        # stagger shard 0; steps 4 and 5 precondition through the
        # transplanted stacks.
        assert rep['refresh'] == [None, None, 'full']
        for n, (a, g) in rep['factors'].items():
            assert np.array_equal(a.numpy(), shards['layers.npz'][
                f'{n}::a_factor'])
            assert np.array_equal(g.numpy(), shards['layers.npz'][
                f'{n}::g_factor'])
    # Every occupied live slot holds its layer's saved rows, bitwise.
    from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan

    probe = kt.KFACPreconditioner(LeNet(image_size=12), **RESIZE_HP)
    live = make_bucket_plan(probe.helpers, n_cols=2)
    checked = 0
    for b in live.buckets:
        saved = shards[f'bucket-{b.key}.npz']
        for rep in ranks:
            col = rep['col']
            for i, name in enumerate(b.column_slots(col)):
                if name is None:
                    continue
                okey, oslot = saved_slot[name]
                for f, t in rep['stacks'][b.key].items():
                    assert np.array_equal(t[i].numpy(), saved[f][oslot]), (
                        b.key, name, f)
                checked += 1
    assert checked == sum(len(plan_b) for plan_b in [
        [n for n in b.slots if n is not None] for b in live.buckets])
    # The first resumed step against one process restoring the same
    # generation and running the global batch.
    torch.manual_seed(5)
    model = LeNet(image_size=12)
    precond = kt.KFACPreconditioner(model, **RESIZE_HP)
    info = elastic.restore_streaming(str(tmp_path / 'gens'), precond)
    model.load_state_dict({k[len('model/'):]: v for k, v in
                           info['extras'].items() if k.startswith('model/')})
    x, y = global_batch(4)
    F.cross_entropy(model(nchw(x)), torch.from_numpy(y)).backward()
    precond.step()
    for n, p in model.named_parameters():
        for rep in ranks:
            err = rel_err(rep['grads'][n].numpy(), p.grad.numpy())
            assert err <= 1e-5, (n, err)


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    resize_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
                Path(sys.argv[5]))
