"""Fault-injection drills of the port, one entry point, one artifact
convention (:mod:`~kfac_pytorch_tpu_torch.scripts._drill`).

Port of ``scripts/fault_drill.py``.  A device of the JAX drills' virtual
CPU mesh is a rank of a ``torch.distributed`` world here: each leg is a
world of ranks started with :func:`kfac_pytorch_tpu_torch.testing.\
spawn_ranks`, on the card (``--device cuda``, the default; every rank on
``cuda:0`` over gloo when there are fewer cards than ranks, as
:func:`~kfac_pytorch_tpu_torch.parallel.mesh.default_backend` says) or
on the CPU (``--device cpu``).  Each world size is a parameter whose
default is the JAX drill's device count, and the phase names follow it.

**Numerical health** (default): runs ``tests/test_torch_health.py``
through ``pytest.main`` (``--device cuda``: the card's health tests of
``tests/test_torch_kernel_cuda.py``); extra arguments pass through to
pytest::

    python -m kfac_pytorch_tpu_torch.scripts.fault_drill --device cpu -q

**Elastic** (``--elastic``): a world of 8 ranks is SIGKILLed mid-save
(from ``save_streaming``'s ``on_shard`` hook, after
``KILL_AFTER_SHARDS`` shards, before the manifest); a same-world resume
names the torn generation, restores the one before it with no
decomposition recompute and reaches the reference bit for bit; the run
then resumes at 4 and at 2 ranks (stacks transplanted, still no
recompute) and ends within ``RESIZE_REL_ERR_BOUND`` of the reference;
and a layers-only generation (``include_decompositions=False``)
restores with the recompute.

**Consistency** (``--consistency``): one rank's copy of a decomposition
stack and of a factor EMA takes an exponent-bit flip between refreshes
(``testing.desync_replica``); the guard detects it within the cadence,
the repair restores bitwise agreement over every curvature surface
(``consistency.host_replica_divergence``), and the repaired run ends
closer to the uncorrupted one than an unguarded contrast.

**Watchdog** (``--watchdog``): a finite curvature poison that health
and the consistency guard cannot see; the watchdog detects it, rolls
back bit for bit onto a ``healthy`` generation from before the poison,
and replays closer to the clean run than the unguarded contrast.

**Postmortem** (``--postmortem``): the flight recorder under health,
the watchdog and the observe monitor; a SIGKILLed run's periodic
snapshot is schema-valid, fresh within one flush and bitwise the
reference's series; a NaN batch latches ``health_step_skip``; the run
with the recorder on is bitwise the run with it off.

**Multi-process** (``--multiproc``): bounded init against a dead
coordinator, world 2 against world 1, two world-2 runs bitwise equal, a
rank death (exit 87, a ``kfac-rank-death`` record, the flight recorder
dumped), the 2 -> 1 resize restore, the consistency repair across
processes, and the seeded rank-guarded barrier: flagged by
:mod:`kfac_pytorch_tpu_torch.analysis.collective` before any process
starts, then shown to wedge while its unguarded contrast completes.

Each drill writes its artifact with ``--json-out`` and has a validator
(``--validate-<drill> PATH``) that re-checks the pinned bounds::

    python -m kfac_pytorch_tpu_torch.scripts.fault_drill --elastic \\
        --device cuda --json-out elastic_drill.json
    python -m kfac_pytorch_tpu_torch.scripts.fault_drill \\
        --validate-elastic elastic_drill.json
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
from typing import Any

import numpy as np

from kfac_pytorch_tpu_torch.scripts._drill import CONS_CADENCE
from kfac_pytorch_tpu_torch.scripts._drill import CONS_FLIP_BIT
from kfac_pytorch_tpu_torch.scripts._drill import CONS_INJECT_STEP
from kfac_pytorch_tpu_torch.scripts._drill import CONS_INV_UPDATE_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import CONS_REJOIN_BOUND
from kfac_pytorch_tpu_torch.scripts._drill import CONS_SCHEMA
from kfac_pytorch_tpu_torch.scripts._drill import CONS_TARGET_REPLICA
from kfac_pytorch_tpu_torch.scripts._drill import CONS_TOTAL_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import CONS_WORLD
from kfac_pytorch_tpu_torch.scripts._drill import ELASTIC_SCHEMA
from kfac_pytorch_tpu_torch.scripts._drill import ELASTIC_WORLDS
from kfac_pytorch_tpu_torch.scripts._drill import FINAL_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import HEALTH_SCHEMA
from kfac_pytorch_tpu_torch.scripts._drill import INV_UPDATE_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import KILL_AFTER_SHARDS
from kfac_pytorch_tpu_torch.scripts._drill import KILL_SAVE_STEP
from kfac_pytorch_tpu_torch.scripts._drill import LAYERS_ONLY_SAVE_STEP
from kfac_pytorch_tpu_torch.scripts._drill import LEG_TIMEOUT_S
from kfac_pytorch_tpu_torch.scripts._drill import MID_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import MP_BARRIER_TIMEOUT_S
from kfac_pytorch_tpu_torch.scripts._drill import MP_DETECT_BOUND_S
from kfac_pytorch_tpu_torch.scripts._drill import MP_DEVICES_PER_RANK
from kfac_pytorch_tpu_torch.scripts._drill import MP_EXIT_RANK_DEATH
from kfac_pytorch_tpu_torch.scripts._drill import MP_FLIGHT_FLUSH_EVERY
from kfac_pytorch_tpu_torch.scripts._drill import MP_FLIGHT_WINDOW
from kfac_pytorch_tpu_torch.scripts._drill import MP_HEARTBEAT_GRACE_S
from kfac_pytorch_tpu_torch.scripts._drill import MP_HEARTBEAT_INTERVAL_S
from kfac_pytorch_tpu_torch.scripts._drill import MP_INIT_DEADLINE_S
from kfac_pytorch_tpu_torch.scripts._drill import MP_INIT_WALL_CAP_S
from kfac_pytorch_tpu_torch.scripts._drill import MP_KILL_RANK
from kfac_pytorch_tpu_torch.scripts._drill import MP_KILL_SAVE_STEP
from kfac_pytorch_tpu_torch.scripts._drill import MP_NPROCS
from kfac_pytorch_tpu_torch.scripts._drill import MP_PARITY_REL_ERR_BOUND
from kfac_pytorch_tpu_torch.scripts._drill import MP_RANK_GUARD_RULE
from kfac_pytorch_tpu_torch.scripts._drill import MP_RANK_GUARD_TIMEOUT_S
from kfac_pytorch_tpu_torch.scripts._drill import MP_SAVE_EVERY
from kfac_pytorch_tpu_torch.scripts._drill import MP_SCHEMA
from kfac_pytorch_tpu_torch.scripts._drill import MP_TOTAL_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import PM_FLUSH_EVERY
from kfac_pytorch_tpu_torch.scripts._drill import PM_INV_UPDATE_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import PM_KILL_STEP
from kfac_pytorch_tpu_torch.scripts._drill import PM_MIN_OVERLAP_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import PM_MIN_SUBSYSTEMS
from kfac_pytorch_tpu_torch.scripts._drill import PM_NAN_STEP
from kfac_pytorch_tpu_torch.scripts._drill import PM_SCHEMA
from kfac_pytorch_tpu_torch.scripts._drill import PM_TOTAL_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import PM_WINDOW
from kfac_pytorch_tpu_torch.scripts._drill import PM_WORLD
from kfac_pytorch_tpu_torch.scripts._drill import RESIZE_REL_ERR_BOUND
from kfac_pytorch_tpu_torch.scripts._drill import SHORT_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import WD_CHECK_EVERY
from kfac_pytorch_tpu_torch.scripts._drill import WD_CLEARANCE
from kfac_pytorch_tpu_torch.scripts._drill import WD_DETECT_BOUND
from kfac_pytorch_tpu_torch.scripts._drill import WD_INJECT_STEP
from kfac_pytorch_tpu_torch.scripts._drill import WD_INV_UPDATE_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import WD_POISON_SCALE
from kfac_pytorch_tpu_torch.scripts._drill import WD_PROBE_MIN_DRIFT
from kfac_pytorch_tpu_torch.scripts._drill import WD_REJOIN_BOUND
from kfac_pytorch_tpu_torch.scripts._drill import WD_SAVE_EVERY
from kfac_pytorch_tpu_torch.scripts._drill import WD_SCHEMA
from kfac_pytorch_tpu_torch.scripts._drill import WD_TOTAL_STEPS
from kfac_pytorch_tpu_torch.scripts._drill import WD_WINDOW
from kfac_pytorch_tpu_torch.scripts._drill import WD_WORLD
from kfac_pytorch_tpu_torch.scripts._drill import drill_artifact
from kfac_pytorch_tpu_torch.scripts._drill import drill_rel_err
from kfac_pytorch_tpu_torch.scripts._drill import validate_drill_artifact
from kfac_pytorch_tpu_torch.scripts._drill import write_drill_artifact

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = 'kfac_pytorch_tpu_torch.scripts.fault_drill'

# Seconds the other ranks of a leg get to end by themselves once one
# rank has failed or been killed (they are left in a collective with a
# dead peer), before they are SIGKILLed.
FAILED_LEG_GRACE_S = 10.0

# The seeded negative of the multiproc drill, kept as source text so
# the package sweep does not see it as code: a barrier only rank 0
# reaches.  The drill lints this text (the analyzer must flag it as
# ``collective-under-rank-guard``) and runs the function it defines on
# a live world of two ranks to show the flagged pattern wedges.  Do not
# fix it and do not give it a pragma: being caught is its job.
SEEDED_RANK_GUARD_SOURCE = '''\
def seeded_rank_guarded_barrier(rt, timeout_s=None):
    import torch.distributed as dist

    if dist.get_rank() == 0:
        rt.barrier('drill/start', timeout_s=timeout_s)
'''

# Its contrast: the same barrier on every rank.  Lints clean and
# completes at once on the same world.
UNGUARDED_BARRIER_SOURCE = '''\
def unguarded_barrier(rt, timeout_s=None):
    rt.barrier('drill/start', timeout_s=timeout_s)
'''


def _defined(source: str, name: str):
    scope: dict[str, Any] = {}
    exec(compile(source, f'<{name}>', 'exec'), scope)  # noqa: S102
    return scope[name]


# ----------------------------------------------------------------------
# ranks: environment, device, the tiny-MLP problem
# ----------------------------------------------------------------------


def _rank_world() -> tuple[int, int]:
    """This process's ``(rank, world)`` from :func:`~kfac_pytorch_tpu_\
torch.testing.spawn_ranks`'s environment."""
    return (int(os.environ.get('KFAC_RANK', '0')),
            int(os.environ.get('KFAC_NPROCS', '1')))


def _device(name: str, rank: int, world: int):
    """The rank's device: ``cuda:0`` for every rank over gloo (its own
    card over NCCL), with TF32 off; the CPU for ``'cpu'``."""
    import torch

    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    if name == 'cpu':
        torch.set_num_threads(1)
        return torch.device('cpu'), 'gloo'
    if not torch.cuda.is_available():
        raise RuntimeError(
            '--device cuda needs a CUDA card; pass --device cpu to run the '
            'drill on the CPU',
        )
    backend = default_backend(world)
    dev = torch.device(
        'cuda', rank % torch.cuda.device_count() if backend == 'nccl' else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev, backend


def _init_world(device_name: str):
    """``(rank, world, device)``, the default process group up over the
    spawned environment when the world has several ranks."""
    import datetime

    import torch.distributed as dist

    rank, world = _rank_world()
    dev, backend = _device(device_name, rank, world)
    if world > 1:
        dist.init_process_group(
            backend, init_method='env://', rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=LEG_TIMEOUT_S),
        )
        _destroy_at_exit()
    return rank, world, dev


def _destroy_at_exit() -> None:
    """Destroy the process group when the interpreter exits, after the
    exit handlers registered later (a flight recorder's dump, which names
    its file by rank): a group left to the interpreter's teardown can
    abort the process ("terminate called without an active
    exception")."""
    import atexit

    import torch.distributed as dist

    def destroy():
        try:
            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — best effort at exit
            pass

    atexit.register(destroy)


def make_problem(seed: int = 0, n: int = 16, d: int = 10,
                 classes: int = 5, scale: float = 0.5):
    """The drills' class-separable data (JAX ``testing.\
make_classification``'s recipe, drawn with numpy): one fixed global
    batch, the same at every world size."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((classes, d))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    y = rng.integers(0, classes, size=(n,))
    x = means[y] + scale * rng.standard_normal((n, d))
    return x.astype(np.float32), y.astype(np.int64)


def _local_batch(dev, rank: int, world: int, x=None):
    """This rank's rows of the global batch."""
    import torch

    gx, gy = make_problem()
    if x is not None:
        gx = x
    if gx.shape[0] % world:
        raise ValueError(
            f'the batch of {gx.shape[0]} rows does not split over a world '
            f'of {world}',
        )
    rows = gx.shape[0] // world
    sl = slice(rank * rows, (rank + 1) * rows)
    return (torch.from_numpy(np.ascontiguousarray(gx[sl])).to(dev),
            torch.from_numpy(gy[sl]).to(dev))


def _engine(dev, world: int, strategy: str, **kfac_kw):
    """TinyModel (seeded) and its preconditioner (``damping 0.003``,
    ``lr 0.1``, factors every step).  Each rank differentiates its local
    batch's mean loss and :func:`_train_step` averages the gradients, as
    ``DistributedDataParallel`` does but in one fixed layout: a new DDP
    wrapper's first all-reduce buckets the gradients in another order
    than its later ones, and a resumed process would then sum in another
    order than the uninterrupted one and move the last bit."""
    import torch

    import kfac_pytorch_tpu_torch as kt

    torch.manual_seed(2)
    model = kt.models.TinyModel(10, 20, 10).to(dev)
    kw = dict(factor_update_steps=1, damping=0.003, lr=0.1,
              grad_worker_fraction=getattr(kt.DistributedStrategy,
                                           strategy))
    kw.update(kfac_kw)
    precond = kt.KFACPreconditioner(model, **kw)
    return model, precond


def _train_step(model, precond, xb, yb, lr: float = 0.1):
    """One K-FAC step and ``p -= lr * grad``; returns the local loss."""
    import torch
    import torch.nn.functional as F

    for p in model.parameters():
        p.grad = None
    loss = F.cross_entropy(model(xb), yb)
    loss.backward()
    _average_grads(model)
    precond.step()
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(lr * p.grad)
    return loss


def _average_grads(model) -> None:
    """The ranks' mean gradient, by one all-reduce of the gradients laid
    end to end in parameter order."""
    import torch
    import torch.distributed as dist

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return
    params = list(model.parameters())
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def _global_loss(loss, world: int) -> float:
    """The mean of the ranks' losses (the global batch's)."""
    import torch.distributed as dist

    t = loss.detach().double().reshape(1)
    if world > 1:
        dist.all_reduce(t)
        t /= world
    return float(t.item())


def _param_tensors(model) -> dict:
    return {f'p.{n}': p.detach() for n, p in model.named_parameters()}


def _flat_params(model) -> dict:
    return {k: v.cpu().numpy().copy()
            for k, v in _param_tensors(model).items()}


def _load_params(model, arrays) -> None:
    import torch

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.as_tensor(np.asarray(arrays[f'p.{n}'])))


def _finish_world(world: int) -> None:
    """A last barrier, so no rank leaves while a peer still reads."""
    import torch.distributed as dist

    if world > 1:
        dist.barrier()


# ----------------------------------------------------------------------
# legs: worlds of ranks run from the orchestrator
# ----------------------------------------------------------------------


def _child_argv(flag: str, spec: dict, module: str = MODULE) -> list[str]:
    return [sys.executable, '-m', module, flag, json.dumps(spec)]


def _start_world(name: str, flag: str, spec: dict, world: int, *,
                 grace_s: float = FAILED_LEG_GRACE_S,
                 coordinator: str | None = None,
                 module: str = MODULE) -> dict:
    """Start a world of ``world`` ranks running ``python -m module flag
    spec`` (:func:`~kfac_pytorch_tpu_torch.testing.spawn_ranks`) and
    drain their output; :func:`_wait_world` ends it."""
    from kfac_pytorch_tpu_torch import testing as ktest

    print(f'== drill leg: {name} (world {world}) ==', flush=True)
    env = {'OMP_NUM_THREADS': '1'} if spec.get('device') == 'cpu' else None
    procs, _ = ktest.spawn_ranks(
        world, _child_argv(flag, spec, module), cwd=REPO, extra_env=env,
        coordinator=coordinator,
    )
    bufs: list[list[str]] = [[] for _ in procs]

    def _drain(p, buf):
        for line in p.stdout:
            buf.append(line)

    threads = [threading.Thread(target=_drain, args=(p, b), daemon=True)
               for p, b in zip(procs, bufs)]
    for t in threads:
        t.start()
    return {'name': name, 'procs': procs, 'bufs': bufs, 'threads': threads,
            'grace_s': grace_s, 't0': time.monotonic()}


def _wait_world(leg: dict, expect_failure: bool = False):
    """Wait for a world :func:`_start_world` started.  Once a rank has
    failed, the others get the leg's ``grace_s`` to end by themselves
    and are then SIGKILLed.  A failed rank's last lines are printed
    unless the leg is meant to fail (``expect_failure``).  Returns
    ``(returncodes, outputs, exit_times)``."""
    procs = leg['procs']
    exit_at: dict[int, float] = {}
    deadline = leg['t0'] + LEG_TIMEOUT_S
    failed_at = None
    while len(exit_at) < len(procs):
        now = time.monotonic()
        for i, p in enumerate(procs):
            if i not in exit_at and p.poll() is not None:
                exit_at[i] = now
                if p.returncode != 0 and failed_at is None:
                    failed_at = now
        if now >= deadline or (failed_at is not None
                               and now - failed_at >= leg['grace_s']):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            now = time.monotonic()
            for i in range(len(procs)):
                exit_at.setdefault(i, now)
            break
        time.sleep(0.02)
    for p in procs:
        p.wait()
    for t in leg['threads']:
        t.join(timeout=10.0)
    outs = [''.join(b) for b in leg['bufs']]
    rcs = [p.returncode for p in procs]
    for i, (rc, out) in enumerate(zip(rcs, outs)):
        if rc != 0 and not expect_failure:
            tail = ''.join(out.splitlines(True)[-15:])
            print(f'-- {leg["name"]} rank {i} rc={rc} tail --\n{tail}',
                  flush=True)
    print(f'== drill leg: {leg["name"]} ended in '
          f'{time.monotonic() - leg["t0"]:.2f} s, exit codes {rcs} ==',
          flush=True)
    return rcs, outs, exit_at


def _wait_for(path: str) -> None:
    """Block until the orchestrator creates ``path`` (a leg started
    before the leg it depends on has ended: the start, the imports and
    the card's context are paid meanwhile)."""
    deadline = time.monotonic() + LEG_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError(f'{path} never appeared')
        time.sleep(0.05)


def _touch(path: str) -> None:
    with open(path, 'w'):
        pass


def _run_world(name: str, flag: str, spec: dict, world: int, **kw):
    """:func:`_start_world` then :func:`_wait_world`."""
    return _wait_world(_start_world(name, flag, spec, world, **kw))


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _load_leg(out: str) -> tuple[dict, dict]:
    meta = _read_json(out + '.json')
    with np.load(out + '.npz') as npz:
        arrays = {k: npz[k] for k in npz.files}
    return meta, arrays


def _param_keys(arrays: dict) -> list[str]:
    return sorted(k for k in arrays if not k.startswith('snap'))


def _compare_bitwise(a: dict, b: dict, keys_a: list[str],
                     prefix_b: str = '') -> tuple[bool, float]:
    equal = True
    max_abs = 0.0
    for k in keys_a:
        va, vb = a[k], b[prefix_b + k]
        if not np.array_equal(va, vb):
            equal = False
        max_abs = max(max_abs, float(np.max(np.abs(va - vb), initial=0.0)))
    return equal, max_abs


def _compare_rel(a: dict, b: dict, keys: list[str],
                 prefix_b: str = '') -> float:
    worst = 0.0
    for k in keys:
        num = float(np.linalg.norm(a[k] - b[prefix_b + k]))
        den = float(np.linalg.norm(b[prefix_b + k])) + 1e-12
        worst = max(worst, num / den)
    return worst


def _finish(drill: str, schema: str, phases: dict, config: dict,
            work: str, json_out: str | None, extra: dict | None = None
            ) -> int:
    """Write the artifact, keep the work directory on failure, return
    the exit code."""
    ok_all = bool(phases) and all(p.get('ok', False) for p in phases.values())
    if ok_all:
        shutil.rmtree(work, ignore_errors=True)
    else:
        print(f'{drill} drill work dir kept for diagnosis: {work}')
    payload = drill_artifact(schema, ok_all, config, phases)
    if extra:
        payload.update(extra)
    if json_out:
        write_drill_artifact(json_out, payload)
    print(json.dumps(payload['phases'], indent=1, sort_keys=True,
                     default=str))
    print(f'{drill} drill: ' + ('all green' if ok_all else 'FAILED'))
    return 0 if ok_all else 1


# ----------------------------------------------------------------------
# health drill
# ----------------------------------------------------------------------


def run_health_drill(extra_args: list[str], json_out: str | None,
                     device: str = 'cuda') -> int:
    """The health suite through ``pytest.main``: the port's parity tests
    of the guardrails on the CPU, the card's health tests on CUDA."""
    import pytest

    if device == 'cuda':
        args = [os.path.join(REPO, 'tests', 'test_torch_kernel_cuda.py'),
                '--noconftest', '-m', 'cuda', '-k', 'quarantine or verdict']
    else:
        args = [os.path.join(REPO, 'tests', 'test_torch_health.py')]
    args += ['-p', 'no:cacheprovider', *extra_args]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        rc = int(pytest.main(list(args)))
    finally:
        os.chdir(cwd)
    if json_out:
        write_drill_artifact(json_out, drill_artifact(
            HEALTH_SCHEMA, rc == 0,
            {'pytest_args': args, 'device': device,
             'extra_args': extra_args},
            {'health_suite': {'ok': rc == 0, 'returncode': rc}},
        ))
    if rc == 0:
        print('fault drill: all recovery paths green')
    return rc


# ----------------------------------------------------------------------
# elastic drill
# ----------------------------------------------------------------------


def _resize_names(worlds) -> list[str]:
    w0, w1, w2 = worlds
    return [f'resize_{w0}_to_{w1}', f'resize_{w1}_to_{w2}']


def run_elastic_child(spec_json: str) -> int:
    """One rank of an elastic-drill leg: train, save every
    ``save_every`` steps (rank 0 SIGKILLs itself from the ``on_shard``
    hook at ``kill_save_step``), optionally resume first; rank 0 writes
    the leg's ``out.npz`` / ``out.json``."""
    from kfac_pytorch_tpu_torch import elastic
    from kfac_pytorch_tpu_torch import testing as ktest

    spec = json.loads(spec_json)
    rank, world, dev = _init_world(spec['device'])
    xb, yb = _local_batch(dev, rank, world)
    model, precond = _engine(dev, world, 'MEM_OPT',
                                  inv_update_steps=INV_UPDATE_STEPS)
    if spec.get('go'):
        _wait_for(spec['go'])
    start, restore_info = 0, None
    if spec.get('resume'):
        info = elastic.restore_streaming(spec['save_dir'], precond)
        extras = info.pop('extras')
        if extras is None:
            raise RuntimeError('resume generation carries no params')
        _load_params(model, extras)
        start = precond.steps
        restore_info = info

    kill_step = spec.get('kill_save_step')
    shards_seen = 0

    def killer(name: str) -> None:
        nonlocal shards_seen
        shards_seen += 1
        if shards_seen >= KILL_AFTER_SHARDS:
            # The preemption itself: no cleanup, no atexit.
            ktest.kill_rank(os.getpid())

    losses, snapshots = [], {}
    for step in range(start, int(spec['total_steps'])):
        loss = _train_step(model, precond, xb, yb)
        losses.append(_global_loss(loss, world))
        done = step + 1
        if done in spec.get('snapshot_at', []):
            snapshots[done] = _flat_params(model)
        if spec.get('save_every') and done % int(spec['save_every']) == 0:
            elastic.save_streaming(
                spec['save_dir'], precond, extras=_param_tensors(model),
                on_shard=killer if done == kill_step else None,
            )
        if done == spec.get('layers_only_at'):
            elastic.save_streaming(
                spec['layers_dir'], precond, include_decompositions=False,
                extras=_param_tensors(model),
            )
    if rank == 0:
        out = spec['out']
        arrays = dict(_flat_params(model))
        for at, snap in snapshots.items():
            arrays.update({f'snap{at}::{k}': v for k, v in snap.items()})
        with open(out + '.npz', 'wb') as fh:
            np.savez(fh, **arrays)
        with open(out + '.json', 'w') as fh:
            json.dump({
                'world': world,
                'start_step': start,
                'final_step': int(spec['total_steps']),
                'losses': losses,
                'restore_info': restore_info,
            }, fh, indent=1)
    _finish_world(world)
    return 0


def run_elastic_drill(json_out: str | None, device: str = 'cuda',
                      worlds=ELASTIC_WORLDS) -> int:
    """The kill, torn-save fallback, bitwise resume, two resizes and the
    layers-only recompute; see the module docstring."""
    w0, w1, w2 = (int(w) for w in worlds)
    if not w0 > w1 > w2 >= 1:
        raise ValueError(f'elastic worlds must shrink: {worlds}')
    work = tempfile.mkdtemp(prefix='elastic_drill_')
    save_dir = os.path.join(work, 'ckpt')
    layers_dir = os.path.join(work, 'layers_only')
    phases: dict[str, dict] = {}

    def start(name, world, spec):
        spec = dict(spec, device=device, out=os.path.join(work, name))
        return _start_world(name, '--elastic-child', spec, world)

    resize_names = _resize_names((w0, w1, w2))
    go = {name: os.path.join(work, f'go-{name}') for name in (
        'resume', *resize_names, 'layers_only')}
    legs: dict[str, dict] = {}
    try:
        # Every leg starts at once: the reference and the victim run, and
        # each later leg waits (started, imported, on the card) for the
        # go file of the leg it restores from.
        legs['ref'] = start('ref', w0, {
            'total_steps': FINAL_STEPS,
            'snapshot_at': [SHORT_STEPS, MID_STEPS],
            'layers_only_at': LAYERS_ONLY_SAVE_STEP,
            'layers_dir': layers_dir,
        })
        legs['victim'] = start('victim', w0, {
            'total_steps': SHORT_STEPS, 'save_every': 1,
            'save_dir': save_dir, 'kill_save_step': KILL_SAVE_STEP,
        })
        legs['resume'] = start('resume', w0, {
            'total_steps': SHORT_STEPS, 'save_every': 1,
            'save_dir': save_dir, 'resume': True, 'go': go['resume'],
        })
        for name, world, total in zip(resize_names, (w1, w2),
                                      (MID_STEPS, FINAL_STEPS)):
            legs[name] = start(name, world, {
                'total_steps': total, 'save_every': 1,
                'save_dir': save_dir, 'resume': True, 'go': go[name],
            })
        legs['layers_only'] = start('layers_only', w2, {
            'total_steps': MID_STEPS, 'save_dir': layers_dir, 'resume': True,
            'go': go['layers_only'],
        })

        ref_rcs, _, _ = _wait_world(legs.pop('ref'))
        if any(ref_rcs):
            raise RuntimeError(f'reference leg failed: {ref_rcs}')
        _touch(go['layers_only'])
        ref_meta, ref_arrays = _load_leg(os.path.join(work, 'ref'))

        rcs, _, _ = _wait_world(legs.pop('victim'), expect_failure=True)
        torn = f'gen-{KILL_SAVE_STEP:08d}'
        killed = rcs[0] == -signal.SIGKILL
        torn_exists = os.path.isdir(os.path.join(save_dir, torn))
        torn_uncommitted = not os.path.isfile(
            os.path.join(save_dir, torn, 'MANIFEST.json'))
        phases['mid_save_kill'] = {
            'ok': killed and torn_exists and torn_uncommitted,
            'returncode': rcs[0],
            'returncodes': rcs,
            'torn_generation': torn,
            'torn_has_no_manifest': torn_uncommitted,
        }

        _touch(go['resume'])
        rcs, _, _ = _wait_world(legs.pop('resume'))
        if any(rcs):
            raise RuntimeError(f'same-world resume leg failed: {rcs}')
        r_meta, r_arrays = _load_leg(os.path.join(work, 'resume'))
        rinfo = r_meta['restore_info']
        keys = _param_keys(r_arrays)
        bitwise, max_abs = _compare_bitwise(
            r_arrays, ref_arrays, keys, prefix_b=f'snap{SHORT_STEPS}::')
        skipped_names = [s['generation'] for s in rinfo['skipped']]
        phases['same_world_bitwise'] = {
            'ok': (bitwise
                   and rinfo['generation'] == f'gen-{KILL_SAVE_STEP - 1:08d}'
                   and torn in skipped_names
                   and not rinfo['recomputed']
                   and rinfo['decompositions_installed']),
            'bitwise_equal': bitwise,
            'max_abs_diff': max_abs,
            'restored_generation': rinfo['generation'],
            'skipped_generations': skipped_names,
            'recomputed': rinfo['recomputed'],
        }

        prev_losses = r_meta['losses']
        final_arrays = None
        for name in resize_names:
            _touch(go[name])
            rcs, _, _ = _wait_world(legs.pop(name))
            if any(rcs):
                raise RuntimeError(f'{name} leg failed: {rcs}')
            meta, arrays = _load_leg(os.path.join(work, name))
            info = meta['restore_info']
            phases[name] = {
                'ok': bool(info['resized'] and not info['recomputed']
                           and info['decompositions_installed']),
                'resized': info['resized'],
                'recomputed': info['recomputed'],
                'start_step': meta['start_step'],
                'losses': meta['losses'],
            }
            prev_losses = meta['losses']
            final_arrays = arrays

        keys = _param_keys(final_arrays)
        rel = _compare_rel(final_arrays, ref_arrays, keys)
        phases['resize_divergence'] = {
            'ok': rel <= RESIZE_REL_ERR_BOUND,
            'param_rel_err': rel,
            'bound': RESIZE_REL_ERR_BOUND,
            'loss_reference': ref_meta['losses'][-1],
            'loss_resized_chain': prev_losses[-1],
        }

        # The layers-only generation: no bucket shard on disk, the meta
        # says so, and the restore (at the smallest world) recomputes.
        gen = os.path.join(layers_dir, f'gen-{LAYERS_ONLY_SAVE_STEP:08d}')
        shards = sorted(os.listdir(gen)) if os.path.isdir(gen) else []
        saved_meta = (_read_json(os.path.join(gen, 'meta.json'))
                      if 'meta.json' in shards else {})
        rcs, _, _ = _wait_world(legs.pop('layers_only'))
        if any(rcs):
            raise RuntimeError(f'layers-only restore leg failed: {rcs}')
        lo_meta, lo_arrays = _load_leg(os.path.join(work, 'layers_only'))
        linfo = lo_meta['restore_info']
        keys = _param_keys(lo_arrays)
        rel = _compare_rel(lo_arrays, ref_arrays, keys,
                           prefix_b=f'snap{MID_STEPS}::')
        no_buckets = not any(s.startswith('bucket-') for s in shards)
        phases['layers_only_recompute'] = {
            'ok': bool(no_buckets
                       and saved_meta.get('include_decompositions') is False
                       and linfo['generation'] == os.path.basename(gen)
                       and linfo['recomputed']
                       and rel <= RESIZE_REL_ERR_BOUND),
            'shards': shards,
            'include_decompositions': saved_meta.get('include_decompositions'),
            'restored_generation': linfo['generation'],
            'recomputed': linfo['recomputed'],
            'world': w2,
            'param_rel_err': rel,
            'bound': RESIZE_REL_ERR_BOUND,
        }
    except Exception as exc:  # noqa: BLE001 — the gate reports, not raises
        phases['error'] = {'ok': False, 'message': str(exc)}
    finally:
        # Legs still waiting are let go and ended.
        for path in go.values():
            _touch(path)
        for leg in legs.values():
            _wait_world(leg)

    return _finish('elastic', ELASTIC_SCHEMA, phases, {
        'kill_save_step': KILL_SAVE_STEP,
        'kill_after_shards': KILL_AFTER_SHARDS,
        'short_steps': SHORT_STEPS,
        'mid_steps': MID_STEPS,
        'final_steps': FINAL_STEPS,
        'inv_update_steps': INV_UPDATE_STEPS,
        'layers_only_save_step': LAYERS_ONLY_SAVE_STEP,
        'worlds': [w0, w1, w2],
        'device': device,
    }, work, json_out)


def validate_elastic_artifact(path: str) -> int:
    """Gate of an elastic artifact, independent of the writer's exit
    code.  The resize phases are named by the artifact's ``worlds``
    (default the JAX drill's 8, 4, 2); a port artifact (one that names
    its layers-only save step) must carry the layers-only recompute."""
    try:
        config = _read_json(path).get('config', {})
    except (OSError, ValueError):
        config = {}
    worlds = config.get('worlds', list(ELASTIC_WORLDS))
    errors: list[str] = []
    if not (isinstance(worlds, list) and len(worlds) == 3
            and all(isinstance(w, int) for w in worlds)
            and worlds[0] > worlds[1] > worlds[2] >= 1):
        errors.append(f'config.worlds {worlds!r} is not three shrinking '
                      'world sizes')
        worlds = list(ELASTIC_WORLDS)
    layers_only = 'layers_only_save_step' in config
    payload, more = validate_drill_artifact(path, ELASTIC_SCHEMA, (
        'mid_save_kill', 'same_world_bitwise', *_resize_names(worlds),
        'resize_divergence',
    ) + (('layers_only_recompute',) if layers_only else ()))
    if payload is None:
        print(f'elastic artifact INVALID: {more[0]}')
        return 1
    errors += more
    phases = payload.get('phases', {})
    if phases.get('same_world_bitwise', {}).get('bitwise_equal') is not True:
        errors.append('same-world recovery is not bitwise')
    rd = phases.get('resize_divergence', {})
    if not isinstance(rd.get('param_rel_err'), (int, float)):
        errors.append('resize_divergence.param_rel_err missing')
    else:
        if not rd['param_rel_err'] <= RESIZE_REL_ERR_BOUND:
            errors.append(
                f'resize divergence {rd["param_rel_err"]} exceeds the '
                f'pinned bound {RESIZE_REL_ERR_BOUND}')
        if rd.get('bound') != RESIZE_REL_ERR_BOUND:
            errors.append(
                f'artifact bound {rd.get("bound")!r} != pinned '
                f'{RESIZE_REL_ERR_BOUND} (writer drifted)')
    if layers_only:
        lo = phases.get('layers_only_recompute', {})
        if lo.get('recomputed') is not True:
            errors.append('the layers-only restore did not recompute')
        if lo.get('include_decompositions') is not False:
            errors.append('the layers-only generation does not record '
                          'include_decompositions=False')
        err = lo.get('param_rel_err')
        if not isinstance(err, (int, float)) or not (
                err <= RESIZE_REL_ERR_BOUND):
            errors.append(f'layers-only divergence {err!r} exceeds the '
                          f'pinned bound {RESIZE_REL_ERR_BOUND}')
    if errors:
        for e in errors:
            print(f'elastic artifact INVALID: {e}')
        return 1
    print('elastic artifact valid')
    return 0


# ----------------------------------------------------------------------
# consistency drill
# ----------------------------------------------------------------------


def _flip_buffer(bit: int):
    """Every element's f32 bit ``bit`` flipped: the corrupt-DMA fault
    model (the whole local buffer garbage, every op on it still fine)."""
    import torch

    def fn(t):
        out = t.detach().to(torch.float32).clone().contiguous()
        out.view(torch.int32).bitwise_xor_(1 << bit)
        return out

    return fn


def _corrupt(precond, replica: int, bit: int) -> None:
    """Rank ``replica``'s copy of the first bucket's decomposition stack
    (``qa``, or ``a_inv``) and of the first layer's A-factor EMA, flipped
    (every rank calls this; only the owner's buffers change)."""
    from kfac_pytorch_tpu_torch import testing as ktest

    fn = _flip_buffer(bit)
    key = sorted(precond.buckets)[0]
    bs = precond.buckets[key]
    field = 'qa' if bs.qa is not None else 'a_inv'
    setattr(bs, field, ktest.desync_replica(getattr(bs, field), replica, fn))
    st = precond.layers[sorted(precond.layers)[0]]
    st.a_factor = ktest.desync_replica(st.a_factor, replica, fn)


def _surfaces(precond) -> dict:
    """Every curvature surface by the JAX drill's names: each bucket
    field and each layer's factor EMAs."""
    from kfac_pytorch_tpu_torch.consistency import _fields

    out = {}
    for key in sorted(precond.buckets):
        for name, t in _fields(precond.buckets[key]):
            out[f"['buckets']['{key}'].{name}"] = t
    for base in sorted(precond.layers):
        st = precond.layers[base]
        for name in ('a_factor', 'g_factor'):
            out[f"['layers']['{base}'].{name}"] = getattr(st, name)
    return out


def _own_divergence(tensors: dict, world: int) -> list[str]:
    """Names whose bytes on this rank differ from rank 0's: what this
    rank alone can see of a replica fault (a collective)."""
    import torch
    import torch.distributed as dist

    from kfac_pytorch_tpu_torch.consistency import _byte_view

    if world <= 1:
        return []
    rank = dist.get_rank()
    out = []
    for name in sorted(tensors):
        local = _byte_view(tensors[name].contiguous())
        gathered = torch.empty(world * local.numel(), dtype=torch.uint8,
                               device=local.device)
        dist.all_gather_into_tensor(gathered, local)
        rows = gathered.view(world, -1)
        if not torch.equal(rows[0], rows[rank]):
            out.append(name)
    return out


def _info_int(info: dict, key: str) -> int:
    v = info.get(key, 0)
    return int(v.item() if hasattr(v, 'item') else v)


def _consistency_run(dev, rank, world, spec, *, guard: bool, inject: bool,
                     xb, yb) -> dict:
    """One trajectory of the consistency drill on this rank.  The
    parameters' divergence after the run is the guard's to remove: its
    repair votes on the parameters and the step's gradients too."""
    from kfac_pytorch_tpu_torch import consistency as clib
    from kfac_pytorch_tpu_torch.consistency import ConsistencyConfig

    model, precond = _engine(
        dev, world, 'COMM_OPT',
        inv_update_steps=int(spec['inv_update_steps']),
        consistency=(ConsistencyConfig(cadence=int(spec['cadence']))
                     if guard else None),
    )
    records, pre, own_pre = [], None, None
    for step in range(int(spec['total_steps'])):
        if inject and step == int(spec['inject_step']):
            _corrupt(precond, int(spec['target_replica']),
                     int(spec['flip_bit']))
            pre = clib.host_replica_divergence(_surfaces(precond))
            own_pre = _own_divergence(_surfaces(precond), world)
        loss = _train_step(model, precond, xb, yb)
        info = precond.last_step_info or {}
        rec = {
            'step': step,
            'loss': _global_loss(loss, world),
            'checked': _info_int(info, 'consistency/checked'),
            'mismatches': _info_int(info, 'consistency/mismatches'),
            'detections_total': _info_int(
                info, 'consistency/detections_total'),
            'repairs_total': _info_int(info, 'consistency/repairs_total'),
            'quarantines_total': _info_int(
                info, 'consistency/quarantines_total'),
        }
        records.append(rec)
    params = _flat_params(model)
    return {
        'records': records,
        'params': params,
        'pre_divergence': pre,
        'own_pre_divergence': own_pre or [],
        'post_divergence': clib.host_replica_divergence(_surfaces(precond)),
        'param_divergence': clib.host_replica_divergence(
            _param_tensors(model)),
    }


def run_consistency_child(spec_json: str) -> int:
    """One rank of the consistency leg: the reference (guard on, clean),
    the guarded victim and the unguarded contrast, in that order; rank 0
    writes the phases (over its own parameters, as the JAX drill reads
    device 0's)."""
    spec = json.loads(spec_json)
    rank, world, dev = _init_world(spec['device'])
    xb, yb = _local_batch(dev, rank, world)
    kw = dict(xb=xb, yb=yb)
    reference = _consistency_run(dev, rank, world, spec, guard=True,
                                 inject=False, **kw)
    guarded = _consistency_run(dev, rank, world, spec, guard=True,
                               inject=True, **kw)
    unguarded = _consistency_run(dev, rank, world, spec, guard=False,
                                 inject=True, **kw)
    _finish_world(world)
    if rank != 0:
        return 0
    inject_step = int(spec['inject_step'])
    cadence = int(spec['cadence'])
    detect_step = next((r['step'] for r in guarded['records']
                        if r['detections_total'] > 0), None)
    latency = None if detect_step is None else detect_step - inject_step
    guarded_err = drill_rel_err(guarded['params'], reference['params'])
    unguarded_err = drill_rel_err(unguarded['params'], reference['params'])
    bound = float(spec['rejoin_bound'])
    repairs = max(r['repairs_total'] for r in guarded['records'])
    phases = {
        'injection': {
            'ok': bool(guarded['pre_divergence'])
            and all(r['detections_total'] == 0
                    for r in unguarded['records']),
            'divergent_arrays': sorted(guarded['pre_divergence'] or {}),
            'inject_step': inject_step,
            'target_replica': int(spec['target_replica']),
        },
        'detection': {
            'ok': latency is not None and 0 <= latency <= cadence,
            'detect_step': detect_step,
            'inject_step': inject_step,
            'latency_steps': latency,
            'cadence': cadence,
        },
        'repair_agreement': {
            'ok': not guarded['post_divergence'] and repairs == 1
            and not guarded['param_divergence'],
            'divergent_after_repair': sorted(guarded['post_divergence']),
            'repairs_total': repairs,
            'quarantines_total': max(
                r['quarantines_total'] for r in guarded['records']),
            'param_divergence_after': sorted(guarded['param_divergence']),
        },
        'trajectory_rejoin': {
            'ok': guarded_err <= bound and guarded_err < unguarded_err,
            'param_rel_err': guarded_err,
            'bound': bound,
            'unguarded_rel_err': unguarded_err,
            'reference_loss': reference['records'][-1]['loss'],
            'guarded_loss': guarded['records'][-1]['loss'],
            'unguarded_loss': unguarded['records'][-1]['loss'],
        },
    }
    with open(spec['out'], 'w') as fh:
        json.dump({'phases': phases, 'records': guarded['records']}, fh,
                  indent=1, sort_keys=True)
    return 0


def consistency_target(world: int) -> int:
    """The corrupted rank: the JAX drill's device 3, or the last rank of
    a smaller world."""
    return CONS_TARGET_REPLICA if world > CONS_TARGET_REPLICA else world - 1


def run_consistency_drill(json_out: str | None, device: str = 'cuda',
                          world: int = CONS_WORLD) -> int:
    """Orchestrate the consistency drill; see the module docstring."""
    if world < 2:
        raise ValueError('the consistency drill needs a world of >= 2 ranks')
    work = tempfile.mkdtemp(prefix='consistency_drill_')
    out = os.path.join(work, 'consistency_leg.json')
    target = consistency_target(world)
    phases: dict[str, dict] = {}
    try:
        rcs, _, _ = _run_world(
            f'consistency (bit flip on rank {target})',
            '--consistency-child', {
                'device': device,
                'total_steps': CONS_TOTAL_STEPS,
                'cadence': CONS_CADENCE,
                'inject_step': CONS_INJECT_STEP,
                'inv_update_steps': CONS_INV_UPDATE_STEPS,
                'target_replica': target,
                'flip_bit': CONS_FLIP_BIT,
                'rejoin_bound': CONS_REJOIN_BOUND,
                'out': out,
            }, world)
        if any(rcs):
            raise RuntimeError(f'consistency leg failed: {rcs}')
        phases = _read_json(out)['phases']
    except Exception as exc:  # noqa: BLE001 — the gate reports, not raises
        phases['error'] = {'ok': False, 'message': str(exc)}
    return _finish('consistency', CONS_SCHEMA, phases, {
        'total_steps': CONS_TOTAL_STEPS,
        'cadence': CONS_CADENCE,
        'inject_step': CONS_INJECT_STEP,
        'inv_update_steps': CONS_INV_UPDATE_STEPS,
        'target_replica': target,
        'flip_bit': CONS_FLIP_BIT,
        'rejoin_bound': CONS_REJOIN_BOUND,
        'world': world,
        'device': device,
    }, work, json_out)


def validate_consistency_artifact(path: str) -> int:
    """Gate of a consistency artifact: the shared checks, detection
    latency within the cadence, bitwise agreement after the repair (of
    the parameters too, where the artifact records them), the rejoin
    under the pinned bound and strictly under the unguarded contrast."""
    payload, errors = validate_drill_artifact(path, CONS_SCHEMA, (
        'injection', 'detection', 'repair_agreement', 'trajectory_rejoin',
    ))
    if payload is None:
        print(f'consistency artifact INVALID: {errors[0]}')
        return 1
    phases = payload.get('phases', {})
    latency = phases.get('detection', {}).get('latency_steps')
    if not isinstance(latency, int) or not 0 <= latency <= CONS_CADENCE:
        errors.append(f'detection latency {latency!r} not within the '
                      f'pinned cadence {CONS_CADENCE}')
    rep = phases.get('repair_agreement', {})
    if rep.get('divergent_after_repair'):
        errors.append('replicas still diverge after repair: '
                      f'{rep["divergent_after_repair"]}')
    if rep.get('param_divergence_after'):
        errors.append('parameters still diverge after repair: '
                      f'{rep["param_divergence_after"]}')
    tr = phases.get('trajectory_rejoin', {})
    err = tr.get('param_rel_err')
    ug = tr.get('unguarded_rel_err')
    if not isinstance(err, (int, float)):
        errors.append('trajectory_rejoin.param_rel_err missing')
    else:
        if not err <= CONS_REJOIN_BOUND:
            errors.append(f'rejoin error {err} exceeds the pinned bound '
                          f'{CONS_REJOIN_BOUND}')
        if tr.get('bound') != CONS_REJOIN_BOUND:
            errors.append(f'artifact bound {tr.get("bound")!r} != pinned '
                          f'{CONS_REJOIN_BOUND} (writer drifted)')
        if not isinstance(ug, (int, float)) or not err < ug:
            errors.append(f'repaired error {err} is not strictly below the '
                          f'unguarded contrast {ug!r}: the guard is vacuous '
                          'on this trajectory')
    if errors:
        for e in errors:
            print(f'consistency artifact INVALID: {e}')
        return 1
    print('consistency artifact valid')
    return 0


# ----------------------------------------------------------------------
# watchdog drill
# ----------------------------------------------------------------------


def _watchdog_run(dev, world, spec, xb, yb, save_dir, *, inject: bool,
                  drive: bool, watchdog: bool = True,
                  guards: bool = False) -> dict:
    """One trajectory of the watchdog drill on this rank."""
    from kfac_pytorch_tpu_torch import testing as ktest
    from kfac_pytorch_tpu_torch.consistency import ConsistencyConfig
    from kfac_pytorch_tpu_torch.health import HealthConfig
    from kfac_pytorch_tpu_torch.watchdog import WatchdogConfig

    wd = None
    if watchdog:
        wd = WatchdogConfig(
            window=int(spec['window']),
            check_every=int(spec['check_every']),
            save_dir=save_dir,
            save_every=(int(spec['save_every'])
                        if save_dir is not None else None),
            clearance=int(spec['clearance']),
        )
    model, precond = _engine(
        dev, world, 'COMM_OPT',
        inv_update_steps=int(spec['inv_update_steps']),
        kl_clip=None,
        watchdog=wd,
        health=HealthConfig() if guards else None,
        consistency=ConsistencyConfig(cadence=2) if guards else None,
    )
    inject_step = int(spec['inject_step'])
    total = int(spec['total_steps'])
    records, rollback, iterations = [], None, 0
    # The engine's counter rewinds on a rollback; the iteration ceiling
    # is the runaway brake.
    while precond.steps < total and iterations < 4 * total:
        iterations += 1
        if inject and precond.steps == inject_step:
            # Step-indexed: the replayed pass meets the same fault.
            base = sorted(precond.layers)[0]
            ktest.poison_factors(precond, base, sides='ag',
                                 scale=float(spec['poison_scale']))
        engine_step = precond.steps
        loss = _train_step(model, precond, xb, yb)
        if drive:
            rolled = precond.watchdog_step(
                loss, extras=lambda: _param_tensors(model))
            if rolled is not None:
                _load_params(model, rolled['extras'])
                gen_dir = os.path.join(save_dir, rolled['generation'])
                with np.load(os.path.join(gen_dir, 'extras.npz')) as npz:
                    on_disk = {k: npz[k] for k in npz.files}
                bitwise = set(on_disk) == set(rolled['extras']) and all(
                    np.array_equal(on_disk[k],
                                   np.asarray(rolled['extras'][k]))
                    for k in on_disk)
                rollback = {
                    'at_engine_step': engine_step + 1,
                    'target_step': rolled['target_step'],
                    'generation': rolled['generation'],
                    'health_stamp': rolled['health_stamp'],
                    'recomputed': rolled['recomputed'],
                    'bitwise_on_generation': bitwise,
                }
        info = precond.last_step_info or {}
        records.append({
            'engine_step': engine_step,
            'loss': _global_loss(loss, world),
            'detections_total': _info_int(info,
                                          'watchdog/detections_total'),
            'softens_total': _info_int(info, 'watchdog/softens_total'),
            'rollbacks_total': _info_int(info, 'watchdog/rollbacks_total'),
            'parks_total': _info_int(info, 'watchdog/parks_total'),
            'health_skipped': _info_int(info, 'health/steps_skipped'),
            'consistency_detections': _info_int(
                info, 'consistency/detections_total'),
        })
    return {
        'records': records,
        'params': _flat_params(model),
        'rollback': rollback,
        'final_loss': records[-1]['loss'] if records else None,
    }


def run_watchdog_child(spec_json: str) -> int:
    """One rank of the watchdog leg: the reference (driven, clean), the
    guarded victim (driven, poisoned), the unguarded contrast (poisoned,
    never driven) and the invisibility probe (health and the consistency
    guard on, poisoned); rank 0 writes the phases."""
    spec = json.loads(spec_json)
    rank, world, dev = _init_world(spec['device'])
    xb, yb = _local_batch(dev, rank, world)
    work = spec['work']
    kw = dict(xb=xb, yb=yb)
    reference = _watchdog_run(dev, world, spec, save_dir=os.path.join(
        work, 'ref_ckpt'), inject=False, drive=True, **kw)
    guarded = _watchdog_run(dev, world, spec, save_dir=os.path.join(
        work, 'victim_ckpt'), inject=True, drive=True, **kw)
    unguarded = _watchdog_run(dev, world, spec, save_dir=None, inject=True,
                              drive=False, **kw)
    probe = _watchdog_run(dev, world, spec, save_dir=None, inject=True,
                          drive=False, watchdog=False, guards=True, **kw)
    _finish_world(world)
    if rank != 0:
        return 0
    inject_step = int(spec['inject_step'])
    detect_step = next((r['engine_step'] for r in guarded['records']
                        if r['detections_total'] > 0), None)
    latency = None if detect_step is None else detect_step - inject_step
    detect_bound = int(spec['detect_bound'])
    rb = guarded['rollback']
    bitwise = rb is not None and rb['bitwise_on_generation']
    guarded_err = drill_rel_err(guarded['params'], reference['params'])
    unguarded_err = drill_rel_err(unguarded['params'], reference['params'])
    probe_err = drill_rel_err(probe['params'], reference['params'])
    rejoin_bound = float(spec['rejoin_bound'])
    probe_min_drift = float(spec['probe_min_drift'])
    health_skipped = max(r['health_skipped'] for r in probe['records'])
    cons_detections = max(r['consistency_detections']
                          for r in probe['records'])
    phases = {
        'injector_invisibility': {
            'ok': (health_skipped == 0 and cons_detections == 0
                   and probe_err > probe_min_drift),
            'health_steps_skipped': health_skipped,
            'consistency_detections': cons_detections,
            'probe_param_rel_err': probe_err,
            'probe_min_drift': probe_min_drift,
            'poison_scale': float(spec['poison_scale']),
        },
        'detection': {
            'ok': (max(r['detections_total']
                       for r in reference['records']) == 0
                   and latency is not None and 0 <= latency <= detect_bound),
            'reference_detections': max(r['detections_total']
                                        for r in reference['records']),
            'detect_step': detect_step,
            'inject_step': inject_step,
            'latency_steps': latency,
            'bound': detect_bound,
        },
        'rollback': {
            'ok': (rb is not None and bitwise
                   and rb['health_stamp'] == 'healthy'
                   and rb['target_step'] < inject_step
                   and rb['recomputed'] is False),
            'bitwise_on_generation': bitwise,
            'generation': None if rb is None else rb['generation'],
            'target_step': None if rb is None else rb['target_step'],
            'health_stamp': None if rb is None else rb['health_stamp'],
            'inject_step': inject_step,
            'rollbacks_total': max(r['rollbacks_total']
                                   for r in guarded['records']),
        },
        'trajectory_rejoin': {
            'ok': guarded_err <= rejoin_bound and guarded_err < unguarded_err,
            'param_rel_err': guarded_err,
            'bound': rejoin_bound,
            'unguarded_rel_err': unguarded_err,
            'reference_loss': reference['final_loss'],
            'guarded_loss': guarded['final_loss'],
            'unguarded_loss': unguarded['final_loss'],
        },
    }
    with open(spec['out'], 'w') as fh:
        json.dump({'phases': phases, 'records': guarded['records']}, fh,
                  indent=1, sort_keys=True)
    return 0


def run_watchdog_drill(json_out: str | None, device: str = 'cuda',
                       world: int = WD_WORLD) -> int:
    """Orchestrate the watchdog drill; see the module docstring."""
    work = tempfile.mkdtemp(prefix='watchdog_drill_')
    out = os.path.join(work, 'watchdog_leg.json')
    config = {
        'total_steps': WD_TOTAL_STEPS,
        'inv_update_steps': WD_INV_UPDATE_STEPS,
        'inject_step': WD_INJECT_STEP,
        'poison_scale': WD_POISON_SCALE,
        'window': WD_WINDOW,
        'check_every': WD_CHECK_EVERY,
        'save_every': WD_SAVE_EVERY,
        'clearance': WD_CLEARANCE,
        'detect_bound': WD_DETECT_BOUND,
        'rejoin_bound': WD_REJOIN_BOUND,
        'probe_min_drift': WD_PROBE_MIN_DRIFT,
    }
    phases: dict[str, dict] = {}
    try:
        rcs, _, _ = _run_world(
            'watchdog (finite curvature poison)', '--watchdog-child',
            dict(config, device=device, work=work, out=out), world)
        if any(rcs):
            raise RuntimeError(f'watchdog leg failed: {rcs}')
        phases = _read_json(out)['phases']
    except Exception as exc:  # noqa: BLE001 — the gate reports, not raises
        phases['error'] = {'ok': False, 'message': str(exc)}
    return _finish('watchdog', WD_SCHEMA, phases,
                   dict(config, world=world, device=device), work, json_out)


def validate_watchdog_artifact(path: str) -> int:
    """Gate of a watchdog artifact: injector invisibility non-vacuous,
    detection within the pinned window + cadence, a bitwise rollback onto
    a healthy generation from before the poison, the rejoin under the
    pinned bound and strictly under the unguarded contrast."""
    payload, errors = validate_drill_artifact(path, WD_SCHEMA, (
        'injector_invisibility', 'detection', 'rollback',
        'trajectory_rejoin',
    ))
    if payload is None:
        print(f'watchdog artifact INVALID: {errors[0]}')
        return 1
    phases = payload.get('phases', {})
    inv = phases.get('injector_invisibility', {})
    if inv.get('health_steps_skipped') != 0 or (
            inv.get('consistency_detections') != 0):
        errors.append('the finite injector tripped health/consistency: the '
                      'fault class is not watchdog-exclusive')
    drift = inv.get('probe_param_rel_err')
    if not isinstance(drift, (int, float)) or not drift > WD_PROBE_MIN_DRIFT:
        errors.append(f'probe drift {drift!r} does not exceed the pinned '
                      f'{WD_PROBE_MIN_DRIFT}: the injector is vacuous')
    det = phases.get('detection', {})
    latency = det.get('latency_steps')
    if not isinstance(latency, int) or not 0 <= latency <= WD_DETECT_BOUND:
        errors.append(f'detection latency {latency!r} not within the pinned '
                      f'window + cadence bound {WD_DETECT_BOUND}')
    if det.get('reference_detections') != 0:
        errors.append('the clean reference saw detections: the detectors '
                      'false-positive on healthy trajectories')
    rb = phases.get('rollback', {})
    if rb.get('bitwise_on_generation') is not True:
        errors.append('rollback did not land bitwise on a generation')
    if rb.get('health_stamp') != 'healthy':
        errors.append(f'rollback landed on a {rb.get("health_stamp")!r} '
                      'generation: only cleared generations are legal')
    ts, isp = rb.get('target_step'), rb.get('inject_step')
    if not (isinstance(ts, int) and isinstance(isp, int) and ts < isp):
        errors.append(f'rollback target {ts!r} is not strictly before the '
                      f'poisoned span start {isp!r}')
    tr = phases.get('trajectory_rejoin', {})
    err = tr.get('param_rel_err')
    ug = tr.get('unguarded_rel_err')
    if not isinstance(err, (int, float)):
        errors.append('trajectory_rejoin.param_rel_err missing')
    else:
        if not err <= WD_REJOIN_BOUND:
            errors.append(f'rejoin error {err} exceeds the pinned bound '
                          f'{WD_REJOIN_BOUND}')
        if tr.get('bound') != WD_REJOIN_BOUND:
            errors.append(f'artifact bound {tr.get("bound")!r} != pinned '
                          f'{WD_REJOIN_BOUND} (writer drifted)')
        if not isinstance(ug, (int, float)) or not err < ug:
            errors.append(f'guarded error {err} is not strictly below the '
                          f'unguarded contrast {ug!r}: the watchdog is '
                          'vacuous on this trajectory')
    if errors:
        for e in errors:
            print(f'watchdog artifact INVALID: {e}')
        return 1
    print('watchdog artifact valid')
    return 0


# ----------------------------------------------------------------------
# postmortem drill
# ----------------------------------------------------------------------


def rank_box_path(path: str, world: int) -> str:
    """Where rank 0's flight recorder writes ``path`` in a world of
    ``world`` ranks (``postmortem.p0.json`` across several)."""
    if world <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f'{root}.p0{ext}'


def run_postmortem_child(spec_json: str) -> int:
    """One rank of a postmortem leg (``mode``): ``reference`` (a window
    over the whole run, a flush every step, then the flight-off contrast
    in the same process), ``victim`` (rank 0 SIGKILLs itself at the top
    of ``kill_step``; its last periodic snapshot is the recovered box)
    or ``trigger`` (a NaN in rank 0's batch at ``nan_step``)."""
    from kfac_pytorch_tpu_torch import testing as ktest
    from kfac_pytorch_tpu_torch.health import HealthConfig
    from kfac_pytorch_tpu_torch.observe import ObserveConfig
    from kfac_pytorch_tpu_torch.observe.flight import FlightConfig
    from kfac_pytorch_tpu_torch.watchdog import WatchdogConfig

    spec = json.loads(spec_json)
    rank, world, dev = _init_world(spec['device'])
    mode = spec['mode']
    total = int(spec['total_steps'])
    xb, yb = _local_batch(dev, rank, world)
    x_nan = ktest.nan_batch(xb) if rank == 0 else xb

    def run(flight_cfg):
        model, precond = _engine(
            dev, world, 'COMM_OPT',
            inv_update_steps=int(spec['inv_update_steps']),
            health=HealthConfig(), observe=ObserveConfig(),
            watchdog=WatchdogConfig(window=4, check_every=2),
            flight=flight_cfg,
        )
        for step in range(total):
            if mode == 'victim' and step == spec.get('kill_step') \
                    and rank == 0:
                # The preemption: no handler runs.
                os.kill(os.getpid(), signal.SIGKILL)
            batch = (x_nan if mode == 'trigger'
                     and step == spec.get('nan_step') else xb)
            loss = _train_step(model, precond, batch, yb)
            precond.watchdog_step(loss)
            precond.flight_step(loss)
        return precond, _flat_params(model)

    if mode == 'reference':
        cfg = FlightConfig(path=spec['pm_path'], window=total + 2,
                           flush_every=1)
    else:
        cfg = FlightConfig(path=spec['pm_path'], window=int(spec['window']),
                           flush_every=int(spec['flush_every']))
    precond_on, flat_on = run(cfg)
    out = {'mode': mode, 'final_step': total}
    if mode == 'reference':
        # The recorder is a pure reader: the same run with it off is the
        # same trajectory bit for bit.
        precond_on.flight.disarm()
        _, flat_off = run(None)
        out['flight_off'] = {
            'bitwise': set(flat_on) == set(flat_off) and all(
                np.array_equal(flat_on[k], flat_off[k]) for k in flat_on),
            'cache_key_identity': 'not applicable: eager torch compiles no '
                                  'step programs to key',
        }
        precond_on.flight.arm()
    _finish_world(world)
    if rank == 0:
        with open(spec['out'], 'w') as fh:
            json.dump(out, fh, indent=1, sort_keys=True)
    return 0


def run_postmortem_judge(spec_json: str) -> int:
    """Schema-validate and series-join the recovered boxes (an entry
    point of its own, as in JAX; the orchestrator calls it in
    process)."""
    from kfac_pytorch_tpu_torch.observe.flight import read_postmortem
    from kfac_pytorch_tpu_torch.observe.flight import validate_postmortem

    spec = json.loads(spec_json)
    ref = read_postmortem(spec['reference'])
    victim = read_postmortem(spec['victim'])
    trig = read_postmortem(spec['trigger'])
    phases: dict[str, dict] = {}
    kill_step = int(spec['kill_step'])
    flush_every = int(spec['flush_every'])
    nan_step = int(spec['nan_step'])

    ref_problems = validate_postmortem(ref, min_subsystems=PM_MIN_SUBSYSTEMS,
                                       expect_trigger='atexit')
    ref_steps = {r['step']: r for r in ref['steps']}
    phases['reference_box'] = {
        'ok': not ref_problems and len(ref_steps) >= int(spec['total_steps']),
        'problems': ref_problems,
        'steps_covered': len(ref_steps),
    }
    vic_problems = validate_postmortem(
        victim, min_subsystems=PM_MIN_SUBSYSTEMS, expect_trigger='periodic')
    vic_last = victim['steps'][-1]['step'] if victim['steps'] else None
    fresh = (vic_last is not None
             and kill_step - flush_every <= vic_last <= kill_step)
    phases['recovered_schema'] = {
        'ok': not vic_problems and fresh,
        'problems': vic_problems,
        'last_step': vic_last,
        'kill_step': kill_step,
        'staleness_bound': flush_every,
    }
    overlap = 0
    mismatches = []
    prefixes_compared: set[str] = set()
    for rec in victim['steps']:
        ref_rec = ref_steps.get(rec['step'])
        if ref_rec is None:
            continue
        overlap += 1
        for key, value in rec.items():
            if key == 'time':
                continue
            for prefix in ('observe/', 'health/', 'consistency/',
                           'watchdog/'):
                if key.startswith(prefix):
                    prefixes_compared.add(prefix)
            if key not in ref_rec or ref_rec[key] != value:
                mismatches.append({'step': rec['step'], 'key': key,
                                   'victim': value,
                                   'reference': ref_rec.get(key)})
    phases['bitwise_series'] = {
        'ok': (not mismatches and overlap >= PM_MIN_OVERLAP_STEPS
               and len(prefixes_compared) >= PM_MIN_SUBSYSTEMS),
        'overlap_steps': overlap,
        'subsystems_compared': sorted(prefixes_compared),
        'mismatches': mismatches[:10],
        'mismatch_count': len(mismatches),
    }
    trig_problems = validate_postmortem(trig,
                                        min_subsystems=PM_MIN_SUBSYSTEMS)
    latched = [t for t in trig.get('triggers', [])
               if t.get('name') == 'health_step_skip']
    skips = [r.get('health/steps_skipped', 0.0) for r in trig['steps']]
    phases['trigger_hook'] = {
        'ok': bool(not trig_problems and latched
                   and latched[0].get('step', -1) >= nan_step
                   and skips and max(skips) >= 1.0),
        'problems': trig_problems,
        'latched': latched,
        'nan_step': nan_step,
        'max_steps_skipped': max(skips) if skips else None,
    }
    with open(spec['out'], 'w') as fh:
        json.dump({'phases': phases}, fh, indent=1, sort_keys=True)
    return 0


def run_postmortem_drill(json_out: str | None, device: str = 'cuda',
                         world: int = PM_WORLD) -> int:
    """Orchestrate the postmortem drill; see the module docstring."""
    work = tempfile.mkdtemp(prefix='postmortem_drill_')
    phases: dict[str, dict] = {}
    pm_paths = {name: os.path.join(work, f'postmortem_{name}.json')
                for name in ('reference', 'victim', 'trigger')}
    boxes = {name: rank_box_path(p, world) for name, p in pm_paths.items()}
    try:
        base = {
            'device': device,
            'total_steps': PM_TOTAL_STEPS,
            'inv_update_steps': PM_INV_UPDATE_STEPS,
            'window': PM_WINDOW,
            'flush_every': PM_FLUSH_EVERY,
        }
        rcs, _, _ = _run_world('postmortem reference', '--postmortem-child', {
            **base, 'mode': 'reference', 'pm_path': pm_paths['reference'],
            'out': os.path.join(work, 'ref_leg.json'),
        }, world)
        if any(rcs):
            raise RuntimeError(f'reference leg failed: {rcs}')
        ref_out = _read_json(os.path.join(work, 'ref_leg.json'))
        phases['flight_off_identity'] = {
            'ok': bool(ref_out['flight_off']['bitwise']),
            **ref_out['flight_off'],
        }
        rcs, _, _ = _run_world('postmortem victim (SIGKILL)',
                               '--postmortem-child', {
                                   **base, 'mode': 'victim',
                                   'kill_step': PM_KILL_STEP,
                                   'pm_path': pm_paths['victim'],
                                   'out': os.path.join(work,
                                                       'victim_leg.json'),
                               }, world)
        phases['sigkill'] = {
            'ok': rcs[0] == -signal.SIGKILL and os.path.isfile(
                boxes['victim']),
            'returncode': rcs[0],
            'returncodes': rcs,
            'black_box_on_disk': os.path.isfile(boxes['victim']),
        }
        rcs, _, _ = _run_world('postmortem trigger (NaN batch)',
                               '--postmortem-child', {
                                   **base, 'mode': 'trigger',
                                   'nan_step': PM_NAN_STEP,
                                   'pm_path': pm_paths['trigger'],
                                   'out': os.path.join(work,
                                                       'trigger_leg.json'),
                               }, world)
        if any(rcs):
            raise RuntimeError(f'trigger leg failed: {rcs}')
        judge_out = os.path.join(work, 'judge.json')
        run_postmortem_judge(json.dumps({
            'reference': boxes['reference'],
            'victim': boxes['victim'],
            'trigger': boxes['trigger'],
            'kill_step': PM_KILL_STEP,
            'flush_every': PM_FLUSH_EVERY,
            'nan_step': PM_NAN_STEP,
            'total_steps': PM_TOTAL_STEPS,
            'out': judge_out,
        }))
        phases.update(_read_json(judge_out)['phases'])
    except Exception as exc:  # noqa: BLE001 — the gate reports, not raises
        phases['error'] = {'ok': False, 'message': str(exc)}
    embedded = {}
    for name, path in boxes.items():
        try:
            embedded[name] = _read_json(path)
        except (OSError, ValueError):
            embedded[name] = None
    return _finish('postmortem', PM_SCHEMA, phases, {
        'total_steps': PM_TOTAL_STEPS,
        'inv_update_steps': PM_INV_UPDATE_STEPS,
        'window': PM_WINDOW,
        'flush_every': PM_FLUSH_EVERY,
        'kill_step': PM_KILL_STEP,
        'nan_step': PM_NAN_STEP,
        'min_overlap_steps': PM_MIN_OVERLAP_STEPS,
        'min_subsystems': PM_MIN_SUBSYSTEMS,
        'world': world,
        'device': device,
    }, work, json_out, extra={'postmortems': embedded})


def validate_postmortem_artifact(path: str) -> int:
    """Gate of a postmortem artifact: the shared checks, then the pinned
    claims re-derived from the embedded boxes (freshness within the
    flush cadence, the bitwise join over the pinned overlap and
    subsystem count, the periodic trigger, the latched health skip)."""
    payload, errors = validate_drill_artifact(path, PM_SCHEMA, (
        'flight_off_identity', 'sigkill', 'recovered_schema',
        'bitwise_series', 'trigger_hook',
    ))
    if payload is None:
        print(f'postmortem artifact INVALID: {errors[0]}')
        return 1
    boxes = payload.get('postmortems') or {}
    ref, victim, trig = (boxes.get('reference'), boxes.get('victim'),
                         boxes.get('trigger'))
    if not all(isinstance(b, dict) for b in (ref, victim, trig)):
        errors.append('embedded postmortems missing')
    else:
        for name, box in (('reference', ref), ('victim', victim),
                          ('trigger', trig)):
            if box.get('schema') != 'kfac-postmortem-v1':
                errors.append(f'{name} box schema {box.get("schema")!r}')
            if not box.get('steps'):
                errors.append(f'{name} box has no step series')
        if victim.get('steps') and ref.get('steps'):
            ref_steps = {r['step']: r for r in ref['steps']}
            overlap = 0
            prefixes: set[str] = set()
            mismatch = None
            for rec in victim['steps']:
                ref_rec = ref_steps.get(rec['step'])
                if ref_rec is None:
                    continue
                overlap += 1
                for key, value in rec.items():
                    if key == 'time':
                        continue
                    for p in ('observe/', 'health/', 'consistency/',
                              'watchdog/'):
                        if key.startswith(p):
                            prefixes.add(p)
                    if ref_rec.get(key) != value and mismatch is None:
                        mismatch = f'step {rec["step"]} key {key}'
            if mismatch is not None:
                errors.append('recovered series diverges from reference: '
                              f'{mismatch}')
            if overlap < PM_MIN_OVERLAP_STEPS:
                errors.append(f'only {overlap} overlapping steps < pinned '
                              f'{PM_MIN_OVERLAP_STEPS} (vacuous join)')
            if len(prefixes) < PM_MIN_SUBSYSTEMS:
                errors.append(f'only {len(prefixes)} subsystem series '
                              f'compared < pinned {PM_MIN_SUBSYSTEMS} '
                              '(vacuous box)')
            last = victim['steps'][-1]['step']
            if not PM_KILL_STEP - PM_FLUSH_EVERY <= last <= PM_KILL_STEP:
                errors.append(
                    f'recovered box last step {last} staler than the '
                    f'pinned flush cadence {PM_FLUSH_EVERY} before kill '
                    f'step {PM_KILL_STEP}')
            if (victim.get('trigger') or {}).get('name') != 'periodic':
                errors.append('recovered box trigger is not the periodic '
                              'snapshot (SIGKILL runs no handlers)')
        if trig.get('steps'):
            names = [t.get('name') for t in trig.get('triggers', [])]
            if 'health_step_skip' not in names:
                errors.append("trigger box history never latched "
                              "'health_step_skip'")
    if errors:
        for e in errors:
            print(f'postmortem artifact INVALID: {e}')
        return 1
    print('postmortem artifact valid')
    return 0


# ----------------------------------------------------------------------
# multi-process drill
# ----------------------------------------------------------------------


def run_multiproc_child(spec_json: str) -> int:
    """One rank of a multiproc leg (``role``): ``init_probe`` (a rank
    pointed at a dead coordinator must raise ``RuntimeInitError`` within
    the deadline), ``rank_guard`` (run the seeded rank-guarded barrier,
    or its contrast, and record whether this rank wedged),
    ``consistency`` (the consistency trajectory across processes) or the
    default ``train`` (the elastic drill's trajectory under the runtime,
    streaming saves, rank ``MP_KILL_RANK`` SIGKILLed entering the save
    at ``kill_save_step``, the flight recorder dumped by the peer-death
    hook)."""
    from kfac_pytorch_tpu_torch import runtime as rtlib

    spec = json.loads(spec_json)
    rank = int(spec.get('rank', os.environ.get('KFAC_RANK', '0')))
    nprocs = int(spec.get('nprocs', os.environ.get('KFAC_NPROCS', '1')))
    coord = spec.get('coordinator', os.environ.get('KFAC_COORD', ''))

    if spec.get('role') == 'init_probe':
        cfg = rtlib.RuntimeConfig(
            coordinator=coord, num_processes=nprocs, process_id=rank,
            init_deadline_s=float(spec['init_deadline_s']))
        t0 = time.monotonic()
        try:
            rtlib.initialize_distributed(cfg)
        except rtlib.RuntimeInitError as exc:
            with open(spec['out'], 'w') as fh:
                json.dump({'elapsed_s': time.monotonic() - t0,
                           'error': type(exc).__name__,
                           'message': str(exc)}, fh, indent=1)
            return 0
        print('initialize_distributed unexpectedly succeeded')
        return 1

    dev, _ = _device(spec['device'], rank, nprocs)
    rt = None
    init_attempts = None
    if nprocs > 1:
        rt = rtlib.DistributedRuntime(rtlib.RuntimeConfig(
            coordinator=coord, num_processes=nprocs, process_id=rank,
            barrier_timeout_s=MP_BARRIER_TIMEOUT_S,
            heartbeat_dir=spec.get('heartbeat_dir'),
            heartbeat_interval_s=MP_HEARTBEAT_INTERVAL_S,
            heartbeat_grace_s=MP_HEARTBEAT_GRACE_S,
        ))
        init_attempts = rt.initialize()
        rtlib.install(rt)
        _destroy_at_exit()

    if spec.get('role') == 'rank_guard':
        timeout_s = float(spec['timeout_s'])
        fn = (_defined(SEEDED_RANK_GUARD_SOURCE, 'seeded_rank_guarded_barrier')
              if spec.get('guarded') else
              _defined(UNGUARDED_BARRIER_SOURCE, 'unguarded_barrier'))
        result: dict[str, Any] = {'rank': rank, 'wedged': False,
                                  'error': None}
        t0 = time.monotonic()
        try:
            fn(rt, timeout_s=timeout_s)
        except rtlib.BarrierTimeoutError as exc:
            result['wedged'] = True
            result['error'] = type(exc).__name__
        result['elapsed_s'] = time.monotonic() - t0
        if spec.get('guarded') and rank != 0:
            # A deadlocked peer is busy elsewhere, not dead: stay alive
            # past the skipped barrier.
            time.sleep(timeout_s + 2.0)
        with open(f'{spec["out"]}.r{rank}.json', 'w') as fh:
            json.dump(result, fh, indent=1)
        return 0

    world = nprocs
    if rt is not None:
        # A named barrier before any collective: every rank is up.
        rt.barrier('drill/start')
    xb, yb = _local_batch(dev, rank, world)

    if spec.get('role') == 'consistency':
        return _multiproc_consistency(spec, rank, world, dev, xb, yb, rt)

    from kfac_pytorch_tpu_torch import elastic
    from kfac_pytorch_tpu_torch import testing as ktest
    from kfac_pytorch_tpu_torch.observe import ObserveConfig
    from kfac_pytorch_tpu_torch.observe.flight import FlightConfig

    flight_cfg = None
    if spec.get('flight_path'):
        flight_cfg = FlightConfig(path=spec['flight_path'],
                                  window=MP_FLIGHT_WINDOW,
                                  flush_every=MP_FLIGHT_FLUSH_EVERY)
    model, precond = _engine(
        dev, world, 'MEM_OPT', inv_update_steps=INV_UPDATE_STEPS,
        observe=ObserveConfig() if flight_cfg is not None else None,
        flight=flight_cfg,
    )
    if rt is not None and flight_cfg is not None:
        # The black box survives the abort: the peer-death hook dumps it
        # (trigger 'rank_death') before the runtime exits.
        rt.on_peer_death(lambda dead: precond.flight is not None
                         and precond.flight.dump('rank_death'))
    start, restore_info = 0, None
    if spec.get('resume'):
        info = elastic.restore_streaming(spec['save_dir'], precond)
        extras = info.pop('extras')
        if extras is None:
            raise RuntimeError('resume generation carries no params')
        _load_params(model, extras)
        start = precond.steps
        restore_info = info

    kill_save_step = spec.get('kill_save_step')
    losses = []
    try:  # spmd: collective-safe(the handler waits for the runtime's exit and re-raises: nothing re-enters a collective)
        for step in range(start, int(spec['total_steps'])):
            loss = _train_step(model, precond, xb, yb)
            losses.append(_global_loss(loss, world))
            precond.flight_step(loss)
            done = step + 1
            if spec.get('save_every') and done % int(spec['save_every']) == 0:
                if done == kill_save_step and rank == MP_KILL_RANK:
                    # The rank death: SIGKILL at the collective save's
                    # entry, leaving the survivor in its gathers.
                    ktest.kill_rank(os.getpid())
                    os._exit(1)  # unreachable
                elastic.save_streaming(spec['save_dir'], precond,
                                       extras=_param_tensors(model))
    except RuntimeError:
        if rt is None:
            raise
        # gloo may raise "connection closed by peer" from a collective
        # whose peer died, before the heartbeat lapses: wait for the
        # runtime's monitor, which records the death and exits 87.
        time.sleep(MP_HEARTBEAT_GRACE_S + 10 * MP_HEARTBEAT_INTERVAL_S + 5.0)
        raise

    with open(f"{spec['out']}.r{rank}.json", 'w') as fh:
        json.dump({
            'rank': rank,
            'nprocs': nprocs,
            'world': world,
            'init_attempts': init_attempts,
            'start_step': start,
            'final_step': int(spec['total_steps']),
            'losses': losses,
            'restore_info': restore_info,
        }, fh, indent=1)
    if rank == 0:
        with open(spec['out'] + '.npz', 'wb') as fh:
            np.savez(fh, **_flat_params(model))
    if rt is not None:
        rt.barrier('drill/end')
        rt.shutdown()
    return 0


def _multiproc_consistency(spec, rank, world, dev, xb, yb, rt) -> int:
    """The consistency trajectory across a process boundary: the
    corruption lands on rank ``target_replica``'s copy only, and both
    ranks must see the same verdicts, repair once and agree again."""
    import hashlib

    out = _consistency_run(dev, rank, world, spec, guard=True, inject=True,
                           xb=xb, yb=yb)
    digest = hashlib.sha256()
    for k in sorted(out['params']):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(out['params'][k]).tobytes())
    with open(f"{spec['out']}.r{rank}.json", 'w') as fh:
        json.dump({
            'rank': rank,
            'records': [{k: r[k] for k in ('step', 'loss', 'checked',
                                           'detections_total',
                                           'repairs_total')}
                        for r in out['records']],
            'pre_divergence': sorted(out['own_pre_divergence']),
            'post_divergence': sorted(out['post_divergence']),
            'param_sha256': digest.hexdigest(),
        }, fh, indent=1)
    if rt is not None:
        rt.barrier('drill/end')
        rt.shutdown()
    return 0


def _gen_surfaces(gen_dir: str) -> dict:
    """Every saved array of a committed generation, keyed so two
    layouts compare: ``layers.npz`` and ``extras.npz`` by name, each
    bucket field per layer, through the saved layout signature
    (``<layer>::<field>``, the layer's slot of the stack)."""
    from kfac_pytorch_tpu_torch.parallel.bucketing import signature_slot_map

    meta = _read_json(os.path.join(gen_dir, 'meta.json'))
    sig = (meta.get('topology') or {}).get('signature') or {'buckets': []}
    slot_of = signature_slot_map(sig)
    n_slots = {b['key']: len(b['slots']) for b in sig['buckets']}
    out = {}
    for fn in sorted(os.listdir(gen_dir)):
        if not fn.endswith('.npz'):
            continue
        with np.load(os.path.join(gen_dir, fn)) as z:
            arrays = {k: z[k] for k in z.files}
        if fn.startswith('bucket-'):
            key = fn[len('bucket-'):-len('.npz')]
            for layer, (bkey, slot) in slot_of.items():
                if bkey != key:
                    continue
                for field, arr in arrays.items():
                    if arr.ndim and arr.shape[0] == n_slots[key]:
                        out[f'{layer}::{field}'] = arr[slot]
        else:
            out.update({f'{fn}::{k}': v for k, v in arrays.items()})
    return out


def _compare_surfaces(a: dict, b: dict):
    """``(keys_match, bitwise, max_rel_err)`` over every array."""
    if set(a) != set(b):
        return False, False, float('inf')
    bitwise, worst = True, 0.0
    for k in a:
        va, vb = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if not np.array_equal(a[k], b[k]):
            bitwise = False
        ratio = float(np.linalg.norm(va - vb)) / (
            float(np.linalg.norm(vb)) + 1e-12)
        if not np.isfinite(ratio):
            return True, False, float('inf')
        worst = max(worst, ratio)
    return True, bitwise, worst


def _is_eigenbasis(key: str) -> bool:
    return key.endswith('::qa') or key.endswith('::qg')


def eigen_action_check(a: dict, b: dict):
    """``(action_rel_err, orthonormality_err, raw_basis_rel_err)`` of
    the per-layer eigenbases: eigenvectors rotate inside near-degenerate
    clusters under last-bit differences, so the pinned invariant is the
    operator ``qg ((qg^T P qa) * dgda) qa^T`` on a fixed probe ``P``,
    plus each basis's orthonormality; the raw difference is recorded."""
    action_err = ortho_err = raw_err = 0.0
    layers = sorted(k.rsplit('::', 1)[0] for k in a if k.endswith('::dgda'))
    for layer in layers:
        stacks = {side: {name: np.asarray(arrays[f'{layer}::{name}'],
                                          np.float64)
                         for name in ('qa', 'qg', 'dgda')}
                  for side, arrays in (('a', a), ('b', b))}
        for name in ('qa', 'qg'):
            for side in ('a', 'b'):
                q = stacks[side][name]
                ortho_err = max(ortho_err, float(
                    np.abs(q.T @ q - np.eye(q.shape[-1])).max()))
            diff = np.linalg.norm(stacks['a'][name] - stacks['b'][name])
            raw_err = max(raw_err, float(
                diff / (np.linalg.norm(stacks['b'][name]) + 1e-12)))
        probe = np.random.RandomState(0).standard_normal(
            stacks['a']['dgda'].shape)

        def action(s):
            v1 = s['qg'].T @ probe @ s['qa']
            return s['qg'] @ (v1 * s['dgda']) @ s['qa'].T

        pa, pb = action(stacks['a']), action(stacks['b'])
        action_err = max(action_err, float(
            np.linalg.norm(pa - pb) / (np.linalg.norm(pb) + 1e-12)))
    return action_err, ortho_err, raw_err


def run_multiproc_drill(json_out: str | None, device: str = 'cuda',
                        nprocs: int = MP_NPROCS) -> int:
    """The multi-process drill; see the module docstring."""
    from kfac_pytorch_tpu_torch import runtime as rtlib
    from kfac_pytorch_tpu_torch import testing as ktest
    from kfac_pytorch_tpu_torch.analysis import collective as spmdlint
    from kfac_pytorch_tpu_torch.observe.flight import validate_postmortem

    assert rtlib.EXIT_RANK_DEATH == MP_EXIT_RANK_DEATH
    work = tempfile.mkdtemp(prefix='multiproc_drill_')
    phases: dict[str, dict] = {}
    last_gen = f'gen-{MP_KILL_SAVE_STEP - MP_SAVE_EVERY:08d}'

    def world(name, spec, n, **kw):
        return _run_world(name, '--multiproc-child',
                          dict(spec, device=device), n, **kw)

    try:
        # Bounded init against a coordinator nobody listens on.
        probe_out = os.path.join(work, 'init_probe.json')
        t0 = time.monotonic()
        rcs, _, _ = world('init_bounded (dead coordinator)', {
            'role': 'init_probe', 'rank': 1, 'nprocs': nprocs,
            'coordinator': f'127.0.0.1:{ktest.free_port()}',
            'init_deadline_s': MP_INIT_DEADLINE_S, 'out': probe_out,
        }, 1)
        wall = time.monotonic() - t0
        probe = _read_json(probe_out) if os.path.isfile(probe_out) else {}
        phases['init_bounded'] = {
            'ok': (rcs == [0] and probe.get('error') == 'RuntimeInitError'
                   and probe.get('elapsed_s', float('inf'))
                   <= MP_INIT_DEADLINE_S + 2.0
                   and wall <= MP_INIT_WALL_CAP_S),
            'returncodes': rcs,
            'error': probe.get('error'),
            'elapsed_s': probe.get('elapsed_s'),
            'deadline_s': MP_INIT_DEADLINE_S,
            'wall_s': wall,
            'wall_cap_s': MP_INIT_WALL_CAP_S,
        }

        # The reference: one process.
        ref_dir = os.path.join(work, 'ref1')
        rcs, _, _ = world('reference (world 1)', {
            'total_steps': MP_TOTAL_STEPS, 'save_every': MP_SAVE_EVERY,
            'save_dir': ref_dir, 'out': os.path.join(work, 'ref1leg'),
        }, 1)
        if rcs != [0]:
            raise RuntimeError(f'reference leg failed: {rcs}')
        ref_final = _gen_surfaces(os.path.join(
            ref_dir, f'gen-{MP_TOTAL_STEPS:08d}'))

        # The multi-process world, twice.
        mp_meta, mp_final = {}, {}
        for tag in ('a', 'b'):
            d = os.path.join(work, f'mp_{tag}')
            rcs, _, _ = world(f'multiproc-{tag} (world {nprocs})', {
                'total_steps': MP_TOTAL_STEPS, 'save_every': MP_SAVE_EVERY,
                'save_dir': d,
                'heartbeat_dir': os.path.join(work, f'hb_{tag}'),
                'out': os.path.join(work, f'mp_{tag}_leg'),
            }, nprocs)
            if any(rcs):
                raise RuntimeError(f'multiproc leg {tag} failed: {rcs}')
            mp_meta[tag] = _read_json(os.path.join(work,
                                                   f'mp_{tag}_leg.r0.json'))
            mp_final[tag] = _gen_surfaces(os.path.join(
                d, f'gen-{MP_TOTAL_STEPS:08d}'))

        keys_ok = set(mp_final['a']) == set(ref_final)
        direct = [k for k in mp_final['a'] if not _is_eigenbasis(k)]
        _, bitwise, direct_rel = (_compare_surfaces(
            {k: mp_final['a'][k] for k in direct},
            {k: ref_final[k] for k in direct},
        ) if keys_ok else (False, False, float('inf')))
        action_rel, ortho_err, basis_rel = (
            eigen_action_check(mp_final['a'], ref_final)
            if keys_ok else (float('inf'),) * 3)
        phases['parity'] = {
            'ok': (keys_ok and direct_rel <= MP_PARITY_REL_ERR_BOUND
                   and action_rel <= MP_PARITY_REL_ERR_BOUND
                   and ortho_err <= MP_PARITY_REL_ERR_BOUND),
            'surfaces_match': keys_ok,
            'surface_count': len(mp_final['a']),
            'bitwise_equal': bitwise,
            'direct_rel_err': direct_rel,
            'action_rel_err': action_rel,
            'orthonormality_err': ortho_err,
            'eigenbasis_rel_err': basis_rel,
            'bound': MP_PARITY_REL_ERR_BOUND,
            'init_attempts': mp_meta['a'].get('init_attempts'),
        }
        keys_ok, bitwise, rel = _compare_surfaces(mp_final['a'],
                                                  mp_final['b'])
        losses_equal = mp_meta['a']['losses'] == mp_meta['b']['losses']
        phases['mp_determinism'] = {
            'ok': keys_ok and bitwise and losses_equal,
            'surfaces_match': keys_ok,
            'bitwise_equal': bitwise,
            'max_rel_err': rel,
            'losses_equal': losses_equal,
        }

        # Rank death entering a save.
        death_dir = os.path.join(work, 'death')
        hb_dir = os.path.join(work, 'hb_death')
        flight_path = os.path.join(work, 'flight', 'postmortem.json')
        os.makedirs(os.path.dirname(flight_path), exist_ok=True)
        rcs, _, exit_at = world('rank_death (SIGKILL entering a save)', {
            'total_steps': MP_TOTAL_STEPS, 'save_every': MP_SAVE_EVERY,
            'save_dir': death_dir, 'kill_save_step': MP_KILL_SAVE_STEP,
            'heartbeat_dir': hb_dir, 'flight_path': flight_path,
            'out': os.path.join(work, 'death_leg'),
        }, nprocs, grace_s=MP_BARRIER_TIMEOUT_S + 10.0)
        detect_latency = (exit_at[0] - exit_at[MP_KILL_RANK]
                          if 0 in exit_at and MP_KILL_RANK in exit_at
                          else None)
        record_path = os.path.join(hb_dir, 'rank_death.json')
        death_record = (_read_json(record_path)
                        if os.path.isfile(record_path) else None)
        committed = sorted(
            name for name in os.listdir(death_dir)
            if name.startswith('gen-') and os.path.isfile(
                os.path.join(death_dir, name, 'MANIFEST.json'))
        ) if os.path.isdir(death_dir) else []
        fl_path = rank_box_path(flight_path, nprocs)
        flight_payload = (_read_json(fl_path) if os.path.isfile(fl_path)
                          else None)
        flight_problems = (
            validate_postmortem(flight_payload, min_subsystems=1,
                                expect_trigger='rank_death')
            if flight_payload is not None else ['no flight dump recovered'])
        want_rcs = [MP_EXIT_RANK_DEATH] * nprocs
        want_rcs[MP_KILL_RANK] = -signal.SIGKILL
        phases['rank_death'] = {
            'ok': (rcs == want_rcs
                   and detect_latency is not None
                   and 0.0 <= detect_latency <= MP_DETECT_BOUND_S
                   and detect_latency < MP_BARRIER_TIMEOUT_S
                   and death_record is not None
                   and death_record.get('schema') == 'kfac-rank-death'
                   and death_record.get('dead_ranks') == [MP_KILL_RANK]
                   and committed != [] and committed[-1] == last_gen
                   and not flight_problems),
            'returncodes': rcs,
            'detect_latency_s': detect_latency,
            'detect_bound_s': MP_DETECT_BOUND_S,
            'barrier_timeout_s': MP_BARRIER_TIMEOUT_S,
            'death_record': death_record,
            'committed_generations': committed,
            'flight_trigger': ((flight_payload or {}).get('trigger')
                               or {}).get('name'),
            'flight_problems': flight_problems,
        }

        # The survivors' restore on one process: a real resize.
        rcs, _, _ = world('resize_restore (world 1)', {
            'total_steps': MP_TOTAL_STEPS, 'save_every': MP_SAVE_EVERY,
            'save_dir': death_dir, 'resume': True,
            'out': os.path.join(work, 'resize_leg'),
        }, 1)
        if rcs != [0]:
            raise RuntimeError(f'resize_restore leg failed: {rcs}')
        rz_meta = _read_json(os.path.join(work, 'resize_leg.r0.json'))
        rinfo = rz_meta['restore_info']
        with np.load(os.path.join(work, 'resize_leg.npz')) as z:
            rz_params = {k: z[k] for k in z.files}
        with np.load(os.path.join(work, 'ref1leg.npz')) as z:
            ref_params = {k: z[k] for k in z.files}
        rel = drill_rel_err(rz_params, ref_params)
        phases['resize_restore'] = {
            'ok': (rinfo['generation'] == last_gen and rinfo['resized']
                   and not rinfo['recomputed']
                   and rinfo['decompositions_installed']
                   and rz_meta['start_step']
                   == MP_KILL_SAVE_STEP - MP_SAVE_EVERY
                   and rel <= RESIZE_REL_ERR_BOUND),
            'restored_generation': rinfo['generation'],
            'resized': rinfo['resized'],
            'recomputed': rinfo['recomputed'],
            'start_step': rz_meta['start_step'],
            'param_rel_err': rel,
            'bound': RESIZE_REL_ERR_BOUND,
        }

        # The consistency guard across the process boundary.
        cons_out = os.path.join(work, 'cons_leg')
        rcs, _, _ = world(f'consistency_mp (world {nprocs})', {
            'role': 'consistency',
            'total_steps': CONS_TOTAL_STEPS, 'cadence': CONS_CADENCE,
            'inject_step': CONS_INJECT_STEP,
            'inv_update_steps': CONS_INV_UPDATE_STEPS,
            'flip_bit': CONS_FLIP_BIT, 'target_replica': nprocs - 1,
            'heartbeat_dir': os.path.join(work, 'hb_cons'),
            'out': cons_out,
        }, nprocs)
        if any(rcs):
            raise RuntimeError(f'consistency_mp leg failed: {rcs}')
        ranks = [_read_json(f'{cons_out}.r{r}.json') for r in range(nprocs)]
        r0, owner = ranks[0], ranks[-1]
        detect_step = next((r['step'] for r in r0['records']
                            if r['detections_total'] > 0), None)
        latency = (None if detect_step is None
                   else detect_step - CONS_INJECT_STEP)
        repairs = max(r['repairs_total'] for r in r0['records'])
        records_agree = all(r['records'] == r0['records'] for r in ranks)
        params_agree = all(r['param_sha256'] == r0['param_sha256']
                           for r in ranks)
        post = sorted(set().union(*(r['post_divergence'] for r in ranks)))
        phases['consistency_mp'] = {
            'ok': (latency is not None and 0 <= latency <= CONS_CADENCE
                   and owner['pre_divergence'] != []
                   and r0['pre_divergence'] == []
                   and repairs == 1 and post == []
                   and records_agree and params_agree
                   and all(np.isfinite(r['loss']) for r in r0['records'])),
            'detect_step': detect_step,
            'latency_steps': latency,
            'cadence': CONS_CADENCE,
            'pre_divergence_owner': owner['pre_divergence'],
            'pre_divergence_peer': r0['pre_divergence'],
            'repairs_total': repairs,
            'post_divergence': post,
            'records_agree': records_agree,
            'params_agree': params_agree,
        }

        # The seeded rank-guarded barrier: flagged before any process
        # starts, then shown to wedge on a live world.
        seeded = spmdlint.lint_source(SEEDED_RANK_GUARD_SOURCE,
                                      'seeded_rank_guard.py')
        contrast = spmdlint.lint_source(UNGUARDED_BARRIER_SOURCE,
                                        'unguarded_contrast.py')
        lint_rules = sorted({f.rule for f in seeded})
        wedge_out = os.path.join(work, 'rank_guard')
        rcs, _, _ = world('rank_guard_wedge (seeded)', {
            'role': 'rank_guard', 'guarded': True,
            'timeout_s': MP_RANK_GUARD_TIMEOUT_S, 'out': wedge_out,
        }, nprocs)
        w = [_read_json(f'{wedge_out}.r{r}.json') for r in range(nprocs)]
        clean_out = os.path.join(work, 'rank_guard_clean')
        crcs, _, _ = world('rank_guard contrast (no guard)', {
            'role': 'rank_guard', 'guarded': False,
            'timeout_s': MP_RANK_GUARD_TIMEOUT_S, 'out': clean_out,
        }, nprocs)
        c = [_read_json(f'{clean_out}.r{r}.json') for r in range(nprocs)]
        contrast_elapsed = max(r.get('elapsed_s', float('inf')) for r in c)
        phases['rank_guard_wedge'] = {
            'ok': (lint_rules == [MP_RANK_GUARD_RULE] and not contrast
                   and not any(rcs) and not any(crcs)
                   and w[0].get('wedged') is True
                   and w[0].get('error') == 'BarrierTimeoutError'
                   and w[0].get('elapsed_s', 0.0) >= MP_RANK_GUARD_TIMEOUT_S
                   and all(r.get('wedged') is False for r in w[1:])
                   and all(r.get('wedged') is False for r in c)
                   and contrast_elapsed < MP_RANK_GUARD_TIMEOUT_S),
            'lint_rules': lint_rules,
            'lint_findings': [f.format() for f in seeded],
            'contrast_lint_rules': sorted({f.rule for f in contrast}),
            'returncodes': rcs,
            'contrast_returncodes': crcs,
            'wedged': w[0].get('wedged'),
            'wedge_error': w[0].get('error'),
            'wedge_elapsed_s': w[0].get('elapsed_s'),
            'timeout_s': MP_RANK_GUARD_TIMEOUT_S,
            'skipping_rank_wedged': any(r.get('wedged') for r in w[1:]),
            'contrast_wedged': any(r.get('wedged') for r in c),
            'contrast_elapsed_s': contrast_elapsed,
        }
    except Exception as exc:  # noqa: BLE001 — the gate reports, not raises
        phases['error'] = {'ok': False, 'message': str(exc)}

    return _finish('multiproc', MP_SCHEMA, phases, {
        'nprocs': nprocs,
        'devices_per_rank': MP_DEVICES_PER_RANK,
        'total_steps': MP_TOTAL_STEPS,
        'save_every': MP_SAVE_EVERY,
        'kill_save_step': MP_KILL_SAVE_STEP,
        'kill_rank': MP_KILL_RANK,
        'parity_rel_err_bound': MP_PARITY_REL_ERR_BOUND,
        'resize_rel_err_bound': RESIZE_REL_ERR_BOUND,
        'init_deadline_s': MP_INIT_DEADLINE_S,
        'detect_bound_s': MP_DETECT_BOUND_S,
        'barrier_timeout_s': MP_BARRIER_TIMEOUT_S,
        'heartbeat_grace_s': MP_HEARTBEAT_GRACE_S,
        'exit_rank_death': MP_EXIT_RANK_DEATH,
        'rank_guard_timeout_s': MP_RANK_GUARD_TIMEOUT_S,
        'rank_guard_rule': MP_RANK_GUARD_RULE,
        'device': device,
    }, work, json_out)


def validate_multiproc_artifact(path: str) -> int:
    """Gate of a multiproc artifact: every pinned bound re-derived from
    the payload, and the doctored-artifact rules (recovery claimed
    without a recorded rank death; a wedge claimed without the static
    flag)."""
    payload, errors = validate_drill_artifact(path, MP_SCHEMA, (
        'init_bounded', 'parity', 'mp_determinism', 'rank_death',
        'resize_restore', 'consistency_mp', 'rank_guard_wedge',
    ))
    if payload is not None:
        phases = payload.get('phases', {})
        nprocs = (payload.get('config') or {}).get('nprocs', MP_NPROCS)
        init = phases.get('init_bounded', {})
        if init.get('error') != 'RuntimeInitError':
            errors.append(f'init_bounded error {init.get("error")!r} is not '
                          'the named RuntimeInitError')
        elapsed = init.get('elapsed_s')
        if not isinstance(elapsed, (int, float)) or (
                elapsed > MP_INIT_DEADLINE_S + 2.0):
            errors.append(f'init_bounded elapsed {elapsed} exceeds pinned '
                          f'deadline {MP_INIT_DEADLINE_S}+2.0s')
        par = phases.get('parity', {})
        if par.get('bound') != MP_PARITY_REL_ERR_BOUND:
            errors.append(f'parity bound {par.get("bound")} != pinned '
                          f'{MP_PARITY_REL_ERR_BOUND} (writer drifted)')
        for field in ('direct_rel_err', 'action_rel_err',
                      'orthonormality_err'):
            rel = par.get(field)
            if not isinstance(rel, (int, float)) or not (
                    rel <= MP_PARITY_REL_ERR_BOUND):
                errors.append(f'parity {field} {rel} exceeds pinned '
                              f'{MP_PARITY_REL_ERR_BOUND}')
        if phases.get('mp_determinism', {}).get('bitwise_equal') is not True:
            errors.append('mp_determinism is not bitwise')
        death = phases.get('rank_death', {})
        latency = death.get('detect_latency_s')
        if not isinstance(latency, (int, float)) or not (
                0.0 <= latency <= MP_DETECT_BOUND_S):
            errors.append(f'rank-death detect latency {latency} outside '
                          f'pinned [0, {MP_DETECT_BOUND_S}]s')
        want = [MP_EXIT_RANK_DEATH] * (nprocs if isinstance(nprocs, int)
                                       else MP_NPROCS)
        if MP_KILL_RANK < len(want):
            want[MP_KILL_RANK] = -signal.SIGKILL
        if death.get('returncodes') != want:
            errors.append(f'rank_death returncodes {death.get("returncodes")}'
                          f' != {want} (survivor abort + SIGKILL victim)')
        record = death.get('death_record') or {}
        recorded = (record.get('schema') == 'kfac-rank-death'
                    and isinstance(record.get('dead_ranks'), list)
                    and record.get('dead_ranks'))
        rz = phases.get('resize_restore', {})
        if rz.get('ok') is True and not recorded:
            errors.append('recovery claimed (resize_restore ok) without a '
                          'recorded rank death (rank_death.death_record)')
        rel = rz.get('param_rel_err')
        if rz.get('bound') != RESIZE_REL_ERR_BOUND:
            errors.append(f'resize bound {rz.get("bound")} != pinned '
                          f'{RESIZE_REL_ERR_BOUND} (writer drifted)')
        if not isinstance(rel, (int, float)) or not (
                rel <= RESIZE_REL_ERR_BOUND):
            errors.append(f'resize rel err {rel} exceeds pinned '
                          f'{RESIZE_REL_ERR_BOUND}')
        cons = phases.get('consistency_mp', {})
        lat = cons.get('latency_steps')
        if not isinstance(lat, int) or not 0 <= lat <= CONS_CADENCE:
            errors.append(f'consistency detect latency {lat} outside pinned '
                          f'[0, {CONS_CADENCE}] steps')
        if cons.get('repairs_total') != 1:
            errors.append(f'consistency repairs {cons.get("repairs_total")} '
                          '!= 1')
        if cons.get('pre_divergence_owner') == []:
            errors.append('consistency corruption vacuous: owner rank saw no '
                          'pre-repair divergence')
        if cons.get('post_divergence') != []:
            errors.append('divergence survived repair: '
                          f'{cons.get("post_divergence")}')
        if not (cons.get('records_agree') and cons.get('params_agree')):
            errors.append('controllers disagree after repair '
                          '(records/params)')
        rg = phases.get('rank_guard_wedge', {})
        if rg.get('lint_rules') != [MP_RANK_GUARD_RULE]:
            errors.append(f'rank-guard lint rules {rg.get("lint_rules")} != '
                          f'[{MP_RANK_GUARD_RULE!r}]: the seeded pattern was '
                          'not statically flagged')
        if rg.get('contrast_lint_rules') != []:
            errors.append('rank-guard contrast not lint-clean: '
                          f'{rg.get("contrast_lint_rules")}')
        if rg.get('wedged') is not True or (
                rg.get('wedge_error') != 'BarrierTimeoutError'):
            errors.append('seeded rank-guarded collective did not '
                          f'demonstrably wedge (wedged={rg.get("wedged")}, '
                          f'error={rg.get("wedge_error")!r})')
        t = rg.get('timeout_s')
        el = rg.get('wedge_elapsed_s')
        if (not isinstance(t, (int, float)) or t <= 0
                or not isinstance(el, (int, float)) or el < t):
            errors.append(f'rank-guard wedge elapsed {el} below its pinned '
                          f'timeout {t}: the blocked rank did not wait out '
                          'the barrier')
        if rg.get('skipping_rank_wedged') is not False:
            errors.append('the guard-skipping rank reports wedged: the '
                          'divergence was not one-sided')
        if rg.get('contrast_wedged') is not False or not (
                isinstance(rg.get('contrast_elapsed_s'), (int, float))
                and rg['contrast_elapsed_s'] < (t or float('inf'))):
            errors.append('unguarded contrast wedged or never completed '
                          'promptly: the wedge cannot be attributed to the '
                          'rank guard')
    if errors:
        for e in errors:
            print(f'multiproc artifact INVALID: {e}')
        return 1
    print('multiproc artifact valid')
    return 0


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='where the drill ranks run (default cuda; '
                             'cuda without a card raises)')
    parser.add_argument('--elastic', action='store_true',
                        help='run the preemption/resize drill')
    parser.add_argument('--consistency', action='store_true',
                        help='run the cross-replica consistency drill')
    parser.add_argument('--watchdog', action='store_true',
                        help='run the trajectory-watchdog drill')
    parser.add_argument('--postmortem', action='store_true',
                        help='run the flight-recorder postmortem drill')
    parser.add_argument('--multiproc', action='store_true',
                        help='run the multi-process rank-death drill')
    parser.add_argument('--worlds', default=None,
                        help='the elastic drill\'s three shrinking world '
                             'sizes, comma-separated (default 8,4,2)')
    parser.add_argument('--world', type=int, default=None,
                        help='world size of the consistency, watchdog and '
                             'postmortem drills (default 8) or the '
                             'multiproc drill (default 2)')
    parser.add_argument('--json-out', default=None,
                        help='artifact path of the drill that runs')
    for flag in ('elastic', 'consistency', 'watchdog', 'postmortem',
                 'multiproc'):
        parser.add_argument(f'--{flag}-child', default=None,
                            metavar='SPEC_JSON', help=argparse.SUPPRESS)
    parser.add_argument('--postmortem-judge', default=None,
                        metavar='SPEC_JSON', help=argparse.SUPPRESS)
    for flag in ('elastic', 'consistency', 'watchdog', 'postmortem',
                 'multiproc'):
        parser.add_argument(f'--validate-{flag}', default=None,
                            metavar='PATH',
                            help=f'validate a {flag} drill artifact')
    args, extra = parser.parse_known_args(argv)

    children = {
        'elastic_child': run_elastic_child,
        'consistency_child': run_consistency_child,
        'watchdog_child': run_watchdog_child,
        'postmortem_child': run_postmortem_child,
        'postmortem_judge': run_postmortem_judge,
        'multiproc_child': run_multiproc_child,
    }
    for attr, fn in children.items():
        if getattr(args, attr) is not None:
            return fn(getattr(args, attr))
    validators = {
        'validate_elastic': validate_elastic_artifact,
        'validate_consistency': validate_consistency_artifact,
        'validate_watchdog': validate_watchdog_artifact,
        'validate_postmortem': validate_postmortem_artifact,
        'validate_multiproc': validate_multiproc_artifact,
    }
    for attr, fn in validators.items():
        if getattr(args, attr) is not None:
            return fn(getattr(args, attr))
    if args.device == 'cuda':
        import torch

        if not torch.cuda.is_available():
            parser.error('--device cuda needs a CUDA card; pass --device cpu '
                         'to run the drill on the CPU')
    kw = {'device': args.device}
    if args.elastic:
        if args.worlds:
            kw['worlds'] = tuple(int(w) for w in args.worlds.split(','))
        return run_elastic_drill(args.json_out, **kw)
    if args.multiproc:
        if args.world:
            kw['nprocs'] = args.world
        return run_multiproc_drill(args.json_out, **kw)
    if args.world:
        kw['world'] = args.world
    if args.consistency:
        return run_consistency_drill(args.json_out, **kw)
    if args.watchdog:
        return run_watchdog_drill(args.json_out, **kw)
    if args.postmortem:
        return run_postmortem_drill(args.json_out, **kw)
    return run_health_drill(extra, args.json_out, args.device)


if __name__ == '__main__':
    raise SystemExit(main())
