"""The port's cross-replica consistency guard against the JAX package's,
on the CPU.

* The digests are bit for bit JAX's (``array_digest``, ``stack_digest``,
  ``sanitize``, the fold and the hyperparameter vector) on f32, bf16,
  bool and int arrays with NaN, +-inf and -0.0; ``canonical_rank`` is
  JAX's ``_canonical_rank`` on the same gathered digest arrays;
  ``ConsistencyConfig`` takes JAX's defaults and raises JAX's errors, and
  so do the preconditioner's exclusions.
* One rank: every check is clean and issues no collective; the guard on
  a clean run is bitwise the guard off; the check keys appear on cadence
  steps only.
* Four gloo ranks (subprocesses of this file, as
  ``tests/test_torch_distributed.py`` runs them) on LeNet at 12x12 with
  fixed weights, cadence 1.  HYBRID-OPT (2x2): one flipped bit of one
  rank's factor EMA and of another rank's ``qa`` slot are counted
  exactly at the next check (one layer, one slot), repaired bitwise (no
  replica differs afterwards, over the world for the EMAs and over each
  grid column for the stacks) and the next refresh is forced to a
  bootstrap; a fault re-injected before every check quarantines its slot
  after ``quarantine_after`` checks on the ranks that hold it;
  ``repair='detect'`` counts and rewrites nothing; one rank's drifted
  damping counts an ``hp`` mismatch and repairs nothing.  The gathered
  per-rank digests equal JAX's digests of the same arrays, and JAX's
  ``_canonical_rank`` on them gives the port's masks and canonical
  ranks.  The repair's vote on replicated tensors (the parameters and
  their gradients at a repair) restores each divergent one's canonical
  bytes; a trained COMM-OPT run keeps its parameters together.  MEM-OPT (1x4): the stacks have no replicas, so a flipped slot
  goes unseen while a flipped EMA is counted.  Health on HYBRID-OPT with
  injected failures: the same ``health/*`` counters on every rank at
  every step, equal to the JAX 4-device mesh run's.
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

import kfac_pytorch_tpu_torch as kt  # noqa: E402
from kfac_pytorch_tpu_torch import consistency  # noqa: E402
from kfac_pytorch_tpu_torch import testing as ttest  # noqa: E402
from kfac_pytorch_tpu_torch.models import LeNet  # noqa: E402
from kfac_pytorch_tpu_torch.models import TinyModel  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

WORLD = 4
SPAWN_TIMEOUT_S = 240
HP = dict(factor_update_steps=1, inv_update_steps=100, damping=0.003,
          lr=0.1)
#: The slot the rank-2 faults hit: a conv2 (a64g32) slot, in rank 2's
#: grid column (column 0) under HYBRID-OPT.
FLIP_KEY = 'a64g32'


def special_array(dtype: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 5)).astype(np.float32) * 100
    if dtype in ('float32', 'bfloat16'):
        x[0, 0, :4] = [np.nan, np.inf, -np.inf, -0.0]
        x[2, 1, 1] = -0.0
    if dtype == 'bool':
        return x > 0
    if dtype == 'int32':
        return x.astype(np.int32)
    return x


def as_pair(x: np.ndarray, dtype: str):
    """The same array in both packages, bit for bit: bf16 goes through
    its 16-bit patterns (the two packages round a NaN to bf16 with
    different payloads, 0xFFFF and 0x7FC0, so converting each side from
    f32 would digest different inputs)."""
    import jax.numpy as jnp

    if dtype == 'bfloat16':
        j = jnp.asarray(x).astype(jnp.bfloat16)
        bits = np.asarray(j).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16), j
    return torch.from_numpy(x), jnp.asarray(x)


def u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


# -- the primitives against JAX -------------------------------------------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'bool', 'int32'])
def test_digests_bitwise_jax(dtype):
    from kfac_pytorch_tpu import consistency as jc

    t, j = as_pair(special_array(dtype), dtype)
    np.testing.assert_array_equal(consistency.array_digest(t).numpy(),
                                  u32(jc.array_digest(j)))
    np.testing.assert_array_equal(consistency.stack_digest(t).numpy(),
                                  u32(jc.stack_digest(j)))
    np.testing.assert_array_equal(
        consistency.sanitize(t).numpy().view(np.int32),
        np.asarray(jc.sanitize(j)).view(np.int32))


def test_one_flipped_bit_changes_the_digest():
    x = torch.from_numpy(special_array('float32'))
    for index in (0, 7, 59):
        for bit in (0, 20, 31):
            flipped = ttest.bitflip(x, index=index, bit=bit)
            assert not torch.equal(consistency.array_digest(flipped),
                                   consistency.array_digest(x))
    # A sign flip of -0.0 to +0.0 is seen too (bit 31 of element 3).
    zero = torch.tensor([-0.0, 1.0])
    assert not torch.equal(consistency.array_digest(zero),
                           consistency.array_digest(torch.tensor([0.0, 1.0])))


def test_fold_and_hp_vector_match_jax():
    import jax.numpy as jnp

    from kfac_pytorch_tpu import consistency as jc

    arrays = [special_array('float32'), special_array('int32'),
              special_array('bool')]
    got = consistency.fold([consistency.stack_digest(torch.from_numpy(a))
                            for a in arrays])
    want = jc._fold([jc.stack_digest(jnp.asarray(a)) for a in arrays])
    np.testing.assert_array_equal(got.numpy(), u32(want))
    for hp in ({'damping': 0.003, 'factor_decay': 0.95, 'lr': 0.1,
                'kl_clip': 0.001},
               {'damping': -1.5, 'factor_decay': float('nan'), 'lr': 1e30}):
        jhp = {k: jnp.float32(v) for k, v in hp.items()}
        np.testing.assert_array_equal(consistency.hp_vector(hp).numpy(),
                                      u32(jc._hp_vector(jhp)))
    assert consistency.HP_DIGEST_KEYS == jc.HP_DIGEST_KEYS


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_canonical_rank_matches_jax(seed):
    import jax.numpy as jnp

    from kfac_pytorch_tpu import consistency as jc

    rng = np.random.default_rng(seed)
    ag = rng.integers(0, 3, size=(4, 6, 2)).astype(np.int64)
    ag[:, 0] = ag[0, 0]           # every rank agrees
    ag[1:, 1] = ag[0, 1] + 7      # rank 0 is the minority
    canon, mask = consistency.canonical_rank(ag)
    jcanon, jmask = jc._canonical_rank(jnp.asarray(ag.astype(np.uint32)))
    np.testing.assert_array_equal(canon, np.asarray(jcanon))
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    assert not mask[0] and mask[1] and canon[1] == 1


@pytest.mark.parametrize('kwargs', [
    dict(cadence=0), dict(repair='fix'), dict(quarantine_after=0),
])
def test_config_matches_jax(kwargs):
    import dataclasses

    from kfac_pytorch_tpu.consistency import ConsistencyConfig as JaxConfig

    with pytest.raises(ValueError) as want:
        JaxConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        kt.ConsistencyConfig(**kwargs)
    assert str(got.value) == str(want.value)
    assert dataclasses.asdict(kt.ConsistencyConfig()) == dataclasses.asdict(
        JaxConfig())


@pytest.mark.parametrize('kwargs,error', [
    (dict(bucketed=False), ValueError),
    (dict(lowrank_rank=4), ValueError),
    (dict(consistency=object()), TypeError),
])
def test_exclusions_raise_jax_errors(kwargs, error):
    from kfac_pytorch_tpu.consistency import ConsistencyConfig as JaxConfig
    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    jkw = dict(kwargs)
    jkw.setdefault('consistency', JaxConfig())
    kw = dict(kwargs)
    kw.setdefault('consistency', kt.ConsistencyConfig())
    with pytest.raises(error) as want:
        JaxPreconditioner(JaxTiny(), loss_fn=None, **jkw)
    with pytest.raises(error) as got:
        kt.KFACPreconditioner(TinyModel(), **kw)
    assert str(got.value) == str(want.value)


def test_watchdog_names_its_item():
    """The watchdog (Queue A item 21b) is ported: a config of the wrong
    type raises the JAX engine's ``TypeError``, and a ``WatchdogConfig``
    builds the quarantine masks the consistency guard shares."""
    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    with pytest.raises(TypeError) as want:
        JaxPreconditioner(JaxTiny(), loss_fn=None, watchdog=object())
    with pytest.raises(TypeError) as got:
        kt.KFACPreconditioner(TinyModel(), watchdog=object())
    assert str(got.value) == str(want.value)
    precond = kt.KFACPreconditioner(TinyModel(),
                                    watchdog=kt.WatchdogConfig())
    assert all(bs.quarantined is not None for bs in precond.buckets.values())


# -- one rank ----------------------------------------------------------------


def tiny_run(cfg, steps=5, monkeypatch=None):
    torch.manual_seed(0)
    model = TinyModel()
    precond = kt.KFACPreconditioner(
        model, consistency=cfg,
        **dict(HP, inv_update_steps=2))
    rng = np.random.default_rng(1)
    out = []
    for _ in range(steps):
        x = torch.from_numpy(rng.standard_normal((8, 10)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, size=8))
        model.zero_grad()
        F.cross_entropy(model(x), y).backward()
        precond.step()
        out.append(({n: p.grad.clone() for n, p in model.named_parameters()},
                    dict(precond.last_step_info)))
    return precond, out


def test_one_rank_checks_are_clean_and_issue_no_collective(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('a collective was issued')
    for name in ('all_gather_into_tensor', 'broadcast', 'all_reduce',
                 'all_gather'):
        monkeypatch.setattr(dist, name, boom)
    precond, out = tiny_run(kt.ConsistencyConfig(cadence=1))
    info = out[-1][1]
    assert int(info['consistency/checks_total']) == 5
    for key in ('mismatches', 'layer_mismatches', 'hp_mismatches',
                'bucket_mismatches', 'detections_total', 'repairs_total',
                'quarantines_total', 'strikes_max'):
        assert int(info[f'consistency/{key}']) == 0, key
    assert int(info['consistency/bucket/a32g32']) == 0
    assert precond.last_consistency_check.gathered is None
    # Every bucket carries the quarantine masks the ladder writes.
    assert precond.buckets['a32g32'].quarantined.tolist() == [False, False]


def test_guard_on_is_bitwise_guard_off_and_checks_on_cadence():
    _, off = tiny_run(None)
    _, on = tiny_run(kt.ConsistencyConfig(cadence=2))
    for (g0, i0), (g1, i1), t in zip(off, on, range(5)):
        for n in g0:
            assert torch.equal(g0[n], g1[n])
        assert not any(k.startswith('consistency/') for k in i0)
        has = any(k.startswith('consistency/') for k in i1)
        assert has == (t % 2 == 0), t


def test_quarantine_mask_survives_refresh():
    """A consistency quarantine is sticky without health: every refresh
    carries it (JAX ``TestLadder::test_quarantine_mask_survives_refresh``,
    which fails on the reference under jax 0.9.0 only for its
    ``shard_map(check_rep=False)``)."""
    precond, _ = tiny_run(kt.ConsistencyConfig(cadence=1, repair='detect'),
                          steps=1)
    mask = np.array([True, False])
    consistency.apply_quarantine(precond.buckets, {'a32g32': mask},
                                 precond.grid)
    model = precond._capture.model
    for _ in range(3):  # crosses the refresh at step 2
        model.zero_grad()
        F.cross_entropy(model(torch.randn(8, 10)),
                        torch.randint(0, 10, (8,))).backward()
        precond.step()
    assert precond.buckets['a32g32'].quarantined.tolist() == [True, False]
    with pytest.raises(ValueError, match='quarantine mask'):
        consistency.apply_quarantine(
            kt.KFACPreconditioner(TinyModel()).buckets, {'a32g32': mask},
            precond.grid)


# -- four gloo ranks -----------------------------------------------------


def rank_data(rank, world, step):
    rng = np.random.default_rng(100 + step)
    x = rng.standard_normal((16, 1, 12, 12)).astype(np.float32)
    y = rng.integers(0, 10, size=(16,))
    q = len(x) // world
    return (torch.from_numpy(x[rank * q:(rank + 1) * q]),
            torch.from_numpy(y[rank * q:(rank + 1) * q]).long())


def cons_info(info) -> dict:
    return {k: int(v) for k, v in info.items()
            if k.startswith('consistency/')}


def divergence(precond) -> dict:
    """Replicas that differ: every layer tensor over the world, every
    bucket stack over its grid column."""
    layers = {f'{n}.{f}': t for n, st in precond.layers.items()
              for f, t in (('a', st.a_factor), ('g', st.g_factor))}
    out = consistency.host_replica_divergence(layers)
    if precond.grid.rows > 1:
        stacks = {f'{k}.{f}': t for k, bs in precond.buckets.items()
                  for f, t in bs.tensors().items()}
        out.update(consistency.host_replica_divergence(
            stacks, precond.grid.col_group))
    return out


def guarded_run(rank, world, weights, fraction, cfg, faults, steps,
                damping=None, health=None, train_lr=None, **kw):
    """``steps`` fixed-weight steps (with ``train_lr``, each ends with
    ``p -= train_lr * grad``); ``faults[t]`` runs on the preconditioner
    before step ``t``.  Per step the consistency and health info, the
    divergence after the step, the bootstrap flags and the quarantine
    masks (and with ``train_lr`` the parameters' divergence)."""
    model = LeNet(image_size=12)
    model.load_state_dict(weights)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    kw = dict(HP, **kw)
    if damping is not None:
        kw['damping'] = damping
    precond = kt.KFACPreconditioner(
        ddp, grad_worker_fraction=fraction, consistency=cfg, health=health,
        **kw)
    out = []
    for t in range(steps):
        if t in faults:
            faults[t](precond)
        x, y = rank_data(rank, world, t)
        model.zero_grad()
        F.cross_entropy(ddp(x), y).backward()
        precond.step()
        params = {}
        if train_lr is not None:
            with torch.no_grad():
                for p in model.parameters():
                    p.sub_(train_lr * p.grad)
            params = consistency.host_replica_divergence(
                {n: p.detach() for n, p in model.named_parameters()})
        info = precond.last_step_info
        res = precond.last_consistency_check
        out.append(dict(
            params=params,
            cons=cons_info(info),
            health={k: int(v) for k, v in info.items()
                    if k.startswith('health/')},
            divergence=divergence(precond) if cfg is not None else {},
            flags=(precond._stagger_bootstrapped, precond._iter_bootstrapped,
                   precond._overlap_bootstrapped),
            quarantined={k: bs.quarantined.tolist()
                         for k, bs in precond.buckets.items()},
            gathered=None if res is None else res.gathered,
            layer_canon=None if res is None else res.layer_canon,
            bucket_canon=None if res is None else {
                k: v.tolist() for k, v in res.bucket_canon.items()},
            layer_mask=None if res is None else res.layer_mask.tolist(),
            bucket_masks=None if res is None else {
                k: v.tolist() for k, v in res.bucket_masks.items()},
            arrays={n: (st.a_factor.numpy().copy(), st.g_factor.numpy().copy())
                    for n, st in precond.layers.items()},
            stacks={k: {f: t.numpy().copy()
                        for f, t in bs.tensors().items()}
                    for k, bs in precond.buckets.items()},
        ))
    return precond, out


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120),
    )
    weights = torch.load(out / 'init.pt')
    hybrid, memopt = 0.5, 0.25
    report = {}

    def flip_layer(p):
        p.layers['conv1'].a_factor = ttest.desync_replica(
            p.layers['conv1'].a_factor, 1)

    def flip_slot(p):
        # The first slot of rank 2's grid column (occupied under
        # HYBRID-OPT: conv2).
        col = 2 % p.grid.cols
        ttest.desync_slot(p, FLIP_KEY, col * p.plan.bucket(FLIP_KEY).seg,
                          field='qa', replica=2)

    def both(p):
        flip_layer(p)
        flip_slot(p)

    cfg = kt.ConsistencyConfig(cadence=1, quarantine_after=2)
    _, report['repair'] = guarded_run(
        rank, world, weights, hybrid, cfg,
        {1: both, 3: flip_slot, 4: flip_slot}, 6)
    # The repair's parameter vote: rank 2's copy of one tensor of three
    # moved by one bit, rank 3's of another by a different bit.
    torch.manual_seed(5)
    ts = [torch.randn(3, 4), torch.randn(5), torch.randn(2, 2).t()]
    want = [t.clone() for t in ts]
    if rank == 2:
        ts[0] = ttest.bitflip(ts[0], 3)
    if rank == 3:
        ts[2].copy_(ttest.bitflip(ts[2], 1, bit=5))
    report['replicated'] = dict(
        mask=consistency.repair_replicated(ts).tolist(),
        equal=[torch.equal(t, w) for t, w in zip(ts, want)])
    # A trained run under COMM-OPT: the flipped slot moves no rank's
    # gradients apart (its precondition is shared over the column), so
    # every check sees the curvature only and the parameters agree
    # throughout; the repair leaves them bitwise as they were.
    _, report['params'] = guarded_run(
        rank, world, weights, 1.0, kt.ConsistencyConfig(cadence=2),
        {1: flip_slot}, 4, train_lr=0.1)
    _, report['detect'] = guarded_run(
        rank, world, weights, hybrid,
        kt.ConsistencyConfig(cadence=1, repair='detect'), {1: both}, 3)
    _, report['hp'] = guarded_run(
        rank, world, weights, hybrid, cfg, {}, 2,
        damping=0.0031 if rank == 3 else 0.003)
    _, report['memopt'] = guarded_run(
        rank, world, weights, memopt, cfg, {1: both}, 3)

    def flip_basis(p):
        bs = p.buckets[FLIP_KEY]
        bs.basis_qa = ttest.desync_replica(bs.basis_qa, 3)

    _, report['ekfac'] = guarded_run(
        rank, world, weights, hybrid, cfg, {2: flip_basis}, 3, ekfac=True)
    probe = kt.KFACPreconditioner(LeNet(image_size=12),
                                  grad_worker_fraction=hybrid)
    health = ttest.eigh_failure_config(
        probe, layers=('conv2',), attempts=99, quarantine_after=2)
    _, report['health'] = guarded_run(
        rank, world, weights, hybrid, None, {}, 5,
        health=health)
    _, report['health_retry'] = guarded_run(
        rank, world, weights, hybrid, None, {}, 1,
        health=kt.HealthConfig(inject_eigh_failures=1))
    for name, run in report.items():
        for rec in (run if name != 'replicated' else ()):
            if rank:
                rec.pop('arrays')
                rec.pop('stacks')
    torch.save(report, out / f'rank{rank}.pt')
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Per rank the worker's report, and the JAX 4-device mesh run's
    health counters of the ``health`` scenario."""
    tmp = tmp_path_factory.mktemp('consistency')
    torch.manual_seed(3)
    weights = LeNet(image_size=12).state_dict()
    torch.save(weights, tmp / 'init.pt')
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, '--worker', str(rank), str(WORLD),
             str(tmp / 'pg_init'), str(tmp)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(WORLD)
    ]
    deadline = time.time() + SPAWN_TIMEOUT_S
    try:
        want = jax_mesh_health(weights)
    finally:
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
    return [torch.load(tmp / f'rank{r}.pt', weights_only=False)
            for r in range(WORLD)], want


def jax_mesh_health(weights) -> dict:
    """The JAX engine on a 4-device mesh under HYBRID-OPT with the
    ``health`` and ``health_retry`` scenarios' configs: per step the
    ``health/*`` counters."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kfac_pytorch_tpu.enums import DistributedStrategy as JaxStrategy
    from kfac_pytorch_tpu.health import HealthConfig as JaxConfig
    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    x0 = np.zeros((16, 12, 12, 1), np.float32)
    variables = JaxLeNet().init(jax.random.PRNGKey(0), x0)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ('data',))
    shard = NamedSharding(mesh, P('data'))
    out = {}
    for name, steps in (('health', 5), ('health_retry', 1)):
        probe = JaxPreconditioner(JaxLeNet(), loss_fn=xent, mesh=mesh,
                                  grad_worker_fraction=JaxStrategy.HYBRID_OPT)
        probe.init(variables, x0)
        if name == 'health':
            cfg = JaxConfig(inject_eigh_failures=99, quarantine_after=2,
                            inject_eigh_layers=(probe._ekfac_slot['conv2'],))
        else:
            cfg = JaxConfig(inject_eigh_failures=1)
        precond = JaxPreconditioner(
            JaxLeNet(), loss_fn=xent, mesh=mesh,
            grad_worker_fraction=JaxStrategy.HYBRID_OPT, health=cfg, **HP)
        state = precond.init(variables, x0)
        rows = []
        for t in range(steps):
            rng = np.random.default_rng(100 + t)
            x = rng.standard_normal((16, 1, 12, 12)).astype(np.float32)
            y = rng.integers(0, 10, size=(16,))
            xs = jax.device_put(np.transpose(x, (0, 2, 3, 1)), shard)
            _, _, _, state = precond.step(
                variables, state, xs,
                loss_args=(jax.device_put(jnp.asarray(y), shard),))
            info = precond.last_step_info
            rows.append({k: int(np.asarray(info[k])) for k in info
                         if k.startswith('health/')})
        out[name] = rows
    return out


def test_bit_flips_counted_repaired_and_rebootstrapped(ranks):
    reports, _ = ranks
    runs = [r['repair'] for r in reports]
    for run in runs:
        assert run[0]['cons']['consistency/mismatches'] == 0
        hit = run[1]['cons']
        assert hit['consistency/layer_mismatches'] == 1
        assert hit['consistency/bucket_mismatches'] == 1
        assert hit[f'consistency/bucket/{FLIP_KEY}'] == 1
        assert hit['consistency/repairs_total'] == 1
        assert hit['consistency/detections_total'] == 1
        assert run[1]['divergence'] == {}
        assert run[1]['flags'] == (False, False, False)
        assert run[2]['cons']['consistency/mismatches'] == 0
        assert run[2]['cons']['consistency/strikes_max'] == 0
    # Every rank read the same verdicts, masks and canonical ranks.
    for t in range(6):
        for key in ('cons', 'layer_mask', 'bucket_masks', 'bucket_canon'):
            assert all(r[t][key] == runs[0][t][key] for r in runs), (t, key)
    # The canonical copies: rank 0 for the layer, rank 0 (the other
    # replica of column 0) for the slot.
    names = sorted(reports[0]['repair'][0]['arrays'])
    assert runs[0][1]['layer_canon'][names.index('conv1')] == 0


def test_repair_votes_on_replicated_tensors(ranks):
    """``repair_replicated``: the tensors a rank holds apart from the
    majority (a non-contiguous one among them) are counted and take the
    canonical replica's bytes; the others are left as they are."""
    reports, _ = ranks
    for r in reports:
        assert r['replicated']['mask'] == [True, False, True]
        assert r['replicated']['equal'] == [True, True, True]


def test_repair_keeps_trained_parameters_together(ranks):
    """A trained run through one rank's flipped slot: detected and
    repaired at the next check, and the parameters, voted on at the
    repair, agree bitwise at every step.  (The fault drill's TinyModel
    run is the case where they had moved apart; its live test holds
    them together after the repair.)"""
    reports, _ = ranks
    for r in reports:
        run = r['params']
        assert [rec['params'] for rec in run] == [{}] * 4
        assert run[2]['cons']['consistency/repairs_total'] == 1
        assert run[2]['divergence'] == {} and run[3]['divergence'] == {}


def test_persistent_fault_is_quarantined(ranks):
    reports, _ = ranks
    runs = [r['repair'] for r in reports]
    for rank, run in enumerate(runs):
        assert run[3]['cons']['consistency/strikes_max'] == 1
        assert run[4]['cons']['consistency/quarantines_total'] == 1
        col = rank % 2
        slot = [i for i, q in enumerate(run[4]['quarantined'][FLIP_KEY])
                if q]
        assert slot == ([0] if col == 0 else []), (rank, slot)
        assert run[5]['quarantined'][FLIP_KEY] == run[4]['quarantined'][
            FLIP_KEY]
        assert run[4]['divergence'] == {}


def test_detect_mode_rewrites_nothing(ranks):
    reports, _ = ranks
    for rank, r in enumerate(reports):
        run = r['detect']
        hit = run[1]['cons']
        assert hit['consistency/mismatches'] == 2
        assert hit['consistency/repairs_total'] == 0
        assert run[1]['flags'] == (True, True, True)
        # The flipped copies are still there.
        assert run[1]['divergence'] and run[2]['divergence']


def test_hp_drift_is_counted_not_repaired(ranks):
    reports, _ = ranks
    for r in reports:
        hit = r['hp'][0]['cons']
        assert hit['consistency/hp_mismatches'] == 1
        assert hit['consistency/mismatches'] == 1
        assert hit['consistency/detections_total'] == 1
        assert hit['consistency/repairs_total'] == 0


def test_mem_opt_checks_the_replicated_surfaces_only(ranks):
    reports, _ = ranks
    for r in reports:
        hit = r['memopt'][1]['cons']
        assert hit['consistency/layer_mismatches'] == 1
        assert hit['consistency/bucket_mismatches'] == 0
        assert hit['consistency/repairs_total'] == 1


def test_ekfac_bases_are_a_surface_of_their_own(ranks):
    """EKFAC under HYBRID-OPT composes with the guard (JAX's
    ``test_ekfac_composes_with_consistency``): clean checks, then one
    rank's flipped bit in the gathered bases (the port's
    ``basis_qa``, every occupied slot, held on every rank) counted in
    ``consistency/basis_mismatches`` and repaired over the world."""
    reports, _ = ranks
    for r in reports:
        run = r['ekfac']
        for t in (0, 1):
            assert run[t]['cons']['consistency/mismatches'] == 0
            assert run[t]['cons']['consistency/basis_mismatches'] == 0
        hit = run[2]['cons']
        assert hit['consistency/basis_mismatches'] == 1
        assert hit['consistency/mismatches'] == 1
        assert hit['consistency/repairs_total'] == 1
        assert run[2]['divergence'] == {}


def test_gathered_digests_are_jax_digests(ranks):
    """Rank 0's and rank 1's digests of their own factor EMAs and of
    their column's stacks, as gathered at the first check, equal JAX's
    digests of the same arrays; JAX's vote on the gathered layer digests
    gives the port's canonical ranks and masks."""
    import jax.numpy as jnp

    from kfac_pytorch_tpu import consistency as jc

    reports, _ = ranks
    rec = reports[0]['repair'][1]
    ag = rec['gathered']
    names = sorted(rec['arrays'])
    n = len(names)
    for rank in (0, 1):
        arrays = reports[0]['repair'][0]['arrays']  # equal on every rank
        if rank == 0:
            for i, name in enumerate(names):
                a, g = arrays[name]
                want = jc._fold([jc.array_digest(jnp.asarray(a)),
                                 jc.array_digest(jnp.asarray(g))])
                np.testing.assert_array_equal(
                    reports[0]['repair'][0]['gathered'][rank, 2 * i:2 * i + 2],
                    u32(want))
    layers = ag[:, :2 * n].reshape(WORLD, n, 2)
    canon, mask = jc._canonical_rank(jnp.asarray(layers.astype(np.uint32)))
    np.testing.assert_array_equal(np.asarray(canon), rec['layer_canon'])
    np.testing.assert_array_equal(np.asarray(mask), rec['layer_mask'])
    # Rank 0's bucket stacks digest as JAX digests them.
    stacks = reports[0]['repair'][0]['stacks']
    off = 2 * n + 4  # four hyperparameter scalars
    for key in sorted(stacks, key=list(stacks).index):
        fields = stacks[key]
        want = jc._fold([jc.stack_digest(jnp.asarray(fields[f]))
                         for f in sorted(fields)])
        seg = next(iter(fields.values())).shape[0]
        np.testing.assert_array_equal(
            reports[0]['repair'][0]['gathered'][0, off:off + 2 * seg],
            u32(want).reshape(-1))
        off += 2 * seg


def test_health_counters_agree_across_ranks_and_with_jax(ranks):
    reports, want = ranks
    for name in ('health', 'health_retry'):
        runs = [r[name] for r in reports]
        for t, w in enumerate(want[name]):
            for rank, run in enumerate(runs):
                assert run[t]['health'] == w, (name, t, rank,
                                               run[t]['health'], w)
    last = reports[0]['health'][-1]['health']
    assert last['health/quarantined_layers'] == 1
    assert last['health/eigh_fallbacks'] == 1


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
