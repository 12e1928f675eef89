"""The port's multi-process runtime against the JAX package's, on the CPU.

* ``initialize_distributed`` with the same scripted fakes (probe, init,
  clock, sleep, jitter) as JAX's: the same attempt counts, the same
  backoff sleeps and the same error text (the JAX text names
  ``jax.distributed.initialize``, the port's "the distributed init").
* ``Heartbeat.dead_ranks`` over heartbeat files the JAX package wrote,
  under a fake clock: the same verdicts as JAX's reader on the same
  files.
* A barrier that times out raises ``BarrierTimeoutError``; one entered
  with a dead peer raises ``RankDeathError``; the monitor thread writes
  ``rank_death.json`` and runs the ``on_peer_death`` hooks.
* ``commit_point`` is a no-op at world 1 and without a runtime.
* One subprocess test: three gloo ranks come up through
  ``initialize_distributed`` (a real ``TCPStore``), pass a store
  barrier, rank 2 is SIGKILLed by ``testing.kill_rank`` while the others
  enter a collective it never joins (gloo may raise "connection closed
  by peer" at once; the rank then waits for the monitor), and ranks 0
  and 1 exit 87.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch import runtime  # noqa: E402
from kfac_pytorch_tpu_torch import testing as ttest  # noqa: E402
from kfac_pytorch_tpu_torch import tracing  # noqa: E402

pytestmark = pytest.mark.torch_port


class FakeClock:
    def __init__(self) -> None:
        self.t = 100.0
        self.sleeps: list[float] = []

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.t += s


def scripted(script, clock):
    """An initializer that raises (or succeeds) by ``script`` and
    advances the fake clock by 1 s per call."""
    calls = []

    def init(**kw):
        calls.append(kw)
        clock.t += 1.0
        outcome = script[min(len(calls) - 1, len(script) - 1)]
        if outcome != 'ok':
            raise RuntimeError(outcome)
    return init, calls


SCENARIOS = {
    'probe_then_ok': dict(rank=1, probe=[False, False, True],
                          init=['ok'], deadline=60.0),
    'init_fails_twice': dict(rank=0, probe=[True], deadline=60.0,
                             init=['refused', 'refused', 'ok']),
    'never_up': dict(rank=2, probe=[False], init=['ok'], deadline=5.0),
    'always_fails': dict(rank=0, probe=[True], init=['boom'], deadline=6.0),
}


def run_init(mod, case):
    clock = FakeClock()
    init, calls = scripted(case['init'], clock)
    probes = []

    def probe(addr, timeout):
        probes.append(round(timeout, 6))
        clock.t += 0.5
        return case['probe'][min(len(probes) - 1, len(case['probe']) - 1)]

    cfg = mod.RuntimeConfig(coordinator='127.0.0.1:1234', num_processes=4,
                            process_id=case['rank'],
                            init_deadline_s=case['deadline'])
    try:
        attempts = mod.initialize_distributed(
            cfg, initialize=init, probe=probe, clock=clock,
            sleep=clock.sleep, uniform=lambda a, b: 0.25 * (b - a))
        err = None
    except mod.RuntimeInitError as exc:
        attempts, err = None, str(exc)
    timeouts = [c['initialization_timeout'] for c in calls]
    return attempts, err, clock.sleeps, probes, timeouts


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_initialize_distributed_matches_jax(name):
    from kfac_pytorch_tpu import runtime as jrt

    case = SCENARIOS[name]
    got = run_init(runtime, case)
    want = run_init(jrt, case)
    assert got[0] == want[0]
    assert got[2:] == want[2:]
    if want[1] is None:
        assert got[1] is None
    else:
        assert got[1] == want[1].replace('jax.distributed.initialize',
                                         'the distributed init')
    if name in ('never_up', 'always_fails'):
        assert got[1] is not None


def test_heartbeat_reads_the_jax_files(tmp_path):
    """Beats written by the JAX package's ``Heartbeat`` at fake times,
    read by the port's and by JAX's at the same fake times."""
    from kfac_pytorch_tpu import runtime as jrt

    clock = FakeClock()
    jrt.Heartbeat(str(tmp_path), 1, 4, clock=clock).beat()
    clock.t += 2.0
    jrt.Heartbeat(str(tmp_path), 2, 4, clock=clock).beat()
    mine = runtime.Heartbeat(str(tmp_path), 0, 4, grace_s=3.0, clock=clock)
    theirs = jrt.Heartbeat(str(tmp_path), 0, 4, grace_s=3.0, clock=clock)
    for hb in (mine, theirs):
        hb._started_at = clock.t
    seen = []
    for dt in (0.5, 1.5, 2.0, 3.0):
        clock.t += dt
        got, want = mine.dead_ranks(), theirs.dead_ranks()
        assert got == want
        seen.append(got)
    assert seen[0] == () and seen[-1] == (1, 2, 3)
    assert mine.last_beat(1) == theirs.last_beat(1) == 100.0


def test_barrier_timeout_and_rank_death(tmp_path):
    cfg = runtime.RuntimeConfig(
        coordinator='127.0.0.1:1', num_processes=2, process_id=0,
        heartbeat_dir=str(tmp_path), heartbeat_grace_s=0.3,
        heartbeat_interval_s=0.05, abort_on_death=False)
    rt = runtime.DistributedRuntime(cfg)
    release = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(runtime.BarrierTimeoutError, match="'step'"):
        rt.barrier('step', timeout_s=0.2, sync=lambda name: release.wait(5))
    release.set()
    assert time.monotonic() - t0 < 2.0
    hooks = []
    rt.on_peer_death(hooks.append)
    rt.initialize(initialize=lambda **kw: None)  # rank 1 never beats
    try:
        deadline = time.monotonic() + 5.0
        while not hooks and time.monotonic() < deadline:
            time.sleep(0.05)
        assert hooks == [(1,)]
        record = json.loads((tmp_path / 'rank_death.json').read_text())
        assert record['dead_ranks'] == [1] and record['rank'] == 0
        assert record['detection_bound_s'] == pytest.approx(0.35)
        with pytest.raises(runtime.RankDeathError) as exc:
            rt.barrier('next', sync=lambda name: None)
        assert exc.value.dead_ranks == (1,)
    finally:
        rt.shutdown()


def test_commit_point_is_a_noop_at_world_1():
    called = []
    before = tracing.get_events().get('runtime_commit_point', 0)
    runtime.commit_point('elastic/commit')  # no runtime installed
    rt = runtime.DistributedRuntime(runtime.RuntimeConfig(
        coordinator='127.0.0.1:1', num_processes=1, process_id=0))
    runtime.install(rt)
    try:
        rt.barrier('x', sync=called.append)
        runtime.commit_point('elastic/commit')
    finally:
        rt.shutdown()
    assert runtime.active() is None
    assert called == []
    assert tracing.get_events().get('runtime_commit_point', 0) == before


def test_three_ranks_survivors_exit_87(tmp_path):
    """Three gloo ranks through the runtime; rank 2 is SIGKILLed once it
    reports the barrier passed, and the survivors exit 87 within the
    grace period, naming it in ``rank_death.json``."""
    env = {'PYTHONPATH': str(ROOT), 'OMP_NUM_THREADS': '1'}
    procs, _ = ttest.spawn_ranks(
        3, [sys.executable, __file__, '--worker', str(tmp_path)],
        extra_env=env, cwd=str(ROOT))
    ready = tmp_path / 'ready-2'
    killed = ttest.kill_rank(procs[2].pid, when=ready.exists)
    results = ttest.wait_ranks(procs, timeout_s=90.0)
    assert killed.wait(1.0)
    codes = [code for code, _ in results]
    assert codes[:2] == [runtime.EXIT_RANK_DEATH] * 2, results
    assert codes[2] == -9
    record = json.loads((tmp_path / 'hb' / 'rank_death.json').read_text())
    assert record['dead_ranks'] == [2]
    for rank in (0, 1):
        attempts = json.loads((tmp_path / f'ready-{rank}').read_text())
        assert attempts >= 1


def run_worker(workdir: Path) -> None:
    import torch
    import torch.distributed as dist

    cfg = runtime.RuntimeConfig(
        coordinator=os.environ['KFAC_COORD'],
        num_processes=int(os.environ['KFAC_NPROCS']),
        process_id=int(os.environ['KFAC_RANK']),
        init_deadline_s=45.0, heartbeat_dir=str(workdir / 'hb'),
        heartbeat_interval_s=0.1, heartbeat_grace_s=1.5)
    rt = runtime.DistributedRuntime(cfg)
    attempts = rt.initialize()
    runtime.install(rt)
    rt.barrier('ready', timeout_s=30.0)
    (workdir / f'ready-{cfg.process_id}').write_text(json.dumps(attempts))
    if cfg.process_id == 2:
        time.sleep(60)  # killed by the parent
    # A collective rank 2 never joins.  Gloo may raise at once ("connection
    # closed by peer") or block; either way the rank waits for the
    # runtime's monitor, which ends the process with EXIT_RANK_DEATH.
    try:
        dist.all_reduce(torch.ones(4))
    except RuntimeError:
        pass
    time.sleep(60)


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_worker(Path(sys.argv[2]))
