"""The port's flight recorder, emission, aggregation and reports against
the JAX package's, on the CPU.

* Flight on against off through ``train_loop`` (an MLP with the health
  guardrails, the watchdog and the Observe monitor): parameters bitwise,
  ``last_step_info`` the same; the recorder reads its pending scalars
  back once per flush (``host_syncs`` equals the flushes: every scalar
  lies on one device).
* The port's ``postmortem.json`` passes JAX's ``validate_postmortem``
  (and the port's), periodic and after a health step-skip (a NaN batch:
  trigger ``health_step_skip``); a doctored one fails both alike.
* ``read_jsonl``, ``merge_run_dir``, ``run_payload``,
  ``divergence_summary`` and ``format_run_report`` on the port's JSONL
  shards (two processes, a torn tail, a postmortem) equal JAX's on the
  same files, and JAX's ``validate_run_payload`` passes the port's
  payload.
* The report tables (``phase_table``, ``amdahl_breakdown``,
  ``amdahl_table``) equal JAX's on the same phase times, and the port's
  ``bench_payload`` passes JAX's ``validate_bench_payload`` with the same
  fields but ``detail.env``; ``format_placement`` prints JAX's report of
  the same plan.
No test arms an ``atexit`` or SIGTERM handler.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kfac_pytorch_tpu_torch as kt
from kfac_pytorch_tpu.observe import aggregate as jagg
from kfac_pytorch_tpu.observe import emit as jemit
from kfac_pytorch_tpu.observe import flight as jflight
from kfac_pytorch_tpu.observe import report as jreport
from kfac_pytorch_tpu_torch import testing as ttest
from kfac_pytorch_tpu_torch.models import MLP
from kfac_pytorch_tpu_torch.observe import aggregate
from kfac_pytorch_tpu_torch.observe import emit
from kfac_pytorch_tpu_torch.observe import flight
from kfac_pytorch_tpu_torch.observe import FlightConfig
from kfac_pytorch_tpu_torch.observe import ObserveConfig
from kfac_pytorch_tpu_torch.observe import report

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=0.1)
STEPS = 6


def flight_config(path, **kw):
    return FlightConfig(path=str(path), window=8, flush_every=2,
                        arm_atexit=False, arm_sigterm=False, **kw)


def run(tmp_path, flight_cfg, nan_at=None):
    torch.manual_seed(0)
    model = MLP(16, (24, 10))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(8,)))
    precond = kt.KFACPreconditioner(
        model, observe=ObserveConfig(), health=kt.HealthConfig(),
        watchdog=kt.WatchdogConfig(check_every=2), flight=flight_cfg, **HP)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    loop = precond.train_loop(opt, F.cross_entropy)
    infos = []
    for t in range(STEPS):
        xb = ttest.nan_batch(x) if t == nan_at else x
        loop.step(xb, loss_args=(y,))
        infos.append({k: float(v) for k, v in
                      precond.last_step_info.items()})
    return [p.detach().clone() for p in model.parameters()], infos, precond


def test_flight_on_is_bitwise_off(tmp_path):
    off, infos_off, _ = run(tmp_path, None)
    on, infos_on, p = run(tmp_path, flight_config(tmp_path / 'pm.json'))
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert infos_on == infos_off
    rec = p.flight
    assert rec.records_total == STEPS
    flushes = STEPS // 2
    assert rec.dumps_total == flushes and rec.host_syncs == flushes


def test_postmortem_passes_the_jax_validator(tmp_path):
    path = tmp_path / 'pm.json'
    _, _, p = run(tmp_path, flight_config(path))
    payload = flight.read_postmortem(str(path))
    assert jflight.validate_postmortem(payload) == []
    assert flight.validate_postmortem(payload) == []
    assert payload['trigger']['name'] == 'periodic'
    assert [s['step'] for s in payload['steps']] == list(range(1, STEPS + 1))
    assert {'step/inv', 'step/factor'} <= set(
        payload['fingerprint']['jit_cache_keys'])
    assert payload['fingerprint']['ledger'][0]['phase'] == 'factor_allreduce'
    doctored = dict(payload, steps=[
        {k: v for k, v in s.items() if not k.startswith('health/')}
        for s in payload['steps']])
    doctored['steps'][1]['step'] = 0
    assert flight.validate_postmortem(doctored) == \
        jflight.validate_postmortem(doctored) != []


def test_health_step_skip_triggers_a_dump(tmp_path):
    path = tmp_path / 'pm.json'
    _, infos, p = run(tmp_path, flight_config(path), nan_at=2)
    assert infos[2]['health/steps_skipped'] == 1
    payload = flight.read_postmortem(str(path))
    names = [t['name'] for t in payload['triggers']]
    assert 'health_step_skip' in names
    assert jflight.validate_postmortem(payload) == []
    assert p.flight.last_dump['path'] == str(path)


# -- emission and aggregation --------------------------------------------------

def write_shards(tmp_path):
    for proc in (0, 1):
        sink = emit.JsonlSink(str(tmp_path), process=proc)
        for step in range(5):
            sink.write({'kind': 'step', 'step': step, 'time': 1.0 + step,
                        'process': proc, 'loss': 2.0 - 0.1 * step + proc * 1e-3,
                        'observe/kl_nu': 1.0,
                        'health/steps_skipped': 0})
        sink.close()
    ttest.torn_jsonl(str(tmp_path / 'observe.p1.jsonl'))
    with open(tmp_path / 'postmortem.p1.json', 'w') as fh:
        json.dump({'process': 1, 'trigger': {'name': 'periodic'},
                   'triggers': [], 'steps': [
                       {'step': 4, 'time': 5.0, 'loss': 1.6,
                        'observe/kl_nu': 1.0}]}, fh)


def test_read_jsonl_matches_jax(tmp_path):
    write_shards(tmp_path)
    path = str(tmp_path / 'observe.p1.jsonl')
    got_stats, want_stats = {}, {}
    assert emit.read_jsonl(path, stats=got_stats) == jemit.read_jsonl(
        path, stats=want_stats)
    assert got_stats == want_stats == {'torn_tail': 1}
    with pytest.raises(json.JSONDecodeError):
        emit.read_jsonl(path, strict=True)


def test_merge_and_run_payload_match_jax(tmp_path):
    write_shards(tmp_path)
    got = aggregate.merge_run_dir(str(tmp_path))
    want = jagg.merge_run_dir(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.torn_records == 1 and got.postmortems
    assert aggregate.run_payload(got) == jagg.run_payload(want)
    assert jagg.validate_run_payload(aggregate.run_payload(got)) == []
    assert aggregate.format_run_report(got) == jagg.format_run_report(want)
    assert aggregate.run_spread(got) == jagg.run_spread(want)


def test_csv_sink_matches_jax(tmp_path):
    records = [{'kind': 'step', 'step': 0, 'a': 1.0},
               {'kind': 'step', 'step': 1, 'a': 2.0, 'b': 3.0}]
    for mod, sub in ((emit, 'port'), (jemit, 'jax')):
        sink = mod.CsvSink(str(tmp_path / sub), process=0)
        for r in records:
            sink.write(r)
        sink.close()
        assert sink.dropped_keys == {'b': 1} and sink.drops_total == 1
    assert ((tmp_path / 'port' / 'observe.p0.csv').read_text()
            == (tmp_path / 'jax' / 'observe.p0.csv').read_text())


# -- reports -------------------------------------------------------------------

PHASES_S = {'capture': 0.012, 'factor_ema': 0.004, 'eigh_refresh': 0.09,
            'precondition': 0.006}


def test_report_tables_match_jax():
    assert report.phase_table(PHASES_S, 0.115) == jreport.phase_table(
        PHASES_S, 0.115)
    got = report.amdahl_breakdown(PHASES_S, 10, 100, plain_s=0.011)
    want = jreport.amdahl_breakdown(PHASES_S, 10, 100, plain_s=0.011)
    assert got == want
    assert report.amdahl_table(got) == jreport.amdahl_table(want)
    assert report.amortized_phase_share(PHASES_S, 1, 3) == \
        jreport.amortized_phase_share(PHASES_S, 1, 3)
    from kfac_pytorch_tpu import placement as jplacement

    from kfac_pytorch_tpu_torch import placement

    problem = dict(layer_names=('a', 'b', 'c'),
                   layer_dims=((64, 64), (128, 32), (33, 10)), world=4,
                   factor_update_steps=1, inv_update_steps=3,
                   flops_per_second=1e12)
    topo = dict(ici_size=2, n_groups=2, ici_gbytes_per_s=400.0,
                dcn_gbytes_per_s=40.0)
    got = report.format_placement(placement.auto_placement(
        placement.PlacementProblem(**problem), placement.PodTopology(**topo)))
    assert got == jreport.format_placement(jplacement.auto_placement(
        jplacement.PlacementProblem(**problem),
        jplacement.PodTopology(**topo)))


def test_bench_payload_passes_the_jax_validator():
    got = report.bench_payload(PHASES_S, 0.115, model='resnet50',
                               factor_update_steps=1, inv_update_steps=3)
    want = jreport.bench_payload(PHASES_S, 0.115, model='resnet50',
                                 factor_update_steps=1, inv_update_steps=3)
    assert jreport.validate_bench_payload(got) == []
    assert report.validate_bench_payload(got) == []
    env = got['detail'].pop('env')
    want['detail'].pop('env')
    assert got == want
    assert env['device'] == 'cpu' and 'nvidia_smi' in env
    bad = dict(got, detail=dict(got['detail'], total_ms=math.inf))
    assert report.validate_bench_payload(bad) == \
        jreport.validate_bench_payload(bad) != []
