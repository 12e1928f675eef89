"""The port's profile script (``kfac_pytorch_tpu_torch.scripts.
profile_step``) against the JAX package's ``scripts/profile_step.py``.

* Validator parity: on the seven committed JAX smoke artifacts, and on
  copies with one pinned field broken at a time, each port validator
  gives the JAX validator's verdict.  The port's overlap and pipeline
  artifacts carry the card's evidence where JAX's carry compiled HLO;
  on a JAX artifact the port's validators check JAX's HLO block.
* ``_adaptive_replay`` equals JAX's on the committed event traces and
  on doctored ones.
* The placement smoke's payload equals JAX's, both computed live on the
  same 4 x 8 pod with JAX's link rates and one FLOP rate passed to both
  (the packages' defaults differ; the committed file is not the
  target).
* The variant mode on ResNet-32 at a small batch on the CPU, through
  ``run_variants`` (whose batch defaults to JAX's 128); the CLI keeps
  JAX's argument errors.
* Each of the seven smokes runs live on the CPU (the overlap smoke at
  its smallest world, 4 ranks; the pipeline smoke at 2), side by side as
  subprocesses, and its own validator passes its artifact, but for three
  timing pins, claims about the device that the card holds
  (``chip_smoke.py`` phase 32): the iterative smoke's speed, the stagger
  smoke's flatness and the phase profile's sum against its total.  Here
  those three artifacts are complete, their pins that are not timings
  hold, and the two packages' validators agree on them; the ``--smoke``
  artifact passes both packages' ``validate_bench_payload``.  The
  pipeline smoke's gradients equal the synchronous tail's bit for bit;
  the overlap and pipeline validators refuse a card artifact without
  its measurement.
"""
from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys

import pytest

from kfac_pytorch_tpu_torch.scripts import profile_step as ps

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE_TIMEOUT_S = 400

ARTIFACTS = {
    'profile': ('profile_smoke.json', 'validate_artifact'),
    'stagger': ('stagger_smoke.json', 'validate_stagger_artifact'),
    'iterative': ('iterative_smoke.json', 'validate_iterative_artifact'),
    'placement': ('placement_plan.json', 'validate_placement_artifact'),
    'overlap': ('overlap_smoke.json', 'validate_overlap_artifact'),
    'pipeline': ('pipeline_smoke.json', 'validate_pipeline_artifact'),
    'adaptive': ('adaptive_smoke.json', 'validate_adaptive_artifact'),
}


@pytest.fixture(scope='module')
def jps():
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    import profile_step

    return profile_step


def load(name):
    with open(os.path.join(REPO, 'artifacts', ARTIFACTS[name][0])) as fh:
        return json.load(fh)


DELETE = object()


def edit(payload, path, value):
    node = payload
    for key in path[:-1]:
        node = node[key]
    if value is DELETE:
        del node[path[-1]]
    elif callable(value):
        node[path[-1]] = value(node[path[-1]])
    else:
        node[path[-1]] = value


DOCTORED = [
    ('profile', ('detail', 'phase_sum_vs_total'), 1.5),
    ('profile', ('detail', 'phase_sum_vs_total'), float('nan')),
    ('profile', ('detail', 'phases_ms', 'capture'), DELETE),
    ('profile', ('value',), DELETE),
    ('stagger', ('detail', 'staggered', 'p50_ms'), -1.0),
    ('stagger', ('detail', 'monolithic'), DELETE),
    ('stagger', ('detail',), lambda d: dict(d, mono_max_over_p50=3.5,
                                            stag_max_over_p50=2.0)),
    ('stagger', ('detail', 'ledger_interval_ratio'), 1.05),
    ('iterative', ('value',), 0.9),
    ('iterative', ('detail', 'shapes', 0, 'ns_warm_res'), 1.0),
    ('iterative', ('detail', 'tol'), 2.0),
    ('iterative', ('detail', 'shapes'), []),
    ('placement', ('auto_vs_best_fixed',), 1.2),
    ('placement', ('chosen', 'bytes_by_scope', 'dcn'), 0),
    ('placement', ('chosen', 'bytes_by_scope', 'ici'), 0),
    ('placement', ('auto_vs_best_fixed',), None),
    ('overlap', ('detail', 'ledger', 'exposed_on_bytes'),
     lambda v: v * 1e6),
    ('overlap', ('detail', 'ledger', 'hidden_on_bytes'), 0),
    ('overlap', ('detail', 'ledger', 'total_on_bytes'), lambda v: v + 1),
    ('overlap', ('detail', 'ledger', 'exposed_off_bytes'), None),
    ('overlap', ('detail', 'timing', 'exposed_comm_estimate_s'), None),
    ('overlap', ('detail', 'hlo', 'n_plan_overlapped'), 0),
    ('overlap', ('detail', 'hlo', 'all_ok'), False),
    ('pipeline', ('detail', 'ledger', 'hidden_on_bytes'), 0),
    ('pipeline', ('detail', 'ledger', 'total_on_bytes'), lambda v: v + 1),
    ('pipeline', ('detail', 'bucket_rows'), lambda v: v[:1]),
    ('pipeline', ('detail', 'bucket_rows', 0, 'overlapped'), False),
    ('pipeline', ('detail', 'bucket_rows', 0, 'payload_bytes'), 1),
    ('pipeline', ('detail', 'issue_order'), []),
    ('pipeline', ('detail', 'hlo', 'parity_exact'), False),
    ('pipeline', ('detail', 'hlo', 'sync_contrast_fails'), False),
    ('adaptive', ('detail', 'plateau', 'final_loss_gap'), 0.5),
    ('adaptive', ('detail', 'plateau', 'adaptive', 'refreshes'),
     lambda v: v + 1),
    ('adaptive', ('detail', 'plateau', 'adaptive', 'counters', 'skipped'),
     lambda v: v + 1),
    ('adaptive', ('value',), 0.9),
    ('adaptive', ('detail', 'plateau', 'adaptive', 'events'), []),
    ('adaptive', ('detail', 'drifting', 'adaptive', 'events', 3, 1),
     'bogus'),
    ('adaptive', ('detail', 'drifting', 'final_loss_gap'), 0.5),
]


def verdicts(jps, name, path, capsys):
    fn = ARTIFACTS[name][1]
    want = getattr(jps, fn)(path)
    got = getattr(ps, fn)(path)
    capsys.readouterr()
    return got, want


@pytest.mark.parametrize('name', sorted(ARTIFACTS))
def test_committed_artifact_verdicts_match_jax(name, jps, capsys):
    path = os.path.join(REPO, 'artifacts', ARTIFACTS[name][0])
    assert verdicts(jps, name, path, capsys) == (0, 0)


@pytest.mark.parametrize('name,path,value', DOCTORED,
                         ids=[f'{n}-{"/".join(map(str, p))}-{i}'
                              for i, (n, p, _) in enumerate(DOCTORED)])
def test_doctored_artifact_verdicts_match_jax(name, path, value, jps,
                                              tmp_path, capsys):
    payload = copy.deepcopy(load(name))
    edit(payload, path, value)
    out = tmp_path / 'doctored.json'
    out.write_text(json.dumps(payload))
    assert verdicts(jps, name, str(out), capsys) == (1, 1)


def test_constants_are_jax(jps):
    for name in ('ADAPTIVE_MIN_REDUCTION', 'ADAPTIVE_PARITY_TOL',
                 'SMOKE_SUM_TOLERANCE', 'STAGGER_MONO_SPIKE',
                 'STAGGER_FLAT_BOUND', 'STAGGER_LEDGER_TOLERANCE'):
        assert getattr(ps, name) == getattr(jps, name), name


@pytest.mark.parametrize('leg', ['plateau', 'drifting'])
@pytest.mark.parametrize('doctor', [None, 'age', 'twice', 'shard',
                                    'malformed'])
def test_adaptive_replay_matches_jax(leg, doctor, jps):
    block = load('adaptive')['detail'][leg]
    events = copy.deepcopy(block['adaptive']['events'])
    i = next(k for k, ev in enumerate(events)
             if ev[1] in ('scheduled', 'early', 'forced'))
    if doctor == 'age':
        events[i][3] = 10 ** 6
    elif doctor == 'twice':
        events.insert(i + 1, list(events[i]))
    elif doctor == 'shard':
        events[i][2] = 99
    elif doctor == 'malformed':
        events[i] = events[i][:3]
    got = ps._adaptive_replay(events, block['geometry'], leg)
    want = jps._adaptive_replay(events, block['geometry'], leg)
    assert got == want
    assert bool(got[0]) == (doctor is not None)


def close(a, b, rel=1e-12):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            close(a[k], b[k], rel) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            close(x, y, rel) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=rel, abs_tol=1e-300)
    return a == b


@pytest.mark.parametrize('flops', [1e12, 5e13])
def test_placement_payload_equals_jax_live(flops):
    from kfac_pytorch_tpu.placement import PlacementProblem
    from kfac_pytorch_tpu.placement import PodTopology
    from kfac_pytorch_tpu.placement import auto_placement
    from kfac_pytorch_tpu.placement import plan_payload as jax_payload
    from kfac_pytorch_tpu_torch.placement import plan_payload

    rates = dict(ici_gbytes_per_s=45.0, dcn_gbytes_per_s=4.5)
    got = plan_payload(ps.placement_plan(rates, flops))
    d = 1024
    dims = []
    for _ in range(12):
        dims += [(d, 3 * d), (d, d), (d, 4 * d), (4 * d, d)]
    jplan = auto_placement(PlacementProblem(
        layer_names=tuple(f'block{i // 4}/{n}' for i, n in enumerate(
            ['qkv', 'proj', 'mlp_in', 'mlp_out'] * 12)),
        layer_dims=tuple(dims), world=32, factor_update_steps=10,
        inv_update_steps=100, flops_per_second=flops,
    ), PodTopology(ici_size=8, n_groups=4, **rates))
    want = json.loads(json.dumps(jax_payload(jplan)))
    assert close(json.loads(json.dumps(got)), want), (got, want)


def test_placement_smoke_pins_at_h100_rates(tmp_path, capsys):
    """At the port's H100 link rates the smoke's scenario still makes the
    planner beat every fixed strategy with bytes on both link classes."""
    from kfac_pytorch_tpu_torch.placement import plan_payload

    out = tmp_path / 'plan.json'
    out.write_text(json.dumps(plan_payload(ps.placement_plan())))
    assert ps.validate_placement_artifact(str(out)) == 0
    capsys.readouterr()


def test_variant_mode_resnet32_cpu(one_torch_thread, jps):
    import inspect

    assert inspect.signature(ps.run_variants).parameters['batch'].default \
        is None
    assert ps.VARIANT_CONFIGS['resnet32']['batch'] == 128
    assert ps.VARIANT_CONFIGS['resnet50'] == dict(
        batch=32, image=224, classes=1000, factor=10, inv=100)
    p = ps.run_variants('resnet32', 'cpu', 2, batch=4)
    for key in ('model', 'method', 'lowrank', 'ekfac', 'cadence', 'sgd_ms',
                'phases_ms', 'amortized_ms', 'amortized_ratio', 'env'):
        assert key in p
    assert p['batch'] == 4 and p['cadence'] == {'factor': 1, 'inv': 10}
    t = p['phases_ms']
    assert set(t) == {'plain', 'factor', 'inv'}
    assert all(math.isfinite(v) and v > 0 for v in t.values())
    amort = (t['plain'] * 0 + t['factor'] * 9 + t['inv']) / 10
    assert abs(p['amortized_ms'] - amort) <= 2e-3
    assert p['kernel_launches_per_call'] == {'plain': 0.0, 'factor': 0.0,
                                             'inv': 0.0}  # CPU tensors


@pytest.mark.parametrize('argv,error', [
    (['--lowrank', '8', '--method', 'inverse', '--device', 'cpu'],
     '--lowrank requires --method eigen'),
    (['--ekfac', '--method', 'iterative', '--device', 'cpu'],
     '--ekfac requires exact eigen'),
])
def test_cli_errors_match_jax(argv, error, capsys):
    with pytest.raises(SystemExit):
        ps.main(argv)
    assert error in capsys.readouterr().err
    with pytest.raises(ValueError, match='requires'):
        ps.run_variants('resnet32', 'cpu', 1, method='inverse', lowrank=8)


def test_cuda_without_a_card_raises(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(SystemExit):
        ps.main(['--smoke'])
    assert '--device cuda' in capsys.readouterr().err


# -- the seven smokes, live ----------------------------------------------------

LIVE = {
    'profile': ['--smoke'],
    'stagger': ['--stagger-smoke'],
    'iterative': ['--iterative-smoke'],
    'placement': ['--placement-smoke'],
    'overlap': ['--overlap-smoke', '--world', '4'],
    'pipeline': ['--pipeline-smoke', '--world', '2'],
    'adaptive': ['--adaptive-smoke'],
}


@pytest.fixture(scope='module')
def live(tmp_path_factory):
    work = tmp_path_factory.mktemp('smokes')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = {}
    done = {}

    def start(name):
        out = str(work / f'{name}.json')
        procs[name] = (subprocess.Popen(
            [sys.executable, '-m', ps.MODULE, '--device', 'cpu',
             '--json-out', out, *LIVE[name]], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out)

    for name in LIVE:
        start(name)

    def wait(name):
        if name not in done:
            proc, out = procs[name]
            try:
                text, _ = proc.communicate(timeout=LIVE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
            done[name] = (proc.returncode, text, out)
        return done[name]

    yield wait
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


#: The smokes whose artifact holds a timing pin: the card holds it.
TIMED = {'iterative', 'stagger', 'profile'}


@pytest.mark.parametrize('name', sorted(set(LIVE) - TIMED))
def test_smoke_live(name, live, capsys):
    rc, text, out = live(name)
    assert rc == 0, text[-4000:]
    assert getattr(ps, ARTIFACTS[name][1])(out) == 0
    capsys.readouterr()
    payload = json.load(open(out))
    if name in ('overlap', 'pipeline'):
        card = payload['detail']['card']
        assert card['measured'] is False
        assert ps.NOT_MEASURABLE in card['reason']
        assert 'hlo' not in payload['detail']
    if name == 'pipeline':
        parity = payload['detail']['parity']
        assert parity['max_abs_diff'] == 0.0 and parity['tensors'] > 0


@pytest.mark.parametrize('name,doctor', [
    ('overlap', 'card'), ('pipeline', 'card'), ('pipeline', 'parity'),
    ('pipeline', 'no parity'),
])
def test_port_evidence_is_held(name, doctor, live, tmp_path, capsys):
    """A port artifact that says it ran on the card but carries no
    measurement is refused (off the card it may name the pin as not
    measurable); so is a pipelined precondition that is not the
    synchronous one bit for bit, or an artifact without that check."""
    rc, text, out = live(name)
    assert rc == 0, text[-4000:]
    payload = json.load(open(out))
    detail = payload['detail']
    if doctor == 'card':
        detail['device'] = 'cuda'
    elif doctor == 'parity':
        detail['parity']['max_abs_diff'] = 1e-9
    else:
        del detail['parity']
    doctored = tmp_path / 'doctored.json'
    doctored.write_text(json.dumps(payload))
    assert getattr(ps, ARTIFACTS[name][1])(str(doctored)) == 1
    capsys.readouterr()


def test_iterative_smoke_live(live, jps, capsys):
    """The iterative smoke runs on the CPU and writes a complete
    artifact whose Newton–Schulz roots converge; the port's validator
    and JAX's give one verdict on it.  Its speed pin (warm Newton–Schulz
    strictly faster than ``eigh`` on every shape) is a claim about the
    device: on this CPU it reads 0.93–1.05x at one thread and collapsed
    to 0.05x at four under a loaded test run, so the card holds it
    (``chip_smoke.py`` phase 32)."""
    rc, text, out = live('iterative')
    payload = json.load(open(out))
    got = ps.validate_iterative_artifact(out)
    want = jps.validate_iterative_artifact(out)
    printed = capsys.readouterr().out
    assert got == want == rc, text[-4000:]
    detail = payload['detail']
    assert detail['device'] == 'cpu' and len(detail['shapes']) == 3
    for entry in detail['shapes']:
        for key in ('eigh_ms', 'cholesky_ms', 'ns_cold_ms', 'ns_warm_ms'):
            assert math.isfinite(entry[key]) and entry[key] > 0
        assert entry['ns_cold_res'] <= detail['tol']
        assert entry['ns_warm_res'] <= detail['tol']
    if rc:
        assert 'is not beating eigh' in printed and printed.count(
            'iterative gate:') == 2, printed


def test_stagger_smoke_live(live, jps, capsys):
    """The stagger smoke runs on the CPU and writes both modes' step
    time distributions and the ledger's per-interval parity (within
    1%); the port's validator and JAX's give one verdict on it.  Its
    flatness pin (staggered max/p50 under 1.5 where the monolithic
    spike is 3x or more) is a timing taken beside the suite's other
    processes, so the card holds it (``chip_smoke.py`` phase 32)."""
    rc, text, out = live('stagger')
    payload = json.load(open(out))
    got = ps.validate_stagger_artifact(out)
    want = jps.validate_stagger_artifact(out)
    printed = capsys.readouterr().out
    assert got == want == rc, text[-4000:]
    detail = payload['detail']
    assert detail['device'] == 'cpu'
    for mode in ('monolithic', 'staggered'):
        for key in ('p50_ms', 'p95_ms', 'max_ms'):
            assert math.isfinite(detail[mode][key]) and detail[mode][key] > 0
    assert abs(detail['ledger_interval_ratio'] - 1.0) <= \
        ps.STAGGER_LEDGER_TOLERANCE
    if rc:
        assert 'the flatten claim' in printed and printed.count(
            'stagger gate:') == 2, printed


def test_smoke_payload_valid_under_both_packages(live, jps, capsys):
    """The ``--smoke`` payload passes both packages'
    ``validate_bench_payload`` and both validators give one verdict on
    it.  Its pin of the phases' sum within 10% of the chained total is a
    timing taken beside the suite's other processes, so the card holds
    it (``chip_smoke.py`` phase 32)."""
    from kfac_pytorch_tpu.observe.report import (
        validate_bench_payload as jax_validate,
    )
    from kfac_pytorch_tpu_torch.observe.report import validate_bench_payload

    rc, text, out = live('profile')
    payload = json.load(open(out))
    assert jax_validate(payload) == [] and validate_bench_payload(payload) == []
    got = ps.validate_artifact(out)
    want = jps.validate_artifact(out)
    printed = capsys.readouterr().out
    assert got == want == rc, text[-3000:]
    assert math.isfinite(payload['detail']['phase_sum_vs_total'])
    if rc:
        assert printed.count('phase sum vs measured total') == 2, printed
