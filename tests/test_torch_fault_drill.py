"""The port's fault drills (``kfac_pytorch_tpu_torch.scripts.fault_drill``)
against the JAX package's ``scripts/fault_drill.py``.

* Validator parity: on every committed JAX drill artifact
  (``artifacts/{elastic,consistency,watchdog,postmortem,multiproc}_
  drill.json``), and on copies with one pinned field broken at a time,
  each port validator gives the JAX validator's verdict.  (JAX's
  ``scripts/fault_drill.py`` imports no JAX at module level.)
* ``drill_rel_err`` equals JAX's on seeded dicts, NaN and inf included,
  and the pinned constants are JAX's.
* Each of the six drills runs live on the CPU (``--device cpu``) at its
  smallest world, with JAX's step counts and bounds: elastic at worlds
  4 -> 2 -> 1, consistency, watchdog, postmortem and multiproc at two
  ranks, the health drill on one test of ``tests/test_torch_health.py``;
  the six run side by side as subprocesses, and each artifact passes the
  port's validator.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from kfac_pytorch_tpu_torch.scripts import _drill
from kfac_pytorch_tpu_torch.scripts import fault_drill as fd

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE_TIMEOUT_S = 400


@pytest.fixture(scope='module')
def jfd():
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    import fault_drill

    return fault_drill


def artifact(name):
    with open(os.path.join(REPO, 'artifacts', f'{name}_drill.json')) as fh:
        return json.load(fh)


def set_path(payload, path, value):
    node = payload
    for key in path[:-1]:
        node = node[key]
    if value is DELETE:
        del node[path[-1]]
    else:
        node[path[-1]] = value


DELETE = object()

# (drill, path into the payload, doctored value)
DOCTORED = [
    ('elastic', ('schema',), 'kfac-elastic-drill-v0'),
    ('elastic', ('schema_version',), 1),
    ('elastic', ('passed',), False),
    ('elastic', ('phases', 'resize_4_to_2'), DELETE),
    ('elastic', ('phases', 'mid_save_kill', 'ok'), False),
    ('elastic', ('phases', 'same_world_bitwise', 'bitwise_equal'), False),
    ('elastic', ('phases', 'resize_divergence', 'param_rel_err'), 0.02),
    ('elastic', ('phases', 'resize_divergence', 'param_rel_err'), None),
    ('elastic', ('phases', 'resize_divergence', 'bound'), 0.1),
    ('consistency', ('phases', 'detection', 'latency_steps'), 4),
    ('consistency', ('phases', 'detection', 'latency_steps'), 1.0),
    ('consistency', ('phases', 'repair_agreement',
                     'divergent_after_repair'), ["['layers']['x']"]),
    ('consistency', ('phases', 'trajectory_rejoin', 'param_rel_err'), 0.06),
    ('consistency', ('phases', 'trajectory_rejoin', 'bound'), 0.1),
    ('consistency', ('phases', 'trajectory_rejoin', 'unguarded_rel_err'),
     0.001),
    ('consistency', ('phases', 'injection'), DELETE),
    ('watchdog', ('phases', 'injector_invisibility',
                  'health_steps_skipped'), 1),
    ('watchdog', ('phases', 'injector_invisibility',
                  'probe_param_rel_err'), 0.005),
    ('watchdog', ('phases', 'detection', 'latency_steps'), 7),
    ('watchdog', ('phases', 'detection', 'reference_detections'), 1),
    ('watchdog', ('phases', 'rollback', 'bitwise_on_generation'), False),
    ('watchdog', ('phases', 'rollback', 'health_stamp'), 'pending'),
    ('watchdog', ('phases', 'rollback', 'target_step'), 16),
    ('watchdog', ('phases', 'trajectory_rejoin', 'param_rel_err'), 3.5),
    ('watchdog', ('phases', 'trajectory_rejoin', 'bound'), 2.0),
    ('watchdog', ('phases', 'trajectory_rejoin', 'unguarded_rel_err'), 1.0),
    ('postmortem', ('postmortems', 'victim', 'trigger', 'name'), 'atexit'),
    ('postmortem', ('postmortems', 'trigger', 'triggers'), []),
    ('postmortem', ('postmortems', 'reference', 'schema'), 'x'),
    ('postmortem', ('postmortems', 'victim'), None),
    ('postmortem', ('phases', 'bitwise_series', 'ok'), False),
    ('multiproc', ('phases', 'init_bounded', 'error'), 'TimeoutError'),
    ('multiproc', ('phases', 'init_bounded', 'elapsed_s'), 9.0),
    ('multiproc', ('phases', 'parity', 'bound'), 1e-3),
    ('multiproc', ('phases', 'parity', 'action_rel_err'), 1e-3),
    ('multiproc', ('phases', 'mp_determinism', 'bitwise_equal'), False),
    ('multiproc', ('phases', 'rank_death', 'detect_latency_s'), 30.0),
    ('multiproc', ('phases', 'rank_death', 'returncodes'), [1, -9]),
    ('multiproc', ('phases', 'rank_death', 'death_record'), None),
    ('multiproc', ('phases', 'resize_restore', 'bound'), 0.1),
    ('multiproc', ('phases', 'resize_restore', 'param_rel_err'), 0.5),
    ('multiproc', ('phases', 'consistency_mp', 'latency_steps'), 4),
    ('multiproc', ('phases', 'consistency_mp', 'repairs_total'), 2),
    ('multiproc', ('phases', 'consistency_mp', 'pre_divergence_owner'), []),
    ('multiproc', ('phases', 'consistency_mp', 'post_divergence'), ['x']),
    ('multiproc', ('phases', 'consistency_mp', 'params_agree'), False),
    ('multiproc', ('phases', 'rank_guard_wedge', 'lint_rules'), []),
    ('multiproc', ('phases', 'rank_guard_wedge', 'contrast_lint_rules'),
     ['collective-under-rank-guard']),
    ('multiproc', ('phases', 'rank_guard_wedge', 'wedged'), False),
    ('multiproc', ('phases', 'rank_guard_wedge', 'wedge_elapsed_s'), 1.0),
    ('multiproc', ('phases', 'rank_guard_wedge', 'skipping_rank_wedged'),
     True),
    ('multiproc', ('phases', 'rank_guard_wedge', 'contrast_wedged'), True),
]
DRILLS = ('elastic', 'consistency', 'watchdog', 'postmortem', 'multiproc')


def verdicts(jfd, drill, path, capsys):
    want = getattr(jfd, f'validate_{drill}_artifact')(path)
    got = getattr(fd, f'validate_{drill}_artifact')(path)
    capsys.readouterr()
    return got, want


@pytest.mark.parametrize('drill', DRILLS)
def test_committed_artifact_verdicts_match_jax(drill, jfd, capsys):
    path = os.path.join(REPO, 'artifacts', f'{drill}_drill.json')
    got, want = verdicts(jfd, drill, path, capsys)
    assert got == want == 0


@pytest.mark.parametrize('drill,path,value', DOCTORED,
                         ids=[f'{d}-{"/".join(p)}-{i}'
                              for i, (d, p, _) in enumerate(DOCTORED)])
def test_doctored_artifact_verdicts_match_jax(drill, path, value, jfd,
                                              tmp_path, capsys):
    payload = copy.deepcopy(artifact(drill))
    set_path(payload, path, value)
    out = tmp_path / f'{drill}.json'
    out.write_text(json.dumps(payload))
    got, want = verdicts(jfd, drill, str(out), capsys)
    assert got == want == 1


def test_unreadable_artifact_verdicts_match_jax(jfd, tmp_path, capsys):
    out = tmp_path / 'torn.json'
    out.write_text('{"schema": ')
    for drill in DRILLS:
        assert verdicts(jfd, drill, str(out), capsys) == (1, 1)


def test_constants_are_jax(jfd):
    names = [n for n in dir(jfd) if n.isupper() and (
        n.startswith(('CONS_', 'WD_', 'PM_', 'MP_')) or n in (
            'DRILL_SCHEMA_VERSION', 'KILL_SAVE_STEP', 'SHORT_STEPS',
            'MID_STEPS', 'FINAL_STEPS', 'KILL_AFTER_SHARDS',
            'INV_UPDATE_STEPS', 'LEG_TIMEOUT_S', 'RESIZE_REL_ERR_BOUND',
            'ELASTIC_SCHEMA', 'HEALTH_SCHEMA'))]
    assert len(names) > 50
    for name in names:
        assert getattr(_drill, name) == getattr(jfd, name), name
    from kfac_pytorch_tpu_torch import runtime

    assert _drill.MP_EXIT_RANK_DEATH == runtime.EXIT_RANK_DEATH == 87


@pytest.mark.parametrize('poison', [None, 'nan', 'inf', '-inf'])
def test_drill_rel_err_matches_jax(poison, jfd):
    rng = np.random.default_rng(7)
    for trial in range(5):
        a = {f'p{i}': rng.standard_normal((3, 4)).astype(np.float32)
             for i in range(4)}
        b = {k: v + 1e-3 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in a.items()}
        if poison is not None:
            a['p2'] = a['p2'].copy()
            a['p2'][1, 1] = float(poison)
        got, want = _drill.drill_rel_err(a, b), jfd.drill_rel_err(a, b)
        assert got == want or (np.isnan(got) and np.isnan(want))
        if poison is not None:
            assert got == float('inf')


def test_seeded_rank_guard_is_flagged_and_contrast_is_clean():
    from kfac_pytorch_tpu_torch.analysis import collective

    seeded = collective.lint_source(fd.SEEDED_RANK_GUARD_SOURCE)
    assert [f.rule for f in seeded] == [_drill.MP_RANK_GUARD_RULE]
    assert collective.lint_source(fd.UNGUARDED_BARRIER_SOURCE) == []


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(SystemExit):
        fd.main(['--elastic'])
    with pytest.raises(RuntimeError, match='--device cuda'):
        fd._device('cuda', 0, 1)


# -- the six drills, live ------------------------------------------------------

LIVE = {
    'health': ['-q', '-k', 'test_escalation_ladder_matches_jax'],
    'elastic': ['--elastic', '--worlds', '4,2,1'],
    'consistency': ['--consistency', '--world', '2'],
    'watchdog': ['--watchdog', '--world', '2'],
    'postmortem': ['--postmortem', '--world', '2'],
    'multiproc': ['--multiproc'],
}


@pytest.fixture(scope='module')
def live(tmp_path_factory):
    """Start the six drills side by side; ``wait(name)`` returns ``(rc,
    output, artifact path)``."""
    work = tmp_path_factory.mktemp('drills')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = {}
    for name, args in LIVE.items():
        out = str(work / f'{name}.json')
        procs[name] = (subprocess.Popen(
            [sys.executable, '-m', fd.MODULE, '--device', 'cpu',
             '--json-out', out, *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    done = {}

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


def test_health_drill_live(live):
    rc, text, out = live('health')
    assert rc == 0, text[-3000:]
    payload = json.load(open(out))
    assert payload['schema'] == _drill.HEALTH_SCHEMA and payload['passed']
    assert payload['config']['pytest_args'][0].endswith('test_torch_health.py')


@pytest.mark.parametrize('name', ['elastic', 'consistency', 'watchdog',
                                  'postmortem', 'multiproc'])
def test_drill_live(name, live, capsys):
    rc, text, out = live(name)
    assert rc == 0, text[-4000:]
    assert getattr(fd, f'validate_{name}_artifact')(out) == 0
    capsys.readouterr()
    payload = json.load(open(out))
    assert payload['config']['device'] == 'cpu'
    if name == 'elastic':
        phases = payload['phases']
        assert {'resize_4_to_2', 'resize_2_to_1'} <= set(phases)
        assert phases['same_world_bitwise']['max_abs_diff'] == 0.0
        lo = phases['layers_only_recompute']
        assert lo['recomputed'] and not any(
            s.startswith('bucket-') for s in lo['shards'])
    if name == 'consistency':
        assert payload['phases']['detection']['latency_steps'] == 1
        # The guard's own repair brings the parameters back together:
        # the drill re-broadcasts nothing.
        rep = payload['phases']['repair_agreement']
        assert rep['param_divergence_after'] == [] and rep['ok']
        assert 'params_resynced' not in rep
    if name == 'multiproc':
        rg = payload['phases']['rank_guard_wedge']
        assert rg['lint_rules'] == [_drill.MP_RANK_GUARD_RULE]
        assert payload['phases']['rank_death']['returncodes'] == [87, -9]
