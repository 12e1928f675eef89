"""The port's collective audit against JAX's compiled-program audit.

One spawn of 8 gloo ranks (``kfac_pytorch_tpu_torch.analysis.audit``
run as a module: no JAX in the ranks; a ``file://`` rendezvous under
``tmp_path``; joined with a time limit while this process computes the
JAX side) runs JAX's 14 lanes on JAX's ``MLP(features=(32,)*8+(10,))``
at world 8, batch 16.  The references are JAX's committed, verified
``artifacts/hlo_audit.json`` and JAX's live ``observe.costs.comm_ledger``
on the same shapes:

* the port's recorded bytes equal its own ledger per lane, program,
  class and bucket (the payload verifies);
* its ledger equals JAX's artifact rows per lane, program and pinned
  class, exactly, apart from named terms whose formulas are stated
  below (``clip_term``, ``row_count_term``, ``per_call_term`` and the two
  decomposition formulas);
* ``comm_ledger`` equals JAX's row for row on every lane's shapes;
* the bf16 element count equals JAX's ``expected_factor_elements``;
* every program's schedule digest is equal on the 8 ranks, and JAX's
  ten schedule pins hold on the port's schedules;
* seeded negatives fail by lane, rank and entry: an f32 entry where
  bf16 is declared, a rank with one extra collective, a doctored memory
  baseline.
"""
from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch.analysis import audit  # noqa: E402
from kfac_pytorch_tpu_torch.observe import costs  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

WORLD = 8
SPAWN_TIMEOUT_S = 240
JAX_PINNED = ('factor_allreduce', 'grad_col_allgather',
              'decomposition_gather')


@pytest.fixture(scope='module')
def audited(tmp_path_factory):
    """``(port payload, JAX artifact)``."""
    from test_torch_distributed import join

    out = tmp_path_factory.mktemp('audit')
    procs = audit.spawn_ranks(WORLD, str(out))
    artifact = json.loads((ROOT / 'artifacts' / 'hlo_audit.json').read_text())
    join(procs, time.time() + SPAWN_TIMEOUT_S)
    return audit.collect(str(out), WORLD), artifact


def grid(lp):
    return tuple(int(v) for v in lp['grid_rows_x_cols'].split('x'))


def clip_term(lp) -> int:
    """The port's gradient gather packs each slot's f32 kl-clip term
    beside its gradient (JAX sums it in a separate psum): ``cols * Σ_b
    seg_b * 4`` result bytes."""
    _, cols = grid(lp)
    if cols == 1:
        return 0
    return cols * sum(seg for *_, seg in lp['shapes']['buckets']) * 4


def row_count_term(lp) -> int:
    """The port's factor all-reduce carries one f64 vector of each
    layer's row count, its square and its a/g micro-batch counts:
    ``4 * n_layers * 8`` bytes."""
    return 4 * len(lp['shapes']['layers']) * 8


def per_call_term(lp, jax_lane) -> int:
    """JAX reduces one factor contribution per application, the port one
    per layer: each extra call of a layer adds its factor bytes, ``(a +
    g^2) * 4`` for the tied embedding's diagonal-A lookup and attend
    (``tied_calls`` extra calls on ``hybrid_coverage``)."""
    extra = jax_lane.get('coverage', {}).get('tied_calls', 0)
    if not extra:
        return 0
    (a, g, _), = [d for d in lp['shapes']['layers'] if d[2]]
    return extra * (a + g * g) * 4


def port_decomposition_bytes(lp) -> int:
    """The port's column gather of a full refresh: each of ``rows`` ranks'
    share padded to ``ceil(seg / rows)`` slots, a slot moving ``(a^2 +
    g^2 + g a) * 4 + 4`` bytes under eigen with prediv (``qa``, ``qg``,
    ``dgda``, ``bake_damping``) and ``(a^2 + g^2) * 4 + 24`` under the
    iterative method (the roots, four f32 residuals and bounds, an i32
    staleness pair); 0 with one row."""
    rows, _ = grid(lp)
    if rows == 1:
        return 0
    iterative = lp['shapes']['compute_method'] == 'iterative'
    total = 0
    for _, a, g, seg in lp['shapes']['buckets']:
        slot = ((a * a + g * g) * 4 + 24 if iterative
                else (a * a + g * g + g * a) * 4 + 4)
        total += rows * -(-seg // rows) * slot
    return total


def jax_decomposition_bytes(jcosts, lp, program, world) -> int:
    """JAX's pinned ``decomposition_gather``: XLA:CPU's gather of the
    ``eigh`` inputs, ``Σ ceil(L/W) W (a^2 + g^2) 4 (W-1)/W`` over the
    refreshed buckets (the stagger shard's under ``+shardK``); 0 under
    the matmul-only iterative refresh."""
    shapes = [(n, a, g) for n, a, g, _ in lp['shapes']['buckets']]
    if '+shard' in program:
        k = int(program.rsplit('shard', 1)[1])
        shapes = [tuple(s) for s in lp['shapes']['stagger_shards'][k]]
    return jcosts.eigh_input_gather_bytes(
        shapes, world, compute_method=lp['shapes']['compute_method'])


def port_class_bytes(lp, program, cls) -> int:
    return (lp['programs'][program]['collectives'].get(cls, {})
            .get('result_bytes', 0))


def test_payload_verifies(audited):
    payload, _ = audited
    assert payload['violations'] == []
    assert payload['verified'] is True
    assert audit.validate_payload(payload) == []
    assert set(payload['lanes']) == set(audit.LANES)
    assert len(payload['lanes']) == 14
    for lane, lp in payload['lanes'].items():
        assert all(r['match'] for r in lp['parity']), lane
        assert any(r['ledger_bytes'] for r in lp['parity']), lane
        # No memory on the CPU.
        assert not any('memory' in p for p in lp['programs'].values())


def test_digests_equal_across_ranks(audited):
    payload, _ = audited
    for lane, lp in payload['lanes'].items():
        for name in lp['schedule']:
            digests = {audit.schedule_digest_of(r[name]['entries'])
                       for r in lp['ranks']}
            assert len(digests) == 1, (lane, name)
        for name, inter in lp['interleaving'].items():
            assert inter['ranks_equal'], (lane, name)


def test_schedule_pins_hold(audited):
    payload, artifact = audited
    assert [(r['left'], r['right'], r['level'])
            for r in payload['schedule_pins']] == [
        (r['left'], r['right'], r['level'])
        for r in artifact['schedule_pins']]
    assert len(payload['schedule_pins']) == 10
    assert all(r['match'] for r in payload['schedule_pins'])


def test_pinned_classes_match_the_jax_artifact(audited):
    """Per lane, program and JAX-pinned class: the port's bytes, less the
    named terms, are JAX's compiled ones."""
    from kfac_pytorch_tpu.observe import costs as jcosts

    payload, artifact = audited
    assert artifact['verified'] and artifact['n_devices'] == WORLD
    checked = 0
    for lane, jlane in artifact['lanes'].items():
        lp = payload['lanes'][lane]
        assert lp['grid_rows_x_cols'] == jlane['grid_rows_x_cols'], lane
        _, cols = grid(lp)
        for row in jlane['parity']:
            cls, program = row['class'], row['program']
            if cls not in JAX_PINNED or program not in lp['programs']:
                continue
            assert row['ledger_bytes'] == row['hlo_bytes']
            got = port_class_bytes(lp, program, cls)
            if cls == 'factor_allreduce':
                want = (got - row_count_term(lp) + per_call_term(lp, jlane)
                        if got else 0)
                assert want == row['hlo_bytes'], (lane, program)
            elif row['phase'].startswith('grad_col_allgather/bucket'):
                k = int(row['phase'].rsplit('bucket', 1)[1])
                prow = [r for r in lp['pipeline'] if r['program'] == program
                        and r['bucket'] == k][0]
                seg = lp['shapes']['buckets'][[
                    b[1:3] for b in lp['shapes']['buckets']].index(
                        [int(v) for v in prow['key'][1:].split('g')])][3]
                assert costs.allgather_bytes(
                    prow['recorded_bytes'] - cols * seg * 4, cols
                ) == row['hlo_bytes'], (lane, program, k)
            elif cls == 'grad_col_allgather':
                assert costs.allgather_bytes(got - clip_term(lp), cols) == (
                    row['hlo_bytes']), (lane, program)
            else:
                assert row['hlo_bytes'] == jax_decomposition_bytes(
                    jcosts, lp, program, WORLD), (lane, program)
                if '+shard' not in program:
                    assert got == port_decomposition_bytes(lp), (
                        lane, program)
            checked += 1
    assert checked >= 80


def test_iterative_gathers_the_analytic_row(audited):
    """JAX pins zero decomposition-gather bytes under ``iterative`` (no
    ``eigh`` input to gather) and records its root reshard; the port
    gathers its roots over the column, the analytic row, where
    ``rows > 1``, and nothing under MEM-OPT, as JAX."""
    payload, artifact = audited
    hybrid = payload['lanes']['hybrid_iterative']
    assert port_class_bytes(hybrid, 'inv', 'decomposition_gather') == (
        port_decomposition_bytes(hybrid)) > 0
    rec = artifact['lanes']['hybrid_iterative']['recorded'][0]
    assert rec['class'] == 'inverse_row_allgather' and rec['hlo_bytes'] > 0
    mem = payload['lanes']['mem_opt_iterative']
    assert port_class_bytes(mem, 'inv', 'decomposition_gather') == 0


def test_comm_ledger_matches_jax_on_every_lane(audited):
    from kfac_pytorch_tpu.observe import costs as jcosts

    payload, _ = audited
    for lane, lp in payload['lanes'].items():
        rows, cols = grid(lp)
        sh = lp['shapes']
        kw = dict(
            compute_method=sh['compute_method'],
            diag_a=[d for *_, d in sh['layers']],
            factor_comm_triu_bf16=lp['wire']['compressed'],
            stagger_shard_shapes=sh['stagger_shards'],
            pipeline_grad_shapes=None,
        )
        if 'pipeline' in lp:
            by_key = {f'a{a}g{g}': (n, a, g) for n, a, g, _ in sh['buckets']}
            kw['pipeline_grad_shapes'] = [by_key[k]
                                          for k in lp['pipeline_order']]
        args = ([(n, a, g) for n, a, g, _ in sh['buckets']],
                [(a, g) for a, g, _ in sh['layers']], rows, cols)
        got = costs.comm_ledger(*args, **kw)
        want = jcosts.comm_ledger(*args, **kw)
        assert [(r.phase, r.bytes_per_device, r.payload_bytes, r.cadence)
                for r in got] == [
            (r.phase, r.bytes_per_device, r.payload_bytes, r.cadence)
            for r in want], lane


def test_bf16_elements_are_jaxs_packed_count(audited):
    payload, artifact = audited
    lp = payload['lanes']['hybrid_bf16_triu']
    jax_elements = artifact['lanes']['hybrid_bf16_triu']['programs'][
        'factor']['collectives']['factor_allreduce']['elements']
    packed = sum(int(e.split('|')[2])
                 for e, c in zip(lp['ranks'][0]['factor']['entries'],
                                 lp['ranks'][0]['factor']['classes'])
                 if c == 'factor_allreduce' and e.split('|')[1] == 'bf16')
    assert packed == lp['wire']['compressed_elements'] == jax_elements
    assert sum((a * (a + 1) + g * (g + 1)) // 2
               for a, g, _ in lp['shapes']['layers']) == jax_elements
    assert lp['programs']['factor']['collectives']['factor_allreduce'][
        'dtypes'] == ['bf16', 'f64']
    for lane, other in payload['lanes'].items():
        if lane != 'hybrid_bf16_triu':
            assert not any('bf16' in e for r in other['ranks']
                           for p in r.values() for e in p['entries']), lane


def test_lane_specific_checks(audited):
    payload, _ = audited
    lanes = payload['lanes']
    pipe = lanes['hybrid_pipeline']
    assert len(pipe['pipeline_order']) == 3
    assert all(r['async_op'] and r['before_next_tail'] and r['before_scale']
               and r['match'] for r in pipe['pipeline'])
    assert lanes['hybrid_opt']['sync_tail_passes_pipeline_test'] is False
    auto = lanes['auto_placement']
    assert auto['grid_rows_x_cols'] == '2x4'
    assert any(c['pinned'] for c in auto['containment'])
    assert all(c['ok'] for c in auto['containment'])
    # The deferred refresh's gathers are issued on the main thread, inside
    # the collecting programs.
    overlap = lanes['hybrid_overlap']
    for name in ('plain+overlap_inv', 'factor+overlap_inv'):
        inter = overlap['interleaving'][name]
        assert inter['threads'] == ['main'] and inter['ranks_equal']
        assert port_class_bytes(overlap, name, 'decomposition_gather') == (
            port_class_bytes(overlap, 'inv', 'decomposition_gather')) > 0
    wd = lanes['hybrid_watchdog']
    assert wd['ranks'][0]['watchdog_check']['entries'] == [
        'all_reduce|f64|2|g1x8']
    cons = lanes['hybrid_consistency']
    assert port_class_bytes(cons, 'plain+consistency',
                            'consistency_check') == cons['ledger'][
        'consistency_check']['payload_bytes'] > 0
    assert port_class_bytes(cons, 'plain', 'consistency_check') == 0
    for lane in ('comm_opt', 'hybrid_opt', 'mem_opt'):
        assert port_class_bytes(lanes[lane], 'plain', 'factor_allreduce') == 0
    assert port_class_bytes(lanes['comm_opt'], 'plain',
                            'grad_col_allgather') == 0
    assert port_class_bytes(lanes['mem_opt'], 'inv',
                            'decomposition_gather') == 0


def test_seeded_f32_where_bf16_is_declared_fails(audited):
    payload, _ = audited
    bad = copy.deepcopy(payload)
    prog = bad['lanes']['hybrid_bf16_triu']['ranks'][3]['factor']
    i = next(i for i, e in enumerate(prog['entries'])
             if e.split('|')[1] == 'bf16')
    prog['entries'][i] = prog['entries'][i].replace('|bf16|', '|f32|')
    errs = audit.validate_payload(bad)
    entry = prog['entries'][i]
    assert any('hybrid_bf16_triu/factor rank 3' in e and entry in e
               for e in errs), errs


def test_seeded_extra_collective_fails(audited):
    payload, _ = audited
    bad = copy.deepcopy(payload)
    prog = bad['lanes']['hybrid_opt']['ranks'][5]['plain']
    prog['entries'].append('all_reduce|f32|4|g1x8')
    prog['groups'].append(list(range(WORLD)))
    prog['classes'].append('other')
    prog['threads'].append('main')
    prog['async'].append(False)
    errs = audit.validate_payload(bad)
    n = len(prog['entries']) - 1
    assert any(e.startswith('hybrid_opt/plain: rank 5 entry '
                            f'{n} is all_reduce|f32|4|g1x8') for e in errs), \
        errs


def test_seeded_memory_baseline_fails(audited):
    payload, _ = audited
    with_memory = copy.deepcopy(payload)
    with_memory['lanes']['hybrid_opt']['programs']['inv']['memory'] = (
        [1 << 20] * WORLD)
    assert audit.check_payload(with_memory, with_memory) == []
    baseline = copy.deepcopy(with_memory)
    baseline['lanes']['hybrid_opt']['programs']['inv']['memory'][2] = (
        1 << 19)
    errs = audit.check_payload(with_memory, baseline)
    assert len(errs) == 1 and errs[0].startswith('hybrid_opt/inv rank 2: '
                                                 'peak memory'), errs


def test_validate_cli(audited, tmp_path):
    from kfac_pytorch_tpu_torch.scripts import lint_torch

    payload, _ = audited
    good = tmp_path / 'audit.json'
    good.write_text(json.dumps(payload))
    assert lint_torch.main(['--comm-audit-validate', str(good)]) == 0
    assert lint_torch.main(['--comm-audit-validate', str(good),
                            '--baseline', str(good)]) == 0
    bad = copy.deepcopy(payload)
    prog = bad['lanes']['mem_opt']['ranks'][1]['inv']
    prog['entries'].pop()
    prog['groups'].pop()
    path = tmp_path / 'bad.json'
    path.write_text(json.dumps(bad))
    assert lint_torch.main(['--comm-audit-validate', str(path)]) == 1


def test_recorder_labels_and_restores(tmp_path):
    """One process: the recorder files a collective by its innermost
    labelled caller and puts ``torch.distributed`` back on exit."""
    import datetime

    import torch
    import torch.distributed as dist

    from kfac_pytorch_tpu_torch.parallel import collectives

    before = dist.all_reduce
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/pg',
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        with audit.CollectiveRecorder() as rec:
            assert dist.all_reduce is not before
            rec.begin()
            dist.all_reduce(torch.ones(3))
            collectives.all_gather_preconditioned(
                torch.ones(2, 2, 2), torch.ones(2), dist.new_group([0]))
            rec.end('p')
        assert dist.all_reduce is before
        (p,) = rec.programs
        assert [(c.op, c.cls, c.numel, c.thread) for c in p['calls']] == [
            ('all_reduce', 'other', 3, 'main')]
    finally:
        dist.destroy_process_group()
