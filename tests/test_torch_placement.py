"""The port's ledger-driven auto-placement against the JAX package's.

``kfac_pytorch_tpu_torch.placement`` on the same inputs as
``kfac_pytorch_tpu.placement``, mirroring ``tests/test_placement.py``'s
``TestPodTopology``, ``TestLedgerScopes``, ``TestSolver``,
``TestRoundTrip``, ``TestPlanPayload`` and ``TestEngineWiring``.  Every
bandwidth and ``flops_per_second`` is passed explicitly, with the same
values to both packages, so neither package's defaults enter a
comparison:

* **topology and ledger**: ``PodTopology``'s structure, scopes and
  prices, and ``comm_ledger(topology=...)`` row for row (bytes and
  scope), with ``ledger_scalars`` and ``format_ledger`` and their
  per-scope subtotals;
* **solver**: every ``evaluate_candidate`` field within 1e-12 relative,
  and the same ``auto_placement`` fraction, assignment and
  ``plan_payload``, over 24 seeded problems and the flat, cliff,
  ``bf16_triu`` and EKFAC cases; the brute-force argmin;
* **round trip**: ``lower_plan``/``verify_assignment``, doctored
  payloads, and a payload of each package validating in the other;
* **``problem_for``**: a port preconditioner and a JAX one on the same
  model give the same problem;
* **engine**: four gloo ranks (subprocesses of this file, no JAX) run
  ``grad_worker_fraction='auto'`` on a 2 x 2 topology: the solved
  fraction is JAX's ``'auto'`` on a 4-device mesh, each step within 1e-5
  of JAX's and bitwise the port's fixed-fraction step at the plan's
  fraction; ``'auto'`` without a topology warns and takes HYBRID-OPT, a
  string other than ``'auto'`` raises, a topology of another world
  raises, and a numeric fraction with a topology scope-tags the ledger
  only.

Left out: ``TestCommittedAuditArtifact`` (the HLO audit, ``ROADMAP.md``
Queue A item 31) and ``TestBenchTopology`` (the repo-root JAX
``bench.py``'s scaling model, not in the port's bench).
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import math
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch import _native  # noqa: E402
from kfac_pytorch_tpu_torch import DistributedStrategy  # noqa: E402
from kfac_pytorch_tpu_torch import KFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch.assignment import KAISAAssignment  # noqa: E402
from kfac_pytorch_tpu_torch.models import MLP  # noqa: E402
from kfac_pytorch_tpu_torch.observe import costs  # noqa: E402
from kfac_pytorch_tpu_torch.observe import report  # noqa: E402
from kfac_pytorch_tpu_torch.placement import apply  # noqa: E402
from kfac_pytorch_tpu_torch.placement import solver  # noqa: E402
from kfac_pytorch_tpu_torch.placement import topology  # noqa: E402
from kfac_pytorch_tpu_torch.placement import PodTopology  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

#: The bandwidths and rate of every comparison (GB/s, flop/s).
ICI_GBS = 450.0
DCN_GBS = 50.0
FLOPS = 1e11
#: The rate of the GPT-sized problems: the port's default, explicit.
GPT_FLOPS = 989.0e12 * 0.30
WORLD = 4
STEPS = 3
LR = 0.1
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR)
FEATURES = (32,) * 4 + (10,)
SPAWN_TIMEOUT_S = 180
REL = 1e-12


def jax_placement():
    import kfac_pytorch_tpu.placement as jp

    return jp


def topo_pair(ici_size, n_groups, ici=ICI_GBS, dcn=DCN_GBS):
    kw = dict(ici_size=ici_size, n_groups=n_groups, ici_gbytes_per_s=ici,
              dcn_gbytes_per_s=dcn)
    return PodTopology(**kw), jax_placement().PodTopology(**kw)


def flat_pair(world, bw):
    return (PodTopology.flat(world, bw),
            jax_placement().PodTopology.flat(world, bw))


def problem_pair(**kw):
    kw.setdefault('flops_per_second', FLOPS)
    return (solver.PlacementProblem(**kw),
            jax_placement().PlacementProblem(**kw))


def tiny_problem(world=8, **kw):
    dims = ((64, 64),) * 5 + ((128, 32),) * 2 + ((64, 10),)
    defaults = dict(
        layer_names=tuple(f'l{i}' for i in range(len(dims))),
        layer_dims=dims, world=world, factor_update_steps=1,
        inv_update_steps=10, flops_per_second=FLOPS,
    )
    defaults.update(kw)
    return defaults


def gpt_problem(world=32, blocks=12, d=1024, **kw):
    dims = []
    for _ in range(blocks):
        dims += [(d, 3 * d), (d, d), (d, 4 * d), (4 * d, d)]
    defaults = dict(
        layer_names=tuple(f'l{i}' for i in range(len(dims))),
        layer_dims=tuple(dims), world=world, factor_update_steps=10,
        inv_update_steps=100, flops_per_second=GPT_FLOPS,
    )
    defaults.update(kw)
    return defaults


def seeded_problem(seed):
    """A random problem and topology: world, layer dims, cadence, method
    and options drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    ici_size = int(rng.choice([1, 2, 4, 8]))
    n_groups = int(rng.choice([1, 2, 3, 4]))
    world = ici_size * n_groups
    n = int(rng.integers(1, 14))
    dims = tuple((int(rng.integers(3, 600)), int(rng.integers(2, 600)))
                 for _ in range(n))
    method = str(rng.choice(['eigen', 'inverse', 'iterative']))
    colocate = bool(rng.random() < 0.7)
    kw = dict(
        layer_names=tuple(f'layer{i}' for i in range(n)),
        layer_dims=dims, world=world,
        factor_update_steps=int(rng.integers(1, 6)),
        inv_update_steps=int(rng.integers(1, 30)),
        compute_method=method,
        prediv=bool(rng.random() < 0.5) and colocate,
        ekfac=method == 'eigen' and bool(rng.random() < 0.3),
        diag_a=tuple(bool(rng.random() < 0.15) for _ in range(n)),
        call_counts=tuple(int(rng.integers(1, 3)) for _ in range(n)),
        triu_bf16=(tuple(bool(rng.random() < 0.5) for _ in range(n))
                   if rng.random() < 0.4 else None),
        assignment_strategy=str(rng.choice(['compute', 'memory'])),
        colocate_factors=colocate,
        factor_itemsize=int(rng.choice([2, 4])),
        inv_itemsize=int(rng.choice([2, 4])),
        flops_per_second=float(10 ** rng.uniform(9, 15)),
        adaptive=bool(rng.random() < 0.3),
    )
    bw = (float(rng.uniform(10, 900)), float(rng.uniform(1, 100)))
    return kw, (ici_size, n_groups) + bw


def assert_candidates_equal(got, want):
    for field in ('grad_workers', 'n_cols', 'fraction', 'strategy',
                  'bytes_by_scope', 'scopes', 'assignment'):
        g, w = getattr(got, field), getattr(want, field)
        assert (dict(g) if isinstance(g, dict) else g) == w, field
    for field in ('comm_seconds', 'compute_seconds', 'interval_seconds',
                  'decomp_makespan_flops', 'precond_makespan_flops'):
        g, w = getattr(got, field), getattr(want, field)
        assert math.isclose(g, w, rel_tol=REL, abs_tol=0.0), (field, g, w)


def assert_plans_equal(got, want):
    assert got.fraction == want.fraction
    assert got.grad_workers == want.grad_workers
    assert got.n_cols == want.n_cols
    assert got.assignment == want.assignment
    assert got.strategy == want.strategy
    assert len(got.candidates) == len(want.candidates)
    for g, w in zip(got.candidates, want.candidates):
        assert_candidates_equal(g, w)
    assert_candidates_equal(got.flat_predicted, want.flat_predicted)
    jp = jax_placement()
    assert json.loads(json.dumps(apply.plan_payload(got))) == json.loads(
        json.dumps(jp.plan_payload(want)))


# ----------------------------------------------------------------------
# PodTopology
# ----------------------------------------------------------------------


class TestPodTopology:
    def test_structure_matches_jax(self):
        t, j = topo_pair(4, 2)
        assert t.world == j.world == 8
        assert [t.group_of(r) for r in range(8)] == [
            j.group_of(r) for r in range(8)]
        assert t.groups() == j.groups() == (
            frozenset({0, 1, 2, 3}), frozenset({4, 5, 6, 7}))
        assert t.link_for(0, 0) == j.link_for(0, 0) == 'ici'
        assert t.link_for(0, 1) == j.link_for(0, 1) == 'dcn'
        assert t.describe() == j.describe()
        assert str(t) == str(j)
        for w in (4, 16, 64):
            assert t.with_world(w).describe() == j.with_world(w).describe()
        with pytest.raises(ValueError, match='whole ICI groups'):
            t.with_world(10)

    def test_scopes_and_prices_match_jax(self):
        t, j = topo_pair(4, 2, ici=40.0, dcn=4.0)
        sets = ([0, 1, 2, 3], [4, 7], [3, 4], range(8))
        for ranks in sets:
            assert t.scope_of(ranks) == j.scope_of(ranks)
            assert t.ring_allreduce_seconds(1 << 20, ranks) == (
                j.ring_allreduce_seconds(1 << 20, ranks))
            assert t.allgather_seconds(123457, ranks) == (
                j.allgather_seconds(123457, ranks))
        assert t.scope_of_sets([[0, 1], [4, 5]]) == 'ici'
        assert t.scope_of_sets([[0, 1], [3, 4]]) == 'dcn'
        assert t.scope_of_sets([]) == 'ici'
        for scope in ('ici', 'dcn', 'flat'):
            assert t.bandwidth(scope) == j.bandwidth(scope)
        intra = t.ring_allreduce_seconds(1 << 20, [0, 1, 2, 3])
        cross = t.ring_allreduce_seconds(1 << 20, [2, 3, 4, 5])
        assert cross == pytest.approx(10 * intra)

    def test_flat_special_case_matches_flat_model(self):
        bw = 40.0
        t = PodTopology.flat(8, bw)
        payload = 123456
        assert t.scope_of(range(8)) == 'ici'
        assert t.ring_allreduce_seconds(payload, range(8)) == (
            costs.ring_allreduce_bytes(payload, 8) / (bw * 1e9))
        assert t.allgather_seconds(payload, range(8)) == (
            costs.allgather_bytes(payload, 8) / (bw * 1e9))

    def test_defaults_are_the_h100_data_sheet(self):
        t = PodTopology(ici_size=8, n_groups=2)
        assert (t.ici_gbytes_per_s, t.dcn_gbytes_per_s) == (450.0, 50.0)
        assert PodTopology.flat(4).dcn_gbytes_per_s == 450.0
        assert solver.DEFAULT_FLOPS_PER_SECOND == 989.0e12 * 0.30

    def test_validation(self):
        with pytest.raises(ValueError, match='ici_size'):
            PodTopology(ici_size=0, n_groups=2)
        with pytest.raises(ValueError, match='bandwidths'):
            PodTopology(ici_size=2, n_groups=2, dcn_gbytes_per_s=0)
        t = PodTopology(ici_size=2, n_groups=2)
        with pytest.raises(ValueError, match='outside world'):
            t.group_of(4)
        with pytest.raises(ValueError, match='unknown link scope'):
            t.bandwidth('nvlink')

    def test_grid_rank_sets_match_kaisa_partitions(self):
        from kfac_pytorch_tpu.placement import topology as jtopology

        for rows, cols in [(2, 4), (4, 2), (1, 8), (8, 1)]:
            world = rows * cols
            assert set(map(frozenset, topology.grid_col_ranks(rows, cols))) \
                == KAISAAssignment.partition_grad_workers(world, rows)
            assert set(map(frozenset, topology.grid_row_ranks(rows, cols))) \
                == KAISAAssignment.partition_grad_receivers(world, rows)
            assert topology.grid_col_ranks(rows, cols) == (
                jtopology.grid_col_ranks(rows, cols))
            assert topology.grid_row_ranks(rows, cols) == (
                jtopology.grid_row_ranks(rows, cols))


# ----------------------------------------------------------------------
# scope-tagged ledger
# ----------------------------------------------------------------------


LEDGER_CASES = [
    # (rows, cols, ici_size, n_groups, options)
    (2, 4, 4, 2, {}),
    (4, 2, 4, 2, {}),
    (2, 4, 8, 1, {}),
    (8, 1, 2, 4, dict(stagger_shard_shapes=[[(8, 64, 64)], [(4, 64, 64)]])),
    (1, 8, 4, 2, dict(pipeline_grad_shapes=[(8, 64, 64), (4, 32, 64)],
                      overlap_comm=True)),
    (2, 2, 2, 2, dict(consistency_cadence=5, watchdog_cadence=2,
                      adaptive=True, ekfac=True)),
]


class TestLedgerScopes:
    def make(self, rows, cols, topo, **kw):
        return costs.comm_ledger(
            [(8, 64, 64)], [(60, 60)] * 6, rows, cols, topology=topo, **kw)

    @pytest.mark.parametrize('case', range(len(LEDGER_CASES)))
    def test_rows_match_jax(self, case):
        from kfac_pytorch_tpu.observe import costs as jcosts

        rows, cols, ici_size, n_groups, kw = LEDGER_CASES[case]
        t, j = topo_pair(ici_size, n_groups)
        args = ([(8, 64, 64), (4, 32, 64)], [(60, 60)] * 6 + [(30, 50)] * 2,
                rows, cols)
        got = costs.comm_ledger(*args, topology=t, **kw)
        want = jcosts.comm_ledger(*args, topology=j, **kw)
        assert [dataclasses.asdict(r) for r in got] == [
            dataclasses.asdict(r) for r in want]
        assert costs.ledger_scalars(got) == jcosts.ledger_scalars(want)
        cadence = dict(factor_update_steps=1, inv_update_steps=10,
                       consistency_steps=5, watchdog_steps=2)
        assert costs.format_ledger(got, **cadence) == (
            jcosts.format_ledger(want, **cadence))

    def test_scopes_on_2x4(self):
        t, _ = topo_pair(4, 2)
        by_phase = {r.phase: r for r in self.make(2, 4, t)}
        assert by_phase['factor_allreduce'].scope == 'dcn'
        assert by_phase['grad_col_allgather'].scope == 'ici'
        assert by_phase['inverse_row_allgather'].scope == 'dcn'
        assert by_phase['checkpoint'].scope == 'host'

    def test_single_group_is_all_ici(self):
        t, _ = topo_pair(8, 1)
        for row in self.make(2, 4, t):
            if row.collective != 'host':
                assert row.scope == 'ici'

    def test_bytes_invariant_under_tagging(self):
        t, _ = topo_pair(4, 2)
        tagged = self.make(2, 4, t)
        flat = self.make(2, 4, None)
        assert [r.bytes_per_device for r in tagged] == [
            r.bytes_per_device for r in flat]
        assert all(r.scope == 'flat' for r in flat
                   if r.collective != 'host')

    def test_world_mismatch_raises(self):
        with pytest.raises(ValueError, match='topology world'):
            self.make(2, 2, topo_pair(4, 2)[0])

    def test_ledger_scalars_subtotals(self):
        t, _ = topo_pair(4, 2)
        rows = self.make(2, 4, t)
        scal = costs.ledger_scalars(rows)
        assert scal['observe/comm/link/ici_bytes'] == sum(
            r.bytes_per_device for r in rows if r.scope == 'ici')
        assert scal['observe/comm/link/dcn_bytes'] == sum(
            r.bytes_per_device for r in rows if r.scope == 'dcn')
        assert not any('comm/link/' in k for k in
                       costs.ledger_scalars(self.make(2, 4, None)))
        text = costs.format_ledger(rows, 1, 10)
        assert 'subtotal/dcn' in text and 'subtotal/ici' in text


# ----------------------------------------------------------------------
# solver
# ----------------------------------------------------------------------


class TestSolver:
    @pytest.mark.parametrize('seed', range(24))
    def test_seeded_problems_match_jax(self, seed):
        jp = jax_placement()
        kw, (ici_size, n_groups, ici, dcn) = seeded_problem(seed)
        p, jpr = problem_pair(**kw)
        t, j = topo_pair(ici_size, n_groups, ici=ici, dcn=dcn)
        for rows in solver.candidate_grad_workers(p.world):
            assert_candidates_equal(
                solver.evaluate_candidate(p, t, rows),
                jp.evaluate_candidate(jpr, j, rows))
        assert_plans_equal(solver.auto_placement(p, t),
                           jp.auto_placement(jpr, j))

    @pytest.mark.parametrize('case', ['flat_compute', 'flat_comm', 'cliff',
                                      'bf16_triu', 'ekfac', 'gpt_pod'])
    def test_named_cases_match_jax(self, case):
        jp = jax_placement()
        if case == 'flat_compute':
            kw, topos = tiny_problem(flops_per_second=1e9), flat_pair(8,
                                                                      1000.0)
        elif case == 'flat_comm':
            kw, topos = tiny_problem(flops_per_second=1e18), flat_pair(
                8, 0.001)
        elif case == 'cliff':
            kw = gpt_problem(factor_update_steps=1, inv_update_steps=10)
            topos = topo_pair(8, 4)
        elif case == 'bf16_triu':
            kw, topos = tiny_problem(triu_bf16=(True,) * 8), topo_pair(4, 2)
        elif case == 'ekfac':
            kw, topos = tiny_problem(ekfac=True), topo_pair(4, 2)
        else:
            kw, topos = gpt_problem(), topo_pair(8, 4)
        p, jpr = problem_pair(**kw)
        plan = solver.auto_placement(p, topos[0])
        assert_plans_equal(plan, jp.auto_placement(jpr, topos[1]))
        if case == 'flat_compute':
            assert plan.strategy == 'mem_opt'
            assert plan.fraction == pytest.approx(1 / 8)
        elif case == 'flat_comm':
            assert plan.strategy == 'comm_opt' and plan.fraction == 1.0

    def test_dcn_cliff_flips_the_choice(self):
        p, _ = problem_pair(**gpt_problem(factor_update_steps=1,
                                          inv_update_steps=10))
        flat = solver.auto_placement(p, flat_pair(32, ICI_GBS)[0])
        pod = solver.auto_placement(p, topo_pair(8, 4)[0])
        assert flat.grad_workers != pod.grad_workers

    def test_candidates_and_names(self):
        assert solver.candidate_grad_workers(8) == [1, 2, 4, 8]
        assert solver.candidate_grad_workers(12) == [1, 2, 3, 4, 6, 12]
        assert solver.candidate_grad_workers(1) == [1]
        assert solver.strategy_name_of(8, 8) == 'comm_opt'
        assert solver.strategy_name_of(1, 8) == 'mem_opt'
        assert solver.strategy_name_of(4, 8) == 'hybrid_opt'
        assert solver.strategy_name_of(2, 8) == 'auto'

    def test_brute_force_parity(self):
        p, _ = problem_pair(**tiny_problem(world=8))
        t, _ = topo_pair(4, 2)
        plan = solver.auto_placement(p, t)
        evals = {rows: solver.evaluate_candidate(p, t, rows)
                 for rows in solver.candidate_grad_workers(8)}
        assert {e.grad_workers for e in plan.candidates} == set(evals)
        best = min(evals.values(), key=lambda c: (
            c.interval_seconds, c.bytes_by_scope.get('dcn', 0),
            -c.fraction))
        assert plan.grad_workers == best.grad_workers
        assert plan.predicted.interval_seconds == best.interval_seconds
        for c in plan.candidates:
            assert plan.predicted.interval_seconds <= c.interval_seconds

    def test_evaluate_candidate_arithmetic_anchor(self):
        p = solver.PlacementProblem(
            layer_names=('l0',), layer_dims=((64, 64),), world=2,
            factor_update_steps=1, inv_update_steps=1,
            flops_per_second=1e12)
        bw = 10.0
        t = PodTopology.flat(2, bw)
        c = solver.evaluate_candidate(p, t, 2)
        ledger = costs.comm_ledger(
            solver.bucket_shapes_for(p.layer_dims, 1), p.layer_dims, 2, 1,
            topology=t)
        by_phase = {r.phase: r for r in ledger}
        want = (by_phase['factor_allreduce'].bytes_per_device
                + by_phase['inverse_row_allgather'].bytes_per_device
                + by_phase['grad_col_allgather'].bytes_per_device) / (
                    bw * 1e9)
        assert c.comm_seconds == pytest.approx(want)
        assert c.decomp_makespan_flops == pytest.approx(2 * 9.0 * 64 ** 3)
        assert c.precond_makespan_flops == pytest.approx(4 * 2 * 64 ** 3)

    def test_the_solve_runs_the_native_planner(self):
        p, _ = problem_pair(**tiny_problem(world=8))
        before = _native.calls
        solver.auto_placement(p, topo_pair(4, 2)[0])
        # One greedy per candidate grid and one for the flat price.
        assert _native.calls - before == 4 + 1

    def test_bad_inputs(self):
        p, _ = problem_pair(**tiny_problem(world=8))
        t, _ = topo_pair(4, 2)
        with pytest.raises(ValueError, match='does not divide'):
            solver.evaluate_candidate(p, t, 3)
        with pytest.raises(ValueError, match='topology world'):
            solver.evaluate_candidate(p, topo_pair(4, 1)[0], 2)
        with pytest.raises(ValueError, match='unknown objective'):
            solver.auto_placement(p, t, objective='fastest')
        with pytest.raises(ValueError, match='no layers'):
            solver.PlacementProblem(
                layer_names=(), layer_dims=(), world=8,
                factor_update_steps=1, inv_update_steps=1)
        with pytest.raises(ValueError, match='unknown ledger cadence'):
            costs.cadence_events_per_step('health_step', 1, 10)


# ----------------------------------------------------------------------
# round trip and payload
# ----------------------------------------------------------------------


class TestRoundTrip:
    def plan(self):
        p, _ = problem_pair(**tiny_problem(world=8))
        return solver.auto_placement(p, topo_pair(4, 2)[0])

    def test_lower_plan_matches_and_satisfies_invariants(self):
        plan = self.plan()
        asg = apply.lower_plan(plan)
        assert asg.grad_workers == plan.grad_workers
        assert asg.world_size == plan.problem.world
        assert plan.grad_workers * plan.n_cols == plan.problem.world
        cols = set(map(frozenset, topology.grid_col_ranks(
            plan.grad_workers, plan.n_cols)))
        for layer in plan.problem.layer_names:
            for factor in asg.get_factors(layer):
                w = asg.inv_worker(layer, factor)
                assert 0 <= w < plan.problem.world
                assert w == plan.assignment[layer][factor]
                group = asg.grad_worker_group(layer)
                assert w in group and frozenset(group) in cols
                assert plan.layer_column(layer) == w % plan.n_cols

    def test_lower_plan_names_divergence(self):
        plan = self.plan()
        doctored = {k: dict(v) for k, v in plan.assignment.items()}
        layer = plan.problem.layer_names[0]
        doctored[layer]['A'] = (doctored[layer]['A'] + 1) % 8
        bad = dataclasses.replace(plan, assignment=doctored)
        with pytest.raises(AssertionError, match=layer) as excinfo:
            apply.lower_plan(bad)
        assert 'grid column' in str(excinfo.value)


class TestPlanPayload:
    @pytest.fixture()
    def plans(self):
        p, jpr = problem_pair(**gpt_problem())
        t, j = topo_pair(8, 4)
        return (solver.auto_placement(p, t),
                jax_placement().auto_placement(jpr, j))

    def test_payloads_validate_across_packages(self, plans):
        plan, jplan = plans
        jp = jax_placement()
        payload = json.loads(json.dumps(apply.plan_payload(plan)))
        jpayload = json.loads(json.dumps(jp.plan_payload(jplan)))
        assert apply.validate_plan_payload(payload) == []
        assert jp.validate_plan_payload(payload) == []
        assert apply.validate_plan_payload(jpayload) == []
        assert payload == jpayload

    def test_doctored_payloads_fail(self, plans):
        payload = json.loads(json.dumps(apply.plan_payload(plans[0])))
        missing = dict(payload)
        del missing['chosen']
        assert any('chosen' in p for p in
                   apply.validate_plan_payload(missing))
        not_argmin = json.loads(json.dumps(payload))
        not_argmin['chosen']['interval_seconds'] = max(
            c['interval_seconds'] for c in payload['candidates']) * 2
        assert any('argmin' in p for p in
                   apply.validate_plan_payload(not_argmin))
        negative = json.loads(json.dumps(payload))
        negative['chosen']['bytes_by_scope']['dcn'] = -1
        assert apply.validate_plan_payload(negative)

    def test_format_and_scalars_match_jax(self, plans):
        plan, jplan = plans
        jp = jax_placement()
        text = apply.format_placement(plan)
        assert text == jp.format_placement(jplan)
        assert report.format_placement(plan) == text
        assert 'chosen:' in text and f'{plan.grad_workers}x{plan.n_cols}' \
            in text
        scal = apply.placement_scalars(plan)
        assert scal == jp.placement_scalars(jplan)
        assert scal['placement/interval_bytes/dcn'] > 0
        assert plan.strategy == 'auto'
        assert plan.predicted.interval_seconds < (
            plan.best_fixed().interval_seconds)
        assert plan.predicted.scopes['grad_col_allgather'] == 'ici'


# ----------------------------------------------------------------------
# problem_for on a registered preconditioner
# ----------------------------------------------------------------------


PROBLEM_VARIANTS = {
    'default': {},
    'cadence': dict(factor_update_steps=2, inv_update_steps=7),
    'inverse': dict(compute_method='inverse'),
    'ekfac': dict(ekfac=True),
    'memory_split': dict(assignment_strategy='memory',
                         colocate_factors=False,
                         compute_eigenvalue_outer_product=False),
}


@pytest.mark.parametrize('variant', sorted(PROBLEM_VARIANTS))
def test_problem_for_matches_jax(variant):
    import jax
    from jax.sharding import Mesh

    from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    kw = dict(HP, **PROBLEM_VARIANTS[variant])
    x = np.random.default_rng(0).standard_normal((8, 32)).astype(np.float32)
    jmodel = JaxMLP(features=FEATURES)
    jprecond = JaxPreconditioner(
        jmodel, loss_fn=lambda out, y: out.sum(),
        mesh=Mesh(np.array(jax.devices()[:1]), ('data',)), **kw)
    jprecond.init(jmodel.init(jax.random.PRNGKey(0), x), x)
    precond = KFACPreconditioner(MLP(32, FEATURES), **kw)
    got = solver.problem_for(precond, flops_per_second=FLOPS)
    want = jax_placement().problem_for(jprecond, flops_per_second=FLOPS)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_report_and_ledger_of_a_numeric_engine():
    precond = KFACPreconditioner(MLP(32, FEATURES), **HP)
    assert precond.topology is None and precond.placement_plan is None
    with pytest.raises(ValueError, match='no placement plan'):
        precond.placement_report()
    assert all(r.scope in ('flat', 'host') for r in costs.ledger_for(precond))


def test_bad_fraction_string_and_topology_type_raise():
    with pytest.raises(ValueError, match="'auto'"):
        KFACPreconditioner(MLP(32, FEATURES), grad_worker_fraction='fastest')
    with pytest.raises(TypeError, match='PodTopology'):
        KFACPreconditioner(MLP(32, FEATURES), topology=object())
    with pytest.raises(ValueError, match='data world'):
        KFACPreconditioner(MLP(32, FEATURES), grad_worker_fraction='auto',
                           topology=PodTopology(ici_size=2, n_groups=2))
    # compile_budget (item 31) is ported: it attaches the retrace guard.
    precond = KFACPreconditioner(MLP(32, FEATURES), compile_budget=4)
    assert precond.retrace_guard.budget == 4


# ----------------------------------------------------------------------
# engine wiring: four gloo ranks against the JAX mesh
# ----------------------------------------------------------------------


def data() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=16).astype(np.int32)
    return x, y


def train(precond, model, ddp, xl, yl, applied):
    out = []
    for step in range(STEPS):
        model.zero_grad()
        F.cross_entropy(ddp(xl), yl).backward()
        precond.step()
        out.append({n: p.grad.clone() for n, p in model.named_parameters()})
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * applied[step][n]
    return out


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    # Both packages price compute at FLOPS (the 'auto' path takes the
    # solver's default otherwise).
    solver.problem_of = functools.partial(solver.problem_of,
                                          flops_per_second=FLOPS)
    weights = torch.load(out / 'init.pt')
    applied = torch.load(out / 'ref_grads.pt')
    x, y = data()
    q = len(x) // world
    xl = torch.from_numpy(x[rank * q:(rank + 1) * q])
    yl = torch.from_numpy(y[rank * q:(rank + 1) * q]).long()
    topo = PodTopology(ici_size=2, n_groups=2, ici_gbytes_per_s=ICI_GBS,
                       dcn_gbytes_per_s=DCN_GBS)

    def engine(**kw):
        model = MLP(32, FEATURES)
        model.load_state_dict(weights)
        ddp = torch.nn.parallel.DistributedDataParallel(model)
        return model, ddp, KFACPreconditioner(ddp, **HP, **kw)

    res = {}
    before = _native.calls
    model, ddp, auto = engine(grad_worker_fraction='auto', topology=topo)
    res['native_calls'] = _native.calls - before
    plan = auto.placement_plan
    res['fraction'] = auto.grad_worker_fraction
    res['strategy'] = auto.distributed_strategy.name
    res['grid'] = (auto.grid.rows, auto.grid.cols)
    res['payload'] = json.dumps(apply.plan_payload(plan), sort_keys=True)
    res['host_payload'] = json.dumps(apply.plan_payload(
        solver.auto_placement(solver.problem_for(
            auto, flops_per_second=FLOPS), topo)),
        sort_keys=True)
    res['assignment'] = {layer: {f: auto.assignment.inv_worker(layer, f)
                                 for f in auto.assignment.get_factors(layer)}
                         for layer in auto.assignment.get_layers()}
    res['report'] = auto.placement_report()
    res['descriptor'] = auto._topology_descriptor()
    res['auto'] = train(auto, model, ddp, xl, yl, applied)
    model, ddp, fixed = engine(grad_worker_fraction=plan.fraction)
    res['fixed'] = train(fixed, model, ddp, xl, yl, applied)
    res['fixed_grid'] = (fixed.grid.rows, fixed.grid.cols)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        _, _, hybrid = engine(grad_worker_fraction='auto')
    res['fallback'] = ([str(w.message) for w in caught],
                       hybrid.grad_worker_fraction,
                       hybrid.distributed_strategy.name,
                       hybrid.placement_plan)
    _, _, numeric = engine(
        grad_worker_fraction=DistributedStrategy.HYBRID_OPT, topology=topo)
    res['numeric_scopes'] = {r.phase: r.scope
                             for r in costs.ledger_for(numeric)}
    res['numeric_plan'] = numeric.placement_plan
    try:
        numeric.placement_report()
        res['numeric_report'] = 'no error'
    except ValueError as exc:
        res['numeric_report'] = str(exc)
    try:
        engine(grad_worker_fraction='auto',
               topology=PodTopology(ici_size=4, n_groups=2))
        res['mismatch'] = 'no error'
    except ValueError as exc:
        res['mismatch'] = str(exc)
    torch.save(res, out / f'rank{rank}.pt')
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """``(JAX 'auto' engine results, per-rank port results)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import flax.linen as fnn

    import kfac_pytorch_tpu.placement.solver as jsolver
    from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from test_torch_distributed import join
    from test_torch_distributed import spawn

    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    out = tmp_path_factory.mktemp('placement')
    x, y = data()
    jmodel = JaxMLP(features=FEATURES)
    variables = jax.tree.map(np.asarray, fnn.meta.unbox(
        jmodel.init(jax.random.PRNGKey(5), x)))
    torch.save(flax_to_torch_state_dict(variables), out / 'init.pt')

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ('data',))
    shard = NamedSharding(mesh, P('data'))
    saved = jsolver.problem_for
    jsolver.problem_for = functools.partial(saved, flops_per_second=FLOPS)
    try:
        precond = JaxPreconditioner(
            jmodel, loss_fn=xent, mesh=mesh, grad_worker_fraction='auto',
            topology=jax_placement().PodTopology(
                ici_size=2, n_groups=2, ici_gbytes_per_s=ICI_GBS,
                dcn_gbytes_per_s=DCN_GBS),
            **HP)
        state = precond.init(variables, x)
    finally:
        jsolver.problem_for = saved
    params = variables['params']
    grads_by_step = []
    for _ in range(STEPS):
        _, _, grads, state = precond.step(
            {'params': params}, state, jax.device_put(x, shard),
            loss_args=(jax.device_put(jnp.asarray(y), shard),))
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        grads_by_step.append(flax_to_torch_state_dict({'params': grads}))
    torch.save(grads_by_step, out / 'ref_grads.pt')
    ref = dict(fraction=precond.grad_worker_fraction,
               payload=jax_placement().plan_payload(precond.placement_plan),
               grads=grads_by_step)
    join(spawn(__file__, WORLD, out), time.time() + SPAWN_TIMEOUT_S)
    return ref, [torch.load(out / f'rank{r}.pt') for r in range(WORLD)]


def test_auto_fraction_matches_jax_mesh(runs):
    ref, ranks = runs
    # The cadence prices the grid away from HYBRID-OPT.
    assert ref['fraction'] == 0.25
    payload = json.dumps(ref['payload'], sort_keys=True)
    for r in ranks:
        assert r['fraction'] == ref['fraction']
        assert r['strategy'] == 'MEM_OPT' and r['grid'] == (1, 4)
        assert json.loads(r['payload']) == json.loads(payload)
        assert r['payload'] == r['host_payload']
        assert r['native_calls'] >= 3
        assert {layer: row['inv_workers'] for layer, row
                in ref['payload']['per_layer'].items()} == r['assignment']


def test_auto_steps_match_jax_and_the_fixed_fraction(runs):
    ref, ranks = runs
    for r in ranks:
        assert r['fixed_grid'] == r['grid']
        for step in range(STEPS):
            for name, want in ref['grads'][step].items():
                got = r['auto'][step][name]
                assert torch.equal(got, r['fixed'][step][name]), name
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                    err_msg=f'step {step} {name}')


def test_auto_report_and_descriptor(runs):
    _, ranks = runs
    for r in ranks:
        assert 'chosen: 1x4 grid' in r['report']
        assert 'subtotal/dcn' in r['report']
        assert r['descriptor'].endswith(
            f' pod=2x2 pod ({ICI_GBS:g} GB/s ICI, {DCN_GBS:g} GB/s DCN)')


def test_auto_without_topology_falls_back_hybrid(runs):
    _, ranks = runs
    for r in ranks:
        messages, fraction, strategy, plan = r['fallback']
        assert any('HYBRID' in m for m in messages)
        assert (fraction, strategy, plan) == (0.5, 'HYBRID_OPT', None)


def test_numeric_with_topology_tags_ledger_only(runs):
    _, ranks = runs
    for r in ranks:
        assert r['numeric_plan'] is None
        assert 'no placement plan' in r['numeric_report']
        scopes = r['numeric_scopes']
        assert scopes['grad_col_allgather'] == 'ici'
        assert scopes['inverse_row_allgather'] == 'dcn'
        assert scopes['factor_allreduce'] == 'dcn'
        assert scopes['checkpoint'] == 'host'


def test_topology_world_mismatch_raises(runs):
    _, ranks = runs
    for r in ranks:
        assert 'data world is 4' in r['mismatch']


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    _, _, rank_s, world_s, init_s, out_s = sys.argv
    torch.set_num_threads(1)
    run_rank(int(rank_s), int(world_s), Path(init_s), Path(out_s))
