"""The port's observe layer against the JAX package's, on the CPU.

* Each monitor function (``tree_norm``, ``grad_stats``,
  ``masked_extremes``, ``support_mask``, ``eigen_stack_stats``,
  ``prediv_stack_stats``, ``iterative_stack_stats``, ``merge_extremes``,
  ``kl_nu_stat``) against JAX's on the same numpy stacks: exact for the
  masks and extremes, ``1e-6`` relative for the norms.
* ``last_step_info['observe/*']`` of an MLP ``(16 -> 24 -> 40 -> 10)``
  over 3 steps (refreshes at 0 and 2) against JAX's with the eigen
  (prediv and not), inverse and iterative methods, both sides applying
  the JAX step's gradients: the same keys; ``observe/kl_nu`` and the
  gradient norms at ``1e-5`` relative; the spectrum extremes within the
  CPU eigen gate ``max(1e-4, 4 n eps)`` of the largest eigenvalue; the
  iterative evidence at ``1e-5`` (bounds relative, residuals absolute,
  stale counts exact).
* Observe on (monitor, annotate, timeline) against off through
  ``train_loop``: parameters bitwise, ``last_step_info`` off is
  ``{'vg_sum'}`` on both; one synchronize per step on.
* ``StepTimeline``'s variant per step equals JAX's over the same
  cadence, with ``overlap_comm`` and with ``stagger_refresh``.
* ``comm_ledger`` rows, the amortized/exposed/hidden subtotals,
  ``format_ledger`` and ``ledger_scalars`` equal JAX's on the shared
  designs, flat and scope-tagged by a two-group topology;
  ``compiled_costs`` of an MLP forward equals ``2 M N K``;
  ``profile_phases`` times the four phases and leaves the state as it
  found it.
* One subprocess test, four gloo ranks: under HYBRID-OPT (eigen,
  health, consistency, watchdog, the monitor), HYBRID-OPT with EKFAC,
  and MEM-OPT with the adaptive staggered refresh and ``pipeline_grads``,
  every row of ``ledger_for`` equals the bytes the ranks' collectives
  moved on every step of its cadence, and the monitor's extremes after
  the row all-reduce are bitwise the same on every rank and bitwise the
  extremes of the whole gathered stacks.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

import kfac_pytorch_tpu_torch as kt  # noqa: E402
from kfac_pytorch_tpu_torch.models import MLP  # noqa: E402
from kfac_pytorch_tpu_torch.observe import ObserveConfig  # noqa: E402
from kfac_pytorch_tpu_torch.observe import costs  # noqa: E402
from kfac_pytorch_tpu_torch.observe import monitor  # noqa: E402
from kfac_pytorch_tpu_torch.observe import timeline  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=0.1)
LR = 0.1
STEPS = 3
WIDTHS = (24, 40, 10)
EPS32 = float(np.finfo(np.float32).eps)


def rel(got, want) -> float:
    got, want = np.float64(got), np.float64(want)
    return abs(got - want) / max(abs(want), 1e-30)


# -- the monitor functions ------------------------------------------------------

def padded_eigen(seed, dims, pad):
    """Eigenpairs (f32) of SPD factors of the logical ``dims`` embedded in
    a ``pad x pad`` identity, as the bucket stacks hold them."""
    rng = np.random.default_rng(seed)
    stack = np.stack([np.eye(pad) for _ in dims])
    for i, d in enumerate(dims):
        m = rng.standard_normal((d, 2 * d))
        stack[i, :d, :d] = m @ m.T / (2 * d) * (3.0 + i)
    d, q = np.linalg.eigh(stack)
    return d.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope='module')
def stacks():
    a_dims, g_dims = [7, 12, 4], [5, 8, 8]
    da, qa = padded_eigen(0, a_dims, 12)
    dg, qg = padded_eigen(1, g_dims, 8)
    bake = np.array([0.003, 0.01, 0.003], np.float32)
    dgda = (1.0 / (dg[:, :, None] * da[:, None, :] + bake[:, None, None])
            ).astype(np.float32)
    rng = np.random.default_rng(2)
    it = dict(
        res_a=rng.uniform(0, 1e-3, 3).astype(np.float32),
        res_g=rng.uniform(0, 1e-3, 3).astype(np.float32),
        bound_a=rng.uniform(1, 5, 3).astype(np.float32),
        bound_g=rng.uniform(1, 5, 3).astype(np.float32),
        stale_a=np.array([0, 2, 1], np.int32),
        stale_g=np.array([1, 0, 3], np.int32),
    )
    return dict(da=da, qa=qa, dg=dg, qg=qg, dgda=dgda, bake=bake,
                a_dims=np.array(a_dims, np.int32),
                g_dims=np.array(g_dims, np.int32),
                occupied=np.array([True, True, False]), **it)


def both(name, *arrays):
    """``(port result, JAX result)`` of monitor function ``name`` on the
    same numpy inputs, each as numpy (dicts of numpy)."""
    import jax.numpy as jnp

    from kfac_pytorch_tpu.observe import monitor as jmon

    got = getattr(monitor, name)(*[torch.from_numpy(np.asarray(a))
                                   for a in arrays])
    want = getattr(jmon, name)(*[jnp.asarray(a) for a in arrays])

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(host(v) for v in x)
        return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return host(got), host(want)


def assert_same(got, want, rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same(got[k], want[k], rtol)
    elif isinstance(want, tuple):
        for g, w in zip(got, want):
            assert_same(g, w, rtol)
    elif rtol:
        np.testing.assert_allclose(got, want, rtol=rtol)
    else:
        np.testing.assert_array_equal(got, want)


def test_support_mask_and_extremes_match_jax(stacks):
    s = stacks
    assert_same(*both('support_mask', s['qa'], s['a_dims']))
    assert_same(*both('support_mask', s['qg'], s['g_dims']))
    mask = s['da'] > np.median(s['da'])
    assert_same(*both('masked_extremes', s['da'], mask))
    assert_same(*both('masked_extremes', s['da'], np.zeros_like(mask)))


def test_stack_stats_match_jax(stacks):
    s = stacks
    assert_same(*both('eigen_stack_stats', s['da'], s['dg'], s['qa'],
                      s['qg'], s['a_dims'], s['g_dims'], s['occupied']))
    assert_same(*both('prediv_stack_stats', s['dgda'], s['qa'], s['qg'],
                      s['a_dims'], s['g_dims'], s['occupied'], s['bake']))
    assert_same(*both('iterative_stack_stats', s['res_a'], s['res_g'],
                      s['bound_a'], s['bound_g'], s['stale_a'],
                      s['stale_g'], s['occupied']))


def test_merge_norms_and_nu_match_jax(stacks):
    import jax.numpy as jnp

    from kfac_pytorch_tpu.observe import monitor as jmon

    s = stacks
    per = [(s['da'][i:i + 1], s['dg'][i:i + 1]) for i in range(2)]
    got = monitor.merge_extremes([
        {'kron_min': torch.tensor(float(a.min() * g.min())),
         'kron_max': torch.tensor(float(a.max() * g.max()))}
        for a, g in per], 0.003)
    want = jmon.merge_extremes([
        {'kron_min': jnp.float32(float(a.min() * g.min())),
         'kron_max': jnp.float32(float(a.max() * g.max()))}
        for a, g in per], 0.003)
    assert_same({k: v.numpy() for k, v in got.items()},
                {k: np.asarray(v) for k, v in want.items()})
    rng = np.random.default_rng(4)
    leaves = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((6, 5), (5,), (3, 2, 2))]
    got = monitor.tree_norm([torch.from_numpy(x) for x in leaves])
    want = jmon.tree_norm([jnp.asarray(x) for x in leaves])
    assert rel(got, want) < 1e-6
    g2 = monitor.grad_stats([torch.from_numpy(leaves[0])],
                            [torch.from_numpy(leaves[2])])
    w2 = jmon.grad_stats(jnp.asarray(leaves[0]), jnp.asarray(leaves[2]))
    for k in w2:
        assert rel(g2[k], w2[k]) < 1e-6
    assert float(monitor.kl_nu_stat(None)['observe/kl_nu']) == 1.0
    assert float(monitor.kl_nu_stat(torch.tensor(0.25))['observe/kl_nu']) \
        == float(jmon.kl_nu_stat(jnp.float32(0.25))['observe/kl_nu'])


# -- the engine against JAX -----------------------------------------------------

METHODS = {
    'eigen': {},
    'eigen_noprediv': dict(compute_eigenvalue_outer_product=False),
    'inverse': dict(compute_method='inverse'),
    'iterative': dict(compute_method='iterative'),
}


def mlp_data():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((16, 16)).astype(np.float32),
            rng.integers(0, 10, size=(16,)))


def jax_run(kw):
    """Per step JAX's ``observe/*`` floats and gradients (torch names),
    and the initial variables."""
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
    from kfac_pytorch_tpu.observe import ObserveConfig as JaxObserve
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))

    x, y = mlp_data()
    model = JaxMLP(features=WIDTHS)
    variables = jax.tree.map(np.asarray,
                             model.init(jax.random.PRNGKey(3), x))
    precond = JaxPreconditioner(model, loss_fn=xent, observe=JaxObserve(),
                                **HP, **kw)
    state = precond.init(variables, x)
    params = variables['params']
    trace = []
    for _ in range(STEPS):
        _, _, grads, state = precond.step(
            {'params': params}, state, x, loss_args=(jnp.asarray(y),))
        info = {k: float(v) for k, v in precond.last_step_info.items()}
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        trace.append((info, flax_to_torch_state_dict({'params': grads})))
    return flax_to_torch_state_dict(variables), trace


def port_run(weights, jax_trace, kw, observe=ObserveConfig()):
    x, y = (torch.from_numpy(a) for a in mlp_data())
    model = MLP(16, WIDTHS)
    model.load_state_dict(weights, strict=True)
    precond = kt.KFACPreconditioner(model, observe=observe, **HP, **kw)
    out = []
    for _, jax_grads in jax_trace:
        model.zero_grad()
        F.cross_entropy(model(x), y).backward()
        precond.step()
        out.append({k: float(v) for k, v in precond.last_step_info.items()})
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.sub_(LR * torch.as_tensor(jax_grads[n]))
    return out


@pytest.mark.parametrize('method', sorted(METHODS))
def test_step_info_matches_jax(method):
    weights, jax_trace = jax_run(METHODS[method])
    got = port_run(weights, jax_trace, METHODS[method])
    gate = max(1e-4, 4 * 64 * EPS32)
    for t, ((want, _), info) in enumerate(zip(jax_trace, got)):
        assert set(info) == set(want), (t, set(info) ^ set(want))
        scale = max([abs(want[k]) for k in want
                     if k.startswith(('observe/eig_', 'observe/kron_'))]
                    or [1.0])
        for k, w in want.items():
            g = info[k]
            if k in ('observe/kl_nu', 'observe/grad_norm',
                     'observe/precond_grad_norm', 'vg_sum'):
                assert rel(g, w) < 1e-5, (t, k, g, w)
            elif k.startswith(('observe/eig_', 'observe/kron_')):
                assert abs(g - w) <= gate * scale, (t, k, g, w)
            elif k == 'observe/damping_to_spectrum':
                assert rel(g, w) < gate, (t, k, g, w)
            elif k == 'observe/iter_stale_max':
                assert g == w, (t, k)
            elif k == 'observe/iter_res_max':
                assert abs(g - w) < 1e-5, (t, k, g, w)
            elif k.startswith('observe/iter_bound'):
                assert rel(g, w) < 1e-5, (t, k, g, w)
    keys = set(got[0])
    if method == 'eigen':
        assert {'observe/kron_min', 'observe/kron_max',
                'observe/damping_to_spectrum'} <= keys
    elif method == 'eigen_noprediv':
        assert 'observe/eig_a_min' in keys
    elif method == 'iterative':
        assert 'observe/iter_res_max' in keys
    else:
        assert not any(k.startswith('observe/kron') for k in keys)


def fused_params(observe, steps=4):
    torch.manual_seed(0)
    model = MLP(16, WIDTHS)
    x, y = (torch.from_numpy(a) for a in mlp_data())
    precond = kt.KFACPreconditioner(model, observe=observe, **HP)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    loop = precond.train_loop(opt, F.cross_entropy)
    keys = []
    for _ in range(steps):
        loop.step(x, loss_args=(y,))
        keys.append(set(precond.last_step_info))
    return [p.detach().clone() for p in model.parameters()], keys, precond


def test_observe_on_is_bitwise_off():
    off, keys_off, _ = fused_params(None)
    on, keys_on, p = fused_params(ObserveConfig(timeline=True))
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert all(k == {'vg_sum'} for k in keys_off)
    assert all({'vg_sum', 'observe/kl_nu', 'observe/kron_max'} <= k
               for k in keys_on)
    tl = p.timeline
    assert tl.syncs == 4
    assert {ph: len(tl.times(ph)) for ph in tl.phases} == {
        'step/inv': 2, 'step/factor': 2}


def variant_sequence(tl, before):
    """The phase whose count rose since ``before``, and the new counts."""
    now = {ph: len(tl.times(ph)) for ph in tl.phases}
    (rose,) = [ph for ph in now if now[ph] != before.get(ph, 0)]
    return rose, now


TIMELINE_CASES = {
    'overlap': dict(factor_update_steps=2, inv_update_steps=3,
                    overlap_comm=True),
    'stagger': dict(factor_update_steps=1, inv_update_steps=4,
                    stagger_refresh=2),
}


@pytest.mark.parametrize('case', sorted(TIMELINE_CASES))
def test_timeline_variants_match_jax(case):
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu.observe import ObserveConfig as JaxObserve
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    kw = dict(TIMELINE_CASES[case], damping=0.003, lr=0.1)
    steps = 9
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 10)).astype(np.float32)
    jm = JaxTiny()
    variables = jm.init(jax.random.PRNGKey(0), x)
    jp = JaxPreconditioner(jm, loss_fn=lambda out: jnp.mean(out ** 2),
                           observe=JaxObserve(timeline=True), **kw)
    state = jp.init(variables, x)
    want, before = [], {}
    for _ in range(steps):
        _, _, _, state = jp.step(variables, state, x)
        ph, before = variant_sequence(jp.timeline, before)
        want.append(ph)
    model = kt.models.TinyModel()
    p = kt.KFACPreconditioner(model, observe=ObserveConfig(timeline=True),
                              **kw)
    xt = torch.from_numpy(x)
    got, before = [], {}
    for _ in range(steps):
        model.zero_grad()
        model(xt).square().mean().backward()
        p.step()
        ph, before = variant_sequence(p.timeline, before)
        got.append(ph)
    p.join_deferred_refresh()
    assert got == want
    assert any('overlap_inv' in v or '+shard' in v for v in got)


LEDGER_DESIGNS = {
    'comm_opt_eigen': dict(rows=4, cols=1),
    'hybrid_inverse_stagger': dict(
        rows=2, cols=2, compute_method='inverse',
        stagger_shard_shapes=[[(2, 32, 64)], [(1, 64, 32), (1, 32, 32)]]),
    'mem_opt_pipeline_overlap': dict(
        rows=1, cols=4, overlap_comm=True,
        pipeline_grad_shapes=[(3, 64, 32), (2, 32, 64), (1, 32, 32)]),
    'ekfac_guards': dict(rows=2, cols=2, ekfac=True, consistency_cadence=5,
                         consistency_hp_entries=4, watchdog_cadence=2,
                         adaptive=True),
    'coverage_triu': dict(rows=4, cols=1, diag_a=[False, True, False],
                          factor_comm_triu_bf16=[True, False, True],
                          call_counts=[1, 2, 1], compress_symmetric=True,
                          compute_method='iterative', inv_itemsize=2),
}


@pytest.mark.parametrize('design', sorted(LEDGER_DESIGNS))
def test_comm_ledger_matches_jax(design):
    from kfac_pytorch_tpu.observe import costs as jcosts

    kw = dict(LEDGER_DESIGNS[design])
    rows, cols = kw.pop('rows'), kw.pop('cols')
    args = ([(2, 32, 64), (3, 64, 32), (1, 32, 32)],
            [(17, 24), (25, 40), (41, 10)], rows, cols)
    got = costs.comm_ledger(*args, **kw)
    want = jcosts.comm_ledger(*args, **kw)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]
    cadence = (2, 4, 5, 2)
    for fn in ('amortized_bytes_per_step', 'exposed_bytes_per_step',
               'hidden_bytes_per_step', 'interval_bytes_per_device'):
        assert getattr(costs, fn)(got, *cadence) == getattr(jcosts, fn)(
            want, *cadence)
    assert costs.format_ledger(got, *cadence) == jcosts.format_ledger(
        want, *cadence)
    assert costs.ledger_scalars(got) == jcosts.ledger_scalars(want)
    for fn, fargs in (('eigh_input_gather_bytes', (args[0], 4)),
                      ('gspmd_padded_slots', (5, 4)),
                      ('consistency_check_bytes', (3, 4, [2, 3, 1], 2, 2)),
                      ('adaptive_digest_bytes', (3, 2, 2))):
        assert getattr(costs, fn)(*fargs) == getattr(jcosts, fn)(*fargs)
    from kfac_pytorch_tpu.placement import PodTopology as JaxTopology

    topo = dict(ici_size=2, n_groups=rows * cols // 2,
                ici_gbytes_per_s=400.0, dcn_gbytes_per_s=40.0)
    got = costs.comm_ledger(*args, topology=kt.PodTopology(**topo), **kw)
    want = jcosts.comm_ledger(*args, topology=JaxTopology(**topo), **kw)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]
    assert costs.format_ledger(got, *cadence) == jcosts.format_ledger(
        want, *cadence)
    assert costs.ledger_scalars(got) == jcosts.ledger_scalars(want)
    with pytest.raises(ValueError, match='topology world'):
        costs.comm_ledger(*args, topology=kt.PodTopology(
            ici_size=rows * cols, n_groups=2), **kw)


def test_compiled_costs_counts_an_mlp():
    model = MLP(16, WIDTHS)
    x = torch.randn(8, 16)
    got = costs.compiled_costs(model, x)
    widths = (16, *WIDTHS)
    want = sum(2 * 8 * a * b for a, b in zip(widths[:-1], widths[1:]))
    assert got == {'flops': float(want), 'bytes_accessed': -1.0}
    precond = kt.KFACPreconditioner(model, **HP)
    y = torch.randint(0, 10, (8,))

    def fwd_bwd():
        model.zero_grad()
        F.cross_entropy(model(x), y).backward()

    variants = costs.step_variant_costs(precond, fwd_bwd)
    assert list(variants) == ['plain', 'factor', 'inv']
    assert variants['inv']['flops'] >= variants['plain']['flops'] > 3 * want
    assert precond.steps == 0


def test_profile_phases_restores_the_state():
    torch.manual_seed(0)
    model = MLP(16, WIDTHS)
    x, y = (torch.from_numpy(a) for a in mlp_data())
    precond = kt.KFACPreconditioner(model, observe=ObserveConfig(), **HP)

    def fwd_bwd():
        model.zero_grad()
        F.cross_entropy(model(x), y).backward()

    fwd_bwd()
    precond.step()
    before = {n: st.a_factor.clone() for n, st in precond.layers.items()}
    stacks = {k: bs.qa for k, bs in precond.buckets.items()}
    phases, total = timeline.profile_phases(precond, fwd_bwd, iters=2)
    assert list(phases) == list(timeline.PHASES)
    assert all(v > 0 for v in phases.values()) and total > 0
    assert precond.steps == 1
    assert all(torch.equal(precond.layers[n].a_factor, a)
               for n, a in before.items())
    assert all(precond.buckets[k].qa is q for k, q in stacks.items())
    delta = timeline.profile_overlap_delta(precond, fwd_bwd, iters=1)
    assert set(delta) == {'sync_refresh_step_s', 'overlap_refresh_step_s',
                          'exposed_comm_estimate_s'}


# -- four gloo ranks: the ledger against the bytes moved ------------------------

WORLD = 4
LABELS = {
    'all_reduce_mean': 'factor_allreduce',
    'all_reduce_sum_triu': 'factor_allreduce',
    'all_gather_decompositions': 'inverse_row_allgather',
    '_health_counters': 'health_counters',
    '_with_ekfac_bases': 'ekfac_basis_row_allgather',
    'all_gather_preconditioned': 'grad_col_allgather',
    'all_gather_preconditioned_async': 'grad_col_allgather',
    'curvature_stats': 'observe_extremes',
    'ekfac_divergence': 'ekfac_divergence_gather',
    'check': 'consistency_check',
    'drift_info': 'adaptive_digest',
    '_sync_pending': 'watchdog_check',
}
RUNS = {
    'hybrid_guards': dict(
        fraction=0.5, steps=5,
        kw=dict(factor_update_steps=2, inv_update_steps=4,
                health=True, consistency=2, watchdog=2),
        rows={'inverse_row_allgather', 'health_counters',
              'consistency_check', 'watchdog_check'}),
    'hybrid_ekfac': dict(fraction=0.5, steps=3,
                         kw=dict(factor_update_steps=1, inv_update_steps=2,
                                 ekfac=True),
                         rows={'inverse_row_allgather',
                               'ekfac_basis_row_allgather',
                               'ekfac_divergence_gather'}),
    'mem_adaptive_pipeline': dict(
        fraction=0.25, steps=5,
        kw=dict(factor_update_steps=1, inv_update_steps=4,
                stagger_refresh=2, adaptive=True, pipeline_grads=True),
        rows={'adaptive_digest'}),
}


class ByteCounter:
    """Wraps the ``torch.distributed`` collectives and adds each call's
    result bytes under the ledger phase of the function that issued it
    (the innermost caller named in :data:`LABELS`)."""

    def __init__(self, dist) -> None:
        self.counts: dict[str, int] = {}
        self.dist = dist
        self.saved = {}
        for name in ('all_reduce', 'all_gather_into_tensor', 'all_gather',
                     'broadcast'):
            self.saved[name] = getattr(dist, name)
            setattr(dist, name, self._wrap(name, self.saved[name]))

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            out = args[0]
            nbytes = (sum(t.numel() * t.element_size() for t in out)
                      if isinstance(out, list)
                      else out.numel() * out.element_size())
            label = 'unlabelled'
            frame = sys._getframe(1)
            while frame is not None:
                code = frame.f_code
                if code.co_name in LABELS and not (
                        code.co_name == 'check'
                        and not code.co_filename.endswith('consistency.py')):
                    label = LABELS[code.co_name]
                    break
                frame = frame.f_back
            self.counts[label] = self.counts.get(label, 0) + nbytes
            return fn(*args, **kw)
        return wrapped

    def take(self) -> dict[str, int]:
        out, self.counts = self.counts, {}
        return out


def expected_bytes(rows, fired) -> dict[str, int]:
    """Ledger payloads by phase (shard and bucket suffixes folded) of the
    rows whose cadence fired."""
    out: dict[str, int] = {}
    for r in rows:
        if r['cadence'] not in fired or r['collective'] == 'host':
            continue
        phase = r['phase']
        if phase.startswith('inverse_row_allgather/shard'):
            if fired.get('shard') != phase:
                continue
        base = phase.split('/')[0]
        if r['payload_bytes']:
            out[base] = out.get(base, 0) + r['payload_bytes']
    return out


def worker_run(rank, name, spec, dist):
    cfg = spec['kw']
    torch.manual_seed(5)
    model = MLP(16, WIDTHS)
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    kw = dict(HP, **{k: v for k, v in cfg.items()
                     if k not in ('health', 'consistency', 'watchdog',
                                  'adaptive')})
    if cfg.get('health'):
        kw['health'] = kt.HealthConfig()
    if cfg.get('consistency'):
        kw['consistency'] = kt.ConsistencyConfig(cadence=cfg['consistency'])
    if cfg.get('watchdog'):
        kw['watchdog'] = kt.WatchdogConfig(check_every=cfg['watchdog'])
    if cfg.get('adaptive'):
        kw['adaptive'] = kt.AdaptiveRefreshConfig(threshold=0.2)
    precond = kt.KFACPreconditioner(
        ddp, grad_worker_fraction=spec['fraction'],
        observe=ObserveConfig(monitor=True, annotate=False), **kw)
    rows = [dataclasses.asdict(r) for r in costs.ledger_for(precond)]
    counter = ByteCounter(dist)
    rng = np.random.default_rng(10 + rank)
    steps = []
    try:
        for t in range(spec['steps']):
            x = torch.from_numpy(rng.standard_normal((4, 16))
                                 .astype(np.float32))
            y = torch.from_numpy(rng.integers(0, 10, size=(4,)))
            ddp.zero_grad()
            F.cross_entropy(ddp(x), y).backward()
            uf = precond._step_gating()[0]
            counter.take()
            precond.step()
            moved = counter.take()
            check = precond.watchdog_step(torch.tensor(1.0)) if cfg.get(
                'watchdog') else None
            assert check is None
            wd = counter.take()
            info = precond.last_step_info
            refresh = precond.last_refresh
            fired = {'step': 1}
            if uf:
                fired['factor_step'] = 1
            if refresh is not None:
                fired['inv_step'] = 1
                if refresh != 'full':
                    fired['shard'] = f'inverse_row_allgather/shard{refresh}'
            if cfg.get('consistency') and t % cfg['consistency'] == 0:
                fired['consistency_step'] = 1
            obs = {k: float(v) for k, v in info.items()
                   if k.startswith('observe/') and 'norm' not in k
                   and 'kl_nu' not in k}
            steps.append(dict(moved=moved, watchdog=wd,
                              want=expected_bytes(rows, fired), obs=obs))
        # The extremes of the whole stacks (every column's slots).
        full = precond._second_order.gather_stacks(precond.buckets)
    finally:
        for fname, fn in counter.saved.items():
            setattr(dist, fname, fn)
    per_bucket = []
    so = precond._second_order
    for b in so.plan.buckets:
        f = full[b.key]
        a_dims, g_dims = (torch.tensor(d) for d in so._slot_dims[b.key])
        occ = torch.tensor([n is not None for n in b.slots])
        if 'dgda' in f:
            per_bucket.append(monitor.prediv_stack_stats(
                f['dgda'], f['qa'], f['qg'], a_dims, g_dims, occ,
                f['bake_damping']))
        elif 'da' in f:
            per_bucket.append(monitor.eigen_stack_stats(
                f['da'], f['dg'], f['qa'], f['qg'], a_dims, g_dims, occ))
    whole = {k: float(v) for k, v in monitor.merge_extremes(
        per_bucket, precond.damping).items()}
    wd_row = [r for r in rows if r['phase'] == 'watchdog_check']
    return dict(steps=steps, whole=whole,
                watchdog_row=wd_row[0]['payload_bytes'] if wd_row else None,
                grid=(precond.grid.rows, precond.grid.cols))


def run_worker(rank: int, init: str, out: Path) -> None:
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init}', rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    report = {name: worker_run(rank, name, spec, dist)
              for name, spec in RUNS.items()}
    (out / f'rank{rank}.json').write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('observe')
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, __file__, '--worker', str(rank),
         str(tmp / 'pg_init'), str(tmp)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(WORLD)]
    deadline = time.time() + 180
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
    return [json.loads((tmp / f'rank{r}.json').read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize('run', sorted(RUNS))
def test_ledger_rows_equal_the_bytes_moved_at_world_4(ranks, run):
    for rank, report in enumerate(ranks):
        rep = report[run]
        seen = set()
        for t, step in enumerate(rep['steps']):
            moved = {k: v for k, v in step['moved'].items()
                     if k != 'unlabelled'}
            assert moved == step['want'], (run, rank, t)
            seen |= set(moved)
            if step['watchdog']:
                assert step['watchdog'] == {
                    'watchdog_check': rep['watchdog_row']}, (run, rank, t)
                seen.add('watchdog_check')
        assert {'factor_allreduce', 'grad_col_allgather',
                'observe_extremes'} | RUNS[run]['rows'] <= seen, (run, seen)
    assert len({tuple(r[run]['grid']) for r in ranks}) == 1


@pytest.mark.parametrize('run', sorted(RUNS))
def test_extremes_equal_the_whole_stacks_on_every_rank(ranks, run):
    last = [r[run]['steps'][-1]['obs'] for r in ranks]
    assert all(o == last[0] for o in last[1:])
    whole = ranks[0][run]['whole']
    assert whole and {k: last[0][k] for k in whole} == whole


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_worker(int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
