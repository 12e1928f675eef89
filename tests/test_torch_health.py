"""The port's numerical-health guardrails against the JAX package's, on
the CPU.

* The pieces of ``health.py`` on the same inputs: ``EscalationLadder``,
  ``HealthConfig``'s errors, ``terminal_triggers``, the verdicts (f32,
  bf16 and int arrays with NaN and infinities), ``run_with_recovery``
  (verdicts and retry counts exact, outputs within ``1e-5``) and
  ``merge_with_prev`` (exact) on the same numpy stacks and injection
  masks.
* The whole preconditioner on ``TinyModel`` and ``LeNet`` (bridged by
  ``convert.py``, fixed weights, a fresh batch a step, refreshes every
  other step), for eigen, inverse and iterative: injected failures (the
  first attempt only; every attempt of one slot; every attempt of every
  slot) give every ``health/*`` counter exactly equal to JAX's at every
  step and preconditioned gradients within a relative Frobenius
  ``1e-5`` (``1e-4`` after a retried ``eigh`` on LeNet, as JAX holds its
  own retried decomposition, and on ResNet-20); LeNet runs at 12x12, as
  ``tests/test_torch_lowrank.py`` runs it (at 28x28 its a896 bucket
  alone puts the unguarded runs 8.6e-5 apart); a NaN batch leaves the
  EMAs bitwise and zeroes the gradients; a poisoned factor resets; a JAX
  checkpoint taken under health resumes in the port.  A ResNet-20 run holds the same on a
  model with BatchNorm.
* The port alone: health on with nothing failing is bitwise health off;
  a quarantined slot's gradient is its raw gradient bitwise; the fused
  path (``train_loop``) leaves parameters, momentum and BatchNorm's
  buffers bitwise on a bad batch; accumulation skips a poisoned
  micro-batch; a diagonal-A (embedding) layer falls back to the
  identity.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kfac_pytorch_tpu_torch as kt
from kfac_pytorch_tpu_torch import health
from kfac_pytorch_tpu_torch import testing as ttest
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.convert import jax_kfac_state_dict_to_torch
from kfac_pytorch_tpu_torch.models import LeNet
from kfac_pytorch_tpu_torch.models import TinyModel
from kfac_pytorch_tpu_torch.models import resnet20
from kfac_pytorch_tpu_torch.utils.metrics import health_scalars

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003, lr=0.1)
STEPS = 5
TOL = 1e-5
#: The bar of a retried decomposition and of ResNet-20 (BatchNorm at
#: batch 4 and eleven buckets): f32 ``eigh`` on two LAPACK builds (the
#: repo's other eigen trajectories hold 1e-4 for the same reason).
WIDE_TOL = 1e-4


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def spd_stack(seed: int, L: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((L, n, n)))[0]
    eigs = np.logspace(0.0, -2.0, n)
    s = np.einsum('lij,j,lkj->lik', q, eigs, q)
    return ((s + s.transpose(0, 2, 1)) / 2).astype(np.float32)


# -- the pieces -----------------------------------------------------------


def test_escalation_ladder_matches_jax():
    from kfac_pytorch_tpu.health import EscalationLadder as JaxLadder

    mine, ref = health.EscalationLadder(2), JaxLadder(2)
    events = [(('bucket', 'a', 0), True), (('bucket', 'a', 0), True),
              (('layer', 'x'), True), (('bucket', 'a', 1), True),
              (('bucket', 'a', 0), True), (('bucket', 'a', 1), False),
              (('layer', 'x'), True)]
    for key, failed in events:
        assert mine.note(key, failed) == ref.note(key, failed)
        assert mine.strikes == ref.strikes
        assert mine.max_strikes() == ref.max_strikes()
    mine.reset_all(prefix=('bucket',))
    ref.reset_all(prefix=('bucket',))
    assert mine.strikes == ref.strikes == {('layer', 'x'): 2}
    assert mine.strikes_for(('layer', 'x')) == 2
    mine.reset_all()
    assert mine.strikes == {} and mine.max_strikes() == 0
    with pytest.raises(ValueError, match='threshold'):
        health.EscalationLadder(0)


@pytest.mark.parametrize('kwargs', [
    dict(max_eigh_retries=-1), dict(jitter_scale=0.0),
    dict(jitter_growth=-1.0), dict(quarantine_after=0),
])
def test_health_config_errors_match_jax(kwargs):
    from kfac_pytorch_tpu.health import HealthConfig as JaxConfig

    with pytest.raises(ValueError) as want:
        JaxConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        kt.HealthConfig(**kwargs)
    assert str(got.value) == str(want.value)
    assert dataclasses.asdict(kt.HealthConfig()) == dataclasses.asdict(
        JaxConfig())


def test_terminal_triggers_match_jax():
    from kfac_pytorch_tpu import health as jh

    snaps = [None, {'health/steps_skipped': 0.0},
             {'health/steps_skipped': 1.0, 'health/quarantined_layers': 0.0},
             {'health/steps_skipped': 1.0, 'health/quarantined_layers': 2.0}]
    for prev, cur in zip(snaps, snaps[1:]):
        assert health.terminal_triggers(prev, cur) == jh.terminal_triggers(
            prev, cur)
    assert health.terminal_triggers(None, snaps[-1]) == [
        'health_step_skip', 'health_quarantine']
    assert health.HEALTH_INFO_KEYS == jh.HEALTH_INFO_KEYS


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'int32'])
@pytest.mark.parametrize('poison', [None, 'nan', 'inf', '-inf'])
def test_verdicts_match_jax(dtype, poison):
    import jax.numpy as jnp

    from kfac_pytorch_tpu import health as jh

    rng = np.random.default_rng(0)
    stack = rng.standard_normal((3, 4, 5)).astype(np.float32)
    if poison is not None and dtype != 'int32':
        stack[1, 2, 3] = float(poison)
    j = jnp.asarray(stack).astype(getattr(jnp, dtype))
    t = torch.from_numpy(stack).to(getattr(torch, dtype))
    assert bool(health.array_all_finite(t)) == bool(jh.array_all_finite(j))
    tree = {'a': [t, t[0]], 'b': torch.ones(2)}
    jtree = {'a': [j, j[0]], 'b': jnp.ones(2)}
    assert bool(health.tree_all_finite(tree)) == bool(
        jh.tree_all_finite(jtree))
    if dtype != 'int32':
        np.testing.assert_array_equal(
            health.stacked_all_finite([t, t * 2], 3).numpy(),
            np.asarray(jh.stacked_all_finite([j, j * 2], 3)))
    assert bool(health.tree_all_finite([])) is True


def _attempts(method: str, stack: np.ndarray):
    """The port's and JAX's attempt functions on the same stack."""
    import jax.numpy as jnp

    from kfac_pytorch_tpu import ops as jops

    A = torch.from_numpy(stack)
    jA = jnp.asarray(stack)
    eye = np.eye(stack.shape[-1], dtype=np.float32)
    if method == 'eigen':
        def mine(jitter):
            d, q = torch.linalg.eigh(A + jitter * torch.from_numpy(eye))
            return d - jitter, q

        def ref(jitter):
            d, q = jnp.linalg.eigh(jA + jitter * jnp.asarray(eye))
            return d - jitter, q
    else:
        def mine(jitter):
            return (kt.ops.batched_damped_inv(A, 0.003 + jitter),)

        def ref(jitter):
            return (jops.batched_damped_inv(jA, 0.003 + jitter),)
    return mine, ref


@pytest.mark.parametrize('method', ['eigen', 'inverse'])
@pytest.mark.parametrize('failures,mask', [
    (0, None), (1, None), (2, [False, True, False, True]),
    (99, [True, False, False, False]), (99, None),
])
def test_run_with_recovery_matches_jax(method, failures, mask):
    from kfac_pytorch_tpu import health as jh

    stack = spd_stack(1, 4, 12)
    cfg = kt.HealthConfig(inject_eigh_failures=failures)
    jcfg = jh.HealthConfig(inject_eigh_failures=failures)
    m = None if mask is None else np.asarray(mask)
    mine, ref = _attempts(method, stack)
    stats = {}
    outs, ok, retries = health.run_with_recovery(
        mine, 0.003, cfg, n_layers=4, inject_mask=m, stats=stats)
    jouts, jok, jretries = jh.run_with_recovery(
        ref, 0.003, jcfg, n_layers=4, inject_mask=m)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert int(retries) == int(jretries)
    assert int(stats['slot_rounds'].max()) == int(retries)
    assert stats.get('host_reads', 0) == min(int(retries) + 1, 2)
    first = outs[0].numpy()
    want = np.asarray(jouts[0])
    good = np.asarray(jok)
    np.testing.assert_array_equal(np.isfinite(first).all(axis=tuple(
        range(1, first.ndim))), np.isfinite(want).all(axis=tuple(
            range(1, want.ndim))))
    if good.any():
        np.testing.assert_allclose(first[good], want[good], rtol=TOL,
                                   atol=TOL * np.abs(want[good]).max())


def test_run_with_recovery_whole_output_verdict():
    """``n_layers=None`` (the diagonal-A side path): one verdict."""
    from kfac_pytorch_tpu import health as jh

    stack = spd_stack(2, 1, 8)[0]
    for failures in (0, 1, 5):
        def attempt(jitter):
            return (kt.ops.compute_factor_inv(torch.from_numpy(stack),
                                              0.01 + jitter),)
        outs, ok, r = health.run_with_recovery(
            attempt, 0.01, kt.HealthConfig(inject_eigh_failures=failures))
        import jax.numpy as jnp
        from kfac_pytorch_tpu import ops as jops

        def jattempt(jitter):
            return (jops.compute_factor_inv(jnp.asarray(stack),
                                            0.01 + jitter),)
        _, jok, jr = jh.run_with_recovery(
            jattempt, 0.01, jh.HealthConfig(inject_eigh_failures=failures))
        assert bool(ok) == bool(jok) and int(r) == int(jr)


def test_merge_with_prev_matches_jax():
    import jax.numpy as jnp

    from kfac_pytorch_tpu import health as jh
    from kfac_pytorch_tpu.parallel.second_order import (
        BucketSecond as JaxSecond,
    )
    from kfac_pytorch_tpu_torch.parallel.second_order import BucketSecond

    rng = np.random.default_rng(3)
    new_qa = rng.standard_normal((4, 3, 3)).astype(np.float32)
    new_qa[2] = np.nan
    prev_qa = rng.standard_normal((4, 3, 3)).astype(np.float32)
    dgda = rng.standard_normal((4, 2, 3)).astype(np.float32)
    fail = np.array([0, 2, 2, 0], np.int32)
    ever = np.array([True, True, True, False])
    ok = np.array([True, False, False, False])
    cfg = kt.HealthConfig(quarantine_after=3)
    got = health.merge_with_prev(
        BucketSecond(qa=torch.from_numpy(new_qa),
                     dgda=torch.from_numpy(dgda)),
        BucketSecond(qa=torch.from_numpy(prev_qa),
                     dgda=torch.from_numpy(dgda * 2),
                     fail_count=torch.from_numpy(fail),
                     quarantined=torch.zeros(4, dtype=torch.bool),
                     ever_ok=torch.from_numpy(ever)),
        torch.from_numpy(ok), cfg)
    want = jh.merge_with_prev(
        JaxSecond(qa=jnp.asarray(new_qa), dgda=jnp.asarray(dgda)),
        JaxSecond(qa=jnp.asarray(prev_qa), dgda=jnp.asarray(dgda * 2),
                  fail_count=jnp.asarray(fail),
                  quarantined=jnp.zeros(4, bool),
                  ever_ok=jnp.asarray(ever)),
        jnp.asarray(ok), jh.HealthConfig(quarantine_after=3))
    for name in ('qa', 'dgda', 'fail_count', 'quarantined', 'ever_ok'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.quarantined.tolist() == [False, True, True, True]


# -- the whole preconditioner against JAX ---------------------------------


def batches(name: str, steps: int = STEPS, seed: int = 11):
    rng = np.random.default_rng(seed)
    shape = {'tiny': (16, 10), 'lenet': (4, 12, 12, 1),
             'resnet20': (4, 8, 8, 3)}[name]
    return [(rng.standard_normal(shape).astype(np.float32),
             rng.integers(0, 10, size=(shape[0],))) for _ in range(steps)]


def jax_model(name):
    from kfac_pytorch_tpu.models import resnet20 as jax_resnet20
    from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny

    return {'tiny': JaxTiny, 'lenet': JaxLeNet,
            'resnet20': lambda: jax_resnet20(num_classes=10)}[name]()


def torch_model(name):
    return {'tiny': TinyModel, 'lenet': lambda: LeNet(image_size=12),
            'resnet20': lambda: resnet20(num_classes=10, device='cpu'),
            }[name]()


_VARIABLES = {}


def variables(name):
    import jax

    if name not in _VARIABLES:
        x = batches(name, 1)[0][0]
        kw = {'train': True} if name == 'resnet20' else {}
        _VARIABLES[name] = jax.tree.map(
            np.asarray, jax_model(name).init(jax.random.PRNGKey(5), x, **kw))
    return _VARIABLES[name]


def torch_x(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2).contiguous() if t.ndim == 4 else t


def jax_health_config(cfg):
    from kfac_pytorch_tpu.health import HealthConfig as JaxConfig

    return None if cfg is None else JaxConfig(**dataclasses.asdict(cfg))


def jax_run(name, data, cfg, poison=None, save_at=None, **kw):
    """Per step the ``health/*`` counters, the preconditioned gradients
    (port names) and the factor EMAs; ``poison = (step, layer)`` poisons
    that layer's A factor before the step; ``save_at`` also returns the
    state dict saved after that step."""
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu import testing as jtest
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    def xent(out, labels):
        logits, aux = out if isinstance(out, tuple) else (out, None)
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))
        return loss if aux is None else (loss, aux)

    apply_kwargs = ({'train': True, 'mutable': ['batch_stats']}
                    if name == 'resnet20' else None)
    precond = JaxPreconditioner(
        jax_model(name), loss_fn=xent, health=jax_health_config(cfg),
        **({'apply_kwargs': apply_kwargs} if apply_kwargs else {}),
        **dict(HP, **kw))
    v = variables(name)
    state = precond.init(v, data[0][0])
    out, saved = [], None
    for t, (x, y) in enumerate(data):
        if poison is not None and poison[0] == t:
            state = jtest.poison_factors(state, poison[1], sides='a')
        _, _, grads, state = precond.step(v, state, x,
                                          loss_args=(jnp.asarray(y),))
        info = precond.last_step_info
        out.append(dict(
            health={k: int(np.asarray(info[k])) for k in info
                    if k.startswith('health/')},
            vg_sum=float(np.asarray(info['vg_sum'])),
            grads=flax_to_torch_state_dict(
                {'params': jax.tree.map(np.asarray, grads)}),
            factors={b.replace('/', '.'): (np.asarray(state[b].a_factor),
                                           np.asarray(state[b].g_factor))
                     for b in state.layers},
        ))
        if save_at == t:
            saved = jax.tree.map(np.asarray, precond.state_dict(state))
    return out, saved


def torch_run(name, data, cfg, poison=None, precond_hook=None, **kw):
    torch.manual_seed(0)
    model = torch_model(name)
    model.load_state_dict(flax_to_torch_state_dict(variables(name)))
    precond = kt.KFACPreconditioner(model, health=cfg, **dict(HP, **kw))
    if precond_hook is not None:
        precond_hook(precond)
    out = []
    for t, (x, y) in enumerate(data):
        if poison is not None and poison[0] == t:
            ttest.poison_factors(precond, poison[1], sides='a')
        model.zero_grad()
        F.cross_entropy(model(torch_x(x)), torch.from_numpy(y)).backward()
        precond.step()
        info = precond.last_step_info
        out.append(dict(
            health={k: int(v) for k, v in health_scalars(info).items()},
            vg_sum=float(info['vg_sum']),
            grads={n: p.grad.clone() for n, p in model.named_parameters()},
            factors={n: (st.a_factor.clone(), st.g_factor.clone())
                     for n, st in precond.layers.items()},
        ))
    return precond, out


def assert_matches(want, got, tol=TOL):
    for t, (w, g) in enumerate(zip(want, got)):
        assert g['health'] == w['health'], (t, g['health'], w['health'])
        for n, grad in w['grads'].items():
            err = rel_err(g['grads'][n], grad)
            assert err <= tol, (t, n, err)
        for layer, pair in w['factors'].items():
            for side in (0, 1):
                err = rel_err(g['factors'][layer][side], pair[side])
                assert err <= tol, (t, layer, side, err)


def slot_config(name, layers, attempts, **kw):
    probe = kt.KFACPreconditioner(torch_model(name))
    return ttest.eigh_failure_config(probe, layers=layers,
                                     attempts=attempts, **kw)


SCENARIOS = {
    'clean': lambda name: kt.HealthConfig(),
    'retry': lambda name: kt.HealthConfig(inject_eigh_failures=1),
    'fallback': lambda name: slot_config(
        name, ('conv1' if name == 'lenet' else 'linear1',), 99,
        quarantine_after=2),
    'all_fail': lambda name: kt.HealthConfig(inject_eigh_failures=99),
}


@pytest.mark.parametrize('scenario', list(SCENARIOS))
@pytest.mark.parametrize('method', ['eigen', 'inverse', 'iterative'])
def test_injected_failures_match_jax_tiny(scenario, method):
    data = batches('tiny')
    cfg = SCENARIOS[scenario]('tiny')
    want, _ = jax_run('tiny', data, cfg, compute_method=method)
    _, got = torch_run('tiny', data, cfg, compute_method=method)
    assert_matches(want, got)


@pytest.mark.parametrize('scenario', ['retry', 'fallback', 'all_fail'])
def test_injected_failures_match_jax_lenet(scenario):
    data = batches('lenet', 4)
    cfg = SCENARIOS[scenario]('lenet')
    want, _ = jax_run('lenet', data, cfg)
    _, got = torch_run('lenet', data, cfg)
    # A retried eigh subtracts the jitter back out of the eigenvalues,
    # which amplifies f32 rounding on both sides (JAX holds its retried
    # decomposition against its plain one at rtol 1e-4, tests/
    # test_health.py::test_escalation_recovers_transient_failure).
    assert_matches(want, got, tol=WIDE_TOL if scenario == 'retry' else TOL)
    if scenario == 'fallback':
        assert got[-1]['health']['health/quarantined_layers'] == 1


def test_injected_failures_match_jax_resnet20():
    """A model with BatchNorm, eleven buckets, one slot failing every
    attempt beside the others."""
    data = batches('resnet20', 3)
    probe = kt.KFACPreconditioner(torch_model('resnet20'))
    layer = sorted(probe.helpers)[3]
    cfg = ttest.eigh_failure_config(probe, layers=(layer,),
                                    quarantine_after=2)
    want, _ = jax_run('resnet20', data, cfg)
    _, got = torch_run('resnet20', data, cfg)
    assert_matches(want, got, tol=WIDE_TOL)
    assert got[-1]['health']['health/eigh_fallbacks'] == 2


def test_nan_batch_matches_jax():
    data = batches('tiny')
    data[2] = (np.where(np.arange(10) == 0, np.nan, data[2][0]),
               data[2][1])
    cfg = kt.HealthConfig()
    want, _ = jax_run('tiny', data, cfg)
    _, got = torch_run('tiny', data, cfg)
    assert_matches(want[:2] + want[3:], got[:2] + got[3:])
    assert got[2]['health'] == want[2]['health']
    assert got[2]['health']['health/steps_skipped'] == 1
    assert got[2]['health']['health/step_ok'] == 0
    assert got[2]['vg_sum'] == want[2]['vg_sum'] == 0.0
    for g in got[2]['grads'].values():
        assert float(g.abs().sum()) == 0.0
    for n, (a, g) in got[1]['factors'].items():
        assert torch.equal(a, got[2]['factors'][n][0])
        assert torch.equal(g, got[2]['factors'][n][1])


def test_skipped_first_batch_still_seeds_from_identity():
    data = batches('tiny', 3)
    data[0] = (np.full_like(data[0][0], np.nan), data[0][1])
    want, _ = jax_run('tiny', data, kt.HealthConfig())
    _, got = torch_run('tiny', data, kt.HealthConfig())
    assert got[0]['health']['health/factor_updates_applied'] == 0
    assert got[1]['health']['health/factor_updates_applied'] == 1
    assert_matches(want[1:], got[1:])


def test_poisoned_factor_resets_matches_jax():
    data = batches('lenet', 4)
    want, _ = jax_run('lenet', data, kt.HealthConfig(), poison=(2, 'fc2'))
    _, got = torch_run('lenet', data, kt.HealthConfig(), poison=(2, 'fc2'))
    assert got[2]['health']['health/factor_resets'] == 1
    assert_matches(want, got)


def test_jax_checkpoint_under_health_resumes_in_port():
    data = batches('tiny', 5)
    cfg = kt.HealthConfig()
    want, saved = jax_run('tiny', data, cfg, save_at=2)
    sd = jax_kfac_state_dict_to_torch(saved)

    def restore(precond):
        precond.load_state_dict(sd)
    _, got = torch_run('tiny', data[3:], cfg, precond_hook=restore)
    for w, g in zip(want[3:], got):
        for n, grad in w['grads'].items():
            assert rel_err(g['grads'][n], grad) <= TOL, n
    assert got[0]['health']['health/factor_updates_applied'] == 2


@pytest.mark.parametrize('kwargs,error', [
    (dict(bucketed=False), ValueError),
    (dict(lowrank_rank=4), ValueError),
    (dict(stagger_refresh=2), ValueError),
    (dict(overlap_comm=True), ValueError),
    (dict(health=object()), TypeError),
])
def test_exclusions_raise_jax_errors(kwargs, error):
    from kfac_pytorch_tpu.health import HealthConfig as JaxConfig
    from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )

    kw = dict(inv_update_steps=2)
    kw.update(kwargs)
    jkw = dict(kw, health=kw.get('health', JaxConfig()))
    kw.setdefault('health', kt.HealthConfig())
    with pytest.raises(error) as want:
        JaxPreconditioner(JaxTiny(), loss_fn=None, **jkw)
    with pytest.raises(error) as got:
        kt.KFACPreconditioner(TinyModel(), **kw)
    assert str(got.value) == str(want.value)


# -- the port alone ------------------------------------------------------


@pytest.mark.parametrize('name,kw', [
    ('lenet', dict()), ('lenet', dict(compute_method='inverse')),
    ('tiny', dict(compute_method='iterative')),
    ('lenet', dict(compute_eigenvalue_outer_product=False)),
    ('lenet', dict(ekfac=True)), ('lenet', dict(precond_dtype=torch.bfloat16)),
    ('lenet', dict(pipeline_grads=True)),
])
def test_health_on_is_bitwise_health_off(name, kw):
    """Nothing failing (no retry: the iterative method's residual gate
    counts an unconverged refresh as a failure, so it runs on
    ``TinyModel``, whose refreshes converge)."""
    data = batches(name, 4)
    _, off = torch_run(name, data, None, **kw)
    _, on = torch_run(name, data, kt.HealthConfig(), **kw)
    assert on[-1]['health']['health/eigh_retries'] == 0
    for a, b in zip(off, on):
        for n in a['grads']:
            assert torch.equal(a['grads'][n], b['grads'][n]), n
        for n in a['factors']:
            assert torch.equal(a['factors'][n][0], b['factors'][n][0])
        assert a['vg_sum'] == b['vg_sum']


@pytest.mark.parametrize('kw', [dict(), dict(compute_method='inverse'),
                                dict(precond_dtype=torch.bfloat16)])
def test_quarantined_slot_grad_is_raw_bitwise(kw):
    """kl_clip off, so the scale is 1: the quarantined layer's
    preconditioned gradient is its raw gradient bit for bit; the other
    layers are preconditioned."""
    data = batches('lenet', 1)
    cfg = slot_config('lenet', ('fc2',), 99)
    torch.manual_seed(0)
    model = torch_model('lenet')
    model.load_state_dict(flax_to_torch_state_dict(variables('lenet')))
    precond = kt.KFACPreconditioner(model, health=cfg, kl_clip=None,
                                    **dict(HP, **kw))
    x, y = data[0]
    F.cross_entropy(model(torch_x(x)), torch.from_numpy(y)).backward()
    raw = {n: h.get_grad().clone() for n, h in precond.helpers.items()}
    precond.step()
    assert int(precond.last_step_info['health/quarantined_layers']) == 1
    for n, h in precond.helpers.items():
        if n == 'fc2':
            assert torch.equal(h.get_grad(), raw[n])
        else:
            assert not torch.equal(h.get_grad(), raw[n])


def test_fused_path_freezes_params_momentum_and_buffers():
    data = batches('resnet20', 4)
    torch.manual_seed(0)
    model = torch_model('resnet20')
    model.load_state_dict(flax_to_torch_state_dict(variables('resnet20')))
    precond = kt.KFACPreconditioner(model, health=kt.HealthConfig(), **HP)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    loop = precond.train_loop(opt, F.cross_entropy)

    def snapshot():
        return ([t.clone() for t in model.state_dict().values()],
                [s['momentum_buffer'].clone()
                 for s in opt.state.values()])
    for t, (x, y) in enumerate(data):
        if t == 2:
            x = np.where(np.arange(x.shape[-1]) == 0, np.nan, x)
            before = snapshot()
        loop.step(torch_x(x), loss_args=(torch.from_numpy(y),))
        if t == 2:
            after = snapshot()
            for a, b in zip(before[0] + before[1], after[0] + after[1]):
                assert torch.equal(a, b)
    info = precond.last_step_info
    assert int(info['health/steps_skipped']) == 1
    assert int(info['health/step_ok']) == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())
    # One read a step, plus one factor-reset read and one read per
    # bucket at each of the two refreshes (steps 0 and 2).
    n_buckets = len(precond.plan.buckets)
    assert precond.health_host_syncs == 4 + 2 * (1 + n_buckets)


def test_accumulation_skips_poisoned_micro_batch():
    data = batches('tiny', 3)
    torch.manual_seed(0)
    model = TinyModel()
    model.load_state_dict(flax_to_torch_state_dict(variables('tiny')))
    precond = kt.KFACPreconditioner(model, health=kt.HealthConfig(),
                                    accumulation_steps=2, **HP)
    factors = None
    for t, (x, y) in enumerate(data):
        model.zero_grad()
        for i, half in enumerate((slice(0, 8), slice(8, 16))):
            xb = x[half].copy()
            if t == 1 and i == 1:
                xb[0, 0] = np.nan
            (F.cross_entropy(model(torch_x(xb)), torch.from_numpy(y[half]))
             / 2).backward()
        precond.step()
        if t == 0:
            factors = {n: st.a_factor.clone()
                       for n, st in precond.layers.items()}
        if t == 1:
            for n, st in precond.layers.items():
                assert torch.equal(st.a_factor, factors[n])
            for p in model.parameters():
                assert float(p.grad.abs().sum()) == 0.0
    assert int(precond.last_step_info['health/steps_skipped']) == 1


def test_diag_layer_falls_back_to_identity():
    """An embedding (diagonal A, outside the buckets) whose G
    decomposition fails on every attempt at its first refresh degrades
    to the identity, finite and still training; a transient failure
    recovers by a retry."""
    class EmbedNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = torch.nn.Embedding(12, 6)
            self.fc = torch.nn.Linear(6, 5)

        def forward(self, ids):
            return self.fc(self.emb(ids).mean(1))

    for attempts, fallbacks in ((1, 0), (99, 2)):
        torch.manual_seed(0)
        model = EmbedNet()
        precond = kt.KFACPreconditioner(
            model, layer_types=('linear', 'embedding'),
            health=kt.HealthConfig(inject_eigh_failures=attempts,
                                   max_eigh_retries=1), **HP)
        ids = torch.randint(0, 12, (4, 3))
        F.cross_entropy(model(ids), torch.arange(4)).backward()
        precond.step()
        info = health_scalars(precond.last_step_info)
        assert int(info['health/eigh_fallbacks']) == fallbacks
        assert int(info['health/eigh_retries']) == 2
        assert torch.isfinite(model.emb.weight.grad).all()
        if attempts == 99:
            assert torch.equal(precond.layers['emb'].qg, torch.eye(6))
