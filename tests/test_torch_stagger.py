"""The port's staggered refresh (``stagger_refresh=K``) against the JAX
package's, on the CPU.

* The plan: ``make_stagger_plan`` of the port's bucket plans equals the
  JAX package's on LeNet, ResNet-32 (one, two and four grid columns) and
  ImageNet ResNet-50 (the slice's model on the card): shards and costs
  exactly, for several ``K``.
* The cadence: ``stagger_refresh_action`` equals JAX's over a grid of
  (step, interval, ``K``, flags), the raise included; the scheduler
  guard rejects a lambda that takes the interval below ``K``.
* Trajectories: LeNet at 12x12, batch 8, ``stagger_refresh=2``,
  ``inv_update_steps=4``, 12 steps (three intervals: the monolithic
  bootstrap at step 0, shard 1 at step 1, then shards 0 and 1 at phases
  0 and 1), eigen with and without prediv, EKFAC, inverse and
  iterative, against the JAX engine from the same bridged weights with
  the same numpy SGD updates: the refresh of every step, the losses
  (``rtol 1e-5``), the factor EMAs (relative Frobenius ``<= 1e-5``) and
  the preconditioned gradients (``<= 1e-4``, the bar of the port's
  other trajectory tests: the ``eigh`` of two LAPACK builds resolves
  near-degenerate clusters differently; measured at most 4.4e-5).
  EKFAC's gradients are held at ``1e-3``: its scale EMA lives in each
  package's own basis, and on these batches the monolithic EKFAC
  trajectory already differs by up to 7.5e-4 (the staggered one by
  7.0e-4).
* A shard sweep over frozen factors gives the monolithic refresh
  bitwise (the CPU's batched ``eigh`` decomposes each slot alone), for
  eigen with and without prediv, EKFAC and inverse.
* Accumulation: ``accumulation_steps=2`` on two copies of the batch
  follows the plain step's shard cadence, and its preconditioner acts
  as the plain step's does (the preconditioned gradients and
  ``qa·diag·qaᵀ`` reconstructions, never raw eigenvectors).  The
  reference's own test of this composition
  (``tests/test_stagger.py::TestStaggerAccumulation::
  test_finalize_runs_shard_refreshes``) compares raw ``qa`` across two
  trajectories and fails on the reference itself (158 of 2048 entries
  of ``a32g32``'s ``qa`` off by up to 0.80): eigenvectors rotate inside
  near-degenerate clusters.
* The restore invariant: ``load_state_dict(compute_inverses=True)``
  resumes on the shard cadence, ``False`` makes the next due refresh
  monolithic.
"""
from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu.capture import ModelCapture as JaxCapture
from kfac_pytorch_tpu.models import resnet32 as jax_resnet32
from kfac_pytorch_tpu.models.resnet import resnet50 as jax_resnet50
from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
from kfac_pytorch_tpu.parallel import bucketing as jax_bucketing
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu.scheduler import (
    stagger_refresh_action as jax_stagger_refresh_action,
)
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch import LambdaParamScheduler
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import LeNet
from kfac_pytorch_tpu_torch.models import resnet32
from kfac_pytorch_tpu_torch.models import resnet50
from kfac_pytorch_tpu_torch.parallel import bucketing
from kfac_pytorch_tpu_torch.scheduler import stagger_refresh_action

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

LR = 0.1
STEPS = 12
HP = dict(factor_update_steps=1, inv_update_steps=4, damping=0.003, lr=LR)
#: The refresh of each of the 12 steps at K=2, inv 4.
CADENCE = ['full', 1, None, None, 0, 1, None, None, 0, 1, None, None]


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def jax_xent(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))


def batches(steps=STEPS):
    rng = np.random.default_rng(31)
    return [(rng.standard_normal((8, 12, 12, 1)).astype(np.float32),
             rng.integers(0, 10, size=(8,))) for _ in range(steps)]


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# -- the plan -------------------------------------------------------------


def _jax_helpers(model, x, **kw):
    variables = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, **kw),
    )
    cap = JaxCapture(model)
    if kw:
        kw = dict(kw, mutable=['batch_stats'])
    specs = cap.register(variables, x, **kw)
    return {'/'.join(s.helper.path): s.helper for s in specs.values()}


@pytest.fixture(scope='module')
def helper_pairs():
    """``{model: (jax helpers, port helpers)}``; registration only."""
    lenet = _jax_helpers(JaxLeNet(), jnp.zeros((2, 28, 28, 1)))
    cnn = dict(train=True)
    r32 = _jax_helpers(jax_resnet32(num_classes=10),
                       jnp.zeros((2, 32, 32, 3)), **cnn)
    r50 = _jax_helpers(jax_resnet50(num_classes=1000),
                       jnp.zeros((1, 32, 32, 3)), **cnn)
    port = {
        name: ModelCapture(model).helpers
        for name, model in (('lenet', LeNet()),
                            ('resnet32', resnet32(device='cpu')),
                            ('resnet50', resnet50(device='cpu')))
    }
    return {'lenet': (lenet, port['lenet']),
            'resnet32': (r32, port['resnet32']),
            'resnet50': (r50, port['resnet50'])}


@pytest.mark.parametrize('name,n_cols,shards', [
    ('lenet', 1, (1, 2, 3, 64)),
    ('resnet32', 1, (1, 2, 5, 10)),
    ('resnet32', 2, (3, 7)),
    ('resnet32', 4, (4,)),
    ('resnet50', 1, (5, 10)),
])
def test_stagger_plan_matches_jax(helper_pairs, name, n_cols, shards):
    jax_helpers, port_helpers = helper_pairs[name]
    jplan = jax_bucketing.make_bucket_plan(jax_helpers, n_cols=n_cols)
    pplan = bucketing.make_bucket_plan(
        {n: h for n, h in port_helpers.items() if not h.diagonal_a},
        n_cols=n_cols,
    )
    assert ([(b.key, b.n_slots) for b in pplan.buckets]
            == [(b.key, b.n_slots) for b in jplan.buckets])
    for k in shards:
        want = jax_bucketing.make_stagger_plan(jplan, k)
        got = bucketing.make_stagger_plan(pplan, k)
        assert got.n_shards == want.n_shards == k
        assert [dict(s) for s in got.shards] == [dict(s) for s in want.shards]
        assert got.costs == want.costs
        for key, slots in got.shards[0].items():
            assert got.shard_of(key, slots[0]) == 0


def test_resnet50_largest_shard_is_one_a4608_slot(helper_pairs):
    """The slice's prediction: LPT cannot split a slot, so at K=5 the
    largest shard holds one a4608g512 slot, and K=10 keeps it."""
    _, port_helpers = helper_pairs['resnet50']
    plan = bucketing.make_bucket_plan(
        {n: h for n, h in port_helpers.items() if not h.diagonal_a})
    slot_cost = 4608 ** 3 + 512 ** 3
    total = sum(b.n_slots * (b.a_pad ** 3 + b.g_pad ** 3)
                for b in plan.buckets)
    for k in (5, 10):
        st = bucketing.make_stagger_plan(plan, k)
        assert max(st.costs) == slot_cost
        assert sum(st.costs) == total
    assert 0.20 < slot_cost / total < 0.23


def test_stagger_plan_rejects_no_shards(helper_pairs):
    pplan = bucketing.make_bucket_plan(helper_pairs['lenet'][1])
    with pytest.raises(ValueError, match='n_shards'):
        bucketing.make_stagger_plan(pplan, 0)


# -- the cadence ----------------------------------------------------------


def test_stagger_refresh_action_matches_jax():
    for step, inv, k, ready, due, boot in itertools.product(
            range(13), (1, 2, 4, 5), (1, 2, 3, 4, 6), (False, True),
            (False, True), (False, True)):
        kw = dict(factors_ready=ready, monolithic_due=due,
                  bootstrapped=boot)
        try:
            want = jax_stagger_refresh_action(step, inv, k, **kw)
        except ValueError as exc:
            with pytest.raises(ValueError, match='stale') as got:
                stagger_refresh_action(step, inv, k, **kw)
            assert str(got.value) == str(exc)
            continue
        assert stagger_refresh_action(step, inv, k, **kw) == want


def test_validation():
    net = LeNet(image_size=12)
    with pytest.raises(ValueError, match='>= 1'):
        KFACPreconditioner(net, stagger_refresh=0, **HP)
    with pytest.raises(ValueError, match='exceeds'):
        KFACPreconditioner(net, stagger_refresh=5, **HP)
    with pytest.raises(ValueError, match='exceeds'):
        KFACPreconditioner(net, stagger_refresh=5,
                           **dict(HP, inv_update_steps=lambda s: 4))
    with pytest.raises(ValueError, match='bucketed'):
        KFACPreconditioner(net, stagger_refresh=2, bucketed=False, **HP)
    with pytest.raises(ValueError, match='lowrank_rank'):
        KFACPreconditioner(net, stagger_refresh=2, lowrank_rank=8, **HP)
    with pytest.raises(ValueError, match='health'):
        KFACPreconditioner(net, stagger_refresh=2, health=object(), **HP)
    with pytest.raises(TypeError, match='HealthConfig'):
        KFACPreconditioner(net, health=object(), **HP)
    KFACPreconditioner(net, stagger_refresh=2, ekfac=True, **HP)


def test_schedule_guards_interval_shrink():
    """A lambda that takes the interval below K is rejected when it is
    built; one that dips later makes that step raise."""
    net = LeNet(image_size=12)
    p = KFACPreconditioner(net, stagger_refresh=3, **HP)
    with pytest.raises(ValueError, match='stale forever'):
        LambdaParamScheduler(p, inv_update_steps_lambda=lambda s: 0.5)
    sched = LambdaParamScheduler(
        p, inv_update_steps_lambda=lambda s: 1.0 if s < 2 else 0.5,
    )
    (x, y), = batches(1)
    for step in range(3):
        net.zero_grad()
        F.cross_entropy(net(nchw(x)), torch.from_numpy(y)).backward()
        if step == 2:
            with pytest.raises(ValueError, match='stale forever'):
                p.step()
            break
        p.step()
        sched.step()
    with pytest.raises(ValueError, match='stale forever'):
        jax_stagger_refresh_action(5, 2, 4, factors_ready=True,
                                   monolithic_due=False, bootstrapped=True)


# -- trajectories against the JAX engine -----------------------------------

VARIANTS = {
    'eigen': {},
    'eigen_noprediv': dict(compute_eigenvalue_outer_product=False),
    'ekfac': dict(ekfac=True),
    'inverse': dict(compute_method='inverse'),
    'iterative': dict(compute_method='iterative'),
}


def jax_trajectory(kw, data, variables):
    model = JaxLeNet()
    precond = JaxPreconditioner(model, loss_fn=jax_xent, **HP, **kw)
    state = precond.init(variables, data[0][0])
    params = variables['params']
    out = []
    for x, y in data:
        action = precond._refresh_plan()
        loss, _, grads, state = precond.step(
            {'params': params}, state, x, loss_args=(jnp.asarray(y),))
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        refresh = 'full' if action[1] else action[2]
        out.append(dict(
            loss=float(loss), refresh=refresh,
            factors={b: (np.asarray(state[b].a_factor),
                         np.asarray(state[b].g_factor))
                     for b in state.layers},
            grads=flax_to_torch_state_dict({'params': grads}),
        ))
    return out


def port_trajectory(kw, data, weights, want=None, accumulation=1):
    """The port's run; each step applies the JAX run's gradients when
    ``want`` is given (so both see the same weights), else its own."""
    net = LeNet(image_size=12)
    net.load_state_dict(weights, strict=True)
    p = KFACPreconditioner(net, **HP, accumulation_steps=accumulation, **kw)
    out = []
    for i, (x, y) in enumerate(data):
        net.zero_grad()
        for _ in range(accumulation):
            loss = F.cross_entropy(net(nchw(x)), torch.from_numpy(y))
            (loss / accumulation).backward()
        p.step()
        out.append(dict(
            loss=float(loss.detach()), refresh=p.last_refresh,
            factors={n: (st.a_factor.clone(), st.g_factor.clone())
                     for n, st in p.layers.items()},
            grads={n: q.grad.clone() for n, q in net.named_parameters()},
        ))
        apply = want[i]['grads'] if want is not None else out[-1]['grads']
        with torch.no_grad():
            for n, q in net.named_parameters():
                q -= LR * torch.as_tensor(apply[n])
    return p, out


@pytest.fixture(scope='module')
def trajectories():
    data = batches()
    variables = jax.tree.map(np.asarray, JaxLeNet().init(
        jax.random.PRNGKey(5), data[0][0]))
    weights = flax_to_torch_state_dict(variables)
    out = {}
    for name, kw in VARIANTS.items():
        kw = dict(kw, stagger_refresh=2)
        want = jax_trajectory(kw, data, variables)
        _, got = port_trajectory(kw, data, weights, want)
        out[name] = (want, got)
    return out


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_trajectory_matches_jax(trajectories, variant):
    want, got = trajectories[variant]
    assert [w['refresh'] for w in want] == CADENCE
    assert [g['refresh'] for g in got] == CADENCE
    np.testing.assert_allclose([g['loss'] for g in got],
                               [w['loss'] for w in want], rtol=1e-5)
    for step, (w, g) in enumerate(zip(want, got)):
        for layer, pair in w['factors'].items():
            for side in (0, 1):
                err = rel_err(g['factors'][layer][side], pair[side])
                assert err <= 1e-5, (step, layer, side, err)
        for name, grad in w['grads'].items():
            err = rel_err(g['grads'][name], grad)
            assert err <= (1e-3 if variant == 'ekfac' else 1e-4), (
                step, name, err)


# -- a shard sweep is the monolithic refresh ------------------------------


@pytest.mark.parametrize('variant', ['eigen', 'eigen_noprediv', 'ekfac',
                                     'inverse'])
def test_shard_sweep_bitwise_matches_monolithic(variant):
    data = batches(2)
    torch.manual_seed(0)
    net = LeNet(image_size=12)
    p = KFACPreconditioner(net, stagger_refresh=3, **HP, **VARIANTS[variant])
    for x, y in data:
        net.zero_grad()
        F.cross_entropy(net(nchw(x)), torch.from_numpy(y)).backward()
        p.step()
    so = p._second_order
    full = so.compute(p.layers, 0.003)
    swept = {k: dataclasses.replace(bs) for k, bs in p.buckets.items()}
    for k in range(p.stagger.n_shards):
        swept = so.compute_shard(p.layers, 0.003, k, swept)
    for key, bs in full.items():
        for field, t in bs.tensors().items():
            assert torch.equal(t, getattr(swept[key], field)), (key, field)
    with pytest.raises(ValueError, match='out of range'):
        so.compute_shard(p.layers, 0.003, 3, swept)


# -- accumulation follows the plain step's cadence --------------------------


def test_accumulation_follows_the_shard_cadence():
    """Two copies of each batch accumulated against the plain step on
    it: the same refresh every step, and the same action of the
    preconditioner, compared as the preconditioned gradients and the
    reconstructions ``q diag(d) qᵀ`` (relative Frobenius ``<= 1e-5``),
    not as raw eigenvectors."""
    data = batches(9)
    torch.manual_seed(1)
    weights = LeNet(image_size=12).state_dict()
    kw = dict(stagger_refresh=2, compute_eigenvalue_outer_product=False)
    plain, want = port_trajectory(kw, data, weights)
    accum, got = port_trajectory(kw, data, weights, accumulation=2)
    assert [g['refresh'] for g in got] == [w['refresh'] for w in want]
    assert [w['refresh'] for w in want] == CADENCE[:9]
    for step, (w, g) in enumerate(zip(want, got)):
        for name in w['grads']:
            err = rel_err(g['grads'][name], w['grads'][name])
            assert err <= 1e-5, (step, name, err)
    for key, bs in plain.buckets.items():
        other = accum.buckets[key]
        for q, d in (('qa', 'da'), ('qg', 'dg')):
            recon = [getattr(b, q) @ torch.diag_embed(getattr(b, d))
                     @ getattr(b, q).mT for b in (bs, other)]
            err = rel_err(recon[1], recon[0])
            assert err <= 1e-5, (key, q, err)


# -- the restore invariant -------------------------------------------------


@pytest.mark.parametrize('compute_inverses', [True, False])
def test_restore_invariant(compute_inverses):
    data = batches(3)
    torch.manual_seed(2)
    weights = LeNet(image_size=12).state_dict()
    p, _ = port_trajectory(dict(stagger_refresh=2), data, weights)
    assert p._stagger_bootstrapped
    sd = p.state_dict()
    net = LeNet(image_size=12)
    net.load_state_dict(weights)
    fresh = KFACPreconditioner(net, stagger_refresh=2, **HP)
    fresh.load_state_dict(sd, compute_inverses=compute_inverses)
    assert fresh._stagger_bootstrapped == compute_inverses
    # Step 3 is phase 3 (no shard); step 4 is due: a shard when the
    # restore recomputed, the monolithic bootstrap when it did not.
    for x, y in batches(2):
        net.zero_grad()
        F.cross_entropy(net(nchw(x)), torch.from_numpy(y)).backward()
        fresh.step()
    assert fresh.last_refresh == (0 if compute_inverses else 'full')
    assert fresh._stagger_bootstrapped
