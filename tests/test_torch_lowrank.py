"""The port's randomized low-rank eigen against the JAX package, on the CPU.

The sketches are where the two packages part by design: the port seeds a
``torch.Generator`` per (bucket seed, side, sketch step, slot), the JAX
package folds the same tuple into a threefry key.  Every comparison
here injects the JAX package's draw, either as ``randomized_eigh``'s
``sketch`` or by replacing ``ops.lowrank.draw_sketch`` with a function
that returns ``jax.random.normal(fold_in(fold_in(fold_in(PRNGKey(seed),
side), step), slot), (n, m))`` (the JAX bucketed stage's key chain), so
both sides run the same algorithm on the same numbers.  Results are
compared, never raw eigenvectors (the QR's signs are LAPACK's choice).

Op level: the four cases of ``precondition_grad_lowrank`` on factors
that satisfy the truncated-spectrum model exactly (relative Frobenius
``<= 1e-5`` against JAX; measured at most 3.9e-7), ``randomized_eigh`` on
JAX's sketch (``d``, ``sigma`` and the reconstruction ``Q diag(d) Q^T +
sigma (I - Q Q^T)`` at ``<= 1e-5``), its exact fallback, the PSD clamp,
``effective_dim``, ``batched_randomized_eigh`` with per-slot draws, and
the engagement rule and thin allocations.

End to end: ``MLP(128, 128, 4)`` on JAX's ``make_classification(0, 64,
32, 4)`` (every bucket low-rank, both sides or A only), an
``MLP(128, 4)`` on 8 inputs (G only) and LeNet at 12x12 (exact
``a32g32``, A-only and two-sided buckets), ``lowrank_rank=16``, factor
1, inv 3 (refreshes at steps 0 and 3), 5 steps from the same bridged
weights with the same numpy SGD updates: losses ``rtol 1e-5``, factor
EMAs ``<= 1e-5``, preconditioned gradients ``<= 1e-4`` (QR and the
small ``eigh`` run in f32 on two LAPACK builds), the kl-clip scale
``<= 1e-4`` (JAX's ``observe/kl_nu``).  A checkpoint taken after the
step-3 refresh restores the same draws: the recomputed buckets are
bitwise those of the saving run.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
from kfac_pytorch_tpu.observe import ObserveConfig
from kfac_pytorch_tpu.ops import lowrank as jlowrank
from kfac_pytorch_tpu.ops.eigen import compute_factor_eigen
from kfac_pytorch_tpu.ops.eigen import precondition_grad_eigen
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu.testing import make_classification
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import LeNet
from kfac_pytorch_tpu_torch.models import MLP
from kfac_pytorch_tpu_torch.ops import lowrank

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

DAMPING = 0.003


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def jax_draw(seed, side, step, slot, n, m, device='cpu') -> torch.Tensor:
    """The JAX bucketed stage's sketch for one slot
    (``second_order.py:1256-1271``, ``lowrank.py:233-236``)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), side), step), slot)
    return t(jax.random.normal(key, (n, m), jnp.float32)).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    """Route every port sketch through :func:`jax_draw`; records the
    ``(seed, side, step, slot, n, m)`` of each draw."""
    calls = []

    def draw(seed, side, step, slot, n, m, device):
        calls.append((seed, side, step, slot, n, m))
        return jax_draw(seed, side, step, slot, n, m, device)

    monkeypatch.setattr(lowrank, 'draw_sketch', draw)
    return calls


# -- op level ----------------------------------------------------------


def _model_factor(n, k, sigma, rng):
    """A PSD matrix exactly of the truncated-spectrum form."""
    q, _ = np.linalg.qr(rng.standard_normal((n, n)).astype(np.float32))
    qk = q[:, :k]
    d = np.sort(rng.uniform(5.0, 50.0, k).astype(np.float32))[::-1]
    f = qk @ np.diag(d) @ qk.T + sigma * (np.eye(n) - qk @ qk.T)
    return (f.astype(np.float32), qk.copy(), d.copy(), np.float32(sigma))


@pytest.fixture(scope='module')
def factors():
    rng = np.random.default_rng(0)
    A, qa, da, sa = _model_factor(96, 12, 0.11, rng)
    G, qg, dg, sg = _model_factor(64, 8, 0.07, rng)
    grad = rng.standard_normal((64, 96)).astype(np.float32)
    ea = compute_factor_eigen(jnp.asarray(A))
    eg = compute_factor_eigen(jnp.asarray(G))
    ref = precondition_grad_eigen(
        jnp.asarray(grad), ea.q, eg.q, da=ea.d, dg=eg.d, damping=DAMPING,
    )
    return dict(A=A, qa=qa, da=da, sa=sa, G=G, qg=qg, dg=dg, sg=sg,
                grad=grad, ea=(np.asarray(ea.q), np.asarray(ea.d)),
                eg=(np.asarray(eg.q), np.asarray(eg.d)),
                ref=np.asarray(ref))


def _sides(f, case):
    """``(a, g, lowrank_a, lowrank_g)`` triples of one case, numpy."""
    lr_a, lr_g = case
    a = ((f['qa'], f['da'], f['sa']) if lr_a
         else (*f['ea'], np.float32(0.0)))
    g = ((f['qg'], f['dg'], f['sg']) if lr_g
         else (*f['eg'], np.float32(0.0)))
    return a, g, lr_a, lr_g


CASES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize('case', CASES,
                         ids=['both', 'a_only', 'g_only', 'exact'])
def test_precondition_grad_lowrank_matches_jax(factors, case):
    a, g, lr_a, lr_g = _sides(factors, case)
    got = lowrank.precondition_grad_lowrank(
        t(factors['grad']), tuple(map(t, a)), tuple(map(t, g)), DAMPING,
        lowrank_a=lr_a, lowrank_g=lr_g,
    )
    want = jlowrank.precondition_grad_lowrank(
        jnp.asarray(factors['grad']), tuple(map(jnp.asarray, a)),
        tuple(map(jnp.asarray, g)), DAMPING, lowrank_a=lr_a,
        lowrank_g=lr_g,
    )
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-5
    # The factor model holds exactly, so both equal the dense eigen
    # preconditioner (the JAX test's bound).
    err = float(np.abs(got.numpy() - factors['ref']).max()
                / np.abs(factors['ref']).max())
    assert err < 1e-3


def test_precondition_grad_lowrank_batched_equals_per_slot(factors):
    """A stack of slots (the bucket path) gives each slot's own result."""
    a, g, _, _ = _sides(factors, (True, True))
    rng = np.random.default_rng(5)
    grads = rng.standard_normal((3, 64, 96)).astype(np.float32)

    def stack(x):
        return torch.stack([t(x)] * 3)

    got = lowrank.precondition_grad_lowrank(
        t(grads), tuple(map(stack, a)), tuple(map(stack, g)), DAMPING,
        lowrank_a=True, lowrank_g=True,
    )
    for i in range(3):
        one = lowrank.precondition_grad_lowrank(
            t(grads[i]), tuple(map(t, a)), tuple(map(t, g)), DAMPING,
            lowrank_a=True, lowrank_g=True,
        )
        torch.testing.assert_close(got[i], one, rtol=1e-6, atol=1e-6)


def _reconstruct(q, d, sigma):
    q, d = np.asarray(q, np.float64), np.asarray(d, np.float64)
    n = q.shape[0]
    return q @ np.diag(d) @ q.T + float(sigma) * (np.eye(n) - q @ q.T)


def test_randomized_eigh_on_jax_sketch_matches_jax(factors):
    key = jax.random.PRNGKey(3)
    want = jlowrank.randomized_eigh(
        jnp.asarray(factors['A']), 12, oversample=16, power_iters=2,
        key=key,
    )
    sketch = t(jax.random.normal(key, (96, 28), jnp.float32))
    got = lowrank.randomized_eigh(
        t(factors['A']), 12, oversample=16, power_iters=2, sketch=sketch,
    )
    assert got.q.shape == (96, 12) and got.d.shape == (12,)
    assert rel_err(np.sort(got.d.numpy()), np.sort(np.asarray(want.d))) \
        <= 1e-5
    assert abs(float(got.sigma) - float(want.sigma)) <= 1e-5 * abs(
        float(want.sigma)) + 1e-7
    assert rel_err(_reconstruct(*got), _reconstruct(*want)) <= 1e-5
    np.testing.assert_allclose(np.sort(got.d.numpy()),
                               np.sort(factors['da']), rtol=1e-3, atol=1e-2)
    assert abs(float(got.sigma) - 0.11) < 2e-2


def test_randomized_eigh_exact_fallback_matches_jax(factors):
    got = lowrank.randomized_eigh(t(factors['A']), 90, oversample=32)
    want = jlowrank.randomized_eigh(jnp.asarray(factors['A']), 90,
                                    oversample=32)
    assert got.q.shape == (96, 96) and float(got.sigma) == 0.0
    assert rel_err(got.d, want.d) <= 1e-5
    assert rel_err(_reconstruct(*got), _reconstruct(*want)) <= 1e-5


def test_randomized_eigh_psd_clamp_and_effective_dim():
    rng = np.random.default_rng(1)
    m = rng.standard_normal((48, 48)).astype(np.float32)
    sym = (m + m.T) / 2
    key = jax.random.PRNGKey(0)
    sketch = t(jax.random.normal(key, (48, 16), jnp.float32))
    got = lowrank.randomized_eigh(t(sym), 8, oversample=8, power_iters=1,
                                  sketch=sketch)
    assert float(got.d.min()) >= 0.0 and float(got.sigma) >= 0.0
    # A zero-padded factor: sigma averages over the logical dims only.
    f, *_ = _model_factor(40, 6, 0.2, rng)
    padded = np.zeros((64, 64), np.float32)
    padded[:40, :40] = f
    sketch = t(jax.random.normal(key, (64, 22), jnp.float32))
    for eff in (None, 40):
        got = lowrank.randomized_eigh(t(padded), 6, oversample=16,
                                      sketch=sketch, effective_dim=eff)
        want = jlowrank.randomized_eigh(jnp.asarray(padded), 6,
                                        oversample=16, key=key,
                                        effective_dim=eff)
        assert abs(float(got.sigma) - float(want.sigma)) <= 1e-5 * float(
            want.sigma)
    assert abs(float(got.sigma) - 0.2) < 2e-2


def test_batched_randomized_eigh_draws_per_slot(jax_draws, factors):
    """Slot ``i`` of a stack draws ``(seed, side, step, slots[i])``; with
    JAX's draws the stack matches the JAX batched call on its base key,
    slot by slot, over the logical dims."""
    rng = np.random.default_rng(2)
    stack = np.stack([factors['A'], _model_factor(96, 12, 0.3, rng)[0]])
    dims = [96, 90]
    got = lowrank.batched_randomized_eigh(
        t(stack), 12, oversample=16, power_iters=2, seed=7, side=1,
        step=4, slots=[3, 5], effective_dims=dims,
    )
    assert [c[3] for c in jax_draws] == [3, 5]
    base = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(7), 1), 4)
    for i, slot in enumerate((3, 5)):
        want = jlowrank.randomized_eigh(
            jnp.asarray(stack[i]), 12, oversample=16, power_iters=2,
            key=jax.random.fold_in(base, slot), effective_dim=dims[i],
        )
        one = lowrank.LowRankEigen(got.q[i], got.d[i], got.sigma[i])
        assert rel_err(_reconstruct(*one), _reconstruct(*want)) <= 1e-5
    exact = lowrank.decompose_stack(
        t(stack), False, 12, oversample=16, power_iters=2, seed=7, side=1,
        step=4,
    )
    assert exact.q.shape == (2, 96, 96) and not exact.sigma.any()


@pytest.mark.parametrize('dim,k,oversample', [
    (64, 16, 32), (32, 16, 32), (48, 16, 32), (192, 16, 32),
    (4608, 512, 32), (544, 512, 32), (1024, 512, 32), (2176, 512, 32),
    (10, None, 32),
])
def test_lowrank_engages_and_thin_fields_match_jax(dim, k, oversample):
    assert lowrank.lowrank_engages(dim, k, oversample) == (
        jlowrank.lowrank_engages(dim, k, oversample))
    got = lowrank.thin_eigen_fields((2,), dim, 64, k, oversample,
                                    torch.float32)
    want = jlowrank.thin_eigen_fields((2,), dim, 64, k, oversample,
                                      jnp.float32)
    if want is None:
        assert got is None
        return
    assert {n: None if v is None else tuple(v.shape)
            for n, v in got.items()} == {
        n: None if v is None else tuple(v.shape) for n, v in want.items()}


# -- end to end ----------------------------------------------------------

LR = 0.1
STEPS = 5
HP = dict(factor_update_steps=1, inv_update_steps=3, damping=DAMPING,
          kl_clip=0.001, lr=LR, lowrank_rank=16)
MODELS = {
    'mlp': dict(features=(128, 128, 4), d=32, classes=4),
    'mlp_g': dict(features=(128, 4), d=8, classes=4),
    'lenet': dict(features=None, d=None, classes=10),
}


def data(name):
    """Per step ``(x, y)`` numpy: JAX's ``make_classification`` for the
    MLPs (shifted per step), seeded images for LeNet (NHWC)."""
    cfg = MODELS[name]
    if name == 'lenet':
        rng = np.random.default_rng(9)
        return [(rng.standard_normal((16, 12, 12, 1)).astype(np.float32),
                 rng.integers(0, 10, size=16)) for _ in range(STEPS)]
    out = []
    for s in range(STEPS):
        x, y = make_classification(s, n=64, d=cfg['d'],
                                   classes=cfg['classes'])
        out.append((np.array(x, np.float32), np.array(y, np.int64)))
    return out


def jax_model(name):
    if name == 'lenet':
        return JaxLeNet()
    return JaxMLP(features=MODELS[name]['features'])


def port_model(name):
    if name == 'lenet':
        return LeNet(image_size=12)
    return MLP(MODELS[name]['d'], MODELS[name]['features'])


def xent(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))


def jax_trajectory(name, variables):
    model = jax_model(name)
    precond = JaxPreconditioner(model, loss_fn=xent, observe=ObserveConfig(),
                                **HP)
    batches = data(name)
    state = precond.init(variables, batches[0][0])
    params = variables['params']
    trace = []
    for x, y in batches:
        loss, _, grads, state = precond.step(
            {'params': params}, state, x, loss_args=(jnp.asarray(y),),
        )
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        factors = {b.replace('/', '.'): (np.asarray(state[b].a_factor),
                                         np.asarray(state[b].g_factor))
                   for b in state.layers}
        trace.append((float(loss), factors,
                      flax_to_torch_state_dict({'params': grads}),
                      float(precond.last_step_info['observe/kl_nu'])))
    return precond, trace


def port_trajectory(name, variables, jax_trace):
    model = port_model(name)
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    precond = KFACPreconditioner(model, **HP)
    trace, saved = [], None
    for step, (x, y) in enumerate(data(name)):
        xt = torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy() if x.ndim == 4 else x)
        model.zero_grad()
        loss = F.cross_entropy(model(xt), torch.from_numpy(y))
        loss.backward()
        precond.step()
        factors = {k: (st.a_factor.clone(), st.g_factor.clone())
                   for k, st in precond.layers.items()}
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        trace.append((float(loss.detach()), factors, grads,
                      float(precond.last_kl_scale)))
        if step == HP['inv_update_steps']:
            saved = (precond.state_dict(),
                     {k: bs.tensors() for k, bs in precond.buckets.items()})
        with torch.no_grad():
            for k, p in model.named_parameters():
                p -= LR * jax_trace[step][2][k]
    return precond, trace, saved


@pytest.fixture(scope='module', params=list(MODELS))
def runs(request):
    name = request.param
    batches = data(name)
    variables = jax.tree.map(np.asarray, jax_model(name).init(
        jax.random.PRNGKey(4), batches[0][0]))
    jprecond, jax_trace = jax_trajectory(name, variables)
    mp = pytest.MonkeyPatch()
    calls = []

    def draw(seed, side, step, slot, n, m, device):
        calls.append((seed, side, step, slot))
        return jax_draw(seed, side, step, slot, n, m, device)

    mp.setattr(lowrank, 'draw_sketch', draw)
    try:
        precond, port_trace, saved = port_trajectory(
            name, variables, jax_trace)
    finally:
        mp.undo()
    return dict(name=name, jax=jax_trace, port=port_trace, precond=precond,
                jprecond=jprecond, saved=saved, calls=calls)


def test_lowrank_buckets_engage_as_jax(runs):
    so, jso = runs['precond']._second_order, runs['jprecond']._second_order
    assert so._lowrank == jso._lowrank
    assert so._bucket_seed == jso._bucket_seed
    assert any(any(v) for v in so._lowrank.values())
    if runs['name'] == 'mlp_g':
        assert (False, True) in so._lowrank.values()
    for b in so.plan.buckets:
        la, lg = so._lowrank[b.key]
        bs = runs['precond'].buckets[b.key]
        assert bs.qa.shape[-1] == (16 if la else b.a_pad)
        assert bs.qg.shape[-1] == (16 if lg else b.g_pad)
        assert (bs.sa is not None) == la and (bs.sg is not None) == lg
        assert (bs.dgda is not None) == (not (la or lg))
    # Draws at the two refresh steps only, for every truncated side.
    assert {c[2] for c in runs['calls']} == {0, HP['inv_update_steps']}


@pytest.mark.parametrize('step', range(STEPS))
def test_lowrank_losses_and_factors_match_jax(runs, step):
    got, want = runs['port'][step], runs['jax'][step]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert set(got[1]) == set(want[1])
    for layer, pair in want[1].items():
        for side in (0, 1):
            err = rel_err(got[1][layer][side], pair[side])
            assert err <= 1e-5, (layer, side, err)


@pytest.mark.parametrize('step', range(STEPS))
def test_lowrank_preconditioned_grads_match_jax(runs, step):
    got, want = runs['port'][step], runs['jax'][step]
    assert set(got[2]) == set(want[2])
    for k, g in want[2].items():
        err = rel_err(got[2][k], g)
        assert err <= 1e-4, (k, err)
    assert abs(got[3] - want[3]) <= 1e-4 * abs(want[3])


def test_lowrank_resume_draws_the_same_sketches(runs):
    """A checkpoint records the last inverse-update step; the restore's
    recompute draws the port's own sketches for it again and gives the
    saving run's buckets bitwise."""
    sd, buckets = runs['saved']
    assert sd['sketch_step'] == HP['inv_update_steps']
    model = port_model(runs['name'])
    precond = KFACPreconditioner(model, **HP)
    saver = KFACPreconditioner(port_model(runs['name']), **HP)
    saver.load_state_dict(sd)
    precond.load_state_dict(saver.state_dict())
    for key, fields in saver.buckets.items():
        for f, v in fields.tensors().items():
            assert torch.equal(precond.buckets[key].tensors()[f], v), f
    # And the restore reproduces the saving run's decompositions when it
    # draws what that run drew (the JAX draws here).
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lowrank, 'draw_sketch', jax_draw)
        precond.load_state_dict(sd)
    for key, fields in buckets.items():
        for f, v in fields.items():
            assert torch.equal(precond.buckets[key].tensors()[f], v), f


@pytest.mark.parametrize('kwargs,match', [
    (dict(compute_method='inverse', lowrank_rank=8), 'EIGEN'),
    (dict(bucketed=False, lowrank_rank=8), 'bucketed'),
    (dict(lowrank_rank=0), '>= 1'),
    (dict(ekfac=True, lowrank_rank=8), 'mutually exclusive'),
])
def test_lowrank_validation_matches_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        KFACPreconditioner(MLP(8, (8, 4)), **kwargs)
    if 'bucketed' in kwargs or kwargs.get('lowrank_rank') == 0:
        return
    with pytest.raises(ValueError, match=match):
        JaxPreconditioner(JaxMLP(features=(8, 4)), loss_fn=xent, **kwargs)
