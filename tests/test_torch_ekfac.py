"""The port's EKFAC and drift-triggered refresh against the JAX package,
on the CPU.

Op level (``ekfac_scale_contrib`` and its stacked form, the drift):
against a brute-force per-row sum in float64 (dense rows, and conv rows
with their ``spatial_size`` norms), against the JAX functions on the
same numpy inputs (relative Frobenius ``<= 1e-5``), the padded-basis
identity, and the independence limit (``S -> outer(dg, da)``).  The
rows the helpers build pair the same example and position on both
sides: for a conv layer ``g_rows^T a_rows`` is the weight gradient
itself, which a misordered side would scramble.

End to end, from the same bridged weights with the same numpy SGD
updates (the JAX side's gradients): an MLP (MSE loss, as the JAX EKFAC
tests train it) and LeNet at 12x12 (cross entropy), factor 1, inv 3,
5 steps: losses ``rtol 1e-5``, factor EMAs ``<= 1e-5``; every
bucket's ``skron`` (its refresh reseed and each factor step's EMA), the
drift and the preconditioned gradients at ``<= 1e-5`` from one basis
(JAX's step-0 decompositions and scales installed in the port), and
along the trajectory, where each package's ``eigh`` picks its own basis
inside near-degenerate clusters, scales, drift, preconditioned
gradients and kl-clip scale at ``<= 1e-4``.  Right after a refresh
``skron`` is ``dg ⊗ da`` bitwise.  With ``accumulation_steps=4`` the
port's ``step()`` against JAX ``accumulate``/``finalize`` the same way
(the same-basis step included), and a step whose sums were
dropped keeps every ``skron``.  The drift controller
(:class:`AdaptiveRefresh`) refreshes at the same steps as the JAX run on
the same inputs.  Checkpoints: ``include_ekfac_scales`` round trips
bitwise, a JAX checkpoint's scales load into the port, and the JAX
validation errors are raised alike.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu.adaptive import AdaptiveRefresh as JaxAdaptiveRefresh
from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
from kfac_pytorch_tpu.observe import ObserveConfig
from kfac_pytorch_tpu.ops import ekfac as jekfac
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu_torch import AdaptiveRefresh
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.convert import jax_kfac_state_dict_to_torch
from kfac_pytorch_tpu_torch.layers.helpers import ConvHelper
from kfac_pytorch_tpu_torch.layers.helpers import DenseHelper
from kfac_pytorch_tpu_torch.models import LeNet
from kfac_pytorch_tpu_torch.models import MLP

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

REL = 1e-5


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def orth(rng, n):
    return np.linalg.qr(rng.standard_normal((n, n)))[0].astype(np.float32)


# -- op level ----------------------------------------------------------


@pytest.mark.parametrize('norms', [(1.0, 1.0), (4.0, 4.0), (9.0, 1.0)],
                         ids=['dense', 'conv', 'mixed'])
def test_scale_contrib_matches_bruteforce_and_jax(norms):
    rng = np.random.default_rng(0)
    r, a_dim, g_dim = 64, 7, 5
    a_rows = rng.standard_normal((r, a_dim)).astype(np.float32)
    g_rows = rng.standard_normal((r, g_dim)).astype(np.float32)
    qa, qg = orth(rng, a_dim), orth(rng, g_dim)
    an, gn = norms
    got = ops.ekfac_scale_contrib(t(a_rows), t(g_rows), t(qa), t(qg),
                                  a_norm=an, g_norm=gn)
    # Brute force: the mean over rows of outer((qg^T g)^2, (qa^T a)^2),
    # rows normalized, one row at a time in float64.
    want = np.zeros((g_dim, a_dim))
    for a, g in zip(a_rows.astype(np.float64), g_rows.astype(np.float64)):
        want += np.outer((qg.T @ (g / gn)) ** 2, (qa.T @ (a / an)) ** 2)
    want /= r
    assert got.dtype == torch.float32 and got.shape == (g_dim, a_dim)
    assert rel_err(got, want) <= REL
    jax_got = jekfac.ekfac_scale_contrib(
        jnp.asarray(a_rows), jnp.asarray(g_rows), jnp.asarray(qa),
        jnp.asarray(qg), a_norm=an, g_norm=gn,
    )
    assert rel_err(got, jax_got) <= REL


def test_padded_basis_equals_sliced_rows():
    rng = np.random.default_rng(2)
    n, a_dim, pad = 32, 5, 8
    a_rows = rng.standard_normal((n, a_dim)).astype(np.float32)
    g_rows = rng.standard_normal((n, 3)).astype(np.float32)
    qa_pad = orth(rng, pad)
    qg = np.eye(3, dtype=np.float32)
    sliced = ops.ekfac_scale_contrib(t(a_rows), t(g_rows),
                                     t(qa_pad[:a_dim]), t(qg))
    padded = np.zeros((n, pad), np.float32)
    padded[:, :a_dim] = a_rows
    full = ops.ekfac_scale_contrib(t(padded), t(g_rows), t(qa_pad), t(qg))
    torch.testing.assert_close(sliced, full, rtol=1e-5, atol=1e-7)


def test_independence_limit_reduces_to_kfac():
    rng = np.random.default_rng(3)
    n, a_dim, g_dim = 200_000, 4, 3
    a_rows = rng.standard_normal((n, a_dim)).astype(np.float32)
    g_rows = rng.standard_normal((n, g_dim)).astype(np.float32)
    A = a_rows.T.astype(np.float64) @ a_rows / n
    G = g_rows.T.astype(np.float64) @ g_rows / n
    da, qa = np.linalg.eigh(A)
    dg, qg = np.linalg.eigh(G)
    got = ops.ekfac_scale_contrib(t(a_rows), t(g_rows), t(qa), t(qg))
    np.testing.assert_allclose(got.numpy(), np.outer(dg, da), rtol=0.05,
                               atol=0.01)


def test_stacked_matches_per_slice_and_jax():
    rng = np.random.default_rng(4)
    L, r, a_dim, g_dim = 3, 16, 6, 4
    a_rows = rng.standard_normal((L, r, a_dim)).astype(np.float32)
    g_rows = rng.standard_normal((L, r, g_dim)).astype(np.float32)
    a_rows[1, 10:] = 0.0  # masked rows
    qa = np.stack([orth(rng, a_dim) for _ in range(L)])
    qg = np.stack([orth(rng, g_dim) for _ in range(L)])
    got = ops.ekfac_scale_contrib_stacked(t(a_rows), t(g_rows), t(qa),
                                          t(qg), count=10)
    for i in range(L):
        one = ops.ekfac_scale_contrib(t(a_rows[i]), t(g_rows[i]), t(qa[i]),
                                      t(qg[i]))
        torch.testing.assert_close(got[i], one * r / 10, rtol=1e-5,
                                   atol=1e-7)
    want = jekfac.ekfac_scale_contrib_stacked(
        *map(jnp.asarray, (a_rows, g_rows, qa, qg)), count=10)
    assert rel_err(got, want) <= REL


def test_misaligned_rows_raise():
    with pytest.raises(ValueError, match='aligned'):
        ops.ekfac_scale_contrib(torch.zeros(4, 3), torch.zeros(5, 2),
                                torch.eye(3), torch.eye(2))
    with pytest.raises(ValueError, match='aligned'):
        ops.ekfac_scale_contrib_stacked(
            torch.zeros(2, 4, 3), torch.zeros(2, 5, 2),
            torch.eye(3).expand(2, 3, 3), torch.eye(2).expand(2, 2, 2), 4)


def test_divergence_and_info_match_jax():
    rng = np.random.default_rng(5)
    entries = [(rng.random((2, 4, 6)).astype(np.float32),
                rng.random((2, 6)).astype(np.float32),
                rng.random((2, 4)).astype(np.float32)),
               (rng.random((3, 5)).astype(np.float32),
                rng.random(5).astype(np.float32),
                rng.random(3).astype(np.float32))]
    got = ops.ekfac_divergence([tuple(map(t, e)) for e in entries])
    want = jekfac.ekfac_divergence(
        [tuple(map(jnp.asarray, e)) for e in entries])
    assert abs(float(got) - float(want)) <= REL * float(want)

    class St:
        def __init__(self, skron, da, dg):
            self.skron, self.da, self.dg = skron, da, dg

    info = ops.ekfac_divergence_info({
        'a': St(*map(t, entries[1])), 'b': St(None, None, None)})
    assert abs(float(info['ekfac_divergence'])
               - float(jekfac.ekfac_divergence(
                   [tuple(map(jnp.asarray, entries[1]))]))) <= 1e-6


def test_conv_rows_pair_the_same_positions():
    """``g_rows^T a_rows`` is the combined weight gradient of a strided,
    padded conv with bias, and ``cov_from_rows`` of each side is the
    helper's factor: the two sides' rows run (n, oh, ow) alike."""
    torch.manual_seed(0)
    conv = nn.Conv2d(3, 5, 3, stride=2, padding=1)
    helper = ConvHelper(name='c', module=conv, has_bias=True, in_features=3,
                        out_features=5, kernel_size=(3, 3), strides=(2, 2),
                        padding=(1, 1))
    x = torch.randn(2, 3, 9, 7)
    out = conv(x)
    g = torch.randn_like(out)
    out.backward(g)
    a_rows, an = helper.get_a_rows(x)
    g_rows, gn = helper.get_g_rows(g)
    assert a_rows.shape[0] == g_rows.shape[0] == 2 * 5 * 4
    torch.testing.assert_close(g_rows.mT @ a_rows, helper.get_grad(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ops.cov_from_rows(a_rows, an),
                               helper.get_a_factor(x))
    torch.testing.assert_close(ops.cov_from_rows(g_rows, gn),
                               helper.get_g_factor(g))
    lin = nn.Linear(4, 3)
    dense = DenseHelper(name='d', module=lin, has_bias=True, in_features=4,
                        out_features=3)
    assert dense.supports_ekfac and helper.supports_ekfac
    xa = torch.randn(6, 4)
    torch.testing.assert_close(
        ops.cov_from_rows(*dense.get_a_rows(xa)), dense.get_a_factor(xa))


def test_shared_module_rows_pair_by_call():
    """A module called twice: backward delivers the second call's output
    gradient first, and the capture still files each gradient under its
    own call, so the EKFAC contribution is the mean of each call's own
    rows' statistic."""
    torch.manual_seed(1)
    model = nn.Linear(3, 2)
    precond = KFACPreconditioner(model, ekfac=True, inv_update_steps=10)
    x1, x2 = torch.randn(4, 3), torch.randn(4, 3)
    out1, out2 = model(x1), model(x2)
    g1, g2 = torch.randn(4, 2), torch.randn(4, 2)
    (out1 * g1 + out2 * g2 * 3.0).sum().backward()
    ((_, acts, grads),) = precond._capture.take()['']
    assert [torch.equal(a, x) for a, x in zip(acts, (x1, x2))] == [True] * 2
    torch.testing.assert_close(grads[0], g1)
    torch.testing.assert_close(grads[1], g2 * 3.0)


# -- end to end --------------------------------------------------------

LR = 0.1
STEPS = 5
HP = dict(factor_update_steps=1, inv_update_steps=3, damping=0.003,
          kl_clip=0.001, lr=LR, factor_decay=0.9, ekfac=True)
MODELS = ('mlp', 'lenet')


def batches(name, steps=STEPS, rows=16, scale_up=False):
    """Per step ``(x, y)`` numpy (NHWC for LeNet); ``scale_up`` scales
    step ``i``'s inputs by ``1 + i`` so the scales drift."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(steps):
        if name == 'lenet':
            x = rng.standard_normal((rows, 12, 12, 1)).astype(np.float32)
            y = rng.integers(0, 10, size=rows)
        else:
            x = rng.standard_normal((rows, 8)).astype(np.float32)
            y = rng.standard_normal((rows, 4)).astype(np.float32)
        if scale_up:
            x = x * np.float32(1.0 + i)
        out.append((x, y))
    return out


def jax_model(name):
    return JaxLeNet() if name == 'lenet' else JaxMLP(features=(16, 4))


def port_model(name):
    return LeNet(image_size=12) if name == 'lenet' else MLP(8, (16, 4))


def jax_loss(name):
    if name == 'lenet':
        def xent(logits, labels):
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(
                jnp.take_along_axis(logp, labels[:, None], axis=1))
        return xent
    return lambda out, y: jnp.mean((out - y) ** 2)


def port_loss(name, out, y):
    if name == 'lenet':
        return F.cross_entropy(out, torch.from_numpy(np.asarray(y, np.int64)))
    return F.mse_loss(out, torch.from_numpy(y))


def to_port_x(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy() if x.ndim == 4
                            else x.copy())


def init_variables(name):
    x = batches(name)[0][0]
    return jax.tree.map(np.asarray,
                        jax_model(name).init(jax.random.PRNGKey(1), x))


def record(precond_state_buckets):
    return {k: np.array(bs.skron) for k, bs in precond_state_buckets.items()
            if bs.skron is not None}


def jax_run(name, variables, data, accumulation=1, **kw):
    hp = dict(HP, **kw)
    precond = JaxPreconditioner(
        jax_model(name), loss_fn=jax_loss(name), observe=ObserveConfig(),
        accumulation_steps=accumulation, **hp)
    state = precond.init(variables, data[0][0])
    params = variables['params']
    trace = []
    accum = precond.init_accum() if accumulation > 1 else None
    for x, y in data:
        if accumulation == 1:
            loss, _, grads, state = precond.step(
                {'params': params}, state, x, loss_args=(jnp.asarray(y),))
        else:
            total, losses = None, []
            for xm, ym in zip(np.split(x, accumulation),
                              np.split(y, accumulation)):
                loss, _, g, accum = precond.accumulate(
                    {'params': params}, state, accum, xm,
                    loss_args=(jnp.asarray(ym),))
                losses.append(float(loss))
                total = g if total is None else jax.tree.map(jnp.add,
                                                             total, g)
            grads, state, accum = precond.finalize(
                state, jax.tree.map(lambda g: g / accumulation, total),
                accum)
            loss = np.mean(losses)
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        info = precond.last_step_info
        trace.append(dict(
            loss=float(loss),
            factors={b.replace('/', '.'): (np.asarray(state[b].a_factor),
                                           np.asarray(state[b].g_factor))
                     for b in state.layers},
            skron=record(state.buckets),
            div=(float(info['ekfac_divergence'])
                 if 'ekfac_divergence' in info else None),
            grads=flax_to_torch_state_dict({'params': grads}),
            kl=float(info['observe/kl_nu']),
            buckets={k: {f: np.array(getattr(bs, f))
                         for f in ('qa', 'qg', 'da', 'dg', 'skron')}
                     for k, bs in state.buckets.items()},
        ))
    return precond, state, trace


def port_run(name, variables, data, jax_trace, accumulation=1,
             same_basis=False, **kw):
    """The port's run on ``data`` (SGD with the JAX run's gradients);
    with ``same_basis`` the JAX run's step-0 decompositions and scales
    replace the port's after step 0, so later steps start from the same
    basis."""
    hp = dict(HP, **kw)
    model = port_model(name)
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    precond = KFACPreconditioner(model, accumulation_steps=accumulation,
                                 **hp)
    trace = []
    refreshed = []
    orig = precond._refresh

    def spy(damping):
        refreshed.append(precond.steps)
        out = orig(damping)
        refreshed_bits.append(all(
            torch.equal(bs.skron,
                        bs.dg[:, :, None] * bs.da[:, None, :])
            for bs in precond.buckets.values()))
        return out

    refreshed_bits: list[bool] = []
    precond._refresh = spy
    for step, (x, y) in enumerate(data):
        model.zero_grad()
        losses = []
        for xm, ym in zip(np.split(x, accumulation),
                          np.split(y, accumulation)):
            loss = port_loss(name, model(to_port_x(xm)), ym)
            (loss / accumulation).backward()
            losses.append(float(loss.detach()))
        precond.step()
        if same_basis and step == 0:
            for key, fields in jax_trace[0]['buckets'].items():
                for f, v in fields.items():
                    setattr(precond.buckets[key], f, t(v))
        div = precond.last_ekfac_divergence
        trace.append(dict(
            loss=float(np.mean(losses)),
            factors={k: (st.a_factor.clone(), st.g_factor.clone())
                     for k, st in precond.layers.items()},
            skron=record(precond.buckets),
            div=None if div is None else float(div),
            grads={k: p.grad.clone() for k, p in model.named_parameters()},
            kl=float(precond.last_kl_scale),
        ))
        with torch.no_grad():
            for k, p in model.named_parameters():
                p -= LR * jax_trace[step]['grads'][k]
    return dict(precond=precond, trace=trace, refreshed=refreshed,
                reseed_bitwise=refreshed_bits, model=model)


@pytest.fixture(scope='module', params=MODELS)
def runs(request):
    name = request.param
    variables = init_variables(name)
    data = batches(name)
    jprecond, jstate, jax_trace = jax_run(name, variables, data)
    port = port_run(name, variables, data, jax_trace)
    return dict(name=name, jax=jax_trace, jprecond=jprecond, jstate=jstate,
                variables=variables, **port)


def check_step(got, want, basis_rel=1e-4):
    """One step against JAX's: loss and factor EMAs at ``1e-5``; the
    scales, drift, preconditioned gradients and kl-clip scale at
    ``basis_rel``, since each lives in an ``eigh`` basis, which two
    LAPACK builds resolve differently inside near-degenerate clusters
    (measured up to 2.7e-5 on the scales a step after a refresh, 7.5e-5
    on LeNet's gradients; ``1e-5`` when both start from one basis)."""
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    for layer, pair in want['factors'].items():
        for side in (0, 1):
            err = rel_err(got['factors'][layer][side], pair[side])
            assert err <= REL, (layer, side, err)
    assert set(got['skron']) == set(want['skron'])
    for key, s in want['skron'].items():
        err = rel_err(got['skron'][key], s)
        assert err <= basis_rel, (key, err)
    if want['div'] is None:
        assert got['div'] is None
    else:
        assert abs(got['div'] - want['div']) <= basis_rel * max(
            want['div'], 1e-3)
    for k, g in want['grads'].items():
        err = rel_err(got['grads'][k], g)
        assert err <= basis_rel, (k, err)
    assert abs(got['kl'] - want['kl']) <= basis_rel * abs(want['kl'])


@pytest.mark.parametrize('step', range(STEPS))
def test_ekfac_trajectory_matches_jax(runs, step):
    check_step(runs['trace'][step], runs['jax'][step])


@pytest.mark.parametrize('name', MODELS)
@pytest.mark.parametrize('accumulation', [1, 4], ids=['step', 'accum4'])
def test_ekfac_factor_step_in_the_same_basis_matches_jax(name, accumulation):
    """From JAX's step-0 decompositions and scales, one factor step's
    scale EMA, drift and preconditioned gradients agree at ``1e-5``."""
    variables = init_variables(name)
    data = batches(name, steps=2)
    _, _, jax_trace = jax_run(name, variables, data,
                              accumulation=accumulation)
    port = port_run(name, variables, data, jax_trace,
                    accumulation=accumulation, same_basis=True)
    got, want = port['trace'][1], jax_trace[1]
    check_step(got, want, basis_rel=REL)
    assert got['div'] > 0


def test_ekfac_refresh_reseeds_skron_bitwise(runs):
    """Every refresh leaves ``skron == dg ⊗ da`` bitwise; every bucket
    keeps ``da``/``dg`` (no ``dgda``: the kernel never runs under
    EKFAC) and no layer rides the diagonal side path."""
    assert runs['refreshed'] == [0, 3]
    assert runs['reseed_bitwise'] == [True, True]
    precond = runs['precond']
    for bs in precond.buckets.values():
        assert bs.dgda is None and bs.skron.dtype == torch.float32
        assert bs.da is not None and bs.dg is not None
    # The step after a refresh moved the scales off the seed, the
    # factor steps' drift is what JAX reads, and a refresh step reads 0.
    divs = [s['div'] for s in runs['trace']]
    assert divs[0] == 0.0 and divs[3] == 0.0
    assert divs[1] > 0 and divs[4] > 0


def test_ekfac_skron_ema_matches_hand_computation():
    """Step 1's scales are ``decay * seed + (1 - decay) * contrib`` with
    the contribution recomputed from step 1's rows in step 0's basis."""
    variables = init_variables('mlp')
    model = port_model('mlp')
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    precond = KFACPreconditioner(model, **HP)
    data = batches('mlp')
    x0, y0 = data[0]
    model.zero_grad()
    F.mse_loss(model(to_port_x(x0)), torch.from_numpy(y0)).backward()
    precond.step()
    seed = {k: bs.skron.clone() for k, bs in precond.buckets.items()}
    basis = {k: (bs.qa.clone(), bs.qg.clone())
             for k, bs in precond.buckets.items()}
    x1, y1 = data[1]
    xt = to_port_x(x1)
    acts = {}
    handles = [m.register_forward_hook(
        lambda mod, inp, out, n=n: acts.__setitem__(n, (inp[0], out)))
        for n, m in model.named_children()]
    out = model(xt)
    for h in handles:
        h.remove()
    g = torch.autograd.grad(F.mse_loss(out, torch.from_numpy(y1)),
                            acts['fc0'][1])[0]
    model.zero_grad()
    F.mse_loss(model(xt), torch.from_numpy(y1)).backward()
    precond.step()
    key, slot = precond.plan.slot_of['fc0']
    a_rows, an = ops.linear_a_rows(acts['fc0'][0].detach())
    g_rows, gn = ops.linear_g_rows(g)
    qa, qg = basis[key]
    contrib = ops.ekfac_scale_contrib(
        a_rows, g_rows, qa[slot][:a_rows.shape[1]],
        qg[slot][:g_rows.shape[1]], an, gn)
    want = 0.9 * seed[key][slot] + 0.1 * contrib
    torch.testing.assert_close(precond.buckets[key].skron[slot], want,
                               rtol=1e-5, atol=1e-7)


# -- accumulation ------------------------------------------------------

ACC = 4


@pytest.fixture(scope='module', params=MODELS)
def accum_runs(request):
    name = request.param
    variables = init_variables(name)
    data = batches(name, steps=4, rows=16)
    _, _, jax_trace = jax_run(name, variables, data, accumulation=ACC,
                              inv_update_steps=2)
    port = port_run(name, variables, data, jax_trace, accumulation=ACC,
                    inv_update_steps=2)
    return dict(jax=jax_trace, **port)


@pytest.mark.parametrize('step', range(4))
def test_ekfac_accumulation_matches_jax(accum_runs, step):
    """Each micro-batch's rows are projected at its fold; the scale EMA
    takes their mean (its G side ``N^2`` times one batch's, as the
    factors' is)."""
    check_step(accum_runs['trace'][step], accum_runs['jax'][step])
    assert accum_runs['refreshed'] == [0, 2]


def test_ekfac_empty_accumulation_leaves_skron(accum_runs):
    precond = accum_runs['precond']
    before = {k: bs.skron.clone() for k, bs in precond.buckets.items()}
    factors = {k: st.a_factor.clone() for k, st in precond.layers.items()}
    model = accum_runs['model']
    x, y = batches('lenet' if isinstance(model, LeNet) else 'mlp')[0]
    name = 'lenet' if isinstance(model, LeNet) else 'mlp'
    port_loss(name, model(to_port_x(x[:4])), y[:4]).backward()
    precond.reset_batch()
    precond._steps = 5  # a factor step, not a refresh step
    precond.step()
    for k, s in before.items():
        assert torch.equal(precond.buckets[k].skron, s)
    for k, a in factors.items():
        assert torch.equal(precond.layers[k].a_factor, a)


# -- the drift-triggered refresh ---------------------------------------


def test_adaptive_refresh_unit_and_state():
    ar = AdaptiveRefresh(threshold=0.1, min_interval=3)
    assert not ar.update(0.05, step=10)
    ar.note_refresh(10)
    assert not ar.update(0.5, step=12)
    assert ar.update(0.5, step=13)
    assert ar.triggers == 1
    assert not ar.update(float('nan'), step=20)
    assert 'AdaptiveRefresh' in repr(ar)
    with pytest.raises(ValueError, match='threshold'):
        AdaptiveRefresh(threshold=0.0)
    with pytest.raises(ValueError, match='min_interval'):
        AdaptiveRefresh(min_interval=0)
    ar = AdaptiveRefresh(threshold=0.1, min_interval=5)
    ar.note_refresh(40)
    assert ar.update(0.5, step=46)
    fresh = AdaptiveRefresh(threshold=0.1, min_interval=5)
    fresh.load_state_dict(ar.state_dict())
    jax_ar = JaxAdaptiveRefresh(threshold=0.1, min_interval=5)
    jax_ar.load_state_dict(ar.state_dict())
    assert fresh.state_dict() == jax_ar.state_dict() == {
        'last_refresh': 40, 'triggers': 1, 'divergence': 0.5}
    assert not fresh.update(0.5, step=44)
    fresh.load_state_dict({})
    assert fresh.state_dict() == {'last_refresh': -1, 'triggers': 0,
                                  'divergence': None}
    assert repr(AdaptiveRefresh()) == repr(JaxAdaptiveRefresh())


def test_adaptive_refresh_triggers_at_the_jax_steps():
    """Inputs scaled up step by step, inv 1000: the refreshes after step
    0 are the controller's, at the same steps in both packages, with the
    same drift readings."""
    name = 'mlp'
    variables = init_variables(name)
    data = batches(name, steps=10, scale_up=True)
    kw = dict(inv_update_steps=1000)
    jar = JaxAdaptiveRefresh(threshold=0.15, min_interval=2)
    jprecond, _, jax_trace = jax_run(name, variables, data,
                                     adaptive_refresh=jar, **kw)
    ar = AdaptiveRefresh(threshold=0.15, min_interval=2)
    port = port_run(name, variables, data, jax_trace, adaptive_refresh=ar,
                    **kw)
    assert ar.triggers == jar.triggers >= 2
    assert ar.state_dict()['last_refresh'] == jar.state_dict()[
        'last_refresh']
    got = [s['div'] for s in port['trace']]
    want = [s['div'] for s in jax_trace]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # A refresh runs at step i + 1 exactly when step i's reading
    # triggered; each of them reseeds bitwise.
    assert port['refreshed'][0] == 0 and len(port['refreshed']) == (
        1 + ar.triggers)
    assert all(port['reseed_bitwise'])
    sd = port['precond'].state_dict()
    assert sd['adaptive_refresh'] == ar.state_dict()
    ar2 = AdaptiveRefresh(threshold=0.15, min_interval=2)
    p2 = KFACPreconditioner(port_model(name), adaptive_refresh=ar2,
                            **dict(HP, **kw))
    p2.load_state_dict(sd)
    assert ar2.state_dict() == ar.state_dict()


# -- checkpoints and validation ----------------------------------------


def test_ekfac_scales_round_trip(runs):
    precond = runs['precond']
    sd = precond.state_dict(include_ekfac_scales=True)
    assert set(sd['ekfac_scales']) == set(precond.buckets)
    p2 = KFACPreconditioner(port_model(runs['name']), **HP)
    p2.load_state_dict(sd)
    for key, bs in precond.buckets.items():
        assert torch.equal(p2.buckets[key].skron, bs.skron)
    p3 = KFACPreconditioner(port_model(runs['name']), **HP)
    p3.load_state_dict(precond.state_dict())
    assert any(not torch.equal(p3.buckets[k].skron, bs.skron)
               for k, bs in precond.buckets.items())


def test_jax_checkpoint_scales_load_into_the_port(runs):
    jsd = runs['jprecond'].state_dict(runs['jstate'],
                                      include_ekfac_scales=True)
    sd = jax_kfac_state_dict_to_torch(jax.tree.map(
        lambda v: np.asarray(v) if hasattr(v, 'shape') else v, jsd))
    p = KFACPreconditioner(port_model(runs['name']), **HP)
    p.load_state_dict(sd)
    for key, s in jsd['ekfac_scales'].items():
        np.testing.assert_array_equal(p.buckets[key].skron.numpy(),
                                      np.asarray(s))


def _saved(runs):
    return runs['precond'].state_dict(include_ekfac_scales=True)


def test_scales_require_factors(runs):
    with pytest.raises(ValueError, match='include_factors'):
        runs['precond'].state_dict(include_factors=False,
                                   include_ekfac_scales=True)


def test_scales_rejected_without_ekfac():
    with pytest.raises(ValueError, match=r'no\s+EKFAC scale state'):
        KFACPreconditioner(MLP(8, (8, 4))).state_dict(
            include_ekfac_scales=True)


def test_scales_rejected_without_compute_inverses(runs):
    p2 = KFACPreconditioner(port_model(runs['name']), **HP)
    with pytest.raises(ValueError, match='compute_inverses'):
        p2.load_state_dict(_saved(runs), compute_inverses=False)


def test_scales_partial_coverage_rejected(runs):
    sd = _saved(runs)
    sd['ekfac_scales'].pop(next(iter(sd['ekfac_scales'])))
    p2 = KFACPreconditioner(port_model(runs['name']), **HP)
    with pytest.raises(ValueError, match='does not cover'):
        p2.load_state_dict(sd)


def test_scales_unknown_bucket_rejected(runs):
    sd = _saved(runs)
    sd['ekfac_scales']['a1g1'] = torch.zeros(1, 1, 1)
    p2 = KFACPreconditioner(port_model(runs['name']), **HP)
    with pytest.raises(ValueError, match='no EKFAC scale slot'):
        p2.load_state_dict(sd)


def test_scales_shape_mismatch_rejected(runs):
    sd = _saved(runs)
    key = next(iter(sd['ekfac_scales']))
    sd['ekfac_scales'][key] = sd['ekfac_scales'][key][:, :4, :4]
    p2 = KFACPreconditioner(port_model(runs['name']), **HP)
    with pytest.raises(ValueError, match='shape mismatch'):
        p2.load_state_dict(sd)


@pytest.mark.parametrize('kwargs,match', [
    (dict(ekfac=True, compute_method='inverse'), 'EIGEN'),
    (dict(ekfac=True, lowrank_rank=8), 'mutually exclusive'),
    (dict(ekfac=True, bucketed=False), 'bucketed'),
    (dict(adaptive_refresh=AdaptiveRefresh()), 'ekfac'),
])
def test_ekfac_validation_matches_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        KFACPreconditioner(MLP(8, (4,)), **kwargs)
    jkw = dict(kwargs)
    if 'adaptive_refresh' in jkw:
        jkw['adaptive_refresh'] = JaxAdaptiveRefresh()
    with pytest.raises(ValueError, match=match):
        JaxPreconditioner(JaxMLP(features=(4,)), loss_fn=jax_loss('mlp'),
                          **jkw)


def test_ekfac_rejects_layers_without_rows():
    class WithEmbed(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(11, 8)
            self.head = nn.Linear(8, 4)

        def forward(self, ids):
            return self.head(self.embed(ids).mean(1))

    with pytest.raises(ValueError, match='EKFAC row'):
        KFACPreconditioner(WithEmbed(), ekfac=True,
                           layer_types=('linear', 'embedding'))
