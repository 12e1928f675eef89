"""The port's replicated engine (``bucketed=False``) and general-eig
escape hatch against the JAX package's, on the CPU.

* Trajectories: LeNet at 12x12, batch 8, factor 1, inv 3, 7 steps
  (refreshes at 0, 3 and 6) with ``bucketed=False``, eigen with and
  without prediv and inverse, and ``gpt_tiny`` with full coverage
  (eigen; the tied embedding's diagonal A and the LayerNorms per layer),
  against the JAX engine with ``bucketed=False`` from the same bridged
  weights with the same numpy SGD updates: losses ``rtol 1e-5``, factor
  EMAs and preconditioned gradients (relative Frobenius ``<= 1e-5`` and
  ``<= 1e-4``, the bars of the port's other trajectory tests).  The
  per-layer decompositions live in the layer states, the bucket stacks
  are empty, and the fused kernel is launched 0 times, as in JAX
  (``use_pallas`` needs the bucketed stage).
* The replicated engine against the bucketed one on the same batches:
  the same preconditioned gradients (``<= 1e-5``).
* ``compute_factor_eig_general`` against JAX's on seeded non-symmetric
  matrices (the clamped real spectra, order-insensitive, ``rtol 1e-5``;
  the eigenvectors, as the reconstruction ``q diag(d) q^-1`` of the
  clamped spectrum, ``<= 1e-4``), its output on the factor's device and
  dtype, and on non-finite input: all-zero outputs, one warning and one
  counted event, as JAX's ``eig_general_nonfinite``.
* Non-symmetric custom helpers: the replicated engine trains through
  the general eig and the LU inverse against JAX's on the same
  monkeypatched helpers; the bucketed engine rejects them; their
  factors stay dense in a ``compress_symmetric`` checkpoint.
"""
from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu import ops as jops
from kfac_pytorch_tpu.layers.helpers import LayerHelper as JaxLayerHelper
from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
from kfac_pytorch_tpu.models.tiny import TinyModel as JaxTiny
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.layers.helpers import LayerHelper
from kfac_pytorch_tpu_torch.models import gpt_tiny
from kfac_pytorch_tpu_torch.models import LeNet
from kfac_pytorch_tpu_torch.models import TinyModel

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

LR = 0.1
STEPS = 7
HP = dict(factor_update_steps=1, inv_update_steps=3, damping=0.003, lr=LR)
GPT_KW = dict(layer_types=('linear', 'conv2d', 'embedding', 'layernorm'),
              tied_weights=('wte',))
VARIANTS = {
    'eigen': {},
    'eigen_noprediv': dict(compute_eigenvalue_outer_product=False),
    'inverse': dict(compute_method='inverse'),
}


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def jax_xent(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))


def jax_lm(logits, tokens):
    logp = jax.nn.log_softmax(logits[:, :-1])
    return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], -1))


def data(name, steps=STEPS):
    rng = np.random.default_rng(53)
    if name == 'gpt':
        out = []
        for _ in range(steps):
            t = rng.integers(0, 256, size=(4, 8)).astype(np.int32)
            out.append((t, t))
        return out
    if name == 'tiny':
        return [(rng.standard_normal((16, 10)).astype(np.float32),
                 rng.integers(0, 10, size=(16,))) for _ in range(steps)]
    return [(rng.standard_normal((8, 12, 12, 1)).astype(np.float32),
             rng.integers(0, 10, size=(8,))) for _ in range(steps)]


def port_input(x):
    x = x.transpose(0, 3, 1, 2) if x.ndim == 4 else x
    x = torch.from_numpy(np.ascontiguousarray(x))
    return x.long() if not x.is_floating_point() else x


def port_loss(name, out, y):
    if name == 'gpt':
        out, y = out[:, :-1].reshape(-1, out.shape[-1]), y[:, 1:].reshape(-1)
    return F.cross_entropy(out, y)


JAX_MODELS = {'lenet': JaxLeNet, 'gpt': jax_gpt_tiny, 'tiny': JaxTiny}
PORT_MODELS = {'lenet': lambda: LeNet(image_size=12),
               'gpt': lambda: gpt_tiny(device='cpu'), 'tiny': TinyModel}


def trajectories(name, kw):
    """``(jax steps, port steps, port preconditioner)`` of one run."""
    import flax.linen as fnn

    batches = data(name)
    model = JAX_MODELS[name]()
    variables = jax.tree.map(np.asarray, fnn.meta.unbox(model.init(
        jax.random.PRNGKey(6), batches[0][0])))
    extra = GPT_KW if name == 'gpt' else {}
    jp = JaxPreconditioner(
        model, loss_fn=jax_lm if name == 'gpt' else jax_xent, **HP, **extra,
        **kw,
    )
    state = jp.init(variables, batches[0][0])
    params = variables['params']
    want = []
    for x, y in batches:
        loss, _, grads, state = jp.step(
            {'params': params}, state, x, loss_args=(jnp.asarray(y),))
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        want.append(dict(
            loss=float(loss), grads=flax_to_torch_state_dict(
                {'params': grads}),
            factors={b.replace('/', '.'): (np.asarray(state[b].a_factor),
                                           np.asarray(state[b].g_factor))
                     for b in jp._groups},
        ))
    net = PORT_MODELS[name]()
    net.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    port = KFACPreconditioner(net, **HP, **extra, **kw)
    got = []
    for (x, y), w in zip(batches, want):
        net.zero_grad()
        loss = port_loss(name, net(port_input(x)), torch.from_numpy(y).long())
        loss.backward()
        port.step()
        got.append(dict(
            loss=float(loss.detach()),
            grads={n: q.grad.clone() for n, q in net.named_parameters()},
            factors={n: (st.a_factor.clone(), st.g_factor.clone())
                     for n, st in port.layers.items()},
        ))
        with torch.no_grad():
            for n, q in net.named_parameters():
                q -= LR * torch.as_tensor(w['grads'][n])
    return want, got, port


def check(want, got):
    np.testing.assert_allclose([g['loss'] for g in got],
                               [w['loss'] for w in want], rtol=1e-5)
    for step, (w, g) in enumerate(zip(want, got)):
        assert set(g['factors']) == set(w['factors'])
        for layer, pair in w['factors'].items():
            for side in (0, 1):
                err = rel_err(g['factors'][layer][side], pair[side])
                assert err <= 1e-5, (step, layer, side, err)
        for name, grad in w['grads'].items():
            err = rel_err(g['grads'][name], grad)
            assert err <= 1e-4, (step, name, err)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts calls of the fused kernel's entry points."""
    from kfac_pytorch_tpu_torch.ops import fused_precond

    calls = []
    for name in ('fused_eigen_precondition',
                 'fused_eigen_precondition_sharded'):
        real = getattr(fused_precond, name)

        def spy(*a, _real=real, **k):
            calls.append(1)
            return _real(*a, **k)
        monkeypatch.setattr(fused_precond, name, spy)
    from kfac_pytorch_tpu_torch.parallel import second_order

    monkeypatch.setattr(
        second_order.ops, 'fused_eigen_precondition_sharded',
        fused_precond.fused_eigen_precondition_sharded,
    )
    return calls


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_replicated_matches_jax(variant, kernel_calls):
    want, got, port = trajectories(
        'lenet', dict(VARIANTS[variant], bucketed=False))
    check(want, got)
    assert port.plan is None and port.buckets == {}
    assert kernel_calls == []
    held = {n: set(st.decompositions()) for n, st in port.layers.items()}
    fields = {'eigen': {'qa', 'qg', 'dgda'},
              'eigen_noprediv': {'qa', 'qg', 'da', 'dg'},
              'inverse': {'a_inv', 'g_inv'}}[variant]
    assert all(h == fields for h in held.values()), held
    assert port.memory_usage()['second_order'] > 0


def test_replicated_gpt_matches_jax(kernel_calls):
    want, got, port = trajectories('gpt', dict(bucketed=False))
    check(want, got)
    assert port.diag_layers == ('wte',)
    assert set(port.layers['wte'].decompositions()) == {'qg', 'dg', 'da'}
    assert kernel_calls == []


def test_replicated_equals_bucketed(kernel_calls):
    batches = data('lenet', 4)
    out, launched = {}, {}
    for bucketed in (True, False):
        torch.manual_seed(3)
        net = LeNet(image_size=12)
        p = KFACPreconditioner(net, bucketed=bucketed, **HP)
        grads = []
        for x, y in batches:
            net.zero_grad()
            F.cross_entropy(net(port_input(x)),
                            torch.from_numpy(y)).backward()
            p.step()
            grads.append({n: q.grad.clone() for n, q in
                          net.named_parameters()})
        out[bucketed] = grads
        launched[bucketed] = len(kernel_calls)
    # The bucketed run calls the kernel (two buckets of LeNet's four
    # each step), the replicated one never.
    assert launched[True] > 0 and launched[False] == launched[True]
    for step, (a, b) in enumerate(zip(out[True], out[False])):
        for name in a:
            err = rel_err(b[name], a[name])
            assert err <= 1e-5, (step, name, err)


def test_replicated_validation():
    net = LeNet(image_size=12)
    for kw, match in ((dict(compute_method='iterative'), 'iterative'),
                      (dict(lowrank_rank=8), 'lowrank_rank'),
                      (dict(ekfac=True), 'ekfac'),
                      (dict(stagger_refresh=2), 'stagger_refresh')):
        with pytest.raises(ValueError, match=match):
            KFACPreconditioner(net, bucketed=False, **HP, **kw)


# -- the general eig ---------------------------------------------------------


def test_eig_general_matches_jax():
    rng = np.random.default_rng(11)
    for n in (5, 6, 17):
        f = rng.standard_normal((n, n)).astype(np.float32)
        jq, jd = jops.compute_factor_eig_general(jnp.asarray(f))
        q, d = ops.compute_factor_eig_general(torch.from_numpy(f))
        assert q.dtype == d.dtype == torch.float32
        assert q.shape == (n, n) and d.shape == (n,)
        np.testing.assert_allclose(np.sort(d.numpy()),
                                   np.sort(np.asarray(jd)), rtol=1e-5,
                                   atol=1e-6)
        assert (d >= 0).all()
        # The same real parts in the same order: the reconstruction of
        # the clamped spectrum agrees.
        got = q.double() @ torch.diag(d.double()) @ torch.linalg.pinv(
            q.double())
        want = (np.asarray(jq, np.float64) @ np.diag(np.asarray(jd))
                @ np.linalg.pinv(np.asarray(jq, np.float64)))
        assert rel_err(got, want) <= 1e-4
        # numpy's own general eig, real parts, clamped.
        dn = np.clip(np.linalg.eig(f)[0].real.astype(np.float32), 0, None)
        np.testing.assert_allclose(np.sort(d.numpy()), np.sort(dn),
                                   rtol=1e-5, atol=1e-6)
    q, d = ops.compute_factor_eig_general(
        torch.from_numpy(f), torch.float64)
    assert q.dtype == d.dtype == torch.float64


def test_eig_general_sanitizes_non_finite(caplog):
    before = ops.compute_factor_eig_general.nonfinite
    bad = np.eye(4, dtype=np.float32)
    bad[1, 2] = np.nan
    jq, jd = jops.compute_factor_eig_general(jnp.asarray(bad))
    with caplog.at_level(logging.WARNING):
        q, d = ops.compute_factor_eig_general(torch.from_numpy(bad))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert not q.any() and not d.any()
    assert ops.compute_factor_eig_general.nonfinite == before + 1
    assert sum('non-finite' in r.message for r in caplog.records
               if r.name == 'kfac_pytorch_tpu_torch.ops.eigen') == 1


# -- non-symmetric custom helpers --------------------------------------------


@pytest.fixture
def asymmetric(monkeypatch):
    for cls in (JaxLayerHelper, LayerHelper):
        monkeypatch.setattr(cls, 'symmetric_factors',
                            property(lambda self: False))


@pytest.mark.parametrize('method', ['eigen', 'inverse'])
def test_asymmetric_helpers_train_on_replicated(asymmetric, method):
    want, got, port = trajectories(
        'tiny', dict(bucketed=False, compute_method=method))
    check(want, got)


def test_asymmetric_helpers_rejected_by_bucketed(asymmetric):
    with pytest.raises(ValueError, match='non-symmetric factors'):
        KFACPreconditioner(TinyModel(), **HP)


def test_asymmetric_factors_stay_dense_in_checkpoints(asymmetric):
    net = TinyModel()
    p = KFACPreconditioner(net, bucketed=False, **HP)
    (x, y), = data('tiny', 1)
    F.cross_entropy(net(port_input(x)), torch.from_numpy(y)).backward()
    p.step()
    sd = p.state_dict(compress_symmetric=True)
    for packed in sd['layers'].values():
        assert isinstance(packed['A'], torch.Tensor)
        assert isinstance(packed['G'], torch.Tensor)
    fresh = KFACPreconditioner(TinyModel(), bucketed=False, **HP)
    fresh.load_state_dict(sd)
    for name, st in fresh.layers.items():
        assert torch.equal(st.a_factor, p.layers[name].a_factor)
