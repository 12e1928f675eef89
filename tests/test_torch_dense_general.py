"""The port's DenseGeneral K-FAC and coverage report against the JAX
package's, and the repair for ``torch.nn.MultiheadAttention``.

The model is ``tests/test_coverage.py``'s: Flax's
``nn.MultiHeadDotProductAttention(num_heads=2, qkv_features=8)`` and a
``Dense(4)`` head on ``[2, 5, 8]`` inputs, against the port's
:class:`~kfac_pytorch_tpu_torch.models.layers.MultiHeadDotProductAttention`
and an ``nn.Linear`` head from the same bridged weights.

* Forward: f32 logits within ``atol 1e-6``.
* Registration with ``layer_types=('linear', 'dense_general')``: the
  four projections ``attn/query|key|value|out`` with the JAX helpers'
  features and ``kernel_in_ndim``/``kernel_out_ndim``; only ``head`` by
  default.
* The helpers: the combined gradient of a multi-axis kernel equal to the
  JAX helper's and its round trip exact; expand and reduce factors
  against the JAX helpers' (``rtol 1e-5``).
* A 3-step trajectory against the JAX ``KFACPreconditioner.step``
  (``factor_update_steps=1, inv_update_steps=2``, damping 0.003, kl-clip
  0.001, lr 0.1; both sides apply the JAX gradients with the same SGD
  update): losses ``rtol 1e-5``; factors, preconditioned gradients and
  the kl-clip scale to a relative error ``<= 1e-4``, the bar of
  ``tests/test_torch_gpt.py`` (the f32 eigendecompositions of the two
  libraries differ in the last bits, and the preconditioner divides by
  their eigenvalues); a gradient that is zero in exact arithmetic to an
  absolute ``1e-8`` instead (``ZERO_GRAD_ATOL``).
* ``torch.nn.MultiheadAttention``: its ``out_proj`` is rejected with a
  warning, ``head`` alone registers and the model trains 3 steps.
* ``coverage_report()`` equal to the JAX report on ``gpt_tiny`` with full
  coverage, ``bert_tiny``, ``vit_tiny`` (full and default) and the MHA
  model: counts and ``param_fraction`` exactly, ``uncovered`` through
  the bridge's name map.

The trajectory helpers here serve ``tests/test_torch_vit.py`` and
``tests/test_torch_bert.py`` too.
"""
from __future__ import annotations

import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu.capture import ModelCapture as JaxCapture
from kfac_pytorch_tpu.layers import coverage as jax_cov
from kfac_pytorch_tpu.observe import ObserveConfig
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.convert import flax_to_torch_names
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.layers import DenseGeneralHelper
from kfac_pytorch_tpu_torch.layers import DenseGeneralReduceHelper
from kfac_pytorch_tpu_torch.models import DenseGeneral
from kfac_pytorch_tpu_torch.models import MultiHeadDotProductAttention

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

STEPS = 3
LR = 0.1
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR)
REL = 1e-4
#: Absolute bar of a gradient that is zero in exact arithmetic, whose
#: relative error is rounding noise over rounding noise: the bias of
#: BERT's last LayerNorm, whose output gradient is ``qa_head``'s kernel
#: times the start and end softmax gradients, each of which sums to zero
#: over a row's positions.
ZERO_GRAD_ATOL = 1e-8
MHA_TYPES = ('linear', 'dense_general')


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- trajectories against the JAX preconditioner ----------------------------

def jax_trajectory(model, init, batches, loss_fn, kw):
    """Per step ``(loss, factors by port name, preconditioned grads by
    port name, kl scale)``.  ``batches`` holds ``(apply args, loss
    args)`` per step."""
    precond = JaxPreconditioner(model, loss_fn=loss_fn,
                                observe=ObserveConfig(), **HP, **kw)
    state = precond.init(init, *batches[0][0])
    params = init['params']
    trace = []
    for args, loss_args in batches:
        loss, _, grads, state = precond.step(
            {'params': params}, state, *args, loss_args=loss_args,
        )
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        factors = {
            base.replace('/', '.'): (np.asarray(state[base].a_factor),
                                     np.asarray(state[base].g_factor))
            for base in state.layers
        }
        trace.append((float(loss), factors,
                      flax_to_torch_state_dict({'params': grads}),
                      float(precond.last_step_info['observe/kl_nu'])))
    return trace


def port_trajectory(model, jax_trace, loss_of, kw):
    """The port's steps, each applying the JAX step's gradients so both
    sides hold the same weights; ``loss_of(model, step)`` runs the
    forward pass of a step and returns the loss."""
    precond = KFACPreconditioner(model, **HP, **kw)
    trace = []
    for step in range(len(jax_trace)):
        model.zero_grad()
        loss = loss_of(model, step)
        loss.backward()
        precond.step()
        factors = {n: (st.a_factor.clone(), st.g_factor.clone())
                   for n, st in precond.layers.items()}
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        trace.append((float(loss.detach()), factors, grads,
                      float(precond.last_kl_scale)))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p -= LR * jax_trace[step][2][name]
    return trace


def check_trajectories(jax_trace, port_trace, n_layers):
    """Losses ``rtol 1e-5``; factors, preconditioned gradients and the
    kl-clip scale within ``REL``."""
    for step, (want, got) in enumerate(zip(jax_trace, port_trace)):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        assert set(got[1]) == set(want[1])
        assert len(got[1]) == n_layers
        for name, pair in want[1].items():
            for side in (0, 1):
                assert got[1][name][side].shape == pair[side].shape
                err = rel_err(got[1][name][side], pair[side])
                assert err <= REL, (step, name, side, err)
        assert set(got[2]) == set(want[2])
        for name in want[2]:
            err = rel_err(got[2][name], want[2][name])
            diff = float(np.abs(np.asarray(got[2][name], np.float64)
                                - np.asarray(want[2][name])).max())
            assert err <= REL or diff <= ZERO_GRAD_ATOL, (step, name, err)
        assert 0.0 < got[3] <= 1.0
        assert abs(got[3] - want[3]) <= REL * want[3], (step, got[3], want[3])


def check_coverage(jax_rep, port_rep, names):
    """Counts and ``param_fraction`` exactly; ``uncovered`` through the
    bridge's name map ``names``."""
    for key in ('registered', 'skipped', 'unsupported', 'tied',
                'params_total', 'params_covered', 'param_fraction'):
        assert port_rep[key] == jax_rep[key], key
    assert port_rep['uncovered'] == sorted(
        names[p] for p in jax_rep['uncovered'])


# -- the MHA model ---------------------------------------------------------

class JaxMHA(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.MultiHeadDotProductAttention(
            num_heads=2, qkv_features=8, name='attn',
        )(x)
        return fnn.Dense(4, name='head')(x)


class PortMHA(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = MultiHeadDotProductAttention(8, 2, qkv_features=8)
        self.head = nn.Linear(8, 4)

    def forward(self, x):
        return self.head(self.attn(x))


class TorchMHA(nn.Module):
    """torch's own attention module, whose projections K-FAC cannot
    see."""

    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(8, 2, batch_first=True)
        self.head = nn.Linear(8, 4)

    def forward(self, x):
        return self.head(self.attn(x, x, x, need_weights=False)[0])


def mha_batches():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal((2, 5, 8)).astype(np.float32),
             rng.integers(0, 4, size=(2, 5)).astype(np.int32))
            for _ in range(STEPS)]


@pytest.fixture(scope='module')
def mha_init():
    v = JaxMHA().init(jax.random.PRNGKey(0), jnp.ones((2, 5, 8)))
    return jax.tree.map(np.asarray, v)


def port_mha(init):
    model = PortMHA()
    model.load_state_dict(flax_to_torch_state_dict(init), strict=True)
    return model.train()


def jax_xent(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))


def port_xent(logits, labels):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def test_mha_forward_matches_flax(mha_init):
    x = mha_batches()[0][0]
    want = JaxMHA().apply(mha_init, x)
    with torch.no_grad():
        got = port_mha(mha_init)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_mha_kernels_keep_the_flax_layout(mha_init):
    model = port_mha(mha_init)
    assert model.attn.query.kernel.shape == (8, 2, 4)
    assert model.attn.query.bias.shape == (2, 4)
    assert model.attn.out.kernel.shape == (2, 4, 8)
    np.testing.assert_array_equal(
        model.attn.out.kernel.detach().numpy(),
        mha_init['params']['attn']['out']['kernel'])


def test_mha_internals_register(mha_init):
    x = mha_batches()[0][0]
    jcap = JaxCapture(JaxMHA(), layer_types=MHA_TYPES)
    specs = jcap.register(mha_init, x)
    cap = ModelCapture(port_mha(mha_init), layer_types=MHA_TYPES)
    assert set(cap.helpers) == {n.replace('/', '.') for n in specs}
    assert {n for n in cap.helpers if n.startswith('attn.')} == {
        'attn.query', 'attn.key', 'attn.value', 'attn.out'}
    for name, spec in specs.items():
        want, got = spec.helper, cap.helpers[name.replace('/', '.')]
        assert type(got).__name__ == type(want).__name__
        for field in ('has_bias', 'in_features', 'out_features'):
            assert getattr(got, field) == getattr(want, field), (name, field)
        if isinstance(want, jax_cov.DenseGeneralHelper):
            assert got.kernel_in_ndim == want.kernel_in_ndim
            assert got.kernel_out_ndim == want.kernel_out_ndim
    assert cap.helpers['attn.query'].kernel_out_ndim == 2
    assert cap.helpers['attn.out'].kernel_in_ndim == 2


def test_mha_not_registered_by_default(mha_init):
    jcap = JaxCapture(JaxMHA())
    assert set(jcap.register(mha_init, mha_batches()[0][0])) == {'head'}
    assert list(ModelCapture(port_mha(mha_init)).helpers) == ['head']


@pytest.mark.parametrize('in_shape,features', [
    ((6,), (2, 4)),   # q/k/v: the out axes split per head
    ((2, 4), (6,)),   # out: the in axes split
], ids=['qkv', 'out'])
def test_kernel_grad_round_trip(in_shape, features):
    rng = np.random.default_rng(3)
    kernel = rng.standard_normal(in_shape + features).astype(np.float32)
    bias = rng.standard_normal(features).astype(np.float32)
    kw = dict(has_bias=True, in_features=int(np.prod(in_shape)),
              out_features=int(np.prod(features)),
              kernel_in_ndim=len(in_shape), kernel_out_ndim=len(features))
    want = jax_cov.DenseGeneralHelper(name='q', path=('q',), **kw)
    module = DenseGeneral(in_shape, features,
                          axis=tuple(range(-len(in_shape), 0)))
    module.kernel.grad = torch.from_numpy(kernel.copy())
    module.bias.grad = torch.from_numpy(bias.copy())
    got = DenseGeneralHelper(name='q', module=module, **kw)
    combined = got.get_grad()
    assert combined.shape == (kw['out_features'], kw['in_features'] + 1)
    np.testing.assert_array_equal(
        combined.numpy(),
        np.asarray(want.get_grad({'kernel': kernel, 'bias': bias})))
    module.kernel.grad.zero_()
    module.bias.grad.zero_()
    got.set_grad(combined)
    np.testing.assert_array_equal(module.kernel.grad.numpy(), kernel)
    np.testing.assert_array_equal(module.bias.grad.numpy(), bias)


@pytest.mark.parametrize('reduce', [False, True], ids=['expand', 'reduce'])
@pytest.mark.parametrize('in_shape,features', [
    ((6,), (2, 4)), ((2, 4), (6,)),
], ids=['qkv', 'out'])
def test_factors_match_jax(in_shape, features, reduce):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 5) + in_shape).astype(np.float32)
    g = rng.standard_normal((3, 5) + features).astype(np.float32)
    kw = dict(has_bias=True, in_features=int(np.prod(in_shape)),
              out_features=int(np.prod(features)),
              kernel_in_ndim=len(in_shape), kernel_out_ndim=len(features))
    jcls = (jax_cov.DenseGeneralReduceHelper if reduce
            else jax_cov.DenseGeneralHelper)
    pcls = DenseGeneralReduceHelper if reduce else DenseGeneralHelper
    want = jcls(name='l', path=('l',), **kw)
    got = pcls(name='l', module=nn.Identity(), **kw)
    np.testing.assert_allclose(
        got.get_a_factor(torch.from_numpy(a)).numpy(),
        np.asarray(want.get_a_factor(jnp.asarray(a))), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        got.get_g_factor(torch.from_numpy(g)).numpy(),
        np.asarray(want.get_g_factor(jnp.asarray(g))), rtol=1e-5, atol=1e-7)


def test_non_trailing_axes_are_rejected():
    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = DenseGeneral(5, 4, axis=-2)

        def forward(self, x):
            return self.proj(x)

    with pytest.warns(UserWarning, match='non-trailing contraction axes'):
        cap = ModelCapture(Model(), layer_types=MHA_TYPES)
    assert not cap.helpers and 'proj' in cap.rejected
    assert Model()(torch.ones(2, 5, 3)).shape == (2, 3, 4)


def test_dense_general_takes_kfac_approx():
    cap = ModelCapture(PortMHA(), layer_types=MHA_TYPES,
                       kfac_approx={'query': 'reduce'})
    assert type(cap.helpers['attn.query']) is DenseGeneralReduceHelper
    assert type(cap.helpers['attn.key']) is DenseGeneralHelper


def test_mha_trajectory_matches_jax(mha_init):
    batches = mha_batches()
    jax_trace = jax_trajectory(
        JaxMHA(), mha_init, [((x,), (y,)) for x, y in batches], jax_xent,
        dict(layer_types=MHA_TYPES))

    def loss_of(model, step):
        x, y = batches[step]
        return port_xent(model(torch.from_numpy(x)), torch.from_numpy(y))

    port_trace = port_trajectory(port_mha(mha_init), jax_trace, loss_of,
                                 dict(layer_types=MHA_TYPES))
    check_trajectories(jax_trace, port_trace, 5)
    assert port_trace[-1][0] < port_trace[0][0]


def test_torch_multihead_attention_is_rejected_and_trains():
    torch.manual_seed(0)
    model = TorchMHA()
    with pytest.warns(UserWarning, match='attn.out_proj') as record:
        precond = KFACPreconditioner(model, **HP)
    assert len(record) == 1
    assert 'F.multi_head_attention_forward' in str(record[0].message)
    assert 'MultiHeadDotProductAttention' in str(record[0].message)
    assert list(precond.helpers) == ['head']
    assert 'F.multi_head_attention_forward' in \
        precond._capture.rejected['attn.out_proj']
    rep = precond.coverage_report()
    assert rep['unsupported'] == 1 and rep['registered'] == 1
    assert 'attn.out_proj.weight' in rep['uncovered']
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    losses = []
    for x, y in mha_batches()[:1] * STEPS:
        opt.zero_grad()
        loss = port_xent(model(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        precond.step()
        opt.step()
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_torch_multihead_attention_skipped_layer_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        cap = ModelCapture(TorchMHA(), skip_layers=('out_proj',))
    assert cap.skipped == ['attn.out_proj'] and list(cap.helpers) == ['head']


# -- coverage_report() against the JAX report -----------------------------

def _gpt():
    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_model

    from kfac_pytorch_tpu_torch.models import gpt_tiny
    kw = dict(layer_types=('linear', 'conv2d', 'embedding', 'layernorm'),
              tied_weights=('wte',))
    return (jax_model(), (jnp.zeros((1, 16), jnp.int32),),
            gpt_tiny(device='cpu'), kw)


def _bert():
    from kfac_pytorch_tpu.models.bert import bert_tiny as jax_model

    from kfac_pytorch_tpu_torch.models import bert_tiny
    return (jax_model(), (jnp.zeros((2, 16), jnp.int32),),
            bert_tiny(device='cpu'),
            dict(layer_types=('linear', 'embedding', 'layernorm')))


def _vit(kw):
    from kfac_pytorch_tpu.models.vit import vit_tiny as jax_model

    from kfac_pytorch_tpu_torch.models import vit_tiny
    return (jax_model(), (jnp.zeros((2, 32, 32, 3)),),
            vit_tiny(device='cpu'), kw)


def _mha():
    return JaxMHA(), (jnp.ones((2, 5, 8)),), PortMHA(), dict(
        layer_types=MHA_TYPES)


COVERAGE_MODELS = {
    'gpt_tiny_full': _gpt,
    'bert_tiny_full': _bert,
    'vit_tiny_full': lambda: _vit(dict(
        layer_types=('linear', 'conv2d', 'layernorm'))),
    'vit_tiny_default': lambda: _vit({}),
    'mha': _mha,
}


@pytest.mark.parametrize('case', list(COVERAGE_MODELS))
def test_coverage_report_matches_jax(case):
    jax_model, args, port_model, kw = COVERAGE_MODELS[case]()
    variables = fnn.meta.unbox(
        jax_model.init(jax.random.PRNGKey(0), *args))
    jcap = JaxCapture(jax_model, **kw)
    jcap.register(variables, *args)
    precond = KFACPreconditioner(port_model, **kw)
    check_coverage(jcap.coverage, precond.coverage_report(),
                   flax_to_torch_names(variables))
    assert precond._uses_coverage_helpers() == (case != 'vit_tiny_default')
