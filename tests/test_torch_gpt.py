"""The port's GPT and its transformer K-FAC against the JAX package's.

* ``gpt_tiny`` logits against the Flax model from the same bridged
  weights, f32, ``atol 1e-5``.
* A 3-step ``KFACPreconditioner`` trajectory against the JAX ``step``
  on ``gpt_tiny`` (vocab 256, 2 blocks, ``d_model`` 32), batch 4 x 16
  tokens, next-token cross entropy, ``factor_update_steps=1,
  inv_update_steps=2`` (refreshes at steps 0 and 2), damping 0.003,
  kl-clip 0.001, lr 0.1, both sides applying the JAX gradients with the
  same SGD update (so both hold the same weights at every step), for
  full coverage (Dense, embedding, LayerNorm, the tied head), the
  default coverage (the 8 Dense layers), ``kfac_approx`` reduce on the
  ``fc_in`` layers, and ``compute_method='inverse'`` with an (untied)
  embedding.  Compared per step: the loss (``rtol 1e-5``), every
  layer's factor EMAs, every parameter's preconditioned gradient and
  the kl-clip scale (relative error ``<= 1e-4``, the bar of
  ``tests/test_torch_preconditioner.py``).
* Checkpoints with diagonal layers: the port's ``state_dict`` keeps the
  embedding's A as its ``[V]`` vector (also with ``compress_symmetric``)
  and a restore resumes bit for bit; a legacy dense ``[V, V]`` A loads
  through its diagonal; the JAX full-coverage run's checkpoint after
  step 1 resumes in the port, whose step 2 matches the JAX step 2.
"""
from __future__ import annotations

import io

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from kfac_pytorch_tpu.observe import ObserveConfig
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.convert import jax_kfac_state_dict_to_torch
from kfac_pytorch_tpu_torch.models import gpt_tiny

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

STEPS = 3
LR = 0.1
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR)
REL = 1e-4
FULL = ('linear', 'conv2d', 'embedding', 'layernorm')
#: label -> keywords of both preconditioners.
CONFIGS = {
    'full': dict(layer_types=FULL, tied_weights=('wte',)),
    'default': dict(),
    'reduce': dict(kfac_approx={'fc_in': 'reduce'}),
    'inverse_embedding': dict(layer_types=('linear', 'embedding'),
                              compute_method='inverse'),
}
#: Registered layers per configuration (the tie is one layer).
N_LAYERS = {'full': 14, 'default': 8, 'reduce': 8, 'inverse_embedding': 9}


def batches():
    rng = np.random.default_rng(17)
    return [rng.integers(0, 256, size=(4, 16)).astype(np.int32)
            for _ in range(STEPS)]


def jax_lm_loss(logits, tokens):
    logp = jax.nn.log_softmax(logits[:, :-1])
    return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], -1))


def port_lm_loss(logits, tokens):
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope='module')
def init():
    variables = fnn.meta.unbox(jax_gpt_tiny().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32),
    ))
    return jax.tree.map(np.asarray, variables)


def port_model(init):
    model = gpt_tiny(device='cpu')
    model.load_state_dict(flax_to_torch_state_dict(init), strict=True)
    return model.train()


def test_logits_match_flax(init):
    tokens = batches()[0]
    want = jax_gpt_tiny().apply(init, tokens)
    with torch.no_grad():
        got = port_model(init)(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def jax_trajectory(init, kw):
    """Per step ``(loss, factors by port name, grads by port name, kl
    scale)``, and the JAX checkpoint taken after step 1."""
    precond = JaxPreconditioner(
        jax_gpt_tiny(), loss_fn=jax_lm_loss, observe=ObserveConfig(),
        **HP, **kw,
    )
    data = batches()
    state = precond.init(init, data[0])
    params = init['params']
    trace, ckpt = [], None
    for step, tokens in enumerate(data):
        loss, _, grads, state = precond.step(
            {'params': params}, state, tokens, loss_args=(tokens,),
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
        if step == 1:
            ckpt = precond.state_dict(state)
    return trace, ckpt


def port_trajectory(init, jax_trace, kw, start=0, ckpt=None):
    """The port's steps ``[start, STEPS)``, applying the JAX gradients;
    from ``ckpt`` (a ``load_state_dict`` payload) when given.  Returns
    the per-step trace and the preconditioner's ``state_dict`` after
    step 1 (``None`` when that step was not run)."""
    model = port_model(init)
    with torch.no_grad():  # the weights the JAX run holds at ``start``
        for _, _, grads, _ in jax_trace[:start]:
            for name, p in model.named_parameters():
                p -= LR * grads[name]
    precond = KFACPreconditioner(model, **HP, **kw)
    if ckpt is not None:
        precond.load_state_dict(ckpt)
    trace, saved = [], None
    for step in range(start, STEPS):
        tokens = torch.from_numpy(batches()[step]).long()
        model.zero_grad()
        loss = port_lm_loss(model(tokens), tokens)
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
        if step == 1:
            saved = precond.state_dict(compress_symmetric=True)
    return trace, saved


@pytest.fixture(scope='module', params=list(CONFIGS))
def runs(request, init):
    kw = CONFIGS[request.param]
    jax_trace, jax_ckpt = jax_trajectory(init, kw)
    port_trace, port_ckpt = port_trajectory(init, jax_trace, kw)
    return dict(label=request.param, kw=kw, jax=jax_trace, port=port_trace,
                jax_ckpt=jax_ckpt, port_ckpt=port_ckpt)


def test_losses_match(runs):
    for (want, *_), (got, *_) in zip(runs['jax'], runs['port']):
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_factors_match(runs):
    for step, (want, got) in enumerate(zip(runs['jax'], runs['port'])):
        assert set(got[1]) == set(want[1])
        assert len(got[1]) == N_LAYERS[runs['label']]
        for name, pair in want[1].items():
            for side in (0, 1):
                assert got[1][name][side].shape == pair[side].shape
                err = rel_err(got[1][name][side], pair[side])
                assert err <= REL, (step, name, side, err)


def test_preconditioned_grads_match(runs):
    for step, (want, got) in enumerate(zip(runs['jax'], runs['port'])):
        assert set(got[2]) == set(want[2])
        for name in want[2]:
            err = rel_err(got[2][name], want[2][name])
            assert err <= REL, (step, name, err)


def test_kl_clip_scales_match(runs):
    for step, (want, got) in enumerate(zip(runs['jax'], runs['port'])):
        assert 0.0 < got[3] <= 1.0
        assert abs(got[3] - want[3]) <= REL * want[3], (step, got[3], want[3])


def test_state_dict_round_trip_resumes_bitwise(runs, init):
    """The port's dict after step 1, through ``torch.save``/``load``,
    restores the factors exactly and step 2 bit for bit."""
    sd = runs['port_ckpt']
    if 'embedding' in runs['kw'].get('layer_types', ()):
        assert sd['layers']['wte']['A'].shape == (256,)  # never triu-packed
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    resumed, _ = port_trajectory(init, runs['jax'], runs['kw'], start=2,
                                 ckpt=torch.load(buf))
    want = runs['port'][2]
    for name, (a, g) in want[1].items():
        assert torch.equal(resumed[0][1][name][0], a)
        assert torch.equal(resumed[0][1][name][1], g)
    for name, grad in want[2].items():
        assert torch.equal(resumed[0][2][name], grad), name


def test_jax_checkpoint_resumes_in_the_port(runs, init):
    """The JAX run's ``state_dict`` after step 1, carried across, gives
    the JAX run's step-2 results in the port."""
    ckpt = jax_kfac_state_dict_to_torch(runs['jax_ckpt'])
    resumed, _ = port_trajectory(init, runs['jax'], runs['kw'], start=2,
                                 ckpt=ckpt)
    want = runs['jax'][2]
    for name in want[2]:
        err = rel_err(resumed[0][2][name], want[2][name])
        assert err <= REL, (name, err)


def test_legacy_dense_embedding_a_loads_through_its_diagonal(init):
    model = port_model(init)
    precond = KFACPreconditioner(model, **HP, **CONFIGS['full'])
    tokens = torch.from_numpy(batches()[0]).long()
    port_lm_loss(model(tokens), tokens).backward()
    precond.step()
    sd = precond.state_dict()
    diag = sd['layers']['wte']['A']
    sd['layers']['wte']['A'] = torch.diag(diag)  # the dense form
    fresh = KFACPreconditioner(port_model(init), **HP, **CONFIGS['full'])
    fresh.load_state_dict(sd)
    assert torch.equal(fresh.layers['wte'].a_factor, diag)
    assert torch.equal(fresh.layers['wte'].da, diag)


@pytest.mark.parametrize('kw,exc,match', [
    (dict(attention_impl='ring'), None, None),
    (dict(seq_axis='model'), ValueError, "seq_axis requires attention_impl"),
    (dict(d_model=30, n_heads=4), ValueError, 'multiple of n_heads'),
    (dict(attention_impl='flash'), ValueError, 'attention_impl'),
])
def test_unported_model_options_raise(kw, exc, match):
    """The model options JAX refuses raise here too; ``'ring'`` (item
    27, ported) builds, and without a sequence group gives the dense
    model's logits."""
    if exc is None:
        tokens = torch.from_numpy(batches()[0]).long()
        with torch.no_grad():
            got = gpt_tiny(device='cpu', **kw)(tokens)
            want = gpt_tiny(device='cpu')(tokens)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        return
    with pytest.raises(exc, match=match):
        gpt_tiny(device='cpu', **kw)


def test_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is taken')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gpt_tiny()


def test_bf16_compute_dtypes_follow_flax():
    """bf16 compute: Dense and LayerNorm inputs arrive in bf16, the head
    gets ``x`` in the parameter dtype and returns a bf16 cotangent, the
    logits are f32, the token ids stay integers, and a full-coverage
    step preconditions every layer with finite values."""
    model = gpt_tiny(device='cpu', dtype=torch.bfloat16)
    precond = KFACPreconditioner(model, **HP, **CONFIGS['full'])
    cap = precond._capture
    tokens = torch.from_numpy(batches()[0]).long()
    logits = model(tokens)
    assert logits.dtype == torch.float32
    port_lm_loss(logits, tokens).backward()
    assert cap._acts['h_0.attn.qkv'][0].dtype == torch.bfloat16
    assert cap._acts['h_0.ln_2'][0].dtype == torch.bfloat16
    assert cap._acts['wte'][0].dtype == torch.int64
    assert cap._attend_acts['wte'][0].dtype == torch.float32
    assert cap._attend_grads['wte'][0].dtype == torch.bfloat16
    precond.step()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert precond.layers['wte'].a_factor.dtype == torch.float32
