"""``remat`` in the port's GPT and BERT, and ``CoverageLM``, against the
port without ``remat`` and against the JAX package, on the CPU.

* ``gpt_tiny`` (full and default coverage) and ``bert_tiny`` with
  ``remat=True`` against ``remat=False`` from the same weights: two
  ``KFACPreconditioner`` steps with SGD, losses, every factor EMA and
  every gradient bitwise; the recompute of a block during the backward
  records no activation and puts no gradient hook (one capture per
  layer call).
* ``gpt_tiny(remat=True)`` against the JAX model with ``remat=True``:
  the logits.  A K-FAC step cannot be compared: JAX's capture cannot
  trace its ``remat=True`` model (ROADMAP.md Queue C); the port's remat
  step is bitwise its plain step, which ``tests/test_torch_gpt.py``
  holds against JAX's.
* ``CoverageLM``: the logits from the JAX weights, and the full-coverage
  registration (``layer_types=('linear', 'embedding', 'layernorm',
  'dense_general')``, ``tied_weights=('wte',)``) against JAX's coverage
  report.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import bert_tiny
from kfac_pytorch_tpu_torch.models import CoverageLM
from kfac_pytorch_tpu_torch.models import gpt_tiny

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

HP = dict(factor_update_steps=1, inv_update_steps=1, damping=0.003,
          kl_clip=0.001, lr=0.1)
FULL = dict(layer_types=('linear', 'embedding', 'layernorm'),
            tied_weights=('wte',))
COVERAGE = dict(layer_types=('linear', 'embedding', 'layernorm',
                             'dense_general'), tied_weights=('wte',))


def tokens(batch=4, length=16, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (batch, length))).long()


def lm_loss(logits, toks):
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           toks[:, 1:].reshape(-1))


def span_loss(out, toks):
    start, end = out
    return (F.cross_entropy(start, toks[:, 0] % start.shape[1])
            + F.cross_entropy(end, toks[:, 1] % end.shape[1]))


def run(model, loss_fn, kw, steps=2):
    precond = KFACPreconditioner(model, **HP, **kw)
    trace = []
    for step in range(steps):
        x = tokens(seed=step)
        model.zero_grad()
        loss = loss_fn(model(x), x)
        loss.backward()
        precond.step()
        trace.append((
            loss.detach().clone(),
            {n: (st.a_factor.clone(), st.g_factor.clone())
             for n, st in precond.layers.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
        ))
        with torch.no_grad():
            for p in model.parameters():
                p -= 0.1 * p.grad
    return trace


MODELS = {
    'gpt_full': (gpt_tiny, lm_loss, FULL),
    'gpt_default': (gpt_tiny, lm_loss, {}),
    'bert': (bert_tiny, span_loss, {}),
}


@pytest.mark.parametrize('name', list(MODELS))
def test_remat_is_bitwise(name):
    build, loss_fn, kw = MODELS[name]
    plain = run(build(device='cpu', remat=False), loss_fn, kw)
    remat = run(build(device='cpu', remat=True), loss_fn, kw)
    for step, (a, b) in enumerate(zip(plain, remat)):
        assert torch.equal(a[0], b[0]), step
        for n, (fa, fg) in a[1].items():
            assert torch.equal(fa, b[1][n][0]), (step, n)
            assert torch.equal(fg, b[1][n][1]), (step, n)
        for n, g in a[2].items():
            assert torch.equal(g, b[2][n]), (step, n)


def test_recompute_records_nothing():
    """One activation and one output gradient per layer call, although
    each block's forward runs twice."""
    model = gpt_tiny(device='cpu', remat=True)
    cap = ModelCapture(model, **FULL)
    calls = []
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            m.register_forward_pre_hook(lambda m, i: calls.append(m))
    cap.armed = True
    x = tokens()
    lm_loss(model(x), x).backward()
    taken = cap.take()
    n_linear = sum(isinstance(m, torch.nn.Linear) for m in model.modules())
    assert len(calls) == 2 * n_linear  # the forward and the recompute
    for name, roles in taken.items():
        for _, acts, grads in roles:
            assert len(acts) == len(grads) == 1, name


# -- against JAX --------------------------------------------------------


@pytest.fixture(scope='module')
def jax_gpt():
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

    model = jax_gpt_tiny(remat=True)
    variables = jax.tree.map(np.asarray, fnn.meta.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))))
    return model, variables


def test_remat_logits_match_jax(jax_gpt):
    import jax

    model, variables = jax_gpt
    x = tokens()
    want = np.asarray(jax.jit(model.apply)(variables,
                                          x.numpy().astype(np.int32)))
    port = gpt_tiny(device='cpu', remat=True)
    port.load_state_dict(flax_to_torch_state_dict(variables))
    with torch.no_grad():
        np.testing.assert_allclose(port(x).numpy(), want, atol=1e-5)


def test_coverage_lm_matches_jax():
    import flax.linen as fnn
    import jax

    from kfac_pytorch_tpu.capture import ModelCapture as JaxCapture
    from kfac_pytorch_tpu.models.tiny import CoverageLM as JaxCoverageLM

    x = tokens(batch=2, length=5) % 32
    xs = x.numpy().astype(np.int32)
    jmodel = JaxCoverageLM()
    variables = jax.tree.map(np.asarray, fnn.meta.unbox(
        jax.jit(jmodel.init)(jax.random.PRNGKey(1), xs)))
    port = CoverageLM()
    port.load_state_dict(flax_to_torch_state_dict(variables))
    with torch.no_grad():
        np.testing.assert_allclose(port(x).numpy(),
                                   np.asarray(jmodel.apply(variables, xs)),
                                   rtol=1e-5, atol=1e-6)
    jcap = JaxCapture(jmodel, **COVERAGE)
    jcap.register(variables, xs)
    want = jcap.coverage
    got = ModelCapture(port, **COVERAGE).coverage
    for key in ('registered', 'tied', 'skipped', 'unsupported',
                'params_total', 'params_covered', 'param_fraction'):
        assert got[key] == want[key], key
    assert got['param_fraction'] == 1.0 and got['uncovered'] == []
