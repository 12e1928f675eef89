"""The port's step cadence against the JAX package's.

Every other JAX-versus-port trajectory runs ``factor_update_steps=1``.
Here LeNet at 12x12, batch 8, runs 9 steps with
``factor_update_steps=2, inv_update_steps=4``, a callable damping and a
callable ``factor_decay`` (both change at step 4), so the trajectory
holds factor steps, steps without factors, refreshes at steps 0, 4 and
8, and steps that precondition with decompositions two and three steps
old.  Both sides start from the same bridged weights, see the same numpy
batches and apply the same numpy SGD update (the JAX side's gradients).
Compared per step, with ``kl_clip=0.001`` and with ``kl_clip=None``: the
loss (``rtol 1e-5``), every layer's factor EMAs and every parameter's
preconditioned gradient (relative Frobenius error ``<= 1e-4``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import LeNet

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

STEPS = 9
LR = 0.1
REL = 1e-4


def damping(step):
    return 0.003 if step < 4 else 0.002


def factor_decay(step):
    return 0.95 if step < 4 else 0.9


def hp(kl_clip):
    return dict(factor_update_steps=2, inv_update_steps=4, damping=damping,
                factor_decay=factor_decay, kl_clip=kl_clip, lr=LR)


def batches():
    rng = np.random.default_rng(17)
    return [(rng.standard_normal((8, 12, 12, 1)).astype(np.float32),
             rng.integers(0, 10, size=(8,))) for _ in range(STEPS)]


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def jax_xent(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))


@pytest.fixture(scope='module', params=[0.001, None],
                ids=['kl_clip', 'no_kl_clip'])
def runs(request):
    kl_clip = request.param
    data = batches()
    model = JaxLeNet()
    variables = jax.tree.map(np.asarray,
                             model.init(jax.random.PRNGKey(9), data[0][0]))
    precond = JaxPreconditioner(model, loss_fn=jax_xent, **hp(kl_clip))
    state = precond.init(variables, data[0][0])
    params = variables['params']
    want = []
    for x, y in data:
        loss, _, grads, state = precond.step(
            {'params': params}, state, x, loss_args=(jnp.asarray(y),))
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        want.append((float(loss), {
            base: (np.asarray(state[base].a_factor),
                   np.asarray(state[base].g_factor))
            for base in state.layers
        }, flax_to_torch_state_dict({'params': grads})))

    net = LeNet(image_size=12)
    net.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    port = KFACPreconditioner(net, **hp(kl_clip))
    got = []
    for (x, y), (_, _, jax_grads) in zip(data, want):
        net.zero_grad()
        loss = F.cross_entropy(
            net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())),
            torch.from_numpy(y))
        loss.backward()
        port.step()
        got.append((float(loss.detach()), {
            n: (st.a_factor.clone(), st.g_factor.clone())
            for n, st in port.layers.items()
        }, {n: p.grad.clone() for n, p in net.named_parameters()}))
        with torch.no_grad():
            for n, p in net.named_parameters():
                p -= LR * jax_grads[n]
    return kl_clip, want, got, port


def test_losses_match(runs):
    _, want, got, _ = runs
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-5)


def test_factors_match(runs):
    _, want, got, _ = runs
    for step, (w, g) in enumerate(zip(want, got)):
        assert set(g[1]) == set(w[1]) and len(g[1]) == 5
        for layer, pair in w[1].items():
            for side in (0, 1):
                err = rel_err(g[1][layer][side], pair[side])
                assert err <= REL, (step, layer, side, err)


def test_preconditioned_grads_match(runs):
    _, want, got, _ = runs
    for step, (w, g) in enumerate(zip(want, got)):
        for name in w[2]:
            err = rel_err(g[2][name], w[2][name])
            assert err <= REL, (step, name, err)


def test_cadence_ran_as_scheduled(runs):
    """Factor EMAs move only on even steps; the last refresh was step 8,
    at the second damping."""
    kl_clip, _, got, port = runs
    for step in range(1, STEPS):
        same = all(torch.equal(got[step][1][n][0], got[step - 1][1][n][0])
                   for n in got[step][1])
        assert same == (step % 2 == 1), step
    assert port.steps == STEPS and port._last_inv_step == 8
    assert port.damping == 0.002 and port.factor_decay == 0.9
    assert (port.last_kl_scale is None) == (kl_clip is None)
