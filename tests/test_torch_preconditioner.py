"""The port's ``KFACPreconditioner`` against the JAX package's, end to end.

A 3-step trajectory of CIFAR ResNet-20 at 16x16, batch 4, with
``factor_update_steps=1, inv_update_steps=2`` (refreshes at steps 0 and
2), damping 0.003, kl-clip 0.001, lr 0.1: both sides start from the same
bridged weights, see the same numpy batches and apply the same numpy
SGD update between steps — the JAX side's gradients, so both hold the
same parameters at every step.  (Each side following its own gradients
would compare the trajectory's conditioning, not the port: this
network's BatchNorm-parameter gradients move by ~1% under a 1e-6
relative parameter change.)  Compared per step: the loss, every layer's
factor EMAs, and every parameter's preconditioned gradient (unpadded,
per layer; eigenvectors are never compared).

Tolerances (f32 on both sides, different BLAS/LAPACK summation orders):
loss ``rtol 1e-5``; factors and preconditioned gradients a relative
Frobenius error ``<= 1e-4`` per tensor — the eigendecompositions of the
identity-seeded factors are well conditioned, so f32 rounding (~1e-7)
amplified by ``1/damping`` stays far below it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu.models import resnet20 as jax_resnet20
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import resnet20

pytestmark = pytest.mark.torch_port

STEPS = 3
LR = 0.1
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR)
REL = 1e-4


def batches():
    rng = np.random.default_rng(11)
    return [
        (rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
         rng.integers(0, 10, size=(4,)))
        for _ in range(STEPS)
    ]


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope='module')
def jax_run():
    """The JAX trajectory: initial variables, then per step the loss,
    the factors (by torch layer name) and the grads (torch layout)."""
    model = jax_resnet20(num_classes=10)
    data = batches()
    variables = model.init(jax.random.PRNGKey(5), data[0][0], train=True)
    init = jax.tree.map(np.asarray, variables)

    def loss_fn(out, labels):
        logits, updates = out
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))
        return nll, updates

    precond = JaxPreconditioner(
        model, loss_fn=loss_fn,
        apply_kwargs={'train': True, 'mutable': ['batch_stats']}, **HP,
    )
    state = precond.init(variables, data[0][0])
    params = init['params']
    trace = []
    for x, y in data:
        loss, _, grads, state = precond.step(
            {'params': params, 'batch_stats': init['batch_stats']}, state,
            x, loss_args=(jnp.asarray(y),),
        )
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        factors = {
            base.replace('/', '.'): (
                np.asarray(state[base].a_factor),
                np.asarray(state[base].g_factor),
            )
            for base in state.layers
        }
        trace.append((float(loss), factors,
                      flax_to_torch_state_dict({'params': grads})))
    return init, trace


@pytest.fixture(scope='module')
def port_run(jax_run):
    init, jax_trace = jax_run
    model = resnet20(device='cpu')
    model.load_state_dict(flax_to_torch_state_dict(init), strict=True)
    model.train()
    precond = KFACPreconditioner(model, **HP)
    trace = []
    for (x, y), (_, _, jax_grads) in zip(batches(), jax_trace):
        model.zero_grad()
        logits = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        loss = F.cross_entropy(logits, torch.from_numpy(y))
        loss.backward()
        precond.step()
        factors = {
            name: (st.a_factor.numpy().copy(), st.g_factor.numpy().copy())
            for name, st in precond.layers.items()
        }
        grads = {n: p.grad.numpy().copy()
                 for n, p in model.named_parameters()}
        trace.append((float(loss.detach()), factors, grads))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(
                    p.detach().numpy() - LR * jax_grads[name].numpy(),
                ))
    return precond, trace


@pytest.mark.parametrize('step', range(STEPS))
def test_losses_match(jax_run, port_run, step):
    want = jax_run[1][step][0]
    got = port_run[1][step][0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize('step', range(STEPS))
def test_factors_match(jax_run, port_run, step):
    want = jax_run[1][step][1]
    got = port_run[1][step][1]
    assert set(got) == set(want) and len(got) == 20
    for name in want:
        for side in (0, 1):
            err = rel_err(got[name][side], want[name][side])
            assert err <= REL, (name, side, err)


@pytest.mark.parametrize('step', range(STEPS))
def test_preconditioned_grads_match(jax_run, port_run, step):
    want = jax_run[1][step][2]
    got = port_run[1][step][2]
    assert set(got) == set(want)
    for name in want:
        err = rel_err(got[name], want[name])
        assert err <= REL, (name, err)


def test_port_trajectory_bookkeeping(port_run):
    precond, _ = port_run
    assert precond.steps == STEPS
    # CPU tensors run the plain version: no kernel launches.
    from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition
    assert fused_eigen_precondition.launches == 0
    assert precond.last_kl_scale is not None
    assert 0.0 < float(precond.last_kl_scale) <= 1.0
