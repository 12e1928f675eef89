"""The port's ``KFACPreconditioner`` at the JAX package's accelerator
precision (``precond_dtype`` and ``cov_dtype`` bf16) against the JAX
package's, end to end.

A 3-step trajectory of an MLP (24 inputs, Dense widths 32, 16, 4) on
batches of 64, prediv eigen, ``factor_update_steps=1,
inv_update_steps=2`` (refreshes at steps 0 and 2), damping 0.003,
kl-clip 0.001, lr 0.1, ``factor_decay=0``: each step's factors are that
step's covariances.  (With the default decay the identity seed dominates
the G factors, whose gradients are small: their spectra are degenerate
to f32 precision, so each side's ``eigh`` picks its own basis inside
the cluster.  Both bases are right, and in f32 the two sides then agree
to 1e-6; rounded to bf16 they differ by a bf16 ulp in most elements,
~4e-3 of the preconditioned gradient.)  Both sides start from the same bridged weights
(``convert.py``), see the same numpy batches and apply the same numpy
SGD update between steps (the JAX side's gradients).  The JAX side runs
``use_pallas=True`` with the kernel's entry points in interpret mode
(``tests/test_pallas.py``'s patch): its kernel keeps every intermediate
in f32 and rounds ``v2`` to bf16, the function the port's kernel
computes (on the CPU its plain version).  JAX's default
``use_pallas=False`` chain keeps bf16 intermediates
(``kfac_pytorch_tpu/parallel/second_order.py:1715-1740``), so it is not
the kernel's counterpart.

Tolerances: factors ``rtol 1e-5`` (the covariances of bf16 inputs, f32
sums in other orders); preconditioned gradients within a mean relative
error of 1e-3 per parameter (the bf16 operands round the eigenbases, and
``v2`` rounds where the two sides' f32 sums differ in the last bits);
kl-clip scales ``rtol 1e-3``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kfac_pytorch_tpu.ops.pallas_precond as pp
from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
from kfac_pytorch_tpu.observe import ObserveConfig
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import MLP

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

STEPS = 3
LR = 0.1
D_IN = 24
FEATURES = (32, 16, 4)
HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
          kl_clip=0.001, lr=LR, factor_decay=0.0)


def batches():
    rng = np.random.default_rng(23)
    return [(rng.standard_normal((64, D_IN)).astype(np.float32),
             rng.integers(0, FEATURES[-1], size=64)) for _ in range(STEPS)]


def xent(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))


def mean_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


@pytest.fixture(scope='module')
def jax_run():
    """Initial variables and, per step, the loss, the factors (by torch
    layer name), the grads (torch layout) and the kl-clip scale
    (``observe/kl_nu``)."""
    model = JaxMLP(features=FEATURES)
    data = batches()
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(3), data[0][0]))
    precond = JaxPreconditioner(
        model, loss_fn=xent, precond_dtype=jnp.bfloat16,
        cov_dtype=jnp.bfloat16, use_pallas=True, observe=ObserveConfig(),
        **HP,
    )
    orig = pp.fused_eigen_precondition

    def interpreted(g, qa, qg, dgda, interpret=False):
        return orig(g, qa, qg, dgda, interpret=True)

    mp = pytest.MonkeyPatch()
    mp.setattr(pp, 'fused_eigen_precondition', interpreted)
    try:
        state = precond.init(variables, data[0][0])
        params = variables['params']
        trace = []
        for x, y in data:
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
    finally:
        mp.undo()
    return variables, trace


@pytest.fixture(scope='module')
def port_run(jax_run):
    variables, jax_trace = jax_run
    model = MLP(D_IN, FEATURES)
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    precond = KFACPreconditioner(model, precond_dtype=torch.bfloat16,
                                 cov_dtype=torch.bfloat16, **HP)
    trace = []
    for (x, y), jax_step in zip(batches(), jax_trace):
        model.zero_grad()
        loss = F.cross_entropy(model(torch.from_numpy(x)),
                               torch.from_numpy(y))
        loss.backward()
        precond.step()
        factors = {k: (st.a_factor.numpy().copy(),
                       st.g_factor.numpy().copy())
                   for k, st in precond.layers.items()}
        grads = {k: p.grad.numpy().copy()
                 for k, p in model.named_parameters()}
        trace.append((float(loss.detach()), factors, grads,
                      float(precond.last_kl_scale)))
        with torch.no_grad():
            for k, p in model.named_parameters():
                p -= LR * jax_step[2][k]
    return precond, trace


@pytest.mark.parametrize('step', range(STEPS))
def test_bf16_losses_and_factors_match_jax(jax_run, port_run, step):
    want, got = jax_run[1][step], port_run[1][step]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert set(got[1]) == set(want[1]) and len(got[1]) == len(FEATURES)
    for name in want[1]:
        for side in (0, 1):
            np.testing.assert_allclose(got[1][name][side],
                                       want[1][name][side], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize('step', range(STEPS))
def test_bf16_preconditioned_grads_match_jax_kernel(jax_run, port_run,
                                                    step):
    want, got = jax_run[1][step], port_run[1][step]
    assert set(got[2]) == set(want[2])
    for name in want[2]:
        err = mean_rel(got[2][name], want[2][name])
        assert err < 1e-3, (name, err)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-3)


def test_bf16_path_runs_the_kernels_plain_version(port_run):
    # Every bucket keeps dgda (prediv eigen) and goes through the fused
    # op; on CPU tensors that is the plain version, with no launch.
    from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition

    precond, trace = port_run
    assert precond.steps == STEPS
    assert all(bs.dgda is not None for bs in precond.buckets.values())
    assert fused_eigen_precondition.launches == 0
    assert all(0.0 < s <= 1.0 for *_, s in trace)
