"""Gradient accumulation in the port against the JAX package's.

The JAX side runs ``accumulate`` once per micro-batch and ``finalize``
on the micro-batch mean gradients; the port runs one forward/backward
per micro-batch with the loss divided by ``N`` and then ``step()``, its
``finalize``.  Both start from the same bridged weights, see the same
numpy micro-batches and apply the same numpy SGD update (the JAX
side's gradients) between steps.

Models: LeNet at 12x12 and a small net around the JAX ``Bottleneck``
(``planes=4``, stride 2, so its projection shortcut runs; BatchNorm in
training mode, so each micro-batch normalizes by its own statistics on
both sides), micro-batches of 4 rows, ``N`` = 2 and 3,
``factor_update_steps=2, inv_update_steps=4``, kl-clip 0.001.  The five
steps hold:

* step 0, a factor and refresh step; step 1, a step without factors
  (no capture armed), and step 3 likewise;
* step 2, a factor step whose micro-batch sums are dropped by
  ``reset_batch()`` just before ``step()``: counts of 0, so every
  factor EMA stays as it was;
* step 4, a factor and refresh step that first runs a micro-batch and
  drops it (``reset_batch()`` and zeroed gradients), then a trailing
  partial group of ``N - 1`` micro-batches, whose gradients are scaled
  by ``N / (N - 1)`` as the trainers do.

Compared per step: the micro-batch losses, every layer's factor EMAs
and every K-FAC layer's preconditioned gradient (relative Frobenius
error ``<= 1e-5`` per tensor; the BatchNorm parameters' plain gradients
``<= 1e-4``), and the kl-clip scale (relative ``<= 1e-5``; the JAX
side's ``observe/kl_nu``).
"""
from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu.models.resnet import Bottleneck as JaxBottleneck
from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
from kfac_pytorch_tpu.observe import ObserveConfig
from kfac_pytorch_tpu.preconditioner import (
    KFACPreconditioner as JaxPreconditioner,
)
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import Bottleneck
from kfac_pytorch_tpu_torch.models import LeNet
from kfac_pytorch_tpu_torch.models.layers import Conv2d

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

LR = 0.1
HP = dict(factor_update_steps=2, inv_update_steps=4, damping=0.003,
          kl_clip=0.001, lr=LR)
REL = 1e-5
MICRO = 4
#: Per step: ``(dropped micro-batches, kept micro-batches, reset before
#: step())`` as functions of ``N``.
PLAN = [
    lambda n: (0, n, False),
    lambda n: (0, n, False),
    lambda n: (0, n, True),
    lambda n: (0, n, False),
    lambda n: (1, n - 1, False),
]
CASES = [('lenet', 2), ('lenet', 3), ('bottleneck', 2), ('bottleneck', 3)]


class JaxBottleNet(fnn.Module):
    """A 3x3 stem, one ``Bottleneck(planes=4, stride=2)``, mean pool and
    a dense head, NHWC."""

    @fnn.compact
    def __call__(self, x, train: bool = True):
        x = fnn.Conv(16, (3, 3), padding=((1, 1), (1, 1)), use_bias=False,
                     name='conv1')(x)
        x = JaxBottleneck(4, 2, name='block')(x, train=train)
        return fnn.Dense(10, name='fc')(jnp.mean(x, axis=(1, 2)))


class BottleNet(nn.Module):
    """The port's counterpart of :class:`JaxBottleNet`, NCHW."""

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = Conv2d(3, 16, 3, padding=1)
        self.block = Bottleneck(16, 4, stride=2)
        self.fc = nn.Linear(16, 10)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.block(self.conv1(x)).mean(dim=(2, 3)))


def micro_batches(name: str, n: int):
    """Per step, the list of micro-batches the plan runs (dropped ones
    first), NHWC."""
    rng = np.random.default_rng(7)
    channels = 1 if name == 'lenet' else 3
    out = []
    for plan in PLAN:
        dropped, kept, _ = plan(n)
        out.append([
            (rng.standard_normal((MICRO, 12, 12, channels))
             .astype(np.float32), rng.integers(0, 10, size=(MICRO,)))
            for _ in range(dropped + kept)
        ])
    return out


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def jax_xent(out, labels):
    logits, updates = out if isinstance(out, tuple) else (out, None)
    logp = jax.nn.log_softmax(logits)
    nll = -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=1))
    return (nll, updates) if updates is not None else nll


def jax_model(name):
    if name == 'lenet':
        return JaxLeNet(), {}
    return JaxBottleNet(), {'train': True, 'mutable': ['batch_stats']}


def init_variables(name):
    model, _ = jax_model(name)
    x = micro_batches(name, 2)[0][0][0]
    variables = jax.tree.map(np.asarray,
                             model.init(jax.random.PRNGKey(3), x))
    if name == 'bottleneck':
        # A non-zero bn3 scale, so the block's last conv has gradients.
        params = variables['params']
        params['block']['bn3']['scale'] = np.full(16, 0.5, np.float32)
    return variables


def jax_trajectory(name, n, variables):
    """Per step ``(losses, factors, grads, kl_nu)``, factors and grads
    by port name."""
    model, apply_kwargs = jax_model(name)
    precond = JaxPreconditioner(
        model, loss_fn=jax_xent, apply_kwargs=apply_kwargs or None,
        accumulation_steps=n, observe=ObserveConfig(), **HP,
    )
    data = micro_batches(name, n)
    state = precond.init(variables, data[0][0][0])
    params = variables['params']
    others = {k: v for k, v in variables.items() if k != 'params'}
    accum = precond.init_accum()
    trace = []
    for step, plan in enumerate(PLAN):
        dropped, kept, reset = plan(n)
        losses, total = [], None
        for i, (x, y) in enumerate(data[step]):
            loss, _, grads, accum = precond.accumulate(
                {'params': params, **others}, state, accum, x,
                loss_args=(jnp.asarray(y),),
            )
            if i < dropped:
                accum = precond.reset_batch()
                continue
            losses.append(float(loss))
            total = grads if total is None else jax.tree.map(
                jnp.add, total, grads)
        if reset:
            accum = precond.reset_batch()
        avg = jax.tree.map(lambda g: g / kept, total)
        grads, state, accum = precond.finalize(state, avg, accum)
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        factors = {
            base.replace('/', '.'): (np.asarray(state[base].a_factor),
                                     np.asarray(state[base].g_factor))
            for base in state.layers
        }
        trace.append((losses, factors,
                      flax_to_torch_state_dict({'params': grads}),
                      float(precond.last_step_info['observe/kl_nu'])))
    return trace


def port_trajectory(name, n, variables, jax_trace):
    model = LeNet(image_size=12) if name == 'lenet' else BottleNet()
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    model.train()
    precond = KFACPreconditioner(model, accumulation_steps=n, **HP)
    trace = []
    for step, (plan, batch) in enumerate(zip(PLAN, micro_batches(name, n))):
        dropped, kept, reset = plan(n)
        losses = []
        model.zero_grad()
        for i, (x, y) in enumerate(batch):
            xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
            loss = F.cross_entropy(model(xt), torch.from_numpy(y))
            (loss / n).backward()
            if i < dropped:
                precond.reset_batch()
                model.zero_grad()
                continue
            losses.append(float(loss.detach()))
        if reset:
            precond.reset_batch()
        if kept < n:
            with torch.no_grad():
                for p in model.parameters():
                    p.grad *= n / kept
        precond.step()
        factors = {k: (st.a_factor.clone(), st.g_factor.clone())
                   for k, st in precond.layers.items()}
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        trace.append((losses, factors, grads,
                      float(precond.last_kl_scale)))
        with torch.no_grad():
            for k, p in model.named_parameters():
                p -= LR * jax_trace[step][2][k]
    return precond, trace


@pytest.fixture(scope='module', params=CASES,
                ids=[f'{m}-N{n}' for m, n in CASES])
def runs(request):
    name, n = request.param
    variables = init_variables(name)
    jax_trace = jax_trajectory(name, n, variables)
    precond, port_trace = port_trajectory(name, n, variables, jax_trace)
    return dict(name=name, n=n, jax=jax_trace, port=port_trace,
                precond=precond)


def test_micro_batch_losses_match(runs):
    for step, (want, got) in enumerate(zip(runs['jax'], runs['port'])):
        assert len(got[0]) == len(want[0]) == PLAN[step](runs['n'])[1]
        np.testing.assert_allclose(got[0], want[0], rtol=REL)


def test_factors_match(runs):
    n_layers = 5 if runs['name'] == 'lenet' else 6
    for step, (want, got) in enumerate(zip(runs['jax'], runs['port'])):
        assert set(got[1]) == set(want[1]) and len(got[1]) == n_layers
        for layer, pair in want[1].items():
            for side in (0, 1):
                err = rel_err(got[1][layer][side], pair[side])
                assert err <= REL, (step, layer, side, err)


def test_zero_count_step_keeps_the_factor_emas(runs):
    """Step 2's sums were dropped before ``step()``: its EMAs are step
    1's, which are step 0's, bit for bit."""
    trace = runs['port']
    for layer, (a, g) in trace[0][1].items():
        assert torch.equal(trace[2][1][layer][0], a), layer
        assert torch.equal(trace[2][1][layer][1], g), layer
    # Step 4 folded its partial group: the EMAs moved.
    assert any(not torch.equal(trace[4][1][k][0], trace[2][1][k][0])
               for k in trace[2][1])


def test_preconditioned_grads_match(runs):
    """The K-FAC layers' gradients at 1e-5; the BatchNorm parameters,
    which K-FAC does not precondition, carry the two autograds' own
    BatchNorm backward (f32 summation orders ~1e-5 apart on these small
    gradients) and are held at 1e-4."""
    layers = set(runs['precond'].helpers)
    for step, (want, got) in enumerate(zip(runs['jax'], runs['port'])):
        assert set(got[2]) == set(want[2])
        for param in want[2]:
            bar = REL if param.rsplit('.', 1)[0] in layers else 1e-4
            err = rel_err(got[2][param], want[2][param])
            assert err <= bar, (step, param, err)


def test_kl_clip_scales_match(runs):
    for step, (want, got) in enumerate(zip(runs['jax'], runs['port'])):
        assert 0.0 < got[3] <= 1.0
        assert abs(got[3] - want[3]) <= REL * want[3], (step, got[3], want[3])


def test_micro_batch_sums_are_not_checkpointed(runs):
    precond = runs['precond']
    assert precond.accumulation_steps == runs['n']
    sd = precond.state_dict()
    assert set(sd) >= {'steps', 'layers'}
    assert not any('accum' in k or 'batch' in k for k in sd)


def test_accumulation_steps_below_one_raise():
    with pytest.raises(ValueError, match='accumulation_steps must be >= 1'):
        KFACPreconditioner(LeNet(image_size=12), accumulation_steps=0)


def test_micro_batch_captures_fold_before_the_next_forward():
    """The hooks hold one micro-batch's activations at a time: the next
    forward folds the finished pass into the sums first."""
    model = LeNet(image_size=12)
    precond = KFACPreconditioner(model, accumulation_steps=3)
    cap = precond._capture
    x = torch.randn(4, 1, 12, 12)
    for i in range(3):
        (model(x).sum() / 3).backward()
        assert len(cap._acts['conv1']) == 1
        assert len(precond._accum) == (5 if i else 0)
        counts = {a.a_count for a in precond._accum.values()}
        assert counts == ({i} if i else set())
    precond.step()
    assert precond._accum == {} and not cap.pending()


def test_fold_waits_for_a_backward_pass():
    """Only an output gradient arms the fold: a second forward without a
    backward in between, or a forward that does not record, folds
    nothing, and the fold disarms it again."""
    model = LeNet(image_size=12)
    precond = KFACPreconditioner(model, accumulation_steps=2)
    cap = precond._capture
    x = torch.randn(4, 1, 12, 12)
    model(x)
    loss = model(x).sum() / 2
    assert not cap._grads_arrived and len(cap._acts['conv1']) == 2
    cap.clear()
    loss = model(x).sum() / 2
    loss.backward()
    assert cap._grads_arrived and precond._accum == {}
    with torch.no_grad():
        model(x)
    assert cap._grads_arrived and precond._accum == {}
    (model(x).sum() / 2).backward()
    assert len(precond._accum) == 5 and len(cap._acts['conv1']) == 1
    precond.reset_batch()
    assert not cap._grads_arrived and not cap.pending()
