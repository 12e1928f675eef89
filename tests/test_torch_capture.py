"""The port's capture hooks, step cadence and option surface (CPU).

These pin behaviour the JAX parity tests cannot reach: hooks record
only on factor-update steps, in training mode, with autograd on; a
module applied twice contributes the mean of its per-call factors;
unported JAX options raise ``NotImplementedError`` naming their
``ROADMAP.md`` item.  Factor comparisons are against the port's own ops
on the same tensors (``rtol 1e-6``: identical f32 arithmetic up to the
order of a two-term mean).
"""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.hyperparams import exp_decay_factor_averaging

pytestmark = pytest.mark.torch_port


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.grouped = nn.Conv2d(4, 4, 3, padding=1, groups=2)
        self.fc = nn.Linear(4, 5)
        self.head = nn.Linear(5, 3, bias=False)

    def forward(self, x):
        x = F.relu(self.grouped(F.relu(self.conv(x))))
        x = x.mean(dim=(2, 3))
        return self.head(F.relu(self.fc(x)))


def batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(6, 3, 5, 5, generator=g), torch.randint(
        0, 3, (6,), generator=g,
    )


def fwd_bwd(model, seed=0):
    x, y = batch(seed)
    model.zero_grad()
    F.cross_entropy(model(x), y).backward()


def test_registration_skip_and_reject():
    cap = ModelCapture(Tiny(), skip_layers=('head',))
    assert list(cap.helpers) == ['conv', 'fc']
    assert cap.skipped == ['head']
    assert 'grouped' in cap.rejected
    assert cap.helpers['conv'].a_factor_shape == (28, 28)
    assert cap.helpers['fc'].a_factor_shape == (5, 5)


def test_capture_only_when_armed_training_and_recording():
    model = Tiny()
    cap = ModelCapture(model)
    fwd_bwd(model)
    assert cap._acts == {}  # not armed
    cap.armed = True
    with torch.no_grad():
        model(batch()[0])
    model.eval()
    fwd_bwd(model)
    assert cap._acts == {}
    model.train()
    fwd_bwd(model)
    got = cap.take()
    assert set(got) == {'conv', 'fc', 'head'}
    assert all(len(a) == len(g) == 1 for a, g in got.values())
    with pytest.raises(RuntimeError, match='forward call'):
        cap.take()  # cleared, and nothing captured since


def test_factors_match_ops_on_the_captured_tensors():
    model = Tiny()
    precond = KFACPreconditioner(model, factor_decay=0.9, kl_clip=None)
    acts = {}
    model.conv.register_forward_pre_hook(
        lambda m, i: acts.__setitem__('conv', i[0].detach()),
    )
    fwd_bwd(model)
    precond.step()
    a_new = ops.conv2d_a_factor(acts['conv'], (3, 3), (1, 1), (1, 1))
    want = 0.9 * torch.eye(28) + 0.1 * a_new
    torch.testing.assert_close(
        precond.layers['conv'].a_factor, want, rtol=1e-6, atol=1e-7,
    )


def test_shared_module_averages_calls():
    class Twice(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4)

        def forward(self, x):
            return self.fc(torch.tanh(self.fc(x)))

    model = Twice()
    precond = KFACPreconditioner(model, factor_decay=0.5, kl_clip=None)
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        h = torch.tanh(model.fc(x))
    model(x).square().sum().backward()
    precond.step()
    a_mean = (ops.linear_a_factor(x) + ops.linear_a_factor(h)) / 2
    torch.testing.assert_close(
        precond.layers['fc'].a_factor,
        0.5 * torch.eye(5) + 0.5 * a_mean, rtol=1e-6, atol=1e-7,
    )


def test_cadence_and_schedules():
    model = Tiny()
    precond = KFACPreconditioner(
        model, factor_update_steps=2, inv_update_steps=lambda s: 4,
        factor_decay=exp_decay_factor_averaging(0.95), kl_clip=0.001,
    )
    armed = []
    refreshed = []
    orig = precond._refresh

    def spy(damping):
        refreshed.append(precond.steps)
        orig(damping)

    precond._refresh = spy
    for step in range(6):
        armed.append(precond._capture.armed)
        fwd_bwd(model, seed=step)
        precond.step()
    assert armed == [True, False, True, False, True, False]
    assert refreshed == [0, 4]
    assert precond.steps == 6


def test_precondition_changes_only_registered_grads():
    model = Tiny()
    precond = KFACPreconditioner(model, skip_layers=('head',))
    fwd_bwd(model)
    raw = {n: p.grad.clone() for n, p in model.named_parameters()}
    precond.step()
    for n, p in model.named_parameters():
        if n.startswith(('conv.', 'fc.')):
            assert not torch.equal(p.grad, raw[n]), n
        else:
            assert torch.equal(p.grad, raw[n]), n


def test_damping_validated_each_step():
    model = Tiny()
    with pytest.raises(ValueError, match='damping'):
        KFACPreconditioner(model, damping=0.0)
    precond = KFACPreconditioner(
        model, damping=lambda s: 0.01 if s == 0 else -1.0,
    )
    fwd_bwd(model)
    precond.step()
    fwd_bwd(model)
    with pytest.raises(ValueError, match='at step 1'):
        precond.step()


def test_step_without_backward_raises():
    model = Tiny()
    precond = KFACPreconditioner(model)
    with torch.no_grad():
        model(batch()[0])
    with pytest.raises(RuntimeError):
        precond.step()


@pytest.mark.parametrize('kwargs,item', [
    (dict(compute_method='inverse'), 'item 8'),
    (dict(compute_method='iterative'), 'item 9'),
    (dict(compute_eigenvalue_outer_product=False), 'item 4b'),
    (dict(bucketed=False), 'item 4b'),
    (dict(mesh=object()), 'item 7'),
    (dict(accumulation_steps=2), 'item 14'),
    (dict(lowrank_rank=8), 'item 10'),
    (dict(ekfac=True), 'item 10'),
    (dict(stagger_refresh=2), 'item 15'),
    (dict(adaptive=object()), 'item 16'),
    (dict(overlap_comm=True), 'item 17'),
    (dict(pipeline_grads=True), 'item 18'),
    (dict(factor_comm='bf16_triu'), 'item 13'),
    (dict(health=object()), 'item 19'),
    (dict(consistency=object()), 'item 21'),
    (dict(watchdog=object()), 'item 21'),
    (dict(observe=object()), 'item 23'),
    (dict(flight=object()), 'item 23'),
    (dict(kfac_approx='reduce'), 'item 12'),
    (dict(layer_types=('linear', 'embedding')), 'items 11-12'),
    (dict(use_pallas=True), 'Queue B item 1'),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        KFACPreconditioner(Tiny(), **kwargs)


def test_colocate_factors_required_for_prediv():
    with pytest.raises(ValueError, match='colocate_factors'):
        KFACPreconditioner(Tiny(), colocate_factors=False)
