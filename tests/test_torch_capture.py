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
    # One role per layer (no tied attend call here), one call each.
    assert all(len(roles) == 1 for roles in got.values())
    assert all(len(a) == len(g) == 1 for ((_, a, g),) in got.values())
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
    # Tiny's weights come from the global RNG, whose state depends on the
    # tests run before this one in the process; on about 2% of states the
    # ReLUs after `conv` are all dead, its raw gradient is exactly zero
    # and any preconditioner leaves it so.  Seed the weights.
    torch.manual_seed(0)
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
    (dict(bucketed=False), 'item 4b'),
    (dict(compute_method='inverse', bucketed=False), 'item 4b'),
    (dict(mesh=object()), 'item 7'),
    (dict(lowrank_rank=8, stagger_refresh=2), 'item 15'),
    (dict(ekfac=True, overlap_comm=True), 'item 17'),
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
    (dict(topology=object()), 'item 29'),
    (dict(compile_budget=4), 'item 31'),
    (dict(use_pallas=True), 'Queue B item 1'),
])
def test_unported_options_raise(kwargs, item):
    if item in PORTED or set(GUARDS) & set(kwargs):
        check_ported_option(kwargs)
        return
    with pytest.raises(NotImplementedError, match=item):
        KFACPreconditioner(Tiny(), **kwargs)


#: Queue A items ported since these cases were written: each case now
#: checks the option's ported behaviour (the default ``inv_update_steps``
#: is 1, below ``stagger_refresh=2``).  ``health`` (item 19),
#: ``consistency`` (item 21's first half), the watchdog (item 21b) and
#: ``observe``/``flight`` (item 23) are ported too: a wrong config type
#: raises ``TypeError``; so does a ``topology`` that is not a
#: ``PodTopology`` (item 29).  ``compile_budget`` (item 31) attaches the
#: retrace guard.
PORTED = ('item 4b', 'item 13', 'item 15', 'item 16', 'item 17', 'item 18',
          'item 29', 'item 31')
#: The options that take a config object, and the config's class name.
GUARDS = ('health', 'consistency', 'watchdog', 'observe', 'flight')


def check_ported_option(kwargs):
    if kwargs.get('bucketed') is False:
        precond = KFACPreconditioner(Tiny(), **kwargs)
        assert not precond.bucketed and precond.buckets == {}
    elif 'lowrank_rank' in kwargs:
        with pytest.raises(ValueError, match='mutually exclusive'):
            KFACPreconditioner(Tiny(), **kwargs)
    elif 'stagger_refresh' in kwargs:
        with pytest.raises(ValueError, match='exceeds'):
            KFACPreconditioner(Tiny(), **kwargs)
        KFACPreconditioner(Tiny(), inv_update_steps=2, **kwargs)
    elif 'adaptive' in kwargs:
        with pytest.raises(TypeError, match='AdaptiveRefreshConfig'):
            KFACPreconditioner(Tiny(), stagger_refresh=1, **kwargs)
        from kfac_pytorch_tpu_torch import AdaptiveRefreshConfig

        with pytest.raises(ValueError, match='stagger_refresh'):
            KFACPreconditioner(Tiny(), adaptive=AdaptiveRefreshConfig())
    elif kwargs.get('ekfac'):
        with pytest.raises(ValueError, match='overlap_comm and ekfac'):
            KFACPreconditioner(Tiny(), **kwargs)
    elif 'overlap_comm' in kwargs:
        precond = KFACPreconditioner(Tiny(), **kwargs)
        assert precond._overlap_comm and precond.overlap_pending is None
    elif 'pipeline_grads' in kwargs:
        precond = KFACPreconditioner(Tiny(), **kwargs)
        assert precond._second_order.pipeline_order == tuple(
            b.key for b in precond.plan.buckets)
    elif {'observe', 'flight'} & set(kwargs):
        from kfac_pytorch_tpu_torch.observe import FlightConfig
        from kfac_pytorch_tpu_torch.observe import ObserveConfig

        (name,) = {'observe', 'flight'} & set(kwargs)
        config = {'observe': ObserveConfig, 'flight': FlightConfig}[name]
        with pytest.raises(TypeError, match=config.__name__):
            KFACPreconditioner(Tiny(), **kwargs)
        value = (ObserveConfig() if name == 'observe' else FlightConfig(
            path='unused.json', arm_atexit=False, arm_sigterm=False))
        precond = KFACPreconditioner(Tiny(), **{name: value})
        assert getattr(precond, name) is not None
    elif 'compile_budget' in kwargs:
        precond = KFACPreconditioner(Tiny(), **kwargs)
        assert precond.retrace_guard is not None
        assert precond.retrace_guard.budget == kwargs['compile_budget']
        assert precond.compile_budget == kwargs['compile_budget']
    elif 'topology' in kwargs:
        from kfac_pytorch_tpu_torch import PodTopology

        with pytest.raises(TypeError, match='PodTopology'):
            KFACPreconditioner(Tiny(), **kwargs)
        precond = KFACPreconditioner(
            Tiny(), topology=PodTopology(ici_size=1, n_groups=1))
        assert precond.topology is not None
        assert precond.placement_plan is None
    elif set(GUARDS) & set(kwargs):
        from kfac_pytorch_tpu_torch import ConsistencyConfig
        from kfac_pytorch_tpu_torch import HealthConfig
        from kfac_pytorch_tpu_torch import WatchdogConfig

        (name,) = {'health', 'consistency', 'watchdog'} & set(kwargs)
        config = {'health': HealthConfig, 'consistency': ConsistencyConfig,
                  'watchdog': WatchdogConfig}[name]
        with pytest.raises(TypeError, match=config.__name__):
            KFACPreconditioner(Tiny(), **kwargs)
        precond = KFACPreconditioner(Tiny(), **{name: config()})
        assert all(bs.quarantined is not None
                   for bs in precond.buckets.values())
    else:
        with pytest.warns(UserWarning, match='factor_comm'):
            precond = KFACPreconditioner(Tiny(), **kwargs)
        assert precond.factor_comm is None


def test_colocate_factors_required_for_prediv():
    with pytest.raises(ValueError, match='colocate_factors'):
        KFACPreconditioner(Tiny(), colocate_factors=False)
