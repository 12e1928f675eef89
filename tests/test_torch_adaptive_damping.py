"""The fused training path and Levenberg–Marquardt damping against the
JAX package, on the CPU.

* ``AdaptiveDamping``: the controller against JAX's on the same
  ``(observed, predicted)`` sequences, exactly; its validation, cadence
  and ``repr``.
* ``last_step_info['vg_sum']`` against JAX's within ``1e-5`` relative on
  a model with unregistered BatchNorms (a 3x3 stem, one ResNet
  bottleneck, a dense head: ``tests/test_torch_accumulation.py``'s
  ``BottleNet``), and against the direct sum over the parameters of
  ``<raw grad, final grad>``; ``ekfac_divergence`` rides factor steps
  only.
* ``make_train_step`` against JAX's (``optax.sgd(lr, momentum=0.9)``
  against ``torch.optim.SGD(lr, momentum=0.9)``, the same
  ``AdaptiveDamping``): losses, the damping sequence and ``rho`` within
  ``1e-5``; ``train_loop`` bitwise ``make_train_step``; the predicted
  reduction takes the ``lr`` of the step that made the update.
* The loss-only forward leaves BatchNorm's buffers and the capture as a
  step without it leaves them, bit for bit; ``step()`` warns once that
  it does not feed the controller; ``LambdaParamScheduler`` rejects it;
  ``merge_updates`` and accumulation raise.
* Two gloo ranks (subprocesses of this file) with different local
  batches keep the same damping: the losses are averaged before the
  controller sees them.
"""
from __future__ import annotations

import datetime
import logging
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch import KFACPreconditioner  # noqa: E402
from kfac_pytorch_tpu_torch import LambdaParamScheduler  # noqa: E402
from kfac_pytorch_tpu_torch.adaptive import AdaptiveDamping  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

LR = 0.1
HP = dict(factor_update_steps=1, inv_update_steps=2, kl_clip=0.001, lr=LR)
STEPS = 6
REL = 1e-5
SPAWN_TIMEOUT_S = 120


def batches(steps=STEPS, rows=8):
    rng = np.random.default_rng(5)
    return [(rng.standard_normal((rows, 12, 12, 3)).astype(np.float32),
             rng.integers(0, 10, size=(rows,))) for _ in range(steps)]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def port_xent(out, y):
    return F.cross_entropy(out, y)


class BottleNet(torch.nn.Module):
    """``tests/test_torch_accumulation.py``'s ``BottleNet`` (that module
    imports JAX, which the ranks must not): a 3x3 stem, one
    ``Bottleneck(planes=4, stride=2)``, mean pool and a dense head."""

    def __init__(self) -> None:
        from kfac_pytorch_tpu_torch.models import Bottleneck
        from kfac_pytorch_tpu_torch.models.layers import Conv2d

        super().__init__()
        self.conv1 = Conv2d(3, 16, 3, padding=1)
        self.block = Bottleneck(16, 4, stride=2)
        self.fc = torch.nn.Linear(16, 10)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.block(self.conv1(x)).mean(dim=(2, 3)))


def bottlenet(variables=None):
    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    model = BottleNet()
    if variables is not None:
        model.load_state_dict(flax_to_torch_state_dict(variables),
                              strict=True)
    return model.train()


# -- the controller ----------------------------------------------------------


SEQUENCE = [(-0.5, -0.5), (-0.01, -1.0), (-0.5, -1.0), (float('nan'), -1.0),
            (-1.0, 0.0), (-1.0, 2.0), (-0.9, -1.0), (0.3, -1.0),
            (-1e-3, -1e-3), (float('inf'), -1.0), (-2.0, -1.0)]


@pytest.mark.parametrize('kw', [
    dict(), dict(interval=3), dict(interval=1, decay=0.5),
    dict(initial=0.2, decay=0.1, max_damping=0.3, min_damping=0.15),
    dict(lower=0.1, upper=0.9),
], ids=['default', 'interval3', 'decay', 'clamped', 'band'])
def test_controller_matches_jax_exactly(kw):
    from kfac_pytorch_tpu.adaptive import AdaptiveDamping as JaxDamping

    got, want = AdaptiveDamping(**kw), JaxDamping(**kw)
    assert repr(got) == repr(want)
    assert [got.should_adapt(s) for s in range(12)] == [
        want.should_adapt(s) for s in range(12)]
    for observed, predicted in SEQUENCE:
        assert got.update(observed, predicted) == want.update(observed,
                                                              predicted)
        assert got.damping == want.damping and got(7) == want(7)
        assert (got.rho is None) == (want.rho is None)
        assert got.rho == want.rho or got.rho is None
        assert repr(got) == repr(want)


@pytest.mark.parametrize('kw', [
    dict(interval=0), dict(decay=1.0), dict(decay=0.0),
    dict(initial=0.0), dict(initial=20.0), dict(min_damping=0.01),
])
def test_controller_validation_matches_jax(kw):
    from kfac_pytorch_tpu.adaptive import AdaptiveDamping as JaxDamping

    with pytest.raises(ValueError) as want:
        JaxDamping(**kw)
    with pytest.raises(ValueError) as got:
        AdaptiveDamping(**kw)
    assert str(got.value) == str(want.value)


# -- vg_sum ------------------------------------------------------------------


@pytest.fixture(scope='module')
def variables():
    from test_torch_accumulation import init_variables
    return init_variables('bottleneck')


def jax_precond(damping, **kw):
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from test_torch_accumulation import JaxBottleNet, jax_xent

    return JaxPreconditioner(
        JaxBottleNet(), loss_fn=jax_xent,
        apply_kwargs={'train': True, 'mutable': ['batch_stats']},
        damping=damping, **dict(HP, **kw))


def test_vg_sum_matches_jax_and_the_direct_sum(variables):
    """Each step from JAX's weights (the port applies JAX's gradients):
    ``vg_sum`` within ``1e-5`` of JAX's, and equal to the direct sum of
    ``<raw grad, final grad>`` over every parameter (the BatchNorm
    parameters, which K-FAC does not register, as ``|g|^2``)."""
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict

    data = batches(4)
    jp = jax_precond(0.003)
    state = jp.init(variables, data[0][0])
    params = variables['params']
    others = {k: v for k, v in variables.items() if k != 'params'}
    model = bottlenet(variables)
    precond = KFACPreconditioner(model, damping=0.003, **HP)
    assert precond.coverage_report()['uncovered']  # the BatchNorms
    for x, y in data:
        _, aux, grads, state = jp.step({'params': params, **others}, state,
                                       x, loss_args=(jnp.asarray(y),))
        want = float(jp.last_step_info['vg_sum'])
        grads = jax.tree.map(np.asarray, grads)
        params = jax.tree.map(lambda w, g: w - LR * g, params, grads)
        others = jax.tree.map(np.asarray, dict(aux))
        model.zero_grad()
        F.cross_entropy(model(nchw(x)), torch.from_numpy(y)).backward()
        raw = {n: p.grad.clone() for n, p in model.named_parameters()}
        precond.step()
        info = precond.last_step_info
        assert set(info) == {'vg_sum'}
        got = info['vg_sum']
        assert got.dtype == torch.float32 and got.ndim == 0
        direct = sum(float(torch.sum(raw[n].double() * p.grad.double()))
                     for n, p in model.named_parameters())
        assert abs(float(got) - want) <= REL * abs(want)
        assert abs(float(got) - direct) <= REL * abs(direct)
        step_grads = flax_to_torch_state_dict({'params': grads})
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= LR * step_grads[n]


def test_step_info_carries_the_ekfac_divergence_on_factor_steps():
    from kfac_pytorch_tpu_torch.models import MLP

    torch.manual_seed(0)
    model = MLP(8, (16, 4))
    precond = KFACPreconditioner(model, ekfac=True, factor_update_steps=2,
                                 inv_update_steps=4)
    x, y = torch.randn(8, 8), torch.randn(8, 4)
    keys = []
    for _ in range(4):
        model.zero_grad()
        F.mse_loss(model(x), y).backward()
        precond.step()
        keys.append(sorted(precond.last_step_info))
    assert keys == [['ekfac_divergence', 'vg_sum'], ['vg_sum']] * 2
    assert precond.last_step_info['vg_sum'] > 0


def test_step_info_keys_match_jax_under_the_adaptive_cadence():
    """``stagger_refresh=2`` with the drift-adaptive cadence: each step's
    ``last_step_info`` has JAX's keys (the drift feed on factor steps,
    the controller's counters every step) and the same counters."""
    import jax
    import jax.numpy as jnp

    from kfac_pytorch_tpu.models.tiny import MLP as JaxMLP
    from kfac_pytorch_tpu.preconditioner import (
        KFACPreconditioner as JaxPreconditioner,
    )
    from kfac_pytorch_tpu.scheduler import AdaptiveRefreshConfig as JaxCfg
    from kfac_pytorch_tpu_torch import AdaptiveRefreshConfig
    from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
    from kfac_pytorch_tpu_torch.models import MLP

    hp = dict(factor_update_steps=2, inv_update_steps=4, stagger_refresh=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)
    jmodel = JaxMLP(features=(16, 4))
    variables = jax.tree.map(np.asarray,
                             jmodel.init(jax.random.PRNGKey(0), x))
    jp = JaxPreconditioner(jmodel, loss_fn=lambda o, t: jnp.mean((o - t) ** 2),
                           adaptive=JaxCfg(0.2), **hp)
    state = jp.init(variables, x)
    model = MLP(8, (16, 4))
    model.load_state_dict(flax_to_torch_state_dict(variables))
    p = KFACPreconditioner(model, adaptive=AdaptiveRefreshConfig(0.2), **hp)
    for _ in range(6):
        _, _, _, state = jp.step(variables, state, x,
                                 loss_args=(jnp.asarray(y),))
        model.zero_grad()
        F.mse_loss(model(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        p.step()
        want, got = jp.last_step_info, p.last_step_info
        assert set(got) == set(want)
        for k, v in want.items():
            if k.endswith(('_total', '/skipped', '/early', '/forced',
                           '/age')):
                assert got[k] == int(v), k


# -- the fused path against JAX's -------------------------------------------


def jax_fused(variables, data, interval, momentum=0.9, lr=LR):
    import jax
    import jax.numpy as jnp
    import optax

    from kfac_pytorch_tpu.adaptive import AdaptiveDamping as JaxDamping

    ad = JaxDamping(0.003, interval=interval)
    jp = jax_precond(ad, lr=lr)
    state = jp.init(variables, data[0][0])
    tx = optax.sgd(lr, momentum=momentum)
    step = jp.make_train_step(tx, merge_updates=lambda vs, aux: {**vs, **aux})
    vs = variables
    opt_state = tx.init(variables['params'])
    out = []
    for x, y in data:
        loss, _, vs, opt_state, state = step(vs, opt_state, state, x,
                                             loss_args=(jnp.asarray(y),))
        out.append(dict(loss=float(loss), damping=ad.damping, rho=ad.rho,
                        vg=float(jp.last_step_info['vg_sum'])))
    return out, jax.tree.map(np.asarray, vs)


def port_fused(variables, data, interval, loop=False, lr=LR):
    model = bottlenet(variables)
    ad = AdaptiveDamping(0.003, interval=interval)
    precond = KFACPreconditioner(model, damping=ad, **dict(HP, lr=lr))
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    if loop:
        step = precond.train_loop(opt, port_xent).step
    else:
        step = precond.make_train_step(opt, port_xent)
    out = []
    for x, y in data:
        loss, aux = step(nchw(x), loss_args=(torch.from_numpy(y),))
        assert aux is None
        out.append(dict(loss=float(loss), damping=ad.damping, rho=ad.rho,
                        vg=float(precond.last_step_info['vg_sum'])))
    return out, model, precond


def test_make_train_step_matches_jax(variables):
    """Losses, the damping sequence and ``rho`` within ``1e-5`` of JAX's
    fused step, an adaptation every second step."""
    data = batches()
    want, _ = jax_fused(variables, data, interval=2)
    got, _, _ = port_fused(variables, data, interval=2)
    # The first adaptation is at step 1; rho holds until the next one.
    assert want[0]['rho'] is None and want[1]['rho'] is not None
    assert len({w['damping'] for w in want}) > 1  # the damping moved
    for step, (g, w) in enumerate(zip(got, want)):
        assert abs(g['loss'] - w['loss']) <= REL * abs(w['loss']), step
        assert abs(g['damping'] - w['damping']) <= REL * w['damping'], step
        assert abs(g['vg'] - w['vg']) <= REL * abs(w['vg']), step
        assert (g['rho'] is None) == (w['rho'] is None), step
        if w['rho'] is not None:
            assert abs(g['rho'] - w['rho']) <= REL * abs(w['rho']), step


def test_train_loop_is_bitwise_make_train_step(variables):
    data = batches()
    a, model_a, pa = port_fused(variables, data, interval=2)
    b, model_b, pb = port_fused(variables, data, interval=2, loop=True)
    assert a == b
    for (n, x), (_, y) in zip(model_a.state_dict().items(),
                              model_b.state_dict().items()):
        assert torch.equal(x, y), n
    opt = torch.optim.SGD(model_b.parameters(), lr=LR)
    model_sd, opt_sd, kfac_sd = pb.train_loop(opt, port_xent).carry
    assert set(model_sd) == set(model_b.state_dict())
    assert 'param_groups' in opt_sd and kfac_sd['steps'] == STEPS


def test_loss_only_forward_leaves_batchnorm_and_capture_untouched(
        variables):
    """An adapting step (interval 1) against the same step with a fixed
    damping: parameters, BatchNorm running statistics and counters bit
    for bit equal, and the capture holds nothing and stays armed for the
    next forward."""
    x, y = batches(1)[0]
    runs = []
    for damping in (AdaptiveDamping(0.003, interval=1), 0.003):
        model = bottlenet(variables)
        precond = KFACPreconditioner(model, damping=damping, **HP)
        opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
        precond.make_train_step(opt, port_xent)(
            nchw(x), loss_args=(torch.from_numpy(y),))
        runs.append((model.state_dict(), precond))
    (adapted, pa), (plain, pp) = runs
    assert pa._adaptive_damping.rho is not None
    assert any('running_mean' in n for n in adapted)
    for n, t in plain.items():
        assert torch.equal(adapted[n], t), n
    assert not pa._capture.pending()
    assert pa._capture.armed == pp._capture.armed is True


def test_predicted_reduction_uses_the_steps_lr(variables):
    """An lr schedule that drops right after the adaptation step: the
    predicted reduction takes the lr of the step that made the update
    (JAX ``test_predicted_reduction_uses_pre_increment_lr``)."""
    seen = []

    class Recorder(AdaptiveDamping):
        def update(self, observed, predicted):
            seen.append((observed, predicted))
            return super().update(observed, predicted)

    x, y = batches(1)[0]
    model = bottlenet(variables)
    precond = KFACPreconditioner(
        model, damping=Recorder(0.01, interval=2),
        **dict(HP, lr=lambda s: 0.1 if s < 2 else 0.01))
    step = precond.make_train_step(
        torch.optim.SGD(model.parameters(), lr=0.1), port_xent)
    for _ in range(2):
        step(nchw(x), loss_args=(torch.from_numpy(y),))
    assert len(seen) == 1
    vg = float(precond.last_step_info['vg_sum'])
    assert seen[0][1] == pytest.approx((-0.1 + 0.5 * 0.01) * vg, rel=1e-6)


# -- the warning, the scheduler, validation --------------------------------


@pytest.mark.parametrize('accumulation', [1, 2], ids=['step', 'accum'])
def test_step_warns_once_that_the_controller_is_not_fed(caplog,
                                                        accumulation):
    from kfac_pytorch_tpu_torch.models import MLP

    model = MLP(8, (8, 4))
    precond = KFACPreconditioner(model, damping=AdaptiveDamping(0.003),
                                 accumulation_steps=accumulation)
    quiet = KFACPreconditioner(MLP(8, (8, 4)), damping=0.003)
    x, y = torch.randn(4, 8), torch.randn(4, 4)
    with caplog.at_level(logging.WARNING, 'kfac_pytorch_tpu_torch.engine'):
        for p, m in ((precond, model), (quiet, quiet._capture.model)):
            for _ in range(3):
                m.zero_grad()
                for _ in range(p.accumulation_steps):
                    F.mse_loss(m(x), y).backward()
                p.step()
    assert set(precond.last_step_info) == {'vg_sum'}
    msgs = [r.getMessage() for r in caplog.records
            if 'AdaptiveDamping' in r.getMessage()]
    assert len(msgs) == 1
    path = 'step()' if accumulation == 1 else 'accumulated step()'
    assert f'not auto-fed on the {path} path' in msgs[0]
    assert 'last_step_info["vg_sum"]' in msgs[0]


def test_scheduler_rejects_adaptive_damping():
    from kfac_pytorch_tpu_torch.models import MLP

    p = KFACPreconditioner(MLP(8, (8, 4)), damping=AdaptiveDamping(0.003))
    assert p.damping == 0.003
    with pytest.raises(ValueError, match='already a callable'):
        LambdaParamScheduler(p, damping_lambda=lambda step: 0.9)


def test_fused_path_validation():
    from kfac_pytorch_tpu_torch.models import MLP

    model = MLP(8, (8, 4))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    p = KFACPreconditioner(model)
    with pytest.raises(NotImplementedError, match='merge_updates'):
        p.make_train_step(opt, port_xent, merge_updates=lambda v, a: v)
    with pytest.raises(NotImplementedError, match='merge_updates'):
        p.train_loop(opt, port_xent, merge_updates=lambda v, a: v)
    acc = KFACPreconditioner(MLP(8, (8, 4)), accumulation_steps=2)
    step = acc.make_train_step(opt, port_xent)
    with pytest.raises(RuntimeError, match='accumulation_steps'):
        step(torch.randn(4, 8), loss_args=(torch.randn(4, 4),))
    with pytest.raises(RuntimeError, match='accumulation_steps'):
        acc.train_loop(opt, port_xent)


def test_loss_fn_aux_is_returned():
    from kfac_pytorch_tpu_torch.models import MLP

    torch.manual_seed(1)
    model = MLP(8, (8, 4))
    p = KFACPreconditioner(model)
    step = p.make_train_step(torch.optim.SGD(model.parameters(), lr=0.1),
                             lambda out, y: (F.mse_loss(out, y), out.shape))
    loss, aux = step(torch.randn(4, 8), loss_args=(torch.randn(4, 4),))
    assert aux == (4, 4) and not loss.requires_grad and p.steps == 1


# -- two gloo ranks -----------------------------------------------------------


WORLD = 2


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    torch.manual_seed(0)
    model = BottleNet().train()
    ddp = torch.nn.parallel.DistributedDataParallel(model)
    ad = AdaptiveDamping(0.003, interval=1)
    precond = KFACPreconditioner(ddp, damping=ad, **HP)
    step = precond.make_train_step(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9), port_xent)
    damping, rho, losses = [], [], []
    for x, y in batches(4, rows=8):
        lo = rank * 4
        loss, _ = step(nchw(x[lo:lo + 4]),
                       loss_args=(torch.from_numpy(y[lo:lo + 4]),))
        losses.append(float(loss))
        damping.append(ad.damping)
        rho.append(ad.rho)
    torch.save(dict(damping=damping, rho=rho, losses=losses,
                    params=[p.detach().clone() for p in model.parameters()]),
               out / f'rank{rank}.pt')
    dist.destroy_process_group()


def test_gloo_ranks_keep_the_same_damping(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, __file__, '--worker', str(rank), str(WORLD),
         str(tmp_path / 'pg_init'), str(tmp_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(WORLD)]
    deadline = time.time() + SPAWN_TIMEOUT_S
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.time()))[0]
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail('worker ranks timed out and were killed')
    bad = [(i, p.returncode, log[-3000:])
           for i, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    r0, r1 = (torch.load(tmp_path / f'rank{r}.pt') for r in range(WORLD))
    assert r0['losses'] != r1['losses']  # different local batches
    assert r0['damping'] == r1['damping'] and r0['rho'] == r1['rho']
    assert all(math.isfinite(r) for r in r0['rho'] if r is not None)
    assert len(set(r0['damping'])) > 1
    assert all(torch.equal(a, b) for a, b in zip(r0['params'],
                                                 r1['params']))


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
