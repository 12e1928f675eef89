"""The port's ImageNet ResNet-50 against the JAX package's, and the
bridge of its variables.

The full-width JAX ``resnet50`` (1000 classes) is initialized at 32x32,
which still reaches layer4 (1x1 there), and every BatchNorm's scale,
bias, running mean and variance are redrawn from a seeded numpy
generator (``bn3``'s scale starts at zero, which would leave each
block's residual branch out of the comparison).  Through
:func:`~kfac_pytorch_tpu_torch.convert.flax_to_torch_state_dict` the
port's ``resnet50`` loads them strictly; on the same numpy batch of 2
the logits agree within ``atol 1e-4`` in eval mode (f32 on both sides,
53 BatchNorms and 54 convolutions summing in different orders).  In
training mode every stage (stem, each bottleneck, head) is held at
``atol 1e-4`` on the JAX model's input to it, at batch 4 on 64x64 (see
the test for why not batch 2 on 32x32), and the updated running means
and variances at ``atol 1e-5``.  The bridge maps every variable (HWIO -> OIHW,
``[in, out]`` -> ``[out, in]``, scale/bias/mean/var -> weight/bias/
running_mean/running_var) and the module names and parameter count are
the JAX model's.  The model's own initialization and the geometry of
its layers are checked too.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.models.resnet import resnet50 as jax_resnet50
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import resnet50
from kfac_pytorch_tpu_torch.models import resnet101
from kfac_pytorch_tpu_torch.models import resnet152

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port


def _redraw_batchnorm(variables, rng):
    def walk(params, stats):
        for k, v in params.items():
            if 'scale' in v:
                n = v['scale'].shape[0]
                v['scale'] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                v['bias'] = (0.1 * rng.standard_normal(n)).astype(np.float32)
                stats[k]['mean'] = (0.1 * rng.standard_normal(n)
                                    ).astype(np.float32)
                stats[k]['var'] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            elif isinstance(v, dict) and 'kernel' not in v:
                walk(v, stats[k])
    walk(variables['params'], variables['batch_stats'])


@pytest.fixture(scope='module')
def bridged():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)  # NHWC
    model = jax_resnet50(num_classes=1000)
    variables = jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(8), x, train=True),
    )
    variables = jax.tree.map(np.array, variables)  # writable copies
    _redraw_batchnorm(variables, rng)
    port = resnet50(device='cpu')
    port.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    return model, variables, port, x, xt


def test_eval_logits_match_flax(bridged):
    model, variables, port, x, xt = bridged
    want = model.apply(variables, x, train=False)
    port.eval()
    with torch.no_grad():
        got = port(xt)
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_train_mode_matches_flax_stage_by_stage(bridged):
    """Training-mode BatchNorm, each stage on the JAX model's input to it:
    the stem (conv1, bn1), every bottleneck block, and the head on the
    JAX last block's output; then the updated running statistics.

    This runs at batch 4 on 64x64 (layer4 at 2x2, 16 values a channel).
    At batch 2 on 32x32 layer4's BatchNorms normalize 2 values a
    channel, ``d / sqrt(d^2 + eps)``, which amplifies f32 rounding up to
    ``1 / sqrt(eps)`` = 316-fold: two f32 implementations then disagree
    at O(0.1) in one block (measured), and compounded over the whole
    network at O(1) in the logits.
    """
    import torch.nn.functional as F

    model, variables, port, _, _ = bridged
    rng = np.random.default_rng(13)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    logits, st = model.apply(variables, x, train=True,
                             mutable=['batch_stats', 'intermediates'],
                             capture_intermediates=True)
    inter = st['intermediates']

    def nchw(a):
        return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())

    def out_of(name):
        return nchw(inter[name]['__call__'][0])

    port.train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    try:
        with torch.no_grad():
            got = port.bn1(port.conv1(nchw(x)))
            np.testing.assert_allclose(got.numpy(), out_of('bn1').numpy(),
                                       atol=1e-4, rtol=0)
            h = F.max_pool2d(F.relu(out_of('bn1')), 3, stride=2, padding=1)
            for name in port.block_names:
                want = out_of(name)
                got = getattr(port, name)(h)
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           atol=1e-4, rtol=0, err_msg=name)
                h = want
            got = port.fc(h.mean(dim=(2, 3)))
            np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                                       atol=1e-4, rtol=0)
        stats = flax_to_torch_state_dict(
            {'batch_stats': jax.tree.map(np.asarray, st['batch_stats'])})
        sd = port.state_dict()
        n = 0
        for key, value in stats.items():
            if key.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(sd[key].numpy(), value.numpy(),
                                           atol=1e-5, rtol=0, err_msg=key)
                n += 1
            elif key.endswith('num_batches_tracked'):
                assert int(sd[key]) == 1, key
        assert n == 2 * 53
    finally:
        port.load_state_dict(before)


def test_bridge_maps_every_variable(bridged):
    _, variables, port, _, _ = bridged
    sd = flax_to_torch_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    kernel = variables['params']['layer4_0']['conv2']['kernel']  # HWIO
    np.testing.assert_array_equal(sd['layer4_0.conv2.weight'].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    fc = variables['params']['fc']
    np.testing.assert_array_equal(sd['fc.weight'].numpy(), fc['kernel'].T)
    assert tuple(sd['fc.bias'].shape) == (1000,)
    n_jax = sum(v.size for v in jax.tree.leaves(variables['params']))
    assert n_jax == sum(p.numel() for p in port.parameters()) == 25557032


def test_registration_and_geometry():
    """54 K-FAC layers; the stem 7x7/2 pad 3, the 1x1 stride-2
    projection with no padding, the head's A factor 2049 (bias)."""
    model = resnet50(device='cpu')
    helpers = ModelCapture(model).helpers
    assert len(helpers) == 54
    stem = helpers['conv1']
    assert (stem.kernel_size, stem.strides, stem.padding) == (
        (7, 7), (2, 2), (3, 3))
    proj = helpers['layer2_0.downsample_conv']
    assert (proj.kernel_size, proj.strides, proj.padding) == (
        (1, 1), (2, 2), (0, 0))
    assert helpers['layer2_0.conv2'].strides == (2, 2)
    assert helpers['fc'].a_factor_shape[0] == 2049
    assert helpers['layer4_0.conv2'].a_factor_shape[0] == 4608


def test_init_is_seeded_and_zeroes_bn3():
    a, b = resnet50(device='cpu', seed=1), resnet50(device='cpu', seed=1)
    c = resnet50(device='cpu', seed=2)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    assert float(a.layer1_0.bn3.weight.abs().sum()) == 0.0
    assert float(a.layer1_0.bn1.weight.min()) == 1.0
    # lecun_normal: variance 1 / fan_in.
    w = a.layer3_0.conv2.weight
    assert abs(float(w.var()) * w[0].numel() - 1.0) < 0.05


@pytest.mark.parametrize('factory,blocks', [
    (resnet101, (3, 4, 23, 3)), (resnet152, (3, 8, 36, 3)),
])
def test_deeper_resnets_have_the_jax_block_counts(factory, blocks):
    model = factory(device='cpu', num_classes=10)
    for stage, n in enumerate(blocks, start=1):
        names = [b for b in model.block_names if b.startswith(f'layer{stage}_')]
        assert len(names) == n


def test_bf16_computes_in_bf16_with_f32_parameters():
    model = resnet50(device='cpu', num_classes=10, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = []
    model.layer1_0.conv2.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    out = model(torch.randn(2, 3, 32, 32))
    assert seen == [torch.bfloat16] and out.dtype == torch.float32


def test_factory_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resnet50()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_batchnorm_blends_the_biased_variance_in_one_op(dtype):
    """Training mode over two steps: the output and its gradients are
    torch's own layer's (atol 1e-6; bf16 output to its rounding), the
    running mean is its blend (atol 1e-6) and the running variance
    blends the biased batch variance (rtol 1e-6)."""
    from kfac_pytorch_tpu_torch.models.layers import BatchNorm2d

    rng = np.random.default_rng(5)
    ours, ref = BatchNorm2d(6, dtype), torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6)))
        ours.bias.copy_(torch.from_numpy(rng.standard_normal(6)))
    ref.load_state_dict(ours.state_dict())
    var = torch.ones(6)
    for _ in range(2):
        x = torch.from_numpy(
            rng.standard_normal((3, 6, 5, 4)).astype(np.float32) * 2 + 1)
        w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
        xo, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
        yo, yr = ours(xo), ref(xr)
        assert yo.dtype == dtype
        (yo.float() * w).sum().backward()
        (yr * w).sum().backward()
        if dtype == torch.float32:
            torch.testing.assert_close(yo, yr, atol=1e-6, rtol=0)
            torch.testing.assert_close(xo.grad, xr.grad, atol=1e-6, rtol=0)
        else:
            torch.testing.assert_close(yo, yr.to(dtype))
        torch.testing.assert_close(ours.running_mean, ref.running_mean,
                                   atol=1e-6, rtol=0)
        var = 0.9 * var + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
        torch.testing.assert_close(ours.running_var, var, rtol=1e-6, atol=0)
    assert int(ours.num_batches_tracked) == 2


def test_batchnorm_needs_two_values_per_channel_to_train():
    from kfac_pytorch_tpu_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(3)
    with pytest.raises(ValueError, match='more than 1 value per channel'):
        bn(torch.ones(1, 3, 1, 1))
    bn.eval()
    assert bn(torch.ones(1, 3, 1, 1)).shape == (1, 3, 1, 1)
