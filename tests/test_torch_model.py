"""The weight bridge and the port's CIFAR ResNet against the Flax model.

Flax variables made from a fixed key are converted with
:func:`kfac_pytorch_tpu_torch.convert.flax_to_torch_state_dict` and
loaded strictly; logits on the same numpy batch must agree within
``atol 1e-4`` (f32 on both sides; the convolutions, batch statistics and
pooling sum in different orders over ~20 layers of O(1) activations).
In train mode the running BatchNorm statistics are not compared: Flax
updates them with the biased batch variance and torch with the unbiased
one.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.models import resnet20 as jax_resnet20
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import resnet20
from kfac_pytorch_tpu_torch.models import resnet32

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope='module')
def bridged():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)  # NHWC
    model = jax_resnet20(num_classes=10)
    variables = model.init(jax.random.PRNGKey(4), x, train=True)
    host = jax.tree.map(np.asarray, variables)
    return model, variables, flax_to_torch_state_dict(host), x


@pytest.mark.parametrize('train', [True, False])
def test_logits_match_flax(bridged, train):
    model, variables, state_dict, x = bridged
    port = resnet20(device='cpu')
    port.load_state_dict(state_dict, strict=True)
    if train:
        want, _ = model.apply(
            variables, x, train=True, mutable=['batch_stats'],
        )
        port.train()
    else:
        want = model.apply(variables, x, train=False)
        port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_bridge_layouts():
    rng = np.random.default_rng(0)
    conv = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)  # HWIO
    dense = rng.standard_normal((5, 7)).astype(np.float32)        # [in, out]
    sd = flax_to_torch_state_dict({
        'params': {
            'c': {'kernel': conv},
            'blk': {'d': {'kernel': dense, 'bias': np.arange(7.0)}},
            'bn': {'scale': np.ones(8), 'bias': np.zeros(8)},
        },
        'batch_stats': {'bn': {'mean': np.full(8, 2.0),
                               'var': np.full(8, 3.0)}},
    })
    assert torch.equal(sd['c.weight'],
                       torch.from_numpy(conv.transpose(3, 2, 0, 1).copy()))
    assert torch.equal(sd['blk.d.weight'], torch.from_numpy(dense.T.copy()))
    assert sd['blk.d.bias'].tolist() == list(np.arange(7.0))
    assert sd['bn.weight'].tolist() == [1.0] * 8
    assert sd['bn.running_mean'].tolist() == [2.0] * 8
    assert sd['bn.running_var'].tolist() == [3.0] * 8
    assert int(sd['bn.num_batches_tracked']) == 0


def test_model_shapes_and_seeded_init():
    a = resnet32(device='cpu', seed=7)
    b = resnet32(device='cpu', seed=7)
    c = resnet32(device='cpu', seed=8)
    assert torch.equal(a.conv1.weight, b.conv1.weight)
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    out = a(torch.zeros(2, 3, 32, 32))
    assert tuple(out.shape) == (2, 10)
    n_layers = sum(
        isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
        for m in a.modules()
    )
    assert n_layers == 32
    assert a.layer3_0.bn1.momentum == 0.1 and a.layer3_0.bn1.eps == 1e-5


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resnet20()
