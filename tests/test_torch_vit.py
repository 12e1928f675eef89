"""The port's ViT and its K-FAC against the JAX package's.

* ``vit_tiny`` (32x32 images, 8x8 patches, 2 blocks, ``d_model`` 32,
  f32) logits against the Flax model from the same bridged weights, with
  mean and ``cls`` pooling, ``atol 1e-5``; the images are NHWC for Flax
  and the same array transposed to NCHW for the port.
* The invalid-pool error; the default registration of the patchify conv,
  the 8 Dense layers and the head (``tests/test_vit.py``'s count).
* A 3-step ``KFACPreconditioner`` trajectory against the JAX ``step``
  (batch 4, cross entropy, the hyperparameters and tolerances of
  ``tests/test_torch_dense_general.py``), with the default coverage and
  with full coverage (the 5 LayerNorms too).
"""
from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.models.vit import vit_tiny as jax_vit_tiny
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import vit_tiny

from test_torch_dense_general import check_trajectories
from test_torch_dense_general import jax_trajectory
from test_torch_dense_general import jax_xent
from test_torch_dense_general import port_trajectory
from test_torch_dense_general import port_xent
from test_torch_dense_general import STEPS
from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

#: label -> (keywords of both preconditioners, registered layers).
CONFIGS = {
    'default': (dict(), 10),
    'full': (dict(layer_types=('linear', 'conv2d', 'layernorm')), 15),
}


def batches():
    rng = np.random.default_rng(23)
    return [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=4).astype(np.int32))
            for _ in range(STEPS)]


def nchw(images):
    return torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1,
                                                                  2)))


def flax_init(pool):
    variables = fnn.meta.unbox(jax_vit_tiny(pool=pool).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    return jax.tree.map(np.asarray, variables)


def port_model(init, pool='mean'):
    model = vit_tiny(device='cpu', pool=pool)
    model.load_state_dict(flax_to_torch_state_dict(init), strict=True)
    return model.train()


@pytest.mark.parametrize('pool', ['mean', 'cls'])
def test_logits_match_flax(pool):
    init = flax_init(pool)
    images = batches()[0][0]
    want = jax_vit_tiny(pool=pool).apply(init, images)
    with torch.no_grad():
        got = port_model(init, pool)(nchw(images))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    names = {n for n, _ in port_model(init, pool).named_parameters()}
    assert ('cls' in names) == (pool == 'cls') and 'pos_embed' in names


def test_invalid_pool_rejected():
    with pytest.raises(ValueError, match='pool'):
        vit_tiny(device='cpu', pool='avg')


def test_registers_patchify_and_all_dense():
    cap = ModelCapture(vit_tiny(device='cpu'))
    names = set(cap.helpers)
    # 2 blocks x (qkv, proj, fc_in, fc_out) + patchify conv + head.
    assert len(names) == 10, sorted(names)
    assert {'patchify', 'head', 'block_0.qkv', 'block_1.fc_out'} <= names


def test_factory_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the factory builds there')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        vit_tiny()


@pytest.mark.parametrize('label', list(CONFIGS))
def test_trajectory_matches_jax(label):
    kw, n_layers = CONFIGS[label]
    init = flax_init('mean')
    data = batches()
    jax_trace = jax_trajectory(
        jax_vit_tiny(), init, [((x,), (y,)) for x, y in data], jax_xent, kw)

    def loss_of(model, step):
        x, y = data[step]
        return port_xent(model(nchw(x)), torch.from_numpy(y))

    port_trace = port_trajectory(port_model(init), jax_trace, loss_of, kw)
    check_trajectories(jax_trace, port_trace, n_layers)
