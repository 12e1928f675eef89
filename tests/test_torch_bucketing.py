"""Bucketing parity: the port's ``pad_dim`` and bucket plan against the
JAX package's.  Bucket keys, bucket order and slot order must be
identical (exact equality; the plan is integer/string logic)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest

from kfac_pytorch_tpu.capture import ModelCapture as JaxCapture
from kfac_pytorch_tpu.models import resnet20 as jax_resnet20
from kfac_pytorch_tpu.models import resnet32 as jax_resnet32
from kfac_pytorch_tpu.parallel import bucketing as jax_bucketing
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch.models import resnet20
from kfac_pytorch_tpu_torch.models import resnet32
from kfac_pytorch_tpu_torch.parallel import bucketing

pytestmark = pytest.mark.torch_port

#: ResNet-32's buckets, ``key: live slots`` (the JAX registration).
RESNET32_BUCKETS = {
    'a576g64': 9, 'a320g64': 1, 'a320g32': 9, 'a192g32': 11,
    'a128g32': 1, 'a32g32': 1,
}


def test_pad_dim_matches_jax():
    for n in range(1, 5001):
        assert bucketing.pad_dim(n) == jax_bucketing.pad_dim(n), n
    with pytest.raises(ValueError):
        bucketing.pad_dim(0)


def _jax_plan(factory):
    model = factory(num_classes=10)
    x = jnp.zeros((2, 32, 32, 3))
    variables = model.init(jax.random.PRNGKey(0), x, train=True)
    cap = JaxCapture(model)
    specs = cap.register(variables, x, train=True, mutable=['batch_stats'])
    helpers = {
        '/'.join(s.helper.path): s.helper for s in specs.values()
    }
    return jax_bucketing.make_bucket_plan(helpers, n_cols=1)


def _port_plan(factory):
    precond = KFACPreconditioner(factory(device='cpu'))
    return precond.plan


@pytest.mark.parametrize(
    'name,jax_factory,port_factory',
    [('resnet20', jax_resnet20, resnet20), ('resnet32', jax_resnet32,
                                             resnet32)],
)
def test_bucket_plan_matches_jax(name, jax_factory, port_factory):
    want = _jax_plan(jax_factory)
    got = _port_plan(port_factory)
    assert [b.key for b in got.buckets] == [b.key for b in want.buckets]
    for gb, wb in zip(got.buckets, want.buckets):
        # torch module names join with '.', Flax paths with '/'.
        slots = tuple(
            None if s is None else s.replace('.', '/') for s in gb.slots
        )
        assert slots == wb.slots, gb.key
        assert (gb.a_pad, gb.g_pad, gb.seg) == (wb.a_pad, wb.g_pad, wb.seg)
    if name == 'resnet32':
        assert {
            b.key: sum(s is not None for s in b.slots) for b in got.buckets
        } == RESNET32_BUCKETS
