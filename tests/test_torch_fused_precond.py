"""The fused eigen-preconditioning chain: the port's plain version against
the JAX package's Pallas kernel (interpret mode on the CPU), and the
wrapper's CPU dispatch.

Tolerances are ``tests/test_pallas.py``'s bar: ``rtol 1e-5, atol 1e-4``
on ``pg`` and ``rtol 1e-3`` on the kl-clip terms (sums of
``gp * ap`` products, where summation order alone moves the low
digits); bf16 operands against f32 within a mean relative
error of 0.05 (bf16 keeps 8 bits of mantissa).  The CUDA kernel itself
is held against this plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_kernel_cuda.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu.ops.pallas_precond import (
    fused_eigen_precondition as jax_fused,
)
from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition
from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition_reference

pytestmark = pytest.mark.torch_port

#: test_pallas.py's shapes, then the six ResNet-32 bucket shapes
#: (a576g64, a320g64, a320g32, a192g32, a128g32, a32g32) at small L.
SHAPES = [
    (1, 32, 32), (3, 64, 128), (5, 128, 256), (2, 64, 576),
    (3, 64, 576), (1, 64, 320), (2, 32, 320), (3, 32, 192), (1, 32, 128),
    (2, 32, 32),
]


def rand_inputs(L, gp, ap, seed=0):
    # Orthonormal q, as every eigenbasis is: with test_pallas.py's
    # Gaussian q the outputs reach O(1e4) and f32 summation order alone
    # (torch's CPU GEMM against XLA's) exceeds atol 1e-4.
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(L, gp, ap)).astype(np.float32)
    qa = np.linalg.qr(rng.normal(size=(L, ap, ap)))[0].astype(np.float32)
    qg = np.linalg.qr(rng.normal(size=(L, gp, gp)))[0].astype(np.float32)
    dgda = rng.uniform(0.1, 1.0, size=(L, gp, ap)).astype(np.float32)
    return g, qa, qg, dgda


def torch_args(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize('L,gp,ap', SHAPES)
def test_plain_matches_jax_kernel(L, gp, ap):
    arrays = rand_inputs(L, gp, ap, seed=L * gp + ap)
    want_pg, want_clip = jax_fused(
        *[jnp.asarray(a) for a in arrays], interpret=True,
    )
    pg, clip = fused_eigen_precondition_reference(*torch_args(arrays))
    assert pg.dtype == clip.dtype == torch.float32
    assert tuple(pg.shape) == (L, gp, ap) and tuple(clip.shape) == (L,)
    np.testing.assert_allclose(
        pg.numpy(), np.asarray(want_pg), rtol=1e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        clip.numpy(), np.asarray(want_clip), rtol=1e-3,
    )
    # clip[l] == <pg[l], g[l]>.
    inner = (pg * torch.from_numpy(arrays[0])).sum(dim=(1, 2))
    np.testing.assert_allclose(clip.numpy(), inner.numpy(), rtol=1e-3)


def test_bf16_operands_close_to_f32():
    arrays = rand_inputs(3, 64, 128, seed=5)
    out32, _ = fused_eigen_precondition_reference(*torch_args(arrays))
    out16, _ = fused_eigen_precondition_reference(
        *torch_args(arrays, torch.bfloat16),
    )
    assert out16.dtype == torch.float32
    err = (out16 - out32).abs().mean() / out32.abs().mean()
    assert float(err) < 0.05
    # The JAX kernel rounds v2 to bf16 at the same point: same outputs
    # up to f32 summation order.
    want, _ = jax_fused(
        *[jnp.asarray(a, jnp.bfloat16) for a in arrays], interpret=True,
    )
    np.testing.assert_allclose(
        out16.numpy(), np.asarray(want), rtol=1e-4, atol=1e-2,
    )


def test_orthonormal_identity_eigvals_is_identity():
    rng = np.random.default_rng(0)
    L, n = 2, 64
    q = torch.from_numpy(
        np.linalg.qr(rng.normal(size=(L, n, n)))[0].astype(np.float32),
    )
    g = torch.from_numpy(rng.normal(size=(L, n, n)).astype(np.float32))
    out, clip = fused_eigen_precondition(g, q, q, torch.ones(L, n, n))
    np.testing.assert_allclose(out.numpy(), g.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        clip.numpy(), (g * g).sum(dim=(1, 2)).numpy(), rtol=1e-4,
    )


def test_cpu_dispatch_runs_plain_version_uncounted():
    arrays = torch_args(rand_inputs(2, 32, 64, seed=3))
    fused_eigen_precondition.launches = 0
    pg, clip = fused_eigen_precondition(*arrays)
    want_pg, want_clip = fused_eigen_precondition_reference(*arrays)
    assert torch.equal(pg, want_pg) and torch.equal(clip, want_clip)
    assert fused_eigen_precondition.launches == 0


def test_rejects_mismatched_operands():
    g, qa, qg, dgda = torch_args(rand_inputs(2, 32, 64))
    with pytest.raises(ValueError, match='qa must have shape'):
        fused_eigen_precondition(g, qa[:, :32, :32], qg, dgda)
    with pytest.raises(TypeError, match='share'):
        fused_eigen_precondition(g, qa.double(), qg, dgda)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        fused_eigen_precondition(
            g.double(), qa.double(), qg.double(), dgda.double(),
        )
