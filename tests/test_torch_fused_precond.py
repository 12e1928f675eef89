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

from test_torch_threads import one_torch_thread  # noqa: E402,F401

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


#: The six ResNet-32 bucket shapes (a576g64, a320g64, a320g32, a192g32,
#: a128g32, a32g32) at small L, for the CUDA kernel's arithmetic.
BUCKET_SHAPES = [
    (2, 64, 576), (1, 64, 320), (2, 32, 320), (2, 32, 192), (1, 32, 128),
    (1, 32, 32),
]


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by the ``cvt.rna.tf32.f32`` rule: keep 10 mantissa
    bits, round to nearest with ties away from zero (add half of the
    dropped 13 bits to the magnitude, then drop them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value an MMA reads from an f32 register: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel's tensor cores form it from f32 operands:
    ``hi`` is ``x`` rounded to TF32, ``lo = x - hi`` (exact in f32, read
    by the MMA truncated to TF32), then ``lo·hi + hi·lo + hi·hi`` in
    f32."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_trunc(a - a_hi), _tf32_trunc(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _kernel_arithmetic(g, qa, qg, dgda):
    """The CUDA kernel's chain, reassociated as it runs:
    ``v1 = qg^T (g qa)``, ``pg = qg (v2 qa^T)``, every product 3xTF32."""
    v1 = _mm_3xtf32(qg.mT, _mm_3xtf32(g, qa))
    v2 = v1 * dgda
    clip = torch.sum(v1 * v2, dim=(1, 2))
    pg = _mm_3xtf32(qg, _mm_3xtf32(v2, qa.mT))
    return pg, clip


def test_tf32_rounding_rules():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    np.testing.assert_array_equal(
        _tf32_rna(x).numpy(),
        np.array([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10),
                  1.0, 3.0], dtype=np.float32),
    )
    np.testing.assert_array_equal(
        _tf32_trunc(x).numpy(),
        np.array([1.0, 1.0 + 2.0 ** -10, -1.0, 1.0, 3.0], dtype=np.float32),
    )


@pytest.mark.parametrize('L,gp,ap', BUCKET_SHAPES)
def test_kernel_arithmetic_matches_jax_kernel(L, gp, ap):
    # The CUDA kernel's numbers (3xTF32 split, reassociated chain) against
    # the Pallas kernel at the card's f32 gate, before any card run.
    arrays = rand_inputs(L, gp, ap, seed=7 * L + gp + ap)
    want_pg, want_clip = jax_fused(
        *[jnp.asarray(a) for a in arrays], interpret=True,
    )
    pg, clip = _kernel_arithmetic(*torch_args(arrays))
    np.testing.assert_allclose(
        pg.numpy(), np.asarray(want_pg), rtol=1e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        clip.numpy(), np.asarray(want_clip), rtol=1e-5,
    )
    # One TF32 product alone misses the gate at the widest contraction.
    if ap == 576:
        g, qa = torch_args(arrays)[:2]
        one = _tf32_rna(g) @ _tf32_rna(qa)
        exact = g.double() @ qa.double()
        assert float((one.double() - exact).abs().max()) > 1e-4


#: The wgmma route's constants (``csrc/fused_eigen_precond.cu``,
#: namespace ``wg``): tile rows, K per ring stage, stages per accumulation
#: chunk, the most K parts, a split's cost in stages, the H100's SMs.
WG_BM, WG_BK, WG_CHUNK, WG_MAX_SPLIT, WG_SPLIT_COST, WG_SMS = (
    128, 32, 4, 8, 13, 132)


def _wg_split(L, M, N, K, bn, sms=WG_SMS):
    """``plan_pass``'s K split: only where the tiles fill at most half the
    SMs, the least-cost S (each part at least one chunk deep) of
    ``waves(S) * stages per part + split cost``, if under three quarters
    of the unsplit stages."""
    tiles = L * -(-M // WG_BM) * -(-N // bn)
    nk = -(-K // WG_BK)
    most = max(1, min(WG_MAX_SPLIT, nk // WG_CHUNK)) if 2 * tiles <= sms else 1
    best, split = nk, 1
    for s in range(2, most + 1):
        cost = -(-tiles * s // sms) * -(-nk // s) + WG_SPLIT_COST
        if cost < best:
            best, split = cost, s
    return split if 4 * best <= 3 * nk else 1


def _wg_mm(a, b, split, exact_a=False, exact_b=False):
    """``a @ b`` ([L, M, K] by [L, K, N]) as a wgmma pass forms it: hi and
    lo both truncated to TF32 (``hi = trunc(x)``, ``lo = trunc(x - hi)``;
    a bf16 value is its own hi), K in ``split`` parts of whole 32-deep
    stages, each part in 128-deep chunks of ``lo*hi + hi*lo + hi*hi``
    summed in order, the parts summed in part order."""
    K = a.shape[-1]
    nk = -(-K // WG_BK)
    a_hi = a if exact_a else _tf32_trunc(a)
    b_hi = b if exact_b else _tf32_trunc(b)
    a_lo = _tf32_trunc(a - a_hi)
    b_lo = _tf32_trunc(b - b_hi)
    out = None
    for s in range(split):
        k0 = s * nk // split * WG_BK
        k1 = min((s + 1) * nk // split * WG_BK, K)
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
        for c0 in range(k0, k1, WG_CHUNK * WG_BK):
            ks = slice(c0, min(c0 + WG_CHUNK * WG_BK, k1))
            chunk = a_hi[..., ks] @ b_hi[..., ks, :]
            if not exact_a:
                chunk = a_lo[..., ks] @ b_hi[..., ks, :] + chunk
            if not exact_b:
                chunk = a_hi[..., ks] @ b_lo[..., ks, :] + chunk
            acc = acc + chunk
        out = acc if out is None else out + acc
    return out


def _wide_arithmetic(g, qa, qg, dgda):
    """The wgmma route's chain (gp > 64, f32 operands) as it runs:
    ``W^T = qa^T g^T``, ``v1 = qg^T W``, ``Y = v2 qa^T``, ``pg = qg Y``,
    each pass split and chunked as above, and the clip term summed per
    128 x BN tile, the tiles in order."""
    L, gp, ap = g.shape
    bn = 32 if ap <= 64 else 128
    wt = _wg_mm(qa.mT, g.mT, _wg_split(L, ap, gp, ap, 128))
    v1 = _wg_mm(qg.mT, wt.mT, _wg_split(L, gp, ap, gp, bn))
    v2 = v1 * dgda
    prod = v1 * v2
    clip = torch.zeros(L)
    for m0 in range(0, gp, WG_BM):
        for n0 in range(0, ap, bn):
            clip = clip + prod[:, m0:m0 + WG_BM, n0:n0 + bn].sum(dim=(1, 2))
    y = _wg_mm(v2, qa.mT, _wg_split(L, gp, ap, ap, bn))
    pg = _wg_mm(qg, y, _wg_split(L, gp, ap, gp, bn))
    return pg, clip


@pytest.mark.parametrize('shape,split', [
    # P1 of the card tests' split-K case and of ResNet-50's a1152g128
    # and a1024g512 (few tiles, long K); none at a512g1024's 16 stages,
    # a second partial wave of 136 tiles (a2176g1024), BERT-large's
    # fc_out or where K is one stage deep.
    ((2, 1152, 128, 1152, 128), 6), ((4, 1152, 128, 1152, 128), 3),
    ((1, 1024, 512, 1024, 128), 4), ((1, 512, 1024, 512, 128), 1),
    ((1, 2176, 1024, 2176, 128), 1), ((24, 4224, 1024, 4224, 128), 1),
    ((1, 128, 32, 32, 32), 1),
])
def test_wgmma_split_rule(shape, split):
    assert _wg_split(*shape) == split


@pytest.mark.parametrize('L,gp,ap', [
    (2, 96, 160), (1, 128, 32), (3, 72, 136), (1, 96, 1152),
])
def test_wide_arithmetic_matches_jax_kernel(L, gp, ap):
    # The wgmma route's numbers (truncated 3xTF32 split, the P1-P4
    # reassociation, 128-deep chunks, split-K parts in order) against the
    # Pallas kernel at the card's f32 gate.
    arrays = rand_inputs(L, gp, ap, seed=11 * L + gp + ap)
    want_pg, want_clip = jax_fused(
        *[jnp.asarray(a) for a in arrays], interpret=True,
    )
    pg, clip = _wide_arithmetic(*torch_args(arrays))
    np.testing.assert_allclose(
        pg.numpy(), np.asarray(want_pg), rtol=1e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        clip.numpy(), np.asarray(want_clip), rtol=1e-5,
    )


@pytest.mark.parametrize('gp,ap,dtype,route', [
    (32, 32, torch.float32, 'pair'), (64, 576, torch.bfloat16, 'pair'),
    (65, 64, torch.float32, 'cp.async'), (128, 1152, torch.float32, 'wgmma'),
    (1024, 32, torch.bfloat16, 'wgmma'), (257, 769, torch.float32, 'cp.async'),
    (768, 3076, torch.float32, 'wgmma'), (768, 3076, torch.bfloat16, 'cp.async'),
])
def test_kernel_route_by_shape(gp, ap, dtype, route):
    # TMA takes rows of 16-byte multiples: gp and ap multiples of 4 (f32)
    # or 8 (bf16) above gp = 64; the fused pair below.
    from kfac_pytorch_tpu_torch.ops.fused_precond import kernel_route

    assert kernel_route(gp, ap, dtype) == route
