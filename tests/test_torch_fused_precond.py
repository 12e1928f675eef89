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


def _wg_split(L, M, N, K, bn, sms=WG_SMS, bm=WG_BM, bk=WG_BK):
    """``plan_pass``'s K split of ``bm x bn`` tiles and ``bk``-deep
    stages: only where the tiles fill at most half the SMs, the
    least-cost S (each part at least 128 deep) of ``waves(S) * stages
    per part + split cost``, if under three quarters of the unsplit
    stages."""
    tiles = L * -(-M // bm) * -(-N // bn)
    nk = -(-K // bk)
    most = max(1, min(WG_MAX_SPLIT, nk // (128 // bk))) if 2 * tiles <= sms else 1
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


#: The bf16 wgmma route's tiles (namespace ``wgb``): K per ring stage,
#: columns (64 where ``ap <= 64``), and the rows of the three-plane
#: passes (P2, P4).
WGB_BK, WGB_BN, WGB_BM_PLANES = 64, 128, 128


def _wgb_single_bm(L, gp, ap, sms=WG_SMS):
    """``wgb::chain_of``'s tile rows for the single-plane passes (P1, P3):
    256 where 256 x 128 tiles fill a wave of the SMs, else 128."""
    return 256 if L * -(-gp // 256) * -(-ap // WGB_BN) >= sms else 128


def _wgb_bn(ap):
    """``wgb::chain_of``'s tile columns: 64 where ``ap <= 64``."""
    return 64 if ap <= 64 else WGB_BN


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest, ties to even), back in f32."""
    return x.to(torch.bfloat16).float()


def _split3(x: torch.Tensor) -> list[torch.Tensor]:
    """The three bf16 planes the kernel writes for an f32 ``x``: each the
    rest of ``x`` after the ones before it, rounded to bf16."""
    planes = []
    for _ in range(3):
        planes.append(_bf16_round(x))
        x = x - planes[-1]
    return planes


def _wgb_mm(a_planes, b_planes, split):
    """``sum_q a_q @ b_q`` ([L, M, K] by [L, K, N], bf16 values in f32)
    as a bf16 wgmma pass forms it: every product of two bf16 values
    exact, K in ``split`` parts of whole 64-deep stages, each part one
    f32 sum, the parts summed in part order."""
    K = a_planes[0].shape[-1]
    nk = -(-K // WGB_BK)
    pairs = list(zip(a_planes * len(b_planes) if len(a_planes) == 1
                     else a_planes,
                     b_planes * len(a_planes) if len(b_planes) == 1
                     else b_planes))
    out = None
    for s in range(split):
        ks = slice(s * nk // split * WGB_BK,
                   min((s + 1) * nk // split * WGB_BK, K))
        acc = sum(a[..., ks] @ b[..., ks, :] for a, b in pairs)
        out = acc if out is None else out + acc
    return out


def _wgb_arithmetic(g, qa, qg, dgda):
    """The bf16 wgmma route's chain (gp > 64, bf16 operands) as it runs:
    the order chosen by shape (``kernel_order``), the f32 intermediate
    of P1 and P3 as three bf16 planes, ``v2`` a bf16 plane, each pass's
    K split by the split rule, the clip term summed per 128 x 128 tile
    of P2, the tiles in order."""
    from kfac_pytorch_tpu_torch.ops.fused_precond import kernel_order

    g, qa, qg, dgda = (t.float() for t in (g, qa, qg, dgda))
    L, gp, ap = g.shape
    gfirst = kernel_order(gp, ap, torch.bfloat16) == 'g.qa'
    k13, k24 = (ap, gp) if gfirst else (gp, ap)

    bn = _wgb_bn(ap)

    def split(K, bm):
        return _wg_split(L, gp, ap, K, bn, bm=bm, bk=WGB_BK)

    s1 = split(k13, _wgb_single_bm(L, gp, ap))
    s2 = split(k24, WGB_BM_PLANES)
    if gfirst:
        x = _split3(_wgb_mm([g], [qa], s1))
        v1 = _wgb_mm([qg.mT], x, s2)
    else:
        x = _split3(_wgb_mm([qg.mT], [g], s1))
        v1 = _wgb_mm(x, [qa], s2)
    v2 = v1 * dgda
    prod = v1 * v2
    clip = torch.zeros(L)
    for m0 in range(0, gp, WGB_BM_PLANES):
        for n0 in range(0, ap, bn):
            clip = clip + prod[:, m0:m0 + WGB_BM_PLANES,
                               n0:n0 + bn].sum(dim=(1, 2))
    v2 = _bf16_round(v2)
    if gfirst:
        x = _split3(_wgb_mm([v2], [qa.mT], s1))
        pg = _wgb_mm([qg], x, s2)
    else:
        x = _split3(_wgb_mm([qg], [v2], s1))
        pg = _wgb_mm(x, [qa.mT], s2)
    return pg, clip


def test_split3_is_exact():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(
        (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096))
        .astype(np.float32))
    hi, mid, lo = _split3(x)
    for part in (hi, mid, lo):
        assert torch.equal(part, _bf16_round(part))
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())


@pytest.mark.parametrize('L,gp,ap', [
    (2, 96, 160), (2, 160, 96), (1, 128, 1152), (1, 1152, 128),
    (3, 256, 64),
])
def test_bf16_wgmma_arithmetic_matches_jax_kernel(L, gp, ap):
    # The bf16 wgmma route's numbers (the order by shape, three bf16
    # planes of each f32 intermediate, the bf16 v2 plane, split-K parts
    # in order) against the Pallas kernel on bf16 operands, at the
    # card's bf16 gate: mean relative error 1e-3 against plain bf16.
    arrays = rand_inputs(L, gp, ap, seed=13 * L + gp + ap)
    want_pg, want_clip = jax_fused(
        *[jnp.asarray(a, jnp.bfloat16) for a in arrays], interpret=True,
    )
    want_pg = torch.from_numpy(np.array(want_pg, dtype=np.float32))
    pg, clip = _wgb_arithmetic(*torch_args(arrays, torch.bfloat16))
    err = float((pg - want_pg).abs().mean() / want_pg.abs().mean())
    assert err < 1e-3
    np.testing.assert_allclose(
        clip.numpy(), np.asarray(want_clip), rtol=1e-3,
    )
    # The plain bf16 chain (f32 products of the widened operands) within
    # the same gate.
    plain, _ = fused_eigen_precondition_reference(
        *torch_args(arrays, torch.bfloat16))
    assert float((pg - plain).abs().mean() / plain.abs().mean()) < 1e-3


@pytest.mark.parametrize('shape,bm,split', [
    # P1 of (1, 128, 2304) (one 128-row tile, 18 columns, 36 stages);
    # none at BERT-large's fc_out and fc_in, ResNet-50's a1152g128 or
    # a P2 at fc_out.
    ((1, 128, 2304, 2304), 128, 6), ((24, 1024, 4224, 4224), 256, 1),
    ((24, 4096, 1152, 4096), 256, 1), ((4, 128, 1152, 1152), 128, 1),
    ((24, 1024, 4224, 1024), WGB_BM_PLANES, 1),
])
def test_bf16_wgmma_split_rule(shape, bm, split):
    L, M, N, K = shape
    assert _wg_split(L, M, N, K, WGB_BN, bm=bm, bk=WGB_BK) == split


@pytest.mark.parametrize('shape,bm', [
    # 256-row tiles where they fill the 132 SMs: BERT-large's fc_out
    # (3168 tiles) and fc_in, GPT-125M's fc_out (12 x 3 x 25); 128 rows
    # at ResNet-50's a1152g128 (36 tiles) and a2176g1024 (68).
    ((24, 1024, 4224), 256), ((24, 4096, 1152), 256), ((12, 768, 3200), 256),
    ((4, 128, 1152), 128), ((1, 1024, 2176), 128), ((1, 128, 2304), 128),
])
def test_bf16_single_pass_tile_rows(shape, bm):
    assert _wgb_single_bm(*shape) == bm


@pytest.mark.parametrize('ap,bn', [(32, 64), (64, 64), (72, 128), (4224, 128)])
def test_bf16_tile_columns(ap, bn):
    # 64-wide tiles where 128-wide ones would be half or more masked.
    assert _wgb_bn(ap) == bn


@pytest.mark.parametrize('gp,ap,dtype,order', [
    (1024, 4224, torch.bfloat16, 'g.qa'), (4096, 1152, torch.bfloat16, 'qgT.g'),
    (1024, 4224, torch.float32, 'g.qa'), (4096, 1152, torch.float32, 'g.qa'),
    (1152, 1152, torch.bfloat16, 'g.qa'), (1024, 32, torch.bfloat16, 'qgT.g'),
    (64, 32, torch.bfloat16, 'g.qa'), (768, 3076, torch.bfloat16, 'g.qa'),
    (3073, 768, torch.bfloat16, 'g.qa'),
])
def test_kernel_order_by_shape(gp, ap, dtype, order):
    # The bf16 wgmma route (gp > 64, rows of 16-byte multiples) forms
    # qg^T g first where gp > ap; every other call g qa.
    from kfac_pytorch_tpu_torch.ops.fused_precond import kernel_order

    assert kernel_order(gp, ap, dtype) == order


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke_bound', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('shape,bound_ms', [
    ((24, 1024, 4224), 3.07), ((24, 4096, 1152), 3.46),
])
def test_bf16_bound(shape, bound_ms):
    # bf16 x bf16 products (the larger contraction of each half) at the
    # bf16 rate, bf16 x f32 ones at three bf16 products each (cheaper
    # than two TF32 products); f32 calls keep their bound.
    cs = _chip_smoke()
    assert round(cs.precond_bound(*shape, 2)[0], 2) == bound_ms
    assert cs.precond_bound(*shape, 2)[2] > cs.precond_bound(*shape, 2)[1]


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
