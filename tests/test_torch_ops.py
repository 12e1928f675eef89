"""The port's K-FAC ops against ``kfac_pytorch_tpu.ops`` on the same
numpy inputs, in f32 on the CPU.

Tolerance: ``rtol 1e-5`` with ``atol 1e-6`` — both sides compute the
same f32 formulas and differ only in summation order (one or two ulps
per accumulation over at most a few hundred terms of O(1) values); the
``atol`` covers entries that cancel to near zero.  Eigenvectors are
never compared directly (they rotate within near-degenerate
eigenspaces): the decomposition is checked by orthonormality and by
reconstructing ``q diag(d) q^T``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import ops as jops
from kfac_pytorch_tpu_torch import ops

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64),
        rtol=rtol, atol=atol,
    )


@pytest.fixture
def rng():
    return np.random.default_rng(20)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def j(x):
    return jnp.asarray(x)


class TestCov:
    def test_append_bias_ones(self, rng):
        x = rng.standard_normal((5, 3)).astype(np.float32)
        close(ops.append_bias_ones(t(x)), jops.append_bias_ones(j(x)))

    @pytest.mark.parametrize('with_b', [False, True])
    def test_get_cov(self, rng, with_b):
        a = rng.standard_normal((40, 9)).astype(np.float32)
        b = rng.standard_normal((40, 9)).astype(np.float32)
        if with_b:
            close(ops.get_cov(t(a), t(b), scale=7.0),
                  jops.get_cov(j(a), j(b), scale=7.0))
        else:
            got = ops.get_cov(t(a))
            close(got, jops.get_cov(j(a)))
            assert torch.equal(got, got.T)

    def test_get_cov_bf16_accumulates_f32(self, rng):
        a = rng.standard_normal((64, 12)).astype(np.float32)
        got = ops.get_cov(t(a).to(torch.bfloat16))
        want = jops.get_cov(j(a).astype(jnp.bfloat16))
        assert got.dtype == torch.float32
        close(got, np.asarray(want, np.float32))

    def test_get_cov_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            ops.get_cov(torch.zeros(2, 3, 4))
        with pytest.raises(ValueError):
            ops.get_cov(torch.zeros(2, 3), torch.zeros(3, 3))

    @pytest.mark.parametrize('has_bias', [False, True])
    def test_linear_factors_and_rows(self, rng, has_bias):
        a = rng.standard_normal((6, 4, 10)).astype(np.float32)
        g = rng.standard_normal((6, 4, 7)).astype(np.float32)
        rows, norm = ops.linear_a_rows(t(a), has_bias)
        jrows, jnorm = jops.linear_a_rows(j(a), has_bias)
        close(rows, jrows)
        assert norm == jnorm
        close(ops.linear_a_factor(t(a), has_bias),
              jops.linear_a_factor(j(a), has_bias))
        close(ops.linear_g_factor(t(g)), jops.linear_g_factor(j(g)))
        close(ops.linear_g_rows(t(g))[0], jops.linear_g_rows(j(g))[0])

    @pytest.mark.parametrize(
        'k,s,p',
        [((3, 3), (1, 1), (1, 1)), ((3, 3), (2, 2), (1, 1)),
         ((1, 1), (2, 2), (0, 0)), ((2, 3), (1, 2), 'VALID')],
    )
    def test_extract_patches_nchw(self, rng, k, s, p):
        x = rng.standard_normal((2, 9, 9, 3)).astype(np.float32)  # NHWC
        want = jops.extract_patches(j(x), k, s, p)
        got = ops.extract_patches(t(x.transpose(0, 3, 1, 2)), k, s, p)
        assert tuple(got.shape) == tuple(want.shape)
        close(got, want)

    @pytest.mark.parametrize('has_bias', [False, True])
    def test_conv2d_factors_and_rows(self, rng, has_bias):
        x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)  # NHWC
        g = rng.standard_normal((3, 4, 4, 5)).astype(np.float32)
        xt = t(x.transpose(0, 3, 1, 2))
        gt = t(g.transpose(0, 3, 1, 2))
        geom = ((3, 3), (2, 2), (1, 1))
        rows, norm = ops.conv2d_a_rows(xt, *geom, has_bias=has_bias)
        jrows, jnorm = jops.conv2d_a_rows(j(x), *geom, has_bias=has_bias)
        close(rows, jrows)
        assert norm == jnorm == 16.0
        close(ops.conv2d_a_factor(xt, *geom, has_bias=has_bias),
              jops.conv2d_a_factor(j(x), *geom, has_bias=has_bias))
        grows, gnorm = ops.conv2d_g_rows(gt)
        jgrows, jgnorm = jops.conv2d_g_rows(j(g))
        close(grows, jgrows)
        assert gnorm == jgnorm
        close(ops.conv2d_g_factor(gt), jops.conv2d_g_factor(j(g)))
        close(ops.cov_from_rows(grows, 3.0), jops.cov_from_rows(jgrows, 3.0))


class TestUpdate:
    @pytest.mark.parametrize('first', [True, False])
    def test_ema_update_factor(self, rng, first):
        old = rng.standard_normal((6, 6)).astype(np.float32)
        new = rng.standard_normal((6, 6)).astype(np.float32)
        close(ops.ema_update_factor(t(old), t(new), 0.95, first),
              jops.ema_update_factor(j(old), j(new), 0.95, first))

    def test_grad_scale_sum(self, rng):
        pg = rng.standard_normal((5, 8)).astype(np.float32)
        g = rng.standard_normal((5, 8)).astype(np.float32)
        close(ops.grad_scale_sum(t(pg), t(g), 0.1),
              jops.grad_scale_sum(j(pg), j(g), 0.1))

    @pytest.mark.parametrize('terms', [[3.0, -1.0], [1e-6, 2e-6], [0.0]])
    def test_kl_clip_scale(self, terms):
        got = ops.kl_clip_scale([torch.tensor(v) for v in terms], 0.001)
        want = jops.kl_clip_scale([jnp.asarray(v) for v in terms], 0.001)
        close(got, want)

    def test_kl_clip_scale_empty_is_one(self):
        assert float(ops.kl_clip_scale([], 0.001)) == 1.0


class TestEigen:
    def _spd(self, rng, n, lead=()):
        r = rng.standard_normal(lead + (n + 3, n)).astype(np.float32)
        return np.swapaxes(r, -1, -2) @ r / (n + 3)

    @pytest.mark.parametrize('lead', [(), (3,)])
    def test_compute_factor_eigen(self, rng, lead):
        f = self._spd(rng, 12, lead)
        q, d = ops.compute_factor_eigen(t(f))
        eye = np.broadcast_to(np.eye(12), f.shape)
        close(q.mT @ q, eye, rtol=0, atol=1e-5)
        recon = q @ torch.diag_embed(d) @ q.mT
        close(recon, f, rtol=0, atol=1e-5)
        assert float(d.min()) >= 0.0
        if not lead:
            close(d, jops.compute_factor_eigen(j(f)).d, rtol=1e-5,
                  atol=1e-6)

    def test_eigenvalues_clamped(self):
        f = torch.diag(torch.tensor([-1.0, 0.5, 2.0]))
        _, d = ops.compute_factor_eigen(f)
        assert d.tolist() == [0.0, 0.5, 2.0]

    def test_compute_dgda(self, rng):
        dg = rng.uniform(0, 2, 5).astype(np.float32)
        da = rng.uniform(0, 2, 7).astype(np.float32)
        close(ops.compute_dgda(t(dg), t(da), 0.003),
              jops.compute_dgda(j(dg), j(da), 0.003))

    @pytest.mark.parametrize('prediv', [True, False])
    def test_precondition_grad_eigen(self, rng, prediv):
        A = self._spd(rng, 9)
        G = self._spd(rng, 6)
        grad = rng.standard_normal((6, 9)).astype(np.float32)
        # Same decomposition on both sides: only the rotation is tested.
        qa, da = jops.compute_factor_eigen(j(A))
        qg, dg = jops.compute_factor_eigen(j(G))
        kw = dict(damping=0.003)
        if prediv:
            dgda = jops.compute_dgda(dg, da, 0.003)
            want = jops.precondition_grad_eigen(j(grad), qa, qg,
                                                dgda=dgda, **kw)
            got = ops.precondition_grad_eigen(
                t(grad), t(np.asarray(qa)), t(np.asarray(qg)),
                dgda=t(np.asarray(dgda)), **kw,
            )
        else:
            want = jops.precondition_grad_eigen(j(grad), qa, qg, da=da,
                                                dg=dg, **kw)
            got = ops.precondition_grad_eigen(
                t(grad), t(np.asarray(qa)), t(np.asarray(qg)),
                da=t(np.asarray(da)), dg=t(np.asarray(dg)), **kw,
            )
        # Values reach 1/damping ~ 333: scale the absolute floor with it.
        close(got, want, rtol=1e-5, atol=1e-4)


def test_symmetric_eigh_shift_matches_plain_on_the_cpu(monkeypatch):
    """``ops.symmetric_eigh`` is ``torch.linalg.eigh`` bit for bit on CPU
    tensors (the JAX package's numerics).  Its CUDA path, run here on the
    CPU: sound decompositions stay the plain ones bit for bit; one that
    fails as cuSOLVER's does (an eigenvalue and its vector corrupted, as
    the card returned them for a near-identity factor) is caught by the
    float64 residual, counted, and redone shifted: the float64 spectrum
    within 1e-6 of its scale and the matrix rebuilt within 1e-5."""
    from kfac_pytorch_tpu_torch import tracing
    from kfac_pytorch_tpu_torch.ops import eigen

    rng = np.random.default_rng(0)
    r = rng.standard_normal((4, 48, 12))
    m = r @ r.transpose(0, 2, 1) / 12 + 1e-3 * np.eye(48)
    m[[0, 2]] = 0.7 * np.eye(48) + 1e-8 * m[[0, 2]]
    t = torch.tensor(m, dtype=torch.float32)
    d0, q0 = torch.linalg.eigh(t)
    d1, q1 = ops.symmetric_eigh(t)
    assert torch.equal(d0, d1) and torch.equal(q0, q1)
    d2, q2 = eigen._checked_eigh(t)
    assert torch.equal(d0, d2) and torch.equal(q0, q2)
    real = torch.linalg.eigh

    def failing(x):
        d, q = real(x)
        if x.shape[0] == 4:  # the plain call; the shifted redo is sound
            d, q = d.clone(), q.clone()
            d[2, -1] = 165.2
            q[2, :, -1] = 1.0 / 48 ** 0.5
        return d, q

    before = tracing.get_events().get('eigh_shifted_redo', 0)
    monkeypatch.setattr(torch.linalg, 'eigh', failing)
    d3, q3 = eigen._checked_eigh(t)
    monkeypatch.setattr(torch.linalg, 'eigh', real)
    assert tracing.get_events().get('eigh_shifted_redo', 0) == before + 1
    want = torch.linalg.eigvalsh(t.double())
    for i in range(4):
        if i == 2:
            scale = float(want[i].abs().max())
            assert float((d3[i].double() - want[i]).abs().max()) <= (
                1e-6 * scale)
            back = q3[i] @ torch.diag(d3[i]) @ q3[i].mT
            assert float((back - t[i]).abs().max()) <= 1e-5 * scale
        else:
            assert torch.equal(d3[i], d0[i]) and torch.equal(q3[i], q0[i])
