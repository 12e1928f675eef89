"""Randomized low-rank eigen preconditioning.

Port of ``kfac_pytorch_tpu/ops/lowrank.py``.  A large Kronecker factor
is summarized by its top ``k`` eigenpairs and the mean ``sigma`` of the
trailing spectrum, ``A ~ Q diag(d) Q^T + sigma (I - Q Q^T)``:

* :func:`randomized_eigh` finds the top ``k`` by randomized subspace
  iteration: a Gaussian sketch ``Y = A @ Omega``, a few QR power
  iterations, and an exact ``eigh`` of the small ``m x m`` projection
  (``O(n^2 m)`` matmuls and a QR of ``[n, m]`` instead of an ``O(n^3)``
  eigensolve);
* :func:`precondition_grad_lowrank` is the exact eigen preconditioner of
  that factor model, in thin ``[n, k]`` matmuls.

Randomness is explicit.  Every sketch comes from :func:`draw_sketch`,
which seeds a ``torch.Generator`` on the factor's device from the tuple
``(bucket seed, side, sketch step, slot)``.  The JAX package folds the
same tuple into a threefry key, so the two packages draw different
sketches by design; :func:`randomized_eigh` also takes a given
``sketch``, through which a caller can pass the JAX package's draw.

Products follow the port's ``precond_dtype`` convention: operands are
rounded to ``compute_dtype`` and multiplied in f32.  Float64 inputs stay
in float64 throughout (a reference evaluation of the same code).
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Sequence

import torch

from kfac_pytorch_tpu_torch.ops.eigen import symmetric_eigh


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in its own dtype if that is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class LowRankEigen(NamedTuple):
    """Truncated eigendecomposition of one Kronecker factor (or a stack).

    ``q``: ``[..., n, k]`` orthonormal top eigenvectors (``k == n``:
    exact).  ``d``: ``[..., k]`` eigenvalues, clamped ``>= 0``.
    ``sigma``: ``[...]`` mean of the trailing spectrum (0 when exact).
    """

    q: torch.Tensor
    d: torch.Tensor
    sigma: torch.Tensor


def draw_sketch(
    seed: int,
    side: int,
    step: int,
    slot: int,
    n: int,
    m: int,
    device: torch.device | str,
) -> torch.Tensor:
    """The Gaussian sketch ``Omega [n, m]`` (f32) of one factor side.

    ``seed`` is the bucket seed (``zlib.crc32`` of the bucket key),
    ``side`` 0 for A and 1 for G, ``step`` the inverse-update step and
    ``slot`` the slot's index in the whole bucket stack; a generator on
    ``device`` is seeded from the tuple, so a CUDA and a CPU draw of the
    same tuple differ.
    """
    digest = hashlib.blake2b(
        repr((int(seed), int(side), int(step), int(slot))).encode(),
        digest_size=8,
    ).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, 'little') & (2 ** 63 - 1))
    return torch.randn(n, m, generator=gen, device=device,
                       dtype=torch.float32)


def randomized_eigh(
    factor: torch.Tensor,
    k: int,
    *,
    oversample: int = 32,
    power_iters: int = 2,
    sketch: torch.Tensor | None = None,
    effective_dim: torch.Tensor | int | None = None,
) -> LowRankEigen:
    """Top ``k`` eigenpairs of a symmetric PSD factor, randomized.

    ``factor`` is ``[n, n]`` or a stack ``[L, n, n]``, with ``sketch``
    ``[n, m]`` or ``[L, n, m]`` (``m = k + oversample``; default: the
    draw of :func:`draw_sketch` for the tuple ``(0, 0, 0, slot)``).
    Falls back to an exact ``eigh`` when ``k + oversample >= n``.  All
    linear algebra runs in f32 (f64 for an f64 factor).
    ``effective_dim`` (scalar or ``[L]``) is the logical dimension when
    trailing rows and columns are zero
    padding: ``sigma`` averages the trailing spectrum over the real
    trailing dims only.
    """
    n = factor.shape[-1]
    a = _wide(factor)
    if k + oversample >= n:
        d, q = symmetric_eigh(a)
        return LowRankEigen(
            q=q, d=torch.clamp(d, min=0.0),
            sigma=a.new_zeros(a.shape[:-2]),
        )
    m = k + oversample
    if sketch is None:
        lead = a.shape[:-2]
        draws = [draw_sketch(0, 0, 0, i, n, m, a.device)
                 for i in range(lead.numel())]
        sketch = torch.stack(draws).reshape(*lead, n, m)
    omega = sketch.to(device=a.device, dtype=a.dtype)
    y = a @ omega
    for _ in range(power_iters):
        q = torch.linalg.qr(y).Q
        y = a @ q
    q = torch.linalg.qr(y).Q                        # [.., n, m]
    b = q.mT @ a @ q                                # [.., m, m]
    db, vb = torch.linalg.eigh((b + b.mT) / 2.0)    # ascending
    d = torch.clamp(db[..., -k:], min=0.0)          # top k
    qk = q @ vb[..., -k:]                           # [.., n, k]
    n_eff = torch.as_tensor(
        n if effective_dim is None else effective_dim, device=a.device,
    ).to(a.dtype)
    trace = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)
    sigma = torch.clamp(
        (trace - d.sum(-1)) / torch.clamp(n_eff - k, min=1.0), min=0.0,
    )
    return LowRankEigen(q=qk, d=d, sigma=sigma)


def _outer(dg: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    return dg[..., :, None] * da[..., None, :]


def precondition_grad_lowrank(
    grad: torch.Tensor,
    a: LowRankEigen | tuple,
    g: LowRankEigen | tuple,
    damping: float,
    *,
    lowrank_a: bool,
    lowrank_g: bool,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Exact eigen preconditioning under the truncated-spectrum model.

    ``grad`` is the combined ``[out, in(+1)]`` layout (G left, A right),
    or a stack of them with matching stacks of ``(q, d, sigma)``.  An
    exact side (``lowrank_*`` False: ``k == n``, ``sigma`` unused) takes
    the dense-basis block, so the ``I - Q Q^T ~ 0`` rounding residual is
    never amplified by ``1 / damping``.  With ``M[i, j] = 1 / (dg_i
    da_j + damping)`` and each side's trailing subspace carrying its
    scalar ``sigma``, the blocks are the JAX package's: (top, top)
    ``qg (M * C) qa^T`` with ``C = qg^T G qa``; (top-g, perp-a) and
    (perp-g, top-a) a per-index scale of the singly projected
    remainder; (perp, perp) one scalar times the doubly projected
    remainder.  Returns f32 (f64 for f64 operands).
    """
    qa, da, sa = a
    qg, dg, sg = g
    cdt = compute_dtype or grad.dtype

    def r(t: torch.Tensor) -> torch.Tensor:  # cdt operand, f32 product
        return _wide(t.to(cdt))

    lam = float(damping)
    gr = r(grad)
    qa_c, qg_c = r(qa), r(qg)
    da, dg = _wide(da), _wide(dg)
    m = 1.0 / (_outer(dg, da) + lam)

    if not lowrank_a and not lowrank_g:
        v1 = qg_c.mT @ gr @ qa_c
        return qg_c @ r(v1 * m) @ qa_c.mT

    if lowrank_a and not lowrank_g:
        # The complete G basis: no perp-g blocks.
        sa = _wide(torch.as_tensor(sa, device=grad.device))[..., None]
        v = qg_c.mT @ gr                                # [g, a]
        c = r(v) @ qa_c                                 # [g, ka]
        wg = 1.0 / (dg * sa + lam)                      # [g]
        inner = r(m * c) @ qa_c.mT + wg[..., :, None] * (
            v - r(c) @ qa_c.mT
        )
        return qg_c @ r(inner)

    if lowrank_g and not lowrank_a:
        sg = _wide(torch.as_tensor(sg, device=grad.device))[..., None]
        v = gr @ qa_c                                   # [g, a]
        c = qg_c.mT @ r(v)                              # [kg, a]
        wa = 1.0 / (sg * da + lam)                      # [a]
        inner = qg_c @ r(m * c) + (
            v - qg_c @ r(c)
        ) * wa[..., None, :]
        return r(inner) @ qa_c.mT

    # Both sides truncated.
    sa = _wide(torch.as_tensor(sa, device=grad.device))[..., None]
    sg = _wide(torch.as_tensor(sg, device=grad.device))[..., None]
    yg = qg_c.mT @ gr                                   # [kg, a]
    ya = gr @ qa_c                                      # [g, ka]
    c = r(yg) @ qa_c                                    # [kg, ka]
    wg = 1.0 / (dg * sa + lam)                          # [kg]
    wa = 1.0 / (sg * da + lam)                          # [ka]
    s4 = (1.0 / (sg * sa + lam))[..., None]             # [.., 1, 1]
    t1 = m * c - wg[..., :, None] * c - c * wa[..., None, :] + s4 * c
    left = wg[..., :, None] * yg - s4 * yg + r(t1) @ qa_c.mT   # [kg, a]
    right = ya * wa[..., None, :] - s4 * ya                    # [g, ka]
    return s4 * gr + qg_c @ r(left) + r(right) @ qa_c.mT


def lowrank_engages(dim: int, k: int | None, oversample: int) -> bool:
    """The one truncation rule: a side truncates only when it pays
    (``dim >= 2k``) and the sketch is strictly smaller than the factor
    (else :func:`randomized_eigh` falls back to an exact full-width
    basis, which would not fit the thin allocations)."""
    return k is not None and dim >= 2 * k and k + oversample < dim


def batched_randomized_eigh(
    stack: torch.Tensor,
    k: int,
    *,
    oversample: int,
    power_iters: int,
    seed: int,
    side: int,
    step: int,
    slots: Sequence[int] | None = None,
    effective_dims: Sequence[int] | torch.Tensor | None = None,
) -> LowRankEigen:
    """:func:`randomized_eigh` over an ``[L, n, n]`` stack.

    Item ``i`` draws its sketch for ``(seed, side, step, slots[i])``
    (:func:`draw_sketch`; ``slots`` default ``range(L)``): ``slots``
    are the items' indices in the whole bucket stack, so a rank that
    decomposes a share of it draws what a one-device run draws for the
    same slots.  ``effective_dims`` (``[L]``) gives logical dims when
    trailing rows are zero padding.
    """
    L, n = stack.shape[0], stack.shape[-1]
    slots = range(L) if slots is None else slots
    sketch = None
    if k + oversample < n:
        sketch = torch.stack([
            draw_sketch(seed, side, step, s, n, k + oversample,
                        stack.device)
            for s in slots
        ])
    dims = (
        torch.full((L,), n) if effective_dims is None
        else torch.as_tensor(effective_dims)
    )
    return randomized_eigh(
        stack, k, oversample=oversample, power_iters=power_iters,
        sketch=sketch, effective_dim=dims.to(stack.device),
    )


def decompose_stack(
    stack: torch.Tensor,
    lowrank: bool,
    k: int | None,
    *,
    oversample: int,
    power_iters: int,
    seed: int,
    side: int,
    step: int,
    slots: Sequence[int] | None = None,
    effective_dims: Sequence[int] | torch.Tensor | None = None,
) -> LowRankEigen:
    """Exact-or-truncated decomposition of an ``[L, n, n]`` stack:
    :func:`batched_randomized_eigh` when ``lowrank``, else a clamped
    exact ``eigh`` with zero ``sigma``."""
    if lowrank:
        return batched_randomized_eigh(
            stack, k, oversample=oversample, power_iters=power_iters,
            seed=seed, side=side, step=step, slots=slots,
            effective_dims=effective_dims,
        )
    d, q = symmetric_eigh(_wide(stack))
    return LowRankEigen(
        q=q, d=torch.clamp(d, min=0.0), sigma=d.new_zeros(stack.shape[:-2]),
    )


def thin_eigen_fields(
    lead: tuple,
    a_dim: int,
    g_dim: int,
    k: int | None,
    oversample: int,
    inv_dtype: torch.dtype,
    device: torch.device | str = 'cpu',
) -> dict | None:
    """Zeroed decomposition fields of one layer (``lead`` the stack
    prefix): thin ``qa/qg/da/dg`` and ``sa``/``sg`` when either side
    truncates, ``None`` when neither does (the caller keeps its dense
    layout)."""
    lr_a = lowrank_engages(a_dim, k, oversample)
    lr_g = lowrank_engages(g_dim, k, oversample)
    if not (lr_a or lr_g):
        return None
    ka = k if lr_a else a_dim
    kg = k if lr_g else g_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=inv_dtype, device=device)

    return dict(
        qa=zeros(*lead, a_dim, ka),
        qg=zeros(*lead, g_dim, kg),
        da=zeros(*lead, ka),
        dg=zeros(*lead, kg),
        sa=zeros(*lead) if lr_a else None,
        sg=zeros(*lead) if lr_g else None,
    )
