"""Fused two-sided eigenbasis preconditioning of bucket stacks.

Port of ``kfac_pytorch_tpu/ops/pallas_precond.py`` (the TPU kernel
``_kernel``/``_call`` behind ``fused_eigen_precondition``).  Per stacked
layer slot ``l``::

    v1 = qg^T g qa ;  v2 = v1 * dgda ;  pg = qg v2 qa^T
    clip[l] = sum(v1 * v2)          (== <pg[l], g[l]>)

On CUDA tensors :func:`fused_eigen_precondition` launches the
hand-written kernel ``csrc/fused_eigen_precond.cu`` (built on first use
by :mod:`._build`); on CPU tensors it runs
:func:`fused_eigen_precondition_reference`, the plain PyTorch chain.
A CUDA launch that fails raises — it never falls back.  Unlike the TPU
kernel there is no shape gate: every ``(gp, ap)`` is taken.
"""
from __future__ import annotations

import ctypes

import torch

from kfac_pytorch_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_eigen_precondition_reference(
    g: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    dgda: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch chain with the kernel's signature and outputs.

    Operands are widened to f32 before each product (the product of two
    bf16 values is exact in f32, so this is the f32-accumulating
    contraction), and for bf16 operands ``v2`` is rounded to bf16 before
    the back-rotation — the TPU kernel's numerics.
    """
    _check(g, qa, qg, dgda)
    gf, qaf, qgf = g.float(), qa.float(), qg.float()
    v1 = qgf.mT @ gf @ qaf
    v2 = v1 * dgda.float()
    clip = torch.sum(v1 * v2, dim=(1, 2))
    v2 = v2.to(g.dtype).float()
    pg = qgf @ v2 @ qaf.mT
    return pg, clip


def _check(g, qa, qg, dgda) -> None:
    if g.ndim != 3:
        raise ValueError(f'g must be [L, gp, ap], got {tuple(g.shape)}')
    L, gp, ap = g.shape
    want = {
        'qa': (qa, (L, ap, ap)),
        'qg': (qg, (L, gp, gp)),
        'dgda': (dgda, (L, gp, ap)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f'{name} must have shape {shape} for g of shape '
                f'{tuple(g.shape)}, got {tuple(t.shape)}',
            )
    for name, t in (('qa', qa), ('qg', qg), ('dgda', dgda)):
        if t.dtype != g.dtype:
            raise TypeError(
                f'{name} is {t.dtype} but g is {g.dtype}: operands share '
                'one dtype',
            )
        if t.device != g.device:
            raise ValueError(
                f'{name} is on {t.device} but g is on {g.device}',
            )
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(
            f'operands must be float32 or bfloat16, got {g.dtype}',
        )


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load_library('fused_eigen_precond')
    fn = lib.kfac_fused_eigen_precond
    if fn.argtypes is None:  # first use: declare the C signatures
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
        tiles = lib.kfac_fused_eigen_precond_tiles
        tiles.argtypes = [i, i]
        tiles.restype = i
    return lib


def fused_eigen_precondition(
    g: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    dgda: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``qg @ ((qg^T @ g @ qa) * dgda) @ qa^T`` per stacked layer.

    Args:
        g: ``[L, gp, ap]`` combined gradients (f32 or bf16).
        qa: ``[L, ap, ap]`` A-factor eigenvectors.
        qg: ``[L, gp, gp]`` G-factor eigenvectors.
        dgda: ``[L, gp, ap]`` predivided eigenvalue outer product.

    Returns:
        ``(pg [L, gp, ap] f32, clip [L] f32)`` with
        ``clip[l] == <pg[l], g[l]>``.

    CUDA tensors launch the kernel on the current stream (and count one
    launch in ``fused_eigen_precondition.launches``); CPU tensors run
    the plain version.
    """
    _check(g, qa, qg, dgda)
    if g.device.type == 'cpu':
        return fused_eigen_precondition_reference(g, qa, qg, dgda)
    if g.device.type != 'cuda':
        raise ValueError(f'unsupported device {g.device}')
    for name, t in (('g', g), ('qa', qa), ('qg', qg), ('dgda', dgda)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    lib = _kernel_library()
    L, gp, ap = g.shape
    tiles = lib.kfac_fused_eigen_precond_tiles(gp, ap)
    with torch.cuda.device(g.device):
        pg = torch.empty((L, gp, ap), dtype=torch.float32, device=g.device)
        clip = torch.empty((L,), dtype=torch.float32, device=g.device)
        scratch = torch.empty(
            (2, L, gp, ap), dtype=torch.float32, device=g.device,
        )
        partials = torch.empty(
            (L, tiles), dtype=torch.float32, device=g.device,
        )
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.kfac_fused_eigen_precond(
            g.data_ptr(), qa.data_ptr(), qg.data_ptr(), dgda.data_ptr(),
            pg.data_ptr(), clip.data_ptr(), scratch.data_ptr(),
            partials.data_ptr(), L, gp, ap, _DTYPE_CODES[g.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f'fused_eigen_precond kernel launch failed for L={L}, gp={gp}, '
            f'ap={ap}, dtype={g.dtype}: cudaError {rc}',
        )
    fused_eigen_precondition.launches += 1
    return pg, clip


#: Kernel launches since the count was last set to 0 (CPU calls run the
#: plain version and are not counted).
fused_eigen_precondition.launches = 0
