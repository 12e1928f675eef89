"""Fused two-sided eigenbasis preconditioning of bucket stacks.

Port of ``kfac_pytorch_tpu/ops/pallas_precond.py`` (the TPU kernel
``_kernel``/``_call``).  Per stacked layer slot ``l``::

    v1 = qg^T g qa ;  v2 = v1 * dgda ;  pg = qg v2 qa^T
    clip[l] = sum(v1 * v2)          (== <pg[l], g[l]>)

:func:`fused_eigen_precondition` calls the custom op
``kfac_torch::fused_eigen_precond`` (:func:`fused_eigen_precond_op`):
on CUDA tensors it launches the hand-written kernel
``csrc/fused_eigen_precond.cu`` (built on first use by :mod:`._build`),
on CPU tensors it runs :func:`fused_eigen_precondition_reference`, the
plain PyTorch chain, and its fake implementation gives the output shapes
to ``FakeTensorMode`` and ``torch.compile``, so the precondition tail
traces through the kernel with no graph break.  A CUDA build or launch
that fails raises — it never falls back.  Unlike the TPU kernel there
is no shape gate: every ``(gp, ap)`` is taken, by one of three routes
chosen by shape before the launch (:func:`kernel_route`).

:func:`fused_eigen_precondition_sharded` is the KAISA form (the JAX
package's ``shard_map`` over the grid's column axis): the same kernel on
this rank's column slice of a bucket, then the all-gather of ``pg`` and
the clip terms over the rank's grid row.
:func:`fused_eigen_precondition_sharded_async` launches the same kernel
and issues that gather asynchronously (``pipeline_grads``), returning the
gather's handle.

Under the numerical-health guardrails and the consistency guard a slot
may be quarantined to identity preconditioning: the sharded forms take
the bucket's ``quarantined`` mask and run
:func:`substitute_quarantined` on the kernel's output before the row
gather (the JAX package runs its matmul chain instead of its kernel
there; the kernel's per-slot clip terms make the substitution exact
after it).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from kfac_pytorch_tpu_torch.ops import _build
from kfac_pytorch_tpu_torch.parallel import collectives

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


#: The kernel's routes, by the number ``csrc/fused_eigen_precond.cu``'s
#: ``kfac_fused_eigen_precond_route`` gives them.
ROUTES = ('pair', 'wgmma', 'cp.async')


def kernel_route(gp: int, ap: int, dtype: torch.dtype) -> str:
    """The route a CUDA call on contiguous (16-byte aligned) operands of
    ``[L, gp, ap]`` takes, chosen by shape before any launch:

    * ``'pair'``: ``gp <= 64``, the fused forward/back pair (two CUDA
      kernels, ``mma.sync``);
    * ``'wgmma'``: ``gp > 64`` on rows TMA can address (``gp`` and ``ap``
      multiples of 4 for f32, of 8 for bf16): four persistent passes of
      TMA-fed ``wgmma`` (four CUDA kernels), TF32 for f32 operands and
      bf16 for bf16 operands (:func:`kernel_order`);
    * ``'cp.async'``: ``gp > 64`` on other rows: four ``mma.sync``
      passes fed by ``cp.async`` with masked edges.

    The kernel's own rule (``kfac_fused_eigen_precond_route``) in
    Python, so the CPU tests reach it."""
    if gp <= 64:
        return 'pair'
    per = 16 // (4 if dtype == torch.float32 else 2)
    return 'wgmma' if gp % per == 0 and ap % per == 0 else 'cp.async'


#: The chain's two associations, by the number
#: ``kfac_fused_eigen_precond_order`` gives them.
ORDERS = ('g.qa', 'qgT.g')


def kernel_order(gp: int, ap: int, dtype: torch.dtype) -> str:
    """Which product a CUDA call on contiguous operands forms first,
    chosen by shape before any launch:

    * ``'g.qa'``: ``W = g qa``, then ``qg^T W`` (and ``Y = v2 qa^T``, then
      ``qg Y``): every f32 call, the pair and ``cp.async`` routes, and the
      bf16 ``wgmma`` route where ``ap >= gp``;
    * ``'qgT.g'``: ``U = qg^T g``, then ``U qa`` (and ``Z = qg v2``, then
      ``Z qa^T``), the TPU kernel's order: the bf16 ``wgmma`` route where
      ``gp > ap``.

    On the bf16 ``wgmma`` route the larger contraction of each half of
    the chain is then always bf16 x bf16.  The kernel's own rule
    (``kfac_fused_eigen_precond_order``) in Python."""
    bf16_wgmma = (dtype == torch.bfloat16
                  and kernel_route(gp, ap, dtype) == 'wgmma')
    return ORDERS[1] if bf16_wgmma and gp > ap else ORDERS[0]


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load_library('fused_eigen_precond')
    fn = lib.kfac_fused_eigen_precond
    if fn.argtypes is None:  # first use: declare the C signatures
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
        ws = lib.kfac_fused_eigen_precond_workspace
        ws.argtypes = [i, i, i]
        ws.restype = ctypes.c_longlong
        for name in ('route', 'order'):
            rule = getattr(lib, f'kfac_fused_eigen_precond_{name}')
            rule.argtypes = [i, i, i]
            rule.restype = i
    return lib


def library_route(gp: int, ap: int, dtype: torch.dtype) -> str:
    """:func:`kernel_route` as the built library answers it (builds the
    kernel on first use; for the card's tests and ``chip_smoke.py``)."""
    lib = _kernel_library()
    return ROUTES[lib.kfac_fused_eigen_precond_route(
        gp, ap, _DTYPE_CODES[dtype])]


def library_order(gp: int, ap: int, dtype: torch.dtype) -> str:
    """:func:`kernel_order` as the built library answers it."""
    lib = _kernel_library()
    return ORDERS[lib.kfac_fused_eigen_precond_order(
        gp, ap, _DTYPE_CODES[dtype])]


def _launch_kernel(
    g: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    dgda: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the hand-written kernel on the current stream (the
    CUDA kernel of :func:`fused_eigen_precond_op`); counts the launch in
    ``fused_eigen_precondition.launches``.  A build or launch failure
    raises."""
    for name, t in (('g', g), ('qa', qa), ('qg', qg), ('dgda', dgda)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    lib = _kernel_library()
    L, gp, ap = g.shape
    with torch.cuda.device(g.device):
        pg = torch.empty((L, gp, ap), dtype=torch.float32, device=g.device)
        clip = torch.empty((L,), dtype=torch.float32, device=g.device)
        # The v2 plane and the clip partials (plus the Y plane and the
        # split-K partial products when gp > 64), as the kernel sizes
        # them.
        workspace = torch.empty(
            (lib.kfac_fused_eigen_precond_workspace(L, gp, ap),),
            dtype=torch.float32, device=g.device,
        )
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.kfac_fused_eigen_precond(
            g.data_ptr(), qa.data_ptr(), qg.data_ptr(), dgda.data_ptr(),
            pg.data_ptr(), clip.data_ptr(), workspace.data_ptr(), L, gp, ap,
            _DTYPE_CODES[g.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f'fused_eigen_precond kernel launch failed for L={L}, gp={gp}, '
            f'ap={ap}, dtype={g.dtype}: cudaError {rc}',
        )
    fused_eigen_precondition.launches += 1
    return pg, clip


@torch.library.custom_op('kfac_torch::fused_eigen_precond', mutates_args=())
def fused_eigen_precond_op(
    g: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    dgda: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``kfac_torch::fused_eigen_precond``: the kernel as a custom op, so
    ``torch.compile`` and ``FakeTensorMode`` trace through it (a
    ``ctypes`` call is opaque to both).  CUDA runs the hand-written
    kernel, CPU the plain chain; any other device has no kernel."""
    raise NotImplementedError(
        f'kfac_torch::fused_eigen_precond has no kernel for {g.device}',
    )


fused_eigen_precond_op.register_kernel('cuda')(_launch_kernel)


@fused_eigen_precond_op.register_kernel('cpu')
def _cpu_kernel(g, qa, qg, dgda):
    return fused_eigen_precondition_reference(g, qa, qg, dgda)


@fused_eigen_precond_op.register_fake
def _fake_kernel(g, qa, qg, dgda):
    L, gp, ap = g.shape
    return (g.new_empty((L, gp, ap), dtype=torch.float32),
            g.new_empty((L,), dtype=torch.float32))


@register_flop_formula(torch.ops.kfac_torch.fused_eigen_precond)
def _kernel_flops(g_shape, qa_shape, qg_shape, dgda_shape, *args,
                  **kwargs) -> int:
    """The four contractions (``FlopCounterMode``'s count for the same
    chain of batched products) and the three elementwise products (the
    ``dgda`` scale and the clip's product and sum)."""
    L, gp, ap = g_shape
    return 4 * L * gp * ap * (gp + ap) + 3 * L * gp * ap


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

    Goes through the custom op ``kfac_torch::fused_eigen_precond``: CUDA
    tensors launch the kernel on the current stream (and count one
    launch in ``fused_eigen_precondition.launches``); CPU tensors run
    the plain version.
    """
    _check(g, qa, qg, dgda)
    if g.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {g.device}')
    return fused_eigen_precond_op(g, qa, qg, dgda)


#: Kernel launches since the count was last set to 0 (CPU calls run the
#: plain version and are not counted).
fused_eigen_precondition.launches = 0


def substitute_quarantined(
    pg: torch.Tensor,
    clip: torch.Tensor,
    g: torch.Tensor,
    quarantined: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Identity preconditioning of the quarantined slots (JAX
    ``second_order.py:1737-1763``): ``pg[l] = g[l]`` and ``clip[l] =
    <g[l], g[l]>`` where ``quarantined[l]``, the kernel's (or the
    chain's) output elsewhere, bit for bit.  ``g`` is the f32 gradient
    stack."""
    q = quarantined.to(device=pg.device, dtype=torch.bool)
    gf = g.float()
    pg = torch.where(q[:, None, None], gf, pg)
    clip = torch.where(q, torch.sum(gf * gf, dim=(1, 2)), clip)
    return pg, clip


def _kernel_then_substitute(g, qa, qg, dgda, quarantined, raw, fn):
    pg, clip = fn(g, qa, qg, dgda)
    if quarantined is not None:
        pg, clip = substitute_quarantined(
            pg, clip, g if raw is None else raw, quarantined,
        )
    return pg, clip


def fused_eigen_precondition_sharded(
    g: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    dgda: torch.Tensor,
    group=None,
    quarantined: torch.Tensor | None = None,
    raw: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """KAISA phases 3 and 4 for one bucket.

    Args:
        g, qa, qg, dgda: this rank's ``[seg, ...]`` column slice of the
            bucket stacks (the operands of :func:`fused_eigen_precondition`).
        group: the rank's grid row (ranks ordered by column), or ``None``
            for a grid of one column: nothing to gather.
        quarantined: the slice's ``[seg]`` quarantine mask, or ``None``:
            :func:`substitute_quarantined` runs on the kernel's output
            before the gather.
        raw: the f32 gradient slice the substitution takes (default
            ``g``; the caller passes it when ``g`` is bf16).

    Returns:
        ``(pg [cols * seg, gp, ap] f32, clip [cols * seg] f32)``, every
        column's slots in column order — the bucket's full stacks.

    The kernel runs on the local slice (CUDA tensors, counted in
    ``fused_eigen_precondition.launches``; CPU tensors run the plain
    version).
    """
    pg, clip = _kernel_then_substitute(g, qa, qg, dgda, quarantined, raw,
                                       fused_eigen_precondition)
    return collectives.all_gather_preconditioned(pg, clip, group)


def fused_eigen_precondition_sharded_async(
    g: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    dgda: torch.Tensor,
    group=None,
    quarantined: torch.Tensor | None = None,
    raw: torch.Tensor | None = None,
) -> collectives.GatherHandle:
    """:func:`fused_eigen_precondition_sharded` with the row gather issued
    asynchronously: the kernel runs on the local slice (counted as one
    launch), then the gather is issued and its handle returned; the
    handle's ``wait()`` gives the ``(pg, clip)`` the synchronous form
    returns, bit for bit.  ``group=None`` gives a handle already done."""
    pg, clip = _kernel_then_substitute(g, qa, qg, dgda, quarantined, raw,
                                       fused_eigen_precondition)
    return collectives.all_gather_preconditioned_async(pg, clip, group)


def fused_eigen_precondition_sharded_reference(
    g: torch.Tensor,
    qa: torch.Tensor,
    qg: torch.Tensor,
    dgda: torch.Tensor,
    group=None,
    quarantined: torch.Tensor | None = None,
    raw: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_eigen_precondition_sharded` through the plain chain."""
    pg, clip = _kernel_then_substitute(g, qa, qg, dgda, quarantined, raw,
                                       fused_eigen_precondition_reference)
    return collectives.all_gather_preconditioned(pg, clip, group)
