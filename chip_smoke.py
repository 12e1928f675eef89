#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA card.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc`` (``sm_90a``), and imports nothing of
JAX or of the JAX package.  Phases, each of which exits non-zero when it
fails:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``kfac_pytorch_tpu_torch/csrc`` and its time;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (ResNet-32's six bucket stacks) plus
   ResNet-50's largest bucket, in f32 (``rtol 1e-5, atol 1e-4``) and in
   bf16 (against f32: mean relative error < 0.05), with two runs giving
   bitwise-equal outputs; times of the kernel, its plain version and
   the cuBLAS ``torch.matmul`` chain, with CUDA events, and the device
   time of one step's kernel calls replayed as one CUDA graph;
3. the main path: CIFAR ResNet-32 at batch 128 trained for 20 K-FAC
   steps on one fixed synthetic batch through ``KFACPreconditioner``,
   counting kernel launches, checking one step's preconditioned
   gradients against a rerun of the same state through the plain
   version, and timing the step and its stages.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

#: H100 SXM figures (NVIDIA data sheet, 700 W): HBM bytes/s, f32
#: CUDA-core FLOP/s, dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

#: ResNet-32's bucket stacks ``(L, gp, ap)`` in plan order, then
#: ResNet-50's largest bucket (a4608g512) at L=2.
MAIN_PATH_CASES = [
    (9, 64, 576), (1, 64, 320), (9, 32, 320), (11, 32, 192),
    (1, 32, 128), (1, 32, 32),
]
EXTRA_CASES = [(2, 512, 4608)]
TRAIN_STEPS = 20
BATCH = 128
DEVICE = 'cuda'
CHECK_STEP = 10  # an inverse-update step: refresh + precondition


def fail(msg: str) -> None:
    print(f'FAIL: {msg}', file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, calls, reps: int = 20) -> float:
    """Mean milliseconds per replay of one CUDA graph that holds every
    call in ``calls``: their device time without the host's cost of
    issuing each call."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    return time_ms(torch, graph.replay, reps)


def precond_bound(L, gp, ap, itemsize):
    """``(bound_ms, bound_by)`` of one fused call: every input read once,
    ``pg`` and ``clip`` written once, against the four contractions plus
    the elementwise scale and clip product."""
    nbytes = itemsize * L * (2 * gp * ap + ap * ap + gp * gp)
    nbytes += 4 * L * gp * ap + 4 * L
    flops = 2 * L * (gp * gp * ap * 2 + gp * ap * ap * 2) + 3 * L * gp * ap
    peak = F32_FLOPS if itemsize == 4 else BF16_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def make_case(torch, L, gp, ap, seed):
    """Realistic operands: orthonormal eigenbases, Gaussian gradient,
    positive eigenvalue grid."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)

    def orth(n):
        a = torch.randn(L, n, n, generator=gen, device=DEVICE)
        return torch.linalg.qr(a)[0].contiguous()

    g = torch.randn(L, gp, ap, generator=gen, device=DEVICE)
    dgda = torch.rand(L, gp, ap, generator=gen, device=DEVICE) * 0.9 + 0.1
    return [g, orth(ap), orth(gp), dgda]


def phase_kernels(torch, ops):
    """Kernel against plain on the card; returns the kernels-line entry
    (times summed over the main path's six bucket calls of one step)."""
    kernel = ops.fused_eigen_precondition
    plain = ops.fused_eigen_precondition_reference

    def library(g, qa, qg, dgda):
        return qg @ ((qg.mT @ g @ qa) * dgda) @ qa.mT

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  t_bytes=0.0, t_ops=0.0)
    max_err = 0.0
    step_calls = []
    for i, (L, gp, ap) in enumerate(MAIN_PATH_CASES + EXTRA_CASES):
        args = make_case(torch, L, gp, ap, seed=100 + i)
        pg, clip = kernel(*args)
        pg2, clip2 = kernel(*args)
        want_pg, want_clip = plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(clip, clip2) and torch.equal(pg, pg2)):
            fail(f'case {(L, gp, ap)}: two kernel runs differ bitwise')
        err = float((pg - want_pg).abs().max())
        bad = (pg - want_pg).abs() > 1e-4 + 1e-5 * want_pg.abs()
        if not torch.isfinite(pg).all() or bool(bad.any()):
            fail(f'case {(L, gp, ap)} f32: kernel disagrees with plain '
                 f'(max abs err {err:.3e}, {int(bad.sum())} elements)')
        clip_err = float(((clip - want_clip).abs()
                          / want_clip.abs().clamp_min(1e-6)).max())
        if clip_err > 1e-3:
            fail(f'case {(L, gp, ap)}: clip rel err {clip_err:.3e}')
        bf = [a.to(torch.bfloat16) for a in args]
        pg16, clip16 = kernel(*bf)
        pg16b, clip16b = kernel(*bf)
        want16, _ = plain(*bf)
        torch.cuda.synchronize()
        if not (torch.equal(clip16, clip16b) and torch.equal(pg16, pg16b)):
            fail(f'case {(L, gp, ap)} bf16: two runs differ bitwise')
        rel32 = float((pg16 - want_pg).abs().mean() / want_pg.abs().mean())
        rel16 = float((pg16 - want16).abs().mean() / want16.abs().mean())
        if not rel32 < 0.05 or not rel16 < 1e-3:
            fail(f'case {(L, gp, ap)} bf16: mean rel err {rel32:.3e} vs '
                 f'f32, {rel16:.3e} vs plain bf16')
        ms = time_ms(torch, lambda: kernel(*args))
        plain_ms = time_ms(torch, lambda: plain(*args))
        library_ms = time_ms(torch, lambda: library(*args))
        ms16 = time_ms(torch, lambda: kernel(*bf))
        bound, t_bytes, t_ops = precond_bound(L, gp, ap, 4)
        bound16 = precond_bound(L, gp, ap, 2)[0]
        print(f'case L={L} gp={gp} ap={ap}: f32 max_abs_err={err:.3e} '
              f'clip_rel_err={clip_err:.3e} kernel_ms={ms:.5f} '
              f'plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} '
              f'bound_ms={bound:.5f} | bf16 mean_rel_err_vs_f32={rel32:.3e} '
              f'kernel_ms={ms16:.5f} bound_ms={bound16:.6f}', flush=True)
        if (L, gp, ap) in MAIN_PATH_CASES:
            step_calls.append(lambda a=args: kernel(*a))
            max_err = max(max_err, err)
            for key, v in (('ms', ms), ('plain_ms', plain_ms),
                           ('library_ms', library_ms), ('bound_ms', bound),
                           ('t_bytes', t_bytes), ('t_ops', t_ops)):
                totals[key] += v
    step_graph_ms = graph_ms(torch, step_calls)
    print(f'kernel: one step\'s {len(step_calls)} calls: {totals["ms"]:.5f} '
          f'ms issued one by one, {step_graph_ms:.5f} ms replayed as one '
          'CUDA graph (device time)', flush=True)
    return {
        'name': 'fused_eigen_precondition',
        'route': 'cuda',
        'source': 'kfac_pytorch_tpu_torch/csrc/fused_eigen_precond.cu',
        'replaces': 'kfac_pytorch_tpu/ops/pallas_precond.py:43',
        'launches': None,  # filled from the main path's run
        'max_abs_err': max_err,
        'ms': totals['ms'],
        'kernel_ms': totals['ms'],
        'graph_ms': step_graph_ms,
        'plain_ms': totals['plain_ms'],
        'bound_ms': totals['bound_ms'],
        'bound_by': (
            'operations' if totals['t_ops'] >= totals['t_bytes']
            else 'bytes'
        ),
        'library_ms': totals['library_ms'],
    }


def phase_train(torch, kt):
    """ResNet-32, batch 128, 20 K-FAC steps on one fixed batch."""
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch.parallel.second_order import (
        BucketedSecondOrder,
    )
    from kfac_pytorch_tpu_torch.parallel.second_order import BucketSecond

    model = kt.models.resnet32(device=DEVICE, seed=0)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    x = torch.randn(BATCH, 3, 32, 32, generator=gen, device=DEVICE)
    y = torch.randint(0, 10, (BATCH,), generator=gen, device=DEVICE)
    precond = kt.KFACPreconditioner(
        model, factor_update_steps=1, inv_update_steps=10, damping=0.003,
        kl_clip=0.001, lr=0.1,
    )
    n_buckets = len(precond.plan.buckets)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

    events: dict[str, list] = {
        'capture (fwd+bwd)': [], 'factors (cov+EMA)': [],
        'eigh refresh': [], 'precondition': [],
    }

    def timed(name, fn):
        def run(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            events[name].append((s, e))
            return out
        return run

    precond._update_factors = timed(
        'factors (cov+EMA)', precond._update_factors,
    )
    precond._refresh = timed('eigh refresh', precond._refresh)
    precond._precondition = timed('precondition', precond._precondition)

    def fwd_bwd():
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        return loss

    fwd_bwd_timed = timed('capture (fwd+bwd)', fwd_bwd)
    losses, step_s = [], []
    check = None
    kernel = kt.ops.fused_eigen_precondition
    torch.cuda.synchronize()
    kernel.launches = 0
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = fwd_bwd_timed()
        if step == CHECK_STEP:
            raw = {n: h.get_grad().clone()
                   for n, h in precond.helpers.items()}
        precond.step()
        if step == CHECK_STEP:
            check = (raw, {n: h.get_grad().clone()
                           for n, h in precond.helpers.items()})
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
    launches = kernel.launches

    if not all(math.isfinite(v) for v in losses):
        fail(f'non-finite loss: {losses}')
    if not losses[-1] < losses[0]:
        fail(f'loss did not fall: first {losses[0]}, last {losses[-1]}')
    if launches != TRAIN_STEPS * n_buckets:
        fail(f'kernel launched {launches} times in {TRAIN_STEPS} steps, '
             f'expected {TRAIN_STEPS * n_buckets} ({n_buckets} buckets)')

    # Rerun the check step's precondition from the same state through the
    # plain version (CPU tensors take it): same kl-clip, same buckets.
    raw, got = check
    cpu_so = BucketedSecondOrder(precond.plan, device='cpu')
    cpu_buckets = {
        k: BucketSecond(qa=b.qa.cpu(), qg=b.qg.cpu(), dgda=b.dgda.cpu())
        for k, b in precond.buckets.items()
    }
    want, _ = cpu_so.precondition(
        cpu_buckets, {n: g.cpu() for n, g in raw.items()}, 0.001, 0.1,
    )
    worst = 0.0
    for name, w in want.items():
        g = got[name].cpu()
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        worst = max(worst, rel)
    # Same eigenbases on both sides; only the f32 summation order of the
    # 576-long contractions differs (relative norm error ~1e-6).
    if not worst < 1e-4:
        fail(f'step {CHECK_STEP}: kernel path vs plain rerun relative '
             f'norm error {worst:.3e}')

    steady = step_s[1:]
    stage_ms = {}
    for name, evs in events.items():
        ts = [s.elapsed_time(e) for s, e in evs]
        stage_ms[name] = (statistics.median(ts), len(ts))
    print(f'train: losses first={losses[0]:.6f} last={losses[-1]:.6f} '
          f'all={[round(v, 5) for v in losses]}', flush=True)
    print(f'train: launches={launches} ({n_buckets} buckets x '
          f'{TRAIN_STEPS} steps); check step {CHECK_STEP} rel err vs '
          f'plain rerun {worst:.3e}', flush=True)
    print(f'train: median step {statistics.median(steady) * 1e3:.4f} ms '
          f'(steps 1-{TRAIN_STEPS - 1}, host clock, synchronized); first '
          f'step {step_s[0] * 1e3:.2f} ms', flush=True)
    for name, (ms, n) in stage_ms.items():
        print(f'train: stage {name}: median {ms:.4f} ms over {n} calls '
              '(CUDA events)', flush=True)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke test needs '
             'a CUDA card')
    try:
        import kfac_pytorch_tpu_torch as kt
        from kfac_pytorch_tpu_torch.ops import _build
    except ImportError as exc:
        fail(f'the port is not importable (run from the repository root): '
             f'{exc}')
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    print(f'build: {time.perf_counter() - t0:.2f} s for '
          f'{len(_build.build_log)} kernel source(s)', flush=True)
    for stem, rec in _build.build_log.items():
        usage = [ln.strip() for ln in rec['log'].splitlines()
                 if 'registers' in ln or 'spill' in ln]
        print(f'build: {stem}: {rec["seconds"]:.2f} s -> {rec["path"]}',
              flush=True)
        for ln in usage:
            print(f'  ptxas: {ln}', flush=True)

    entry = phase_kernels(torch, kt.ops)
    entry['launches'] = phase_train(torch, kt)
    print(card, flush=True)
    print(json.dumps({'kernels': [entry]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
