#!/usr/bin/env python3
"""The fused kernel's ``gp > 64`` route on one CUDA card: checks, times
and per-pass profiles at chosen shapes, and builds of the kernel source
with other compile-time settings compared in one process.

Run from the root of the repository::

    python3 chip_probes/wgmma_on_card.py 24,1024,4224 1,1024,2176
    python3 chip_probes/wgmma_on_card.py --variants 'A=-DNAME=1' \\
        'B=-DNAME=2' 24,1024,4224
    python3 chip_probes/wgmma_on_card.py --source other.cu --variants ...

The first form builds the kernels (``ops/_build.py``) and, per shape,
holds the kernel against its plain version in f32 (``rtol 1e-5, atol
1e-4``) and bf16 (mean relative error 1e-3), with two runs bitwise
equal, then prints the kernel's and the cuBLAS chain's times (CUDA
events) and each CUDA kernel's device time in one call of each dtype
(``torch.profiler``), with the route and order each dtype takes.  The second compiles
``csrc/fused_eigen_precond.cu`` once per ``NAME=flags`` (``nvcc`` with
``ops/_build.NVCC_FLAGS`` and those flags, into ``chiprun_out/var/``),
loads each library through ``ctypes`` and times them at each shape in
turns (a, b, ..., b, a; the least of two), after the same checks;
``--source`` builds another copy of the source instead.
Nothing here is part of ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from kfac_pytorch_tpu_torch.ops import _build  # noqa: E402
from kfac_pytorch_tpu_torch.ops import fused_precond  # noqa: E402
from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition  # noqa: E402
from kfac_pytorch_tpu_torch.ops import (  # noqa: E402
    fused_eigen_precondition_reference as plain,
)

SOURCE = os.path.join(ROOT, 'kfac_pytorch_tpu_torch', 'csrc',
                      'fused_eigen_precond.cu')


def operands(L, gp, ap, seed):
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)

    def orth(n):
        a = torch.randn(L, n, n, generator=gen, device='cuda')
        return torch.linalg.qr(a)[0].contiguous()

    g = torch.randn(L, gp, ap, generator=gen, device='cuda')
    dgda = torch.rand(L, gp, ap, generator=gen, device='cuda') * 0.9 + 0.1
    return [g, orth(ap), orth(gp), dgda]


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(kernel, args, calls=200):
    """Microseconds of host time to issue one call (200 calls issued
    back to back; the launch queue holds them all)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        kernel(*args)
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


def check(kernel, args):
    """``(ok, max abs err)`` of two kernel runs against plain."""
    pg, clip = kernel(*args)
    pg2, clip2 = kernel(*args)
    want, _ = plain(*args)
    torch.cuda.synchronize()
    err = float((pg - want).abs().max())
    if args[0].dtype == torch.float32:
        ok = bool(((pg - want).abs() <= 1e-4 + 1e-5 * want.abs()).all())
    else:
        ok = float((pg - want).abs().mean() / want.abs().mean()) < 1e-3
    return ok and torch.equal(pg, pg2) and torch.equal(clip, clip2), err


def pass_times(kernel, args):
    """Device ms of each CUDA kernel one call issues."""
    from torch.profiler import ProfilerActivity, profile

    kernel(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernel(*args)
        torch.cuda.synchronize()
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name.replace('(anonymous namespace)::', '')
            out.append(f'{name.split("(")[0][-64:]} {evt.device_time / 1e3:.4f}')
    return '; '.join(out)


def library(path):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kfac_fused_eigen_precond.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                             i, p]
    lib.kfac_fused_eigen_precond_workspace.argtypes = [i, i, i]
    lib.kfac_fused_eigen_precond_workspace.restype = ctypes.c_longlong

    def call(g, qa, qg, dgda):
        L, gp, ap = g.shape
        pg = torch.empty(L, gp, ap, device='cuda')
        clip = torch.empty(L, device='cuda')
        ws = torch.empty(lib.kfac_fused_eigen_precond_workspace(L, gp, ap),
                         device='cuda')
        rc = lib.kfac_fused_eigen_precond(
            g.data_ptr(), qa.data_ptr(), qg.data_ptr(), dgda.data_ptr(),
            pg.data_ptr(), clip.data_ptr(), ws.data_ptr(), L, gp, ap,
            0 if g.dtype == torch.float32 else 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f'launch failed: cudaError {rc}')
        return pg, clip

    return call


def build_variants(variants):
    out_dir = os.path.join(ROOT, 'chiprun_out', 'var')
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        path = os.path.join(out_dir, f'lib{name}.so')
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, '-o', path,
               SOURCE]
        procs[name] = (path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(out_dir, f'{name}.log'), 'w') as fh:
            fh.write(log)
        if proc.returncode:
            raise SystemExit(f'{name}: nvcc failed\n{log[-4000:]}')
        for line in log.splitlines():
            if 'serialized' in line or 'injected' in line:
                print(name, line[:240], flush=True)
        kernels[name] = library(path)
    return kernels


def main(argv):
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    variants = {}
    global SOURCE
    if argv and argv[0] == '--source':
        SOURCE = os.path.abspath(argv[1])
        argv = argv[2:]
    if argv and argv[0] == '--variants':
        argv = argv[1:]
        while argv and '=' in argv[0]:
            name, flags = argv.pop(0).split('=', 1)
            variants[name] = flags.split()
    shapes = [tuple(int(x) for x in a.split(',')) for a in argv]
    t0 = time.perf_counter()
    if variants:
        kernels = build_variants(variants)
    else:
        _build.build_all()
        kernels = {'kernel': fused_eigen_precondition}
    print(f'build {time.perf_counter() - t0:.1f} s', flush=True)
    bad = 0
    for L, gp, ap in shapes:
        args32 = operands(L, gp, ap, L + gp + ap)
        reps = 5 if L * gp * ap > 5e7 else 20
        for dtype in (torch.float32, torch.bfloat16):
            args = [a.to(dtype) for a in args32]
            line = f'{(L, gp, ap)} {str(dtype)[6:]}:'
            for name, kernel in kernels.items():
                ok, err = check(kernel, args)
                bad += not ok
                line += f' {name} {"ok" if ok else "BAD"} {err:.2e}'
            times = {name: [] for name in kernels}
            for name in [*kernels, *reversed(kernels)]:
                times[name].append(time_ms(lambda: kernels[name](*args),
                                           reps))
            line += ' | ' + ' '.join(f'{n}_ms={min(t):.4f}'
                                     for n, t in times.items())
            for name, kernel in kernels.items():
                line += f' {name}_host_us={host_us(kernel, args):.1f}'
            if dtype == torch.float32:
                g, qa, qg, dgda = args
                line += ' cublas_ms=' + format(time_ms(
                    lambda: qg @ ((qg.mT @ g @ qa) * dgda) @ qa.mT, reps),
                    '.4f')
            if not variants:
                # (A checkout from before the bf16 route has no order.)
                order = getattr(fused_precond, 'kernel_order',
                                lambda *_: 'g.qa')
                line += (f' route={fused_precond.kernel_route(gp, ap, dtype)}'
                         f' order={order(gp, ap, dtype)}')
            print(line, flush=True)
            for name, kernel in kernels.items():
                print(f'   {name} passes: {pass_times(kernel, args)}',
                      flush=True)
        del args32, args
        torch.cuda.empty_cache()
    print(f'bad {bad}', flush=True)
    return 1 if bad else 0


if __name__ == '__main__':
    raise SystemExit(main(sys.argv[1:]))
