#!/usr/bin/env python3
"""``chip_smoke.profile_case``'s fresh-process profiler, and phase 17's
profile lines in a process that ran no earlier phase.

Run from the root of the repository on one CUDA card::

    python3 chip_probes/profiler_fallback.py

It builds the kernels, then profiles three bucket shapes with this
process's profiler sessions made to come up empty, so that each call is
profiled in the fresh process (the first start included in the first
shape's seconds), and then runs phase 17 (ResNet-50 at world 4 over
gloo, rank 0's HYBRID-OPT shards profiled one by one).  Each ``profile``
line names the session that saw the kernels.  It checks what
``profile_case`` checks and nothing more.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

#: ``(L, gp, ap)``: two narrow shapes (two CUDA kernels a call) and a
#: wide one (four).
SHAPES = [(1, 64, 192), (2, 512, 4608), (3, 64, 576)]


def main() -> int:
    import torch

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        cs.fail('this probe needs a CUDA card')
    print(cs.card_line(), flush=True)
    _build.build_all()
    real = cs.kernel_device_times
    cs.kernel_device_times = (
        lambda torch, fn, sessions=5, calls=3: ([], sessions))
    try:
        for i, shape in enumerate(SHAPES):
            t = time.perf_counter()
            args = cs.make_case(torch, *shape, seed=900 + i)
            n = cs.profile_case(torch, kt.ops.fused_eigen_precondition,
                                args, shape, 900 + i, at_most=4)
            print(f'fresh-process profile {shape}: {n} kernels a call, '
                  f'{time.perf_counter() - t:.2f} s', flush=True)
    finally:
        cs.kernel_device_times = real
    t = time.perf_counter()
    try:
        cs.phase_resnet50_pipelined(torch, kt)
    finally:
        cs.stop_profile_worker()
    print(f'phase 17 alone: {time.perf_counter() - t:.2f} s', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
