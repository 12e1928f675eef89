#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 33 by itself on one CUDA card.

Run from the root of the repository on one CUDA card::

    python3 chip_probes/analysis_on_card.py

It builds the kernels and runs phase 33's functions: the retrace guard
on ResNet-50 over the damping sweep against an unguarded twin and the
sync guard on its later steps (``phase_guard``), the precondition tail
under ``torch.compile(fullgraph=True)`` (``phase_compiled_tail``: the
eager backend on ResNet-50, Inductor on ResNet-32) and the kernel's host
cost through the custom op against the direct launch
(``op_host_cost``), with phase 32b's elastic drill running beside them
as in ``chip_smoke.py`` (``start_elastic_drill``; the op's host cost is
timed after it ends), each phase's lines as ``chip_smoke.py`` prints them,
then the phase's seconds, between two lines with the card's name and
power limit.  The kernel-case checks of phases 1-2 are not run: the
kernels-line fields they fill are left out.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        cs.fail('this probe needs a CUDA card')
    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.ops import _build

    card = cs.card_line()
    print(card, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda}', flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    t0 = time.perf_counter()
    drill = cs.start_elastic_drill()
    try:
        entries = cs.phase_analysis(torch, kt, {'max_abs_err': 0.0},
                                    {'max_abs_err': 0.0}, drill)
    finally:
        cs.stop_elastic_drill(drill)
    print(f'phase 33 alone: {time.perf_counter() - t0:.2f} s; launches '
          f'{[e["launches"] for e in entries]}', flush=True)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
