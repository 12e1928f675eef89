#!/usr/bin/env python3
"""What one spawn for the multi-rank phases saves on the card.

Run from the root of the repository on one CUDA card::

    python3 chip_probes/shared_spawn.py

It builds the kernels, then runs the rank work of ``chip_smoke.py``'s
phases 5, 17, 18, 21, 22 (the resize) and 23 (its two ranks) twice on
the same host: each phase in a spawn of its own, one after the other
(``chip_smoke.spawn_alone``), then all of them in one spawn
(``chip_smoke.spawn_shared``), and prints each time beside the card's
name and power limit.  The phases' gates are the script's; this probe
checks only that every rank finished.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from kfac_pytorch_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        cs.fail('torch.cuda.is_available() is false: this probe needs a '
                'CUDA card')
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    took = {}
    for key in cs.multi_rank_plan():
        t0 = time.perf_counter()
        cs.spawn_alone(torch, key)
        took[f'alone {key}'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.spawn_shared(torch)
    took['shared'] = time.perf_counter() - t0
    alone = sum(v for k, v in took.items() if k.startswith('alone'))
    print(f'shared spawn: {took["shared"]:.2f} s against {alone:.2f} s '
          f'in separate spawns (saved {alone - took["shared"]:.2f} s); '
          + json.dumps(took), flush=True)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
