#!/usr/bin/env python3
"""The port's drill and profile scripts on one CUDA card.

Run from the root of the repository on one CUDA card::

    python3 chip_probes/scripts_on_card.py [OUT_DIR]

It builds the kernels, runs ``chip_smoke.py``'s phase 32 by itself (the
variant mode on ResNet-50, the iterative, stagger and phase-profile
smokes, the elastic drill at 8 -> 4 -> 2), then the four smokes phase 32
does not run (placement, overlap and pipeline at their default world of
8 ranks, adaptive) and the five other drills (health, consistency,
watchdog, postmortem, multiproc), each with ``--device cuda`` through
its command line, each artifact through its validator.  Artifacts and
logs go to ``OUT_DIR`` (default ``chiprun_out/scripts_on_card``); one
line a script says its exit code, its validator's, its seconds and the
evidence the card gave, beside the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PROFILE = 'kfac_pytorch_tpu_torch.scripts.profile_step'
DRILL = 'kfac_pytorch_tpu_torch.scripts.fault_drill'
SMOKES = {
    'placement': ['--placement-smoke'],
    'overlap': ['--overlap-smoke'],
    'pipeline': ['--pipeline-smoke'],
    'adaptive': ['--adaptive-smoke'],
}
DRILLS = ('health', 'consistency', 'watchdog', 'postmortem', 'multiproc')
TIMEOUT_S = 900


def run(argv: list[str], log: str) -> tuple[int, float]:
    t = time.perf_counter()
    with open(log, 'w') as fh:
        rc = subprocess.call([sys.executable, '-m', *argv], cwd=ROOT,
                             stdout=fh, stderr=subprocess.STDOUT,
                             timeout=TIMEOUT_S)
    return rc, time.perf_counter() - t


def main() -> int:
    import torch

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        cs.fail('torch.cuda.is_available() is false: this probe needs a '
                'CUDA card')
    out = os.path.abspath(sys.argv[1] if sys.argv[1:] else os.path.join(
        ROOT, 'chiprun_out', 'scripts_on_card'))
    os.makedirs(out, exist_ok=True)
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    _build.build_all()
    print(f'build {time.perf_counter() - t:.2f} s', flush=True)
    t = time.perf_counter()
    launches, err = cs.phase_profile_drill(torch, kt)
    drill = cs.start_elastic_drill()
    try:
        cs.finish_elastic_drill(drill)
    finally:
        cs.stop_elastic_drill(drill)
    print(f'phase 32: launches {launches}, max abs err {err:.3e}, '
          f'{time.perf_counter() - t:.2f} s', flush=True)
    ok = True
    for name, flags in SMOKES.items():
        art = os.path.join(out, f'{name}_smoke.json')
        rc, took = run([PROFILE, '--device', 'cuda', '--json-out', art,
                        *flags], os.path.join(out, f'{name}_smoke.log'))
        evidence = {}
        try:
            with open(art) as fh:
                detail = json.load(fh).get('detail', {})
            evidence = {k: detail[k] for k in ('card', 'parity', 'device')
                        if k in detail}
        except (OSError, ValueError):
            pass
        ok &= rc == 0
        print(f'smoke {name}: rc {rc} (its validator) {took:.2f} s '
              f'{json.dumps(evidence)}', flush=True)
    for drill in DRILLS:
        art = os.path.join(out, f'{drill}_drill.json')
        flag = [] if drill == 'health' else [f'--{drill}']
        rc, took = run([DRILL, '--device', 'cuda', *flag, '--json-out', art],
                       os.path.join(out, f'{drill}_drill.log'))
        vrc = None
        summary = {}
        if drill != 'health':
            vrc = subprocess.call([sys.executable, '-m', DRILL,
                                   f'--validate-{drill}', art], cwd=ROOT)
            try:
                with open(art) as fh:
                    summary = {k: v.get('ok') for k, v in
                               json.load(fh)['phases'].items()}
            except (OSError, ValueError, KeyError):
                pass
        ok &= rc == 0 and vrc in (None, 0)
        print(f'drill {drill}: rc {rc} validator {vrc} {took:.2f} s '
              f'{summary}', flush=True)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
