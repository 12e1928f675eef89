#!/usr/bin/env python3
"""The collective audit on one CUDA card: ``chip_smoke.py``'s audited
phases and the audit's own lanes.

Run from the root of the repository on one CUDA card::

    python3 chip_probes/audit_on_card.py [OUT.json]

It builds the kernels, runs the four gloo ranks of phases 5 (ResNet-32
on the KAISA grid, every option), 17 (ResNet-50 at world 4, pipelined,
and the overlap pass) and 31 b (ResNet-50 on the ``'auto'`` grid) one
spawn each, with each phase's gates and its ``audit`` lines as
``chip_smoke.py`` prints them, then the collective audit's 14 lanes
(:func:`kfac_pytorch_tpu_torch.analysis.audit.run_audit`) at world 8 on
the card, written to ``OUT.json`` (default ``comm_audit_card.json`` in
the working directory) with its table, and each part's
seconds, between two lines with the card's name and power limit.  The
kernel-case checks of phases 1-2 are not run: the kernels-line entries
of these phases are built from their stubs.
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

    if not torch.cuda.is_available():
        cs.fail('this probe needs a CUDA card')
    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.analysis import audit
    from kfac_pytorch_tpu_torch.ops import _build

    out = sys.argv[1] if len(sys.argv) > 1 else 'comm_audit_card.json'
    card = cs.card_line()
    print(card, flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda}', flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    # The phases' kernel entries time the kernel on the card; here they
    # are stubs, as their gates run in the ranks.
    cs.bucket_entry = lambda *a, **k: {}
    took = {}
    for name, fn in (('5', cs.phase_kaisa),
                     ('17', cs.phase_resnet50_pipelined),
                     ('31b', cs.phase_resnet50_placement)):
        t0 = time.perf_counter()
        fn(torch, kt)
        took[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload = audit.run_audit(8, device='cuda', timeout=600)
    took['audit lanes'] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, 'w') as fh:
        json.dump(payload, fh)
    print(audit.format_payload(payload), flush=True)
    for lane, lp in payload['lanes'].items():
        print(f'audit lanes {lane}: '
              + json.dumps(audit.lane_summary(lp)), flush=True)
    print('seconds: ' + ', '.join(f'{k} {v:.2f}' for k, v in took.items()),
          flush=True)
    print(card, flush=True)
    return 0 if payload['verified'] else 1


if __name__ == '__main__':
    sys.exit(main())
