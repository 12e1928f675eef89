#!/usr/bin/env python3
"""Which faults the trajectory watchdog's signals can see on ResNet-50.

Run from the root of the repository on one CUDA card::

    python3 chip_probes/watchdog_fault_survey.py

It builds the kernels, then trains ``chip_smoke.py``'s phase 23
configuration (ImageNet ResNet-50, b32 at 224x224, f32, factor 1, inv 4)
for 14 steps with no watchdog under each fault of :data:`WATCH_SURVEY`,
and prints the loss and ``vg_sum`` of every step, beside the card's name
and power limit.  It is the survey behind phase 23's choice of fault and
checks nothing.
"""
from __future__ import annotations

import gc
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

#: label -> (hyperparameter changes, fault).
WATCH_SURVEY = {
    'clean': ({}, None),
    'inputs x50 at steps 9-11': ({}, ('span', dict(scale=50.0))),
    'labels shuffled at steps 9-11': (
        {}, ('span', dict(scale=None, label_shuffle=True))),
    'factor EMAs x1e-4 before step 8': ({}, ('poison', 1e-4)),
    'factor EMAs x1e-4 before step 8, factor 3': (
        dict(factor_update_steps=3), ('poison', 1e-4)),
    'factor EMAs x1e-4 before step 8, kl_clip None': (
        dict(kl_clip=None), ('poison', 1e-4)),
}


def survey_watchdog_faults(torch, kt):
    """The loss and ``vg_sum`` of every step under each fault."""
    import torch.nn.functional as F

    x, y = cs.rn50_batch(torch)
    y = y % cs.ELASTIC_MODEL[1]
    for label, (change, fault) in WATCH_SURVEY.items():
        hp = dict(cs.RN50_WATCH_HP, **change)
        model, opt, precond = cs.elastic_model(torch, kt, hp, seed=0)
        loop = precond.train_loop(opt, F.cross_entropy)
        span = (kt.testing.bad_batch_span(9, 3, **fault[1])
                if fault and fault[0] == 'span' else None)
        losses, vgs = [], []
        for t in range(14):
            xb, yb = span(t, x, y) if span else (x, y)
            if (fault and fault[0] == 'poison'
                    and t == cs.RN50_WATCH_POISON[0]):
                kt.testing.poison_factors(precond, tuple(precond.layers),
                                          scale=fault[1])
            loss, _ = loop.step(xb, loss_args=(yb,))
            losses.append(float(f'{float(loss):.4g}'))
            vgs.append(float(f'{float(precond.last_step_info["vg_sum"]):.4g}'))
        print(f'watchdog fault survey, {label}: losses {losses}; vg_sum '
              f'{vgs}', flush=True)
        del loop, opt, precond, model
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        cs.fail('no CUDA card: the survey runs on the card only')
    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.ops import _build

    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    survey_watchdog_faults(torch, kt)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
