#!/usr/bin/env python3
"""The fused kernel of two checkouts of the repository timed in turns on
one CUDA card: the parent, then this checkout twice, then the parent.

Run from the root of the repository, with the parent's tree unpacked
into a directory that ``.gitignore`` lists::

    git archive <parent> | (mkdir -p logs/parent && tar -x -C logs/parent)
    python3 chip_probes/kernel_ab.py logs/parent [L,gp,ap ...]

Each turn is a fresh process that imports the tree's own package and
``chip_smoke.py``, builds its kernels, and prints one JSON line:
ResNet-32's six bucket calls issued one by one and as one CUDA graph
(``chip_smoke.time_ms``/``graph_ms``, the ``kernel:`` line's numbers),
the host microseconds of a call through the custom op and of the direct
launch (``chip_smoke.op_host_cost``), and the ms of a call at each shape
given (``chip_smoke.make_case`` operands in f32, then cast to bf16: keys
``L,gp,ap`` and ``L,gp,ap bf16``), issued one by one and replayed as a
CUDA graph (``... graph``: device time without the host's cost of
issuing the call, which decides the eager time of the small calls).  Nothing is checked here:
``chip_smoke.py`` holds each tree's kernel against its plain version.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

TURN = r'''
import contextlib, io, json, os, sys
root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from kfac_pytorch_tpu_torch.ops import _build
from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition as kernel
import kfac_pytorch_tpu_torch as kt
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
calls = []
for i, shape in enumerate(cs.MAIN_PATH_CASES):
    args = cs.make_case(torch, *shape, seed=100 + i)
    calls.append(lambda a=args: kernel(*a))
out['resnet32_ms'] = sum(cs.time_ms(torch, c) for c in calls)
out['resnet32_graph_ms'] = cs.graph_ms(torch, calls)
with contextlib.redirect_stdout(io.StringIO()):
    host = cs.op_host_cost(torch, kt)
out['op_host_us'] = sum(host['op']) / len(host['op'])
out['direct_host_us'] = sum(host['direct']) / len(host['direct'])
for arg in sys.argv[2:]:
    shape = tuple(int(x) for x in arg.split(','))
    args = cs.make_case(torch, *shape, seed=7)
    for key in (arg, arg + ' bf16'):
        if key.endswith('bf16'):
            args = [a.to(torch.bfloat16) for a in args]
        out[key] = cs.time_ms(torch, lambda: kernel(*args))
        out[key + ' graph'] = cs.graph_ms(torch, [lambda: kernel(*args)])
    del args
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


def main(argv):
    parent, shapes = argv[0], argv[1:]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, tree in (('parent', parent), ('change', here),
                       ('change', here), ('parent', parent)):
        proc = subprocess.run([sys.executable, '-c', TURN, tree, *shapes],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(name, 'failed:', proc.stderr[-3000:], flush=True)
            return 1
        print(name, proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main(sys.argv[1:]))
