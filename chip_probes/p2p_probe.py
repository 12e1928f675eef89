#!/usr/bin/env python3
"""Which point-to-point hand-off gloo takes on CUDA tensors.

Run from the root of the repository on one CUDA card::

    python3 chip_probes/p2p_probe.py

Four ranks share ``cuda:0`` over gloo, as ``chip_smoke.py``'s
multi-process phases do.  Each rank tries, on a CUDA tensor of one
GPT-125M GPipe activation (``1 x 2048 x 768`` f32, 6 MiB):

* ``send``/``recv`` from rank ``s`` to ``s + 1`` (``isend``/``irecv``
  waited with a time limit, so a refusal on one side cannot hang the
  other);
* ``broadcast`` with ``src = s`` over the two-rank group ``{s, s + 1}``,
  one group per edge, made once in the same order on every rank.

It prints one line per rank and edge (``ok`` with the received
checksum and the hand-off's median milliseconds, or the error) and, as
its last line, a JSON object ``{"send_recv": bool, "pair_broadcast":
bool}``: whether every edge took each form.  The pipeline module picks
its hand-off from the backend, never from a failure; this probe is the
record behind that choice.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import statistics
import sys
import tempfile
import time

WORLD = 4
SHAPE = (1, 2048, 768)
REPS = 5
TIMEOUT = datetime.timedelta(seconds=20)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _edge_tensor(torch, rank: int, src: int):
    value = float(src + 1) if rank == src else 0.0
    return torch.full(SHAPE, value, device='cuda:0')


def _try(torch, fn) -> dict:
    times = []
    try:
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return {'ok': True, 'sum': float(out.sum()),
                'ms': statistics.median(times)}
    except Exception as exc:  # noqa: BLE001 - the probe records refusals
        return {'ok': False, 'error': f'{type(exc).__name__}: {exc}'[:300]}


def rank_main(rank: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            world_size=WORLD, rank=rank, timeout=TIMEOUT)
    pairs = [dist.new_group([s, s + 1]) for s in range(WORLD - 1)]
    result = {}
    for s in range(WORLD - 1):
        if rank not in (s, s + 1):
            continue

        def send_recv(s=s):
            t = _edge_tensor(torch, rank, s)
            work = (dist.isend(t, s + 1) if rank == s
                    else dist.irecv(t, s))
            work.wait(TIMEOUT)
            return t

        def pair_broadcast(s=s):
            t = _edge_tensor(torch, rank, s)
            dist.broadcast(t, s, group=pairs[s])
            return t

        result[f'send_recv {s}->{s + 1}'] = _try(torch, send_recv)
        result[f'pair_broadcast {s}->{s + 1}'] = _try(torch, pair_broadcast)
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(result, f)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print('this probe needs a CUDA card', file=sys.stderr)
        return 1
    out_dir = tempfile.mkdtemp(prefix='p2p_probe_')
    port = _free_port()
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=rank_main, args=(r, port, out_dir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.time() + 180
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    verdict = {'send_recv': True, 'pair_broadcast': True}
    for r in range(WORLD):
        path = os.path.join(out_dir, f'rank{r}.json')
        if not os.path.exists(path):
            print(f'rank {r}: no result (exit {procs[r].exitcode})')
            verdict = {k: False for k in verdict}
            continue
        with open(path) as f:
            for name, res in json.load(f).items():
                print(f'rank {r} {name}: {res}', flush=True)
                key = name.split()[0]
                verdict[key] = verdict[key] and res['ok']
    print(json.dumps(verdict), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
