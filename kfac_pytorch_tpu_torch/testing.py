"""Fault injectors for the robustness subsystems (testing and drills).

Port of the injectors of ``kfac_pytorch_tpu/testing.py``:
:func:`bitflip` (one flipped bit, the silent-data-corruption model),
:func:`desync_replica` (a corruption on one rank only),
:func:`poison_factors` (non-finite or scaled factor EMAs),
:func:`eigh_failure_config` (a :class:`~kfac_pytorch_tpu_torch.health.\
HealthConfig` that forces decomposition failures), :func:`nan_batch` (a
NaN input), :func:`bad_batch_span` (a finite bad-data span, the
watchdog's fault), and the storage faults :func:`torn_jsonl` and
:func:`corrupt_checkpoint` (a save cut off mid-write).  The JAX package
threads its state through functions, so its injectors return a new
state; the port's state lives in the preconditioner, so
:func:`poison_factors` and :func:`desync_slot` write into it.

The multi-process helpers of the JAX module (``testing.py:508-648``):
:func:`free_port`, :func:`spawn_ranks` (real separate interpreters with
the ``torch.distributed`` environment), :func:`wait_ranks` (bounded) and
:func:`kill_rank` (the rank-death injector of
:mod:`~kfac_pytorch_tpu_torch.runtime`), and :func:`plain_step_flops`
(``testing.py:462``) over :func:`~kfac_pytorch_tpu_torch.observe.costs.\
step_variant_costs`.  The JAX module's virtual-device helpers have no
torch counterpart.
"""
from __future__ import annotations

import math
import os
import signal
import socket
import subprocess
import threading
import time
from typing import Any, Callable

import numpy as np

import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch.health import HealthConfig

__all__ = [
    'bad_batch_span',
    'bitflip',
    'corrupt_checkpoint',
    'desync_replica',
    'desync_slot',
    'eigh_failure_config',
    'free_port',
    'kill_rank',
    'nan_batch',
    'plain_step_flops',
    'poison_factors',
    'spawn_ranks',
    'torn_jsonl',
    'wait_ranks',
]


def bitflip(t: torch.Tensor, index: int = 0, bit: int = 20) -> torch.Tensor:
    """Copy of an f32 tensor with one bit of element ``index`` (flat,
    modulo the size) flipped; ``bit=20`` perturbs the value by a relative
    ~2^-3, and nothing overflows."""
    out = t.detach().to(torch.float32).clone().contiguous()
    view = out.reshape(-1).view(torch.int32)
    i = index % max(view.numel(), 1)
    mask = 1 << bit
    if bit == 31:  # the sign bit, as an int32 value
        mask = -(1 << 31)
    view[i] ^= mask
    return out


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def desync_replica(
    t: torch.Tensor,
    replica: int,
    fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """``fn(t)`` (default :func:`bitflip`) on rank ``replica``, ``t`` on
    every other rank: one rank's copy of a replicated tensor (or of its
    column's slot of a bucket stack) silently diverges.  Every rank calls
    it with the same arguments; only the owner's buffer changes."""
    if fn is None:
        fn = bitflip
    if _rank() != replica:
        return t
    return fn(t).to(dtype=t.dtype, device=t.device)


def poison_factors(
    precond: Any,
    bases: str | tuple[str, ...],
    value: float = float('nan'),
    sides: str = 'ag',
    *,
    replica: int | None = None,
    scale: float | None = None,
) -> Any:
    """Overwrite the A (``'a' in sides``) and/or G factor EMA of each
    named layer of ``precond`` with ``value`` (default NaN), or with
    ``scale`` multiply it (the finite mode).  ``replica`` restricts the
    change to that rank's copy (:func:`desync_replica`).  Returns
    ``precond``."""
    if isinstance(bases, str):
        bases = (bases,)
    if scale is not None:
        if not math.isfinite(scale):
            raise ValueError(
                'poison_factors(scale=...) is the FINITE poisoning '
                f'mode; got scale={scale!r}',
            )
        if not (isinstance(value, float) and math.isnan(value)):
            raise ValueError(
                'poison_factors: pass either value= (overwrite mode) '
                'or scale= (finite multiply mode), not both',
            )

    def poisoned(factor):
        def fn(f):
            return f * scale if scale is not None else torch.full_like(
                f, value)
        if replica is None:
            return fn(factor)
        return desync_replica(factor, replica, fn)

    for base in bases:
        st = precond.layers[base]
        if 'a' in sides:
            st.a_factor = poisoned(st.a_factor)
        if 'g' in sides:
            st.g_factor = poisoned(st.g_factor)
    return precond


def desync_slot(
    precond: Any,
    key: str,
    slot: int,
    field: str = 'qa',
    replica: int = 0,
    fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> Any:
    """Rewrite global slot ``slot`` of bucket ``key``'s ``field`` stack by
    ``fn`` (default :func:`bitflip`) on rank ``replica`` only, which must
    hold that slot (its grid column); the other ranks keep theirs.
    Returns ``precond``."""
    if fn is None:
        fn = bitflip
    if _rank() != replica:
        return precond
    seg = precond.plan.bucket(key).seg
    local = slot - precond.grid.col * seg
    if not 0 <= local < seg:
        raise ValueError(
            f'rank {replica} holds column {precond.grid.col} of bucket '
            f'{key!r}, not slot {slot}',
        )
    bs = precond.buckets[key]
    stack = getattr(bs, field).clone()
    stack[local] = fn(stack[local]).to(stack.dtype)
    setattr(bs, field, stack)
    return precond


def eigh_failure_config(
    precond: Any = None,
    layers: tuple[str, ...] | None = None,
    attempts: int = 99,
    **overrides: Any,
) -> HealthConfig:
    """A :class:`HealthConfig` that forces decomposition failures.

    ``layers`` (names) become the ``(bucket, slot)`` pairs of
    ``precond.plan.slot_of`` (so ``precond`` is needed); ``None`` fails
    every slot.  ``attempts=1`` fails only the first attempt (recovery
    by the first retry); more than ``max_eigh_retries`` fails every
    attempt (fallback, then quarantine)."""
    inject_layers = None
    if layers is not None:
        if precond is None:
            raise ValueError(
                'eigh_failure_config needs the preconditioner to map '
                'layer names to bucket slots',
            )
        inject_layers = tuple(precond.plan.slot_of[name] for name in layers)
    return HealthConfig(
        inject_eigh_failures=attempts,
        inject_eigh_layers=inject_layers,
        **overrides,
    )


def nan_batch(
    x: torch.Tensor,
    index: Any = (0,),
    *,
    replica: int | None = None,
    world: int | None = None,
) -> torch.Tensor:
    """A copy of ``x`` with a NaN at ``index`` (JAX ``testing.py:
    130-165``): one element reaches the loss, every gradient and every
    factor contribution, as a corrupt record would.  ``replica`` offsets
    the leading index into replica ``replica``'s block of a ``world``-way
    split of the batch, so only that rank's share carries it."""
    if replica is not None:
        if world is None:
            raise ValueError('nan_batch(replica=...) needs world=')
        if x.shape[0] % world != 0:
            raise ValueError(
                f'batch dim {x.shape[0]} does not split over world={world}',
            )
        if not 0 <= replica < world:
            raise ValueError(f'replica {replica} out of range [0, {world})')
        shard = x.shape[0] // world
        index = (replica * shard + index[0],) + tuple(index[1:])
    out = x.clone()
    out[tuple(index)] = float('nan')
    return out


def bad_batch_span(
    start: int,
    steps: int,
    *,
    scale: float | None = 50.0,
    label_shuffle: bool = False,
    seed: int = 0,
) -> Callable[[int, torch.Tensor, torch.Tensor],
              tuple[torch.Tensor, torch.Tensor]]:
    """A step-indexed finite bad-data injector (JAX ``testing.py:
    168-220``): ``corrupt(step, x, y)`` returns, for ``start <= step <
    start + steps``, the inputs times ``scale`` and/or the labels
    permuted (``label_shuffle``, seeded by ``seed + step`` with numpy, so
    the JAX and port drills draw the same permutation), and outside the
    span ``x`` and ``y`` themselves.  Every value stays finite and every
    rank sees the same damage, so health and the consistency guard pass
    it; only the trajectory watchdog sees it."""
    if steps < 1:
        raise ValueError('steps must be >= 1')
    if scale is None and not label_shuffle:
        raise ValueError(
            'bad_batch_span needs scale and/or label_shuffle — an injector '
            'that changes nothing would make every drill built on it '
            'vacuous',
        )

    def corrupt(step: int, x: torch.Tensor, y: torch.Tensor):
        if not start <= step < start + steps:
            return x, y
        if scale is not None:
            x = x * scale
        if label_shuffle:
            perm = np.random.default_rng(seed + step).permutation(y.shape[0])
            y = y[torch.as_tensor(perm, device=y.device)]
        return x, y

    return corrupt


def torn_jsonl(path: str, drop_bytes: int = 8) -> int:
    """Cut a JSONL file inside its last record, as a killed writer leaves
    it (JAX ``testing.py:409-434``): ``drop_bytes`` from the end, keeping
    at least one byte of the last record.  Returns the bytes removed."""
    size = os.path.getsize(path)
    with open(path, 'rb') as fh:
        data = fh.read()
    stripped = data.rstrip(b'\n')
    if not stripped:
        raise ValueError(f'{path!r} has no record to tear')
    last_start = stripped.rfind(b'\n') + 1
    keep = max(last_start + 1, len(stripped) - drop_bytes)
    keep = min(keep, len(stripped) - 1)
    with open(path, 'r+b') as fh:
        fh.truncate(keep)
    return size - keep


def corrupt_checkpoint(path: str, keep_fraction: float = 0.25) -> int:
    """Truncate every non-empty file under ``path`` to ``keep_fraction``
    of its bytes, a save that died mid-write (JAX ``testing.py:
    437-459``); a monolithic checkpoint then fails to load and a streaming
    generation its manifest check.  Returns the files touched."""
    n = 0
    for root, _, files in os.walk(path):
        for name in files:
            fp = os.path.join(root, name)
            size = os.path.getsize(fp)
            if size == 0:
                continue
            with open(fp, 'r+b') as fh:
                fh.truncate(max(1, int(size * keep_fraction)))
            n += 1
    if n == 0:
        raise ValueError(f'no files to corrupt under {path!r}')
    return n


def plain_step_flops(
    model: torch.nn.Module,
    x: torch.Tensor,
    y: torch.Tensor,
    fraction: float = 1.0,
) -> float:
    """FLOPs of one K-FAC plain step (no factor update, no refresh) of
    ``model`` on ``(x, y)`` with a cross-entropy loss at KAISA fraction
    ``fraction`` of the current ``torch.distributed`` world: the forward,
    the backward and the precondition, counted by
    :func:`~kfac_pytorch_tpu_torch.observe.costs.step_variant_costs` (the
    fused kernel's FLOPs from its shapes).  The preconditioner is the JAX
    helper's (factor 10, inv 100, damping 0.003, lr 0.1); the model's
    ``.grad`` is left holding the step's preconditioned gradients."""
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch.observe.costs import step_variant_costs
    from kfac_pytorch_tpu_torch.preconditioner import KFACPreconditioner

    precond = KFACPreconditioner(
        model, factor_update_steps=10, inv_update_steps=100,
        damping=0.003, lr=0.1, grad_worker_fraction=fraction,
    )

    def forward_backward():
        model.zero_grad()
        F.cross_entropy(model(x), y).backward()

    return step_variant_costs(precond, forward_backward)['plain']['flops']


# ----------------------------------------------------------------------
# multi-process rank injectors (kfac_pytorch_tpu_torch/runtime.py)
# ----------------------------------------------------------------------


def free_port() -> int:
    """An OS-assigned free localhost TCP port (the coordinator's)."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def spawn_ranks(
    n: int,
    argv: list[str],
    *,
    coordinator: str | None = None,
    extra_env: dict[str, str] | None = None,
    cwd: str | None = None,
    capture: bool = True,
) -> tuple[list[subprocess.Popen], str]:
    """Spawn ``n`` localhost ranks of a ``torch.distributed`` world, each
    a separate interpreter running ``argv``, with the world in the
    environment: ``MASTER_ADDR``/``MASTER_PORT`` and ``KFAC_COORD``
    (``host:port``, an OS-assigned free port unless ``coordinator`` is
    given), ``KFAC_NPROCS`` and ``WORLD_SIZE``, and per rank
    ``KFAC_RANK`` and ``RANK`` — what a
    :class:`~kfac_pytorch_tpu_torch.runtime.RuntimeConfig` is built from.
    Returns ``(procs, coordinator)``; the caller owns the processes
    (:func:`wait_ranks`, :func:`kill_rank`)."""
    if n < 1:
        raise ValueError(f'need n >= 1 ranks, got {n}')
    if coordinator is None:
        coordinator = f'127.0.0.1:{free_port()}'
    host, _, port = coordinator.rpartition(':')
    base = dict(os.environ)
    base.update(MASTER_ADDR=host, MASTER_PORT=port, KFAC_COORD=coordinator,
                KFAC_NPROCS=str(n), WORLD_SIZE=str(n))
    if extra_env:
        base.update(extra_env)
    procs = []
    for rank in range(n):
        env = dict(base, KFAC_RANK=str(rank), RANK=str(rank))
        procs.append(subprocess.Popen(
            argv,
            env=env,
            cwd=cwd,
            stdout=subprocess.PIPE if capture else None,
            stderr=subprocess.STDOUT if capture else None,
            text=capture,
        ))
    return procs, coordinator


def wait_ranks(
    procs: list[subprocess.Popen],
    timeout_s: float = 600.0,
) -> list[tuple[int, str]]:
    """Bounded wait for every rank; a rank still alive at the deadline is
    SIGKILLed and reported with its (negative) return code.  Returns
    ``[(returncode, captured_output), ...]`` in rank order."""
    deadline = time.monotonic() + timeout_s
    results: list[tuple[int, str]] = []
    for proc in procs:
        remaining = max(0.1, deadline - time.monotonic())
        try:
            out, _ = proc.communicate(timeout=remaining)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        results.append((proc.returncode, out or ''))
    return results


def kill_rank(
    pid: int,
    when: float | Callable[[], bool] | None = None,
    *,
    sig: int = signal.SIGKILL,
    poll_s: float = 0.05,
) -> threading.Event:
    """SIGKILL a rank: now (``when=None``), after ``when`` seconds, or
    once the zero-argument callable ``when`` returns true (polled every
    ``poll_s``).  Returns an event set once the signal is sent (or the
    process was already gone).  A rank may kill itself with
    ``kill_rank(os.getpid())``."""
    done = threading.Event()

    def _kill() -> None:
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass
        done.set()

    if when is None:
        _kill()
        return done

    def _run() -> None:
        if callable(when):
            while not when():
                time.sleep(poll_s)
        else:
            time.sleep(float(when))
        _kill()

    threading.Thread(
        target=_run, name=f'kfac-kill-rank-{pid}', daemon=True,
    ).start()
    return done
