"""The deferred refresh of ``overlap_comm``, run off the step.

The JAX package defers a due refresh into the next step's compiled
program, where XLA brackets the step's forward and backward with the
refresh's async collective pairs (``kfac_pytorch_tpu/engine.py:1446-1461``).
The port runs eagerly, so it gets the overlap the way the original torch
library did: a side CUDA stream and ``torch.distributed`` work handles.

*Issue point.*  The end of step ``R``'s ``step()``, after the
precondition and after the step counter moved to ``R + 1`` (so the
refresh takes step ``R + 1``'s damping, as the JAX deferred refresh reads
the hyperparameters of the program it runs in).  The refresh then runs
while the caller's optimizer step and step ``R + 1``'s forward and
backward are enqueued.

*Collect point.*  The top of step ``R + 1``'s ``step()``, before the
factor update and the precondition: :meth:`DeferredRefresh.wait` joins
the worker, makes the current stream wait on the side stream's last
event, and hands the new state to the engine, which installs it.

*Why a worker thread.*  ``torch.linalg.eigh`` checks its ``infos`` on the
host, so on CUDA it synchronizes (with the side stream, where it runs).
Issued from the main thread, the host would block there until the side
stream finished, and step ``R + 1``'s kernels would be enqueued only
afterwards: nothing would overlap.  A worker thread blocks instead, and
torch releases the GIL inside those calls, so the main thread goes on
enqueueing.  Grad mode, the current device and the current stream are
thread-local, so the worker sets each of them itself.

*Inputs and memory.*  The engine snapshots the factor references at the
issue point (the factor update rebinds them, never writes them in place)
and builds the new state into new objects; nothing step ``R + 1`` reads
before the collect point is written early.  The side stream waits on the
current stream at the issue point, so it reads finished EMAs; the input
references live until the collect point, after which the current stream
has waited on the side stream; every tensor the refresh hands over gets
``record_stream`` on the collecting stream, so the caching allocator
reuses none of it under a live kernel.

*Collectives.*  The worker issues none.  It decomposes the rank's
shares; the column gather runs in :meth:`DeferredRefresh.wait` through
``finish``, on the collecting thread (the main thread at the collect
point), after the side stream's work.  NCCL asks that kernels of
different communicators be launched in the same order on every rank.
Issued from the worker, the gathers raced the main thread's DDP
all-reduce over the world, and the collective audit
(``analysis/audit.py``, lane ``hybrid_overlap``) recorded ranks that
interleaved the two differently; at the collect point every rank issues
them at the same place in its sequence.  The values are the same, so
the one-step shift is unchanged bit for bit.

On the CPU the worker thread runs the same code with no stream.  A
refresh that raises in the worker raises again at the collect point.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import torch


class DeferredRefresh:
    """One deferred refresh in flight: ``fn()`` runs on a worker thread
    (on ``stream`` when it is a CUDA stream) and returns the new state;
    :meth:`wait` joins it and returns that state, ordered after the side
    stream's work on the caller's current stream."""

    def __init__(
        self,
        fn: Callable[[], Any],
        device: torch.device,
        stream: Any = None,
        finish: Callable[[Any], Any] | None = None,
    ) -> None:
        self._device = device
        self._stream = stream
        self._finish = finish
        self._result: Any = None
        self._error: BaseException | None = None
        self._event = None
        if stream is not None:
            # The side stream starts after everything the current stream
            # has enqueued: the factor EMAs it reads are finished.
            stream.wait_stream(torch.cuda.current_stream(device))
        self._thread = threading.Thread(
            target=self._run, args=(fn,), name='kfac-deferred-refresh',
            daemon=True,
        )
        self._thread.start()

    def _run(self, fn: Callable[[], Any]) -> None:
        try:
            if self._stream is None:
                scope = contextlib.nullcontext()
            else:
                scope = contextlib.ExitStack()
                scope.enter_context(torch.cuda.device(self._device))
                scope.enter_context(torch.cuda.stream(self._stream))
            with scope, torch.no_grad():
                self._result = fn()
                if self._stream is not None:
                    self._event = torch.cuda.Event()
                    self._event.record(self._stream)
        except BaseException as exc:  # re-raised at the collect point
            self._error = exc

    def join(self) -> None:
        """Wait for the worker to return; an error it raised is kept for
        :meth:`wait`."""
        self._thread.join()

    def wait(self) -> Any:
        """Join the worker and return its state, passed through
        ``finish`` on this thread when one was given; raises if the
        refresh raised."""
        self._thread.join()
        if self._error is not None:
            raise RuntimeError(
                'the deferred refresh (overlap_comm) failed on its side '
                f'{"stream" if self._stream is not None else "thread"}',
            ) from self._error
        if self._stream is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(self._event)
            for t in tensors_of(self._result):
                if t.device.type == 'cuda':
                    t.record_stream(current)
        if self._finish is not None:
            self._result, self._finish = self._finish(self._result), None
        return self._result


def tensors_of(tree: Any) -> list[torch.Tensor]:
    """Every tensor in nested dicts, lists, tuples and objects with a
    ``tensors()`` method (the bucket stacks)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, 'tensors') and callable(tree.tensors):
        return list(tree.tensors().values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []
