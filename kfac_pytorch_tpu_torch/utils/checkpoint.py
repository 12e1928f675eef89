"""Monolithic preconditioner checkpoints: atomic saves, restore-time
validation, a retain-last-K rotation and the fallback walk.

Port of ``kfac_pytorch_tpu/utils/checkpoint.py``.  The JAX package
writes an orbax pytree; here a checkpoint is a directory
``ckpt-<step>/`` holding one file, ``torch.save`` of the preconditioner's
:meth:`~kfac_pytorch_tpu_torch.engine.KFACEngineMixin.state_dict`, read
back with ``torch.load(weights_only=True)``.  The names, the rotation and
the fallback walk are the JAX package's:

* :func:`save_preconditioner` publishes atomically (a sibling temp
  directory, ``os.replace``, a directory fsync), so a save killed
  mid-write leaves the previous checkpoint or nothing under the final
  name, never half of one;
* :func:`validate_payload` checks a payload before it loads: the keys,
  a finite positive damping, each layer's factor shapes (the error
  names the layer) and, by default, every factor's finiteness;
* :func:`save_rotating` keeps the last ``retain`` members under one
  directory;
* :func:`restore_latest_valid` walks the rotation newest first and
  restores the first member that loads, validates and installs; a torn,
  corrupt or poisoned member is skipped with a warning and a
  ``'checkpoint_fallback'`` event (:func:`~kfac_pytorch_tpu_torch.\
tracing.count_event`), and a failed candidate leaves the preconditioner
  as it was (:func:`snapshot_host_state`).

Across ``torch.distributed`` ranks every rank holds the same averaged
factor EMAs, so one rank writes: every rank calls
:func:`save_preconditioner` (``state_dict(include_ekfac_scales=True)``
gathers over the grid row) and rank 0 alone writes, then all meet at a
barrier, so the member exists for every rank when the call returns.
:func:`restore_latest_valid` lets rank 0 probe the rotation and
broadcasts its choice (``broadcast_object_list``), so every rank loads
the same member even when one rank's view of the storage is torn.

The streaming generations of :mod:`kfac_pytorch_tpu_torch.elastic`
(per-bucket shards, a restore without the decomposition recompute, a
world-size resize) bridge to this format through
:func:`~kfac_pytorch_tpu_torch.elastic.restore_any`.
"""
from __future__ import annotations

import dataclasses
import glob
import logging
import os
import random
import re
import shutil
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch import tracing

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r'^ckpt-(\d+)$')
#: The one file of a checkpoint directory.
PAYLOAD_NAME = 'preconditioner.pt'


class CheckpointValidationError(ValueError):
    """A checkpoint payload failed restore-time integrity validation."""


def _distributed() -> bool:
    """Whether ``torch.distributed`` runs more than one rank (the
    checkpoint modules' one test of it)."""
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _rank() -> int:
    return dist.get_rank() if _distributed() else 0


def retry_transient_save(
    fn: Callable[[], Any],
    *,
    retries: int = 3,
    base_delay: float = 0.05,
    jitter: float = 0.5,
    label: str = 'checkpoint save',
    sleep: Callable[[float], None] = time.sleep,
    deadline_s: float | None = None,
    clock: Callable[[], float] = time.monotonic,
) -> Any:
    """Run a save under bounded retries with jittered backoff (JAX
    ``utils/checkpoint.py:71-156``).

    An ``OSError`` (a flaky mount, a transient ``EIO``) retries up to
    ``retries`` times after ``base_delay * 2**attempt`` seconds, widened
    by up to ``jitter`` so hosts sharing a mount do not retry in
    lockstep.  The last failure skips the save: a
    ``'checkpoint_save_failed'`` event is counted, the error logged, and
    ``None`` returned, so the training loop goes on and the next
    scheduled save tries again.  Any other exception propagates (a shape
    or validation error is a bug, not weather).  ``deadline_s`` caps the
    whole call, attempts and sleeps included, so a wedged filesystem
    cannot eat a preemption notice.  Both savers publish atomically, so
    rerunning a whole save body is safe.
    """
    if retries < 0:
        raise ValueError('retries must be >= 0')
    if deadline_s is not None and deadline_s <= 0:
        raise ValueError('deadline_s must be > 0 (or None)')
    deadline = None if deadline_s is None else clock() + deadline_s
    last: OSError | None = None
    gave_up = ''
    attempts_made = 0
    for attempt in range(retries + 1):
        attempts_made = attempt + 1
        try:
            return fn()
        except OSError as exc:
            last = exc
            if deadline is not None and clock() >= deadline:
                gave_up = f' (total deadline {deadline_s:.1f}s exceeded)'
                break
            if attempt < retries:
                delay = base_delay * (2 ** attempt)
                delay *= 1.0 + jitter * random.random()
                if deadline is not None:
                    delay = min(delay, max(0.0, deadline - clock()))
                logger.warning(
                    '%s failed with transient %s: %s — retry %d/%d in '
                    '%.2fs', label, type(exc).__name__, exc, attempt + 1,
                    retries, delay,
                )
                sleep(delay)
    tracing.count_event('checkpoint_save_failed')
    logger.error(
        '%s failed after %d attempt(s)%s; SKIPPING this save (the run '
        'continues; the next scheduled save will retry): %s',
        label, attempts_made, gave_up, last,
    )
    return None


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename within it survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without O_RDONLY directory opens
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _barrier() -> None:
    if _distributed():
        dist.barrier()


def save_preconditioner(
    path: str,
    precond: Any,
    include_factors: bool = True,
    compress_symmetric: bool = False,
    include_ekfac_scales: bool = False,
) -> str:
    """Write ``precond.state_dict(...)`` to the directory ``path``.

    The payload is written into a sibling temp directory, fsynced, and
    published by one ``os.replace`` and a parent-directory fsync.  Every
    rank calls this; rank 0 writes, and all ranks meet at a barrier
    before it returns."""
    path = os.path.abspath(path)
    payload = precond.state_dict(
        include_factors=include_factors,
        compress_symmetric=compress_symmetric,
        include_ekfac_scales=include_ekfac_scales,
    )
    if _rank() == 0:
        _publish_payload(path, payload)
    _barrier()
    return path


def _publish_payload(path: str, payload: Any) -> None:
    tmp = f'{path}.tmp-{os.getpid()}'
    if os.path.isdir(tmp):  # left by a killed save of this process
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, PAYLOAD_NAME), 'wb') as fh:
        torch.save(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())
    # From here on the new payload is complete at ``tmp``; on a failure
    # below ``tmp`` stays (it may be the only complete copy).
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    # Temp trees of earlier killed saves of this path, reclaimed only
    # once the new tree is published.
    for stale in glob.glob(f'{glob.escape(path)}.tmp-*'):
        shutil.rmtree(stale, ignore_errors=True)


def load_payload(path: str) -> dict:
    """A checkpoint directory's payload (``torch.load(weights_only=True)``
    on the CPU)."""
    return torch.load(os.path.join(os.path.abspath(path), PAYLOAD_NAME),
                      map_location='cpu', weights_only=True)


def restore_preconditioner(
    path: str,
    precond: Any,
    compute_inverses: bool = True,
) -> None:
    """Load a checkpoint written by :func:`save_preconditioner`; the
    decompositions are recomputed from the loaded factor EMAs when
    ``compute_inverses`` (collective across ranks)."""
    precond.load_state_dict(load_payload(path),
                            compute_inverses=compute_inverses)


# -- integrity: validation, rotation, fallback ------------------------------


def _as_array(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def validate_payload(
    payload: Any,
    precond: Any,
    check_finite: bool = True,
) -> None:
    """Restore-time validation of a state-dict payload (JAX
    ``utils/checkpoint.py:258-340``): the ``steps`` counter, a finite
    positive damping (a saved ``damping=0`` would poison the first
    refresh), every layer registered and of the live factor shapes (the
    error names the layer) and, with ``check_finite``, every factor
    finite.

    Raises:
        CheckpointValidationError: naming the failing check and layer.
    """
    from kfac_pytorch_tpu_torch.engine import validate_saved_factor_shapes
    from kfac_pytorch_tpu_torch.hyperparams import validate_damping

    if not isinstance(payload, dict):
        raise CheckpointValidationError(
            f'checkpoint payload is {type(payload).__name__}, expected a '
            'state dict',
        )
    if 'steps' not in payload:
        raise CheckpointValidationError(
            "checkpoint payload is missing the 'steps' counter",
        )
    try:
        int(payload['steps'])
    except (TypeError, ValueError) as exc:
        raise CheckpointValidationError(
            f'checkpoint steps counter is not an integer: {exc}',
        ) from exc
    if 'damping' in payload:
        try:
            validate_damping(payload['damping'], origin='saved damping')
        except (TypeError, ValueError) as exc:
            raise CheckpointValidationError(str(exc)) from exc
    layers = payload.get('layers')
    if layers is None:
        return
    if not isinstance(layers, dict):
        raise CheckpointValidationError(
            "checkpoint 'layers' entry is not a mapping",
        )
    registered = precond._checkpoint_layer_states()
    unknown = set(layers) - set(registered)
    if unknown:
        raise CheckpointValidationError(
            f'checkpoint contains unregistered layers {sorted(unknown)}',
        )
    try:
        validate_saved_factor_shapes(layers, registered)
    except ValueError as exc:
        raise CheckpointValidationError(str(exc)) from exc
    if not check_finite:
        return
    for base, factors in layers.items():
        if not isinstance(factors, dict):
            raise CheckpointValidationError(
                f'checkpoint entry for layer {base!r} is not a mapping',
            )
        for key in ('A', 'G'):
            packed = factors.get(key)
            if packed is None:
                continue
            arr = (packed['triu'] if isinstance(packed, dict)
                   and 'triu' in packed else packed)
            if not np.isfinite(_as_array(arr)).all():
                raise CheckpointValidationError(
                    f'checkpoint factor {key} of layer {base!r} contains '
                    'non-finite values — refusing to restore a poisoned '
                    'factor EMA',
                )


def list_checkpoints(directory: str) -> list[str]:
    """Rotation members of ``directory``, oldest first (by step)."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return [path for _, path in sorted(found)]


def save_rotating(
    directory: str,
    precond: Any,
    *,
    step: int | None = None,
    retain: int = 3,
    include_factors: bool = True,
    compress_symmetric: bool = False,
    include_ekfac_scales: bool = False,
) -> str | None:
    """Save ``<directory>/ckpt-<step>`` (``step`` defaults to
    ``precond.steps``) and prune the members beyond the newest
    ``retain`` (JAX ``utils/checkpoint.py:356-426``).

    On one process a transient ``OSError`` retries and, if it persists,
    skips the save (``None``; :func:`retry_transient_save`).  Across
    ranks the save is collective (the state-dict gathers and the
    barrier), and one rank retrying alone would enter collectives its
    peers never join, so there the error raises as it is; rank 0 prunes.
    """
    if retain < 1:
        raise ValueError('retain must be >= 1')
    if step is None:
        step = precond.steps
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f'ckpt-{int(step):08d}')

    def attempt() -> str:
        save_preconditioner(
            path, precond,
            include_factors=include_factors,
            compress_symmetric=compress_symmetric,
            include_ekfac_scales=include_ekfac_scales,
        )
        if _rank() == 0:
            for stale in list_checkpoints(directory)[:-retain]:
                shutil.rmtree(stale, ignore_errors=True)
        return path

    if _distributed():
        return attempt()
    return retry_transient_save(
        attempt, label=f'rotating checkpoint save ({path})',
    )


def _member_incomplete(path: str) -> str | None:
    """Why a rotation member is plainly a torn write (an empty
    directory, only zero-byte files, a plain file where the directory
    should be), or ``None`` when it may be complete; the payload checks
    come after."""
    if not os.path.isdir(path):
        return 'not a directory (partially-renamed save?)'
    files = 0
    total = 0
    for root, _, names in os.walk(path):
        for name in names:
            files += 1
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                return f'unreadable file {name!r}'
    if files == 0:
        return 'empty directory (save killed before any data landed)'
    if total == 0:
        return 'all files zero bytes (truncated save)'
    return None


def _skip_torn(path: str, errors: list[str]) -> bool:
    """True when ``path`` is plainly torn: recorded in ``errors``, logged
    and counted as a ``'checkpoint_fallback'``, so the walk skips it
    without loading it."""
    reason = _member_incomplete(path)
    if reason is None:
        return False
    errors.append(f'{os.path.basename(path)}: {reason}')
    logger.warning(
        'checkpoint %s skipped (%s); falling back to the previous rotation '
        'member', path, reason,
    )
    tracing.count_event('checkpoint_fallback')
    return True


def snapshot_host_state(precond: Any) -> Callable[[], None]:
    """Snapshot everything a restore may change before it can fail, and
    return a ``rollback()`` that puts it back (JAX ``utils/checkpoint.py:
    475-523``).

    The JAX state is an immutable pytree, so there only the host
    counters, hyperparameters and the drift controller need it; the
    port's state lives in the preconditioner, so the snapshot also keeps
    the layer states' fields, the bucket stacks and the health counters
    (references: a restore rebinds them, it never writes into a live
    tensor).  Shared by :func:`restore_latest_valid` and the generation
    walk of :mod:`kfac_pytorch_tpu_torch.elastic`.
    """
    from kfac_pytorch_tpu_torch.engine import HYPERPARAM_KEYS

    flags = ('_steps', '_last_inv_step', '_factors_initialized',
             '_stagger_bootstrapped', '_iter_bootstrapped',
             '_overlap_bootstrapped')
    snap = {name: getattr(precond, name) for name in flags}
    hp = {name: getattr(precond, f'_{name}') for name in HYPERPARAM_KEYS}
    layers = {name: dataclasses.replace(st)
              for name, st in precond.layers.items()}
    buckets = {key: dataclasses.replace(bs)
               for key, bs in precond.buckets.items()}
    health = precond._health_state()
    health_snap = None if health is None else dataclasses.replace(health)
    ar = precond._adaptive_refresh
    ar_snap = None if ar is None else ar.state_dict()

    def rollback() -> None:
        for name, value in snap.items():
            setattr(precond, name, value)
        for name, value in hp.items():
            setattr(precond, f'_{name}', value)
        for name, st in layers.items():
            live = precond.layers[name]
            for f in dataclasses.fields(st):
                setattr(live, f.name, getattr(st, f.name))
        precond.buckets = dict(buckets)
        if health_snap is not None:
            for f in dataclasses.fields(health_snap):
                setattr(health, f.name, getattr(health_snap, f.name))
        if ar_snap is not None:
            ar.load_state_dict(ar_snap)
        precond._arm_capture(precond._step_gating()[0])

    return rollback


def restore_latest_valid(
    directory: str,
    precond: Any,
    compute_inverses: bool = True,
    check_finite: bool = True,
) -> str:
    """Restore the newest rotation member that validates; returns its
    path (JAX ``utils/checkpoint.py:526-690``).

    Newest first, each candidate must load from disk, pass
    :func:`validate_payload` and install through ``load_state_dict``; a
    candidate failing any of them is skipped with a warning and a
    ``'checkpoint_fallback'`` event, and leaves the preconditioner as it
    was.

    Across ranks rank 0 alone probes (load and validate), its choice is
    broadcast, and every rank loads that member; a failure to read or
    install it then raises on every rank rather than letting ranks walk
    to different members (different steps and factors, wedged
    collectives).

    Raises:
        CheckpointValidationError: an empty rotation, or no member
            survives.
    """
    members = list_checkpoints(directory)
    if not members:
        raise CheckpointValidationError(
            f'no checkpoints found under {directory!r}',
        )
    rollback = snapshot_host_state(precond)
    errors: list[str] = []
    candidates = list(reversed(members))
    if _distributed():
        chosen, payload = -1, None
        if _rank() == 0:
            for i, path in enumerate(candidates):
                if _skip_torn(path, errors):
                    continue
                try:
                    payload = load_payload(path)
                    validate_payload(payload, precond,
                                     check_finite=check_finite)
                except Exception as exc:  # noqa: BLE001 — any corruption
                    errors.append(f'{os.path.basename(path)}: {exc}')
                    logger.warning('checkpoint %s failed probe (%s); '
                                   'falling back', path, exc)
                    tracing.count_event('checkpoint_fallback')
                    payload = None
                    continue
                chosen = i
                break
        box = [chosen, errors]
        dist.broadcast_object_list(box, src=0)
        chosen, errors = box
        if chosen < 0:
            raise CheckpointValidationError(
                f'no valid checkpoint in rotation {directory!r}; all '
                f'candidates failed: {errors}',
            )
        path = candidates[chosen]
        read_err = None
        if payload is None:
            try:
                payload = load_payload(path)
            except Exception as exc:  # noqa: BLE001
                read_err = exc
        flags = [0 if read_err is None else 1]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, flags)
        if any(f[0] for f in every):
            raise CheckpointValidationError(
                f'agreed checkpoint {path} unreadable on '
                f'{sum(f[0] for f in every)} rank(s)'
                + (f': {read_err}' if read_err is not None else ''),
            )
        try:
            precond.load_state_dict(payload,
                                    compute_inverses=compute_inverses)
        except Exception as exc:  # noqa: BLE001
            rollback()
            tracing.count_event('checkpoint_fallback')
            raise CheckpointValidationError(
                f'agreed checkpoint {path} failed to load: {exc}',
            ) from exc
        return path
    for path in candidates:
        if _skip_torn(path, errors):
            continue
        try:
            payload = load_payload(path)
            validate_payload(payload, precond, check_finite=check_finite)
            precond.load_state_dict(payload,
                                    compute_inverses=compute_inverses)
        except Exception as exc:  # noqa: BLE001 — any corruption mode
            rollback()
            errors.append(f'{os.path.basename(path)}: {exc}')
            logger.warning(
                'checkpoint %s failed to restore (%s); falling back to the '
                'previous rotation member', path, exc,
            )
            tracing.count_event('checkpoint_fallback')
            continue
        if errors:
            logger.warning('restored %s after skipping %d corrupt '
                           'checkpoint(s)', path, len(errors))
        return path
    raise CheckpointValidationError(
        f'no valid checkpoint in rotation {directory!r}; all candidates '
        f'failed: {errors}',
    )
