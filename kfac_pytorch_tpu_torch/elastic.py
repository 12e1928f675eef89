"""Streaming checkpoints: per-bucket shards, a restore without the
decomposition recompute, and world-size resize.

Port of ``kfac_pytorch_tpu/elastic.py``.  The monolithic checkpoint
(:mod:`kfac_pytorch_tpu_torch.utils.checkpoint`) makes a run restorable,
but its restore recomputes every decomposition (a ResNet-50 refresh is
a second on an H100) and its curvature state is bound to the world size
it was saved at.  Here:

* :func:`save_streaming` writes the factor EMAs and the decomposition
  stacks as shards of one *generation* directory ``gen-<step>/``, each
  published by a temp write and ``os.replace``, the manifest last; a
  save killed at any point leaves no generation the restore accepts
  under that name, and the previous one intact;
* :func:`restore_streaming` walks the generations newest first, skips
  a corrupt one naming the bad artifact, and installs the saved stacks
  as they are when the saved bucket layout is the live one: no
  ``eigh``, and the resumed run is the uninterrupted one bit for bit;
* on a resize (another world size, so another column layout) the factor
  EMAs reload by layer name and the saved stacks are transplanted slot
  by slot into the live plan (pad slots donated by a saved pad slot of
  the bucket, or synthesized); the next refresh is then forced to a
  monolithic bootstrap (:func:`~kfac_pytorch_tpu_torch.scheduler.\
post_restore_bootstrapped`), and a pending stagger or ``overlap_comm``
  deferral is dropped.

The on-disk format is the JAX package's: ``layers.npz`` (``<layer>::
<field>`` per-layer arrays), ``bucket-<key>.npz`` (the fields of
:class:`~kfac_pytorch_tpu_torch.parallel.second_order.BucketSecond` over
all ``L`` slots, by JAX's field names), ``health.npz``, ``extras.npz``
(the caller's arrays, e.g. the model and optimizer state, so one
generation restores the whole training process), ``meta.json`` (counters,
hyperparameters, the :func:`~kfac_pytorch_tpu_torch.parallel.bucketing.\
layout_signature` and a trajectory-health stamp) and ``MANIFEST.json``
(bytes and CRC32 of every other file).  A JAX generation restores here
once :func:`~kfac_pytorch_tpu_torch.convert.jax_generation_to_torch` has
renamed its layers from ``/`` to ``.``.  A bf16 stack is saved widened
to f32 (numpy has no bf16) and narrowed back exactly at install.

Across ranks each rank holds its grid column's slots, so
:func:`save_streaming` gathers every bucket over the grid row (a
collective every rank calls); rank 0 alone writes, and its result is
broadcast, so every rank returns the same path (or ``None``) with the
generation on disk.  :func:`restore_streaming` lets rank 0 verify the
candidates and broadcasts its choice; every rank reads and checks that
generation, the ranks agree on any failure before anything collective
runs, and every rank then installs it, its own column of each stack.
"""
from __future__ import annotations

import io
import json
import logging
import os
import re
import shutil
import zlib
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch import tracing
from kfac_pytorch_tpu_torch.hyperparams import resolve
from kfac_pytorch_tpu_torch.parallel.bucketing import layout_signature
from kfac_pytorch_tpu_torch.parallel.bucketing import signature_slot_map
from kfac_pytorch_tpu_torch.utils.checkpoint import _distributed
from kfac_pytorch_tpu_torch.utils.checkpoint import _fsync_dir
from kfac_pytorch_tpu_torch.utils.checkpoint import _rank

logger = logging.getLogger(__name__)

__all__ = [
    'ElasticCheckpointError',
    'ElasticCompatibilityError',
    'FORMAT_VERSION',
    'HEALTH_STAMP_HEALTHY',
    'HEALTH_STAMP_PENDING',
    'generation_stamp',
    'generation_step',
    'list_generations',
    'restore_any',
    'restore_streaming',
    'save_streaming',
    'stamp_generation',
]

FORMAT_VERSION = 1
MANIFEST_NAME = 'MANIFEST.json'
META_NAME = 'meta.json'
# Trajectory-health stamps (:mod:`kfac_pytorch_tpu_torch.watchdog`): a
# generation is born 'pending' and becomes 'healthy', a legal rollback
# target, only once the trajectory has run clean for a clearance window
# beyond it.
HEALTH_STAMP_PENDING = 'pending'
HEALTH_STAMP_HEALTHY = 'healthy'
_GEN_RE = re.compile(r'^gen-(\d+)$')
_INT_HYPERPARAMS = ('factor_update_steps', 'inv_update_steps')


class ElasticCheckpointError(RuntimeError):
    """A streaming checkpoint artifact is missing, torn, or corrupt."""


class ElasticCompatibilityError(ElasticCheckpointError):
    """The saved curvature state cannot be carried to this configuration
    (another compute method, a changed layer set, a low-rank resize).
    Older generations of the same run cannot help, so this propagates
    instead of falling back."""


# -- file-system primitives (atomicity lives here) ---------------------------


def _publish(tmp: str, final: str) -> None:
    """Atomically publish ``tmp`` as ``final`` (+ directory fsync)."""
    os.replace(tmp, final)
    _fsync_dir(os.path.dirname(final))


def _write_npz(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    tmp = f'{path}.tmp-{os.getpid()}'
    with open(tmp, 'wb') as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    _publish(tmp, path)


def _write_json(path: str, payload: Any) -> None:
    tmp = f'{path}.tmp-{os.getpid()}'
    with open(tmp, 'w') as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    _publish(tmp, path)


def _crc32(path: str) -> int:
    """Whole-file CRC32 by read-back (``np.savez`` seeks back to patch
    the zip headers, so a CRC taken during the write would be wrong)."""
    crc = 0
    with open(path, 'rb') as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


# -- generation directory layout --------------------------------------------


def list_generations(
    directory: str, *, stamps: bool = False,
) -> list[str] | list[tuple[str, str | None]]:
    """Generation directories under ``directory``, oldest first, by name
    only (torn ones too: validity is the restore walk's business).  With
    ``stamps`` each comes with its trajectory-health stamp
    (:func:`generation_stamp`)."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        m = _GEN_RE.match(name)
        if m and os.path.isdir(os.path.join(directory, name)):
            found.append((int(m.group(1)), os.path.join(directory, name)))
    paths = [path for _, path in sorted(found)]
    if not stamps:
        return paths
    return [(path, generation_stamp(path)) for path in paths]


def generation_stamp(gen: str) -> str | None:
    """A generation's trajectory-health stamp from its ``meta.json``
    (``'pending'``/``'healthy'``), ``None`` for a torn or unreadable meta
    or one without a stamp.  No manifest check: the restore re-verifies
    what it installs."""
    try:
        with open(os.path.join(gen, META_NAME)) as fh:
            meta = json.load(fh)
    except (OSError, ValueError):
        return None
    stamp = meta.get('health_stamp')
    return stamp if isinstance(stamp, str) else None


def _read_stamp_files(gen: str) -> tuple[dict, dict]:
    """A generation's ``(manifest, meta)`` for a stamp rewrite."""
    manifest_path = os.path.join(gen, MANIFEST_NAME)
    if not os.path.isfile(manifest_path):
        raise ElasticCheckpointError(
            f'{os.path.basename(gen)}: cannot stamp a torn generation '
            f'(no {MANIFEST_NAME})',
        )
    try:
        with open(manifest_path) as fh:
            manifest = json.load(fh)
        with open(os.path.join(gen, META_NAME)) as fh:
            meta = json.load(fh)
    except (OSError, ValueError) as exc:
        raise ElasticCheckpointError(
            f'{os.path.basename(gen)}: unreadable meta/manifest ({exc})',
        ) from exc
    return manifest, meta


def _write_stamp(gen: str, stamp: str) -> None:
    """The write half of :func:`stamp_generation`, on the calling rank
    only: ``meta.json`` with the new stamp, then the manifest with its
    new bytes and CRC32."""
    manifest, meta = _read_stamp_files(gen)
    if meta.get('health_stamp') == stamp:
        return
    meta_path = os.path.join(gen, META_NAME)
    meta['health_stamp'] = stamp
    _write_json(meta_path, meta)
    manifest.setdefault('shards', {})[META_NAME] = {
        'bytes': os.path.getsize(meta_path), 'crc32': _crc32(meta_path),
    }
    _write_json(os.path.join(gen, MANIFEST_NAME), manifest)
    tracing.count_event('elastic_generation_stamped')


def stamp_generation(gen: str, stamp: str = HEALTH_STAMP_HEALTHY) -> None:
    """Rewrite a generation's trajectory-health stamp in ``meta.json``,
    and its manifest entry (bytes, CRC32) with it, so the stamped
    generation still verifies (JAX ``elastic.py:212-272``).  A kill
    between the two renames leaves the manifest's CRC stale: the
    generation then fails verification and costs the restore one
    fallback, never a torn install.  Every rank calls it and checks the
    generation; rank 0 writes, and all meet at a barrier.

    Raises:
        ElasticCheckpointError: a torn generation (no manifest) or an
            unreadable meta or manifest.
    """
    from kfac_pytorch_tpu_torch import runtime

    _read_stamp_files(gen)
    # The cross-process commit point: every rank checked the generation
    # before rank 0 rewrites it.
    runtime.commit_point('elastic/stamp')
    if _rank() == 0:
        _write_stamp(gen, stamp)
    if _distributed():
        dist.barrier()


def generation_step(path: str) -> int:
    """The step number in a generation directory's name."""
    m = _GEN_RE.match(os.path.basename(path))
    if not m:
        raise ValueError(f'{path!r} is not a generation directory')
    return int(m.group(1))


def generation_bytes(gen: str) -> int:
    """Bytes of a committed generation, as its manifest counts them."""
    return sum(e['bytes'] for e in _read_manifest(gen)['shards'].values())


def _host_array(x: Any) -> np.ndarray:
    """A CPU numpy copy; bf16 widened to f32 (numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(x)


def _check_finite_arrays(
    arrays: Mapping[str, np.ndarray], origin: str,
) -> None:
    """Refuse non-finite float arrays, naming the artifact.  The stacks
    install as they are (no recompute launders a NaN), so every array is
    checked, not only the factor EMAs.  The Newton–Schulz residuals carry
    ``+inf`` as a legal sentinel (a slot never refreshed)."""
    for name, arr in arrays.items():
        if not (np.issubdtype(arr.dtype, np.floating)
                or np.issubdtype(arr.dtype, np.complexfloating)):
            continue
        if name.split('/')[-1].startswith('iter_res_'):
            if np.isnan(arr).any() or (arr == -np.inf).any():
                raise ElasticCheckpointError(
                    f'{origin}/{name} contains NaN or -inf — refusing to '
                    'restore poisoned curvature state',
                )
            continue
        if not np.isfinite(arr).all():
            raise ElasticCheckpointError(
                f'{origin}/{name} contains non-finite values — refusing to '
                'restore poisoned curvature state',
            )


def _sanitize_hyperparams(sd: Mapping[str, Any]) -> dict[str, Any]:
    """JSON-portable copy of ``save_hyperparams`` output."""
    out: dict[str, Any] = {}
    for name, value in sd.items():
        if value is None:
            out[name] = None
        elif name in _INT_HYPERPARAMS:
            out[name] = int(value)
        else:
            out[name] = float(value)
    return out


# -- save --------------------------------------------------------------------


def save_streaming(
    directory: str,
    precond: Any,
    *,
    step: int | None = None,
    retain: int = 3,
    include_decompositions: bool = True,
    extras: Mapping[str, Any] | None = None,
    on_shard: Callable[[str], None] | None = None,
) -> str | None:
    """Write generation ``<directory>/gen-<step>`` (``step`` defaults to
    ``precond.steps``) and prune committed generations beyond the newest
    ``retain`` (JAX ``elastic.py:352-596``).

    Shards: ``layers.npz`` (the factor EMAs, and the decompositions a
    layer keeps outside the stacks), ``bucket-<key>.npz`` per bucket,
    ``health.npz`` under health, ``extras.npz`` (``extras``, a flat
    ``str -> tensor`` mapping), then ``meta.json`` (born ``'pending'``)
    and last ``MANIFEST.json``.  ``include_decompositions=False`` saves
    the layers only: ``layers.npz`` keeps each layer's ``a_factor`` and
    ``g_factor`` and no bucket shard is written (nothing is gathered);
    the meta records it, and the restore recomputes the decompositions.

    ``on_shard(relative_name)`` fires on the writer after each shard is
    published, then once for ``meta.json``, before the manifest: progress
    reporting, and the fault drill's mid-save kill hook.

    Returns the generation's path, or ``None`` when the writes failed
    with an ``OSError`` on every bounded retry (the save is skipped with
    a ``'checkpoint_save_failed'`` event instead of raising into the
    training loop).  Across ranks every rank calls this: the stacks are
    gathered over the grid row, rank 0 writes, and its result reaches
    every rank.
    """
    from kfac_pytorch_tpu_torch.engine import save_hyperparams
    from kfac_pytorch_tpu_torch.utils.checkpoint import retry_transient_save

    if retain < 1:
        raise ValueError('retain must be >= 1')
    if step is None:
        step = precond.steps
    step = int(step)
    directory = os.path.abspath(directory)
    gen = os.path.join(directory, f'gen-{step:08d}')

    # The stacks are gathered over the grid row on every rank (a
    # collective); only rank 0, the writer, copies anything to the host.
    so = precond._second_order
    stacks = (so.gather_stacks(precond.buckets)
              if so is not None and include_decompositions else {})
    shards: dict[str, dict[str, np.ndarray]] = {}
    if _rank() == 0:
        layer_arrays: dict[str, np.ndarray] = {}
        for base, st in precond._checkpoint_layer_states().items():
            fields = {'a_factor': st.a_factor, 'g_factor': st.g_factor}
            # A field not computed yet is saved as the zeros the JAX
            # state starts from.
            for fname, shape in (precond._layer_field_shapes(base).items()
                                 if include_decompositions else ()):
                t = getattr(st, fname)
                fields[fname] = t if t is not None else torch.zeros(
                    shape, dtype=precond.inv_dtype)
            for fname, t in fields.items():
                layer_arrays[f'{base}::{fname}'] = _host_array(t)
        shards['layers.npz'] = layer_arrays
        for key, fields in stacks.items():
            shards[f'bucket-{key}.npz'] = {
                f: _host_array(t) for f, t in fields.items()
            }
        health = precond._health_state()
        if health is not None:
            shards['health.npz'] = {
                f: _host_array(getattr(health, f))
                for f in health.__dataclass_fields__
            }
        if extras:
            shards['extras.npz'] = {k: _host_array(v)
                                    for k, v in extras.items()}
    del stacks
    hp: dict[str, Any] = {}
    save_hyperparams(precond, hp)
    ar = precond._adaptive_refresh
    meta = {
        'format': FORMAT_VERSION,
        'health_stamp': HEALTH_STAMP_PENDING,
        'steps': int(precond._steps),
        'sketch_step': int(precond._last_inv_step),
        'factors_initialized': bool(precond._factors_initialized),
        'stagger_bootstrapped': bool(precond._stagger_bootstrapped),
        'iter_bootstrapped': bool(precond._iter_bootstrapped),
        'stagger_refresh': precond._stagger_refresh,
        'include_decompositions': bool(include_decompositions),
        'hyperparams': _sanitize_hyperparams(hp),
        'adaptive_refresh': None if ar is None else ar.state_dict(),
        'topology': {
            'descriptor': precond._topology_descriptor(),
            'signature': (layout_signature(precond.plan)
                          if precond.plan is not None else None),
        },
    }

    def write_generation() -> str:
        # A leftover directory at this step: a torn one (no manifest) is
        # invalid and cleared; a committed one stays the newest valid
        # generation until its replacement, built in a staging sibling
        # the gen-* pattern does not match, is complete.
        staging = None
        target = gen
        if os.path.isdir(gen):
            if os.path.isfile(os.path.join(gen, MANIFEST_NAME)):
                staging = f'{gen}.resave-{os.getpid()}'
                if os.path.isdir(staging):
                    shutil.rmtree(staging)
                target = staging
            else:
                shutil.rmtree(gen)
        os.makedirs(target, exist_ok=True)
        manifest_shards: dict[str, dict[str, int]] = {}
        for name in sorted(shards):
            path = os.path.join(target, name)
            _write_npz(path, shards[name])
            manifest_shards[name] = {
                'bytes': os.path.getsize(path), 'crc32': _crc32(path),
            }
            if on_shard is not None:
                on_shard(name)
        meta_path = os.path.join(target, META_NAME)
        _write_json(meta_path, meta)
        manifest_shards[META_NAME] = {
            'bytes': os.path.getsize(meta_path), 'crc32': _crc32(meta_path),
        }
        if on_shard is not None:
            on_shard(META_NAME)
        # The commit point: nothing above is visible before this rename.
        _write_json(os.path.join(target, MANIFEST_NAME), {
            'format': FORMAT_VERSION, 'step': step,
            'shards': manifest_shards,
        })
        if staging is not None:
            shutil.rmtree(gen)
            os.replace(staging, gen)
            _fsync_dir(directory)
        # Prune: torn generations older than this one hold no retention
        # slot; the window counts committed generations; staging
        # leftovers of killed re-saves are dead.
        gens = list_generations(directory)
        committed = [g for g in gens
                     if os.path.isfile(os.path.join(g, MANIFEST_NAME))]
        torn = [g for g in gens
                if g not in committed and generation_step(g) < step]
        stale = [os.path.join(directory, name)
                 for name in os.listdir(directory) if '.resave-' in name]
        for path in torn + committed[:-retain] + stale:
            shutil.rmtree(path, ignore_errors=True)
        return gen

    from kfac_pytorch_tpu_torch import runtime

    # The cross-process commit point: every rank has fed the gathers
    # above; rank 0 is about to make the generation durable (manifest
    # last), so a rank that died mid-save surfaces as a named timeout or
    # death instead of a hung save.
    runtime.commit_point('elastic/commit')
    result = None
    if _rank() == 0:
        result = retry_transient_save(
            write_generation, label=f'streaming checkpoint save ({gen})',
        )
    if _distributed():
        box = [result]
        dist.broadcast_object_list(box, src=0)
        result = box[0]
    return result


# -- restore -----------------------------------------------------------------


def _read_manifest(gen: str) -> dict:
    """The generation's manifest, presence/parse/format-checked."""
    mpath = os.path.join(gen, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        raise ElasticCheckpointError(
            f'{os.path.basename(gen)}: no {MANIFEST_NAME} — save was killed '
            'before the commit point (torn generation)',
        )
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as exc:
        raise ElasticCheckpointError(
            f'{os.path.basename(gen)}/{MANIFEST_NAME}: unreadable manifest '
            f'({exc})',
        ) from exc
    if manifest.get('format') != FORMAT_VERSION:
        raise ElasticCompatibilityError(
            f'{os.path.basename(gen)}: manifest format '
            f'{manifest.get("format")!r} != {FORMAT_VERSION}',
        )
    return manifest


def _read_verified(gen: str, name: str, entry: dict) -> bytes:
    """One manifest entry, read once and checked against the manifest's
    size and CRC32; raises naming the artifact."""
    path = os.path.join(gen, name)
    if not os.path.isfile(path):
        raise ElasticCheckpointError(
            f'{os.path.basename(gen)}/{name}: shard listed in manifest is '
            'missing (torn rename?)',
        )
    with open(path, 'rb') as fh:
        data = fh.read()
    if len(data) != entry['bytes']:
        raise ElasticCheckpointError(
            f'{os.path.basename(gen)}/{name}: {len(data)} bytes on disk != '
            f'{entry["bytes"]} in manifest (truncated shard)',
        )
    crc = zlib.crc32(data)
    if crc != entry['crc32']:
        raise ElasticCheckpointError(
            f'{os.path.basename(gen)}/{name}: CRC32 {crc:#x} != manifest '
            f'{entry["crc32"]:#x} (corrupt shard)',
        )
    return data


def _verify_generation(gen: str) -> dict:
    """Manifest-driven integrity check; raises naming the bad artifact."""
    manifest = _read_manifest(gen)
    for name, entry in manifest['shards'].items():
        _read_verified(gen, name, entry)
    return manifest


def _load_generation(gen: str) -> tuple[dict, dict]:
    """Verify and parse in one pass: ``(meta, {shard: {name: array}})``,
    each file read once."""
    manifest = _read_manifest(gen)
    meta: dict | None = None
    shards: dict[str, dict[str, np.ndarray]] = {}
    for name, entry in manifest['shards'].items():
        data = _read_verified(gen, name, entry)
        if name == META_NAME:
            meta = json.loads(data)
        elif name.endswith('.npz'):
            with np.load(io.BytesIO(data)) as npz:
                # Copies: arrays parsed from bytes are read-only.
                shards[name] = {k: np.array(npz[k]) for k in npz.files}
    if meta is None:
        raise ElasticCheckpointError(
            f'{os.path.basename(gen)}: manifest lists no {META_NAME}',
        )
    return meta, shards


def _probe_generation(meta: dict, shards: dict, check_finite: bool) -> None:
    """The checks of a loaded generation that need no live state: its
    format, and with ``check_finite`` every array finite (the layers, the
    stacks, and the caller's extras, which install as they are too)."""
    if meta.get('format') != FORMAT_VERSION:
        raise ElasticCompatibilityError(
            f'meta format {meta.get("format")!r} != {FORMAT_VERSION}',
        )
    if not check_finite:
        return
    for name, arrays in shards.items():
        if name == 'layers.npz':
            by_layer: dict[str, dict[str, np.ndarray]] = {}
            for key, arr in arrays.items():
                base, _, field = key.rpartition('::')
                by_layer.setdefault(base, {})[field] = arr
            for base, fields in by_layer.items():
                _check_finite_arrays(fields, f'layers.npz/{base}')
        elif name != 'health.npz':
            _check_finite_arrays(arrays, name)


def _pad_slot_value(
    field: str, key: str, shape: tuple, dtype: np.dtype, damping: float,
) -> np.ndarray:
    """One pad slot of a stack field, as a monolithic refresh computes it
    for an identity-padded slot (``eigh(I) == (ones, I)``), used only
    when the saved layout has no pad slot of the bucket to donate.  Pad
    slots touch no layer's preconditioning (their gradients are zero),
    so this only needs to be finite and well formed."""
    if field in ('qa', 'qg', 'a_inv', 'g_inv'):
        eye = np.eye(shape[0], dtype=dtype)
        return eye / (1.0 + damping) if field in ('a_inv', 'g_inv') else eye
    if field in ('da', 'dg', 'skron', 'ever_ok'):
        return np.ones(shape, dtype)
    if field == 'dgda':
        return np.full(shape, 1.0 / (1.0 + damping), dtype)
    if field == 'bake_damping':
        return np.asarray(damping, dtype)
    if field in ('fail_count', 'quarantined', 'iter_res_a', 'iter_res_g',
                 'iter_stale_a', 'iter_stale_g'):
        # The synthesized inverse is exact for an identity pad: zero
        # Newton–Schulz residual, no stale iterations.
        return np.zeros(shape, dtype)
    if field in ('iter_bound_a', 'iter_bound_g'):
        return np.asarray(1.0 + damping, dtype)
    raise ElasticCompatibilityError(
        f'cannot synthesize a pad-slot value for stack field {field!r} of '
        f'bucket {key!r} — resize is not supported for this configuration',
    )


def _matching_stack_fields(
    key: str, tmpl: Any, saved: Mapping[str, np.ndarray],
) -> list[str]:
    """The live bucket's saved fields, which must equal the saved set: a
    difference means the compute method, prediv or guard configuration
    changed between save and restore."""
    fields = list(tmpl.stack_fields())
    if set(fields) != set(saved):
        raise ElasticCompatibilityError(
            f'bucket {key!r} stack fields differ: saved {sorted(saved)} vs '
            f'live {sorted(fields)} — compute method / prediv / health '
            'configuration changed between save and restore',
        )
    return fields


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return _host_array(t[:0]).dtype


def _transplant_buckets(
    precond: Any,
    saved_sig: Mapping,
    saved_buckets: Mapping[str, Mapping[str, np.ndarray]],
    damping: float,
) -> dict[str, dict[str, np.ndarray]]:
    """The saved stacks re-laid into the live plan's full ``[L, ...]``
    stacks (JAX ``elastic.py:757-846``): each occupied live slot takes its
    layer's row from the slot the saved layout kept it in
    (:func:`~kfac_pytorch_tpu_torch.parallel.bucketing.\
signature_slot_map`); a pad slot takes a saved pad slot of the bucket
    (what the old refresh computed for it), else a synthesized one.
    Gathers only, no ``eigh``."""
    so = precond._second_order
    if so is None:
        raise ElasticCompatibilityError(
            'decomposition transplant requires the bucketed second-order '
            'stage',
        )
    if precond.lowrank_rank is not None:
        raise ElasticCompatibilityError(
            'world-size resize of low-rank decomposition state is not '
            'supported (the truncated stacks are sketch-draw-keyed); '
            'restore with recompute instead',
        )
    saved_slot_of = signature_slot_map(saved_sig)
    saved_pads = {
        bucket['key']: [i for i, n in enumerate(bucket['slots']) if n is None]
        for bucket in saved_sig['buckets']
    }
    out: dict[str, dict[str, np.ndarray]] = {}
    for b in precond.plan.buckets:
        tmpl = precond.buckets[b.key]
        saved = saved_buckets.get(b.key)
        if saved is None:
            raise ElasticCompatibilityError(
                f'saved checkpoint has no stacks for bucket {b.key!r} — was '
                'it saved under a different model configuration?',
            )
        fields = _matching_stack_fields(b.key, tmpl, saved)
        out[b.key] = {}
        for field in fields:
            live = getattr(tmpl, field)
            shape, dtype = tuple(live.shape[1:]), _np_dtype(live)
            src = saved[field]
            rows = []
            for name in b.slots:
                if name is not None:
                    if name not in saved_slot_of:
                        raise ElasticCompatibilityError(
                            f'layer {name!r} occupies a live slot but is '
                            'absent from the saved bucket layout — was the '
                            'model changed between save and restore?',
                        )
                    okey, oslot = saved_slot_of[name]
                    if okey != b.key:
                        raise ElasticCompatibilityError(
                            f'layer {name!r} moved buckets across the '
                            f'resize ({okey!r} -> {b.key!r}) — padded factor '
                            'dims changed, decompositions are not portable',
                        )
                    rows.append(src[oslot])
                elif saved_pads.get(b.key):
                    rows.append(src[saved_pads[b.key][0]])
                else:
                    rows.append(_pad_slot_value(field, b.key, shape, dtype,
                                                damping))
            stacked = np.stack(rows).astype(dtype)
            if stacked.shape != (b.n_slots,) + shape:
                raise ElasticCompatibilityError(
                    f'bucket {b.key!r} field {field!r}: transplanted shape '
                    f'{stacked.shape} != live {(b.n_slots,) + shape}',
                )
            out[b.key][field] = stacked
    return out


def _check_layer_fields(
    precond: Any,
    layer_arrays: Mapping[str, np.ndarray],
    saved_topology: str | None,
) -> tuple[dict, dict]:
    """The saved per-layer fields checked against the live layers, with
    nothing written: ``(factors, fields)``, the factor EMAs in
    ``_restore_factors``'s form (shape-checked by layer) and the
    decompositions a layer keeps outside the stacks."""
    from kfac_pytorch_tpu_torch.engine import validate_saved_factor_shapes

    by_layer: dict[str, dict[str, np.ndarray]] = {}
    for key, arr in layer_arrays.items():
        base, _, field = key.rpartition('::')
        by_layer.setdefault(base, {})[field] = arr
    registered = precond._checkpoint_layer_states()
    unknown = set(by_layer) - set(registered)
    if unknown:
        raise ElasticCompatibilityError(
            f'checkpoint contains unregistered layers {sorted(unknown)} '
            f'(registered: {sorted(registered)})',
        )
    missing = set(registered) - set(by_layer)
    if missing:
        raise ElasticCompatibilityError(
            f'checkpoint is missing registered layers {sorted(missing)} — '
            'was the model changed between save and restore?',
        )
    factors = {}
    for base, fields in by_layer.items():
        if 'a_factor' not in fields or 'g_factor' not in fields:
            raise ElasticCheckpointError(
                f'layer shard for {base!r} is missing its factor EMAs',
            )
        factors[base] = {'A': fields['a_factor'], 'G': fields['g_factor']}
    validate_saved_factor_shapes(
        factors, registered, saved_topology=saved_topology,
        expected_topology=precond._topology_descriptor(),
    )
    installs = {}
    for base, fields in by_layer.items():
        shapes = precond._layer_field_shapes(base)
        for fname, arr in fields.items():
            if fname in ('a_factor', 'g_factor'):
                continue
            if fname not in shapes:
                raise ElasticCompatibilityError(
                    f'layer {base!r} saved field {fname!r} has no slot in '
                    'this configuration (compute method changed?)',
                )
            if tuple(arr.shape) != shapes[fname]:
                raise ElasticCheckpointError(
                    f'layer {base!r} field {fname!r}: saved shape '
                    f'{tuple(arr.shape)} != expected {shapes[fname]}',
                )
            installs.setdefault(base, {})[fname] = arr
    return factors, installs


def _prepare_install(
    precond: Any, meta: dict, shards: dict[str, dict[str, np.ndarray]],
) -> dict[str, Any]:
    """Everything about installing one loaded generation that can refuse
    it, checked with nothing written and nothing collective: the
    per-layer fields (:func:`_check_layer_fields`) and every bucket's
    full stacks, as saved when the saved layout is the live one, else
    transplanted through the live layout.  Raises
    :class:`ElasticCompatibilityError` for a configuration mismatch and
    :class:`ElasticCheckpointError` for a generation that cannot be
    installed."""
    topo = meta.get('topology') or {}
    saved_sig = topo.get('signature')
    factors, layer_fields = _check_layer_fields(
        precond, shards.get('layers.npz', {}), topo.get('descriptor'),
    )
    saved_buckets = {
        name[len('bucket-'):-len('.npz')]: arrays
        for name, arrays in shards.items() if name.startswith('bucket-')
    }
    full, resized = None, False
    if precond._second_order is not None and saved_buckets:
        if saved_sig == layout_signature(precond.plan):
            full = {}
            for b in precond.plan.buckets:
                saved = saved_buckets.get(b.key)
                if saved is None:
                    raise ElasticCheckpointError(
                        f'bucket shard for {b.key!r} missing from a '
                        'layout-identical generation',
                    )
                fields = _matching_stack_fields(b.key, precond.buckets[b.key],
                                                saved)
                full[b.key] = {f: saved[f] for f in fields}
        else:
            # The damping the restored engine has at the restored step.
            damping = float(resolve(
                meta.get('hyperparams', {}).get('damping', precond._damping),
                int(meta['steps'])))
            full = _transplant_buckets(precond, saved_sig, saved_buckets,
                                       damping)
            resized = True
    return {'factors': factors, 'layer_fields': layer_fields, 'full': full,
            'resized': resized}


def _every_rank(item: Any) -> list[Any]:
    """``item`` of every rank, in rank order (``[item]`` on one)."""
    if not _distributed():
        return [item]
    out: list[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, item)
    return out


def restore_streaming(
    directory: str,
    precond: Any,
    *,
    check_finite: bool = True,
    target_step: int | None = None,
    require_stamp: str | None = None,
) -> dict[str, Any]:
    """Restore the newest valid streaming generation into ``precond``
    (JAX ``elastic.py:938-1085``); returns ``info``.

    Newest first, each candidate must verify against its manifest (a
    torn generation, a truncated or missing shard, a CRC mismatch, a
    non-finite array are each skipped with a warning naming the artifact
    and an ``'elastic_restore_fallback'`` event) and then pass the
    install's checks (:func:`_prepare_install`: a saved shape that does
    not fit, a layer without its factor EMAs).  A configuration mismatch
    (:class:`ElasticCompatibilityError`) propagates: older generations of
    the same run cannot fix it.

    One path for every world size: rank 0 (the only process on one)
    reads and verifies newest first and broadcasts its choice; every
    other rank reads that generation; every rank checks the install, and
    the ranks agree on any failure (one ``all_gather_object``) before
    anything is written or anything collective runs, so all of them fall
    back to the next candidate together, or raise together.

    ``target_step`` pins the restore to ``gen-<target_step>``: no walk,
    and a missing, torn or corrupt target raises naming it (the
    watchdog's rollback lands on the generation it chose, or nowhere).
    ``require_stamp`` keeps only generations whose trajectory-health
    stamp equals it; the others are listed in ``info['skipped']``.

    Install: counters, hyperparameters and factor EMAs always; the saved
    stacks as they are when the saved layout is the live one (no
    recompute, a bitwise resume), transplanted through the live layout
    on a resize; with no saved stacks (a JAX generation saved without
    its decompositions) the monolithic refresh runs, as
    ``load_state_dict(compute_inverses=True)`` does.  The bootstrap flags
    follow :func:`~kfac_pytorch_tpu_torch.scheduler.\
post_restore_bootstrapped`; a pending deferred refresh, the micro-batch
    sums and a pending drift-triggered refresh are dropped, and the
    adaptive cadence restarts its ages.

    ``info`` holds ``generation``, ``step``, ``resized``, ``recomputed``,
    ``decompositions_installed``, ``health_stamp``, ``skipped`` (``{'
    generation', 'error'}`` for each generation passed over) and
    ``extras`` (the caller's arrays saved alongside, as CPU tensors, or
    ``None``).

    Raises:
        ElasticCheckpointError: no generation, none valid, or a pinned
            ``target_step`` that is missing, corrupt or unstamped.
    """
    from kfac_pytorch_tpu_torch.utils.checkpoint import snapshot_host_state

    candidates = list(reversed(list_generations(directory)))
    if not candidates:
        raise ElasticCheckpointError(
            f'no streaming generations found under {directory!r}',
        )
    skipped: list[dict[str, str]] = []
    if target_step is not None:
        want = f'gen-{int(target_step):08d}'
        pinned = [g for g in candidates if os.path.basename(g) == want]
        if not pinned:
            raise ElasticCheckpointError(
                f'pinned rollback target {want} does not exist under '
                f'{directory!r} (generations: '
                f'{[os.path.basename(g) for g in candidates]})',
            )
        candidates = pinned
    if require_stamp is not None:
        kept = []
        for gen in candidates:
            stamp = generation_stamp(gen)
            if stamp == require_stamp:
                kept.append(gen)
            else:
                skipped.append({
                    'generation': os.path.basename(gen),
                    'error': (f'health_stamp={stamp!r} != required '
                              f'{require_stamp!r}'),
                })
        if not kept:
            raise ElasticCheckpointError(
                f'no generation under {directory!r} carries the required '
                f'health stamp {require_stamp!r}; skipped: {skipped}',
            )
        candidates = kept

    def skip(gen: str, error: str) -> None:
        if target_step is not None:
            raise ElasticCheckpointError(
                f'pinned rollback target {os.path.basename(gen)} failed to '
                f'restore: {error}',
            )
        skipped.append({'generation': os.path.basename(gen), 'error': error})
        logger.warning(
            'streaming generation %s failed to restore (%s); falling back '
            'to the previous generation', gen, error,
        )
        tracing.count_event('elastic_restore_fallback')

    def walk(start: int) -> tuple[int, dict, dict]:
        """Newest first from ``start``: the first candidate that reads
        and probes clean; a compatibility error propagates."""
        for i in range(start, len(candidates)):
            try:
                meta, shards = _load_generation(candidates[i])
                _probe_generation(meta, shards, check_finite)
            except ElasticCompatibilityError:
                raise
            except Exception as exc:  # noqa: BLE001 — any corruption mode
                skip(candidates[i], str(exc))
                continue
            return i, meta, shards
        raise ElasticCheckpointError(
            f'no valid streaming generation under {directory!r}; all '
            f'candidates failed: {skipped}',
        )

    start = 0
    while True:
        i, meta, shards, error = -1, None, None, None
        if _rank() == 0:
            try:
                i, meta, shards = walk(start)
            except ElasticCheckpointError as exc:
                error = (type(exc).__name__, str(exc))
        if _distributed():
            box: list[Any] = [(i, skipped, error)]
            dist.broadcast_object_list(box, src=0)
            i, skipped[:], error = box[0]
        if error is not None:
            cls = (ElasticCompatibilityError
                   if error[0] == ElasticCompatibilityError.__name__
                   else ElasticCheckpointError)
            raise cls(error[1])
        gen = candidates[i]
        fault = None
        try:
            if meta is None:
                # Rank 0 probed these bytes; the CRCs prove them the same.
                meta, shards = _load_generation(gen)
            plan = _prepare_install(precond, meta, shards)
        except ElasticCompatibilityError as exc:
            fault = ('compatibility', str(exc))
        except Exception as exc:  # noqa: BLE001 — any corruption mode
            fault = ('corrupt', str(exc))
        faults = [(r, f) for r, f in enumerate(_every_rank(fault)) if f]
        if any(f[0] == 'compatibility' for _, f in faults):
            raise ElasticCompatibilityError('; '.join(
                f'rank {r}: {f[1]}' for r, f in faults
                if f[0] == 'compatibility'))
        if faults:
            skip(gen, '; '.join(f'rank {r}: {f[1]}' for r, f in faults))
            start = i + 1
            continue
        break
    rollback = snapshot_host_state(precond)
    try:
        info = _install_generation(precond, meta, shards, plan)
    except Exception:
        rollback()
        raise
    info['generation'] = os.path.basename(gen)
    info['health_stamp'] = meta.get('health_stamp')
    info['skipped'] = skipped
    if skipped:
        logger.warning('restored %s after skipping %d generation(s)', gen,
                       len(skipped))
    return info


def _install_generation(
    precond: Any, meta: dict, shards: dict[str, dict[str, np.ndarray]],
    plan: dict[str, Any],
) -> dict[str, Any]:
    """Install one verified generation, checked by
    :func:`_prepare_install` into ``plan``, into the live preconditioner
    (JAX ``elastic.py:1088-1289``)."""
    from kfac_pytorch_tpu_torch.engine import load_hyperparams
    from kfac_pytorch_tpu_torch.scheduler import post_restore_bootstrapped

    # A deferred refresh was scheduled against the state being replaced:
    # its work is joined and discarded before anything is written.
    precond._overlap_drop()
    precond.reset_batch()
    precond._refresh_requested = False
    if precond._consistency_ladder is not None:
        precond._consistency_ladder.reset_all()

    precond._steps = int(meta['steps'])
    precond._last_inv_step = int(meta['sketch_step'])
    load_hyperparams(precond, meta.get('hyperparams', {}))
    ar_sd = meta.get('adaptive_refresh')
    if ar_sd is not None and precond._adaptive_refresh is not None:
        precond._adaptive_refresh.load_state_dict(ar_sd)
    precond._restore_factors(plan['factors'])
    for base, fields in plan['layer_fields'].items():
        st = precond.layers[base]
        for fname, arr in fields.items():
            setattr(st, fname, torch.as_tensor(arr).to(
                device=precond.device, dtype=precond.inv_dtype))
    precond._factors_initialized = bool(meta.get('factors_initialized',
                                                 True))
    h = precond._health_state()
    if h is not None:
        for name, arr in (shards.get('health.npz') or {}).items():
            if hasattr(h, name):
                live = getattr(h, name)
                setattr(h, name, torch.as_tensor(arr).to(
                    device=live.device, dtype=live.dtype))
        # Restored EMAs are running averages: the next factor step must
        # not reseed them from the identity.
        h.factor_updates_applied = torch.clamp(h.factor_updates_applied,
                                               min=1)

    so = precond._second_order
    resized, recomputed = plan['resized'], False
    decomps_installed = bool(plan['layer_fields']) and so is None
    if plan['full'] is not None:
        precond.buckets = so.install_stacks(plan['full'], precond.buckets)
        decomps_installed = True
    elif not decomps_installed:
        # No saved decompositions (a JAX generation saved without them):
        # the monolithic restore refresh, at the iterative method's
        # bootstrap depth (collective across ranks).
        precond._iter_bootstrapped = False
        precond._restore_refresh()
        recomputed = True

    # The saved stagger flag speaks of the saving engine's shard
    # schedule, so it holds only for the same shard count.
    stagger_matches = meta.get('stagger_refresh') == precond._stagger_refresh
    saved_boot = bool(meta.get('stagger_bootstrapped', False))
    precond._stagger_bootstrapped = post_restore_bootstrapped(
        full_recompute=recomputed,
        decompositions_installed=decomps_installed,
        topology_changed=resized,
        saved_bootstrapped=saved_boot and stagger_matches,
    )
    precond._iter_bootstrapped = post_restore_bootstrapped(
        full_recompute=recomputed,
        decompositions_installed=decomps_installed,
        topology_changed=resized,
        saved_bootstrapped=(decomps_installed
                            and bool(meta.get('iter_bootstrapped', False))),
    )
    precond._overlap_bootstrapped = post_restore_bootstrapped(
        full_recompute=recomputed,
        decompositions_installed=decomps_installed,
        topology_changed=resized,
        saved_bootstrapped=decomps_installed and saved_boot,
    )
    ctl = precond._adaptive_controller
    if ctl is not None:
        ctl.reset()
        precond._adaptive_last_drift = None
    precond._arm_capture(precond._step_gating()[0])
    extras = shards.get('extras.npz')
    return {
        'step': int(meta['steps']),
        'resized': resized,
        'recomputed': recomputed,
        'decompositions_installed': decomps_installed,
        'extras': (None if extras is None else
                   {k: torch.from_numpy(v) for k, v in extras.items()}),
    }


def restore_any(
    directory: str, precond: Any, **kwargs: Any,
) -> dict[str, Any]:
    """Restore from streaming generations or, with none, from a monolithic
    rotation (:func:`~kfac_pytorch_tpu_torch.utils.checkpoint.\
restore_latest_valid`: a full recompute, pinned to the saving world
    size); ``info['loader']`` says which (JAX ``elastic.py:1292-1332``)."""
    if list_generations(directory):
        info = restore_streaming(directory, precond, **kwargs)
        info['loader'] = 'streaming'
        return info
    from kfac_pytorch_tpu_torch.utils import checkpoint as ckpt_lib

    if ckpt_lib.list_checkpoints(directory):
        path = ckpt_lib.restore_latest_valid(
            directory, precond, check_finite=kwargs.get('check_finite', True),
        )
        return {
            'loader': 'monolithic',
            'generation': os.path.basename(path),
            'step': precond.steps,
            'resized': False,
            'recomputed': True,
            'decompositions_installed': False,
            'skipped': [],
            'extras': None,
        }
    raise ElasticCheckpointError(
        f'no streaming generations and no checkpoint rotation under '
        f'{directory!r}',
    )
