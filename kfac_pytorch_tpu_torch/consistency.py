"""Cross-replica consistency guard: detect and repair silent divergence.

Port of ``kfac_pytorch_tpu/consistency.py`` over ``torch.distributed``.
The factor EMAs, the hyperparameter scalars and the bucket stacks of the
second-order state are replicated by construction: every rank holds the
same factor EMAs, and the ranks of a grid column
(:attr:`~kfac_pytorch_tpu_torch.parallel.mesh.KaisaGrid.col_group`, the
group the decomposition gather runs over) hold the same slots of every
bucket.  Nothing checks it; a one-bit divergence in one rank's buffer
preconditions that rank differently for a whole refresh interval.

* **fingerprint** — every surface is digested on its own rank: a
  NaN-safe ``(sum, max-abs)`` pair per layer (the factor EMAs and a
  diagonal-A layer's decompositions), per bucket *slot* (every field of
  :class:`~kfac_pytorch_tpu_torch.parallel.second_order.BucketSecond`
  with a per-slot leading dim), and the canonical hyperparameter
  scalars.  Component 0 is the exact modular u32 sum of the f32 bit
  patterns, component 1 the bit pattern of the sanitized max-abs: bit
  for bit the JAX module's (:func:`array_digest`).  Digests are held in
  int64 tensors with values in ``[0, 2^32)``.
* **compare** — one ``all_gather`` over the world of each rank's digest
  vector (a few kB): the layer and hyperparameter digests are compared
  over every rank, each bucket slot's over the ranks of its grid column
  only (never over a row, whose ranks hold different slots).  The same
  gathered array gives every rank the vote, so every rank reaches the
  same verdicts, masks and counts.
* **repair** — per divergent surface the replicas vote by digest
  equality; the lowest rank of the largest agreeing set is canonical
  (:func:`canonical_rank`), and its bytes are broadcast (``dist.broadcast``
  over the world for a layer, over the column for a slot), bitwise,
  ``-0.0`` and NaN payloads included.  (JAX's masked ``psum`` turns a
  canonical ``-0.0`` into ``+0.0``.)  Surfaces that agree are left
  alone; JAX rebroadcasts them from rank 0, a bitwise no-op.

The ladder above these primitives is the engine's
(``KFACEngineMixin._consistency_finish``): repair, then force the next
refresh to a bootstrap, then quarantine a slot after
``quarantine_after`` consecutive disagreeing checks.

Under MEM-OPT (one grid row) the stacks have no replicas and only the
replicated surfaces are checked; with one rank every check is clean and
issues no collective.  Under EKFAC on a grid with several columns the
port keeps ``basis_qa``/``basis_qg`` (every occupied slot's eigenbases,
the same on every rank), which have no JAX counterpart: they are a
surface of their own, compared and repaired over the world, and counted
in ``consistency/basis_mismatches``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from kfac_pytorch_tpu_torch.parallel.collectives import group_size

__all__ = [
    'ConsistencyConfig',
    'HP_DIGEST_KEYS',
    'CheckResult',
    'apply_quarantine',
    'array_digest',
    'canonical_rank',
    'check',
    'check_info',
    'host_replica_divergence',
    'mismatch_masks',
    'repair_state',
    'sanitize',
    'stack_digest',
]

#: Canonical hyperparameter scalars entering the digest, in order; only
#: the keys present contribute (``kl_clip=None`` digests three).
HP_DIGEST_KEYS = ('damping', 'factor_decay', 'kl_clip', 'lr')

# NaN-safe encodings (JAX consistency.py:100-107): bitwise identical
# replicas digest identically, NaN-vs-finite does not.
_NAN_SENTINEL = 1.5e38
_POSINF_SENTINEL = 2.5e38
_NEGINF_SENTINEL = -2.5e38
_U32 = 0xFFFFFFFF

#: Fields of a bucket state that are not slot stacks: the EKFAC bases
#: of every occupied slot, digested as a replicated surface of their own.
BASIS_FIELDS = ('basis_qa', 'basis_qg')


@dataclasses.dataclass(frozen=True)
class ConsistencyConfig:
    """Static knobs of the cross-replica consistency guard (JAX
    ``consistency.py:114-164``).

    Args:
        cadence: steps between checks; a check runs at the end of every
            step whose index is a multiple of the cadence.  A divergence
            is detected at most ``cadence`` steps after it occurs.
        repair: ``'broadcast'`` (detect and walk the repair ladder) or
            ``'detect'`` (count and quarantine only; state is never
            rewritten).
        quarantine_after: consecutive disagreeing checks before a slot
            is quarantined to SGD.  Strikes reset when the slot agrees.
        include_hyperparams: digest the hyperparameter scalars too;
            disagreement is counted, never repaired (host values).
    """

    cadence: int = 10
    repair: str = 'broadcast'
    quarantine_after: int = 3
    include_hyperparams: bool = True

    def __post_init__(self) -> None:
        if self.cadence < 1:
            raise ValueError('cadence must be >= 1')
        if self.repair not in ('broadcast', 'detect'):
            raise ValueError(
                f"repair must be 'broadcast' or 'detect', got "
                f'{self.repair!r}',
            )
        if self.quarantine_after < 1:
            raise ValueError('quarantine_after must be >= 1')


# ----------------------------------------------------------------------
# digests (local, per rank)
# ----------------------------------------------------------------------


def sanitize(x: torch.Tensor) -> torch.Tensor:
    """f32 copy of ``x`` with non-finite values mapped to sentinels
    (bool and integer inputs cast exactly)."""
    return torch.nan_to_num(
        x.to(torch.float32),
        nan=_NAN_SENTINEL, posinf=_POSINF_SENTINEL, neginf=_NEGINF_SENTINEL,
    )


def _bits(x: torch.Tensor) -> torch.Tensor:
    """int32 view of ``x``'s f32 bit patterns (bf16, bool and int widen
    exactly first)."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def _u32_sum(bits: torch.Tensor, dim=None) -> torch.Tensor:
    """The modular u32 sum of int32 bit patterns as int64 values in
    ``[0, 2^32)``: the signed int64 sum is congruent to the unsigned one
    mod ``2^32``, so no widened copy of the input is made."""
    if dim is None:
        s = torch.sum(bits, dtype=torch.int64)
    else:
        s = torch.sum(bits, dim=dim, dtype=torch.int64)
    return s & _U32


def _maxabs_bits(s: torch.Tensor, dim=None) -> torch.Tensor:
    """Bit pattern of the sanitized max-abs (0 for no element), as int64:
    nonnegative f32 values are monotone in their bits, so a max of the
    patterns folds as a max of the values."""
    a = s.abs()
    if dim is None:
        m = (a.amax() if a.numel() else
             torch.zeros((), dtype=torch.float32, device=s.device))
    else:
        m = a.amax(dim=dim)
    return m.contiguous().view(torch.int32).to(torch.int64)


def array_digest(x: torch.Tensor) -> torch.Tensor:
    """``[2]`` ``(bit-pattern sum, max-abs bits)`` digest of one tensor."""
    return torch.stack([_u32_sum(_bits(x)), _maxabs_bits(sanitize(x))])


def stack_digest(x: torch.Tensor) -> torch.Tensor:
    """``[L, 2]`` per-slot digest of a leading-``L`` stack (trailing dims
    reduced)."""
    n = x.shape[0]
    bits = _bits(x).reshape(n, -1)
    s = sanitize(x).reshape(n, -1)
    return torch.stack([_u32_sum(bits, dim=1), _maxabs_bits(s, dim=1)],
                       dim=1)


def fold(digests: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fold the digests of one surface's tensors: sums add mod ``2^32``,
    maxima max."""
    out = digests[0]
    for d in digests[1:]:
        out = torch.stack(
            [(out[..., 0] + d[..., 0]) & _U32,
             torch.maximum(out[..., 1], d[..., 1])], dim=-1,
        )
    return out


def hp_vector(hp: Mapping[str, float]) -> torch.Tensor | None:
    """``[k]`` u32 bit patterns (int64) of the hyperparameter scalars
    rounded to f32, in :data:`HP_DIGEST_KEYS` order."""
    vals = [float(hp[k]) for k in HP_DIGEST_KEYS
            if k in hp and hp[k] is not None]
    if not vals:
        return None
    t = sanitize(torch.tensor(vals, dtype=torch.float32))
    return _bits(t).to(torch.int64) & _U32


def canonical_rank(ag: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Majority vote over gathered digests (JAX ``_canonical_rank``).

    ``ag`` is ``[R, ..., 2]`` (replica-major).  Per unit, each replica's
    agreement count is how many replicas share its digest exactly; the
    canonical replica is the lowest rank among those with the largest
    count.  Returns ``(canonical [...] int32, mask [...] bool)``, the
    mask True where any replica disagrees."""
    ag = np.asarray(ag)
    R = ag.shape[0]
    eq = np.all(ag[:, None] == ag[None, :], axis=-1)
    counts = np.sum(eq.astype(np.int32), axis=1)
    maj = np.max(counts, axis=0)
    ranks = np.arange(R, dtype=np.int32).reshape(
        (R,) + (1,) * (counts.ndim - 1),
    )
    canon = np.min(np.where(counts == maj, ranks, np.int32(R)), axis=0)
    return canon.astype(np.int32), maj < R


# ----------------------------------------------------------------------
# surfaces
# ----------------------------------------------------------------------


def _fields(node: Any, skip: Sequence[str] = ()) -> list[tuple[str, Any]]:
    """``(name, tensor)`` of a dataclass's set tensor fields, by name."""
    out = []
    for f in sorted(dataclasses.fields(node), key=lambda f: f.name):
        v = getattr(node, f.name)
        if f.name not in skip and isinstance(v, torch.Tensor):
            out.append((f.name, v))
    return out


@dataclasses.dataclass
class CheckResult:
    """One check's verdicts, the same on every rank (host arrays).

    ``layer_mask``/``layer_canon`` per layer in sorted-name order,
    ``basis_mask``/``basis_canon`` per bucket with EKFAC bases (keys in
    ``basis_keys``), ``hp_mask`` per hyperparameter scalar (``None``
    when not digested), ``bucket_masks``/``bucket_canon`` per bucket
    over all its slots (every column), the canonical one as a global
    rank; ``gathered`` the ``[world, K]`` digest vectors of every rank
    (``None`` with one rank) and ``gathered_bytes`` what the all-gather
    moved into each rank."""

    layer_names: list[str]
    layer_mask: np.ndarray
    layer_canon: np.ndarray
    basis_keys: list[str]
    basis_mask: np.ndarray
    basis_canon: np.ndarray
    hp_mask: np.ndarray | None
    bucket_masks: dict[str, np.ndarray]
    bucket_canon: dict[str, np.ndarray]
    gathered: np.ndarray | None = None
    gathered_bytes: int = 0

    def info(self) -> dict[str, torch.Tensor]:
        """``consistency/*`` counts (JAX ``check_info``'s keys; the basis
        count only where bases exist)."""
        def i32(v):
            return torch.tensor(int(v), dtype=torch.int32)

        layer = int(self.layer_mask.sum())
        hp = 0 if self.hp_mask is None else int(self.hp_mask.sum())
        buckets = {k: int(m.sum()) for k, m in self.bucket_masks.items()}
        info = {
            'consistency/checked': i32(1),
            'consistency/layer_mismatches': i32(layer),
            'consistency/hp_mismatches': i32(hp),
            'consistency/bucket_mismatches': i32(sum(buckets.values())),
        }
        for key, n in buckets.items():
            info[f'consistency/bucket/{key}'] = i32(n)
        total = layer + hp + sum(buckets.values())
        if self.basis_keys:
            basis = int(self.basis_mask.sum())
            info['consistency/basis_mismatches'] = i32(basis)
            total += basis
        info['consistency/mismatches'] = i32(total)
        return info


def check(
    layers: Mapping[str, Any],
    buckets: Mapping[str, Any],
    plan: Any,
    hp: Mapping[str, float],
    grid: Any,
    *,
    include_hp: bool = True,
) -> CheckResult:
    """Digest every surface, gather the digest vectors over the world in
    one ``all_gather_into_tensor`` and vote (one host read of the
    gathered digests).  With one rank nothing is digested or gathered
    and every mask is clean.  Every rank must call it."""
    names = sorted(layers)
    keys = [b.key for b in plan.buckets]
    basis_keys = [k for k in keys
                  if getattr(buckets[k], 'basis_qa', None) is not None]
    hp_bits = hp_vector(hp) if include_hp else None
    world = group_size(None) if grid is None else grid.world
    n_hp = 0 if hp_bits is None else int(hp_bits.numel())
    if world <= 1:
        return CheckResult(
            layer_names=names,
            layer_mask=np.zeros(len(names), bool),
            layer_canon=np.zeros(len(names), np.int32),
            basis_keys=basis_keys,
            basis_mask=np.zeros(len(basis_keys), bool),
            basis_canon=np.zeros(len(basis_keys), np.int32),
            hp_mask=None if hp_bits is None else np.zeros(n_hp, bool),
            bucket_masks={b.key: np.zeros(b.n_slots, bool)
                          for b in plan.buckets},
            bucket_canon={b.key: np.zeros(b.n_slots, np.int32)
                          for b in plan.buckets},
        )
    any_t = next(iter(layers.values())).a_factor
    device = any_t.device
    parts = [fold([array_digest(t) for _, t in _fields(layers[n])])
             for n in names]
    parts += [fold([array_digest(getattr(buckets[k], f))
                    for f in BASIS_FIELDS]) for k in basis_keys]
    flat = [torch.stack(parts).reshape(-1)] if parts else []
    if hp_bits is not None:
        flat.append(hp_bits.to(device))
    for k in keys:
        fields = _fields(buckets[k], skip=BASIS_FIELDS)
        flat.append(fold([stack_digest(t) for _, t in fields]).reshape(-1))
    local = torch.cat(flat)
    gathered = torch.empty(world * local.numel(), dtype=torch.int64,
                           device=device)
    dist.all_gather_into_tensor(gathered, local)
    ag = gathered.view(world, -1).cpu().numpy()
    nl, nb = len(names), len(basis_keys)
    off = 0
    layer_canon, layer_mask = canonical_rank(
        ag[:, off:off + 2 * nl].reshape(world, nl, 2))
    off += 2 * nl
    basis_canon, basis_mask = canonical_rank(
        ag[:, off:off + 2 * nb].reshape(world, nb, 2))
    off += 2 * nb
    hp_mask = None
    if hp_bits is not None:
        h = ag[:, off:off + n_hp]
        hp_mask = h.min(axis=0) != h.max(axis=0)
        off += n_hp
    rows, cols = grid.rows, grid.cols
    bucket_masks, bucket_canon = {}, {}
    for b in plan.buckets:
        seg = b.seg
        d = ag[:, off:off + 2 * seg].reshape(world, seg, 2)
        off += 2 * seg
        mask = np.zeros(b.n_slots, bool)
        canon = np.zeros(b.n_slots, np.int32)
        if rows > 1:
            for c in range(cols):
                members = [r * cols + c for r in range(rows)]
                row_canon, m = canonical_rank(d[members])
                mask[c * seg:(c + 1) * seg] = m
                canon[c * seg:(c + 1) * seg] = row_canon * cols + c
        bucket_masks[b.key] = mask
        bucket_canon[b.key] = canon
    return CheckResult(
        layer_names=names, layer_mask=layer_mask, layer_canon=layer_canon,
        basis_keys=basis_keys, basis_mask=basis_mask,
        basis_canon=basis_canon, hp_mask=hp_mask,
        bucket_masks=bucket_masks, bucket_canon=bucket_canon, gathered=ag,
        gathered_bytes=gathered.numel() * gathered.element_size(),
    )


def check_info(
    layers: Mapping[str, Any],
    buckets: Mapping[str, Any],
    plan: Any,
    hp: Mapping[str, float],
    grid: Any,
    *,
    include_hp: bool = True,
) -> dict[str, torch.Tensor]:
    """The ``consistency/*`` counts of one :func:`check`."""
    return check(layers, buckets, plan, hp, grid,
                 include_hp=include_hp).info()


def mismatch_masks(
    result: CheckResult,
) -> tuple[np.ndarray, dict[str, np.ndarray], np.ndarray | None]:
    """``(layer mask in sorted-name order, {bucket key: [L] mask}, hp
    mask or None)`` of a check: the detect-only ladder's input."""
    return result.layer_mask, dict(result.bucket_masks), result.hp_mask


# ----------------------------------------------------------------------
# deterministic repair (broadcast of the canonical replica)
# ----------------------------------------------------------------------


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of a contiguous tensor's memory (a one-element
    slice of a gathered buffer keeps the buffer's row stride, which
    ``view(dtype)`` refuses, so it is restrided first)."""
    v = t.reshape(-1)
    if v.numel() == 1 and v.stride(0) != 1:
        v = v.as_strided((1,), (1,))
    return v.view(torch.uint8)


def _broadcast_bytes(tensors: Sequence[torch.Tensor], src: int,
                     group) -> None:
    """Overwrite ``tensors`` (contiguous) on every rank of ``group`` with
    rank ``src``'s bytes, in one broadcast of their packed bytes."""
    packed = torch.cat([_byte_view(t) for t in tensors])
    dist.broadcast(packed, src=src, group=group)
    off = 0
    for t in tensors:
        view = _byte_view(t)
        view.copy_(packed[off:off + view.numel()])
        off += view.numel()


def _contiguous_fields(node: Any, skip: Sequence[str] = ()) -> list:
    """The set tensor fields of a dataclass, made contiguous in place
    (a repair writes into them)."""
    out = []
    for name, t in _fields(node, skip):
        if not t.is_contiguous():
            t = t.contiguous()
            setattr(node, name, t)
        out.append(t)
    return out


def repair_state(
    result: CheckResult,
    layers: Mapping[str, Any],
    buckets: Mapping[str, Any],
    plan: Any,
    grid: Any,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Broadcast every divergent surface's canonical replica (rung 1),
    in place: a layer's tensors over the world, a bucket slot's over its
    grid column, the EKFAC bases over the world.  Returns the masks of
    what disagreed (the ladder's strike input).  Every rank must call
    it with the same ``result``; the broadcasts depend on the masks
    only, which are the same on every rank of each group."""
    if grid is None or grid.world <= 1:
        return result.layer_mask, dict(result.bucket_masks)
    for i, name in enumerate(result.layer_names):
        if result.layer_mask[i]:
            _broadcast_bytes(_contiguous_fields(layers[name]),
                             int(result.layer_canon[i]), None)
    for i, key in enumerate(result.basis_keys):
        if result.basis_mask[i]:
            bs = buckets[key]
            for f in BASIS_FIELDS:
                if not getattr(bs, f).is_contiguous():
                    setattr(bs, f, getattr(bs, f).contiguous())
            _broadcast_bytes([getattr(bs, f) for f in BASIS_FIELDS],
                             int(result.basis_canon[i]), None)
    if grid.rows > 1:
        for b in plan.buckets:
            first = grid.col * b.seg
            mask = result.bucket_masks[b.key][first:first + b.seg]
            if not mask.any():
                continue
            fields = _contiguous_fields(buckets[b.key], BASIS_FIELDS)
            for s in np.flatnonzero(mask):
                src = int(result.bucket_canon[b.key][first + s])
                _broadcast_bytes([t[s] for t in fields], src,
                                 grid.col_group)
    return result.layer_mask, dict(result.bucket_masks)


def apply_quarantine(
    buckets: Mapping[str, Any],
    masks: Mapping[str, np.ndarray],
    grid: Any,
) -> None:
    """OR the ladder's quarantine masks (``[L]`` per bucket, every
    column's slots) into this rank's column of each bucket's
    ``quarantined`` mask, in place (rung 3; sticky until a
    health-managed refresh lifts it)."""
    for key, mask in masks.items():
        bs = buckets[key]
        if bs.quarantined is None:
            raise ValueError(
                f'bucket {key!r} carries no quarantine mask — '
                'consistency quarantine requires the guard (or health) '
                'to have been enabled at init',
            )
        seg = bs.quarantined.shape[0]
        first = (0 if grid is None else grid.col) * seg
        local = torch.as_tensor(np.asarray(mask, bool)[first:first + seg],
                                device=bs.quarantined.device)
        bs.quarantined = bs.quarantined | local


# ----------------------------------------------------------------------
# forensics (tests and drills)
# ----------------------------------------------------------------------


def host_replica_divergence(
    tensors: Mapping[str, torch.Tensor], group=None,
) -> dict[str, int]:
    """Per named tensor, how many ranks of ``group`` (default: the
    world) hold bytes that differ from the group's first rank's: empty
    when every replica is bitwise equal.  Gathers every tensor's bytes;
    every rank of the group must call it with the same names and
    shapes."""
    out: dict[str, int] = {}
    n = group_size(group)
    if n <= 1:
        return out
    for name in sorted(tensors):
        local = _byte_view(tensors[name].contiguous())
        gathered = torch.empty(n * local.numel(), dtype=torch.uint8,
                               device=local.device)
        dist.all_gather_into_tensor(gathered, local, group=group)
        rows = gathered.view(n, -1)
        bad = int(sum(not torch.equal(rows[0], rows[r])
                      for r in range(1, n)))
        if bad:
            out[name] = bad
    return out
