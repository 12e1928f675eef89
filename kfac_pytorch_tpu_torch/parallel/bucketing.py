"""Shape bucketing and slot layout for stacked K-FAC layer state.

Port of ``kfac_pytorch_tpu/parallel/bucketing.py:43-335``.
Layers are grouped into buckets of equal padded factor shape
``(a_pad, g_pad)`` so each bucket's decompositions and rotations run as
one batched call over an ``[L, n, n]`` stack.  Bucket keys, bucket
order and slot order are the JAX package's.

Slots are laid out column-major over the KAISA grid's ``n_cols``
gradient-worker columns: column ``c`` owns ``slots[c*seg:(c+1)*seg]``.
Each bucket's layers go one by one to the least-loaded column, with the
loads carried across buckets, so later buckets can come out unevenly
padded; that is the JAX layout and is kept as it is.

:func:`make_stagger_plan` partitions every bucket slot into ``K``
cost-balanced refresh shards for ``stagger_refresh=K``, and
:func:`make_pipeline_order` orders the buckets for the pipelined gradient
gather of ``pipeline_grads``, and :func:`layout_signature` /
:func:`signature_slot_map` describe a plan to the streaming checkpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, TYPE_CHECKING

if TYPE_CHECKING:  # the layers package imports this one through ops
    from kfac_pytorch_tpu_torch.layers.helpers import LayerHelper


def pad_dim(n: int) -> int:
    """Canonical padded size for a factor dimension.

    Small dims snap to 32/64, mid dims to multiples of 64, large dims to
    multiples of 128.  Fewer canonical sizes means more layers share a
    bucket, so fewer kernel launches per step.
    """
    if n <= 0:
        raise ValueError(f'factor dim must be positive, got {n}')
    if n <= 32:
        return 32
    if n <= 64:
        return 64
    if n <= 768:
        return -(-n // 64) * 64
    return -(-n // 128) * 128


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """One bucket of same-padded-shape layers.

    Attributes:
        key: stable bucket id, ``f'a{a_pad}g{g_pad}'``.
        a_pad: padded A-factor dimension.
        g_pad: padded G-factor dimension.
        slots: slot index -> layer name, ``None`` for padding slots,
            column-major over ``n_cols`` columns of ``seg`` slots.
        seg: slots per column.
    """

    key: str
    a_pad: int
    g_pad: int
    slots: tuple[str | None, ...]
    seg: int

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def column_slots(self, col: int) -> tuple[str | None, ...]:
        """The ``seg`` slots column ``col`` owns."""
        return self.slots[col * self.seg:(col + 1) * self.seg]


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Bucketing plan for a registered model.

    Attributes:
        buckets: all buckets, in descending per-slot cost order.
        n_cols: gradient-worker columns of the KAISA grid.
        slot_of: layer name -> ``(bucket_key, slot_index)``.
    """

    buckets: tuple[BucketLayout, ...]
    n_cols: int
    slot_of: Mapping[str, tuple[str, int]]

    def bucket(self, key: str) -> BucketLayout:
        for b in self.buckets:
            if b.key == key:
                return b
        raise KeyError(key)


def make_bucket_plan(
    helpers: Mapping[str, LayerHelper],
    n_cols: int = 1,
) -> BucketPlan:
    """Bucket layers by padded factor shape and assign columns.

    Buckets are ordered by descending per-slot eigh cost
    ``a_pad^3 + g_pad^3``; layers within a bucket are sorted by name and
    each goes to the least-loaded column (the native packer of
    :mod:`kfac_pytorch_tpu_torch._native` when it built).
    """
    if n_cols < 1:
        raise ValueError('n_cols must be >= 1')
    grouped: dict[tuple[int, int], list[str]] = {}
    for name, helper in helpers.items():
        a_pad = pad_dim(helper.a_factor_shape[0])
        g_pad = pad_dim(helper.g_factor_shape[0])
        grouped.setdefault((a_pad, g_pad), []).append(name)
    ordered = sorted(
        grouped.items(),
        key=lambda kv: (kv[0][0] ** 3 + kv[0][1] ** 3, kv[0]),
        reverse=True,
    )
    # The native (C++) column packer when it built; the loop below is
    # its Python twin (tests/test_torch_native.py holds them equal).
    from kfac_pytorch_tpu_torch import _native

    native_cols = _native.bucket_columns(
        [len(names) for _, names in ordered],
        [float(a ** 3 + g ** 3) for (a, g), _ in ordered],
        n_cols,
    )
    flat_idx = 0
    col_loads = [0.0] * n_cols
    buckets: list[BucketLayout] = []
    slot_of: dict[str, tuple[str, int]] = {}
    for (a_pad, g_pad), names in ordered:
        cost = float(a_pad ** 3 + g_pad ** 3)
        per_col: list[list[str]] = [[] for _ in range(n_cols)]
        for name in sorted(names):
            if native_cols is not None:
                c = native_cols[flat_idx]
                flat_idx += 1
            else:
                c = min(range(n_cols), key=lambda i: (col_loads[i], i))
            per_col[c].append(name)
            col_loads[c] += cost
        seg = max(1, max(len(col) for col in per_col))
        slots: list[str | None] = []
        for col in per_col:
            slots.extend(col)
            slots.extend([None] * (seg - len(col)))
        key = f'a{a_pad}g{g_pad}'
        buckets.append(BucketLayout(
            key=key, a_pad=a_pad, g_pad=g_pad, slots=tuple(slots), seg=seg,
        ))
        for i, name in enumerate(slots):
            if name is not None:
                slot_of[name] = (key, i)
    return BucketPlan(buckets=tuple(buckets), n_cols=n_cols, slot_of=slot_of)


@dataclasses.dataclass(frozen=True)
class StaggerPlan:
    """Cost-balanced partition of all bucket slots into refresh shards
    (``stagger_refresh=K``; JAX ``parallel/bucketing.py:115-146``).

    Attributes:
        n_shards: number of refresh shards ``K``.
        shards: ``shards[k]`` maps bucket key -> the sorted slot indices
            (in the whole bucket) shard ``k`` refreshes; buckets without
            slots in a shard are absent.  Every slot, padding slots
            included, lies in exactly one shard, so a sweep of shards
            ``0..K-1`` recomputes what one monolithic refresh does.
        costs: per-shard summed ``a_pad^3 + g_pad^3``.
    """

    n_shards: int
    shards: tuple[Mapping[str, tuple[int, ...]], ...]
    costs: tuple[float, ...]

    def shard_of(self, bucket_key: str, slot: int) -> int:
        for k, shard in enumerate(self.shards):
            if slot in shard.get(bucket_key, ()):
                return k
        raise KeyError((bucket_key, slot))


def make_stagger_plan(plan: BucketPlan, n_shards: int) -> StaggerPlan:
    """Partition a bucket plan's slots into ``n_shards`` LPT shards
    (JAX ``parallel/bucketing.py:149-193``).

    One slot of bucket ``(a_pad, g_pad)`` costs ``a_pad^3 + g_pad^3``
    (two ``eigh`` calls); the partition is
    :meth:`~kfac_pytorch_tpu_torch.assignment.KAISAAssignment.\
greedy_assignment` with one worker group per shard, so shards and costs
    are the JAX package's slot for slot.  Padding slots cost as much as
    occupied ones (their identity blocks are decomposed either way) and
    take part in the balance.  Shards come out empty when ``n_shards``
    exceeds the slot count; the engine runs a plain step on those.
    """
    if n_shards < 1:
        raise ValueError(f'n_shards must be >= 1, got {n_shards}')
    from kfac_pytorch_tpu_torch.assignment import KAISAAssignment

    work = {
        f'{b.key}:{i}': {'AG': float(b.a_pad ** 3 + b.g_pad ** 3)}
        for b in plan.buckets
        for i in range(b.n_slots)
    }
    assignments = KAISAAssignment.greedy_assignment(
        work,
        worker_groups=[[k] for k in range(n_shards)],
        world_size=n_shards,
        colocate_factors=True,
    )
    shards: list[dict[str, list[int]]] = [{} for _ in range(n_shards)]
    costs = [0.0] * n_shards
    for name, factors in assignments.items():
        key, slot = name.rsplit(':', 1)
        k = factors['AG']
        shards[k].setdefault(key, []).append(int(slot))
        costs[k] += work[name]['AG']
    return StaggerPlan(
        n_shards=n_shards,
        shards=tuple(
            {key: tuple(sorted(slots)) for key, slots in sorted(s.items())}
            for s in shards
        ),
        costs=tuple(costs),
    )


def make_pipeline_order(plan: BucketPlan) -> tuple[str, ...]:
    """The issue order of the pipelined gradient gather
    (``pipeline_grads``; JAX ``parallel/bucketing.py:196-216``): bucket
    keys by descending gather payload ``n_slots * g_pad * a_pad``, the key
    breaking ties.  Each bucket's gather is issued as soon as its rotation
    is done, so the next bucket's rotation hides it; the one gather that
    nothing hides, the last, is then the cheapest bucket's."""
    return tuple(
        b.key for b in sorted(
            plan.buckets,
            key=lambda b: (-float(b.n_slots * b.g_pad * b.a_pad), b.key),
        )
    )


def layout_signature(plan: BucketPlan) -> dict:
    """JSON-portable fingerprint of a plan's bucket and slot layout (JAX
    ``parallel/bucketing.py:219-244``).

    The streaming checkpoints (:mod:`kfac_pytorch_tpu_torch.elastic`)
    save it beside the stacked curvature state: equal signatures mean
    the saved ``[L, ...]`` stacks drop straight into the live buckets,
    unequal ones that the restore transplants them slot by slot.  The
    port's plans are the JAX package's, so for the same model and
    ``n_cols`` the signatures are equal once JAX's ``/`` in layer names
    reads ``.``.
    """
    return {
        'n_cols': plan.n_cols,
        'buckets': [
            {
                'key': b.key,
                'a_pad': b.a_pad,
                'g_pad': b.g_pad,
                'seg': b.seg,
                'slots': list(b.slots),
            }
            for b in plan.buckets
        ],
    }


def signature_slot_map(signature: Mapping) -> dict[str, tuple[str, int]]:
    """Layer name -> ``(bucket key, slot index)`` of a saved
    :func:`layout_signature` (JAX ``parallel/bucketing.py:247-258``): the
    saved side's ``BucketPlan.slot_of``, which finds a layer's rows in
    stacks saved at any world size."""
    out: dict[str, tuple[str, int]] = {}
    for bucket in signature['buckets']:
        for i, name in enumerate(bucket['slots']):
            if name is not None:
                out[name] = (bucket['key'], i)
    return out
