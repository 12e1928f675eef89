"""Shape bucketing and slot layout for stacked K-FAC layer state.

Port of ``kfac_pytorch_tpu/parallel/bucketing.py:43-112,259-335``.
Layers are grouped into buckets of equal padded factor shape
``(a_pad, g_pad)`` so each bucket's decompositions and rotations run as
one batched call over an ``[L, n, n]`` stack.  Bucket keys, bucket
order and slot order are the JAX package's.  This slice runs on one
device, so plans have one column (``n_cols=1``); the column-major
layout is kept for the multi-rank slice.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

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


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Bucketing plan for a registered model.

    Attributes:
        buckets: all buckets, in descending per-slot cost order.
        n_cols: gradient-worker columns (1 on one device).
    """

    buckets: tuple[BucketLayout, ...]
    n_cols: int


def make_bucket_plan(
    helpers: Mapping[str, LayerHelper],
    n_cols: int = 1,
) -> BucketPlan:
    """Bucket layers by padded factor shape and assign columns.

    Buckets are ordered by descending per-slot eigh cost
    ``a_pad^3 + g_pad^3``; layers within a bucket are sorted by name and
    each goes to the least-loaded column.
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
    col_loads = [0.0] * n_cols
    buckets: list[BucketLayout] = []
    for (a_pad, g_pad), names in ordered:
        cost = float(a_pad ** 3 + g_pad ** 3)
        per_col: list[list[str]] = [[] for _ in range(n_cols)]
        for name in sorted(names):
            c = min(range(n_cols), key=lambda i: (col_loads[i], i))
            per_col[c].append(name)
            col_loads[c] += cost
        seg = max(1, max(len(col) for col in per_col))
        slots: list[str | None] = []
        for col in per_col:
            slots.extend(col)
            slots.extend([None] * (seg - len(col)))
        buckets.append(BucketLayout(
            key=f'a{a_pad}g{g_pad}', a_pad=a_pad, g_pad=g_pad,
            slots=tuple(slots), seg=seg,
        ))
    return BucketPlan(buckets=tuple(buckets), n_cols=n_cols)
