"""Collective audit: the port's counterpart of JAX's compiled-program
auditor (``kfac_pytorch_tpu/analysis/hlo.py`` and ``audit.py``).

JAX lowers each step variant on an 8-device CPU mesh and reads the
post-SPMD HLO.  The port has no HLO: its collectives are eager
``torch.distributed`` calls, issued by ``parallel/collectives.py``, the
consistency guard, the drift controller, the observe monitor, the
watchdog and DDP's reducer.  So the audit records them.
:class:`CollectiveRecorder` wraps ``torch.distributed``'s collectives
(``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
``broadcast``, ``reduce_scatter*``, ``all_to_all*``,
``batch_isend_irecv``) and files every call, in issue order, with its
op, dtype, element count, result bytes, group, ``async_op``, issuing
thread and class: the innermost caller named in :data:`LABELS`
(:func:`classify_collective`).  DDP's gradient all-reduce runs in the
C++ reducer; :meth:`CollectiveRecorder.hook` registers
:func:`grad_sync_hook`, which does what DDP's default all-reduce hook
does, so it is recorded too (class ``grad_sync``, recorded, not pinned,
as in JAX).

The lanes of :func:`run_audit` are JAX's 14 (``audit.py:1928-2525``), on
JAX's ``MLP(features=(32,)*8+(10,))`` at world 8, a global batch of 16,
``factor_update_steps=1, inv_update_steps=2``; each step variant is
forced as ``observe/costs.step_variant_costs`` forces it (the engine's
plan overridden), after one natural bootstrap step (``bootstrap``, the
step in which DDP still buckets in its first order).  A *program* is one
step's window: forward, backward and ``step()``.  Per lane the checks
are:

1. **byte parity per class** (exact): ``factor_allreduce``,
   ``grad_col_allgather`` (per bucket, in issue order, under
   ``pipeline_grads``), ``decomposition_gather`` (the ledger's
   ``inverse_row_allgather`` row, per stagger shard), and the guards'
   ``consistency_check``, ``adaptive_digest`` and ``watchdog_check``
   against ``observe/costs.ledger_for``'s rows, and each class absent
   where the variant issues none (no factor all-reduce on ``plain``, no
   gradient gather when ``cols == 1``, no decomposition gather when
   ``rows == 1``).  Under ``iterative`` the port gathers its roots over
   the column where ``rows > 1``: that is the analytic KAISA row,
   JAX's compiled ``inverse_row_allgather`` root reshard, not JAX's zero
   ``decomposition_gather`` (an XLA:CPU ``eigh``-input gather that the
   matmul-only refresh does not need);
2. **wire dtypes**: bf16 only on the factor all-reduce that
   ``factor_comm='bf16_triu'`` packs, with JAX's packed element count
   (:func:`expected_factor_elements`); any other bf16 or f16 is a
   violation, and the decomposition gather's floats are the inverse
   dtype;
3. **schedules**: each program's digest of ``op|dtype|numel|gNxS``
   entries equal on every rank (JAX's asymmetry scan), every occurrence
   of a program the same, and JAX's ten :data:`SCHEDULE_PINS` at their
   levels; where two threads or two communicators issue collectives, each
   rank's interleaving of them (the NCCL ordering rule: kernels of
   different communicators launch in the same order on every rank);
4. **placement containment**: on ``auto_placement`` (a declared 2 x 4
   :class:`~kfac_pytorch_tpu_torch.placement.PodTopology`) every
   collective whose phase the plan scopes ``'ici'`` runs inside one
   group;
5. **memory**: each program's ``torch.cuda.max_memory_allocated()``
   (reset before it) on CUDA, absent on the CPU; :func:`check_payload`
   fails a drift beyond :data:`MEMORY_TOLERANCE` against a baseline
   payload.

**No counterpart.**  Donation (the port has no compiled buffers to
alias), the HLO parser, and the async start/done brackets of JAX's
pipeline and overlap lanes (eager calls have no dataflow graph to
bracket).  The nearest check is the recorded issue order: under
``pipeline_grads`` bucket ``k``'s gather is issued asynchronously before
bucket ``k+1``'s tail starts (so before its kernel launch) and before
the kl-clip scale exists (so it carries the unscaled stack), and the
synchronous tail of ``hybrid_opt`` is the contrast that must fail.
Under ``overlap_comm`` the deferred refresh's gathers are issued on the
main thread at the collect point (``overlap.py``), inside the collecting
program, as JAX's deferred refresh is inside its ``+overlap_inv``
program.

The port's bytes differ from JAX's compiled ones by named terms, never
by a tolerance (``observe/costs.py``'s docstring): the gradient gather
carries one f32 kl-clip term a slot; the factor all-reduce carries an
f64 vector of row counts, their squares and the micro-batch counts, and
one contribution per layer where JAX reduces one per call; the
decomposition gather moves the analytic ``inverse_row_allgather`` row
where JAX's pin is XLA:CPU's gather of the ``eigh`` inputs.

CLI: ``python -m kfac_pytorch_tpu_torch.scripts.lint_torch --comm-audit
OUT.json`` (gloo ranks on the CPU, or sharing the card with ``--device
cuda``) and ``--comm-audit-validate PATH``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import threading
import time
from typing import Any, Iterable, Mapping, Sequence

import torch
import torch.distributed as dist

__all__ = [
    'AUDIT_SCHEMA_VERSION',
    'LABELS',
    'LANES',
    'MEMORY_TOLERANCE',
    'SCHEDULE_PINS',
    'CollectiveCall',
    'CollectiveRecorder',
    'check_payload',
    'classify_collective',
    'expected_factor_elements',
    'format_payload',
    'grad_sync_hook',
    'lane_report',
    'lane_summary',
    'merge_rank_reports',
    'program_report',
    'run_audit',
    'schedule_class_key',
    'schedule_digest_of',
    'validate_payload',
]

AUDIT_SCHEMA_VERSION = 1

#: A program's peak memory drifting beyond this fraction of the baseline
#: payload's fails :func:`check_payload` (JAX ``audit.py:131``).
MEMORY_TOLERANCE = 0.10

#: ``(file name, function name) -> class``: a collective is filed under
#: the innermost caller on its stack named here (the generalisation of
#: the smoke test's former ``LEDGER_LABELS``); ``'other'`` otherwise.
LABELS: dict[tuple[str, str], str] = {
    ('base_preconditioner.py', '_update_factors'): 'factor_allreduce',
    ('collectives.py', 'all_gather_decompositions'): 'decomposition_gather',
    ('collectives.py', 'all_gather_preconditioned'): 'grad_col_allgather',
    ('collectives.py', 'all_gather_preconditioned_async'):
        'grad_col_allgather',
    ('second_order.py', '_health_counters'): 'health_counters',
    ('second_order.py', '_with_ekfac_bases'): 'ekfac_basis_row_allgather',
    ('second_order.py', 'ekfac_divergence'): 'ekfac_divergence_gather',
    ('second_order.py', 'curvature_stats'): 'observe_extremes',
    ('second_order.py', 'gather_stacks'): 'checkpoint_gather',
    ('base_preconditioner.py', '_ekfac_scales'): 'checkpoint_gather',
    ('consistency.py', 'check'): 'consistency_check',
    ('consistency.py', '_broadcast_bytes'): 'consistency_repair',
    ('consistency.py', 'repair_replicated'): 'consistency_repair',
    ('consistency.py', 'host_replica_divergence'): 'replica_divergence',
    ('watchdog.py', '_sync_pending'): 'watchdog_check',
    ('adaptive.py', 'drift_info'): 'adaptive_digest',
    ('engine.py', '_adapt_inputs'): 'adaptive_damping_loss',
    ('audit.py', 'grad_sync_hook'): 'grad_sync',
}

#: The ledger phase each pinned class is held to (its shard and bucket
#: rows carry a suffix).
LEDGER_PHASE = {'decomposition_gather': 'inverse_row_allgather'}

#: The wrapped ``torch.distributed`` functions and the argument holding
#: each one's result.
_WRAPPED = {
    'all_reduce': 'tensor',
    'all_gather': 'tensor_list',
    'all_gather_into_tensor': 'output_tensor',
    'broadcast': 'tensor',
    'reduce_scatter': 'output',
    'reduce_scatter_tensor': 'output',
    'all_to_all': 'output_tensor_list',
    'all_to_all_single': 'output',
    'batch_isend_irecv': 'p2p_op_list',
}

_DTYPES = {
    torch.float32: 'f32', torch.bfloat16: 'bf16', torch.float16: 'f16',
    torch.float64: 'f64', torch.int64: 'i64', torch.int32: 'i32',
    torch.int16: 'i16', torch.int8: 'i8', torch.uint8: 'u8',
    torch.bool: 'pred',
}
_ITEMSIZE = {'f32': 4, 'bf16': 2, 'f16': 2, 'f64': 8, 'i64': 8, 'i32': 4,
             'i16': 2, 'i8': 1, 'u8': 1, 'pred': 1}


# ----------------------------------------------------------------------
# the recorder
# ----------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveCall:
    """One recorded collective (``op`` is the ``torch.distributed``
    function's name; a ``marker`` op is a compute marker of the
    pipelined tail, not a collective)."""

    seq: int
    op: str
    dtype: str
    numel: int
    nbytes: int
    ranks: tuple[int, ...]
    async_op: bool
    thread: str
    cls: str
    tag: str = ''

    def key(self, world: int) -> str:
        """``op|dtype|numel|gNxS``: N groups of S ranks (JAX's schedule
        key without the channel ordinal; the same on every rank)."""
        size = max(len(self.ranks), 1)
        return f'{self.op}|{self.dtype}|{self.numel}|g{world // size}x{size}'


def classify_collective(frame: Any) -> str:
    """The class of a collective issued under ``frame``: the innermost
    caller on the stack named in :data:`LABELS`, else ``'other'``."""
    while frame is not None:
        code = frame.f_code
        cls = LABELS.get((os.path.basename(code.co_filename), code.co_name))
        if cls is not None:
            return cls
        frame = frame.f_back
    return 'other'


def grad_sync_hook(state, bucket):  # DDP reads the annotations
    """DDP's default all-reduce comm hook
    (``torch.distributed.algorithms.ddp_comm_hooks.default_hooks.\
allreduce_hook``: divide by the group size, all-reduce asynchronously),
    under a name :data:`LABELS` files as ``grad_sync``."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    return default_hooks.allreduce_hook(state, bucket)


def _thread_name() -> str:
    t = threading.current_thread()
    if t is threading.main_thread():
        return 'main'
    return re.sub(r'[-_]?\d+$', '', t.name) or 'thread'


def _result_tensors(name: str, bound: inspect.BoundArguments) -> list:
    arg = bound.arguments.get(_WRAPPED[name])
    if name == 'batch_isend_irecv':
        return [op.tensor for op in arg]
    if isinstance(arg, (list, tuple)):
        return list(arg)
    return [arg]


class CollectiveRecorder:
    """Records every ``torch.distributed`` collective issued while it is
    entered (a context manager; entering twice is an error), and the
    pipelined tail's compute markers (``tail:<bucket>`` at the start of
    each bucket's tail, ``scale`` when the kl-clip scale is computed).

    ``begin()`` and ``end(name)`` bracket one program: the calls issued
    in between, from any thread, are filed under ``name``.  On CUDA
    ``end`` stores ``torch.cuda.max_memory_allocated()`` of the program
    (the peak is reset at ``begin``).
    """

    def __init__(self) -> None:
        self.calls: list[CollectiveCall] = []
        self.programs: list[dict[str, Any]] = []
        self._lock = threading.Lock()
        self._saved: dict[Any, tuple[Any, str, Any]] = {}
        self._since: int | None = None
        self._device: torch.device | None = None

    # -- wrapping -------------------------------------------------------

    def __enter__(self) -> 'CollectiveRecorder':
        if self._saved:
            raise RuntimeError('the recorder is already entered')
        for name in _WRAPPED:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[(dist, name)] = fn
            setattr(dist, name, self._wrap(name, fn))
        from kfac_pytorch_tpu_torch import ops
        from kfac_pytorch_tpu_torch.parallel import second_order

        cls = second_order.BucketedSecondOrder
        tail = cls._bucket_tail
        scale = ops.kl_clip_scale
        self._saved[(cls, '_bucket_tail')] = tail
        self._saved[(ops, 'kl_clip_scale')] = scale

        def marked_tail(so, b, *args, **kw):
            self._marker(f'tail:{b.key}')
            return tail(so, b, *args, **kw)

        def marked_scale(*args, **kw):
            self._marker('scale')
            return scale(*args, **kw)

        cls._bucket_tail = marked_tail
        ops.kl_clip_scale = marked_scale
        return self

    def __exit__(self, *exc: Any) -> None:
        for (owner, name), fn in self._saved.items():
            setattr(owner, name, fn)
        self._saved = {}

    def _wrap(self, name: str, fn: Any) -> Any:
        sig = inspect.signature(fn)

        def wrapped(*args, **kw):
            self._record(name, sig.bind(*args, **kw), sys._getframe(1))
            return fn(*args, **kw)

        wrapped.__wrapped__ = fn
        return wrapped

    def _record(self, name: str, bound: inspect.BoundArguments,
                frame: Any) -> None:
        tensors = [t for t in _result_tensors(name, bound)
                   if isinstance(t, torch.Tensor)]
        group = bound.arguments.get('group')
        if name == 'batch_isend_irecv':
            p2p = bound.arguments['p2p_op_list']
            group = p2p[0].group if p2p else None
        world = dist.get_world_size()
        ranks = (tuple(range(world)) if group is None
                 else tuple(dist.get_process_group_ranks(group)))
        dtypes = sorted({_DTYPES.get(t.dtype, str(t.dtype)) for t in tensors})
        with self._lock:
            self.calls.append(CollectiveCall(
                seq=len(self.calls), op=name, dtype='+'.join(dtypes),
                numel=sum(t.numel() for t in tensors),
                nbytes=sum(t.numel() * t.element_size() for t in tensors),
                ranks=ranks,
                async_op=bool(bound.arguments.get('async_op', False)
                              or name == 'batch_isend_irecv'),
                thread=_thread_name(), cls=classify_collective(frame),
            ))

    def _marker(self, tag: str) -> None:
        with self._lock:
            self.calls.append(CollectiveCall(
                seq=len(self.calls), op='marker', dtype='', numel=0,
                nbytes=0, ranks=(), async_op=False, thread=_thread_name(),
                cls='marker', tag=tag,
            ))

    def hook(self, ddp: torch.nn.parallel.DistributedDataParallel) -> None:
        """Route ``ddp``'s gradient all-reduce through
        :func:`grad_sync_hook` (before its first backward)."""
        ddp.register_comm_hook(None, grad_sync_hook)

    # -- programs ---------------------------------------------------------

    def begin(self, device: torch.device | None = None) -> None:
        """Open a program window (on a CUDA ``device`` the peak memory
        is reset)."""
        if self._since is not None:
            raise RuntimeError('a program window is already open')
        self._device = device
        if device is not None and device.type == 'cuda':
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        self._since = len(self.calls)

    def end(self, name: str, variant: str | None = None) -> dict[str, Any]:
        """Close the window: its calls are filed under ``name``
        (``variant``, the engine's step-variant name, defaults to it)."""
        if self._since is None:
            raise RuntimeError('no program window is open')
        device, self._device = self._device, None
        memory = None
        if device is not None and device.type == 'cuda':
            torch.cuda.synchronize(device)
            memory = int(torch.cuda.max_memory_allocated(device))
        with self._lock:
            calls = self.calls[self._since:]
            self._since = None
        rec = {'name': name, 'variant': variant or name, 'calls': calls,
               'memory': memory}
        self.programs.append(rec)
        return rec


# ----------------------------------------------------------------------
# schedules
# ----------------------------------------------------------------------

#: Cross-program pins (JAX ``audit.py:1622-1655``): variants whose ranks
#: must rendezvous, at ``exact`` (issue order), ``exact_bag`` (payload
#: multiset) or ``bag`` (class multiset) level.
SCHEDULE_PINS: tuple[tuple[str, str, str], ...] = (
    ('hybrid_watchdog/plain', 'hybrid_opt/plain', 'exact'),
    ('hybrid_watchdog/factor', 'hybrid_opt/factor', 'exact_bag'),
    ('hybrid_watchdog/inv', 'hybrid_opt/inv', 'exact_bag'),
    ('hybrid_consistency/plain', 'hybrid_opt/plain', 'exact'),
    ('hybrid_consistency/factor', 'hybrid_opt/factor', 'exact_bag'),
    ('hybrid_consistency/inv', 'hybrid_opt/inv', 'exact_bag'),
    ('hybrid_stagger2/plain+shard0', 'hybrid_stagger2/plain+shard1', 'bag'),
    ('hybrid_stagger2/factor+shard0', 'hybrid_stagger2/factor+shard1',
     'bag'),
    ('hybrid_adaptive/plain+shard0', 'hybrid_adaptive/plain+shard1', 'bag'),
    ('hybrid_adaptive/factor+shard0', 'hybrid_adaptive/factor+shard1',
     'bag'),
)

SCHEDULE_LEVEL_FIELDS = {
    'exact': 'digest',
    'exact_bag': 'exact_bag_digest',
    'class': 'class_digest',
    'bag': 'bag_digest',
}


def schedule_class_key(exact_key: str) -> str:
    """``op|dtype|numel|gNxS`` -> ``op|dtype|gNxS``."""
    parts = exact_key.split('|')
    return '|'.join((parts[0], parts[1], parts[3]))


def schedule_digest_of(entries: Iterable[str], level: str = 'exact') -> str:
    """sha256 of a program's entries at ``level``: ``exact`` in issue
    order, ``exact_bag`` sorted, ``class`` the class keys in order,
    ``bag`` the class keys sorted."""
    keys = list(entries)
    if level == 'class':
        keys = [schedule_class_key(k) for k in keys]
    elif level == 'bag':
        keys = sorted(schedule_class_key(k) for k in keys)
    elif level == 'exact_bag':
        keys = sorted(keys)
    elif level != 'exact':
        raise ValueError(f'unknown schedule level {level!r}')
    return hashlib.sha256('\n'.join(keys).encode()).hexdigest()


def _schedule_block(entries: Sequence[str]) -> dict[str, Any]:
    return {
        **{field: schedule_digest_of(entries, level)
           for level, field in SCHEDULE_LEVEL_FIELDS.items()},
        'n_collectives': len(entries),
    }


def _interleaving(entries: Sequence[str], threads: Sequence[str]) -> list:
    """``thread|gNxS`` runs of a program (one token per run of calls from
    one thread on one group shape)."""
    out: list[str] = []
    for e, t in zip(entries, threads):
        tok = f'{t}|{e.rsplit("|", 1)[1]}'
        if not out or out[-1] != tok:
            out.append(tok)
    return out


# ----------------------------------------------------------------------
# per-program report
# ----------------------------------------------------------------------


def program_report(calls: Sequence[CollectiveCall]) -> dict[str, Any]:
    """Per-class aggregate of one program's calls (markers left out):
    ``count``, ``elements``, ``result_bytes`` and ``dtypes`` per class,
    and ``n_collectives``."""
    classes: dict[str, dict[str, Any]] = {}
    n = 0
    for c in calls:
        if c.op == 'marker':
            continue
        n += 1
        agg = classes.setdefault(c.cls, {'count': 0, 'elements': 0,
                                         'result_bytes': 0, 'dtypes': []})
        agg['count'] += 1
        agg['elements'] += c.numel
        agg['result_bytes'] += c.nbytes
        for d in c.dtype.split('+'):
            if d and d not in agg['dtypes']:
                agg['dtypes'].append(d)
    for agg in classes.values():
        agg['dtypes'].sort()
    return {'collectives': classes, 'n_collectives': n}


def expected_factor_elements(precond: Any) -> int:
    """Factor elements one factor step's all-reduce moves (JAX
    ``audit.py:637``): ``d(d+1)/2`` per side of a compressed layer,
    ``a + g^2`` for a diagonal-A layer, ``a^2 + g^2`` otherwise; the
    port's f64 row-count vector is not a factor and is left out."""
    from kfac_pytorch_tpu_torch.observe import costs

    flags = costs.factor_comm_compress_flags(precond)
    total = 0
    for flag, h in zip(flags, precond.helpers.values()):
        a, g = h.a_factor_shape[0], h.g_factor_shape[0]
        if h.diagonal_a:
            total += a + g * g
        elif flag:
            total += a * (a + 1) // 2 + g * (g + 1) // 2
        else:
            total += a * a + g * g
    return total


def _compressed_elements(precond: Any) -> int:
    from kfac_pytorch_tpu_torch.observe import costs

    return sum(
        h.a_factor_shape[0] * (h.a_factor_shape[0] + 1) // 2
        + h.g_factor_shape[0] * (h.g_factor_shape[0] + 1) // 2
        for flag, h in zip(costs.factor_comm_compress_flags(precond),
                           precond.helpers.values()) if flag
    )


def _parse_variant(variant: str) -> tuple[str, int | None | str, bool]:
    """``(base, refresh, check)``: ``refresh`` is ``'full'``, a shard
    index or ``None``."""
    base, *suffixes = variant.split('+')
    refresh: int | str | None = 'full' if base == 'inv' else None
    for s in suffixes:
        if s in ('overlap_inv',):
            refresh = 'full'
        elif s.startswith('overlap_shard'):
            refresh = int(s[len('overlap_shard'):])
        elif s.startswith('shard'):
            refresh = int(s[len('shard'):])
    return base, refresh, 'consistency' in suffixes


def _expected(precond: Any, variant: str) -> dict[str, tuple[str, int]]:
    """``class -> (ledger phase, bytes)`` a program of ``variant`` must
    move, for the classes the engine's ledger prices."""
    from kfac_pytorch_tpu_torch.observe import costs

    ledger = {row.phase: row for row in costs.ledger_for(precond)}
    if variant == 'watchdog_check':
        row = ledger.get('watchdog_check')
        return {} if row is None else {
            'watchdog_check': ('watchdog_check', row.payload_bytes)}
    base, refresh, check = _parse_variant(variant)
    factor = base in ('factor', 'inv')
    out = {'factor_allreduce': (
        'factor_allreduce',
        ledger['factor_allreduce'].payload_bytes if factor else 0)}
    if refresh is None:
        out['decomposition_gather'] = ('inverse_row_allgather', 0)
    elif refresh == 'full':
        out['decomposition_gather'] = (
            'inverse_row_allgather',
            costs._decomposition_gather_bytes(precond, None))
    else:
        phase = f'inverse_row_allgather/shard{refresh}'
        out['decomposition_gather'] = (phase, ledger[phase].payload_bytes)
    out['grad_col_allgather'] = ('grad_col_allgather', sum(
        row.payload_bytes for row in ledger.values()
        if row.phase.startswith('grad_col_allgather')))
    if 'consistency_check' in ledger:
        out['consistency_check'] = (
            'consistency_check',
            ledger['consistency_check'].payload_bytes if check else 0)
    if 'adaptive_digest' in ledger:
        out['adaptive_digest'] = (
            'adaptive_digest',
            ledger['adaptive_digest'].payload_bytes if factor else 0)
    if 'watchdog_check' in ledger:
        out['watchdog_check'] = ('watchdog_check', 0)
    return out


def _parity_rows(precond: Any, program: str, variant: str,
                 calls: Sequence[CollectiveCall]) -> list[dict[str, Any]]:
    got = program_report(calls)['collectives']
    rows = []
    for cls, (phase, want) in _expected(precond, variant).items():
        have = got.get(cls, {}).get('result_bytes', 0)
        rows.append({'phase': phase if want else f'{phase}/absent',
                     'class': cls, 'program': program,
                     'ledger_bytes': want, 'recorded_bytes': have,
                     'match': have == want})
    return rows


def _pipeline_rows(precond: Any, program: str,
                   calls: Sequence[CollectiveCall]) -> tuple[list, list]:
    """Under ``pipeline_grads``: each bucket's gather, in issue order,
    against the ledger's ``grad_col_allgather/bucket<k>`` row; issued
    asynchronously before the next bucket's tail starts and before the
    kl-clip scale is computed.  Returns ``(rows, errors)``."""
    from kfac_pytorch_tpu_torch.observe import costs

    order = list(precond._second_order.pipeline_order or ())
    ledger = {row.phase: row for row in costs.ledger_for(precond)}
    gathers = [c for c in calls if c.cls == 'grad_col_allgather']
    if precond.grid.cols == 1:
        # One column: nothing to gather, every bucket row is 0 bytes.
        return [], ([f'{program}: {len(gathers)} gradient gathers with '
                     'one column'] if gathers else [])
    tails = {c.tag[len('tail:'):]: c.seq for c in calls
             if c.op == 'marker' and c.tag.startswith('tail:')}
    scale = min((c.seq for c in calls
                 if c.op == 'marker' and c.tag == 'scale'), default=None)
    rows, errs = [], []
    if len(gathers) != len(order):
        errs.append(f'{program}: {len(gathers)} gradient gathers for '
                    f'{len(order)} pipelined buckets')
    for k, (key, c) in enumerate(zip(order, gathers)):
        want = ledger[f'grad_col_allgather/bucket{k}'].payload_bytes
        nxt = tails.get(order[k + 1]) if k + 1 < len(order) else None
        before_next = nxt is None or c.seq < nxt
        unscaled = scale is None or c.seq < scale
        rows.append({'bucket': k, 'key': key, 'program': program,
                     'ledger_bytes': want, 'recorded_bytes': c.nbytes,
                     'async_op': c.async_op,
                     'before_next_tail': before_next,
                     'before_scale': unscaled,
                     'match': c.nbytes == want})
        if not (c.nbytes == want and c.async_op and before_next
                and unscaled):
            errs.append(f'{program}: bucket {k} ({key}) gather '
                        f'{c.nbytes} B against {want}, async {c.async_op}, '
                        f'before the next tail {before_next}, before the '
                        f'scale {unscaled}')
    return rows, errs


def _pipeline_contrast(calls: Sequence[CollectiveCall]) -> bool:
    """Whether a synchronous tail would pass the pipeline test: every
    gradient gather asynchronous (it must not)."""
    gathers = [c for c in calls if c.cls == 'grad_col_allgather']
    return bool(gathers) and all(c.async_op for c in gathers)


def _containment_rows(precond: Any, program: str,
                      calls: Sequence[CollectiveCall]) -> list:
    """Auto-placement: every collective of a plan-scoped phase against
    the topology's groups (``pinned`` where the plan says ``'ici'``)."""
    plan, topo = precond.placement_plan, precond.topology
    scopes = dict(plan.predicted.scopes)
    groups = topo.groups()
    phase_of = {'factor_allreduce': 'factor_allreduce',
                'grad_col_allgather': 'grad_col_allgather',
                'decomposition_gather': 'inverse_row_allgather'}
    rows = []
    for c in calls:
        phase = phase_of.get(c.cls)
        if phase is None:
            continue
        scope = scopes.get(phase)
        contained = any(set(c.ranks) <= g for g in groups)
        pinned = scope == 'ici'
        rows.append({'program': program, 'class': c.cls, 'phase': phase,
                     'plan_scope': scope, 'ranks': list(c.ranks),
                     'contained': contained, 'pinned': pinned,
                     'ok': contained or not pinned})
    return rows


def lane_report(
    lane: str,
    precond: Any,
    recorder: CollectiveRecorder,
    world: int,
    options: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """One rank's report of one lane from the programs ``recorder``
    bracketed: per program the schedule entries (with each entry's
    class, thread and ``async_op``) and its memory; the parity rows
    against this rank's ledger; the lane's wire facts; the pipeline and
    containment rows where they apply; and this rank's violations."""
    from kfac_pytorch_tpu_torch.observe import costs

    grid = precond.grid
    programs: dict[str, dict[str, Any]] = {}
    parity: list[dict[str, Any]] = []
    errs: list[str] = []
    pipeline: list[dict[str, Any]] = []
    containment: list[dict[str, Any]] = []
    contrast = None
    for rec in recorder.programs:
        calls = [c for c in rec['calls'] if c.op != 'marker']
        entries = [c.key(world) for c in calls]
        name = rec['name']
        if name in programs:
            if programs[name]['entries'] != entries:
                errs.append(f'{lane}/{name}: two runs of the program issued '
                            'different schedules')
            programs[name]['occurrences'] += 1
            if rec['memory'] is not None:
                programs[name]['memory'] = max(programs[name]['memory'],
                                               rec['memory'])
            continue
        programs[name] = {
            'variant': rec['variant'], 'entries': entries,
            'collectives': program_report(calls)['collectives'],
            'groups': [list(c.ranks) for c in calls],
            'classes': [c.cls for c in calls],
            'threads': [c.thread for c in calls],
            'async': [c.async_op for c in calls],
            'occurrences': 1,
            **({} if rec['memory'] is None else {'memory': rec['memory']}),
        }
        parity += _parity_rows(precond, name, rec['variant'], calls)
        if precond._second_order.pipeline_order is not None:
            rows, perrs = _pipeline_rows(precond, name, rec['calls'])
            pipeline += rows
            errs += [f'{lane}/{e}' for e in perrs]
        elif name == 'plain' and grid.cols > 1:
            contrast = _pipeline_contrast(rec['calls'])
        if getattr(precond, 'placement_plan', None) is not None:
            containment += _containment_rows(precond, name, calls)
    errs += [f'{lane}: parity {r["phase"]} ({r["program"]}): ledger '
             f'{r["ledger_bytes"]} != recorded {r["recorded_bytes"]}'
             for r in parity if not r['match']]
    ledger = {row.phase: {'payload_bytes': row.payload_bytes,
                          'bytes_per_device': row.bytes_per_device,
                          'cadence': row.cadence, 'scope': row.scope}
              for row in costs.ledger_for(precond)}
    so = precond._second_order
    out = {
        'grid_rows_x_cols': f'{grid.rows}x{grid.cols}',
        'options': dict(options or {}),
        'programs': programs,
        'parity': parity,
        'ledger': ledger,
        'shapes': {
            'buckets': [(b.n_slots, b.a_pad, b.g_pad, b.seg)
                        for b in so.plan.buckets],
            'layers': [(h.a_factor_shape[0], h.g_factor_shape[0],
                        bool(h.diagonal_a))
                       for h in precond.helpers.values()],
            'stagger_shards': costs.stagger_shard_shapes_for(so),
            'compute_method': so.compute_method.name.lower(),
        },
        'wire': {
            'compressed': any(costs.factor_comm_compress_flags(precond)),
            'compressed_elements': _compressed_elements(precond),
            'factor_elements': expected_factor_elements(precond),
            'inv_dtype': _DTYPES[precond._second_order.inv_dtype],
        },
        'violations': errs,
    }
    if pipeline:
        out['pipeline'] = pipeline
        out['pipeline_order'] = list(precond._second_order.pipeline_order)
    if contrast is not None:
        out['sync_tail_passes_pipeline_test'] = contrast
    if containment:
        plan = precond.placement_plan
        out['containment'] = containment
        out['placement'] = {
            'topology': precond.topology.describe(),
            'chosen_fraction': precond.grad_worker_fraction,
            'strategy': plan.strategy,
            'scopes': dict(plan.predicted.scopes),
        }
    return out


# ----------------------------------------------------------------------
# cross-rank checks (the validator's, from stored entries)
# ----------------------------------------------------------------------


def _wire_violations(lane: str, lp: Mapping[str, Any]) -> list[str]:
    """bf16 exactly where ``bf16_triu`` packs, with the packed element
    count; the decomposition gather's floats in the inverse dtype."""
    wire = lp['wire']
    errs = []
    for r, progs in enumerate(lp['ranks']):
        for name, p in progs.items():
            base = p['variant'].split('+')[0]
            packed = 0
            for i, (e, cls) in enumerate(zip(p['entries'], p['classes'])):
                dtypes = set(e.split('|')[1].split('+'))
                low = dtypes & {'bf16', 'f16'}
                floats = dtypes & {'f32', 'f64', 'bf16', 'f16'}
                if cls == 'factor_allreduce' and 'bf16' in dtypes:
                    packed += int(e.split('|')[2])
                if low and not (cls == 'factor_allreduce'
                                and wire['compressed'] and low == {'bf16'}):
                    errs.append(f'{lane}/{name} rank {r} entry {i}: {e} '
                                f'({cls}) moves {sorted(low)}; bf16 is '
                                'licensed only on the compressed factor '
                                'all-reduce')
                if (cls == 'decomposition_gather'
                        and floats - {wire['inv_dtype']}):
                    errs.append(f'{lane}/{name} rank {r} entry {i}: {e} '
                                'gathers decompositions in '
                                f'{sorted(floats)}, not {wire["inv_dtype"]}')
            if wire['compressed'] and base in ('factor', 'inv'):
                if packed != wire['compressed_elements']:
                    bad = [f'entry {i}: {e}' for i, (e, cls) in enumerate(
                        zip(p['entries'], p['classes']))
                        if cls == 'factor_allreduce'
                        and 'bf16' not in e.split('|')[1]
                        and 'f64' not in e.split('|')[1]]
                    errs.append(
                        f'{lane}/{name} rank {r}: {packed} bf16 factor '
                        f'elements where bf16 is declared for '
                        f'{wire["compressed_elements"]} '
                        f'({"; ".join(bad) or "no factor entry"})')
    return errs


def _asymmetries(lane: str, lp: Mapping[str, Any]) -> list[str]:
    """Every communicator's collectives the same on each of its ranks
    (JAX's asymmetry scan, per group: ranks of different columns may
    gather different sizes on their own groups), and every stored digest
    equal to its entries'."""
    errs = []
    ranks = lp['ranks']
    names = {name for progs in ranks for name in progs}
    for name in sorted(names):
        missing = [r for r, progs in enumerate(ranks) if name not in progs]
        if missing:
            errs.append(f'{lane}/{name}: ranks {missing} never ran the '
                        'program')
            continue
        # group -> rank -> [(index in the rank's entries, entry)]
        on: dict[tuple, dict[int, list]] = {}
        for r, progs in enumerate(ranks):
            p = progs[name]
            for i, (e, g) in enumerate(zip(p['entries'], p['groups'])):
                on.setdefault(tuple(g), {}).setdefault(r, []).append((i, e))
        for g, by_rank in on.items():
            lead = min(g)
            for r in g:
                if r == lead or r >= len(ranks):
                    continue
                mine = by_rank.get(r, [])
                theirs = by_rank.get(lead, [])
                if [e for _, e in mine] == [e for _, e in theirs]:
                    continue
                k = next((k for k, (a, b) in enumerate(zip(mine, theirs))
                          if a[1] != b[1]), min(len(mine), len(theirs)))
                i, e = mine[k] if k < len(mine) else ('-', '(none)')
                other = theirs[k][1] if k < len(theirs) else '(none)'
                errs.append(
                    f'{lane}/{name}: rank {r} entry {i} is {e} on ranks '
                    f'{list(g)}, rank {lead} issues {other} there '
                    f'({len(mine)} against {len(theirs)} collectives on the '
                    'group): the ranks would not rendezvous')
    for name, block in lp['schedule'].items():
        entries = ranks[0][name]['entries']
        if block['digest'] != schedule_digest_of(entries):
            errs.append(f'{lane}/{name}: stored digest does not match its '
                        'entries')
    return errs


def _interleavings(lane: str, lp: Mapping[str, Any]) -> tuple[dict, list]:
    """Per program where two threads or two communicators issue, each
    rank's interleaving; unequal interleavings are the NCCL ordering
    hazard."""
    out, errs = {}, []
    for name in lp['ranks'][0]:
        per_rank = [_interleaving(p[name]['entries'], p[name]['threads'])
                    for p in lp['ranks'] if name in p]
        threads = {t for p in lp['ranks'] if name in p
                   for t in p[name]['threads']}
        groups = {e.rsplit('|', 1)[1] for p in lp['ranks'] if name in p
                  for e in p[name]['entries']}
        if len(threads) < 2 and len(groups) < 2:
            continue
        equal = all(x == per_rank[0] for x in per_rank)
        out[name] = {'threads': sorted(threads), 'groups': sorted(groups),
                     'ranks_equal': equal,
                     'rank0': per_rank[0]}
        if not equal:
            r = next(i for i, x in enumerate(per_rank) if x != per_rank[0])
            errs.append(f'{lane}/{name}: rank {r} interleaves its threads '
                        f'and communicators as {per_rank[r]}, rank 0 as '
                        f'{per_rank[0]} (NCCL launches in the same order on '
                        'every rank)')
    return out, errs


def _pin_rows(lanes: Mapping[str, Any]) -> tuple[list, list]:
    rows, errs = [], []
    for left, right, level in SCHEDULE_PINS:
        blocks = []
        for ref in (left, right):
            lane, _, program = ref.partition('/')
            blocks.append((lanes.get(lane) or {}).get('schedule', {})
                          .get(program))
        lb, rb = blocks
        if lb is None or rb is None:
            errs.append(f'schedule pin {left} == {right}: the pinned '
                        'program never ran')
            continue
        field = SCHEDULE_LEVEL_FIELDS[level]
        row = {'left': left, 'right': right, 'level': level,
               'left_digest': lb[field], 'right_digest': rb[field],
               'match': lb[field] == rb[field]}
        rows.append(row)
        if not row['match']:
            errs.append(f'schedule pin {left} != {right} at {level} level: '
                        'variants that must rendezvous issue different '
                        'collective schedules')
    return rows, errs


def _lane_checks(lane: str, lp: Mapping[str, Any]) -> list[str]:
    """The checks a payload's stored entries support, per lane."""
    errs = _asymmetries(lane, lp) + _wire_violations(lane, lp)
    for r, progs in enumerate(lp['ranks']):
        for row in lp['rank_parity'][r]:
            p = progs.get(row['program'])
            if p is None:
                continue
            got = sum(int(e.split('|')[2]) * _ITEMSIZE.get(
                e.split('|')[1], 0)
                for e, cls in zip(p['entries'], p['classes'])
                if cls == row['class'])
            if got != row['ledger_bytes']:
                errs.append(f'{lane}/{row["program"]} rank {r}: '
                            f'{row["class"]} {got} B against the ledger\'s '
                            f'{row["ledger_bytes"]}')
    if lp.get('sync_tail_passes_pipeline_test'):
        errs.append(f'{lane}: the synchronous tail passes the pipeline '
                    'test (vacuous)')
    if 'containment' in lp:
        pinned = [c for c in lp['containment'] if c['pinned']]
        if not pinned and lane == 'auto_placement':
            # The audit lane is built to exercise an intra-group phase; a
            # plan of another run may scope none.
            errs.append(f'{lane}: no collective is plan-scoped intra-ICI: '
                        'the containment check is vacuous')
        errs += [f'{lane}/{c["program"]}: {c["class"]} over ranks '
                 f'{c["ranks"]} crosses the declared ICI groups but the '
                 f'plan scoped {c["phase"]} as intra-ICI'
                 for c in lp['containment'] if not c['ok']]
    return errs


def merge_rank_reports(
    reports: Sequence[Mapping[str, Any]],
    env: Mapping[str, Any] | None = None,
    pins: bool = True,
) -> dict[str, Any]:
    """The payload from every rank's ``{lane: lane_report}``: rank 0's
    parity, ledger and wire facts, every rank's program entries
    (``lanes[lane]['ranks']``), rank 0's schedule digests, the
    interleaving reports, the pins (``pins=False``: none, for lanes of
    another run than :data:`LANES`) and the violations."""
    world = len(reports)
    payload: dict[str, Any] = {
        'schema_version': AUDIT_SCHEMA_VERSION,
        'world': world,
        'model': 'MLP(32, features=(32,)*8 + (10,))',
        'memory_tolerance': MEMORY_TOLERANCE,
        'lanes': {},
        'env': dict(env or {}),
    }
    violations: list[str] = []
    for lane in reports[0]:
        r0 = reports[0][lane]
        lp = {k: v for k, v in r0.items() if k not in ('programs',
                                                       'violations')}
        lp['ranks'] = [rep[lane]['programs'] for rep in reports]
        lp['rank_parity'] = [rep[lane]['parity'] for rep in reports]
        lp['schedule'] = {name: _schedule_block(p['entries'])
                          for name, p in r0['programs'].items()}
        lp['programs'] = {
            name: {'collectives': p['collectives'],
                   'n_collectives': len(p['entries']),
                   'variant': p['variant'],
                   **({'memory': [rep[lane]['programs'][name].get('memory')
                                  for rep in reports]}
                      if 'memory' in p else {})}
            for name, p in r0['programs'].items()
        }
        lp['interleaving'], inter_errs = _interleavings(lane, lp)
        for r, rep in enumerate(reports):
            violations += [f'rank {r}: {e}' for e in rep[lane]['violations']]
        violations += _lane_checks(lane, lp) + inter_errs
        payload['lanes'][lane] = lp
    payload['schedule_pins'], pin_errs = (_pin_rows(payload['lanes'])
                                          if pins else ([], []))
    violations += pin_errs
    payload['violations'] = violations
    payload['verified'] = not violations
    return payload


def validate_payload(payload: Any) -> list[str]:
    """Schema and consistency errors of a payload: the structure, every
    stored digest against its entries, the rank schedules, the wire
    dtypes, the parity rows recomputed from each rank's entries, the
    pins, and ``verified`` equal to an empty violation list."""
    errs: list[str] = []
    if not isinstance(payload, Mapping):
        return ['payload is not a JSON object']
    for key in ('schema_version', 'world', 'lanes', 'schedule_pins',
                'violations', 'verified'):
        if key not in payload:
            errs.append(f'missing key {key!r}')
    if errs:
        return errs
    if payload['schema_version'] != AUDIT_SCHEMA_VERSION:
        errs.append(f'schema_version {payload["schema_version"]} != '
                    f'{AUDIT_SCHEMA_VERSION}')
    lanes = payload['lanes']
    missing = sorted(set(LANES) - set(lanes))
    if missing:
        errs.append(f'lanes missing: {missing}')
    for lane, lp in lanes.items():
        if len(lp.get('ranks', ())) != payload['world']:
            errs.append(f'{lane}: {len(lp.get("ranks", ()))} rank reports '
                        f'for world {payload["world"]}')
            continue
        errs += _lane_checks(lane, lp)
        errs += _interleavings(lane, lp)[1]
        if not any(r['ledger_bytes'] for r in lp['parity']):
            errs.append(f'{lane}: every parity row is zero (vacuous)')
    rows, pin_errs = _pin_rows(lanes)
    errs += pin_errs
    if payload['verified'] != (not payload['violations']):
        errs.append('verified disagrees with the violation list')
    if payload['violations']:
        errs.append(f'{len(payload["violations"])} violation(s) recorded')
    return errs


def _memory_drift(payload: Mapping[str, Any],
                  baseline: Mapping[str, Any]) -> list[str]:
    errs = []
    for lane, lp in payload['lanes'].items():
        base = baseline.get('lanes', {}).get(lane)
        if base is None:
            continue
        for name, p in lp['programs'].items():
            old = base.get('programs', {}).get(name, {}).get('memory')
            new = p.get('memory')
            if old is None or new is None:
                continue
            for r, (o, n) in enumerate(zip(old, new)):
                if o and abs(n - o) > MEMORY_TOLERANCE * o:
                    errs.append(
                        f'{lane}/{name} rank {r}: peak memory {n} B against '
                        f'the baseline\'s {o} B, beyond '
                        f'{MEMORY_TOLERANCE:.0%}')
    return errs


def check_payload(
    payload: Mapping[str, Any],
    baseline: Mapping[str, Any] | None = None,
) -> list[str]:
    """:func:`validate_payload`, and with a ``baseline`` payload the
    memory drift gate (:data:`MEMORY_TOLERANCE`)."""
    errs = validate_payload(payload)
    if baseline is not None and not errs:
        errs += _memory_drift(payload, baseline)
    return errs


def lane_summary(lp: Mapping[str, Any]) -> dict[str, Any]:
    """One lane of a payload in short: per program the recorded bytes
    against the ledger's per pinned class, the wire dtypes per class,
    whether every rank's schedule digest is equal, the peak memory per
    rank where measured, and the interleavings."""
    parity: dict[str, dict[str, list[int]]] = {}
    for r in lp['parity']:
        parity.setdefault(r['program'], {})[r['class']] = [
            r['recorded_bytes'], r['ledger_bytes']]
    dtypes: dict[str, list[str]] = {}
    for p in lp['programs'].values():
        for cls, agg in p['collectives'].items():
            dtypes[cls] = sorted(set(dtypes.get(cls, [])) | set(agg['dtypes']))
    extra = {}
    if 'pipeline' in lp:
        ok = [r['match'] and r['async_op'] and r['before_next_tail']
              and r['before_scale'] for r in lp['pipeline']]
        extra['pipeline_gathers_async_before_next_tail_and_scale'] = (
            f'{sum(ok)}/{len(ok)}')
    if 'containment' in lp:
        pinned = [c for c in lp['containment'] if c['pinned']]
        extra['ici_scoped_collectives_contained'] = (
            f'{sum(c["contained"] for c in pinned)}/{len(pinned)}')
    return {
        'grid': lp['grid_rows_x_cols'],
        **extra,
        'bytes_recorded_vs_ledger': parity,
        'wire_dtypes': dtypes,
        'digests_equal_across_ranks': all(
            len({schedule_digest_of(r[name]['entries'])
                 for r in lp['ranks']}) == 1 for name in lp['schedule']),
        'schedules_equal_within_each_group': not _asymmetries('', lp),
        'n_programs': len(lp['programs']),
        'peak_memory_bytes': {name: p['memory']
                              for name, p in lp['programs'].items()
                              if 'memory' in p},
        'interleaving': {name: {'threads': i['threads'],
                                'groups': i['groups'],
                                'ranks_equal': i['ranks_equal']}
                         for name, i in lp.get('interleaving', {}).items()},
    }


def format_payload(payload: Mapping[str, Any]) -> str:
    """A short table: per lane its grid, programs, pinned classes'
    recorded bytes against the ledger, interleavings and memory."""
    lines = [f'collective audit, world {payload["world"]}, '
             f'{len(payload["lanes"])} lanes, verified '
             f'{payload["verified"]}']
    for lane, lp in payload['lanes'].items():
        ok = sum(r['match'] for r in lp['parity'])
        lines.append(f'{lane:20s} {lp["grid_rows_x_cols"]:5s} programs '
                     f'{",".join(lp["programs"])}; parity {ok}/'
                     f'{len(lp["parity"])}')
        for name, inter in lp.get('interleaving', {}).items():
            same = 'equal' if inter['ranks_equal'] else 'UNEQUAL'
            lines.append(f'  {name}: {same} interleaving of '
                         f'{inter["threads"]} on {inter["groups"]}')
    for row in payload['schedule_pins']:
        lines.append(f'pin {row["left"]} == {row["right"]} ({row["level"]}): '
                     f'{row["match"]}')
    lines += [f'VIOLATION {v}' for v in payload['violations']]
    return '\n'.join(lines)


# ----------------------------------------------------------------------
# the lanes
# ----------------------------------------------------------------------

#: JAX's lanes (``audit.py:1990-2180``): grad-worker fraction (``None``:
#: MEM-OPT, 1/world), options, geometry, and the programs forced after
#: the bootstrap.  ``hybrid_watchdog`` also runs the watchdog's check
#: (outside the step: ``watchdog_check``).
LANES: dict[str, dict[str, Any]] = {
    'comm_opt': {'fraction': 1.0},
    'hybrid_opt': {'fraction': 0.5},
    'mem_opt': {'fraction': None},
    'hybrid_bf16_triu': {'fraction': 0.5,
                         'extra': {'factor_comm': 'bf16_triu'},
                         'programs': ('plain', 'factor')},
    'hybrid_stagger2': {
        'fraction': 0.5, 'extra': {'stagger_refresh': 2},
        'programs': ('plain', 'factor', 'inv', 'plain+shard0',
                     'factor+shard0', 'plain+shard1', 'factor+shard1')},
    'hybrid_adaptive': {
        'fraction': 0.5, 'extra': {'stagger_refresh': 2, 'adaptive': True},
        'programs': ('plain', 'factor', 'inv', 'plain+shard0',
                     'factor+shard0', 'plain+shard1', 'factor+shard1')},
    'hybrid_iterative': {'fraction': 0.5,
                         'extra': {'compute_method': 'iterative'}},
    'mem_opt_iterative': {'fraction': None,
                          'extra': {'compute_method': 'iterative'}},
    'hybrid_pipeline': {'fraction': 0.5, 'extra': {'pipeline_grads': True},
                        'geometry': 'multi_bucket',
                        'programs': ('plain', 'factor')},
    'hybrid_overlap': {
        'fraction': 0.5, 'extra': {'overlap_comm': True},
        'programs': ('plain', 'factor', 'inv', 'plain+overlap_inv',
                     'factor+overlap_inv')},
    'hybrid_consistency': {
        'fraction': 0.5, 'extra': {'consistency': True},
        'programs': ('plain', 'factor', 'inv', 'plain+consistency',
                     'factor+consistency')},
    'hybrid_watchdog': {'fraction': 0.5, 'extra': {'watchdog': True}},
    'hybrid_coverage': {
        'fraction': 0.5, 'geometry': 'coverage',
        'extra': {'layer_types': ('linear', 'embedding', 'layernorm',
                                  'dense_general'),
                  'tied_weights': ('wte',)},
        'programs': ('plain', 'factor')},
    'auto_placement': {'fraction': 'auto', 'extra': {'topology': True}},
}
DEFAULT_PROGRAMS = ('plain', 'factor', 'inv')
#: The engine's cadence and hyperparameters in every lane (JAX
#: ``audit.py:_build_engine``).
LANE_HP = dict(factor_update_steps=1, inv_update_steps=2, damping=0.003,
               lr=0.1)


def _lane_kwargs(spec: Mapping[str, Any], world: int,
                 topology: Any) -> dict[str, Any]:
    import kfac_pytorch_tpu_torch as kt

    kw = {}
    for k, v in spec.get('extra', {}).items():
        if k == 'adaptive':
            kw[k] = kt.AdaptiveRefreshConfig()
        elif k == 'consistency':
            kw[k] = kt.ConsistencyConfig(cadence=1)
        elif k == 'watchdog':
            kw[k] = kt.WatchdogConfig(check_every=1)
        elif k == 'topology':
            kw[k] = topology
        else:
            kw[k] = v
    fraction = spec['fraction']
    kw['grad_worker_fraction'] = 1.0 / world if fraction is None else fraction
    return kw


def _geometry(name: str | None, world: int, device: torch.device):
    """``(model, x, y)`` of a lane, the same weights and global batch on
    every rank (seeded), ``2 * world`` examples."""
    from kfac_pytorch_tpu_torch.models import MLP
    from kfac_pytorch_tpu_torch.models.tiny import CoverageLM

    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(2)
    n = 2 * world
    if name == 'coverage':
        model = CoverageLM()
        x = torch.randint(0, model.vocab, (n, 8), generator=gen)
    elif name == 'multi_bucket':
        model = MLP(64, (64, 64, 32, 32, 10))
        x = torch.randn(n, 64, generator=gen)
    else:
        model = MLP(32, (32,) * 8 + (10,))
        x = torch.randn(n, 32, generator=gen)
    y = torch.randint(0, 10, (n,), generator=gen)
    return model.to(device), x.to(device), y.to(device)


def _force(precond: Any, variant: str, pending: tuple | None,
           deferred: tuple | None) -> None:
    """Plan the next step as ``variant`` (and issue ``pending``)."""
    base, refresh, check = _parse_variant(variant)
    uf = base in ('factor', 'inv')
    ui = base == 'inv'
    shard = refresh if isinstance(refresh, int) and deferred is None else None
    precond._overlap_plan = lambda: (uf, ui, shard, deferred, pending)
    precond._consistency_due = lambda: check
    precond._arm_capture(uf)


def run_lane(
    lane: str,
    rank: int,
    world: int,
    device: torch.device,
    topology: Any = None,
) -> dict[str, Any]:
    """One rank of one lane: DDP over the model with
    :func:`grad_sync_hook`, the bootstrap step, then each program of the
    lane forced once (the overlap lane issues a deferred refresh from a
    ``plain`` step first; the watchdog lane runs its check after every
    step); returns :func:`lane_report`."""
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt

    spec = LANES[lane]
    model, x, y = _geometry(spec.get('geometry'), world, device)
    q = x.shape[0] // world
    xl, yl = x[rank * q:(rank + 1) * q], y[rank * q:(rank + 1) * q]
    ddp = torch.nn.parallel.DistributedDataParallel(
        model, device_ids=None if device.index is None else [device.index])
    precond = kt.KFACPreconditioner(
        ddp, **LANE_HP, **_lane_kwargs(spec, world, topology))
    opt = torch.optim.SGD(model.parameters(), lr=LANE_HP['lr'])
    watchdog = 'watchdog' in spec.get('extra', {})
    mem_device = device if device.type == 'cuda' else None
    rec = CollectiveRecorder()
    rec.hook(ddp)

    def step(name: str | None) -> None:
        rec.begin(mem_device)
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(ddp(xl), yl)
        loss.backward()
        precond.step()
        variant = precond._last_variant
        rec.end(name or 'bootstrap', variant)
        if name is not None and variant != name:
            raise RuntimeError(f'{lane}: forced {name}, the engine ran '
                               f'{variant}')
        opt.step()
        if watchdog:
            rec.begin(mem_device)
            precond.watchdog_step(loss.detach())
            rec.end('watchdog_check')

    with rec:
        step(None)
        programs = list(spec.get('programs', DEFAULT_PROGRAMS))
        if lane == 'hybrid_overlap':
            # The plain step that issues the first deferred refresh (a
            # second occurrence of 'plain'); each +overlap_inv step
            # collects one, and the first issues the next.
            _force(precond, 'plain', ('inv', None), None)
            step('plain')
            _force(precond, 'plain+overlap_inv', ('inv', None), ('inv', None))
            step('plain+overlap_inv')
            _force(precond, 'factor+overlap_inv', None, ('inv', None))
            step('factor+overlap_inv')
            programs = [p for p in programs if 'overlap' not in p]
        for name in programs:
            _force(precond, name, None, None)
            step(name)
        precond.join_deferred_refresh()
    options = {k: (v if isinstance(v, (int, float, str, bool)) or v is None
                   else repr(v))
               for k, v in _lane_kwargs(spec, world, topology).items()
               if k != 'topology'}
    return lane_report(lane, precond, rec, world, options)


def default_topology(world: int) -> Any:
    """The auto-placement lane's pod: two groups of ``world // 2`` ranks
    at :class:`~kfac_pytorch_tpu_torch.placement.PodTopology`'s data-sheet
    rates (NVLink inside a group, InfiniBand between)."""
    from kfac_pytorch_tpu_torch.placement import PodTopology

    return PodTopology(ici_size=world // 2, n_groups=2)


def run_rank(rank: int, world: int, init: str, out: str,
             device: str = 'cpu') -> None:
    """One audit rank: join the gloo group at ``init``, run every lane,
    write ``{out}/audit_rank{rank}.json``."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        dev = torch.device('cuda', 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        'gloo', init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120),
    )
    topo = default_topology(world)
    try:
        report = {lane: run_lane(lane, rank, world, dev, topo)
                  for lane in LANES}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f'audit_rank{rank}.json'), 'w') as fh:
        json.dump(report, fh)


def spawn_ranks(world: int, out: str, device: str = 'cpu') -> list:
    """Start ``world`` audit ranks (``python -m
    kfac_pytorch_tpu_torch.analysis.audit``) meeting through a file under
    ``out``; each writes its report there."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       'PYTHONPATH', '').split(os.pathsep) if p]))
    init = 'file://' + os.path.join(os.path.abspath(out), 'audit_pg_init')
    return [subprocess.Popen(
        [sys.executable, '-m', 'kfac_pytorch_tpu_torch.analysis.audit',
         '--rank', str(r), str(world), init, os.path.abspath(out), device],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    ) for r in range(world)]


def collect(out: str, world: int,
            env: Mapping[str, Any] | None = None) -> dict[str, Any]:
    """The payload from the ranks' reports under ``out``."""
    reports = []
    for r in range(world):
        with open(os.path.join(out, f'audit_rank{r}.json')) as fh:
            reports.append(json.load(fh))
    return merge_rank_reports(reports, env)


def run_audit(
    world: int = 8,
    out: str | None = None,
    device: str = 'cpu',
    timeout: float = 600.0,
) -> dict[str, Any]:
    """Spawn the ranks, wait for them (all killed at ``timeout``
    seconds), and return the merged payload."""
    import tempfile

    from kfac_pytorch_tpu_torch.utils.backend import environment_summary

    with contextlib.ExitStack() as stack:
        if out is None:
            out = stack.enter_context(tempfile.TemporaryDirectory())
        procs = spawn_ranks(world, out, device)
        deadline = time.time() + timeout
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.time()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, log[-2000:]) for r, (p, log)
               in enumerate(zip(procs, logs)) if p.returncode]
        if bad or len(logs) < world:
            raise RuntimeError(f'audit ranks failed: {bad[:1]}')
        env = environment_summary()
        env['device_type'] = device
        return collect(out, world, env)


if __name__ == '__main__' and sys.argv[1:2] == ['--rank']:
    _, _, rank_s, world_s, init_s, out_s, device_s = sys.argv
    torch.set_num_threads(1)
    run_rank(int(rank_s), int(world_s), init_s, out_s, device_s)
