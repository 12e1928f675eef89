"""Cost accounting: counted step FLOPs and the KAISA communication ledger.

Port of ``kfac_pytorch_tpu/observe/costs.py``.  Two views of what a
K-FAC step costs:

* :func:`compiled_costs` counts the FLOPs of one executed call with
  ``torch.utils.flop_counter.FlopCounterMode`` (the JAX module reads
  XLA's cost analysis of a compiled program; torch has none, so the call
  runs).  The mode sees the aten operators (matmuls, convolutions and
  their backward passes) and the fused kernel's custom op
  (``kfac_torch::fused_eigen_precond``, ``ops/fused_precond.py``), whose
  registered formula counts its four contractions,
  ``4·L·gp·ap·(gp+ap)``, on every device.  cuSOLVER's ``eigh`` has no
  FLOP formula and is not counted.  ``bytes_accessed`` is ``-1.0``, the JAX contract for a field
  the backend does not report.
* :func:`comm_ledger` is the JAX module's analytic per-phase table of
  the KAISA grid from the bucket plan, the ``(rows, cols)`` grid shape
  and the dtypes, function for function (same arguments, same rows);
  :func:`ledger_for` builds the ledger of a port preconditioner, which
  describes the port's collectives (:mod:`~kfac_pytorch_tpu_torch.\
parallel.collectives` and the guards' own), not JAX's.

**The port's rows.**  ``payload_bytes`` is the size of the result
buffers one rank's collectives of that phase produce (an all-reduce's
buffer, an all-gather's gathered output), summed over the collectives of
one event, and 0 where the port issues no collective (a grid axis of
extent 1); ``bytes_per_device`` applies the JAX wire model to it (ring
all-reduce ``2 P (n-1)/n``, all-gather ``P (n-1)/n``).  Where the port's
collectives differ from JAX's compiled ones, its rows differ:

* ``factor_allreduce`` also carries the f64 vector of row counts, their
  squares and the micro-batch counts (the equal-batch check), the EKFAC
  scale contributions (``[g_pad, a_pad]`` f32 per layer), and counts one
  contribution per layer (a layer applied several times averages its
  calls before the all-reduce; JAX reduces one per call); it is never
  ``overlapped``: the port's factor all-reduce is synchronous in the step
  even under ``overlap_comm``;
* ``inverse_row_allgather`` gathers each column's slots padded to
  ``ceil(seg / rows)`` per rank (the port's analogue of
  :func:`gspmd_padded_slots`), with every field the method keeps
  (``bake_damping`` and the iterative residuals included) and the health
  verdicts; none with one row;
* ``grad_col_allgather`` moves each slot's f32 clip term beside its
  preconditioned gradient (the kernel's ``clip[l]``);
* ``health_counters`` (health on, ``cols > 1``): the per-slot verdicts
  gathered over the row at each refresh;
* ``ekfac_basis_row_allgather`` and ``ekfac_divergence_gather`` (EKFAC
  with ``cols > 1``): every column's bases gathered over the row at each
  refresh, and the per-bucket drift terms on each factor step;
* ``observe_extremes`` (monitor on, ``cols > 1``): one
  ``all_reduce(MAX)`` of the per-bucket spectrum extremes over the row
  each step, since a rank holds only its column's slots;
* ``consistency_check``: one all-gather over the world of every rank's
  int64 digest vector (JAX: pmin/pmax reductions);
* ``adaptive_digest``: the int64 digest and sketch (5 per layer, 8
  bytes each);
* ``watchdog_check``: one f64 all-reduce per check of the retained
  scalars, ``check_every`` steps of the loss and the configured signals
  (JAX bills zero bytes: its loss is global).

Unbilled, as in JAX: the repair broadcasts (data-dependent), the
``AdaptiveDamping`` loss all-reduce of the fused path, and the
runtime's barriers (they run on the rendezvous store, not the group).

**Scopes.**  With a :class:`~kfac_pytorch_tpu_torch.placement.topology.\
PodTopology` (``comm_ledger(topology=...)``, or a preconditioner built
with ``topology=``) each row names the slowest link class its groups
traverse, by JAX's rule: the world's rows (the factor all-reduce and
the guards') the world's scope, the decomposition gather the scope of
the grid's column groups, the gradient gather (and the port's other
row-group collectives) the scope of its row groups.  ``'ici'`` is one
NVLink domain, ``'dcn'`` the network between nodes; host rows stay
``'host'``; without a topology every row is ``'flat'``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch


# ----------------------------------------------------------------------
# counted FLOPs
# ----------------------------------------------------------------------


def compiled_costs(
    fn: Callable[..., Any], *args: Any, count: str = 'matmul',
) -> dict[str, float]:
    """Counted cost of one call ``fn(*args)``: ``{'flops',
    'bytes_accessed'}``.

    ``count='matmul'``: the call runs under ``FlopCounterMode``, which
    counts the matmuls, convolutions and their backward passes at every
    kernel tap; the fused kernel's custom op
    (``kfac_torch::fused_eigen_precond``) carries its own formula, its
    four contractions, on every device.  ``count='all'``: XLA's cost
    analysis model, which the JAX package reads (:class:`HloFlopCounter`):
    a convolution counts only the taps that meet the input (not the
    zero padding), and the elementwise and reduction work counts too.
    ``bytes_accessed`` is ``-1.0`` (not reported).
    """
    if count == 'all':
        with HloFlopCounter() as counter:
            fn(*args)
        return {'flops': float(counter.flops), 'bytes_accessed': -1.0}
    if count != 'matmul':
        raise ValueError(f"count must be 'matmul' or 'all', got {count!r}")
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {'flops': float(counter.get_total_flops()),
            'bytes_accessed': -1.0}


def _valid_taps(size: int, k: int, stride: int, pad: int, dil: int,
                out: int) -> int:
    """(output, kernel) pairs of one spatial dimension whose input index
    lies inside the unpadded input."""
    return sum(1 for o in range(out) for j in range(k)
               if 0 <= o * stride - pad + j * dil < size)


def _conv_macs(x_shape, w_shape, out_shape, stride, padding, dilation,
               groups) -> int:
    taps = 1
    for d in range(len(w_shape) - 2):
        taps *= _valid_taps(x_shape[2 + d], w_shape[2 + d], stride[d],
                            padding[d], dilation[d], out_shape[2 + d])
    return x_shape[0] * w_shape[0] * (x_shape[1] // groups) * taps


class HloFlopCounter:
    """Counts one call's FLOPs as XLA's cost analysis does (a context
    manager; ``flops`` after it): a convolution and each
    of its backward products ``2 x`` the multiply-adds whose input index
    is inside the unpadded input; matmuls by ``FlopCounterMode``'s
    formulas (the fused kernel's custom op included); one FLOP per output
    element of a pointwise op (two for an ``add`` with ``alpha``, the SGD
    update's multiply and add); one per input element of a reduction and
    of a (log-)softmax and the loss; training-mode batch norm 6 per
    element forward and 7 backward (XLA's counts of Flax's
    ``BatchNorm``).  Views, copies and allocations count 0."""

    BN_FORWARD = 6
    BN_BACKWARD = 7
    REDUCTIONS = frozenset({
        'sum', 'mean', 'amax', 'amin', 'max', 'min', 'var', 'var_mean',
        '_softmax', '_log_softmax', '_softmax_backward_data',
        '_log_softmax_backward_data', 'nll_loss_forward',
        'nll_loss_backward',
    })

    def __init__(self) -> None:
        self.flops = 0
        self._mode = None

    def __enter__(self) -> 'HloFlopCounter':
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                counter.flops += counter._op_flops(func, args, kwargs, out)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._mode.__exit__(*exc)
        self._mode = None

    def _op_flops(self, func, args, kwargs, out) -> int:
        import torch.utils._pytree as pytree
        from torch.utils.flop_counter import flop_registry
        from torch.utils.flop_counter import get_shape

        aten = torch.ops.aten
        name = func.overloadpacket.__name__
        if func is aten.convolution.default:
            x, w, bias, stride, pad, dil, _, _, groups = args
            macs = _conv_macs(x.shape, w.shape, out.shape, stride, pad, dil,
                              groups)
            return 2 * macs + (out.numel() if bias is not None else 0)
        if func is aten.convolution_backward.default:
            go, x, w, _, stride, pad, dil, _, _, groups, mask = args
            macs = _conv_macs(x.shape, w.shape, go.shape, stride, pad, dil,
                              groups)
            return (2 * macs * (int(mask[0]) + int(mask[1]))
                    + (go.numel() if mask[2] else 0))
        formula = flop_registry.get(func) or flop_registry.get(
            func.overloadpacket)
        if formula is not None:
            a, kw, o = pytree.tree_map(get_shape, (args, kwargs, out))
            return int(formula(*a, **kw, out_val=o))
        if name in ('native_batch_norm', '_native_batch_norm_legit',
                    '_native_batch_norm_legit_functional'):
            return self.BN_FORWARD * args[0].numel()
        if name == 'native_batch_norm_backward':
            return self.BN_BACKWARD * args[0].numel()
        if name in self.REDUCTIONS:
            return args[0].numel()
        if torch.Tag.pointwise in func.tags:
            outs = out if isinstance(out, (tuple, list)) else [out]
            n = sum(t.numel() for t in outs
                    if isinstance(t, torch.Tensor) and t.is_floating_point())
            return n * (2 if kwargs.get('alpha', 1) != 1 else 1)
        return 0


def step_variant_costs(
    precond: Any, forward_backward: Callable[[], Any],
) -> dict[str, dict[str, float]]:
    """Counted costs of each step variant the engine dispatches between:
    ``{'plain': {...}, 'factor': {...}, 'inv': {...}}``.

    Each variant runs once (``forward_backward()``, then
    :meth:`step` with the variant's gating forced) under
    :func:`compiled_costs`; the preconditioner's state is put back
    afterwards (the ``.grad`` of the model holds the last variant's
    preconditioned gradients).
    """
    from kfac_pytorch_tpu_torch.utils.checkpoint import snapshot_host_state

    rollback = snapshot_host_state(precond)
    out: dict[str, dict[str, float]] = {}
    try:
        for name, (uf, ui) in (('factor', (True, False)),
                               ('inv', (True, True)),
                               ('plain', (False, False))):
            precond._refresh_plan = lambda uf=uf, ui=ui: (uf, ui, None)
            precond._arm_capture(uf)

            def one_step():
                forward_backward()
                precond._step()

            try:
                out[name] = compiled_costs(one_step)
            finally:
                del precond._refresh_plan
    finally:
        rollback()
    return {name: out[name] for name in ('plain', 'factor', 'inv')}


# ----------------------------------------------------------------------
# analytic KAISA communication ledger (the JAX module's functions)
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommRow:
    """One phase of KAISA data movement.

    ``bytes_per_device`` is the receive volume of one device per event of
    ``cadence`` (``'factor_step'``, ``'inv_step'``, ``'step'``,
    ``'consistency_step'``, ``'watchdog_step'`` or ``'checkpoint'``);
    ``payload_bytes`` the payload the collective moves; ``scope`` the
    link class (``'flat'`` without a topology, ``'host'`` for host
    rows); ``overlapped`` marks bytes the dispatch plan hides behind
    same-step compute.
    """

    phase: str
    collective: str
    axis: str
    cadence: str
    bytes_per_device: int
    payload_bytes: int = 0
    scope: str = 'flat'
    overlapped: bool = False


def decomposition_bytes(
    n_slots: int,
    a_pad: int,
    g_pad: int,
    *,
    compute_method: str = 'eigen',
    prediv: bool = True,
    ekfac: bool = False,
    itemsize: int = 4,
) -> int:
    """Bytes of one bucket's full second-order stacks (all slots), the
    JAX model: ``qa``/``qg`` and ``dgda`` (prediv) or ``da``/``dg``, the
    EKFAC ``skron`` (f32), or the inverse/iterative ``a_inv``/``g_inv``."""
    L, a, g = n_slots, a_pad, g_pad
    if compute_method in ('inverse', 'iterative'):
        return (L * a * a + L * g * g) * itemsize
    total = L * a * a + L * g * g  # qa + qg
    if prediv and not ekfac:
        total += L * g * a  # dgda
    else:
        total += L * a + L * g  # da + dg
    skron = L * g * a * 4 if ekfac else 0
    return total * itemsize + skron


def grad_stack_bytes(
    n_slots: int, a_pad: int, g_pad: int, itemsize: int = 4,
) -> int:
    """Bytes of one bucket's padded combined-gradient stack."""
    return n_slots * g_pad * a_pad * itemsize


def factor_payload_bytes(
    layer_dims: Sequence[tuple[int, int]],
    itemsize: int = 4,
    diag_a: Sequence[bool] | None = None,
    triu_bf16: bool | Sequence[bool] = False,
    call_counts: Sequence[int] | None = None,
) -> int:
    """Logical (unpadded) factor bytes of all layers, ``sum a^2 + g^2``
    (``a`` for a diagonal-A layer); a compressed layer
    (``factor_comm='bf16_triu'``) moves its packed triangles at 2 bytes;
    ``call_counts[i]`` multiplies layer ``i`` (JAX reduces one
    contribution per application)."""
    total = 0
    for i, (a, g) in enumerate(layer_dims):
        calls = 1 if call_counts is None else int(call_counts[i])
        compress = (
            triu_bf16[i] if isinstance(triu_bf16, (list, tuple))
            else triu_bf16
        )
        if diag_a is not None and diag_a[i]:
            total += (a + g * g) * itemsize * calls
        elif compress:
            total += (a * (a + 1) // 2 + g * (g + 1) // 2) * 2 * calls
        else:
            total += (a * a + g * g) * itemsize * calls
    return total


def checkpoint_bytes(
    layer_dims: Sequence[tuple[int, int]],
    itemsize: int = 4,
    diag_a: Sequence[bool] | None = None,
    compress_symmetric: bool = False,
) -> int:
    """Factor payload of one ``state_dict`` save (packed upper triangles
    with ``compress_symmetric``)."""
    if not compress_symmetric:
        return factor_payload_bytes(layer_dims, itemsize, diag_a)
    total = 0
    for i, (a, g) in enumerate(layer_dims):
        if diag_a is not None and diag_a[i]:
            total += a
        else:
            total += a * (a + 1) // 2
        total += g * (g + 1) // 2
    return total * itemsize


def gspmd_padded_slots(n_slots: int, shards: int) -> int:
    """Slot count after GSPMD's even-sharding pad, ``ceil(L/W)*W``."""
    if shards <= 1:
        return n_slots
    return -(-n_slots // shards) * shards


def eigh_input_gather_bytes(
    bucket_shapes: Sequence[tuple[int, int, int]],
    world: int,
    itemsize: int = 4,
    compute_method: str = 'eigen',
) -> int:
    """Per-device receive bytes of the JAX decomposition phase as XLA:CPU
    compiles it (the eigh inputs gathered to every device); 0 for the
    iterative method and on one device."""
    if compute_method == 'iterative':
        return 0
    if world <= 1:
        return 0
    payload = sum(
        gspmd_padded_slots(L, world) * (a * a + g * g) * itemsize
        for L, a, g in bucket_shapes
    )
    return allgather_bytes(payload, world)


def consistency_check_bytes(
    n_layers: int,
    n_hp: int,
    bucket_slots: Sequence[int],
    rows: int,
    cols: int,
) -> tuple[int, int]:
    """``(semantic_bytes, wire_bytes)`` of one JAX consistency check: the
    pmin + pmax of the digest vector over the mesh, of each bucket's slot
    digests over the rows (``rows > 1``), and the psum of the mismatch
    counts over the columns (``rows > 1`` and ``cols > 1``)."""
    world = rows * cols
    if world <= 1:
        return 0, 0
    m = 2 * n_layers + n_hp
    semantic = 2 * m * 4
    wire = 2 * ring_allreduce_bytes(m * 4, world)
    if rows > 1:
        for L in bucket_slots:
            local = (L // max(cols, 1)) * 2 * 4
            semantic += 2 * local
            wire += 2 * ring_allreduce_bytes(local, rows)
        if cols > 1 and bucket_slots:
            counts = len(bucket_slots) * 4
            semantic += counts
            wire += ring_allreduce_bytes(counts, cols)
    return semantic, wire


def adaptive_digest_bytes(
    n_layers: int,
    rows: int,
    cols: int,
) -> tuple[int, int]:
    """``(semantic_bytes, wire_bytes)`` of one JAX drift-digest emission:
    one pmax of ``5`` u32 words per layer over the mesh."""
    world = rows * cols
    if world <= 1:
        return 0, 0
    payload = 5 * n_layers * 4
    return payload, ring_allreduce_bytes(payload, world)


def ring_allreduce_bytes(payload: int, world: int) -> int:
    """Per-device wire bytes of a ring all-reduce: ``2 P (W-1) / W``."""
    if world <= 1:
        return 0
    return int(2 * payload * (world - 1) // world)


def allgather_bytes(payload: int, shards: int) -> int:
    """Per-device receive bytes gathering ``payload`` from ``shards``
    equal shards when holding one already: ``P (shards-1) / shards``."""
    if shards <= 1:
        return 0
    return int(payload * (shards - 1) // shards)


def comm_ledger(
    bucket_shapes: Sequence[tuple[int, int, int]],
    layer_dims: Sequence[tuple[int, int]],
    rows: int,
    cols: int,
    *,
    compute_method: str = 'eigen',
    prediv: bool = True,
    ekfac: bool = False,
    inv_itemsize: int = 4,
    factor_itemsize: int = 4,
    grad_itemsize: int = 4,
    diag_a: Sequence[bool] | None = None,
    compress_symmetric: bool = False,
    factor_comm_triu_bf16: bool | Sequence[bool] = False,
    stagger_shard_shapes: (
        Sequence[Sequence[tuple[int, int, int]]] | None
    ) = None,
    topology: Any = None,
    overlap_comm: bool = False,
    pipeline_grad_shapes: Sequence[tuple[int, int, int]] | None = None,
    consistency_cadence: int | None = None,
    consistency_hp_entries: int = 3,
    watchdog_cadence: int | None = None,
    adaptive: bool = False,
    call_counts: Sequence[int] | None = None,
) -> list[CommRow]:
    """The JAX module's analytic per-phase KAISA communication table, row
    for row: ``bucket_shapes`` ``(n_slots, a_pad, g_pad)`` per bucket,
    ``layer_dims`` the logical ``(a, g)`` per layer, ``rows``/``cols``
    the grid; the options as in the JAX function (the stagger shards
    replace the decomposition row by one per shard, the pipelined gather
    the gradient row by one per bucket in issue order, all but the last
    ``overlapped``; ``overlap_comm`` tags the factor and decomposition
    rows ``overlapped``; ``topology`` scope-tags the rows, see the module
    docstring: the bytes do not change)."""
    world = rows * cols
    world_scope, rows_scope, cols_scope = grid_scopes(topology, rows, cols)

    def decomp_bytes(shapes):
        return sum(
            decomposition_bytes(
                L, a, g,
                compute_method=compute_method,
                prediv=prediv,
                ekfac=ekfac,
                itemsize=inv_itemsize,
            )
            for L, a, g in shapes
        )

    grads = sum(
        grad_stack_bytes(L, a, g, grad_itemsize) for L, a, g in bucket_shapes
    )
    factors = factor_payload_bytes(
        layer_dims, factor_itemsize, diag_a,
        triu_bf16=factor_comm_triu_bf16,
        call_counts=call_counts,
    )
    if stagger_shard_shapes is None:
        decomp_rows = [
            CommRow(
                phase='inverse_row_allgather',
                collective='all-gather',
                axis='kfac_row',
                cadence='inv_step',
                bytes_per_device=allgather_bytes(
                    decomp_bytes(bucket_shapes) // max(cols, 1), rows,
                ),
                payload_bytes=decomp_bytes(bucket_shapes),
                scope=rows_scope,
                overlapped=overlap_comm,
            ),
        ]
    else:
        decomp_rows = [
            CommRow(
                phase=f'inverse_row_allgather/shard{k}',
                collective='all-gather',
                axis='kfac_row',
                cadence='inv_step',
                bytes_per_device=allgather_bytes(
                    decomp_bytes(shapes) // max(cols, 1), rows,
                ),
                payload_bytes=decomp_bytes(shapes),
                scope=rows_scope,
                overlapped=overlap_comm,
            )
            for k, shapes in enumerate(stagger_shard_shapes)
        ]
    if pipeline_grad_shapes is None:
        grad_rows = [
            CommRow(
                phase='grad_col_allgather',
                collective='all-gather',
                axis='kfac_col',
                cadence='step',
                bytes_per_device=allgather_bytes(grads, cols),
                payload_bytes=grads,
                scope=cols_scope,
            ),
        ]
    else:
        n_pipe = len(pipeline_grad_shapes)
        grad_rows = [
            CommRow(
                phase=f'grad_col_allgather/bucket{k}',
                collective='all-gather',
                axis='kfac_col',
                cadence='step',
                bytes_per_device=allgather_bytes(
                    grad_stack_bytes(L, a, g, grad_itemsize), cols,
                ),
                payload_bytes=grad_stack_bytes(L, a, g, grad_itemsize),
                scope=cols_scope,
                overlapped=k < n_pipe - 1,
            )
            for k, (L, a, g) in enumerate(pipeline_grad_shapes)
        ]
    consistency_rows: list[CommRow] = []
    if consistency_cadence is not None:
        semantic, wire = consistency_check_bytes(
            len(layer_dims),
            consistency_hp_entries,
            [L for L, _, _ in bucket_shapes],
            rows,
            cols,
        )
        consistency_rows.append(CommRow(
            phase='consistency_check',
            collective='all-reduce',
            axis='mesh',
            cadence='consistency_step',
            bytes_per_device=wire,
            payload_bytes=semantic,
            scope=world_scope,
        ))
    adaptive_rows: list[CommRow] = []
    if adaptive:
        semantic, wire = adaptive_digest_bytes(
            len(layer_dims), rows, cols,
        )
        adaptive_rows.append(CommRow(
            phase='adaptive_digest',
            collective='all-reduce',
            axis='mesh',
            cadence='factor_step',
            bytes_per_device=wire,
            payload_bytes=semantic,
            scope=world_scope,
        ))
    watchdog_rows: list[CommRow] = []
    if watchdog_cadence is not None:
        watchdog_rows.append(CommRow(
            phase='watchdog_check',
            collective='host',
            axis='-',
            cadence='watchdog_step',
            bytes_per_device=0,
            payload_bytes=0,
            scope='host',
        ))
    ckpt = checkpoint_bytes(
        layer_dims, factor_itemsize, diag_a, compress_symmetric,
    )
    return [
        CommRow(
            phase='factor_allreduce',
            collective='all-reduce',
            axis='data',
            cadence='factor_step',
            bytes_per_device=ring_allreduce_bytes(factors, world),
            payload_bytes=factors,
            scope=world_scope,
            overlapped=overlap_comm,
        ),
        *decomp_rows,
        *grad_rows,
        *consistency_rows,
        *adaptive_rows,
        *watchdog_rows,
        CommRow(
            phase='checkpoint',
            collective='host',
            axis='-',
            cadence='checkpoint',
            bytes_per_device=ckpt,
            payload_bytes=ckpt,
            scope='host',
        ),
    ]


def grid_scopes(topology: Any, rows: int, cols: int) -> tuple[str, str, str]:
    """``(world, column groups, row groups)`` link classes of a
    ``rows x cols`` grid on ``topology`` (``'flat'`` each without one);
    raises when the topology's world is not the grid's."""
    if topology is None:
        return 'flat', 'flat', 'flat'
    # Local import: placement.topology imports this module's byte models.
    from kfac_pytorch_tpu_torch.placement.topology import grid_col_ranks
    from kfac_pytorch_tpu_torch.placement.topology import grid_row_ranks

    world = rows * cols
    if topology.world != world:
        raise ValueError(
            f'topology world {topology.world} != grid world {world} '
            f'({rows}x{cols})',
        )
    return (
        topology.scope_of(range(world)),
        topology.scope_of_sets(grid_col_ranks(rows, cols)),
        topology.scope_of_sets(grid_row_ranks(rows, cols)),
    )


def cadence_events_per_step(
    cadence: str,
    factor_update_steps: int,
    inv_update_steps: int,
    consistency_steps: int | None = None,
    watchdog_steps: int | None = None,
    measured_rates: Mapping[str, float] | None = None,
) -> float:
    """Amortized per-training-step event rate of a ledger cadence:
    ``'step'`` 1, ``'factor_step'`` ``1/factor_update_steps``,
    ``'inv_step'`` ``1/inv_update_steps``, ``'checkpoint'`` 0, the guard
    cadences at their threaded intervals; ``measured_rates`` overrides
    the named cadences (each in ``[0, 1]``).  An unknown cadence, or a
    guard cadence without its interval, raises: no consumer may price a
    row at zero by not knowing it."""
    if measured_rates is not None and cadence in measured_rates:
        rate = float(measured_rates[cadence])
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f'measured rate for cadence {cadence!r} must be in '
                f'[0, 1] events/step; got {rate!r}',
            )
        return rate
    if cadence == 'step':
        return 1.0
    if cadence == 'factor_step':
        return 1.0 / max(factor_update_steps, 1)
    if cadence == 'inv_step':
        return 1.0 / max(inv_update_steps, 1)
    if cadence == 'checkpoint':
        return 0.0
    if cadence == 'consistency_step' and consistency_steps is not None:
        return 1.0 / max(consistency_steps, 1)
    if cadence == 'watchdog_step' and watchdog_steps is not None:
        return 1.0 / max(watchdog_steps, 1)
    raise ValueError(
        f'unknown ledger cadence {cadence!r} — teach '
        'cadence_events_per_step its event rate before emitting rows '
        'with it',
    )


def measured_rates_for(precond: Any) -> dict[str, float] | None:
    """``{'inv_step': refreshes/step}`` of a drift-adaptive run from its
    controller's counters, ``None`` without one or before a step."""
    ctl = getattr(precond, '_adaptive_controller', None)
    steps = getattr(precond, '_steps', 0)
    if ctl is None or steps <= 0:
        return None
    c = ctl.counters()
    refreshes = c['early'] + c['forced'] + c['scheduled']
    return {'inv_step': min(1.0, refreshes / steps)}


def amortized_bytes_per_step(
    ledger: Sequence[CommRow],
    factor_update_steps: int,
    inv_update_steps: int,
    consistency_steps: int | None = None,
    watchdog_steps: int | None = None,
    measured_rates: Mapping[str, float] | None = None,
) -> float:
    """Average per-device wire bytes per training step for a cadence
    (checkpoint rows count 0)."""
    return sum(
        row.bytes_per_device * cadence_events_per_step(
            row.cadence, factor_update_steps, inv_update_steps,
            consistency_steps, watchdog_steps, measured_rates,
        )
        for row in ledger
    )


def exposed_bytes_per_step(
    ledger: Sequence[CommRow],
    factor_update_steps: int,
    inv_update_steps: int,
    consistency_steps: int | None = None,
    watchdog_steps: int | None = None,
    measured_rates: Mapping[str, float] | None = None,
) -> float:
    """:func:`amortized_bytes_per_step` over the rows on the critical
    path (``overlapped=False``)."""
    return amortized_bytes_per_step(
        [row for row in ledger if not row.overlapped],
        factor_update_steps, inv_update_steps, consistency_steps,
        watchdog_steps, measured_rates,
    )


def hidden_bytes_per_step(
    ledger: Sequence[CommRow],
    factor_update_steps: int,
    inv_update_steps: int,
    consistency_steps: int | None = None,
    watchdog_steps: int | None = None,
    measured_rates: Mapping[str, float] | None = None,
) -> float:
    """:func:`amortized_bytes_per_step` over the ``overlapped`` rows."""
    return amortized_bytes_per_step(
        [row for row in ledger if row.overlapped],
        factor_update_steps, inv_update_steps, consistency_steps,
        watchdog_steps, measured_rates,
    )


def interval_bytes_per_device(
    ledger: Sequence[CommRow],
    factor_update_steps: int,
    inv_update_steps: int,
    consistency_steps: int | None = None,
    watchdog_steps: int | None = None,
    measured_rates: Mapping[str, float] | None = None,
) -> float:
    """Per-device wire bytes over one ``inv_update_steps`` interval."""
    return amortized_bytes_per_step(
        ledger, factor_update_steps, inv_update_steps, consistency_steps,
        watchdog_steps, measured_rates,
    ) * max(inv_update_steps, 1)


# ----------------------------------------------------------------------
# shape readers of a port preconditioner
# ----------------------------------------------------------------------


def stagger_shard_shapes_for(second: Any) -> (
    list[list[tuple[int, int, int]]] | None
):
    """Per-shard ``(n_slots, a_pad, g_pad)`` slices of a staggered
    :class:`~kfac_pytorch_tpu_torch.parallel.second_order.\
BucketedSecondOrder` (``None`` without a stagger plan)."""
    if second is None or second.stagger is None:
        return None
    pads = {b.key: (b.a_pad, b.g_pad) for b in second.plan.buckets}
    return [
        [(len(slots), *pads[key]) for key, slots in shard.items()]
        for shard in second.stagger.shards
    ]


def pipeline_grad_shapes_for(second: Any) -> (
    list[tuple[int, int, int]] | None
):
    """Issue-ordered ``(n_slots, a_pad, g_pad)`` bucket shapes of a
    pipelined stage (``None`` without ``pipeline_grads``)."""
    if second is None or second.pipeline_order is None:
        return None
    by_key = {b.key: b for b in second.plan.buckets}
    return [
        (by_key[k].n_slots, by_key[k].a_pad, by_key[k].g_pad)
        for k in second.pipeline_order
    ]


def consistency_hp_entries_for(precond: Any) -> int:
    """Hyperparameter scalars the consistency check digests: damping,
    factor decay and lr, kl-clip when clipping is on; 0 with
    ``include_hyperparams=False``."""
    cfg = getattr(precond, '_consistency', None)
    if cfg is not None and not cfg.include_hyperparams:
        return 0
    return 3 + (1 if precond.kl_clip is not None else 0)


def factor_comm_compress_flags(precond: Any) -> list[bool]:
    """Per registered layer (registration order), whether its factors
    ride the compressed collective (``factor_comm='bf16_triu'``: linear
    and conv2d layers)."""
    return [name in precond._compressed for name in precond.helpers]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _slot_field_bytes(precond: Any, b: Any) -> int:
    """Bytes of one slot of the fields the refresh gathers over the
    column for bucket ``b`` (``BucketedSecondOrder._zero_fields`` by
    shape, and the health verdict)."""
    from kfac_pytorch_tpu_torch.enums import ComputeMethod

    so = precond._second_order
    inv = _itemsize(so.inv_dtype)
    a, g = b.a_pad, b.g_pad
    if so.compute_method == ComputeMethod.EIGEN:
        lr_a, lr_g = so.lowrank_sides(b.key)
        ka = so.lowrank_rank if lr_a else a
        kg = so.lowrank_rank if lr_g else g
        n = (a * ka + g * kg) * inv
        if so.bucket_prediv(b.key):
            n += g * a * inv + 4  # dgda, bake_damping (f32)
        else:
            n += (ka + kg) * inv
        n += (int(lr_a) + int(lr_g)) * inv  # sa, sg
        if so.ekfac:
            n += g * a * 4  # skron (f32)
    else:
        n = (a * a + g * g) * inv
        if so.compute_method == ComputeMethod.ITERATIVE:
            n += 4 * 4 + 2 * 4  # residuals and bounds f32, stale i32
    if so.health is not None:
        n += 2 * 4  # the (ok, rounds) verdict, i32
    return n


def _share_slots(precond: Any, shard: int | None) -> dict[str, int]:
    """Per bucket, the slots this rank's column gathers in a refresh
    (``shard=None``: the whole column, ``seg``) or in stagger shard
    ``shard`` (its slots in this column); buckets gathering none are
    left out."""
    so = precond._second_order
    if shard is None:
        return {b.key: b.seg for b in so.plan.buckets}
    out = {}
    col = so.grid.col
    for b in so.plan.buckets:
        first = col * b.seg
        n = sum(first <= i < first + b.seg
                for i in so.stagger.shards[shard].get(b.key, ()))
        if n:
            out[b.key] = n
    return out


def _decomposition_gather_bytes(precond: Any, shard: int | None) -> int:
    """Gathered bytes of one refresh's column gather on this rank: each
    of the ``rows`` ranks' share padded to ``ceil(n / rows)`` slots."""
    so = precond._second_order
    rows = so.grid.rows
    if rows <= 1:
        return 0
    total = 0
    for key, n in _share_slots(precond, shard).items():
        per = -(-n // rows)
        total += rows * per * _slot_field_bytes(precond, so.plan.bucket(key))
    return total


def curvature_extremes_len(precond: Any) -> int:
    """Length of the ``observe_extremes`` vector: per bucket, the
    extremes :meth:`BucketedSecondOrder.curvature_stats` reduces over
    the row (``_extremes_vector``)."""
    return len(precond._second_order.curvature_extremes_layout(
        precond.buckets))


def _factor_buffers(precond: Any) -> tuple[list[int], int]:
    """``(dense all-reduce buffer bytes per dtype, compressed bytes)``
    of one factor step's all-reduce on this rank."""
    n = len(precond.helpers)
    by_dtype: dict[torch.dtype, int] = {}
    comp = 0
    fsize = _itemsize(precond.factor_dtype)
    flags = factor_comm_compress_flags(precond)
    for h, compressed in zip(precond.helpers.values(), flags):
        a, g = h.a_factor_shape[0], h.g_factor_shape[0]
        if compressed:
            comp += (a * (a + 1) // 2 + g * (g + 1) // 2) * 2
            continue
        elems = (a if h.diagonal_a else a * a) + g * g
        by_dtype[precond.factor_dtype] = (
            by_dtype.get(precond.factor_dtype, 0) + elems * fsize)
    k = 2
    if precond.ekfac:
        k = 3
        skron = sum(precond.plan.bucket(precond.plan.slot_of[name][0]).g_pad
                    * precond.plan.bucket(precond.plan.slot_of[name][0]).a_pad
                    for name in precond.helpers) * 4
        by_dtype[torch.float32] = by_dtype.get(torch.float32, 0) + skron
    by_dtype[torch.float64] = (2 * n + k * n) * 8
    return list(by_dtype.values()), comp


def ledger_for(precond: Any) -> list[CommRow]:
    """The communication ledger of a port preconditioner (bucketed
    stage), rows as the port's collectives move them (see the module
    docstring): one rank's view, in this order: ``factor_allreduce``, the
    decomposition gather (one row per stagger shard), the health and
    EKFAC refresh gathers, the gradient gather (one row per bucket under
    ``pipeline_grads``), ``observe_extremes``, the EKFAC drift gather,
    the guards' rows, ``checkpoint``.  With ``precond.topology`` each
    row is scope-tagged by its group (the module docstring)."""
    from kfac_pytorch_tpu_torch.parallel.collectives import group_size

    second = getattr(precond, '_second_order', None)
    if second is None:
        raise ValueError(
            'comm ledger requires the bucketed second-order stage '
            '(bucketed=True)',
        )
    grid = precond.grid
    rows, cols, world = grid.rows, grid.cols, grid.world
    if world != group_size(None):
        raise ValueError(
            f'the grid spans {world} ranks but torch.distributed '
            f'{group_size(None)}',
        )
    overlap = bool(getattr(precond, '_overlap_comm', False))
    out: list[CommRow] = []

    # The factor all-reduce (world), once per factor step.
    dense, comp = _factor_buffers(precond)
    payload = sum(dense) + comp if world > 1 else 0
    out.append(CommRow(
        phase='factor_allreduce', collective='all-reduce', axis='data',
        cadence='factor_step',
        bytes_per_device=sum(ring_allreduce_bytes(p, world)
                             for p in dense + ([comp] if comp else []))
        if world > 1 else 0,
        payload_bytes=payload,
    ))

    # The decomposition gather over the column, per refresh (or shard).
    shards = ([None] if second.stagger is None
              else list(range(second.stagger.n_shards)))
    for shard in shards:
        p = _decomposition_gather_bytes(precond, shard)
        out.append(CommRow(
            phase=('inverse_row_allgather' if shard is None
                   else f'inverse_row_allgather/shard{shard}'),
            collective='all-gather', axis='kfac_row', cadence='inv_step',
            bytes_per_device=allgather_bytes(p, rows), payload_bytes=p,
            overlapped=overlap,
        ))
    if second.health is not None:
        p = (cols * sum(b.seg for b in second.plan.buckets) * 3 * 4
             if cols > 1 else 0)
        out.append(CommRow(
            phase='health_counters', collective='all-gather',
            axis='kfac_col', cadence='inv_step',
            bytes_per_device=allgather_bytes(p, cols), payload_bytes=p,
        ))
    inv = _itemsize(second.inv_dtype)
    if second.ekfac and cols > 1:
        p = sum(cols * b.seg * (b.a_pad ** 2 + b.g_pad ** 2) * inv
                for b in second.plan.buckets)
        out.append(CommRow(
            phase='ekfac_basis_row_allgather', collective='all-gather',
            axis='kfac_col', cadence='inv_step',
            bytes_per_device=allgather_bytes(p, cols), payload_bytes=p,
        ))

    # The gradient gather over the row, every step.
    def grad_bytes(b):
        return cols * b.seg * (b.g_pad * b.a_pad + 1) * 4 if cols > 1 else 0

    if second.pipeline_order is None:
        p = sum(grad_bytes(b) for b in second.plan.buckets)
        out.append(CommRow(
            phase='grad_col_allgather', collective='all-gather',
            axis='kfac_col', cadence='step',
            bytes_per_device=allgather_bytes(p, cols), payload_bytes=p,
        ))
    else:
        order = second.pipeline_order
        for k, key in enumerate(order):
            p = grad_bytes(second.plan.bucket(key))
            out.append(CommRow(
                phase=f'grad_col_allgather/bucket{k}',
                collective='all-gather', axis='kfac_col', cadence='step',
                bytes_per_device=allgather_bytes(p, cols), payload_bytes=p,
                overlapped=k < len(order) - 1,
            ))
    obs = getattr(precond, '_observe', None)
    if obs is not None and obs.monitor:
        p = curvature_extremes_len(precond) * 4 if cols > 1 else 0
        out.append(CommRow(
            phase='observe_extremes', collective='all-reduce',
            axis='kfac_col', cadence='step',
            bytes_per_device=ring_allreduce_bytes(p, cols), payload_bytes=p,
        ))
    if second.ekfac and cols > 1:
        nb = sum(precond.buckets[b.key].skron is not None
                 for b in second.plan.buckets)
        p = cols * nb * 2 * 4
        out.append(CommRow(
            phase='ekfac_divergence_gather', collective='all-gather',
            axis='kfac_col', cadence='factor_step',
            bytes_per_device=allgather_bytes(p, cols), payload_bytes=p,
        ))

    # The guards.
    cfg = getattr(precond, '_consistency', None)
    if cfg is not None:
        p = 0
        if world > 1:
            basis = sum(getattr(precond.buckets[b.key], 'basis_qa', None)
                        is not None for b in second.plan.buckets)
            local = (2 * len(precond.layers) + 2 * basis
                     + consistency_hp_entries_for(precond)
                     + sum(2 * b.seg for b in second.plan.buckets))
            p = world * local * 8
        out.append(CommRow(
            phase='consistency_check', collective='all-gather',
            axis='mesh', cadence='consistency_step',
            bytes_per_device=allgather_bytes(p, world), payload_bytes=p,
        ))
    if getattr(precond, '_adaptive_controller', None) is not None:
        p = 5 * len(precond.helpers) * 8 if world > 1 else 0
        out.append(CommRow(
            phase='adaptive_digest', collective='all-reduce', axis='mesh',
            cadence='factor_step',
            bytes_per_device=ring_allreduce_bytes(p, world), payload_bytes=p,
        ))
    wcfg = getattr(precond, '_watchdog_config', None)
    if wcfg is not None:
        p = (wcfg.check_every * (1 + len(wcfg.signals)) * 8
             if world > 1 else 0)
        out.append(CommRow(
            phase='watchdog_check', collective='all-reduce', axis='data',
            cadence='watchdog_step',
            bytes_per_device=ring_allreduce_bytes(p, world), payload_bytes=p,
        ))
    layer_dims = [(h.a_factor_shape[0], h.g_factor_shape[0])
                  for h in precond.helpers.values()]
    diag = [h.diagonal_a for h in precond.helpers.values()]
    ckpt = checkpoint_bytes(layer_dims, _itemsize(precond.factor_dtype),
                            diag)
    out.append(CommRow(
        phase='checkpoint', collective='host', axis='-',
        cadence='checkpoint', bytes_per_device=ckpt, payload_bytes=ckpt,
        scope='host',
    ))
    world_scope, rows_scope, cols_scope = grid_scopes(
        getattr(precond, 'topology', None), rows, cols)
    by_axis = {'data': world_scope, 'mesh': world_scope,
               'kfac_row': rows_scope, 'kfac_col': cols_scope}
    return [row if row.scope == 'host'
            else dataclasses.replace(row, scope=by_axis[row.axis])
            for row in out]


def link_class_bytes(ledger: Sequence[CommRow]) -> dict[str, int]:
    """Per-link-class wire-byte subtotals of a ledger (host rows
    excluded)."""
    out: dict[str, int] = {}
    for row in ledger:
        if row.scope == 'host' or row.collective == 'host':
            continue
        out[row.scope] = out.get(row.scope, 0) + row.bytes_per_device
    return out


def format_ledger(
    ledger: Sequence[CommRow],
    factor_update_steps: int | None = None,
    inv_update_steps: int | None = None,
    consistency_steps: int | None = None,
    watchdog_steps: int | None = None,
) -> str:
    """Human-readable ledger table, with the amortized line when the
    cadence is given and the hidden-vs-exposed subtotals when a row is
    ``overlapped``."""
    overlapped_any = any(row.overlapped for row in ledger)
    lines = [
        f'{"phase":24s} {"collective":12s} {"axis":10s} '
        f'{"cadence":12s} {"scope":6s} {"KiB/device":>12s}'
        + ('  overlap' if overlapped_any else ''),
    ]
    for row in ledger:
        lines.append(
            f'{row.phase:24s} {row.collective:12s} {row.axis:10s} '
            f'{row.cadence:12s} {row.scope:6s} '
            f'{row.bytes_per_device / 1024:12.1f}'
            + (
                ('   hidden' if row.overlapped else '  exposed')
                if overlapped_any else ''
            ),
        )
    if factor_update_steps is not None and inv_update_steps is not None:
        amort = amortized_bytes_per_step(
            ledger, factor_update_steps, inv_update_steps,
            consistency_steps, watchdog_steps,
        )
        lines.append(
            f'{"amortized/step":24s} {"":12s} {"":10s} {"":12s} {"":6s} '
            f'{amort / 1024:12.1f}',
        )
        if overlapped_any:
            exposed = exposed_bytes_per_step(
                ledger, factor_update_steps, inv_update_steps,
                consistency_steps, watchdog_steps,
            )
            hidden = hidden_bytes_per_step(
                ledger, factor_update_steps, inv_update_steps,
                consistency_steps, watchdog_steps,
            )
            lines.append(
                f'{"exposed/step":24s} {"":12s} {"":10s} {"":12s} '
                f'{"":6s} {exposed / 1024:12.1f}',
            )
            lines.append(
                f'{"hidden/step":24s} {"":12s} {"":10s} {"":12s} '
                f'{"":6s} {hidden / 1024:12.1f}',
            )
    by_scope = link_class_bytes(ledger)
    if set(by_scope) - {'flat'}:
        for scope in sorted(by_scope):
            lines.append(
                f'{"subtotal/" + scope:24s} {"":12s} {"":10s} {"":12s} '
                f'{"":6s} {by_scope[scope] / 1024:12.1f}',
            )
    return '\n'.join(lines)


def ledger_scalars(ledger: Sequence[CommRow]) -> dict[str, float]:
    """Flat ``observe/comm/<phase>_bytes`` scalars for the emitters (and
    ``observe/comm/exposed_bytes``/``hidden_bytes`` when a row is
    ``overlapped``)."""
    out = {
        f'observe/comm/{row.phase}_bytes': float(row.bytes_per_device)
        for row in ledger
    }
    by_scope = link_class_bytes(ledger)
    if set(by_scope) - {'flat'}:
        for scope, total in by_scope.items():
            out[f'observe/comm/link/{scope}_bytes'] = float(total)
    if any(row.overlapped for row in ledger):
        wire = [
            row for row in ledger
            if row.scope != 'host' and row.collective != 'host'
        ]
        out['observe/comm/exposed_bytes'] = float(sum(
            row.bytes_per_device for row in wire if not row.overlapped
        ))
        out['observe/comm/hidden_bytes'] = float(sum(
            row.bytes_per_device for row in wire if row.overlapped
        ))
    return out
