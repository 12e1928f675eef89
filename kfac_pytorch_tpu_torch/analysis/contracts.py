"""Trace-contract pass: every step variant dry-run on fake tensors.

Port of ``kfac_pytorch_tpu/analysis/contracts.py``.  JAX dry-runs each
step variant with ``jax.eval_shape``; the port's counterpart is
``torch._subclasses.FakeTensorMode``: every op runs its shape and dtype
rule and allocates nothing, so a whole engine's step surface (ResNet-50
at full width included) is checked on the CPU in seconds.  The checks
are JAX's:

* **state fixpoint**: a step leaves every factor EMA, decomposition
  stack and health counter with the shape, dtype and device it had; a
  violation names the variant and the leaf path (which holds the layer
  or bucket);
* **gradient contract**: the preconditioned gradients match the
  trainable parameters leaf for leaf;
* **layer and bucket arithmetic** (:func:`validate_layer_contracts`):
  factor shapes and dtypes against the registered helpers, packed
  upper-triangle lengths ``n (n + 1) / 2`` through ``ops.get_triu``'s
  own fake evaluation, and the bucket plan's pad ladder and column-major
  slot layout;
* **default-off parity** (:func:`parity_diffs`): an engine with the
  observability pillars off traces the signatures of one built without
  them;
* **graph breaks** (:func:`tail_graph_breaks`): the precondition tail
  (``BucketedSecondOrder.precondition`` and the kl-clip scale) traced by
  ``torch.compile(fullgraph=True, backend='eager')``, which the fused
  kernel's custom op makes possible.

Why fake tensors and not a twin engine on the ``meta`` device: the
port's state lives in mutable objects (the layers' ``.grad``, the
engine's ``layers`` and ``buckets``, the capture's hooks), so the dry run
needs a copy of the engine whatever the device; a fake copy keeps each
tensor's real device and dtype, so a CUDA engine's signatures read
``cuda`` as its steps do, and ``FakeTensorMode`` refuses every host read
of a value, which is how a data-dependent sync in a variant shows up
here (as a ``ContractError`` naming it).  The copy
(:func:`fake_twin`) maps every tensor reachable from the engine to a
fake one and re-registers the capture hooks on the copied model, so the
real engine's ``state_dict()``, hooks and step counter stay bitwise
untouched.

The eigen refresh takes ``torch.linalg.eigh`` on fake tensors (its shape
rule) on every device: ``ops.symmetric_eigh``'s residual check on CUDA
reads values on the host, and a dry run has none.  The consistency
ladder's host walk (it reads host verdicts, and one process has no
mismatch to repair) is not run on the copy.
"""
from __future__ import annotations

import copy
import dataclasses
import types
from typing import Any, Callable, Mapping

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from kfac_pytorch_tpu_torch.analysis.signature import (
    LeafSig,
    abstract_signature,
    diff_signatures,
    format_diffs,
)

__all__ = [
    'ContractError',
    'DEFAULT_VARIANTS',
    'engine_variants',
    'fake_twin',
    'parity_diffs',
    'step_signatures',
    'tail_graph_breaks',
    'validate_engine',
    'validate_layer_contracts',
]


class ContractError(ValueError):
    """A traced contract does not match the engine's declared spec."""


# (variant name, update_factors, update_inverses[, refresh_shard[,
# deferred[, check_consistency]]]): JAX's gating combos.  Inverses never
# update before the first factor update, so (False, True) is not among
# them.
DEFAULT_VARIANTS: tuple[tuple[str, bool, bool], ...] = (
    ('plain', False, False),
    ('factor', True, False),
    ('inv', True, True),
)


def engine_variants(precond: Any) -> tuple[tuple, ...]:
    """Every variant ``precond``'s host dispatch can select (JAX
    ``contracts.py:75-132``): the three defaults; on a consistency engine
    ``plain+consistency`` and ``factor+consistency``; on a staggered
    engine a ``plain``/``factor`` pair per non-empty shard (their
    ``+overlap_shard<k>`` forms under ``overlap_comm``); on an overlap
    engine without stagger ``plain+overlap_inv`` and
    ``factor+overlap_inv``."""
    variants: list[tuple] = list(DEFAULT_VARIANTS)
    stagger = getattr(precond, 'stagger', None)
    overlap = getattr(precond, '_overlap_comm', False)
    if getattr(precond, '_consistency', None) is not None:
        variants.append(
            ('plain+consistency', False, False, None, None, True),
        )
        variants.append(
            ('factor+consistency', True, False, None, None, True),
        )
    if stagger is not None:
        for k in range(stagger.n_shards):
            if precond._stagger_shard_empty(k):
                continue
            if overlap:
                variants.append((
                    f'plain+overlap_shard{k}', False, False, None,
                    ('shard', k),
                ))
                variants.append((
                    f'factor+overlap_shard{k}', True, False, None,
                    ('shard', k),
                ))
            else:
                variants.append((f'plain+shard{k}', False, False, k))
                variants.append((f'factor+shard{k}', True, False, k))
    elif overlap:
        variants.append(
            ('plain+overlap_inv', False, False, None, ('inv',)),
        )
        variants.append(
            ('factor+overlap_inv', True, False, None, ('inv',)),
        )
    return tuple(variants)


def _packed_triu_len(dim: int) -> int:
    return dim * (dim + 1) // 2


def _fake_memo(root: Any, mode: FakeTensorMode) -> dict[int, Any]:
    """A ``copy.deepcopy`` memo mapping every tensor reachable from
    ``root`` (attributes, containers, dataclasses, module parameters and
    buffers, a parameter's ``.grad``) to a fake copy."""
    memo: dict[int, Any] = {}
    seen: set[int] = set()
    keep: list = []
    stack = [root]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        keep.append(o)
        if isinstance(o, torch.Tensor):
            if isinstance(o, torch.nn.Parameter):
                f = torch.nn.Parameter(mode.from_tensor(o),
                                       requires_grad=o.requires_grad)
                if o.grad is not None:
                    f.grad = mode.from_tensor(o.grad)
            else:
                f = mode.from_tensor(o)
            memo[id(o)] = f
            continue
        if isinstance(o, (str, bytes, int, float, bool, type(None), type,
                          types.ModuleType)):
            continue
        if isinstance(o, Mapping):
            stack.extend(o.keys())
            stack.extend(o.values())
            continue
        if isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
            continue
        if isinstance(o, types.MethodType):
            stack.append(o.__self__)
            continue
        if callable(o) and not hasattr(o, '__dict__'):
            continue
        d = getattr(o, '__dict__', None)
        if isinstance(d, dict):
            stack.extend(d.values())
        for s in getattr(type(o), '__slots__', ()):
            if hasattr(o, s):
                stack.append(getattr(o, s))
    memo[id(memo)] = keep
    return memo


def _rebind_hooks(capture: Any) -> None:
    """Point a copied capture's hooks at the copy: the copied modules
    kept the original closures, which file into the original capture."""
    modules = dict(capture.model.named_modules())
    for m in modules.values():
        m._forward_pre_hooks.clear()
        m._forward_hooks.clear()
    for name, helper in capture.helpers.items():
        helper.module.register_forward_pre_hook(
            capture._make_pre_hook('_acts', name))
        helper.module.register_forward_hook(
            capture._make_fwd_hook('_grads', name))
    for base, (head, _) in capture.attend.items():
        modules[head].register_forward_pre_hook(capture._make_pre_hook(
            '_attend_acts', base, weight=modules[base].weight))
        modules[head].register_forward_hook(
            capture._make_fwd_hook('_attend_grads', base))


def fake_twin(precond: Any, mode: FakeTensorMode) -> Any:
    """A copy of ``precond`` whose every tensor is a fake tensor of
    ``mode``, with its own model copy and capture hooks, and no guard.
    The original is read only."""
    memo = _fake_memo(precond, mode)
    # The copy dispatches unguarded.
    memo[id(precond._retrace_guard)] = None
    twin = copy.deepcopy(precond, memo)
    _rebind_hooks(twin._capture)
    return twin


def _fake_args(mode: FakeTensorMode, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return mode.from_tensor(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake_args(mode, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _fake_args(mode, v) for k, v in tree.items()}
    return tree


def _params(precond: Any) -> dict[str, torch.Tensor]:
    return {name: p for name, p in precond._capture_module().named_parameters()
            if p.requires_grad}


class _InlineRefresh:
    """``overlap.DeferredRefresh`` run at once in the calling thread."""

    def __init__(self, fn: Callable[[], Any], device: Any,
                 stream: Any = None,
                 finish: Callable[[Any], Any] | None = None) -> None:
        with torch.no_grad():
            self._result = fn()
        self._finish = finish

    def join(self) -> None:
        pass

    def wait(self) -> Any:
        if self._finish is not None:
            with torch.no_grad():
                self._result, self._finish = self._finish(self._result), None
        return self._result


def _dry_step(
    twin: Any,
    variant: tuple,
    args: tuple,
    loss_args: tuple,
    loss_fn: Callable[..., Any],
) -> dict[str, Any]:
    """One forced variant of ``twin``'s step (inside the fake mode):
    forward, backward and the step's work; returns what it produced."""
    from kfac_pytorch_tpu_torch.engine import _split_loss

    name, update_factors, update_inverses, *rest = variant
    shard = rest[0] if rest else None
    deferred = rest[1] if len(rest) > 1 else None
    check = rest[2] if len(rest) > 2 else False
    if update_factors:
        twin._factors_initialized = True
    if deferred is not None:
        # The refresh the previous step deferred, issued now and run in
        # this thread (the fake mode is this thread's).
        from kfac_pytorch_tpu_torch import base_preconditioner

        twin._overlap_bootstrapped = True
        twin._overlap_pending = deferred
        worker = base_preconditioner.DeferredRefresh
        base_preconditioner.DeferredRefresh = _InlineRefresh
        try:
            twin._overlap_inflight = twin._issue_deferred_refresh(
                deferred, twin.damping)
        finally:
            base_preconditioner.DeferredRefresh = worker
    twin._overlap_plan = lambda: (update_factors, update_inverses, shard,
                                  deferred, None)
    twin._consistency_due = lambda: check
    twin._consistency_finish = lambda info: info
    twin._arm_capture(update_factors)
    module = twin._capture_module()
    module.zero_grad(set_to_none=True)
    loss, _ = _split_loss(loss_fn(module(*args), *loss_args))
    loss.backward()
    twin._step()
    return {
        'loss': loss.detach(),
        'grads': {n: p.grad for n, p in _params(twin).items()},
        'state': twin._variant_state(),
        'info': twin.last_step_info,
    }


def step_signatures(
    precond: Any,
    args: tuple,
    loss_args: tuple = (),
    loss_fn: Callable[..., Any] | None = None,
    variants: tuple[tuple, ...] = DEFAULT_VARIANTS,
) -> dict[str, dict[str, LeafSig]]:
    """Abstract output signature of every step variant, each run on its
    own fake copy of ``precond`` (:func:`fake_twin`; a copy of a fresh
    engine runs the bootstrap refresh first, as step 0 does), with the
    state fixpoint and gradient contracts checked; returns ``{variant:
    signature of (loss, grads, state, info)}``, the unit of
    :func:`parity_diffs`.  ``loss_fn(model(*args), *loss_args)`` is the
    loss (default: the engine's ``loss_fn``).

    Raises:
        ContractError: a variant failed to run on fake tensors (a
            shape or dtype mismatch, or a host read of a value), or is
            not signature-preserving on the K-FAC state, or its
            gradients do not match the parameters: naming the variant
            and the leaf path.
    """
    if loss_fn is None:
        loss_fn = getattr(precond, 'loss_fn', None)
    if loss_fn is None:
        raise ValueError('step_signatures needs a loss_fn')
    params_sig = abstract_signature(_params(precond))
    out: dict[str, dict[str, LeafSig]] = {}
    for variant in variants:
        name = variant[0]
        mode = FakeTensorMode()
        with mode:
            twin = fake_twin(precond, mode)
            fargs = _fake_args(mode, tuple(args))
            floss = _fake_args(mode, tuple(loss_args))
            try:
                if twin.steps == 0:
                    # A fresh engine's first step is the bootstrap
                    # refresh, which allocates what the replicated
                    # engine keeps per layer; every variant runs after.
                    _dry_step(twin, ('bootstrap', True, True), fargs,
                              floss, loss_fn)
                state_sig = abstract_signature(twin._variant_state())
                produced = _dry_step(twin, variant, fargs, floss, loss_fn)
            except Exception as e:
                raise ContractError(
                    f'step variant {name!r} failed to trace: '
                    f'{type(e).__name__}: {e}',
                ) from e
        diffs = diff_signatures(
            state_sig, abstract_signature(produced['state']),
        )
        if diffs:
            raise ContractError(
                f'step variant {name!r} is not signature-preserving on the '
                'K-FAC state (the next step would run another program or '
                'mis-broadcast):\n' + format_diffs(diffs),
            )
        diffs = diff_signatures(
            params_sig, abstract_signature(produced['grads']),
        )
        if diffs:
            raise ContractError(
                f'step variant {name!r}: preconditioned grads do not match '
                'the trainable parameters:\n' + format_diffs(diffs),
            )
        if tuple(produced['loss'].shape) != ():
            raise ContractError(
                f'step variant {name!r}: loss is not a scalar (shape '
                f'{tuple(produced["loss"].shape)})',
            )
        out[name] = abstract_signature(produced)
    return out


def validate_layer_contracts(precond: Any) -> None:
    """Check per-layer factor geometry and dtype and the bucket plan's
    arithmetic (JAX ``validate_layer_contracts``); every failure names
    the layer, or the bucket and field."""
    from kfac_pytorch_tpu_torch import ops
    from kfac_pytorch_tpu_torch.parallel.bucketing import pad_dim

    layers = precond.layers
    for name, helper in precond.helpers.items():
        st = layers.get(name)
        if st is None:
            raise ContractError(
                f'layer {name!r} is registered but has no state entry',
            )
        a_dim = helper.a_factor_shape[0]
        g_dim = helper.g_factor_shape[0]
        want_a = (a_dim,) if helper.diagonal_a else (a_dim, a_dim)
        if tuple(st.a_factor.shape) != want_a:
            raise ContractError(
                f'layer {name!r}: A factor shape '
                f'{tuple(st.a_factor.shape)} != expected {want_a} from '
                f'helper {type(helper).__name__}',
            )
        if tuple(st.g_factor.shape) != (g_dim, g_dim):
            raise ContractError(
                f'layer {name!r}: G factor shape '
                f'{tuple(st.g_factor.shape)} != expected '
                f'{(g_dim, g_dim)} from helper {type(helper).__name__}',
            )
        for label, factor in (('A', st.a_factor), ('G', st.g_factor)):
            if factor.dtype != precond.factor_dtype:
                raise ContractError(
                    f'layer {name!r}: {label} factor dtype {factor.dtype} '
                    f'!= the engine\'s factor_dtype {precond.factor_dtype}',
                )
        if helper.diagonal_a:
            continue
        for label, factor in (('A', st.a_factor), ('G', st.g_factor)):
            with FakeTensorMode() as mode:
                packed = ops.get_triu(mode.from_tensor(factor))
            want = _packed_triu_len(factor.shape[-1])
            if packed.shape[-1] != want:
                raise ContractError(
                    f'layer {name!r}: packed {label} triu length '
                    f'{packed.shape[-1]} != dim*(dim+1)/2 = {want}',
                )

    plan = getattr(precond, 'plan', None)
    if plan is None:
        return
    for b in plan.buckets:
        if len(b.slots) != b.seg * plan.n_cols:
            raise ContractError(
                f'bucket {b.key!r}: {len(b.slots)} slots != seg '
                f'{b.seg} * n_cols {plan.n_cols} (column-major layout '
                'broken)',
            )
        for i, name in enumerate(b.slots):
            if name is None:
                continue
            if plan.slot_of.get(name) != (b.key, i):
                raise ContractError(
                    f'layer {name!r}: slot_of says '
                    f'{plan.slot_of.get(name)} but bucket {b.key!r} '
                    f'holds it at slot {i}',
                )
            helper = precond.helpers[name]
            for label, dim, pad in (
                ('A', helper.a_factor_shape[0], b.a_pad),
                ('G', helper.g_factor_shape[0], b.g_pad),
            ):
                if pad_dim(dim) != pad:
                    raise ContractError(
                        f'layer {name!r} in bucket {b.key!r}: {label} '
                        f'dim {dim} pads to {pad_dim(dim)}, bucket '
                        f'declares {pad}',
                    )
    buckets = getattr(precond, 'buckets', None) or {}
    for b in plan.buckets:
        bs = buckets.get(b.key)
        if bs is None:
            raise ContractError(
                f'bucket {b.key!r} has no second-order state entry',
            )
        # This rank's column: seg slots (the EKFAC bases hold the
        # occupied slots of every column instead).
        for f in dataclasses.fields(bs):
            arr = getattr(bs, f.name)
            if (f.name.startswith('basis_') or not isinstance(
                    arr, torch.Tensor) or arr.ndim == 0):
                continue
            if arr.shape[0] != b.seg:
                raise ContractError(
                    f'bucket {b.key!r} field {f.name!r}: stack leading '
                    f'dim {arr.shape[0]} != {b.seg} slots',
                )


def parity_diffs(
    a: Mapping[str, Mapping[str, LeafSig]],
    b: Mapping[str, Mapping[str, LeafSig]],
) -> dict[str, str]:
    """Per-variant formatted signature diffs between two engines; empty
    when they trace the same signatures (the default-off parity pin)."""
    out: dict[str, str] = {}
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            out[name] = 'variant only traced by one engine'
            continue
        diffs = diff_signatures(a[name], b[name])
        if diffs:
            out[name] = format_diffs(diffs)
    return out


def tail_graph_breaks(precond: Any) -> int:
    """Graph breaks of the engine's precondition tail under
    ``torch.compile(backend='eager')``: the bucket stacks' tail
    (``BucketedSecondOrder.precondition``, which launches the fused
    kernel's custom op) and the kl-clip scale, on a fake copy's state
    and gradients, at canonical hyperparameters.  0 is the contract; a
    one-process engine only (a row gather across ranks is a collective,
    which Dynamo does not trace)."""
    import torch._dynamo

    so = getattr(precond, '_second_order', None)
    if so is None:
        raise ValueError('the precondition tail needs a bucketed engine')
    with FakeTensorMode() as mode:
        twin = fake_twin(precond, mode)
        grads = {
            name: torch.zeros(
                (h.g_factor_shape[0], h.a_factor_shape[0]),
                device=twin.device,
            )
            for name, h in twin.helpers.items()
            if name not in twin.diag_layers
        }
        damping, kl_clip, lr = twin._tail_hyperparams()

        def tail(buckets, grads, damping, kl_clip, lr):
            return twin._second_order.precondition(
                buckets, grads, damping, kl_clip, lr)

        torch._dynamo.reset()
        explained = torch._dynamo.explain(tail)(
            twin.buckets, grads, damping, kl_clip, lr)
    torch._dynamo.reset()
    return int(explained.graph_break_count)


def validate_engine(
    precond: Any,
    args: tuple,
    loss_args: tuple = (),
    loss_fn: Callable[..., Any] | None = None,
) -> dict[str, dict[str, LeafSig]]:
    """The whole pass: layer and bucket arithmetic, then every variant
    of :func:`engine_variants` through :func:`step_signatures`; returns
    the per-variant signatures."""
    validate_layer_contracts(precond)
    return step_signatures(
        precond, args, loss_args, loss_fn,
        variants=engine_variants(precond),
    )
