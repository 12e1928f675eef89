"""Activation / output-gradient capture through module hooks.

Port of ``kfac_pytorch_tpu/capture.py``.  JAX has no hooks, so the JAX
package captures with interceptors and zero probes; the port returns to
the mechanism of the original torch library:

* **registration** walks ``model.named_modules()`` and builds a helper
  for every module of a kind in ``layer_types``: ``nn.Linear``,
  ``nn.Conv2d``, ``nn.Embedding``, ``nn.LayerNorm`` and the port's
  :class:`~kfac_pytorch_tpu_torch.models.layers.DenseGeneral`
  (``skip_layers`` regexes skip by name or class name; ``kfac_approx``
  picks expand or reduce per linear and ``dense_general`` layer; a
  tensor-parallel ``nn.Linear`` shard gets the helper of its full layer,
  :mod:`~kfac_pytorch_tpu_torch.layers.tensor`).  A
  layer it cannot precondition is rejected with a reason and a warning,
  and trains on its raw gradient; among them the ``nn.Linear``
  submodules of ``torch.nn.MultiheadAttention``, whose forward never
  runs as a module call;
* **capture** uses a forward pre-hook that stores each layer's input
  and a forward hook that puts a tensor hook on the layer's output, so
  the backward pass delivers ``d(loss)/d(output)``.  Both do nothing
  unless the owner has armed the capture (factor-update steps only),
  the module is in training mode and autograd is recording.

A module applied several times in one forward pass yields one capture
per call; the engine averages the factor contributions over calls.

Under gradient accumulation the owner sets :attr:`ModelCapture.fold`:
the first recording forward pre-hook after a backward pass calls it, so
the finished micro-batch's captures are folded into running sums (and
released) before the next micro-batch records.

A tied embedding (``tied_weights``) has a second application, the LM
head ``x @ E^T``, which JAX intercepts as ``Embed.attend``.  In PyTorch
the head is a :class:`~kfac_pytorch_tpu_torch.layers.coverage.TiedAttend`
module naming the embedding; its calls are captured into lists of their
own under the embedding's name and feed the same factor set with the
roles swapped.  (Output gradients arrive in backward order, so mixing
them into the lookup's lists would pair the two applications crosswise.)
"""
from __future__ import annotations

import math
import re
import warnings
from typing import Any, Callable, Iterable, Sequence

import torch
from torch import nn

from kfac_pytorch_tpu_torch.layers.coverage import DenseGeneralHelper
from kfac_pytorch_tpu_torch.layers.coverage import DenseGeneralReduceHelper
from kfac_pytorch_tpu_torch.layers.coverage import KfacExpandHelper
from kfac_pytorch_tpu_torch.layers.coverage import KfacReduceHelper
from kfac_pytorch_tpu_torch.layers.coverage import ScaleBiasHelper
from kfac_pytorch_tpu_torch.layers.coverage import TiedAttend
from kfac_pytorch_tpu_torch.layers.coverage import TiedAttendHelper
from kfac_pytorch_tpu_torch.layers.coverage import TiedEmbedHelper
from kfac_pytorch_tpu_torch.layers.helpers import ConvHelper
from kfac_pytorch_tpu_torch.layers.helpers import DenseHelper
from kfac_pytorch_tpu_torch.layers.helpers import EmbedHelper
from kfac_pytorch_tpu_torch.layers.helpers import LayerHelper
from kfac_pytorch_tpu_torch.layers.tensor import parallel_dense_helper
from kfac_pytorch_tpu_torch.models.layers import DenseGeneral
from kfac_pytorch_tpu_torch.models.layers import recomputing
from kfac_pytorch_tpu_torch.parallel.tensor import ParallelDense

#: The JAX package's kinds; ``layernorm`` and ``dense_general`` (the
#: multi-head attention projections) are the opt-in full-coverage ones.
KNOWN_MODULES = frozenset({
    'linear', 'conv2d', 'embedding', 'layernorm', 'dense_general',
})
DEFAULT_LAYER_TYPES = frozenset({'linear', 'conv2d'})
KNOWN_APPROX = ('expand', 'reduce')

#: Why the ``nn.Linear`` inside ``torch.nn.MultiheadAttention`` is
#: rejected.
MHA_REASON = (
    'a projection of torch.nn.MultiheadAttention, which runs inside '
    'F.multi_head_attention_forward from the raw weights, where module '
    'hooks see neither its input nor its output gradient; build the '
    'attention from kfac_pytorch_tpu_torch.models.layers.'
    "MultiHeadDotProductAttention and add 'dense_general' to layer_types "
    'to precondition it'
)

#: ``(helper, activations, output gradients)`` of one role of a layer:
#: its own calls, or a tied embedding's attend calls.
Role = tuple[LayerHelper, list, list]


def any_match(query: Iterable[str], patterns: Sequence[str]) -> bool:
    """True if any pattern re.search-matches any query string."""
    return any(
        re.search(p, q) is not None for p in patterns for q in query
    )


def _module_kind(module: nn.Module) -> str | None:
    if isinstance(module, nn.Linear):
        return 'linear'
    if isinstance(module, nn.Conv2d):
        return 'conv2d'
    if isinstance(module, nn.Embedding):
        return 'embedding'
    if isinstance(module, nn.LayerNorm):
        return 'layernorm'
    if isinstance(module, DenseGeneral):
        return 'dense_general'
    return None


def _conv_padding(module: nn.Conv2d) -> tuple[int, int] | None:
    pad = module.padding
    if isinstance(pad, str):
        return (0, 0) if pad == 'valid' else None
    return (int(pad[0]), int(pad[1]))


def _check_options(
    layer_types: frozenset[str], kfac_approx: Any, tied_weights: tuple,
) -> None:
    unknown = layer_types - KNOWN_MODULES
    if unknown:
        raise ValueError(
            f'Unknown layer types {sorted(unknown)}; known: '
            f'{sorted(KNOWN_MODULES)}',
        )
    modes = (
        {'': kfac_approx} if isinstance(kfac_approx, str)
        else dict(kfac_approx)
    )
    bad = {p: m for p, m in modes.items() if m not in KNOWN_APPROX}
    if bad:
        raise ValueError(
            f'kfac_approx must be one of {KNOWN_APPROX} or a {{pattern: '
            f'mode}} mapping of them; got {kfac_approx!r}',
        )
    if tied_weights and 'embedding' not in layer_types:
        raise ValueError(
            "tied_weights declares shared embedding tables but 'embedding' "
            'is not in layer_types; the tied factor set is fed through the '
            "embedding lookup capture, so add 'embedding' to layer_types",
        )


class ModelCapture:
    """Hooked access to a model's K-FAC layers.

    Args:
        model: the module to instrument.
        skip_layers: regexes; a layer whose name or class name matches
            one is not registered.
        layer_types: kinds to register (a subset of ``KNOWN_MODULES``).
        kfac_approx: ``'expand'`` (default), ``'reduce'``, or a mapping
            of regexes (on the layer name and class name) to those
            modes, for linear and ``dense_general`` layers; a pattern
            that selects none of them raises.
        tied_weights: names of ``nn.Embedding`` modules whose weight a
            :class:`~kfac_pytorch_tpu_torch.layers.coverage.TiedAttend`
            head shares; needs ``'embedding'`` in ``layer_types``.  A
            ``skip_layers`` pattern matching the embedding or its head
            raises, and so does a tie with no head.

    Attributes:
        helpers: layer name -> helper, in registration order.
        attend: tied embedding name -> ``(head module name,
            TiedAttendHelper)``.
        skipped: names matched by ``skip_layers``.
        rejected: layer name -> reason it cannot be preconditioned.
        coverage: the coverage report (:meth:`_coverage_report`).
        armed: capture switch; the hooks record only while it is True.
        fold: ``None``, or a callable that consumes the captures of a
            finished forward/backward pass (through :meth:`take`); it
            runs in the first recording pre-hook after output gradients
            have arrived.
    """

    def __init__(
        self,
        model: nn.Module,
        skip_layers: Sequence[str] = (),
        layer_types: Iterable[str] = DEFAULT_LAYER_TYPES,
        kfac_approx: Any = 'expand',
        tied_weights: Sequence[str] = (),
    ) -> None:
        layer_types = frozenset(layer_types)
        tied_weights = tuple(tied_weights)
        _check_options(layer_types, kfac_approx, tied_weights)
        self.model = model
        self.skip_layers = tuple(skip_layers)
        self.layer_types = layer_types
        self.kfac_approx = kfac_approx
        self.tied_weights = tied_weights
        self.helpers: dict[str, LayerHelper] = {}
        self.attend: dict[str, tuple[str, TiedAttendHelper]] = {}
        self.skipped: list[str] = []
        self.rejected: dict[str, str] = {}
        self.armed = False
        self.fold: Callable[[], None] | None = None
        self._acts: dict[str, list[torch.Tensor]] = {}
        self._grads: dict[str, list[torch.Tensor]] = {}
        self._attend_acts: dict[str, list[torch.Tensor]] = {}
        self._attend_grads: dict[str, list[torch.Tensor]] = {}
        # Set by the first output gradient after a take() or clear(): a
        # backward pass has run since, so the next forward may fold.
        self._grads_arrived = False
        self._register()
        for name, reason in self.rejected.items():
            warnings.warn(
                f'K-FAC capture cannot precondition layer {name!r}: '
                f'{reason}; it will train on its raw gradient.',
                stacklevel=3,
            )
        self.coverage = self._coverage_report()

    def _skipped(self, name: str, module: nn.Module, tied: str | None):
        if not self.skip_layers or not any_match(
            (name, type(module).__name__), self.skip_layers,
        ):
            return False
        if tied is not None:
            # A half-registered tie would feed one factor set from one
            # application while the shared gradient carries both.
            raise ValueError(
                f'skip_layers pattern matches layer {name!r} '
                f'({type(module).__name__}), which tied_weights declares '
                f'as part of the shared embedding {tied!r}; remove the '
                'skip pattern or the tied_weights entry',
            )
        return True

    def _approx_for(self, name: str, module: nn.Module) -> tuple[str, bool]:
        """``(mode, explicit)`` of a linear or ``dense_general`` layer;
        ``explicit`` marks a mapping match."""
        if isinstance(self.kfac_approx, str):
            return self.kfac_approx, False
        for pattern, mode in dict(self.kfac_approx).items():
            if any_match((name, type(module).__name__), (pattern,)):
                self._approx_matched.add(pattern)
                return mode, True
        return 'expand', False

    def _register(self) -> None:
        self._approx_matched: set[str] = set()
        modules = dict(self.model.named_modules())
        heads = {
            name: m for name, m in modules.items()
            if isinstance(m, TiedAttend) and m.tied_to in self.tied_weights
        }
        for base in self.tied_weights:
            if not isinstance(modules.get(base), nn.Embedding):
                raise ValueError(
                    f'tied_weights declares {base!r} but the model has no '
                    'nn.Embedding of that name (module names as in '
                    'model.named_modules())',
                )
            if not any(h.tied_to == base for h in heads.values()):
                raise ValueError(
                    f'tied_weights declares {base!r} but no TiedAttend '
                    'module is tied to it: the head is not tied to this '
                    'table (drop the declaration rather than feed the '
                    'factor set a phantom application)',
                )
        mha = tuple(name + '.' for name, m in modules.items()
                    if isinstance(m, nn.MultiheadAttention))
        for name, module in modules.items():
            kind = _module_kind(module)
            if kind is None or kind not in self.layer_types:
                continue
            tied = name if name in self.tied_weights else None
            if self._skipped(name, module, tied):
                self.skipped.append(name)
                continue
            if kind == 'linear' and name.startswith(mha):
                self.rejected[name] = MHA_REASON
                continue
            helper, reason = self._make_helper(kind, name, module)
            if helper is None:
                self.rejected[name] = reason
                continue
            self.helpers[name] = helper
            module.register_forward_pre_hook(
                self._make_pre_hook('_acts', name))
            module.register_forward_hook(self._make_fwd_hook('_grads', name))
        for name, head in heads.items():
            base = head.tied_to
            if base in self.attend:
                raise ValueError(
                    f'tied embedding {base!r} has two TiedAttend heads '
                    f'({self.attend[base][0]!r} and {name!r})',
                )
            self._skipped(name, head, base)  # raises on a skipped head
            if base not in self.helpers:
                raise ValueError(
                    f'tied embedding {base!r} cannot be preconditioned: '
                    f'{self.rejected[base]}',
                )
            lookup = self.helpers[base]
            self.attend[base] = (name, TiedAttendHelper(
                name=name, module=modules[base], has_bias=False,
                in_features=lookup.in_features,
                out_features=lookup.out_features,
            ))
            head.register_forward_pre_hook(self._make_pre_hook(
                '_attend_acts', base, weight=modules[base].weight))
            head.register_forward_hook(
                self._make_fwd_hook('_attend_grads', base))
        if not isinstance(self.kfac_approx, str):
            unmatched = set(self.kfac_approx) - self._approx_matched
            if unmatched:
                raise ValueError(
                    f'kfac_approx patterns {sorted(unmatched)} matched no '
                    'registered linear/dense_general layer (matched on the '
                    'layer name and class name); fix the pattern or drop '
                    'the entry',
                )

    def _coverage_report(self) -> dict[str, Any]:
        """Preconditioned-parameter coverage of the model (the JAX
        ``ModelCapture._coverage_report``, with the same keys).

        ``registered`` counts the registered layers and tied heads,
        ``tied`` the heads; ``param_fraction`` is the fraction of the
        trainable parameter elements whose gradient the preconditioner
        transforms, and ``uncovered`` names every parameter that trains
        on its raw gradient (a bare parameter such as a position table,
        and those of skipped and rejected layers).  Counted from the
        module tree: a module applied twice is one layer here, where the
        JAX registration trace counts each call.
        """
        # A model that is itself a layer registers as '' and owns all.
        prefixes = tuple(f'{name}.' if name else '' for name in self.helpers)
        total = covered = 0
        uncovered: list[str] = []
        for name, p in self.model.named_parameters():
            total += p.numel()
            if name.startswith(prefixes):
                covered += p.numel()
            else:
                uncovered.append(name)
        return {
            'registered': len(self.helpers) + len(self.attend),
            'skipped': len(self.skipped),
            'unsupported': len(self.rejected),
            'tied': len(self.attend),
            'params_total': total,
            'params_covered': covered,
            'param_fraction': (covered / total) if total else 0.0,
            'uncovered': sorted(uncovered),
        }

    def _make_helper(
        self, kind: str, name: str, module: nn.Module,
    ) -> tuple[LayerHelper | None, str | None]:
        if kind == 'linear' and isinstance(module, ParallelDense):
            # The full layer behind a tensor-parallel shard.
            if self._approx_for(name, module)[0] != 'expand':
                return None, (
                    "kfac_approx='reduce' on a tensor-parallel layer (its "
                    'helper gathers the expand rows)'
                )
            return parallel_dense_helper(name, module), None
        if kind == 'linear':
            mode, explicit = self._approx_for(name, module)
            cls = (KfacReduceHelper if mode == 'reduce'
                   else KfacExpandHelper if explicit else DenseHelper)
            return cls(
                name=name, module=module, has_bias=module.bias is not None,
                in_features=module.in_features,
                out_features=module.out_features,
            ), None
        if kind == 'dense_general':
            if not module.trailing:
                return None, (
                    f'DenseGeneral with non-trailing contraction axes '
                    f'{module.axis!r} is unsupported (the factor math '
                    'flattens trailing axes only)'
                )
            mode, _ = self._approx_for(name, module)
            cls = (DenseGeneralReduceHelper if mode == 'reduce'
                   else DenseGeneralHelper)
            return cls(
                name=name, module=module, has_bias=module.bias is not None,
                in_features=math.prod(module.in_shape),
                out_features=math.prod(module.features),
                kernel_in_ndim=len(module.in_shape),
                kernel_out_ndim=len(module.features),
            ), None
        if kind == 'embedding':
            if module.sparse:
                return None, 'sparse embedding gradients'
            if module.padding_idx is not None:
                return None, (
                    f'padding_idx={module.padding_idx} (its gradient row is '
                    'masked, which a preconditioned gradient would undo)'
                )
            cls = (TiedEmbedHelper if name in self.tied_weights
                   else EmbedHelper)
            return cls(
                name=name, module=module, has_bias=False,
                in_features=module.num_embeddings,
                out_features=module.embedding_dim,
            ), None
        if kind == 'layernorm':
            if module.weight is None or module.bias is None:
                return None, (
                    'LayerNorm without both scale and bias has no '
                    'elementwise-affine pair to precondition'
                )
            if len(module.normalized_shape) != 1:
                return None, (
                    f'LayerNorm over {tuple(module.normalized_shape)} (the '
                    'scale+bias factor math normalizes over the last axis '
                    'only)'
                )
            return ScaleBiasHelper(
                name=name, module=module, has_bias=True, in_features=1,
                out_features=module.normalized_shape[0],
                epsilon=float(module.eps),
            ), None
        if module.groups != 1:
            return None, (
                f'grouped convs (groups={module.groups}) have no Kronecker '
                'factor structure'
            )
        if tuple(module.dilation) != (1, 1):
            return None, f'dilated convs (dilation={module.dilation})'
        if module.padding_mode != 'zeros':
            return None, f'padding_mode={module.padding_mode!r}'
        padding = _conv_padding(module)
        if padding is None:
            return None, (
                f'padding={module.padding!r}; use explicit symmetric '
                'padding for K-FAC conv layers'
            )
        return ConvHelper(
            name=name, module=module, has_bias=module.bias is not None,
            in_features=module.in_channels,
            out_features=module.out_channels,
            kernel_size=tuple(module.kernel_size),
            strides=tuple(module.stride),
            padding=padding,
        ), None

    def _recording(self, module: nn.Module) -> bool:
        return (self.armed and module.training and torch.is_grad_enabled()
                and not recomputing())

    def _make_pre_hook(self, store: str, name: str, weight=None):
        """Records ``inputs[0]`` into ``self.<store>[name]``; a tied head
        must be called with the embedding's ``weight``."""
        def hook(module, inputs):
            if not self._recording(module):
                return
            if self.fold is not None and self._grads_arrived:
                self.fold()
            if weight is not None and inputs[1] is not weight:
                raise RuntimeError(
                    f'{type(module).__name__} tied to {name!r} was called '
                    f'with a weight other than {name}.weight',
                )
            getattr(self, store).setdefault(name, []).append(
                inputs[0].detach())
        return hook

    def _make_fwd_hook(self, store: str, name: str):
        """Registers a gradient hook on the output that files the
        call's output gradient at the call's own index, so the i-th
        gradient pairs with the i-th activation whatever order backward
        delivers them in (EKFAC pairs rows across the two)."""
        def hook(module, inputs, output):
            if not (self._recording(module) and output.requires_grad):
                return
            grads = getattr(self, store).setdefault(name, [])
            index = len(grads)
            grads.append(None)

            def grad_hook(grad):
                grads[index] = grad.detach()
                self._grads_arrived = True
            output.register_hook(grad_hook)
        return hook

    def take(self) -> dict[str, list[Role]]:
        """Captured ``{name: [(helper, activations, output grads), ...]}``
        (the layer's own calls, then a tied embedding's attend calls),
        cleared.

        Raises if a registered layer or head has activations without
        output gradients (backward was not run) or was not called.
        """
        out = {}
        for name, helper in self.helpers.items():
            roles = [(helper, self._acts, self._grads, name)]
            if name in self.attend:
                head, attend = self.attend[name]
                roles.append(
                    (attend, self._attend_acts, self._attend_grads, head))
            out[name] = []
            for h, acts_by, grads_by, called in roles:
                acts = acts_by.get(name, [])
                grads = [g for g in grads_by.get(name, []) if g is not None]
                if not acts or len(acts) != len(grads):
                    self.clear()
                    raise RuntimeError(
                        f'layer {called!r}: captured {len(acts)} forward '
                        f'call(s) and {len(grads)} output gradient(s) on a '
                        'factor-update step; run forward and backward in '
                        'training mode before step()',
                    )
                out[name].append((h, acts, grads))
        self.clear()
        return out

    def pending(self) -> bool:
        """Whether any capture is held (not yet taken)."""
        return any(
            any(store.values()) for store in (
                self._acts, self._grads, self._attend_acts,
                self._attend_grads,
            )
        )

    def clear(self) -> None:
        self._acts = {}
        self._grads = {}
        self._attend_acts = {}
        self._attend_grads = {}
        self._grads_arrived = False
