"""Activation / output-gradient capture through module hooks.

Port of ``kfac_pytorch_tpu/capture.py``.  JAX has no hooks, so the JAX
package captures with interceptors and zero probes; the port returns to
the mechanism of the original torch library:

* **registration** walks ``model.named_modules()`` and builds a helper
  for every ``nn.Linear`` and ``nn.Conv2d`` (``layer_types`` filters
  the kinds, ``skip_layers`` regexes skip by name or class name);
* **capture** uses a forward pre-hook that stores each layer's input
  and a forward hook that puts a tensor hook on the layer's output, so
  the backward pass delivers ``d(loss)/d(output)``.  Both do nothing
  unless the owner has armed the capture (factor-update steps only),
  the module is in training mode and autograd is recording.

A module applied several times in one forward pass yields one capture
per call; the engine averages the factor contributions over calls.
"""
from __future__ import annotations

import re
from typing import Iterable, Sequence

import torch
from torch import nn

from kfac_pytorch_tpu_torch.layers.helpers import ConvHelper
from kfac_pytorch_tpu_torch.layers.helpers import DenseHelper
from kfac_pytorch_tpu_torch.layers.helpers import LayerHelper

KNOWN_MODULES = frozenset({'linear', 'conv2d'})
DEFAULT_LAYER_TYPES = KNOWN_MODULES


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
    return None


def _conv_padding(module: nn.Conv2d) -> tuple[int, int] | None:
    pad = module.padding
    if isinstance(pad, str):
        return (0, 0) if pad == 'valid' else None
    return (int(pad[0]), int(pad[1]))


class ModelCapture:
    """Hooked access to a model's K-FAC layers.

    Attributes:
        helpers: layer name -> helper, in registration order.
        skipped: names matched by ``skip_layers``.
        rejected: layer name -> reason it cannot be preconditioned.
        armed: capture switch; the hooks record only while it is True.
    """

    def __init__(
        self,
        model: nn.Module,
        skip_layers: Sequence[str] = (),
        layer_types: Iterable[str] = DEFAULT_LAYER_TYPES,
    ) -> None:
        layer_types = frozenset(layer_types)
        unknown = layer_types - KNOWN_MODULES
        if unknown:
            raise NotImplementedError(
                f'layer_types {sorted(unknown)} are not ported yet; this '
                "port registers 'linear' and 'conv2d' (ROADMAP.md Queue A "
                'items 11-12: embeddings and full-coverage layers)',
            )
        self.model = model
        self.skip_layers = tuple(skip_layers)
        self.layer_types = layer_types
        self.helpers: dict[str, LayerHelper] = {}
        self.skipped: list[str] = []
        self.rejected: dict[str, str] = {}
        self.armed = False
        self._acts: dict[str, list[torch.Tensor]] = {}
        self._grads: dict[str, list[torch.Tensor]] = {}
        self._register()

    def _register(self) -> None:
        for name, module in self.model.named_modules():
            kind = _module_kind(module)
            if kind is None or kind not in self.layer_types:
                continue
            if self.skip_layers and any_match(
                (name, type(module).__name__), self.skip_layers,
            ):
                self.skipped.append(name)
                continue
            helper, reason = self._make_helper(kind, name, module)
            if helper is None:
                self.rejected[name] = reason
                continue
            self.helpers[name] = helper
            module.register_forward_pre_hook(self._make_pre_hook(name))
            module.register_forward_hook(self._make_fwd_hook(name))

    @staticmethod
    def _make_helper(
        kind: str, name: str, module: nn.Module,
    ) -> tuple[LayerHelper | None, str | None]:
        has_bias = module.bias is not None
        if kind == 'linear':
            return DenseHelper(
                name=name, module=module, has_bias=has_bias,
                in_features=module.in_features,
                out_features=module.out_features,
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
            name=name, module=module, has_bias=has_bias,
            in_features=module.in_channels,
            out_features=module.out_channels,
            kernel_size=tuple(module.kernel_size),
            strides=tuple(module.stride),
            padding=padding,
        ), None

    def _recording(self, module: nn.Module) -> bool:
        return self.armed and module.training and torch.is_grad_enabled()

    def _make_pre_hook(self, name: str):
        def hook(module, inputs):
            if self._recording(module):
                self._acts.setdefault(name, []).append(inputs[0].detach())
        return hook

    def _make_fwd_hook(self, name: str):
        def grad_hook(grad):
            self._grads.setdefault(name, []).append(grad.detach())

        def hook(module, inputs, output):
            if self._recording(module) and output.requires_grad:
                output.register_hook(grad_hook)
        return hook

    def take(self) -> dict[str, tuple[list, list]]:
        """Captured ``{name: (activations, output grads)}``, cleared.

        Raises if a registered layer has activations without output
        gradients (backward was not run) or was not called at all.
        """
        out = {}
        for name in self.helpers:
            acts = self._acts.get(name, [])
            grads = self._grads.get(name, [])
            if not acts or len(acts) != len(grads):
                self.clear()
                raise RuntimeError(
                    f'layer {name!r}: captured {len(acts)} forward call(s) '
                    f'and {len(grads)} output gradient(s) on a factor-'
                    'update step; run forward and backward in training '
                    'mode before step()',
                )
            out[name] = (acts, grads)
        self.clear()
        return out

    def clear(self) -> None:
        self._acts = {}
        self._grads = {}
