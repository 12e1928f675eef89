"""Small test models: port of ``kfac_pytorch_tpu/models/tiny.py``.

``TinyModel``, ``MLP``, ``LeNet`` and ``CoverageLM`` carry the Flax
models' module names, so
:func:`kfac_pytorch_tpu_torch.convert.flax_to_torch_state_dict` maps
their variables one to one.  None has BatchNorm, so a data-parallel
run normalizes nothing per rank and matches the global-batch run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu_torch.layers.coverage import TiedAttend
from kfac_pytorch_tpu_torch.models.layers import Dense
from kfac_pytorch_tpu_torch.models.layers import DenseGeneral
from kfac_pytorch_tpu_torch.models.layers import Embed
from kfac_pytorch_tpu_torch.models.layers import LayerNorm


class TinyModel(nn.Module):
    """Two dense layers, the second without bias; input ``[N, in]``."""

    def __init__(self, in_features: int = 10, hidden: int = 20,
                 out: int = 10) -> None:
        super().__init__()
        self.linear1 = nn.Linear(in_features, hidden)
        self.linear2 = nn.Linear(hidden, out, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.relu(self.linear1(x)))


class MLP(nn.Module):
    """Dense layers ``fc0, fc1, ...`` with ReLU and a ``head``; the input
    is flattened to ``[N, in_features]``."""

    def __init__(self, in_features: int,
                 features: tuple[int, ...] = (64, 64, 10)) -> None:
        super().__init__()
        widths = (in_features, *features)
        for i in range(len(features) - 1):
            self.add_module(f'fc{i}', nn.Linear(widths[i], widths[i + 1]))
        self.head = nn.Linear(widths[-2], widths[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for name, layer in self.named_children():
            x = layer(x) if name == 'head' else F.relu(layer(x))
        return x


class LeNet(nn.Module):
    """LeNet-style CNN; input ``[N, in_channels, H, W]`` with ``H`` and
    ``W`` equal to ``image_size``.

    The feature map is flattened in NHWC order, as the Flax model
    flattens it, so ``fc1``'s input features run ``(h, w, c)`` and its
    bridged weight and A factor need no reordering.
    """

    def __init__(self, num_classes: int = 10, in_channels: int = 1,
                 image_size: int = 28) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 6, 3, padding=1)
        self.conv2 = nn.Conv2d(6, 16, 3, padding=1)
        side = image_size // 4
        self.fc1 = nn.Linear(16 * side * side, 120)
        self.fc2 = nn.Linear(120, 84)
        self.fc3 = nn.Linear(84, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


class CoverageLM(nn.Module):
    """Tiny LM with every full-coverage layer kind at once: a tied
    embedding (the ``wte`` lookup and a
    :class:`~kfac_pytorch_tpu_torch.layers.coverage.TiedAttend` head on
    the sequence mean), LayerNorm pairs, a per-head ``DenseGeneral``
    ``qk`` (``[d, 2, d/2]``) and a Dense ``fc`` over the sequence axis.
    ``layer_types=('linear', 'embedding', 'layernorm', 'dense_general')``
    with ``tied_weights=('wte',)`` covers every parameter.
    ``forward(tokens [B, T]) -> logits [B, vocab]``."""

    def __init__(self, vocab: int = 32, d: int = 16) -> None:
        super().__init__()
        f32 = torch.float32
        self.vocab, self.d = vocab, d
        self.wte = Embed(vocab, d, f32)
        self.ln_in = LayerNorm(d, f32)
        self.qk = DenseGeneral(d, (2, d // 2), compute_dtype=f32)
        self.fc = Dense(d, d, f32)
        self.ln_f = LayerNorm(d, f32)
        self.head = TiedAttend('wte', dtype=f32)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.ln_in(self.wte(tokens))
        x = self.qk(x)
        x = x.reshape(*x.shape[:-2], self.d)
        x = self.ln_f(F.gelu(self.fc(x), approximate='tanh'))
        return self.head(x.mean(dim=1), self.wte.weight)
