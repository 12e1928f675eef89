"""Full-coverage transformer helpers: KFAC-expand / KFAC-reduce,
LayerNorm scale+bias and tied embeddings.

Port of ``kfac_pytorch_tpu/layers/coverage.py`` (arXiv:2311.00636).
Square factors enter the bucket stacks like any dense layer's; the tied
embedding's diagonal A takes the embedding side path.  The
``DenseGeneral`` helpers serve the multi-head attention projections of
:class:`~kfac_pytorch_tpu_torch.models.layers.MultiHeadDotProductAttention`,
whose kernels keep Flax's multi-axis layout.

A tied LM head computes ``x @ wte.weight^T`` with no module of its own
in PyTorch, so the capture cannot hook it.  :class:`TiedAttend` is that
module: parameter-free, it takes the activations and the shared weight,
and names the embedding it is tied to, so the capture can register the
call as the tied group's attend application.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from kfac_pytorch_tpu_torch.layers.helpers import DenseHelper
from kfac_pytorch_tpu_torch.layers.helpers import EmbedHelper
from kfac_pytorch_tpu_torch.layers.helpers import LayerHelper
from kfac_pytorch_tpu_torch.ops import cov


class TiedAttend(nn.Module):
    """``x @ weight^T`` of a tied LM head, in ``dtype``.

    Args:
        tied_to: the name (``model.named_modules()``) of the
            ``nn.Embedding`` whose weight the head shares; the capture
            registers the call under that layer when ``tied_weights``
            declares it.
        dtype: compute dtype: ``x`` and the weight are cast to it, as
            Flax's ``Embed.attend`` casts both to the module's dtype.
    """

    def __init__(self, tied_to: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tied_to = tied_to
        self.dtype = dtype

    def forward(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), weight.to(self.dtype))

    def extra_repr(self) -> str:
        return f'tied_to={self.tied_to!r}, dtype={self.dtype}'


@dataclasses.dataclass(frozen=True, eq=False)
class KfacExpandHelper(DenseHelper):
    """KFAC-expand for a weight-shared linear application: every shared
    application is an independent example, which is the dense layer's
    own flattening, so this adds no behavior.  Registration gives it to
    a layer a ``kfac_approx`` mapping selects ``'expand'`` for, so the
    choice shows in the registration log."""


@dataclasses.dataclass(frozen=True, eq=False)
class KfacReduceHelper(DenseHelper):
    """KFAC-reduce for a weight-shared linear application: activations
    and output gradients are summed over the shared axes before the
    outer product (arXiv:2311.00636 §3.2)."""

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        return cov.cov_from_rows(*self.get_a_rows(a))

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return cov.cov_from_rows(*self.get_g_rows(g))

    def get_a_rows(self, a: torch.Tensor) -> tuple[torch.Tensor, float]:
        return cov.linear_reduce_a_rows(a, has_bias=self.has_bias)

    def get_g_rows(self, g: torch.Tensor) -> tuple[torch.Tensor, float]:
        return cov.linear_reduce_g_rows(g)


@dataclasses.dataclass(frozen=True, eq=False)
class ScaleBiasHelper(LayerHelper):
    """``nn.LayerNorm``'s elementwise affine pair as a tiny Kronecker
    linear layer: one ``R^2 -> R^1`` map per feature, so rows ``(x̂, 1)``
    give a ``[2, 2]`` A factor and the output gradients the usual
    ``[D, D]`` G factor.  ``x̂`` is recomputed from the captured input
    with the module's ``epsilon``.  The combined gradient is ``[D, 2]``,
    scale column first (the base class's weight-then-bias layout).
    """

    epsilon: float = 1e-6

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        return cov.scale_bias_a_factor(a, self.epsilon)

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return cov.linear_g_factor(g)


@dataclasses.dataclass(frozen=True, eq=False)
class TiedEmbedHelper(EmbedHelper):
    """Lookup side of a tied embedding: the embedding's factor math; the
    tied group holds one factor set, fed by the lookup and by the attend
    call (:class:`TiedAttendHelper`)."""


@dataclasses.dataclass(frozen=True, eq=False)
class TiedAttendHelper(EmbedHelper):
    """Attend side of a tied embedding (``logits = x @ E^T``): in the
    lookup layout the Kronecker roles swap, so A (the ``[V]`` diagonal)
    comes from the attend's output gradients and G (``[D, D]``) from its
    inputs.  The gradient layout stays the lookup's: autograd already
    sums the shared weight's gradient over both uses."""

    @property
    def swap_capture(self) -> bool:
        return True

    def get_a_factor(self, cots: torch.Tensor) -> torch.Tensor:
        return cov.attend_a_diag(cots, self.in_features)

    def get_g_factor(self, x: torch.Tensor) -> torch.Tensor:
        return cov.attend_g_factor(x)


@dataclasses.dataclass(frozen=True, eq=False)
class DenseGeneralHelper(DenseHelper):
    """:class:`~kfac_pytorch_tpu_torch.models.layers.DenseGeneral` with
    trailing contraction axes.

    The projection type inside multi-head attention: q/k/v kernels are
    ``[D, heads, head_dim]`` (out axes split per head), the out
    projection ``[heads, head_dim, D]`` (in axes split).  Factor math is
    the Dense expand math over the flattened in/out dims; only the
    kernel (un)flattening differs: ``kernel_in_ndim``/``kernel_out_ndim``
    record the split so ``get_grad``/``set_grad`` round-trip the kernel
    exactly.
    """

    kernel_in_ndim: int = 1
    kernel_out_ndim: int = 1

    def _flatten_in(self, a: torch.Tensor) -> torch.Tensor:
        """Collapse the trailing contraction axes to ``in_features``."""
        return a.reshape(*a.shape[:a.dim() - self.kernel_in_ndim],
                         self.in_features)

    def _flatten_out(self, g: torch.Tensor) -> torch.Tensor:
        """Collapse the trailing feature axes to ``out_features``."""
        return g.reshape(*g.shape[:g.dim() - self.kernel_out_ndim],
                         self.out_features)

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        return super().get_a_factor(self._flatten_in(a))

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return super().get_g_factor(self._flatten_out(g))

    def get_a_rows(self, a: torch.Tensor) -> tuple[torch.Tensor, float]:
        return super().get_a_rows(self._flatten_in(a))

    def get_g_rows(self, g: torch.Tensor) -> tuple[torch.Tensor, float]:
        return super().get_g_rows(self._flatten_out(g))

    def _weight_grad(self) -> torch.Tensor:
        k = self.module.kernel.grad
        if k is None:
            raise RuntimeError(
                f'layer {self.name!r} has no gradient: call backward() '
                'before step()',
            )
        return k

    def get_grad(self) -> torch.Tensor:
        g = self._weight_grad().reshape(self.in_features,
                                        self.out_features).T
        if self.has_bias:
            g = torch.cat([g, self.module.bias.grad.reshape(-1, 1)], dim=1)
        return g

    def set_grad(self, combined: torch.Tensor) -> None:
        k = self.module.kernel
        w = combined[:, :-1] if self.has_bias else combined
        k.grad.copy_(w.T.reshape(k.shape))
        if self.has_bias:
            b = self.module.bias
            b.grad.copy_(combined[:, -1].reshape(b.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class DenseGeneralReduceHelper(DenseGeneralHelper):
    """KFAC-reduce variant of :class:`DenseGeneralHelper`."""

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        return cov.cov_from_rows(*self.get_a_rows(a))

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return cov.cov_from_rows(*self.get_g_rows(g))

    def get_a_rows(self, a: torch.Tensor) -> tuple[torch.Tensor, float]:
        return cov.linear_reduce_a_rows(
            self._flatten_in(a), has_bias=self.has_bias,
        )

    def get_g_rows(self, g: torch.Tensor) -> tuple[torch.Tensor, float]:
        return cov.linear_reduce_g_rows(self._flatten_out(g))
