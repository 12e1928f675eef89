"""K-FAC helpers of the tensor-parallel dense layers.

The JAX package's K-FAC sees a TP layer as the full logical layer
(``kfac_pytorch_tpu/gpt/preconditioner.py:18-25``: GSPMD arrays are
global), and so do these helpers: their factors, combined gradients and
preconditioned gradients are the unsharded layer's, the same on every
rank of the model group.  Each gathers the sharded side over the group
(:func:`~kfac_pytorch_tpu_torch.parallel.tensor.gather_features`):

* column-parallel (``qkv``, ``fc_in``): A from the local input, which is
  whole; G from the output-gradient shards gathered (``qkv``'s columns
  put back in ``q|k|v`` order);
* row-parallel (``proj``, ``fc_out``): A from the input shards gathered,
  then the bias column of ones; G from the local output gradient, which
  is whole.

:meth:`get_grad` gathers the weight-gradient shards into the full
``[out, in + 1]`` (the bias column last); :meth:`set_grad` writes back
the rank's slice.  Every rank of the group must call them for the same
layers in the same order, as the preconditioner does.
"""
from __future__ import annotations

import dataclasses

import torch

from kfac_pytorch_tpu_torch.layers.helpers import DenseHelper
from kfac_pytorch_tpu_torch.ops import cov
from kfac_pytorch_tpu_torch.parallel.tensor import gather_features
from kfac_pytorch_tpu_torch.parallel.tensor import shard_features


@dataclasses.dataclass(frozen=True, eq=False)
class _ParallelDenseHelper(DenseHelper):
    """Shared parts; ``in_features``/``out_features`` are the full
    layer's."""

    @property
    def supports_ekfac(self) -> bool:
        return False

    def _gather(self, x: torch.Tensor, kind: str, parts: int = 1,
                dim: int = -1) -> torch.Tensor:
        return gather_features(x, self.module.group, parts, dim, kind)


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnParallelHelper(_ParallelDenseHelper):
    """:class:`~kfac_pytorch_tpu_torch.parallel.tensor.ColumnParallelDense`."""

    def get_g_factor(self, g: torch.Tensor) -> torch.Tensor:
        return cov.linear_g_factor(
            self._gather(g, 'factor', self.module.parts))

    def get_grad(self) -> torch.Tensor:
        m = self.module
        local = torch.cat([self._weight_grad(), m.bias.grad[:, None]], 1)
        return self._gather(local, 'grad', m.parts, dim=0)

    def set_grad(self, combined: torch.Tensor) -> None:
        m = self.module
        mine = shard_features(combined, m.tp_rank, m.tp, m.parts, dim=0)
        m.weight.grad.copy_(mine[:, :-1])
        m.bias.grad.copy_(mine[:, -1])


@dataclasses.dataclass(frozen=True, eq=False)
class RowParallelHelper(_ParallelDenseHelper):
    """:class:`~kfac_pytorch_tpu_torch.parallel.tensor.RowParallelDense`."""

    def get_a_factor(self, a: torch.Tensor) -> torch.Tensor:
        return cov.linear_a_factor(self._gather(a, 'factor'),
                                   has_bias=self.has_bias)

    def get_grad(self) -> torch.Tensor:
        m = self.module
        w = self._gather(self._weight_grad(), 'grad', dim=1)
        return torch.cat([w, m.bias.grad[:, None]], 1)

    def set_grad(self, combined: torch.Tensor) -> None:
        m = self.module
        m.weight.grad.copy_(
            shard_features(combined[:, :-1], m.tp_rank, m.tp, dim=1))
        m.bias.grad.copy_(combined[:, -1])


def parallel_dense_helper(name: str, module) -> _ParallelDenseHelper:
    """The helper of a parallel dense layer (its ``split``)."""
    cls = (ColumnParallelHelper if module.split == 'column'
           else RowParallelHelper)
    return cls(name=name, module=module, has_bias=True,
               in_features=module.full_in, out_features=module.full_out)
