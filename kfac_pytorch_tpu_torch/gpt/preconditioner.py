"""K-FAC for tensor-parallel transformer LMs on a ``('data', 'model')``
grid.

Port of ``kfac_pytorch_tpu/gpt/preconditioner.py``
(``GPTKFACPreconditioner``, the counterpart of the reference's
``GPTNeoXKFACPreconditioner``).  The JAX class's policy carries over:

* eigen method only;
* MEM-OPT by default, over the data extent only: ``data_axes`` names the
  grid axes whose ranks form the K-FAC world (layer placement and factor
  averaging), and each index of the other axis has a KAISA grid of its
  own (:func:`~kfac_pytorch_tpu_torch.parallel.mesh.kaisa_grid` with a
  data group), so the second-order state is replicated across the model
  peers, as JAX's docstring says;
* ``compute_eigenvalue_outer_product=False`` by default (no ``dgda``, so
  the fused kernel does not run; with ``True`` it runs on the full
  gathered gradients);
* per-layer factor files (:meth:`save_factors`, :meth:`load_factors`),
  one ``<layer>.npz`` of ``A``, ``G`` and ``steps`` each, which both
  packages read.

What GSPMD gives the JAX class, the model and the helpers do here: the
model's tensor-parallel layers (``GPT(..., tp_group=...)``) register
through :mod:`~kfac_pytorch_tpu_torch.layers.tensor`, whose factors and
gradients are the full layers'.  The kl-clip sum needs no collective:
every rank holds every layer's full preconditioned gradient after the
grid's row gather, so the model peers never add into each other's sums.

The call sequence is :class:`~kfac_pytorch_tpu_torch.KFACPreconditioner`'s
(the caller runs the forward and backward; JAX's ``loss_fn`` has no
counterpart).  Wrap the model in ``DistributedDataParallel`` over the
data group (``process_group=mesh.group('data')``), whose ranks must take
local batches of the same size::

    mesh = axis_groups(2, 2, names=('data', 'model'))
    model = gpt_125m(tp_group=mesh.group('model'))
    ddp = DistributedDataParallel(model, process_group=mesh.group('data'))
    precond = GPTKFACPreconditioner(ddp, mesh=mesh)
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from kfac_pytorch_tpu_torch.enums import ComputeMethod
from kfac_pytorch_tpu_torch.enums import DistributedStrategy
from kfac_pytorch_tpu_torch.parallel.mesh import data_world
from kfac_pytorch_tpu_torch.parallel.mesh import kaisa_grid
from kfac_pytorch_tpu_torch.preconditioner import KFACPreconditioner

logger = logging.getLogger(__name__)


class GPTKFACPreconditioner(KFACPreconditioner):
    """K-FAC for tensor-parallel transformer LMs over a named grid.

    Args:
        model: the model (e.g. :func:`~kfac_pytorch_tpu_torch.models.\
gpt_125m` with ``tp_group``), or its ``DistributedDataParallel``
            wrapper over the data group.
        mesh: the :class:`~kfac_pytorch_tpu_torch.parallel.mesh.\
AxisGroups` of the training grid (``names`` must contain
            ``data_axes``); ``None``: the default process group is the
            data world.
        data_axes: the axes whose ranks form the K-FAC world; the other
            axis is model-parallel (state replicated across it).
        grad_worker_fraction: the KAISA knob over the data extent,
            MEM-OPT by default as in the reference.
        skip_layers: regexes of layer or class names to leave out.
        factor_checkpoint_dir: directory of the per-layer factor files.

    The other keywords are :class:`~kfac_pytorch_tpu_torch.\
KFACPreconditioner`'s, with the JAX class's defaults.
    """

    def __init__(
        self,
        model: nn.Module,
        *,
        mesh: Any = None,
        data_axes: tuple[str, ...] = ('data',),
        factor_update_steps: Callable[[int], int] | int = 10,
        inv_update_steps: Callable[[int], int] | int = 100,
        damping: Callable[[int], float] | float = 0.001,
        factor_decay: Callable[[int], float] | float = 0.95,
        kl_clip: Callable[[int], float] | float | None = 0.001,
        lr: Callable[[int], float] | float = 0.1,
        accumulation_steps: int = 1,
        compute_method: ComputeMethod | str = ComputeMethod.EIGEN,
        compute_eigenvalue_outer_product: bool = False,
        grad_worker_fraction: (
            DistributedStrategy | float
        ) = DistributedStrategy.MEM_OPT,
        factor_dtype: torch.dtype = torch.float32,
        inv_dtype: torch.dtype = torch.float32,
        precond_dtype: torch.dtype | None = None,
        skip_layers: Sequence[str] = (),
        factor_checkpoint_dir: str | None = None,
        lowrank_rank: int | None = None,
        lowrank_oversample: int = 32,
        lowrank_power_iters: int = 2,
        ekfac: bool = False,
        adaptive_refresh: Any = None,
        loglevel: int = logging.DEBUG,
    ) -> None:
        if isinstance(compute_method, str):
            compute_method = ComputeMethod[compute_method.upper()]
        if compute_method != ComputeMethod.EIGEN:
            raise ValueError(
                'GPTKFACPreconditioner only supports the eigen compute '
                'method',
            )
        self._data_ranks = self._data_group = None
        if mesh is not None:
            for axis in data_axes:
                if axis not in mesh.names:
                    raise ValueError(
                        f'data axis {axis!r} not in mesh axes {mesh.names}',
                    )
            if len(set(data_axes)) == 1:
                self._data_ranks = mesh.axis_ranks(data_axes[0])
                self._data_group = mesh.group(data_axes[0])
        self.factor_checkpoint_dir = factor_checkpoint_dir
        super().__init__(
            model,
            factor_update_steps=factor_update_steps,
            inv_update_steps=inv_update_steps,
            damping=damping,
            factor_decay=factor_decay,
            kl_clip=kl_clip,
            lr=lr,
            accumulation_steps=accumulation_steps,
            compute_method=compute_method,
            compute_eigenvalue_outer_product=compute_eigenvalue_outer_product,
            grad_worker_fraction=grad_worker_fraction,
            bucketed=True,
            factor_dtype=factor_dtype,
            inv_dtype=inv_dtype,
            precond_dtype=precond_dtype,
            skip_layers=skip_layers,
            lowrank_rank=lowrank_rank,
            lowrank_oversample=lowrank_oversample,
            lowrank_power_iters=lowrank_power_iters,
            ekfac=ekfac,
            adaptive_refresh=adaptive_refresh,
            loglevel=loglevel,
        )

    def _data_world(self) -> int:
        if self._data_ranks is None:
            return data_world()
        return len(self._data_ranks[0])

    def _make_grid(self, grad_worker_fraction: float):
        return kaisa_grid(grad_worker_fraction, self._data_ranks,
                          self._data_group)

    # -- per-layer factor files ------------------------------------------

    def save_factors(self, step: int | None = None) -> str:
        """Write one ``<layer>.npz`` (``A``, ``G`` and ``steps``) per
        layer under ``factor_checkpoint_dir`` (or its ``step_<step>``),
        and return the directory.  Every rank holds the full factors, so
        in a multi-rank run one rank should call it."""
        if self.factor_checkpoint_dir is None:
            raise RuntimeError('factor_checkpoint_dir was not set')
        subdir = self.factor_checkpoint_dir
        if step is not None:
            subdir = os.path.join(subdir, f'step_{step}')
        os.makedirs(subdir, exist_ok=True)
        for name, st in self.layers.items():
            np.savez(
                os.path.join(subdir, name.replace('/', '.') + '.npz'),
                A=st.a_factor.detach().cpu().numpy(),
                G=st.g_factor.detach().cpu().numpy(),
                steps=np.asarray(self._steps),
            )
        return subdir

    def load_factors(self, directory: str | None = None,
                     compute_inverses: bool = True) -> None:
        """Load the per-layer factor files; a missing file only warns.

        When any file was found, the step counter takes its ``steps``,
        the factors count as initialized, and a layer whose file was
        missing and whose factors are still zero is seeded with the
        identity (the first factor update's seed), since a damped
        inverse of a zero factor would blow the gradient up by about
        ``1 / damping``.  With ``compute_inverses`` the second-order
        state is then recomputed (collective across ranks: every rank
        calls this).
        """
        directory = directory or self.factor_checkpoint_dir
        if directory is None:
            raise RuntimeError('factor_checkpoint_dir was not set')
        found_steps = None
        missing = []
        for name, st in self.layers.items():
            fname = os.path.join(directory, name.replace('/', '.') + '.npz')
            if not os.path.exists(fname):
                logger.warning('No factor checkpoint found for layer %s at %s',
                               name, fname)
                missing.append(name)
                continue
            with np.load(fname) as data:
                st.a_factor = torch.as_tensor(
                    data['A'], dtype=self.factor_dtype, device=self.device)
                st.g_factor = torch.as_tensor(
                    data['G'], dtype=self.factor_dtype, device=self.device)
                found_steps = int(data['steps'])
        if found_steps is None:
            return
        self._steps = found_steps
        self._factors_initialized = True
        for name in missing:
            st = self.layers[name]
            if not bool(torch.any(st.a_factor)):
                st.a_factor = _identity_like(st.a_factor)
                st.g_factor = _identity_like(st.g_factor)
        if compute_inverses:
            self._refresh(self.damping)
        self._arm_capture(self._step_gating()[0])


def _identity_like(f: torch.Tensor) -> torch.Tensor:
    """The identity seed of a factor: ``I`` for ``[n, n]``, ones for a
    diagonal ``[n]``."""
    if f.ndim == 1:
        return torch.ones_like(f)
    return torch.eye(f.shape[0], dtype=f.dtype, device=f.device)
