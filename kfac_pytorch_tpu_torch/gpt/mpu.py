"""Model-parallel utilities over ``torch.distributed`` process groups.

Port of ``kfac_pytorch_tpu/gpt/mpu.py`` (itself the counterpart of the
reference's ``kfac/gpt_neox/mpu.py``).  Where the JAX package expresses
the gather and the scatter as sharding changes on a named mesh, the port
moves the shards itself, over the groups of an
:class:`~kfac_pytorch_tpu_torch.parallel.mesh.AxisGroups` grid whose
``names`` are the JAX mesh's axis names (``axis_groups(n_data, n_model,
names=('data', 'model'))``, the order of JAX's ``Mesh(devices.reshape(
n_data, n_model), ('data', 'model'))``).  A grid's coordinates are a
rank's: rank ``k`` sits at ``(k // n_model, k % n_model)``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from kfac_pytorch_tpu_torch.parallel.mesh import AxisGroups
from kfac_pytorch_tpu_torch.parallel.tensor import gather_features
from kfac_pytorch_tpu_torch.parallel.tensor import group_rank_size
from kfac_pytorch_tpu_torch.parallel.tensor import shard_features


def split_tensor_along_dim(
    tensor: torch.Tensor,
    dim: int,
    num_partitions: int,
) -> tuple[torch.Tensor, ...]:
    """Split a tensor into equal parts along ``dim`` (the Megatron helper
    of ``kfac/gpt_neox/mpu.py:96-130``)."""
    size = tensor.shape[dim]
    if size % num_partitions != 0:
        raise ValueError(
            f'dim {dim} (size {size}) not divisible into '
            f'{num_partitions} partitions',
        )
    return tuple(torch.split(tensor, size // num_partitions, dim=dim))


def gather_from_model_parallel_region(
    x: torch.Tensor,
    mesh: AxisGroups,
    axis: str,
    dim: int = -1,
) -> torch.Tensor:
    """The full tensor on every rank of ``axis``'s group, from each
    rank's shard of ``dim`` (JAX reshards to replicated; the reference
    gathers to a primary rank).  A group of one rank returns ``x``."""
    group = mesh.group(axis)
    if group_rank_size(group)[1] == 1:
        return x
    return gather_features(x, group, dim=dim)


def scatter_to_model_parallel_region(
    x: torch.Tensor,
    mesh: AxisGroups,
    axis: str,
    dim: int = -1,
) -> torch.Tensor:
    """This rank's shard of ``dim`` over ``axis``'s group (the inverse
    of :func:`gather_from_model_parallel_region`)."""
    index = mesh.axis_index(axis)
    extent = (mesh.n_outer, mesh.n_inner)[index]
    dim = dim % x.ndim
    if x.shape[dim] % extent != 0:
        raise ValueError(
            f'dim {dim} (size {x.shape[dim]}) not divisible over mesh '
            f'axis {axis!r} (size {extent})',
        )
    coord = (mesh.outer, mesh.inner)[index]
    return shard_features(x, coord, extent, dim=dim).contiguous()


def axis_coords(mesh: AxisGroups, rank: int | None = None) -> dict[str, int]:
    """Grid coordinates of ``rank`` (default this rank) by axis name."""
    rank = mesh.rank if rank is None else rank
    if not 0 <= rank < mesh.n_outer * mesh.n_inner:
        raise ValueError(f'rank {rank} not in mesh')
    return {mesh.names[0]: rank // mesh.n_inner,
            mesh.names[1]: rank % mesh.n_inner}


def axis_peers(
    mesh: AxisGroups,
    axis: str,
    rank: int | None = None,
) -> Sequence[int]:
    """The ranks sharing every coordinate with ``rank`` (default this
    rank) except ``axis`` (the reference's "model-parallel group
    containing rank r"), by their index on ``axis``."""
    mesh.axis_index(axis)
    rank = mesh.rank if rank is None else rank
    axis_coords(mesh, rank)
    return next(r for r in mesh.axis_ranks(axis) if rank in r)

