"""Shared utilities of the trainers.

Port of ``examples/utils.py``: ``accuracy``, the label-smoothing loss,
the running ``Metric``, the warmup + step-decay learning-rate schedule,
and checkpoint save, find-latest and load, with ``torch.save`` in place
of orbax.  A checkpoint is one file, ``checkpoint_{epoch}``, holding
``{'epoch', 'train_state', 'kfac'}``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F


def setup(device: str | None) -> tuple[torch.device, int, int]:
    """``(device, world, rank)`` of this process.

    A default process group already initialized is used as it is.
    Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) the
    default process group is initialized from the environment, NCCL when
    every rank has a card of its own and gloo otherwise.  Each rank
    takes card ``LOCAL_RANK`` modulo the cards there are.  ``device``
    ``'cpu'`` runs on the CPU (gloo across ranks); ``None`` or
    ``'cuda'`` needs a card and raises without one.
    """
    from kfac_pytorch_tpu_torch.parallel.mesh import default_backend

    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get('WORLD_SIZE', '1')))
    if device == 'cpu':
        dev = torch.device('cpu')
    elif device in (None, 'cuda') or str(device).startswith('cuda'):
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: pass --device cpu to run on the CPU',
            )
        local = int(os.environ.get('LOCAL_RANK', '0'))
        dev = (torch.device(device) if device not in (None, 'cuda')
               else torch.device('cuda', local % torch.cuda.device_count()))
        torch.cuda.set_device(dev)
    else:
        raise ValueError(f"--device must be 'cuda' or 'cpu', got {device!r}")
    if world > 1 and not dist.is_initialized():
        backend = 'gloo' if dev.type == 'cpu' else default_backend(world)
        dist.init_process_group(backend, init_method='env://')
    rank = dist.get_rank() if dist.is_initialized() else 0
    return dev, world, rank


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in [0, 1], a device scalar."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def label_smooth_loss(
    logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.0,
) -> torch.Tensor:
    """Cross entropy with label smoothing; ``smoothing=0`` is plain
    softmax cross entropy.  The smoothed target puts ``1 - smoothing +
    smoothing / n`` on the label and ``smoothing / n`` elsewhere, as the
    JAX function does."""
    n = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    if smoothing <= 0:
        return -logp.gather(-1, labels[..., None]).mean()
    soft = F.one_hot(labels, n).to(logp.dtype) * (1.0 - smoothing)
    soft = soft + smoothing / n
    return -(soft * logp).sum(-1).mean()


class Metric:
    """Running average of a scalar.

    Updates keep their device scalars and are read on :attr:`avg`.
    Under ``torch.distributed`` the read averages over the ranks (one
    all-reduce of the sum and count), so every rank must read it, as
    every rank updates it.
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self._total = 0.0
        self._count = 0.0
        self._pending: list[tuple[Any, float]] = []
        self._avg: float | None = None

    def update(self, value: Any, n: float = 1.0) -> None:
        self._pending.append((value, n))
        self._avg = None

    @property
    def avg(self) -> float:
        if self._avg is None:
            for value, n in self._pending:
                self._total += float(value) * n
                self._count += n
            self._pending.clear()
            total, count = self._total, self._count
            if dist.is_available() and dist.is_initialized():
                t = torch.tensor([total, count], dtype=torch.float64)
                if dist.get_backend() == 'nccl':
                    t = t.cuda()
                dist.all_reduce(t)
                total, count = t.tolist()
            self._avg = total / max(count, 1.0)
        return self._avg


def create_lr_schedule(
    world_size: int,
    warmup_epochs: int,
    decay_schedule: list[int],
    alpha: float = 0.1,
) -> Callable[[int], float]:
    """Epoch -> learning-rate factor: linear warmup from ``1 /
    world_size`` to 1 over ``warmup_epochs``, then ``alpha`` at each
    epoch of ``decay_schedule``."""
    def scale(epoch: float) -> float:
        decayed = alpha ** sum(epoch >= d for d in decay_schedule or ())
        if world_size <= 1 or warmup_epochs <= 0 or epoch >= warmup_epochs:
            return float(decayed)
        return (epoch * (world_size - 1) / warmup_epochs + 1.0) / world_size

    return scale


def save_checkpoint(
    checkpoint_dir: str,
    epoch: int,
    train_state: dict[str, Any],
    kfac_state_dict: dict[str, Any] | None = None,
) -> str:
    """Write ``checkpoint_{epoch}`` under ``checkpoint_dir``: the model,
    optimizer and schedule states in ``train_state`` and the K-FAC
    ``state_dict`` (factors only; a restore recomputes the rest).  The
    file is written under another name and renamed, so an interrupted
    save leaves no torn checkpoint."""
    path = os.path.join(os.path.abspath(checkpoint_dir),
                        f'checkpoint_{epoch}')
    payload: dict[str, Any] = {'epoch': epoch, 'train_state': train_state}
    if kfac_state_dict is not None:
        payload['kfac'] = kfac_state_dict
    torch.save(payload, path + '.tmp')
    os.replace(path + '.tmp', path)
    return path


def find_latest_checkpoint(checkpoint_dir: str) -> tuple[int, str] | None:
    """``(epoch, path)`` of the newest ``checkpoint_{epoch}``, or
    ``None``."""
    if not os.path.isdir(checkpoint_dir):
        return None
    best: tuple[int, str] | None = None
    for entry in os.listdir(checkpoint_dir):
        m = re.fullmatch(r'checkpoint_(\d+)', entry)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), os.path.join(checkpoint_dir, entry))
    return best


def load_checkpoint(path: str) -> dict[str, Any]:
    """A payload written by :func:`save_checkpoint`, on the CPU."""
    return torch.load(path, map_location='cpu', weights_only=True)
