"""Weight bridge: the JAX package's Flax variables -> a torch state dict.

Takes the variables as nested mappings of array-likes (numpy arrays —
convert JAX arrays with ``np.asarray`` first) and returns a
``state_dict`` for the port's model of the same architecture, whose
modules carry the Flax module names:

* Dense ``kernel [in, out]`` -> ``weight [out, in]``;
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* BatchNorm ``scale/bias`` (``params``) and ``mean/var``
  (``batch_stats``) -> ``weight/bias/running_mean/running_var``, with
  ``num_batches_tracked`` set to 0.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _walk(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    """Yield ``(module path, leaf dict)`` for every dict holding arrays."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield prefix, leaves
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def flax_to_torch_state_dict(
    variables: Mapping[str, Any],
) -> dict[str, torch.Tensor]:
    """Convert ``{'params': ..., 'batch_stats': ...}`` to a state dict."""
    out: dict[str, torch.Tensor] = {}
    for path, leaves in _walk(variables.get('params', {})):
        name = '.'.join(path)
        if 'scale' in leaves:  # BatchNorm affine pair
            out[f'{name}.weight'] = _t(leaves['scale'])
            out[f'{name}.bias'] = _t(leaves['bias'])
            continue
        kernel = np.asarray(leaves['kernel'])
        if kernel.ndim == 4:
            out[f'{name}.weight'] = _t(kernel.transpose(3, 2, 0, 1))
        elif kernel.ndim == 2:
            out[f'{name}.weight'] = _t(kernel.T)
        else:
            raise ValueError(
                f'{name}: kernel of rank {kernel.ndim} has no torch '
                'counterpart here (Dense is rank 2, Conv2d rank 4)',
            )
        if 'bias' in leaves:
            out[f'{name}.bias'] = _t(leaves['bias'])
    for path, leaves in _walk(variables.get('batch_stats', {})):
        name = '.'.join(path)
        out[f'{name}.running_mean'] = _t(leaves['mean'])
        out[f'{name}.running_var'] = _t(leaves['var'])
        out[f'{name}.num_batches_tracked'] = torch.tensor(0)
    return out
