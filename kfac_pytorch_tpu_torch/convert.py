"""Bridges from the JAX package: Flax variables -> a torch state dict,
and a K-FAC checkpoint -> the port's ``load_state_dict`` payload.

Takes the variables as nested mappings of array-likes (numpy arrays —
convert JAX arrays with ``np.asarray`` first) and returns a
``state_dict`` for the port's model of the same architecture, whose
modules carry the Flax module names:

* Dense ``kernel [in, out]`` -> ``weight [out, in]``;
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* BatchNorm and LayerNorm ``scale/bias`` (``params``) and ``mean/var``
  (``batch_stats``) -> ``weight/bias/running_mean/running_var``, with
  ``num_batches_tracked`` set to 0;
* Embed ``embedding [V, D]`` -> ``weight [V, D]``;
* a bare parameter (the GPT's positional table ``wpe``) -> itself.

So a JAX ResNet-50's ``params`` and ``batch_stats`` load strictly into
the port's ``resnet50``, and a JAX GPT's into ``gpt_125m``.

:func:`jax_kfac_state_dict_to_torch` carries a JAX
``KFACPreconditioner.state_dict(...)`` across, so a JAX run resumes in
the port; an embedding's ``[V]`` diagonal A factor goes across as it
is.
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
        if 'scale' in leaves:  # BatchNorm / LayerNorm affine pair
            out[f'{name}.weight'] = _t(leaves['scale'])
            out[f'{name}.bias'] = _t(leaves['bias'])
            continue
        if 'embedding' in leaves:
            out[f'{name}.weight'] = _t(leaves['embedding'])
            continue
        if 'kernel' not in leaves:  # bare parameters of a module
            for key, value in leaves.items():
                out['.'.join(path + (key,))] = _t(value)
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


def jax_kfac_state_dict_to_torch(sd: Mapping[str, Any]) -> dict[str, Any]:
    """A JAX ``KFACPreconditioner.state_dict(...)`` as the port's
    ``load_state_dict`` payload: layer names go from ``/`` to ``.``,
    numpy arrays become tensors (triu dicts keep their form), and the
    counters and hyperparameters pass through."""
    def tensor(x: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(x, copy=True))

    def factor(x: Any) -> Any:
        if isinstance(x, Mapping) and 'triu' in x:
            return {'triu': tensor(x['triu']), 'dim': int(x['dim'])}
        return tensor(x)

    out = {k: v for k, v in sd.items() if k != 'layers'}
    if 'layers' in sd:
        out['layers'] = {
            name.replace('/', '.'): {k: factor(v) for k, v in f.items()}
            for name, f in sd['layers'].items()
        }
    return out
