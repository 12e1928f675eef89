"""Bridges from the JAX package: Flax variables -> a torch state dict,
and a K-FAC checkpoint -> the port's ``load_state_dict`` payload.

Takes the variables as nested mappings of array-likes (numpy arrays —
convert JAX arrays with ``np.asarray`` first) and returns a
``state_dict`` for the port's model of the same architecture, whose
modules carry the Flax module names:

* Dense ``kernel [in, out]`` -> ``weight [out, in]``;
* a rank-3 DenseGeneral ``kernel`` (the multi-head attention
  projections: ``[D, heads, head_dim]``, ``[heads, head_dim, D]``) ->
  ``kernel``, unchanged;
* Conv ``kernel`` HWIO -> ``weight`` OIHW (the ViT's patchify stem);
* BatchNorm and LayerNorm ``scale/bias`` (``params``) and ``mean/var``
  (``batch_stats``) -> ``weight/bias/running_mean/running_var``, with
  ``num_batches_tracked`` set to 0;
* Embed ``embedding [V, D]`` -> ``weight [V, D]``;
* a bare parameter (the positional tables ``wpe`` and ``pos_embed``,
  the ViT's ``cls``, the MoE experts' ``[E, D, F]`` ``w_in``/``b_in``/
  ``w_out``/``b_out``) -> itself.

So a JAX ResNet-50's ``params`` and ``batch_stats`` load strictly into
the port's ``resnet50``, a JAX GPT's into ``gpt_125m``, a ViT's into
``vit_b16``, a BERT's into ``bert_large`` and a MoE model's into the
port's of the same layout; :func:`shard_experts` cuts it to a rank's
experts, and :func:`pipeline_lm_state_dict` turns a JAX ``PipelineLM``'s
``[S, ...]`` stage stacks into a rank's stage (or every stage).
:func:`flax_to_tp_state_dict` turns a JAX GPT's full ``params`` into one
model rank's state dict of the tensor-parallel ``GPT(...,
tp_group=...)`` (``qkv`` split by heads, ``fc_in`` by rows, ``proj`` and
``fc_out`` by columns; :func:`flax_to_torch_state_dict` stays the
unsharded path).  :func:`flax_to_torch_names` gives the name map, for
comparing reports that name parameters.

:func:`jax_kfac_state_dict_to_torch` carries a JAX
``KFACPreconditioner.state_dict(...)`` across, so a JAX run resumes in
the port; an embedding's ``[V]`` diagonal A factor goes across as it
is, and the MoE and pipeline flavours' whole ``[E, ...]``/``[S, ...]``
stacks too (a rank's ``load_state_dict`` takes its experts or its
stage).  :func:`jax_generation_to_torch` does the same for a JAX streaming
checkpoint generation (:mod:`kfac_pytorch_tpu_torch.elastic`).
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

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


def _convert(variables: Mapping[str, Any]):
    """Yield ``(Flax leaf path, torch name, tensor)`` for every leaf."""
    for path, leaves in _walk(variables.get('params', {})):
        name = '.'.join(path)

        def leaf(key, torch_key, value):
            return '/'.join(path + (key,)), f'{name}.{torch_key}', value

        if 'scale' in leaves:  # BatchNorm / LayerNorm affine pair
            yield leaf('scale', 'weight', _t(leaves['scale']))
            yield leaf('bias', 'bias', _t(leaves['bias']))
            continue
        if 'embedding' in leaves:
            yield leaf('embedding', 'weight', _t(leaves['embedding']))
            continue
        if 'kernel' not in leaves:  # bare parameters of a module
            for key, value in leaves.items():
                yield '/'.join(path + (key,)), '.'.join(path + (key,)), \
                    _t(value)
            continue
        kernel = np.asarray(leaves['kernel'])
        if kernel.ndim == 3:
            yield leaf('kernel', 'kernel', _t(kernel))
        elif kernel.ndim == 4:
            yield leaf('kernel', 'weight', _t(kernel.transpose(3, 2, 0, 1)))
        elif kernel.ndim == 2:
            yield leaf('kernel', 'weight', _t(kernel.T))
        else:
            raise ValueError(
                f'{name}: kernel of rank {kernel.ndim} has no torch '
                'counterpart here (Dense is rank 2, a multi-head '
                'DenseGeneral rank 3, Conv2d rank 4)',
            )
        if 'bias' in leaves:
            yield leaf('bias', 'bias', _t(leaves['bias']))
    for path, leaves in _walk(variables.get('batch_stats', {})):
        name = '.'.join(path)
        for key, torch_key in (('mean', 'running_mean'),
                               ('var', 'running_var')):
            yield ('/'.join(('batch_stats',) + path + (key,)),
                   f'{name}.{torch_key}', _t(leaves[key]))
        yield None, f'{name}.num_batches_tracked', torch.tensor(0)


def flax_to_torch_state_dict(
    variables: Mapping[str, Any],
) -> dict[str, torch.Tensor]:
    """Convert ``{'params': ..., 'batch_stats': ...}`` to a state dict."""
    return {name: t for _, name, t in _convert(variables)}


def flax_to_torch_names(variables: Mapping[str, Any]) -> dict[str, str]:
    """The bridge's name map: each ``'/'``-joined Flax parameter path
    (``block_0/ln_attn/scale``; ``batch_stats/...`` for the statistics)
    -> the port's parameter or buffer name (``block_0.ln_attn.weight``).
    """
    return {path: name for path, name, _ in _convert(variables)
            if path is not None}


def shard_experts(
    state_dict: Mapping[str, torch.Tensor], n_experts: int,
    expert_group_size: int, index: int,
) -> dict[str, torch.Tensor]:
    """A full model's state dict with every expert parameter (``w_in``,
    ``b_in``, ``w_out``, ``b_out`` of ``n_experts`` rows) cut to the
    rows that rank ``index`` of an expert group of ``expert_group_size``
    holds."""
    per = n_experts // expert_group_size
    names = {'w_in', 'b_in', 'w_out', 'b_out'}
    return {
        k: (v[index * per:(index + 1) * per]
            if k.rsplit('.', 1)[-1] in names and v.shape[0] == n_experts
            else v)
        for k, v in state_dict.items()
    }


def flax_to_tp_state_dict(
    variables: Mapping[str, Any], rank: int, tp: int,
) -> dict[str, torch.Tensor]:
    """A JAX GPT's ``{'params': ...}`` as the state dict of rank
    ``rank`` of a ``tp``-way tensor-parallel port GPT
    (:func:`~kfac_pytorch_tpu_torch.models.gpt.shard_state_dict`)."""
    from kfac_pytorch_tpu_torch.models.gpt import shard_state_dict

    return shard_state_dict(flax_to_torch_state_dict(variables), rank, tp)


def flax_bert_to_tp_state_dict(
    variables: Mapping[str, Any], rank: int, tp: int,
) -> dict[str, torch.Tensor]:
    """A JAX ``BertForQA``'s ``{'params': ...}`` as the state dict of
    rank ``rank`` of a ``tp``-way tensor-parallel port ``BertForQA``
    (:func:`~kfac_pytorch_tpu_torch.models.bert.shard_state_dict`:
    ``qkv``'s q, k and v blocks each cut to the rank's heads, so every
    shard keeps the ``q|k|v`` order)."""
    from kfac_pytorch_tpu_torch.models.bert import shard_state_dict

    return shard_state_dict(flax_to_torch_state_dict(variables), rank, tp)


def _map_leaves(fn, tree: Mapping[str, Any]) -> dict[str, Any]:
    return {k: _map_leaves(fn, v) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def _leaves(tree: Mapping[str, Any]):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, Mapping) else (v,)


def pipeline_lm_state_dict(
    params: Mapping[str, Any], stages: Sequence[int] | None = None,
) -> dict[str, torch.Tensor]:
    """A JAX ``PipelineLM``'s params (``{'embed', 'stages', 'head'}``,
    each stage leaf ``[S, ...]``) as the state dict of the port's
    :class:`~kfac_pytorch_tpu_torch.models.pipeline.PipelineLM` holding
    ``stages`` (default every stage): stage ``s``'s blocks from the
    ``[s]`` slices under ``stages.<s>.``, ``embed`` and ``head`` as they
    are."""
    emb, head = params['embed'], params['head']
    out = {'embed.wte': _t(emb['wte']), 'embed.wpe': _t(emb['wpe']),
           'head.scale': _t(head['scale']), 'head.bias': _t(head['bias'])}
    n = np.shape(next(_leaves(params['stages'])))[0]
    for s in range(n) if stages is None else stages:
        stage = _map_leaves(lambda a, s=s: np.asarray(a)[s], params['stages'])
        for _, name, t in _convert({'params': stage}):
            out[f'stages.{s}.{name}'] = t
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


def jax_generation_to_torch(src: str, dst: str) -> str:
    """A JAX streaming generation (``kfac_pytorch_tpu.elastic.\
save_streaming``'s ``gen-<step>/``) rewritten for the port, as
    ``dst/<the generation's name>``; returns that path.

    Layer names go from ``/`` to ``.`` in ``layers.npz`` and in
    ``meta.json``'s layout signature, and the manifest's bytes and CRC32s
    of the two rewritten files are recomputed; the bucket shards, the
    health counters and the caller's extras are copied as they are (the
    formats are the same).  The source is verified against its own
    manifest first, so a torn or corrupt generation raises here
    (naming the artifact) instead of coming out valid.  The port then
    restores ``dst`` through :func:`kfac_pytorch_tpu_torch.elastic.\
restore_streaming`, at any world size.
    """
    import io
    import json
    import os
    import shutil
    import zlib

    from kfac_pytorch_tpu_torch import elastic

    src = os.path.abspath(src)
    manifest = elastic._verify_generation(src)
    out = os.path.join(os.path.abspath(dst), os.path.basename(src))
    tmp = f'{out}.tmp-{os.getpid()}'
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shards = {}
    for name in manifest['shards']:
        path, target = os.path.join(src, name), os.path.join(tmp, name)
        if name == 'layers.npz':
            with np.load(path) as npz:
                arrays = {k.replace('/', '.'): npz[k] for k in npz.files}
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            data = buf.getvalue()
        elif name == elastic.META_NAME:
            with open(path) as fh:
                meta = json.load(fh)
            sig = (meta.get('topology') or {}).get('signature')
            for bucket in (sig or {}).get('buckets', ()):
                bucket['slots'] = [None if n is None else n.replace('/', '.')
                                   for n in bucket['slots']]
            data = json.dumps(meta, indent=1, sort_keys=True).encode()
        else:
            with open(path, 'rb') as fh:
                data = fh.read()
        with open(target, 'wb') as fh:
            fh.write(data)
        shards[name] = {'bytes': len(data), 'crc32': zlib.crc32(data)}
    with open(os.path.join(tmp, elastic.MANIFEST_NAME), 'w') as fh:
        json.dump(dict(manifest, shards=shards), fh, indent=1,
                  sort_keys=True)
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.replace(tmp, out)
    return out
