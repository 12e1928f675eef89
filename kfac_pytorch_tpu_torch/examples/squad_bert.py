"""BERT SQuAD fine-tuning with tensor-parallel K-FAC.

Port of ``examples/squad_bert.py``, with the same flags and defaults
plus ``--device``: ``BertForQA`` on a ``('data', 'model')`` grid of
``torch.distributed`` ranks (:func:`~kfac_pytorch_tpu_torch.parallel.\
mesh.axis_groups`; ``--model-parallel`` ranks a model group, the
block's dense layers tensor-parallel over it, DDP over the data group)
under :class:`~kfac_pytorch_tpu_torch.gpt.GPTKFACPreconditioner` and its
fused step (``make_train_step``): the span-extraction cross entropy,
AdamW (weight decay 0.01) or SGD with momentum 0.9 on optax's
``warmup_cosine_decay_schedule``, and a checkpoint at the end
(:func:`~kfac_pytorch_tpu_torch.examples.utils.save_checkpoint`: the
model, optimizer and K-FAC state of each model rank of data index 0).

Data (``--data-file``, optional): an ``.npz`` of ``tokens [N, T]
int32``, ``starts [N]``, ``ends [N]`` and ``mask [N, T]`` (pre-tokenized
SQuAD).  Without one, the real-text extractive task built from the
committed ``examples/data/real_text.npz`` (:func:`build_realtext_qa`:
each example ``[query][SEP][context]``, the query an exact span of the
real context, the labels its start and end); ``--synthetic`` the
marker-token toy task.  The arrays are numpy, drawn as the JAX example
draws them, so both packages train on the same examples.

One card::

    python -m kfac_pytorch_tpu_torch.examples.squad_bert

Across ranks (four: data 2 x model 2)::

    torchrun --nproc-per-node 4 -m kfac_pytorch_tpu_torch.examples.squad_bert --model-parallel 2

``--device cpu`` runs on the CPU (gloo across ranks).
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import models
from kfac_pytorch_tpu_torch.examples import utils
from kfac_pytorch_tpu_torch.gpt import GPTKFACPreconditioner
from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups
from kfac_pytorch_tpu_torch.utils import backend


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description='BERT SQuAD + tensor-parallel K-FAC (PyTorch)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument('--data-file', default='', type=str,
                   help='pre-tokenized .npz (real-text QA fallback)')
    p.add_argument('--synthetic', action='store_true',
                   help='use the marker-token toy task instead of the '
                        'real-text corpus')
    p.add_argument('--log-dir', default='./logs/squad', type=str)
    p.add_argument('--seed', default=42, type=int)
    p.add_argument('--multihost', action='store_true',
                   help='accepted for the JAX flag set; torchrun sets up '
                        'the ranks')
    p.add_argument('--model', default='bert_large', type=str,
                   choices=['bert_tiny', 'bert_base', 'bert_large'])
    p.add_argument('--seq-len', default=384, type=int)
    p.add_argument('--batch-size', default=4, type=int,
                   help='batch size per data rank')
    p.add_argument('--epochs', default=2, type=int)
    p.add_argument('--base-lr', default=3e-5, type=float)
    p.add_argument('--optimizer', default='adamw',
                   choices=['adamw', 'sgd'],
                   help='first-order optimizer behind the '
                        'preconditioner; sgd (momentum 0.9) is the '
                        'reference\'s pairing')
    p.add_argument('--warmup-epochs', default=0, type=int)
    p.add_argument('--model-parallel', default=1, type=int,
                   help="extent of the grid's 'model' axis")

    p.add_argument('--kfac-inv-update-steps', default=50, type=int)
    p.add_argument('--kfac-factor-update-steps', default=5, type=int)
    p.add_argument('--kfac-damping', default=0.001, type=float)
    p.add_argument('--kfac-factor-decay', default=0.95, type=float)
    p.add_argument('--kfac-kl-clip', default=0.001, type=float)
    p.add_argument('--kfac-lowrank-rank', default=None, type=int,
                   help='randomized low-rank eigen rank (truncates factor '
                        'sides with dim >= 2k)')
    p.add_argument('--kfac-ekfac', action='store_true',
                   help='EKFAC scale re-estimation in the amortized '
                        'eigenbasis')
    p.add_argument('--kfac-skip-layers', nargs='+', type=str, default=[])
    p.add_argument('--device', default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


REAL_TEXT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    'examples', 'data', 'real_text.npz',
)


def build_realtext_qa(
    seq_len: int,
    n_examples: int = 2048,
    query_len: int = 12,
    seed: int = 0,
) -> tuple[np.ndarray, ...]:
    """Find-the-quote extractive QA over the committed real-text corpus.

    Each example (byte tokens, SEP = 1) is ``[q_0..q_{Q-1}, SEP,
    c_0..c_{T-Q-2}]`` where the query ``q`` is an exact copy of
    ``c[s..e]`` for a random span; the labels are the span's positions
    in the whole sequence."""
    corpus = np.load(REAL_TEXT)['tokens'].astype(np.int32)
    rng = np.random.default_rng(seed)
    ctx_len = seq_len - query_len - 1
    base = query_len + 1  # the context's offset in the sequence
    n = len(corpus) - ctx_len - 1
    tokens = np.empty((n_examples, seq_len), np.int32)
    starts = np.empty(n_examples, np.int32)
    ends = np.empty(n_examples, np.int32)
    for i in range(n_examples):
        ctx = corpus[rng.integers(0, n):][:ctx_len]
        s0 = int(rng.integers(0, ctx_len - query_len))
        q = ctx[s0:s0 + query_len]
        tokens[i, :query_len] = q
        tokens[i, query_len] = 1  # SEP
        tokens[i, base:] = ctx
        starts[i] = base + s0
        ends[i] = base + s0 + query_len - 1
    mask = np.ones((n_examples, seq_len), bool)
    return tokens, starts, ends, mask


def load_data(args) -> tuple[np.ndarray, ...]:
    """``(tokens, starts, ends, mask)``: ``--data-file``, else the
    real-text task, else (``--synthetic``) the marker-token task."""
    if args.data_file and os.path.exists(args.data_file):
        d = np.load(args.data_file)
        return d['tokens'], d['starts'], d['ends'], d['mask']
    if not args.synthetic and os.path.exists(REAL_TEXT):
        return build_realtext_qa(args.seq_len, seed=args.seed)
    # The synthetic span task: sentinel tokens mark the answer span.
    rng = np.random.default_rng(0)
    N, T = 2048, args.seq_len
    tokens = rng.integers(10, 250, (N, T)).astype(np.int32)
    starts = rng.integers(1, T - 8, N).astype(np.int32)
    lengths = rng.integers(1, 6, N)
    ends = np.minimum(starts + lengths, T - 1).astype(np.int32)
    for i in range(N):
        tokens[i, starts[i]] = 2       # learnable begin marker
        tokens[i, ends[i]] = 3         # learnable end marker
    mask = np.ones((N, T), bool)
    return tokens, starts, ends, mask


def span_loss(out, starts, ends):
    """The mean of the start and end cross entropies, with the logits as
    ``aux``."""
    start_logits, end_logits = out
    loss = (F.cross_entropy(start_logits, starts.long())
            + F.cross_entropy(end_logits, ends.long())) / 2
    return loss, {'start': start_logits, 'end': end_logits}


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int,
    decay_steps: int, end_value: float = 0.0, exponent: float = 1.0,
) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (which must come after the
    warmup, as optax requires)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(
            'the cosine decay requires positive decay_steps, got '
            f'{decay_steps} - {warmup_steps} warmup steps')

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / span))
        return peak_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def train(args: argparse.Namespace, **kfac_kw: Any) -> dict[str, Any]:
    """The run of :func:`main`; ``kfac_kw`` adds keywords of
    :class:`~kfac_pytorch_tpu_torch.gpt.GPTKFACPreconditioner` that have
    no flag (``compute_eigenvalue_outer_product``).  Returns ``{'losses',
    'step_s', 'epoch_losses', 'checkpoint', 'precond'}`` (per step the
    loss, read on the host, and the wall time; the checkpoint's path on
    the ranks that write one, else ``None``)."""
    device, world, rank = utils.setup(args.device)
    mp = max(1, args.model_parallel)
    if world % mp:
        raise SystemExit(f'{world} ranks not divisible by mp={mp}')
    mesh = axis_groups(world // mp, mp, names=('data', 'model'))
    n_data = world // mp
    if rank == 0:
        print(f'grid=data {n_data} x model {mp}')
        print(f'env={backend.environment_summary()}')

    tokens, starts, ends, mask = load_data(args)
    batch = args.batch_size * n_data
    model = getattr(models, args.model)(
        device=device, seed=args.seed, max_seq_len=args.seq_len,
        tp_group=mesh.group('model'))
    net = model
    if n_data > 1:
        net = torch.nn.parallel.DistributedDataParallel(
            model, process_group=mesh.group('data'),
            device_ids=None if device.type == 'cpu' else [device])

    n_steps = len(tokens) // batch
    lr_fn = warmup_cosine_decay_schedule(
        0.0, args.base_lr, max(1, args.warmup_epochs * n_steps),
        max(1, args.epochs * n_steps))
    if args.optimizer == 'sgd':
        opt = torch.optim.SGD(model.parameters(), lr=lr_fn(0), momentum=0.9)
    else:
        opt = torch.optim.AdamW(model.parameters(), lr=lr_fn(0),
                                weight_decay=0.01)
    precond = GPTKFACPreconditioner(
        net,
        mesh=mesh,
        data_axes=('data',),
        factor_update_steps=args.kfac_factor_update_steps,
        inv_update_steps=args.kfac_inv_update_steps,
        damping=args.kfac_damping,
        factor_decay=args.kfac_factor_decay,
        kl_clip=args.kfac_kl_clip,
        lr=lr_fn,
        skip_layers=args.kfac_skip_layers,
        lowrank_rank=args.kfac_lowrank_rank,
        ekfac=args.kfac_ekfac,
        **kfac_kw,
    )
    # The mask is per example, so it travels with the batch:
    # (tokens, type_ids, mask).
    train_step = precond.make_train_step(opt, span_loss)

    def on_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t.long() if t.dtype == torch.int32 else t

    losses, step_s, epoch_losses = [], [], []
    step = 0
    mine = slice(mesh.outer * args.batch_size,
                 (mesh.outer + 1) * args.batch_size)
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        perm = np.random.default_rng((args.seed, epoch)).permutation(
            len(tokens))
        epoch_start = len(losses)
        for b in range(n_steps):
            t = time.perf_counter()
            idx = perm[b * batch:(b + 1) * batch][mine]
            for group in opt.param_groups:
                group['lr'] = lr_fn(step)
            loss, _ = train_step(
                on_device(tokens[idx]), None, on_device(mask[idx]),
                loss_args=(on_device(starts[idx]), on_device(ends[idx])))
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t)
            step += 1
        mean = float(np.mean(losses[epoch_start:]))
        if n_data > 1:
            m = torch.tensor([mean], dtype=torch.float64)
            if dist.get_backend() == 'nccl':
                m = m.to(device)
            dist.all_reduce(m, group=mesh.group('data'))
            mean = float(m) / n_data
        epoch_losses.append(mean)
        if rank == 0:
            print(f'epoch {epoch}: span_loss={mean:.4f} '
                  f'({time.perf_counter() - t0:.1f}s, {n_steps} steps)')
    path = None
    if mesh.outer == 0:
        log_dir = (args.log_dir if mp == 1
                   else os.path.join(args.log_dir, f'model{mesh.inner}'))
        os.makedirs(log_dir, exist_ok=True)
        path = utils.save_checkpoint(
            log_dir, args.epochs - 1,
            {'model': model.state_dict(), 'optimizer': opt.state_dict()},
            precond.state_dict(),
        )
    return dict(losses=losses, step_s=step_s, epoch_losses=epoch_losses,
                checkpoint=path, precond=precond)


def main(argv: Sequence[str] | None = None) -> dict[str, Any]:
    return train(parse_args(argv))


if __name__ == '__main__':
    main()
