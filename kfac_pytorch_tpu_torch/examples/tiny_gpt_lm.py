"""Byte-level GPT language modeling on real text: K-FAC against SGD.

Port of ``examples/tiny_gpt_lm.py``, with the same flags and defaults
plus ``--device``: the committed ``examples/data/real_text.npz`` (1 MB
of English prose, byte-tokenized) trains the same small GPT twice, plain
SGD and K-FAC-preconditioned SGD, for ``--steps`` steps at equal
hyperparameters, and writes both loss curves to ``--log-dir``
(:class:`~kfac_pytorch_tpu_torch.utils.metrics.MetricsWriter`, tags
``sgd/loss`` and ``kfac/loss``) and progress records with the curvature
monitor's scalars to its JSONL stream
(:class:`~kfac_pytorch_tpu_torch.observe.Emitter`).  The batches are
drawn by ``np.random.RandomState(seed)`` as in the JAX example, so both
packages train on the same windows.

On the card::

    python -m kfac_pytorch_tpu_torch.examples.tiny_gpt_lm --steps 300

``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch.examples.utils import setup
from kfac_pytorch_tpu_torch.models.gpt import gpt_tiny
from kfac_pytorch_tpu_torch.observe import Emitter
from kfac_pytorch_tpu_torch.observe import FlightConfig
from kfac_pytorch_tpu_torch.observe import ObserveConfig
from kfac_pytorch_tpu_torch.preconditioner import KFACPreconditioner
from kfac_pytorch_tpu_torch.utils import backend
from kfac_pytorch_tpu_torch.utils.metrics import MetricsWriter
from kfac_pytorch_tpu_torch.utils.metrics import observe_scalars

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    'examples', 'data', 'real_text.npz',
)


def load_corpus() -> np.ndarray:
    """The corpus's byte tokens."""
    return np.load(DATA)['tokens']


def batches(tokens, batch, seq_len, steps, seed=0):
    """``steps`` batches of ``batch`` random windows ``(x, y)``, ``y`` the
    next bytes, int32 (the JAX example's draws)."""
    rng = np.random.RandomState(seed)
    n = len(tokens) - seq_len - 1
    for _ in range(steps):
        idx = rng.randint(0, n, size=batch)
        x = np.stack([tokens[i:i + seq_len] for i in idx])
        y = np.stack([tokens[i + 1:i + seq_len + 1] for i in idx])
        yield x.astype(np.int32), y.astype(np.int32)


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of ``[B, T, V]`` logits."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def coverage_layer_kwargs(
    full_coverage: bool, embedding: bool = False,
) -> dict:
    """Registration keywords of the chosen coverage level.

    ``full_coverage``: LayerNorm scale and bias, the token embedding and
    the tied LM head (``wte``'s attend) join the dense layers, so every
    parameter but the ``wpe`` table is preconditioned
    (arXiv:2311.00636).  ``embedding`` alone adds the token embedding.
    The default is the reference's ``{'linear', 'conv2d'}``."""
    if full_coverage:
        return dict(
            layer_types=('linear', 'conv2d', 'embedding', 'layernorm'),
            tied_weights=('wte',),
        )
    if embedding:
        return dict(layer_types=('linear', 'conv2d', 'embedding'))
    return {}


def run(
    precondition: bool,
    args: argparse.Namespace,
    writer: MetricsWriter,
    emitter: Emitter,
    weights: dict[str, torch.Tensor] | None = None,
    keep: dict[str, Any] | None = None,
) -> float:
    """Train one model for ``args.steps`` steps; return the mean loss of
    the curve's tail (the logged losses of the last 20% of steps, at
    most five).

    ``weights`` starts from a state dict instead of the seed's draws;
    ``keep``, when given, receives the ``model``, the ``precond``
    (``None`` for SGD) and every step's ``losses``."""
    tag = 'kfac' if precondition else 'sgd'
    device = torch.device(getattr(args, 'device', None) or 'cuda')
    seed = getattr(args, 'seed', 0)
    model = gpt_tiny(device=device, seed=seed, vocab_size=256,
                     n_layers=args.layers, d_model=args.d_model,
                     d_ff=2 * args.d_model, max_seq_len=args.seq_len)
    if weights is not None:
        model.load_state_dict(weights)
    tokens = load_corpus()

    precond = None
    if precondition:
        precond = KFACPreconditioner(
            model,
            factor_update_steps=args.factor_update_steps,
            inv_update_steps=args.inv_update_steps,
            damping=args.damping,
            lr=args.lr,
            lowrank_rank=args.lowrank_rank,
            ekfac=args.ekfac,
            compute_method=getattr(args, 'compute_method', 'eigen'),
            **coverage_layer_kwargs(
                getattr(args, 'full_coverage', False),
                getattr(args, 'embedding', False),
            ),
            # The curvature monitor: spectrum extremes, damping ratio and
            # kl nu in last_step_info['observe/*'], into the stream below.
            observe=ObserveConfig(),
            # The flight recorder (opt-in): the last steps' series,
            # snapshot crash-consistently into the log dir.
            flight=(
                FlightConfig(path=os.path.join(
                    args.log_dir, f'postmortem.{tag}.json'))
                if getattr(args, 'flight', False) else None
            ),
        )
    opt = torch.optim.SGD(model.parameters(), lr=args.lr)
    if keep is not None:
        keep.update(model=model, precond=precond, losses=[])

    t0 = time.perf_counter()
    logged: list[tuple[int, float]] = []
    for step, (x, y) in enumerate(batches(tokens, args.batch, args.seq_len,
                                          args.steps, seed=seed)):
        x = torch.from_numpy(x).to(device)
        y = torch.from_numpy(y).to(device)
        opt.zero_grad()
        loss = xent(model(x), y)
        loss.backward()
        if precond is not None:
            precond.step()
        opt.step()
        loss = loss.detach()
        if precond is not None:
            precond.flight_step(loss)
        if keep is not None:
            keep['losses'].append(float(loss))
        if step % 10 == 0 or step == args.steps - 1:
            logged.append((step, float(loss)))
            writer.scalar(f'{tag}/loss', logged[-1][1], step)
            if step % 50 == 0:
                values: dict = {
                    'loss': logged[-1][1],
                    'elapsed_s': time.perf_counter() - t0,
                }
                if precond is not None:
                    values.update(observe_scalars(precond.last_step_info))
                emitter.emit(tag, values, step=step)
    # The tail of the curve, not the last batch alone: the logged losses
    # of the last 20% of steps (at most five), never the step-0 loss of
    # a short run.
    tail = [v for s, v in logged if s >= 0.8 * (args.steps - 1)]
    if not tail:
        tail = [logged[-1][1]]
    return float(np.mean(tail[-5:]))


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--batch', type=int, default=32)
    p.add_argument('--seq-len', type=int, default=128)
    p.add_argument('--layers', type=int, default=2)
    p.add_argument('--d-model', type=int, default=64)
    p.add_argument('--lr', type=float, default=0.3)
    p.add_argument('--damping', type=float, default=0.003)
    p.add_argument('--factor-update-steps', type=int, default=10)
    p.add_argument('--lowrank-rank', type=int, default=None,
                   help='randomized low-rank eigen rank')
    p.add_argument('--ekfac', action='store_true',
                   help='EKFAC scale re-estimation in the amortized '
                        'eigenbasis')
    p.add_argument('--inv-update-steps', type=int, default=100)
    p.add_argument('--compute-method', choices=['eigen', 'inverse'],
                   default='eigen',
                   help='second-order solve: eigendecomposition or the '
                        'damped inverse')
    p.add_argument('--embedding', action='store_true',
                   help='also precondition the token embedding table '
                        '(diagonal A)')
    p.add_argument('--full-coverage', action='store_true',
                   dest='full_coverage',
                   help='full-coverage transformer K-FAC: LayerNorm '
                        'scale and bias, the embedding and the tied LM '
                        'head (every parameter but wpe)')
    p.add_argument('--seed', type=int, default=0,
                   help='drives the initialization and the batches')
    p.add_argument('--flight', action='store_true',
                   help='flight recorder: crash-consistent '
                        'postmortem.<tag>.json snapshots in --log-dir')
    p.add_argument('--log-dir', default='./logs/tiny_gpt')
    p.add_argument('--device', default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Sequence[str] | None = None) -> tuple[float, float]:
    """Train both models; return ``(sgd_loss, kfac_loss)``."""
    args = parse_args(argv)
    args.device = str(setup(args.device)[0])
    logging.basicConfig(level=logging.INFO)
    with MetricsWriter(args.log_dir, use_tensorboard=False) as writer, \
            Emitter.to_dir(args.log_dir, log=True,
                           log_interval_s=0.0) as emitter:
        writer.record('env', backend.environment_summary())
        sgd_loss = run(False, args, writer, emitter)
        kfac_loss = run(True, args, writer, emitter)
        emitter.emit('final', {'sgd_loss': sgd_loss, 'kfac_loss': kfac_loss},
                     step=args.steps)
    print(f'final @ {args.steps} steps: sgd={sgd_loss:.4f} '
          f'kfac={kfac_loss:.4f} '
          f'({"kfac wins" if kfac_loss <= sgd_loss else "sgd wins"})')
    return sgd_loss, kfac_loss


if __name__ == '__main__':
    main()
