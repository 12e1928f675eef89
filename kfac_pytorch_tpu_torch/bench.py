"""K-FAC step time against an SGD step on the card: the port's bench.

Port of the K-FAC/SGD ratio of ``bench.py``.  Each configuration trains
one model on one fixed batch made from a seed, first with
``torch.optim.SGD`` alone, then with ``KFACPreconditioner`` in front of
the same optimizer, and reports the step times and their ratio:

* ``resnet50``, the headline: ImageNet ResNet-50 at batch 32, 224x224,
  ``factor_update_steps=10, inv_update_steps=100``, damping 0.003, lr
  0.1 (``bench.py:1803-1830``, the ImageNet trainer's cadence);
* ``resnet32_cifar``: CIFAR ResNet-32 at batch 128, factor 1, inv 10;
* ``gpt125m``: GPT-125M at 4 x 2048 tokens with full coverage, factor 1,
  inv 10, lr 0.3, as ``chip_smoke.py`` phase 8 trains it;
* ``resnet50_lowrank512`` and ``resnet50_ekfac``: the headline
  configuration with ``lowrank_rank=512`` or ``ekfac=True``
  (``bench.py:1849-1894``, ``secondary_rn50_lowrank512`` and
  ``secondary_rn50_ekfac``).  They run only when named (``--configs``),
  so the default line keeps its keys.

Three stages of the JAX bench run only when named too, through
``KFACPreconditioner``, and put their own dict under ``detail[name]``:

* ``stagger_flatness`` (``bench.py:311-406``): a deep MLP (10 layers of
  192, batch 128, factor 1, inv 10) with the monolithic refresh and
  with ``stagger_refresh=10``; each interval phase's step is timed alone
  (ended by a synchronize), the least over 3 intervals is kept, and the
  p50, p95 and max of the phases are reported per mode with
  ``max_over_p50``, the refresh spike;
* ``adaptive_refresh`` (``bench.py:410-538``): an MLP of 8 layers of
  128 on a stationary task (fresh Gaussian inputs and random labels
  every step), inv 8, ``stagger_refresh=2``, 200 steps, with the fixed
  cadence and with ``AdaptiveRefreshConfig(0.2, staleness_factor=3)``:
  the shard refreshes of each (the fixed count analytic, the adaptive
  one from the controller's counters), ``refresh_reduction``, the mean
  step times and the final losses, and the controller's events;
* ``precond_tail`` (``bench.py:540-638``): the precondition tail alone
  (rotations, kl-clip, gradient gathers) of two otherwise equal
  preconditioners on the MLP ``(64, 64, 32, 32, 10)`` (three buckets)
  at input 64 and batch 64, synchronous against ``pipeline_grads=
  True``: two real steps first, then the tail on the same raw gradients,
  runs of 20 calls ended by a synchronize, the two modes in turns, the
  least mean of four runs each; ``bucket_shapes``, ``issue_order``,
  ``sync_ms``, ``pipelined_ms`` and ``pipelined_over_sync``.  On one
  rank nothing is gathered, so the ratio reads about 1.0; under
  ``torch.distributed`` with several ranks the run shards at HYBRID-OPT
  (0.5).

Three more stages of the JAX bench (``ROADMAP.md`` item 6):

* ``micro_mlp`` (``bench.py:234-308``): the 3x512 MLP (two hidden
  layers of 512, 10 classes) at batch 128, factor 10, inv 100, damping
  0.001; ``sgd_ms``, ``kfac_ms`` and their ``ratio``;
* ``inverse_root`` (``bench.py:641-750``): per ``[L, n, n]`` stack of
  the JAX stage's shapes (16x64, 8x128, 4x256; synthetic SPD stacks at
  condition number 1e4), the refresh kernels' times: batched ``eigh``,
  the Cholesky damped inverse, Newton–Schulz cold (bootstrap depth) and
  warm (warm depth, seeded with the previous interval's exact root,
  after a 2% aligned eigenvalue drift), with the residuals; ``shapes``
  and ``warm_vs_eigh_speedup_min``/``_max``;
* ``secondary_rn50_inverse`` (``bench.py:1889``): the headline
  configuration with ``compute_method='inverse'``, one cycle, no SGD
  run; ``kfac_ms``.

The configurations' K-FAC steps (``measure``: the headline, the
secondary ones, ``micro_mlp`` and ``secondary_rn50_inverse``) are timed
through the fused path, ``KFACPreconditioner.train_loop`` (forward,
backward, ``step()`` and the optimizer step in one call), as the JAX
bench times its ``train_loop``.  The K-FAC time is amortized as
``time_kfac_cycles`` does it (``bench.py:97-116``): after a warm-up, the
run is aligned to an inverse-update boundary, whole cycles of
``inv_update_steps`` steps are timed, each ended by ``torch.cuda.synchronize()``, and the least per-step
mean over the cycles is kept.  The SGD step is timed the same way, after
``SGD_WARMUP`` steps, as the least mean over ``SGD_WINDOWS`` windows of
``sgd_iters`` steps.  The last line of the output is one JSON object
with ``bench.py``'s keys: ``metric``, ``value`` (the ResNet-50 ratio),
``unit``, ``vs_baseline`` (1.5 / value) and ``detail`` (per
configuration ``*_sgd_ms``, ``*_kfac_ms_amortized`` and ``*_ratio``, and
``env``, the environment with the card's name and power limit).
Numbers are not rounded.

On the card::

    python -m kfac_pytorch_tpu_torch.bench
    python -m kfac_pytorch_tpu_torch.bench --configs resnet50 \
        resnet50_lowrank512 resnet50_ekfac
    python -m kfac_pytorch_tpu_torch.bench --configs stagger_flatness \
        adaptive_refresh precond_tail
    python -m kfac_pytorch_tpu_torch.bench --configs micro_mlp \
        inverse_root secondary_rn50_inverse

It raises without a card unless ``--device cpu`` is given.

The JAX bench's MFU fields (``bench.py:1205, 1414-1421, 2058``) keep
their names: ``sgd_mfu_vs_bf16_peak`` is the SGD step's counted FLOPs
(:func:`~kfac_pytorch_tpu_torch.observe.costs.compiled_costs` of one SGD
step) over its time, and ``kfac_mfu_vs_bf16_peak`` the K-FAC plain
step's (forward, backward and precondition, the fused kernel's FLOPs
from its shapes: :func:`~kfac_pytorch_tpu_torch.observe.costs.\
step_variant_costs`) over the amortized K-FAC step time, both as a share
of the card's dense BF16 peak from NVIDIA's data sheet
(:data:`BF16_PEAK_TFLOPS`, keyed by ``torch.cuda.get_device_name()``;
an unknown card, or the CPU, gives ``null`` beside its name).  The
configurations' ``*_sgd_gflops_per_step`` and
``*_kfac_plain_gflops_per_step`` are the counts.

The line also carries the JAX bench's prediction blocks
(``bench.py:756-1423``), each a model and marked ``'kind': 'model'``:
``detail['expected']`` (:func:`compute_expected`: the SGD FLOPs counted
on fake tensors as XLA's cost analysis counts them, the registered
layers' dims, and :func:`predict_ratio` per JAX variant),
``detail['kaisa_scaling']`` (:func:`predict_kaisa_scaling`, the
comm-aware :func:`predict_comm_aware_scaling` at one link rate, and
:func:`comm_model_2level`: 4 nodes of 8 cards, NVLink inside a node,
InfiniBand between) and ``detail['expected_vs_measured']`` (per measured
configuration, the model's ratio at the cadence the run timed beside the
measured one).  The rates are arguments; their defaults are the H100 SXM5
data sheet's (989 TFLOP/s dense BF16 at 700 W, 450 GB/s NVLink and 50
GB/s InfiniBand a GPU) at JAX's achieved share of 0.30, never a TPU's.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import time
from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F

from kfac_pytorch_tpu_torch import models
from kfac_pytorch_tpu_torch.observe.costs import compiled_costs
from kfac_pytorch_tpu_torch.observe.costs import step_variant_costs
from kfac_pytorch_tpu_torch.preconditioner import KFACPreconditioner
from kfac_pytorch_tpu_torch.scheduler import AdaptiveRefreshConfig
from kfac_pytorch_tpu_torch.tracing import percentile
from kfac_pytorch_tpu_torch.utils.backend import environment_summary

METRIC = 'kfac_step_overhead_resnet50_imagenet_b32'
#: Dense BF16 tensor-core peak (TFLOP/s, no sparsity) by card name, from
#: NVIDIA's data sheets; the MFU fields divide by it.
BF16_PEAK_TFLOPS = {
    # H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet), at 700 W.
    'NVIDIA H100 80GB HBM3': 989.0,
}
TARGET = 1.5
WARMUP = 3
SGD_WARMUP = 10
SGD_WINDOWS = 5

#: name -> configuration.  ``batch`` is images for the ResNets and
#: ``(sequences, tokens)`` for the GPT.
CONFIGS: dict[str, dict[str, Any]] = {
    'resnet50': dict(
        model='resnet50', batch=32, image=224, classes=1000,
        factor_steps=10, inv_steps=100, damping=0.003, lr=0.1,
        sgd_iters=20, cycles=2,
        note='factor=10 inv=100 (ref ImageNet defaults)',
    ),
    'resnet32_cifar': dict(
        model='resnet32', batch=128, image=32, classes=10,
        factor_steps=1, inv_steps=10, damping=0.003, lr=0.1,
        sgd_iters=30, cycles=3,
        note='factor=1 inv=10 (ref CIFAR defaults)',
    ),
    'gpt125m': dict(
        model='gpt_125m', batch=(4, 2048), factor_steps=1, inv_steps=10,
        damping=0.003, lr=0.3, sgd_iters=10, cycles=2,
        kfac_kw=dict(layer_types=('linear', 'conv2d', 'embedding',
                                  'layernorm'), tied_weights=('wte',)),
        note='factor=1 inv=10, full coverage (chip_smoke.py phase 8)',
    ),
}
for _name, _kw in (('resnet50_lowrank512', dict(lowrank_rank=512)),
                   ('resnet50_ekfac', dict(ekfac=True))):
    CONFIGS[_name] = dict(
        CONFIGS['resnet50'], cycles=1, kfac_kw=_kw,
        note=f'factor=10 inv=100, {_kw} (the JAX secondary stage)',
    )
#: The configurations a run without ``--configs`` measures.
DEFAULT_CONFIGS = ('resnet50', 'resnet32_cifar', 'gpt125m')


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def time_kfac_cycles(step_fn: Callable[[], Any], precond: Any,
                     inv_steps: int, cycles: int,
                     device: torch.device) -> float:
    """Seconds per K-FAC step: the least mean over ``cycles`` whole
    inverse-update cycles, each started on a cycle boundary and ended by
    a synchronize."""
    best = float('inf')
    for _ in range(cycles):
        while precond.steps % inv_steps != 0:
            step_fn()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(inv_steps):
            step_fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / inv_steps)
    return best


def _next_token_loss(logits: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]),
        tokens[:, 1:].reshape(-1),
    )


def _setup(cfg: dict, device: torch.device):
    """``(model, args, loss_args, loss_fn)`` of one configuration, the
    batch made from seed 1: the loss is ``loss_fn(model(*args),
    *loss_args)``, the fused path's form."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    if cfg['model'].startswith('gpt'):
        model = getattr(models, cfg['model'])(device=device, seed=0)
        tokens = torch.randint(0, model.config.vocab_size, cfg['batch'],
                               generator=gen, device=device)
        return model, (tokens,), (tokens,), _next_token_loss
    if cfg['model'] == 'mlp':
        torch.manual_seed(2)
        model = models.MLP(cfg['width'], cfg['features']).to(device)
        x = torch.randn(cfg['batch'], cfg['width'], generator=gen,
                        device=device)
    else:
        model = getattr(models, cfg['model'])(
            num_classes=cfg['classes'], device=device, seed=0,
        )
        x = torch.randn(cfg['batch'], 3, cfg['image'], cfg['image'],
                        generator=gen, device=device)
    y = torch.randint(0, cfg['classes'], (cfg['batch'],), generator=gen,
                      device=device)
    return model, (x,), (y,), F.cross_entropy


def measure(
    cfg: dict,
    device: torch.device | str = 'cuda',
    *,
    inv_steps: int | None = None,
    cycles: int | None = None,
) -> dict[str, Any]:
    """``{'sgd_ms', 'kfac_ms', 'inv_steps', 'cycles', 'sgd_flops',
    'kfac_plain_flops'}`` of one configuration (a :data:`CONFIGS` entry
    or one of that form); ``inv_steps`` and ``cycles`` override the
    entry's.  The FLOPs are counted after the timing, on the same
    batch (``None`` for the SGD step when it is skipped)."""
    device = torch.device(device)
    inv_steps = cfg['inv_steps'] if inv_steps is None else inv_steps
    cycles = cfg['cycles'] if cycles is None else cycles
    sgd_iters = cfg['sgd_iters']
    model, args, loss_args, loss_fn = _setup(cfg, device)
    model.train()

    t_sgd = sgd_flops = None
    if not cfg.get('skip_sgd'):
        sgd = torch.optim.SGD(model.parameters(), lr=cfg['lr'])

        def sgd_step():
            sgd.zero_grad(set_to_none=True)
            loss = loss_fn(model(*args), *loss_args)
            loss.backward()
            sgd.step()
            return loss

        for _ in range(SGD_WARMUP):
            sgd_step()
        t_sgd = float('inf')
        for _ in range(SGD_WINDOWS):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(sgd_iters):
                sgd_step()
            _sync(device)
            t_sgd = min(t_sgd, (time.perf_counter() - t0) / sgd_iters)
        sgd_flops = compiled_costs(sgd_step)['flops']
        del sgd

    precond = KFACPreconditioner(
        model, factor_update_steps=cfg['factor_steps'],
        inv_update_steps=inv_steps, damping=cfg['damping'], lr=cfg['lr'],
        **cfg.get('kfac_kw', {}),
    )
    opt = torch.optim.SGD(model.parameters(), lr=cfg['lr'])
    loop = precond.train_loop(opt, loss_fn)

    def kfac_step():
        return loop.step(*args, loss_args=loss_args)[0]

    # Warm every variant: step 0 refreshes, steps up to the factor
    # interval run without factors, the next one with.
    for _ in range(max(cfg['factor_steps'], 1) + WARMUP):
        kfac_step()
    _sync(device)
    t_kfac = time_kfac_cycles(kfac_step, precond, inv_steps, cycles, device)

    def forward_backward():
        opt.zero_grad(set_to_none=True)
        loss_fn(model(*args), *loss_args).backward()

    kfac_flops = step_variant_costs(precond, forward_backward)['plain']
    out = {'sgd_ms': None if t_sgd is None else t_sgd * 1e3,
           'kfac_ms': t_kfac * 1e3, 'inv_steps': inv_steps,
           'cycles': cycles, 'sgd_flops': sgd_flops,
           'kfac_plain_flops': kfac_flops['flops']}
    del precond, opt, loop, model
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    return out


def _mlp_step(model, precond, opt, x, y):
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    precond.step()
    opt.step()
    return loss


def measure_stagger_flatness(
    device: torch.device | str = 'cuda',
    *,
    n_layers: int = 10,
    width: int = 192,
    batch: int = 128,
    inv_steps: int = 10,
    intervals: int = 3,
) -> dict[str, Any]:
    """The step-time spread of the monolithic and the staggered refresh
    on the same model and cadence (JAX ``measure_stagger_flatness``).

    Each interval phase's step is timed alone and the least over
    ``intervals`` repeats kept; per mode ``p50_ms``, ``p95_ms`` and
    ``max_ms`` of the phases, and each mode's ``max/p50``.  The MLP puts
    ``n_layers`` equal slots in one bucket, so the monolithic spike
    grows with the slot count while a shard stays one slot.
    """
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    x = torch.randn(batch, width, generator=gen, device=device)
    y = torch.randint(0, 10, (batch,), generator=gen, device=device)

    def run(stagger):
        model = models.MLP(width, (width,) * n_layers + (10,)).to(device)
        precond = KFACPreconditioner(
            model, factor_update_steps=1, inv_update_steps=inv_steps,
            damping=0.001, lr=0.1, stagger_refresh=stagger,
        )
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        for _ in range(inv_steps + 1):  # the bootstrap and every shard
            _mlp_step(model, precond, opt, x, y)
        while precond.steps % inv_steps:
            _mlp_step(model, precond, opt, x, y)
        phase_ms = [float('inf')] * inv_steps
        for _ in range(intervals):
            for phase in range(inv_steps):
                _sync(device)
                t0 = time.perf_counter()
                _mlp_step(model, precond, opt, x, y)
                _sync(device)
                phase_ms[phase] = min(
                    phase_ms[phase], (time.perf_counter() - t0) * 1e3,
                )
        ordered = sorted(phase_ms)
        return {
            'p50_ms': percentile(ordered, 0.50),
            'p95_ms': percentile(ordered, 0.95),
            'max_ms': ordered[-1],
            'phase_ms': phase_ms,
        }

    mono = run(None)
    stag = run(inv_steps)
    return {
        'config': f'MLP {n_layers}x{width} b{batch}, factor=1 '
                  f'inv={inv_steps}, stagger={inv_steps}',
        'monolithic': mono,
        'staggered': stag,
        'mono_max_over_p50': mono['max_ms'] / mono['p50_ms'],
        'stag_max_over_p50': stag['max_ms'] / stag['p50_ms'],
    }


def measure_adaptive_refresh(
    device: torch.device | str = 'cuda',
    *,
    n_layers: int = 8,
    width: int = 128,
    batch: int = 128,
    inv_steps: int = 8,
    stagger: int = 2,
    steps: int = 200,
    threshold: float = 0.2,
    staleness_factor: int = 3,
) -> dict[str, Any]:
    """Shard refreshes the drift-adaptive cadence saves on a stationary
    task (JAX ``measure_adaptive_refresh``): fresh Gaussian inputs and
    random labels every step, the fixed stagger cadence against the
    adaptive one from the same weights and the same batches.  The fixed
    count is analytic (one shard per opportunity step after the
    bootstrap); the adaptive one is the controller's counters."""
    device = torch.device(device)

    def run(adaptive):
        torch.manual_seed(2)
        model = models.MLP(width, (width,) * n_layers + (10,)).to(device)
        precond = KFACPreconditioner(
            model, factor_update_steps=1, inv_update_steps=inv_steps,
            damping=0.001, lr=0.1, stagger_refresh=stagger,
            adaptive=adaptive,
        )
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        loss = None
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            x = torch.randn(batch, width, generator=gen, device=device)
            y = torch.randint(0, 10, (batch,), generator=gen, device=device)
            loss = _mlp_step(model, precond, opt, x, y)
        final = float(loss.detach())
        wall_ms = (time.perf_counter() - t0) * 1e3
        return precond, final, wall_ms

    _, fixed_loss, fixed_ms = run(None)
    adapt, adapt_loss, adapt_ms = run(AdaptiveRefreshConfig(
        threshold, staleness_factor=staleness_factor, record_events=True,
    ))
    ctl = adapt.adaptive_controller
    fixed_count = sum(1 for s in range(1, steps)
                      if s % inv_steps < ctl.n_shards)
    c = ctl.counters()
    adaptive_count = c['early'] + c['forced'] + c['scheduled']
    return {
        'config': f'MLP {n_layers}x{width} b{batch} stationary task, '
                  f'factor=1 inv={inv_steps}, stagger={stagger}, '
                  f'threshold={threshold}, floor={staleness_factor}x, '
                  f'{steps} steps',
        'geometry': {'inv_steps': inv_steps, 'n_shards': ctl.n_shards,
                     'steps': steps, 'threshold': threshold,
                     'staleness_factor': staleness_factor},
        'fixed': {'refreshes': fixed_count, 'final_loss': fixed_loss,
                  'step_ms_mean': fixed_ms / steps},
        'adaptive': {
            'refreshes': adaptive_count, 'counters': c,
            'final_loss': adapt_loss, 'step_ms_mean': adapt_ms / steps,
            'host_syncs': adapt.adaptive_host_syncs,
            'events': [list(e) for e in ctl.events],
        },
        'refresh_reduction': 1.0 - adaptive_count / fixed_count,
        'final_loss_gap': abs(adapt_loss - fixed_loss),
    }


def measure_precond_tail(
    device: torch.device | str = 'cuda',
    *,
    widths: tuple[int, ...] = (64, 64, 32, 32, 10),
    in_dim: int = 64,
    batch: int = 64,
    iters: int = 20,
    repeats: int = 4,
) -> dict[str, Any]:
    """The precondition tail alone, synchronous against pipelined (JAX
    ``measure_precond_tail``): per mode, two real steps so the stacks
    hold live decompositions, then the tail
    (``precondition_combined``) on the same raw gradients, ``iters``
    calls per run; the two modes take turns, which goes first
    alternating, and each keeps its least mean over ``repeats`` runs.
    Across ranks the run shards at HYBRID-OPT (0.5); on one rank no
    gather moves anything."""
    import torch.distributed as dist

    device = torch.device(device)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.randn(batch, in_dim, generator=gen, device=device)
    y = torch.randint(0, widths[-1], (batch,), generator=gen, device=device)

    def setup(pipeline):
        torch.manual_seed(2)
        model = models.MLP(in_dim, widths).to(device)
        precond = KFACPreconditioner(
            model, factor_update_steps=1, inv_update_steps=1, damping=0.001,
            lr=0.1, grad_worker_fraction=0.5 if world > 1 else 1.0,
            pipeline_grads=pipeline,
        )
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        for _ in range(2):
            _mlp_step(model, precond, opt, x, y)
        opt.zero_grad(set_to_none=True)
        F.cross_entropy(model(x), y).backward()
        raw = {n: h.get_grad() for n, h in precond.helpers.items()}

        def tail():
            return precond.precondition_combined(
                raw, precond.damping, precond.kl_clip, precond.lr)
        tail()
        return tail, precond

    tails = {mode: setup(mode) for mode in (False, True)}
    best = {False: float('inf'), True: float('inf')}
    for r in range(repeats):
        for mode in ((False, True) if r % 2 == 0 else (True, False)):
            tail = tails[mode][0]
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                tail()
            _sync(device)
            best[mode] = min(best[mode], (time.perf_counter() - t0) / iters)
    precond = tails[True][1]
    sync_ms, pipelined_ms = best[False] * 1e3, best[True] * 1e3
    return {
        'config': (f'MLP {widths} b{batch}, world {world}'
                   + (' (hybrid 0.5)' if world > 1 else ' (one rank)')),
        'bucket_shapes': [[b.n_slots, b.a_pad, b.g_pad]
                          for b in precond.plan.buckets],
        'issue_order': list(precond._second_order.pipeline_order),
        'sync_ms': sync_ms,
        'pipelined_ms': pipelined_ms,
        'pipelined_over_sync': pipelined_ms / sync_ms,
    }


#: The JAX bench's micro stage (``bench.py:234-308``).
MICRO_MLP = dict(
    model='mlp', width=512, features=(512, 512, 10), classes=10,
    batch=128, factor_steps=10, inv_steps=100, damping=0.001, lr=0.1,
    sgd_iters=30, cycles=3,
)


def measure_micro_mlp(device: torch.device | str = 'cuda', *,
                      inv_steps: int | None = None,
                      cycles: int | None = None) -> dict[str, Any]:
    """The smallest K-FAC/SGD ratio: the 3x512 MLP at batch 128, factor
    10, inv 100 (JAX ``measure_micro_mlp``); ``sgd_ms``, ``kfac_ms``
    (amortized over whole cycles) and ``ratio``."""
    res = measure(MICRO_MLP, device, inv_steps=inv_steps, cycles=cycles)
    return {
        'config': f"MLP 512x{MICRO_MLP['features']} b{MICRO_MLP['batch']}, "
                  f"factor={MICRO_MLP['factor_steps']} "
                  f"inv={res['inv_steps']} x {res['cycles']} cycles",
        'sgd_ms': res['sgd_ms'],
        'kfac_ms': res['kfac_ms'],
        'ratio': res['kfac_ms'] / res['sgd_ms'],
    }


def measure_secondary_rn50_inverse(
    device: torch.device | str = 'cuda', *,
    inv_steps: int | None = None, cycles: int | None = None,
) -> dict[str, Any]:
    """The headline configuration with ``compute_method='inverse'``, one
    cycle, no SGD run (JAX ``secondary_rn50_inverse``); ``kfac_ms``."""
    cfg = dict(CONFIGS['resnet50'], cycles=1, skip_sgd=True,
               kfac_kw=dict(compute_method='inverse'))
    res = measure(cfg, device, inv_steps=inv_steps, cycles=cycles)
    return {
        'config': f"factor=10 inv={res['inv_steps']} x {res['cycles']} "
                  "cycle(s), compute_method='inverse'",
        'kfac_ms': res['kfac_ms'],
    }


def measure_inverse_root(
    device: torch.device | str = 'cuda',
    *,
    shapes: Sequence[tuple[int, int]] = ((16, 64), (8, 128), (4, 256)),
    damping: float = 1e-3,
    cond: float = 1e4,
    iters: int = 10,
    drift: float = 0.02,
) -> dict[str, Any]:
    """The refresh kernels on ``[L, n, n]`` stacks (JAX
    ``measure_inverse_root``): batched ``eigh``, the Cholesky damped
    inverse (:func:`~kfac_pytorch_tpu_torch.ops.batched_damped_inv`) and
    Newton–Schulz (:func:`~kfac_pytorch_tpu_torch.ops.\
batched_newton_schulz_inverse`) cold at bootstrap depth and warm at warm
    depth, on synthetic SPD stacks ``Q diag(e) Q^T`` with ``e`` log-spaced
    from 1 to ``1/cond``.  The warm case is the engine's steady state:
    the seed is the exact root of the previous interval's stack and the
    timed stack drifts from it by a relative ``drift`` of each
    eigenvalue (aligned drift, which the warm gate accepts).  Each time
    is the least mean over 3 runs of ``iters`` calls, ended by a
    synchronize; the residuals ride along."""
    from kfac_pytorch_tpu_torch import ops

    device = torch.device(device)
    cfg = ops.IterativeConfig()

    def spd_pair(seed, L, n):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        q, _ = torch.linalg.qr(torch.randn(L, n, n, generator=gen,
                                           device=device))
        eigs = torch.logspace(0.0, -math.log10(cond), n,
                              device=device)[None, :]
        jitter = 1.0 + drift * (2.0 * torch.rand(
            L, n, generator=gen, device=device) - 1.0)
        prev = (q * eigs[:, None, :]) @ q.mT
        cur = (q * (eigs * jitter)[:, None, :]) @ q.mT
        return prev, cur

    def time_fn(fn, *args):
        fn(*args)
        _sync(device)
        best = float('inf')
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            _sync(device)
            best = min(best, (time.perf_counter() - t0) / iters)
        return best * 1e3

    def chol(s):
        return ops.batched_damped_inv(s, damping)

    def cold(s):
        return ops.batched_newton_schulz_inverse(
            s, damping, iters=cfg.bootstrap_iters, tol=cfg.tol)

    def warm(s, w):
        return ops.batched_newton_schulz_inverse(
            s, damping, iters=cfg.warm_iters, warm_start=w, tol=cfg.tol,
            warm_restart_gate=cfg.warm_restart_gate)

    per_shape = []
    for i, (L, n) in enumerate(shapes):
        prev, stack = spd_pair(i, L, n)
        seed = chol(prev)
        per_shape.append({
            'shape': f'[{L}, {n}, {n}]',
            'eigh_ms': time_fn(torch.linalg.eigh, stack),
            'cholesky_ms': time_fn(chol, stack),
            'ns_cold_ms': time_fn(cold, stack),
            'ns_warm_ms': time_fn(warm, stack, seed),
            'ns_cold_res': float(torch.max(cold(stack).residual)),
            'ns_warm_res': float(torch.max(warm(stack, seed).residual)),
            'ns_warm_iters': cfg.warm_iters,
            'ns_bootstrap_iters': cfg.bootstrap_iters,
        })
    speedups = [s['eigh_ms'] / s['ns_warm_ms'] for s in per_shape]
    return {
        'config': f'damping={damping} cond={cond:g} '
                  f'warm_iters={cfg.warm_iters} '
                  f'bootstrap_iters={cfg.bootstrap_iters} '
                  f'drift={drift:g} relative aligned eigenvalue '
                  'jitter per interval',
        'shapes': per_shape,
        'warm_vs_eigh_speedup_min': min(speedups),
        'warm_vs_eigh_speedup_max': max(speedups),
        'tol': cfg.tol,
    }


#: The stages: name -> measure function.
STAGES: dict[str, Callable[..., dict]] = {
    'stagger_flatness': measure_stagger_flatness,
    'adaptive_refresh': measure_adaptive_refresh,
    'precond_tail': measure_precond_tail,
    'micro_mlp': measure_micro_mlp,
    'inverse_root': measure_inverse_root,
    'secondary_rn50_inverse': measure_secondary_rn50_inverse,
}


# ---------------------------------------------------------------------------
# Predictions (the JAX bench's ``bench.py:756-1423``): models, not
# measurements.  Every number of these blocks is arithmetic on counted
# FLOPs and ledger bytes at declared rates.
# ---------------------------------------------------------------------------

#: Operation counts of the decompositions (JAX ``FLOP_MODEL``): ``eigh``
#: ~9 n^3, the Cholesky damped inverse ~1 n^3, a randomized range finder
#: pass 2 n^2 l.
FLOP_MODEL = {
    'eigh_n3': 9.0,
    'cholesky_inv_n3': 1.0,
    'lowrank_pass_coeff': 2.0,
}
#: The achieved share of the peak converting model FLOPs to seconds in
#: the comm-aware models (JAX ``ASSUMED_MFU``).
ASSUMED_MFU = 0.30
#: The card the defaults describe: its dense BF16 peak
#: (:data:`BF16_PEAK_TFLOPS`) and the per-GPU link rates of
#: :class:`~kfac_pytorch_tpu_torch.placement.PodTopology` (NVLink 450
#: GB/s inside a node, InfiniBand 50 GB/s between nodes; data sheets).
DEFAULT_CARD = 'NVIDIA H100 80GB HBM3'
NVLINK_GBYTES_PER_S = 450.0
INFINIBAND_GBYTES_PER_S = 50.0
#: The port's configuration -> the JAX bench's variant of the same run.
VARIANT_OF = {
    'resnet50': 'headline_rn50_imagenet',
    'secondary_rn50_inverse': 'secondary_rn50_inverse',
    'resnet50_lowrank512': 'secondary_rn50_lowrank512',
    'resnet50_ekfac': 'secondary_rn50_ekfac',
    'resnet32_cifar': 'secondary_rn32_cifar',
    'micro_mlp': 'micro_mlp',
}


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def _model_builder(name: str) -> Callable[[], torch.nn.Module]:
    """A builder of the bench model ``name`` (``'resnet50'``,
    ``'resnet32'``, ``'mlp'``) that allocates nothing outside a fake
    mode (the class constructors, no ``.to(device)``)."""
    if name == 'resnet50':
        from kfac_pytorch_tpu_torch.models.resnet import ResNet

        return lambda: ResNet((3, 4, 6, 3), num_classes=1000)
    if name == 'resnet32':
        from kfac_pytorch_tpu_torch.models.cifar_resnet import CifarResNet

        return lambda: CifarResNet((5, 5, 5), num_classes=10)
    if name == 'mlp':
        return lambda: models.MLP(MICRO_MLP['width'], MICRO_MLP['features'])
    raise ValueError(f'no bench model {name!r}')


def registration_dims(
    model: torch.nn.Module | Callable[[], torch.nn.Module],
    example_shape: Sequence[int],
    **kfac_kw: Any,
) -> list[tuple[int, int, int]]:
    """Per registered layer, in registration order, ``(a_dim, g_dim,
    rows_per_example)`` (JAX ``_registration_dims``): the factor sides and
    the covariance rows one example gives (output positions for a conv, 1
    for a dense layer on ``[1, features]``).

    ``model`` is a module builder (or a module whose parameters are fake
    or on ``meta``); it is built and registered by a
    :class:`~kfac_pytorch_tpu_torch.preconditioner.KFACPreconditioner`
    under ``FakeTensorMode`` and run once on a fake ``example_shape``
    input: nothing is computed or allocated."""
    dims: dict[str, tuple[int, int, int]] = {}
    with _fake_mode():
        module = model() if not isinstance(model, torch.nn.Module) else model
        precond = KFACPreconditioner(module, **kfac_kw)
        handles = []
        for name, helper in precond.helpers.items():
            a = helper.a_factor_shape[0]
            g = helper.g_factor_shape[0]

            def hook(mod, args, out, name=name, a=a, g=g):
                # g output features (a conv's channels): the rest of
                # the output are its rows.
                dims[name] = (a, g, out.numel() // g)
            handles.append(helper.module.register_forward_hook(hook))
        try:
            module(torch.empty(tuple(example_shape)))
        finally:
            for h in handles:
                h.remove()
    return [dims[name] for name in precond.helpers]


def sgd_step_flops(name: str, batch: int, image: int | None = None) -> float:
    """Counted FLOPs of one SGD step of the bench model ``name`` at
    ``batch`` (forward, cross entropy, backward, the update), on fake
    tensors, by :func:`~kfac_pytorch_tpu_torch.observe.costs.\
compiled_costs` with ``count='all'`` (XLA's cost-analysis model: only
    the convolution taps that meet the input, and the elementwise work)."""
    with _fake_mode():
        module = _model_builder(name)()
        shape = ((batch, 3, image, image) if image is not None
                 else (batch, MICRO_MLP['width']))
        x = torch.empty(shape)
        y = torch.zeros(batch, dtype=torch.long)
        opt = torch.optim.SGD(module.parameters(), lr=0.1)

        def step():
            opt.zero_grad(set_to_none=True)
            F.cross_entropy(module(x), y).backward()
            opt.step()
        return compiled_costs(step, count='all')['flops']


def predict_ratio(sgd_flops, dims, factor_steps, inv_steps,
                  method='eigen', lowrank_rank=None, lowrank_oversample=32,
                  lowrank_power_iters=2, ekfac=False, batch=1):
    """Predicted K-FAC/SGD step-time ratio of one variant (JAX
    ``predict_ratio``, the same formula): amortized K-FAC FLOPs are the
    SGD FLOPs, the per-step rotations, the factor updates over
    ``factor_steps`` and the decompositions over ``inv_steps``, at equal
    achieved FLOP/s."""
    from kfac_pytorch_tpu_torch.ops.lowrank import lowrank_engages

    em = FLOP_MODEL
    pre = fac = inv = 0.0
    for a, g, rows in dims:
        n_rows = rows * batch
        fac += 2.0 * n_rows * (a * a + g * g)
        if ekfac:
            fac += 2.0 * n_rows * (a * a + g * g)
        if method == 'inverse':
            pre += 2.0 * (g * g * a + g * a * a)
            inv += em['cholesky_inv_n3'] * (a ** 3 + g ** 3)
        elif lowrank_rank is not None:
            eng_a = lowrank_engages(a, lowrank_rank, lowrank_oversample)
            eng_g = lowrank_engages(g, lowrank_rank, lowrank_oversample)
            la = lowrank_rank if eng_a else a
            lg = lowrank_rank if eng_g else g
            pre += 2.0 * (lg * g * a + lg * a * la
                          + g * lg * la + g * la * a)
            passes = 2 * lowrank_power_iters + 2
            for n, eng in ((a, eng_a), (g, eng_g)):
                if eng:
                    sk = lowrank_rank + lowrank_oversample
                    inv += (em['lowrank_pass_coeff'] * passes * n * n * sk
                            + em['eigh_n3'] * sk ** 3)
                else:
                    inv += em['eigh_n3'] * n ** 3
        else:
            pre += 4.0 * (g * g * a + g * a * a)
            inv += em['eigh_n3'] * (a ** 3 + g ** 3)
    kfac_flops = sgd_flops + pre + fac / factor_steps + inv / inv_steps
    return {
        'expected_ratio': round(kfac_flops / sgd_flops, 4),
        'kfac_flops_per_step_amortized': kfac_flops,
        'precondition_flops': pre,
        'factor_flops_per_update': fac,
        'decomp_flops_per_update': inv,
    }


def predict_kaisa_scaling(sgd_flops, dims, factor_steps, inv_steps,
                          batch, world_sizes=(1, 2, 4, 8, 16, 32),
                          method='eigen'):
    """Per-device K-FAC/SGD ratio against the world size per strategy
    under weak scaling (JAX ``predict_kaisa_scaling``): the decompositions
    spread over the world, the rotations over the ``1/f`` columns, the
    factor updates stay per device; no communication."""
    comp = predict_ratio(sgd_flops, dims, factor_steps, inv_steps,
                         method=method, batch=batch)
    pre = comp['precondition_flops']
    fac = comp['factor_flops_per_update']
    inv = comp['decomp_flops_per_update']
    out = {}
    for w in world_sizes:
        strategies = {'comm_opt': 1.0}
        if w > 1:
            strategies['mem_opt'] = 1.0 / w
        if w >= 4:
            strategies['hybrid_opt'] = 0.5
        row = {}
        for name, frac in strategies.items():
            n_cols = max(1, round(1.0 / frac)) if w > 1 else 1
            n_cols = min(n_cols, w)
            per_device = (sgd_flops + pre / n_cols + fac / factor_steps
                          + inv / (w * inv_steps))
            row[name] = round(per_device / sgd_flops, 4)
        out[f'world_{w}'] = row
    return out


def predict_comm_aware_scaling(sgd_flops, dims, factor_steps, inv_steps,
                               batch, world_sizes=(2, 4, 8, 16, 32),
                               method='eigen', topology=None, *,
                               peak_tflops=None, assumed_mfu=ASSUMED_MFU,
                               link_gbytes_per_s=NVLINK_GBYTES_PER_S):
    """:func:`predict_kaisa_scaling` with each strategy's amortized wire
    bytes (the port's ``observe/costs.comm_ledger`` at each grid) priced
    at ``link_gbytes_per_s`` (flat) or, with a ``topology`` template,
    through each row's slowest link on ``topology.with_world(w)``, plus the
    placement solver's fraction as an ``auto`` row (JAX
    ``predict_comm_aware_scaling``, the same formula and fields).  Model
    FLOPs become seconds at ``peak_tflops`` (default the H100's dense BF16
    peak) times ``assumed_mfu``; the SGD side pays its own gradient ring
    all-reduce."""
    from kfac_pytorch_tpu_torch.observe.costs import (
        amortized_bytes_per_step,
        cadence_events_per_step,
        comm_ledger,
        ring_allreduce_bytes,
    )
    from kfac_pytorch_tpu_torch.parallel.mesh import grid_shape
    from kfac_pytorch_tpu_torch.placement.solver import (
        PlacementProblem,
        auto_placement,
        bucket_shapes_for,
    )

    if peak_tflops is None:
        peak_tflops = BF16_PEAK_TFLOPS[DEFAULT_CARD]
    comp = predict_ratio(sgd_flops, dims, factor_steps, inv_steps,
                         method=method, batch=batch)
    pre = comp['precondition_flops']
    fac = comp['factor_flops_per_update']
    inv = comp['decomp_flops_per_update']
    flops_per_s = peak_tflops * 1e12 * assumed_mfu
    bytes_per_s = link_gbytes_per_s * 1e9
    layer_dims = [(a, g) for a, g, _ in dims]
    grad_bytes = sum(a * g * 4 for a, g in layer_dims)

    def amortized_comm_s(ledger, topo):
        if topo is None:
            return amortized_bytes_per_step(
                ledger, factor_steps, inv_steps) / bytes_per_s
        total = 0.0
        for lrow in ledger:
            events = cadence_events_per_step(lrow.cadence, factor_steps,
                                             inv_steps)
            if not events:
                continue
            total += (lrow.bytes_per_device * events
                      / topo.bandwidth(lrow.scope))
        return total

    def strategy_ratio(w, frac, topo, sgd_s):
        rows_, cols = grid_shape(w, frac)
        ledger = comm_ledger(bucket_shapes_for(layer_dims, cols), layer_dims,
                             rows_, cols, compute_method=method,
                             topology=topo)
        kfac_comm_s = amortized_comm_s(ledger, topo)
        kfac_flops = pre / cols + fac / factor_steps + inv / (w * inv_steps)
        total = sgd_s + kfac_flops / flops_per_s + kfac_comm_s
        return total / sgd_s, {
            'ratio': round(total / sgd_s, 4),
            'kfac_comm_ms': round(kfac_comm_s * 1e3, 4),
            'comm_fraction_of_overhead': round(
                kfac_comm_s / (kfac_flops / flops_per_s + kfac_comm_s), 4),
        }

    out: dict[str, Any] = {}
    crossover = None
    diverged_worlds: list[int] = []
    auto_wins: list[int] = []
    for w in world_sizes:
        topo = None if topology is None else topology.with_world(w)
        strategies = {'comm_opt': 1.0, 'mem_opt': 1.0 / w}
        if w >= 4:
            strategies['hybrid_opt'] = 0.5
        sgd_wire = ring_allreduce_bytes(grad_bytes, w)
        sgd_bw = (bytes_per_s if topo is None
                  else topo.bandwidth(topo.scope_of(range(w))))
        sgd_s = sgd_flops / flops_per_s + sgd_wire / sgd_bw
        row: dict[str, Any] = {}
        raw: dict[str, float] = {}
        for name, frac in strategies.items():
            raw[name], row[name] = strategy_ratio(w, frac, topo, sgd_s)
        if topo is not None:
            plan = auto_placement(
                PlacementProblem(
                    layer_names=tuple(f'l{i}' for i in range(len(layer_dims))),
                    layer_dims=tuple(layer_dims), world=w,
                    factor_update_steps=factor_steps,
                    inv_update_steps=inv_steps, compute_method=method,
                    flops_per_second=flops_per_s,
                ),
                topo,
            )
            auto_raw, auto_row = strategy_ratio(w, plan.fraction, topo, sgd_s)
            row['auto'] = {**auto_row, 'fraction': plan.fraction,
                           'grid': f'{plan.grad_workers}x{plan.n_cols}',
                           'strategy': plan.strategy}
            if plan.strategy == 'auto':
                diverged_worlds.append(w)
            if auto_raw < min(raw.values()):
                auto_wins.append(w)
        if crossover is None and (row['comm_opt']['ratio']
                                  < row['mem_opt']['ratio']):
            crossover = w
        out[f'world_{w}'] = row
    out['crossover'] = {
        'comm_beats_mem_at_world': crossover,
        'note': ('smallest modeled world where COMM-OPT beats MEM-OPT end '
                 'to end; null = MEM-OPT wins everywhere modeled at '
                 f'{link_gbytes_per_s:g} GB/s'),
    }
    if topology is not None:
        out['planner'] = {
            'topology_template': topology.describe(),
            'diverges_from_named_at_worlds': diverged_worlds,
            'auto_beats_all_fixed_at_worlds': auto_wins,
            'note': ('diverges = worlds where auto_placement picked a '
                     'fraction that is none of COMM/HYBRID/MEM; beats = '
                     'worlds where it prices strictly below the best '
                     'fixed strategy under the same formula'),
        }
    return out


def comm_model_2level(flops50, dims50, *, peak_tflops=None,
                      assumed_mfu=ASSUMED_MFU,
                      intra_gbytes_per_s=NVLINK_GBYTES_PER_S,
                      inter_gbytes_per_s=INFINIBAND_GBYTES_PER_S,
                      group_size=8, n_groups=4) -> dict:
    """The two-level model (JAX ``_comm_model_2level``): ``n_groups``
    nodes of ``group_size`` cards, ``intra_gbytes_per_s`` inside a node
    (NVLink) and ``inter_gbytes_per_s`` between nodes (InfiniBand), worlds
    up to 64, the headline cadence (factor 10, inv 100) for eigen and
    inverse and the refresh-dense one (factor 1, inv 10) for eigen."""
    from kfac_pytorch_tpu_torch.placement import PodTopology

    if peak_tflops is None:
        peak_tflops = BF16_PEAK_TFLOPS[DEFAULT_CARD]
    topo = PodTopology(ici_size=group_size, n_groups=n_groups,
                       ici_gbytes_per_s=intra_gbytes_per_s,
                       dcn_gbytes_per_s=inter_gbytes_per_s)
    kw = dict(batch=32, world_sizes=(2, 4, 8, 16, 32, 64), topology=topo,
              peak_tflops=peak_tflops, assumed_mfu=assumed_mfu)
    return {
        'kind': 'model',
        'constants': {
            'intra_node_gbytes_per_s': intra_gbytes_per_s,
            'inter_node_gbytes_per_s': inter_gbytes_per_s,
            'cards_per_node': group_size, 'nodes': n_groups,
            'assumed_mfu': assumed_mfu, 'peak_tflops': peak_tflops,
        },
        'eigen': predict_comm_aware_scaling(flops50, dims50, 10, 100,
                                            method='eigen', **kw),
        'inverse': predict_comm_aware_scaling(flops50, dims50, 10, 100,
                                              method='inverse', **kw),
        'eigen_refresh_dense': predict_comm_aware_scaling(
            flops50, dims50, 1, 10, method='eigen', **kw),
    }


_EXPECTED_CACHE: dict[tuple, dict] = {}


def compute_expected(*, peak_tflops=None, assumed_mfu=ASSUMED_MFU) -> dict:
    """The prediction blocks at the bench's configurations (JAX
    ``compute_expected``): SGD FLOPs counted on fake tensors
    (:func:`sgd_step_flops`), registration dims (:func:`registration_dims`),
    the per-variant :func:`predict_ratio`, the KAISA scaling curves and
    both communication models.  All of it is a model; nothing here is
    measured.  Computed once per process for each set of arguments (the
    MLP's widths included)."""
    if peak_tflops is None:
        peak_tflops = BF16_PEAK_TFLOPS[DEFAULT_CARD]
    key = (peak_tflops, assumed_mfu, MICRO_MLP['width'],
           tuple(MICRO_MLP['features']))
    if key not in _EXPECTED_CACHE:
        _EXPECTED_CACHE[key] = _compute_expected(peak_tflops, assumed_mfu)
    return _EXPECTED_CACHE[key]


def _compute_expected(peak_tflops, assumed_mfu) -> dict:
    flops = {
        'resnet50_imagenet_b32': sgd_step_flops('resnet50', 32, 224),
        'resnet32_cifar_b128': sgd_step_flops('resnet32', 128, 32),
        'micro_mlp_b128': sgd_step_flops('mlp', 128),
    }
    dims = {
        'resnet50': registration_dims(_model_builder('resnet50'),
                                      (1, 3, 224, 224)),
        'resnet32': registration_dims(_model_builder('resnet32'),
                                      (1, 3, 32, 32)),
        'mlp': registration_dims(_model_builder('mlp'),
                                 (1, MICRO_MLP['width'])),
    }
    f50, d50 = flops['resnet50_imagenet_b32'], dims['resnet50']
    inputs = {
        'headline_rn50_imagenet': (f50, d50, 10, 100, dict(batch=32)),
        'secondary_rn50_inverse': (f50, d50, 10, 100,
                                   dict(method='inverse', batch=32)),
        'secondary_rn50_lowrank512': (f50, d50, 10, 100,
                                      dict(lowrank_rank=512, batch=32)),
        'secondary_rn50_ekfac': (f50, d50, 10, 100,
                                 dict(ekfac=True, batch=32)),
        'secondary_rn32_cifar': (flops['resnet32_cifar_b128'],
                                 dims['resnet32'], 1, 10, dict(batch=128)),
        'micro_mlp': (flops['micro_mlp_b128'], dims['mlp'], 10, 100,
                      dict(batch=128)),
    }
    out = {
        'kind': 'model',
        'basis': ('counted SGD FLOPs (fake tensors, valid convolution taps '
                  'and elementwise work) + analytic K-FAC FLOPs; equal '
                  'achieved FLOP/s for both steps, memory traffic ignored'),
        'flop_model_constants': dict(FLOP_MODEL),
        'sgd_flops': flops,
        'variants': {name: predict_ratio(f, d, fs, inv, **kw)
                     for name, (f, d, fs, inv, kw) in inputs.items()},
        'inputs': {name: {'sgd_flops': f, 'dims': d, 'factor_steps': fs,
                          'inv_steps': inv, 'kw': kw}
                   for name, (f, d, fs, inv, kw) in inputs.items()},
    }
    out['kaisa_scaling'] = {
        'kind': 'model',
        'config': ('ResNet-50 b32 a card (weak scaling), factor=10 '
                   'inv=100'),
        'comm_model': {
            'kind': 'model',
            'constants': {'link_gbytes_per_s': NVLINK_GBYTES_PER_S,
                          'assumed_mfu': assumed_mfu,
                          'peak_tflops': peak_tflops},
            'eigen': predict_comm_aware_scaling(
                f50, d50, 10, 100, batch=32, method='eigen',
                peak_tflops=peak_tflops, assumed_mfu=assumed_mfu),
            'inverse': predict_comm_aware_scaling(
                f50, d50, 10, 100, batch=32, method='inverse',
                peak_tflops=peak_tflops, assumed_mfu=assumed_mfu),
        },
        'comm_model_2level': comm_model_2level(
            f50, d50, peak_tflops=peak_tflops, assumed_mfu=assumed_mfu),
        'eigen': predict_kaisa_scaling(f50, d50, 10, 100, batch=32,
                                       method='eigen'),
        'inverse': predict_kaisa_scaling(f50, d50, 10, 100, batch=32,
                                         method='inverse'),
    }
    return out


def expected_vs_measured(expected, results, peak_tflops=None) -> dict:
    """Per measured configuration with a JAX variant (:data:`VARIANT_OF`):
    the model's ratio at the cadence the run measured (``expected_ratio``,
    a model), the measured ratio, and the MFU the model's FLOPs imply at
    the measured K-FAC time (JAX ``_expected_vs_measured``)."""
    out = {}
    for name, res in results.items():
        variant = VARIANT_OF.get(name)
        if variant is None or not isinstance(res, dict):
            continue
        inp = expected['inputs'][variant]
        # The stages give their cadence in their 'config' text only.
        timed = re.search(r'inv=(\d+)', str(res.get('config', '')))
        inv_steps = (res.get('inv_steps') or (timed and int(timed[1]))
                     or inp['inv_steps'])
        pred = predict_ratio(inp['sgd_flops'], inp['dims'],
                             inp['factor_steps'], inv_steps, **inp['kw'])
        kfac_ms, sgd_ms = res.get('kfac_ms'), res.get('sgd_ms')
        flops = pred['kfac_flops_per_step_amortized']
        out[name] = {
            'variant': variant,
            'cadence': f'factor={inp["factor_steps"]} inv={inv_steps}',
            'expected_ratio': pred['expected_ratio'],
            'measured_ratio': (kfac_ms / sgd_ms if kfac_ms and sgd_ms
                               else None),
            'kfac_mfu_vs_bf16_peak': (
                flops / (kfac_ms * 1e-3) / (peak_tflops * 1e12)
                if kfac_ms and peak_tflops else None),
        }
    return out


def result_line(results: dict[str, dict | None], env: dict,
                expected: dict | None = None) -> dict:
    """The JSON line: ``bench.py``'s keys from the per-configuration
    results (``None`` for a configuration not run), and with ``expected``
    (:func:`compute_expected`) the model blocks: ``detail['expected']``,
    ``detail['kaisa_scaling']`` and ``detail['expected_vs_measured']``,
    each marked ``'kind': 'model'``."""
    detail: dict[str, Any] = {}
    for name, res in results.items():
        if name in STAGES:
            detail[name] = res
            continue
        cfg = CONFIGS.get(name, {})
        detail[f'{name}_sgd_ms'] = res['sgd_ms'] if res else None
        detail[f'{name}_kfac_ms_amortized'] = res['kfac_ms'] if res else None
        detail[f'{name}_ratio'] = (res['kfac_ms'] / res['sgd_ms']
                                   if res else None)
        detail[f'{name}_config'] = (
            f"{cfg.get('note', name)}; timed inv={res['inv_steps']} x "
            f"{res['cycles']} cycles" if res else None
        )
        for key in ('sgd', 'kfac_plain'):
            flops = res.get(f'{key}_flops') if res else None
            detail[f'{name}_{key}_gflops_per_step'] = (
                None if flops is None else flops / 1e9)
    device = env.get('device')
    peak = BF16_PEAK_TFLOPS.get(device)
    detail['bf16_peak'] = {
        'device': device, 'tflops': peak,
        'source': ('NVIDIA data sheet, dense BF16' if peak is not None
                   else 'no published figure for this device'),
    }
    head = results.get('resnet50')

    def mfu(flops_key, ms_key):
        if not head or peak is None or not head.get(flops_key) or not (
                head.get(ms_key)):
            return None
        return head[flops_key] / (head[ms_key] * 1e-3) / (peak * 1e12)

    detail['sgd_mfu_vs_bf16_peak'] = mfu('sgd_flops', 'sgd_ms')
    detail['kfac_mfu_vs_bf16_peak'] = mfu('kfac_plain_flops', 'kfac_ms')
    if expected is not None:
        detail['expected'] = {k: v for k, v in expected.items()
                              if k not in ('inputs', 'kaisa_scaling')}
        detail['kaisa_scaling'] = expected['kaisa_scaling']
        detail['expected_vs_measured'] = {
            'kind': 'model beside measurement: expected_ratio and the MFU '
                    'are model numbers, measured_ratio is this run\'s',
            **expected_vs_measured(expected, results, peak),
        }
    detail['env'] = env
    ratio = detail.get('resnet50_ratio')
    return {
        'metric': METRIC,
        'value': ratio,
        'unit': 'x_sgd_step_time',
        'vs_baseline': TARGET / ratio if ratio else None,
        'detail': detail,
    }


def run(names: Sequence[str], device: torch.device | str = 'cuda',
        **overrides: Any) -> dict:
    """Measure the named configurations in turn and return the line,
    with the prediction blocks (:func:`compute_expected`)."""
    results = {
        name: (STAGES[name](device) if name in STAGES
               else measure(CONFIGS[name], device, **overrides))
        for name in names
    }
    env = environment_summary()
    env['allow_tf32'] = {
        'matmul': torch.backends.cuda.matmul.allow_tf32,
        'cudnn': torch.backends.cudnn.allow_tf32,
    }
    return result_line(results, env, compute_expected())


def main(argv: Sequence[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--device', default=None,
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--configs', nargs='+', default=list(DEFAULT_CONFIGS),
                   choices=list(CONFIGS) + list(STAGES),
                   help='configurations to measure, in order')
    args = p.parse_args(argv)
    if args.device in (None, 'cuda') and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: the bench measures the card; pass --device '
            'cpu to run it on the CPU',
        )
    device = args.device or 'cuda'
    line = run(args.configs, device)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
