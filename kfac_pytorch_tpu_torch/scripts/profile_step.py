"""Per-variant and per-phase K-FAC step cost decomposition.

Port of ``scripts/profile_step.py``.  Two modes:

* **variant mode** (default): times each step variant of the headline
  ResNet-50 ImageNet configuration (batch 32, 224x224, factor 10, inv
  100) on its own, with CUDA events after warm-ups:

  - ``sgd``    the plain SGD step (the baseline);
  - ``plain``  a K-FAC step with no factor or inverse update (90 of 100);
  - ``factor`` a K-FAC step with the factor EMA update (9 of 100);
  - ``inv``    a K-FAC step with the factor update and the second-order
    refresh (1 of 100);

  each forced through the engine's own stage calls (the capture, the
  factor EMA, the refresh, the precondition, as
  :func:`kfac_pytorch_tpu_torch.observe.timeline.profile_phases` runs
  them), and the amortized ratio to SGD::

      python -m kfac_pytorch_tpu_torch.scripts.profile_step --model resnet50

* **smokes**, each writing an artifact its validator re-checks:
  ``--smoke`` (the phase profile of a tiny MLP: ``profile_phases``,
  ``phase_table``, ``amdahl_breakdown``, ``bench_payload``),
  ``--stagger-smoke``, ``--iterative-smoke``, ``--placement-smoke``,
  ``--overlap-smoke``, ``--pipeline-smoke`` and ``--adaptive-smoke``;
  ``--validate*`` re-checks an artifact.

Every mode takes ``--device`` (default ``cuda``; ``cuda`` without a card
raises).  The JAX smokes that read compiled HLO read what the card shows
here (the side stream's concurrency from the profiler, the pipelined
gather's time); on the CPU that evidence is recorded as not measurable.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Any, Callable

import numpy as np

MODULE = 'kfac_pytorch_tpu_torch.scripts.profile_step'
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Drift-adaptive refresh acceptance: the replayed refresh count of the
# plateauing leg at least this far below the fixed cadence's, at
# final-loss parity within the tolerance.
ADAPTIVE_MIN_REDUCTION = 0.30
ADAPTIVE_PARITY_TOL = 0.02
# sum(phases)/total tolerance of the smoke decomposition.
SMOKE_SUM_TOLERANCE = 0.10
# Spike-vs-flat acceptance of the stagger smoke, and the ledger's
# per-interval parity.
STAGGER_MONO_SPIKE = 3.0
STAGGER_FLAT_BOUND = 1.5
STAGGER_LEDGER_TOLERANCE = 0.01
# World of the overlap and pipeline smokes (the JAX smokes' 8 devices).
SMOKE_WORLD = 8
NOT_MEASURABLE = 'not measurable here'

# Variant mode: the JAX script's batch, image, classes and cadence.
VARIANT_CONFIGS = {
    'resnet50': dict(batch=32, image=224, classes=1000, factor=10, inv=100),
    'resnet32': dict(batch=128, image=32, classes=10, factor=1, inv=10),
    'vit_tiny': dict(batch=128, image=32, classes=10, factor=1, inv=10),
}


def _device(name: str):
    import torch

    if name == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('--device cuda needs a CUDA card; pass '
                               '--device cpu to run on the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def _sync(device) -> None:
    import torch

    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def bench_fn(fn: Callable[[], Any], iters: int, device) -> float:
    """Mean ms of one ``fn()`` call: two warm-up calls, then the least
    mean over 3 windows of ``iters`` calls, timed with CUDA events on the
    card (the host clock on the CPU)."""
    import torch

    fn()
    fn()
    _sync(device)
    best = float('inf')
    for _ in range(3):
        if device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        best = min(best, ms)
    return best


def write_json_atomic(payload: dict, out_path: str) -> None:
    """Temp file + rename: a killed run never truncates an artifact."""
    out = os.path.abspath(out_path)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f'{out}.tmp.{os.getpid()}'
    with open(tmp, 'w') as fh:
        json.dump(payload, fh, indent=1)
    os.replace(tmp, out)


def _read(path: str, gate: str):
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError) as exc:
        print(f'{gate} gate: cannot read {path}: {exc}')
        return None


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


# ----------------------------------------------------------------------
# variant mode
# ----------------------------------------------------------------------


def run_variants(
    model_name: str = 'resnet50',
    device: str = 'cuda',
    iters: int = 20,
    *,
    batch: int | None = None,
    image: int | None = None,
    method: str = 'eigen',
    lowrank: int | None = None,
    ekfac: bool = False,
    json_out: str | None = None,
) -> dict:
    """Time the ``sgd``, ``plain``, ``factor`` and ``inv`` variants of
    ``model_name`` (the JAX script's batch, image and cadence unless
    ``batch``/``image`` are given); returns the JSON payload (JAX's keys,
    plus the fused kernel's launches per call of each K-FAC variant)."""
    import torch
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.utils.backend import environment_summary
    from kfac_pytorch_tpu_torch.utils.checkpoint import snapshot_host_state

    if lowrank is not None and method != 'eigen':
        raise ValueError('--lowrank requires --method eigen')
    if ekfac and (lowrank is not None or method != 'eigen'):
        raise ValueError('--ekfac requires exact eigen (no --lowrank/'
                         '--method)')
    cfg = dict(VARIANT_CONFIGS[model_name])
    if batch is not None:
        cfg['batch'] = batch
    if image is not None:
        cfg['image'] = image
    dev = _device(device)
    factor_steps, inv_steps = cfg['factor'], cfg['inv']
    if model_name == 'vit_tiny':
        model = kt.models.vit_tiny(device=dev, seed=0,
                                   image_size=cfg['image'])
    else:
        model = getattr(kt.models, model_name)(
            num_classes=cfg['classes'], device=dev, seed=0)
    model.train()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn(cfg['batch'], 3, cfg['image'], cfg['image'],
                    generator=gen, device=dev)
    y = torch.randint(0, cfg['classes'], (cfg['batch'],), generator=gen,
                      device=dev)

    sgd = torch.optim.SGD(model.parameters(), lr=0.1)

    def sgd_step():
        sgd.zero_grad(set_to_none=True)
        F.cross_entropy(model(x), y).backward()
        sgd.step()

    t_sgd = bench_fn(sgd_step, iters, dev)
    print(f'sgd            {t_sgd:8.3f} ms', flush=True)

    kfac_kw: dict[str, Any] = dict(
        factor_update_steps=factor_steps, inv_update_steps=inv_steps,
        damping=0.003, lr=0.1, compute_method=method, ekfac=ekfac)
    if lowrank is not None:
        kfac_kw['lowrank_rank'] = lowrank
    precond = kt.KFACPreconditioner(model, **kfac_kw)
    # One real step, so the state holds live factors and decompositions.
    model.zero_grad(set_to_none=True)
    F.cross_entropy(model(x), y).backward()
    precond.step()
    _sync(dev)
    rollback = snapshot_host_state(precond)

    def fwd_bwd(capture: bool) -> None:
        precond._arm_capture(capture)
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(x), y).backward()

    def pre() -> None:
        precond._precondition(*precond._tail_hyperparams())

    def plain():
        fwd_bwd(False)
        pre()

    def factor():
        fwd_bwd(True)
        precond._update_factors(first_update=False)
        pre()

    def inv():
        fwd_bwd(True)
        precond._update_factors(first_update=False)
        precond._refresh(precond.damping)
        pre()

    counter = kt.ops.fused_eigen_precondition
    times, launches = {}, {}
    try:
        for name, fn in (('plain', plain), ('factor', factor), ('inv', inv)):
            n = iters if name != 'inv' else max(iters // 4, 3)
            before = counter.launches
            times[name] = bench_fn(fn, n, dev)
            launches[name] = (counter.launches - before) / (2 + 3 * n)
            print(f'{name:14s} {times[name]:8.3f} ms   '
                  f'({times[name] / t_sgd:5.2f}x sgd)', flush=True)
    finally:
        rollback()
    n_factor = inv_steps // factor_steps
    amort = (times['plain'] * (inv_steps - n_factor)
             + times['factor'] * (n_factor - 1) + times['inv']) / inv_steps
    print(f'amortized      {amort:8.3f} ms   ({amort / t_sgd:5.2f}x sgd)',
          flush=True)
    payload = {
        'model': model_name,
        'method': method,
        'lowrank': lowrank,
        'ekfac': ekfac,
        'cadence': {'factor': factor_steps, 'inv': inv_steps},
        'batch': cfg['batch'],
        'image': cfg['image'],
        'device': dev.type,
        'sgd_ms': round(t_sgd, 3),
        'phases_ms': {k: round(v, 3) for k, v in times.items()},
        'amortized_ms': round(amort, 3),
        'amortized_ratio': round(amort / t_sgd, 4),
        'kernel_launches_per_call': launches,
        'env': environment_summary(),
    }
    if json_out:
        write_json_atomic(payload, json_out)
        print(f'wrote {json_out}')
    return payload


# ----------------------------------------------------------------------
# --smoke: the phase profile
# ----------------------------------------------------------------------


def validate_artifact(path: str) -> int:
    """Gate of a smoke artifact: schema, finiteness, sum/total."""
    from kfac_pytorch_tpu_torch.observe.report import validate_bench_payload

    payload = _read(path, 'profile')
    if payload is None:
        return 1
    problems = validate_bench_payload(payload)
    ratio = payload.get('detail', {}).get('phase_sum_vs_total')
    if not _finite(ratio):
        problems.append(f'phase_sum_vs_total missing/non-finite: {ratio!r}')
    elif abs(ratio - 1.0) > SMOKE_SUM_TOLERANCE:
        problems.append(f'phase sum vs measured total off by more than '
                        f'{SMOKE_SUM_TOLERANCE:.0%}: ratio={ratio}')
    if problems:
        for problem in problems:
            print(f'profile gate: {problem}')
        return 1
    print(f'profile gate: {path} OK (amortized {payload["value"]} '
          f'{payload["unit"]}, sum/total {ratio})')
    return 0


def run_smoke(json_out: str, device: str = 'cuda', steps: int = 5,
              iters: int = 5) -> int:
    """Tiny-MLP phase profile: the table, the Amdahl breakdown and the
    BENCH-schema artifact, gated by :func:`validate_artifact`."""
    import torch
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.observe import ObserveConfig
    from kfac_pytorch_tpu_torch.observe import report
    from kfac_pytorch_tpu_torch.observe.timeline import profile_phases
    from kfac_pytorch_tpu_torch.utils.metrics import observe_scalars

    dev = _device(device)
    factor_steps, inv_steps = 1, steps
    torch.manual_seed(2)
    model = kt.models.MLP(64, (128, 128, 10)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn(256, 64, generator=gen, device=dev)
    y = torch.randint(0, 10, (256,), generator=gen, device=dev)
    precond = kt.KFACPreconditioner(
        model, factor_update_steps=factor_steps, inv_update_steps=inv_steps,
        damping=0.003, lr=0.1, observe=ObserveConfig())
    loss = None
    for _ in range(steps):
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        precond.step()
    _sync(dev)
    info = observe_scalars(precond.last_step_info)

    def forward_backward():
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(x), y).backward()

    phases, total = profile_phases(precond, forward_backward, iters=iters)

    # Capture-free forward/backward: the every-step cost the Amdahl
    # amortization bills to non-factor steps.
    precond._arm_capture(False)
    forward_backward()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        forward_backward()
        _sync(dev)
    plain_s = (time.perf_counter() - t0) / iters

    print(report.phase_table(phases, total))
    print()
    breakdown = report.amdahl_breakdown(phases, factor_steps, inv_steps,
                                        plain_s)
    print(report.amdahl_table(breakdown))
    payload = report.bench_payload(
        phases, total, model='mlp_smoke', factor_update_steps=factor_steps,
        inv_update_steps=inv_steps, plain_s=plain_s,
        extra_detail={'last_loss': float(loss), 'observe': info,
                      'device': dev.type})
    write_json_atomic(payload, json_out)
    print(f'wrote {json_out}')
    return validate_artifact(json_out)


# ----------------------------------------------------------------------
# --stagger-smoke
# ----------------------------------------------------------------------


def validate_stagger_artifact(path: str) -> int:
    """Gate of a stagger-smoke artifact: both modes' p50/p95/max finite,
    the ledger's interval parity within 1%, and staggered ``max/p50 <
    1.5`` wherever the monolithic spike is ``>= 3``."""
    payload = _read(path, 'stagger')
    if payload is None:
        return 1
    problems = []
    detail = payload.get('detail', {})
    for mode in ('monolithic', 'staggered'):
        stats = detail.get(mode)
        if not isinstance(stats, dict):
            problems.append(f'missing {mode} stats')
            continue
        for key in ('p50_ms', 'p95_ms', 'max_ms'):
            v = stats.get(key)
            if not _finite(v) or v <= 0:
                problems.append(f'{mode}.{key} missing/non-finite: {v!r}')
    mono = detail.get('mono_max_over_p50')
    stag = detail.get('stag_max_over_p50')
    if not isinstance(mono, (int, float)) or not isinstance(
            stag, (int, float)):
        problems.append('max/p50 ratios missing')
    elif mono >= STAGGER_MONO_SPIKE and stag >= STAGGER_FLAT_BOUND:
        problems.append(f'monolithic refresh spike {mono}x but staggered '
                        f'max/p50 {stag}x >= {STAGGER_FLAT_BOUND}: the '
                        'flatten claim failed on this host')
    ledger = detail.get('ledger_interval_ratio')
    if not _finite(ledger):
        problems.append(f'ledger_interval_ratio missing: {ledger!r}')
    elif abs(ledger - 1.0) > STAGGER_LEDGER_TOLERANCE:
        problems.append(f'staggered/monolithic per-interval ledger totals '
                        f'differ by more than {STAGGER_LEDGER_TOLERANCE:.0%}:'
                        f' {ledger}')
    if problems:
        for problem in problems:
            print(f'stagger gate: {problem}')
        return 1
    note = ('' if mono >= STAGGER_MONO_SPIKE else
            f' (monolithic spike {mono}x < {STAGGER_MONO_SPIKE}: flatness '
            'unfalsifiable here, distribution recorded anyway)')
    print(f'stagger gate: {path} OK (mono max/p50 {mono}, staggered max/p50 '
          f'{stag}, ledger interval ratio {ledger}){note}')
    return 0


def run_stagger_smoke(json_out: str, device: str = 'cuda') -> int:
    """Spike against flat: ``bench.measure_stagger_flatness`` plus the
    analytic ledger's per-interval parity at a 2x2 grid on the smoke
    model's bucket geometry."""
    import torch

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.bench import measure_stagger_flatness
    from kfac_pytorch_tpu_torch.observe import costs

    dev = _device(device)
    result = measure_stagger_flatness(dev, n_layers=8, width=128, batch=128,
                                      inv_steps=8, intervals=4)

    def engine_ledger(stagger):
        torch.manual_seed(2)
        model = kt.models.MLP(128, (128,) * 8 + (10,))
        p = kt.KFACPreconditioner(model, factor_update_steps=1,
                                  inv_update_steps=8, damping=0.001, lr=0.1,
                                  stagger_refresh=stagger)
        second = p._second_order
        shapes = [(b.n_slots, b.a_pad, b.g_pad) for b in second.plan.buckets]
        dims = [(129, 128)] * 8 + [(129, 10)]
        return costs.comm_ledger(
            shapes, dims, 2, 2,
            stagger_shard_shapes=costs.stagger_shard_shapes_for(second))

    t_mono = costs.interval_bytes_per_device(engine_ledger(None), 1, 8)
    t_stag = costs.interval_bytes_per_device(engine_ledger(8), 1, 8)
    ledger_ratio = t_stag / t_mono if t_mono else float('nan')
    payload = {
        'metric': 'kfac_stagger_refresh_flatness_mlp_smoke',
        'value': result['stag_max_over_p50'],
        'unit': 'max_over_p50_step_time',
        'vs_baseline': result['mono_max_over_p50'],
        'detail': {
            **result,
            'ledger_interval_ratio': round(ledger_ratio, 6),
            'device': dev.type,
            'policy': 'per-phase min over intervals (host-noise stripped; '
                      'see bench.measure_stagger_flatness)',
        },
    }
    write_json_atomic(payload, json_out)
    print(f'wrote {json_out}')
    return validate_stagger_artifact(json_out)


# ----------------------------------------------------------------------
# --iterative-smoke
# ----------------------------------------------------------------------


def validate_iterative_artifact(path: str) -> int:
    """Gate of an iterative-smoke artifact: finite positive timings,
    both Newton–Schulz residuals within ``tol``, and warm Newton–Schulz
    strictly beating ``eigh`` on every shape."""
    payload = _read(path, 'iterative')
    if payload is None:
        return 1
    problems = []
    detail = payload.get('detail', {})
    shapes = detail.get('shapes')
    tol = detail.get('tol')
    if not isinstance(shapes, list) or not shapes:
        problems.append('per-shape timings missing')
        shapes = []
    if not isinstance(tol, (int, float)) or not 0 < tol < 1:
        problems.append(f'tol missing/implausible: {tol!r}')
        tol = float('inf')
    for entry in shapes:
        label = entry.get('shape', '?')
        for key in ('eigh_ms', 'cholesky_ms', 'ns_cold_ms', 'ns_warm_ms'):
            v = entry.get(key)
            if not _finite(v) or v <= 0:
                problems.append(f'{label}.{key} missing/non-finite: {v!r}')
        for key in ('ns_cold_res', 'ns_warm_res'):
            v = entry.get(key)
            if not _finite(v):
                problems.append(f'{label}.{key} missing/non-finite: {v!r}')
            elif v > tol:
                problems.append(f'{label}.{key} = {v} exceeds tol {tol}: the '
                                'Newton–Schulz refresh did not converge on '
                                'this shape')
    speedup = payload.get('value')
    if not _finite(speedup):
        problems.append(f'warm_vs_eigh_speedup_min missing: {speedup!r}')
    elif speedup <= 1.0:
        problems.append(f'warm-started Newton–Schulz is not beating eigh on '
                        f'every stacked shape (min speedup {speedup}x <= 1)')
    if problems:
        for problem in problems:
            print(f'iterative gate: {problem}')
        return 1
    print(f'iterative gate: {path} OK (warm NS vs eigh speedup {speedup}x min '
          f'across {len(shapes)} shapes, residuals within tol={tol})')
    return 0


def run_iterative_smoke(json_out: str, device: str = 'cuda') -> int:
    """Decomposition kernels: ``bench.measure_inverse_root``."""
    from kfac_pytorch_tpu_torch.bench import measure_inverse_root

    dev = _device(device)
    result = measure_inverse_root(dev)
    payload = {
        'metric': 'kfac_inverse_root_kernel_smoke',
        'value': result['warm_vs_eigh_speedup_min'],
        'unit': 'warm_ns_vs_eigh_speedup_min',
        'vs_baseline': result['warm_vs_eigh_speedup_max'],
        'detail': {**result, 'device': dev.type,
                   'policy': 'min-over-repeats per kernel (host-noise '
                             'stripped; see bench.measure_inverse_root)'},
    }
    write_json_atomic(payload, json_out)
    print(f'wrote {json_out}')
    return validate_iterative_artifact(json_out)


# ----------------------------------------------------------------------
# --placement-smoke
# ----------------------------------------------------------------------


def validate_placement_artifact(path: str) -> int:
    """Gate of a placement-plan artifact: the plan schema
    (``placement.validate_plan_payload``, chosen-is-argmin included),
    the planner strictly cheaper than the best fixed strategy, bytes on
    both link classes, and the two-level price not below the flat one."""
    from kfac_pytorch_tpu_torch.placement import validate_plan_payload

    payload = _read(path, 'placement')
    if payload is None:
        return 1
    problems = validate_plan_payload(payload)
    chosen = payload.get('chosen', {})
    ratio = payload.get('auto_vs_best_fixed')
    if not _finite(ratio):
        problems.append(f'auto_vs_best_fixed missing: {ratio!r}')
    elif ratio >= 1.0:
        problems.append(f'auto_vs_best_fixed = {ratio} >= 1: the planner did '
                        'not strictly beat the best fixed strategy')
    scopes_bytes = chosen.get('bytes_by_scope', {})
    for scope in ('ici', 'dcn'):
        if scopes_bytes.get(scope, 0) <= 0:
            problems.append(f'no {scope} bytes in the chosen plan: the smoke '
                            'no longer exercises the 2-level model')
    flat_s = chosen.get('flat_interval_seconds')
    pred_s = chosen.get('interval_seconds')
    if isinstance(flat_s, (int, float)) and isinstance(pred_s, (int, float)):
        if pred_s < flat_s * (1 - 1e-9):
            problems.append(f'2-level interval {pred_s}s prices below the '
                            f'flat model {flat_s}s for the same grid')
    if problems:
        for problem in problems:
            print(f'placement gate: {problem}')
        return 1
    print(f'placement gate: {path} OK (chosen {chosen.get("grad_workers")}x'
          f'{chosen.get("n_cols")} grid, auto/best-fixed = {ratio:.4f})')
    return 0


PLACEMENT_MODEL = ('gpt-class stack: 12 blocks x (qkv, proj, mlp_in, '
                   'mlp_out), d=1024')


def placement_plan(topology_kw: dict | None = None,
                   flops_per_second: float | None = None):
    """The smoke's plan: the JAX smoke's 12-block d=1024 stack (48
    layers) at world 32 on a 4 x 8 topology, at the port's H100 rates
    unless ``topology_kw`` gives others."""
    from kfac_pytorch_tpu_torch.placement import PlacementProblem
    from kfac_pytorch_tpu_torch.placement import PodTopology
    from kfac_pytorch_tpu_torch.placement import auto_placement

    d = 1024
    dims: list[tuple[int, int]] = []
    for _ in range(12):
        dims += [(d, 3 * d), (d, d), (d, 4 * d), (4 * d, d)]
    kw = {} if flops_per_second is None else {
        'flops_per_second': flops_per_second}
    problem = PlacementProblem(
        layer_names=tuple(f'block{i // 4}/{n}' for i, n in enumerate(
            ['qkv', 'proj', 'mlp_in', 'mlp_out'] * 12)),
        layer_dims=tuple(dims), world=32, factor_update_steps=10,
        inv_update_steps=100, **kw)
    topology = PodTopology(ici_size=8, n_groups=4, **(topology_kw or {}))
    return auto_placement(problem, topology)


def run_placement_smoke(json_out: str, device: str = 'cuda') -> int:
    """Solve the modeled 4 x 8 pod (host arithmetic only), round-trip the
    plan through ``KAISAAssignment`` and write the plan payload."""
    from kfac_pytorch_tpu_torch.placement import format_placement
    from kfac_pytorch_tpu_torch.placement import lower_plan
    from kfac_pytorch_tpu_torch.placement import plan_payload

    _device(device)
    plan = placement_plan()
    lower_plan(plan)
    print(format_placement(plan))
    payload = plan_payload(plan)
    payload['model'] = PLACEMENT_MODEL
    write_json_atomic(payload, json_out)
    print(f'wrote {json_out}')
    return validate_placement_artifact(json_out)


# ----------------------------------------------------------------------
# --overlap-smoke and --pipeline-smoke (worlds of ranks)
# ----------------------------------------------------------------------


def _ledger_detail(costs, off, on, factor_steps, inv_steps) -> dict:
    return {
        'exposed_off_bytes': costs.exposed_bytes_per_step(
            off, factor_steps, inv_steps),
        'exposed_on_bytes': costs.exposed_bytes_per_step(
            on, factor_steps, inv_steps),
        'hidden_on_bytes': costs.hidden_bytes_per_step(
            on, factor_steps, inv_steps),
        'total_off_bytes': costs.amortized_bytes_per_step(
            off, factor_steps, inv_steps),
        'total_on_bytes': costs.amortized_bytes_per_step(
            on, factor_steps, inv_steps),
    }


def _check_ledger(ledger: dict, what: str) -> list[str]:
    problems = []
    for key in ('exposed_on_bytes', 'exposed_off_bytes', 'hidden_on_bytes',
                'total_on_bytes', 'total_off_bytes'):
        v = ledger.get(key)
        if not _finite(v) or v < 0:
            problems.append(f'ledger.{key} missing/non-finite: {v!r}')
    if not problems:
        if not ledger['exposed_on_bytes'] < ledger['exposed_off_bytes']:
            problems.append(
                f'exposed bytes with {what} on ({ledger["exposed_on_bytes"]})'
                f' are not strictly below off ({ledger["exposed_off_bytes"]})'
                ' on the modeled ledger')
        if ledger['hidden_on_bytes'] <= 0:
            problems.append('hidden_on_bytes <= 0: nothing hidden')
        if ledger['total_on_bytes'] != ledger['total_off_bytes']:
            problems.append(
                f'amortized totals differ between modes '
                f'({ledger["total_on_bytes"]} vs {ledger["total_off_bytes"]})'
                f': {what} must re-time bytes, never change them')
    return problems


def _check_card(card: Any, keys: tuple[str, ...], device: Any) -> list[str]:
    """The port's evidence block: measured numbers finite, or, off the
    card only, the pin named as not measurable here."""
    if not isinstance(card, dict):
        return ['card evidence missing']
    if card.get('measured') is True:
        bad = [k for k in keys if not _finite(card.get(k))]
        return [f'card evidence {k} missing/non-finite' for k in bad]
    if device == 'cuda':
        return ['card evidence not measured on the card: '
                f'{card.get("reason")!r}']
    if NOT_MEASURABLE not in str(card.get('reason', '')):
        return ['card evidence neither measured nor recorded as '
                f'{NOT_MEASURABLE!r}']
    return []


def validate_overlap_artifact(path: str) -> int:
    """Gate of an overlap-smoke artifact: the modeled exposed bytes with
    ``overlap_comm=True`` strictly below off on equal totals, hidden
    bytes positive; the evidence that the refresh ran beside the step
    (JAX's compiled-HLO block, or the card's side-stream concurrency
    from the profiler); the timing delta present and finite."""
    payload = _read(path, 'overlap')
    if payload is None:
        return 1
    detail = payload.get('detail', {})
    problems = _check_ledger(detail.get('ledger', {}), 'overlap')
    if 'hlo' in detail:
        hlo_ev = detail['hlo']
        n_planned = hlo_ev.get('n_plan_overlapped')
        if not isinstance(n_planned, int) or n_planned < 1:
            problems.append('HLO overlap evidence vacuous: '
                            f'n_plan_overlapped={n_planned!r}')
        if hlo_ev.get('all_ok') is not True:
            problems.append('HLO overlap evidence: a plan-overlapped '
                            'collective failed its bracket/dominance pin')
        if hlo_ev.get('in_band_contrast_fails_issue_at_top') is not True:
            problems.append('HLO overlap evidence: the in-band reference '
                            'does not fail issue-at-top')
    else:
        problems += _check_card(detail.get('card'),
                                ('side_stream_ms', 'concurrent_ms'),
                                detail.get('device'))
        card = detail.get('card') or {}
        if card.get('measured') is True and not card.get(
                'concurrent_ms', 0) > 0:
            problems.append('the side-stream refresh never ran beside '
                            'another stream on the card')
    est = detail.get('timing', {}).get('exposed_comm_estimate_s')
    if not _finite(est):
        problems.append('timing.exposed_comm_estimate_s missing/non-finite: '
                        f'{est!r}')
    if problems:
        for problem in problems:
            print(f'overlap gate: {problem}')
        return 1
    ledger = detail['ledger']
    print(f'overlap gate: {path} OK (exposed/step {ledger["exposed_on_bytes"]}'
          f' vs {ledger["exposed_off_bytes"]} bytes, hidden '
          f'{ledger["hidden_on_bytes"]})')
    return 0


def validate_pipeline_artifact(path: str) -> int:
    """Gate of a pipeline-smoke artifact: the modeled exposed bytes with
    ``pipeline_grads=True`` strictly below the synchronous tail on equal
    totals; at least two per-bucket gather rows with only the last
    exposed; the issue order cost-descending; the evidence (JAX's
    compiled-HLO block, or the port's: the pipelined precondition's
    gradients equal to the synchronous one's bit for bit, and on the card
    both timed)."""
    payload = _read(path, 'pipeline')
    if payload is None:
        return 1
    detail = payload.get('detail', {})
    problems = _check_ledger(detail.get('ledger', {}), 'pipeline')
    buckets = detail.get('bucket_rows')
    if not isinstance(buckets, list) or len(buckets) < 2:
        problems.append(f'bucket_rows missing or fewer than 2 ({buckets!r})')
    else:
        exposed = [b for b in buckets if not b.get('overlapped')]
        if [b.get('phase') for b in exposed] != [buckets[-1].get('phase')]:
            problems.append('exactly the LAST bucket row must be exposed; got '
                            f'{[b.get("phase") for b in exposed]}')
        # The port's artifact carries the order's key apart from the wire
        # payload (its gather adds one f32 kl-clip term a slot).
        field = ('order_key_bytes' if 'order_key_bytes' in buckets[0]
                 else 'payload_bytes')
        payloads = [b.get(field) for b in buckets]
        if not all(isinstance(v, int) and v > 0 for v in payloads) or any(
                a < b for a, b in zip(payloads, payloads[1:])):
            problems.append(f'issue order is not LPT cost-descending: '
                            f'{field} {payloads}')
    order = detail.get('issue_order')
    if not isinstance(order, list) or not order:
        problems.append(f'issue_order missing: {order!r}')
    if 'hlo' in detail:
        hlo_ev = detail['hlo']
        n_pipe = hlo_ev.get('n_pipelined')
        if not isinstance(n_pipe, int) or n_pipe < 1:
            problems.append(f'HLO pipeline evidence vacuous: n_pipelined='
                            f'{n_pipe!r}')
        if hlo_ev.get('all_ok') is not True:
            problems.append('HLO pipeline evidence: a non-final bucket gather '
                            'failed its scale-free/bracket pin')
        if hlo_ev.get('sync_contrast_fails') is not True:
            problems.append('HLO pipeline evidence: the synchronous contrast '
                            'does not fail the combined test')
        if hlo_ev.get('parity_exact') is not True:
            problems.append('HLO pipeline evidence: per-bucket gather bytes '
                            'do not match the ledger rows exactly')
    else:
        problems += _check_card(detail.get('card'),
                                ('sync_precondition_ms',
                                 'pipelined_precondition_ms'),
                                detail.get('device'))
        diff = (detail.get('parity') or {}).get('max_abs_diff')
        if not _finite(diff):
            problems.append('parity.max_abs_diff (pipelined against '
                            f'synchronous gradients) missing: {diff!r}')
        elif diff != 0.0:
            problems.append('the pipelined precondition is not the '
                            'synchronous one bit for bit: max abs diff '
                            f'{diff}')
    if problems:
        for problem in problems:
            print(f'pipeline gate: {problem}')
        return 1
    ledger = detail['ledger']
    print(f'pipeline gate: {path} OK (exposed/step '
          f'{ledger["exposed_on_bytes"]} vs {ledger["exposed_off_bytes"]} '
          f'bytes, issue order {order})')
    return 0


def _side_stream_window(torch, prof):
    """``(side-stream device ms, ms of it beside another stream)`` of one
    profiler window, the side stream found by the ``_sleep`` marker the
    deferred refresh launched first; ``None`` without the marker."""
    def union(spans):
        out = []
        for s, e in sorted(spans):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    acts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    marker = [e for e in acts if 'spin_kernel' in e.name]
    if not marker:
        return None
    side = marker[0].device_resource_id
    mine = union([(e.time_range.start, e.time_range.end) for e in acts
                  if e.device_resource_id == side])
    other = union([(e.time_range.start, e.time_range.end) for e in acts
                   if e.device_resource_id != side])
    both, i, j = 0.0, 0, 0
    while i < len(mine) and j < len(other):
        lo = max(mine[i][0], other[j][0])
        hi = min(mine[i][1], other[j][1])
        both += max(0.0, hi - lo)
        if mine[i][1] < other[j][1]:
            i += 1
        else:
            j += 1
    return sum(e - s for s, e in mine) / 1e3, both / 1e3


def _smoke_rank(kind: str, spec: dict) -> None:
    """One rank of the overlap or pipeline smoke's world; rank 0 writes
    the payload's detail."""
    import threading

    import torch
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.observe import ObserveConfig
    from kfac_pytorch_tpu_torch.observe import costs
    from kfac_pytorch_tpu_torch.observe.timeline import profile_overlap_delta
    from kfac_pytorch_tpu_torch.scripts import fault_drill as fd

    rank, world, dev = fd._init_world(spec['device'])
    features = tuple(spec['features'])
    gen = np.random.default_rng(0)
    gx = gen.standard_normal((16, features[0])).astype(np.float32)
    gy = gen.integers(0, features[-1], size=(16,))
    rows = 16 // world
    x = torch.from_numpy(gx[rank * rows:(rank + 1) * rows]).to(dev)
    y = torch.from_numpy(gy[rank * rows:(rank + 1) * rows]).to(dev)
    factor_steps, inv_steps = 1, 2
    option = 'overlap_comm' if kind == 'overlap' else 'pipeline_grads'

    def build(on):
        torch.manual_seed(2)
        model = kt.models.MLP(features[0], features[1:]).to(dev)
        p = kt.KFACPreconditioner(
            model, factor_update_steps=factor_steps,
            inv_update_steps=inv_steps, damping=0.003, lr=0.1,
            grad_worker_fraction=0.5, observe=ObserveConfig(annotate=True),
            **{option: on})
        return model, p

    off_m, off_p = build(False)
    on_m, on_p = build(True)
    ledger_off, ledger_on = costs.ledger_for(off_p), costs.ledger_for(on_p)
    detail: dict[str, Any] = {
        'ledger': _ledger_detail(costs, ledger_off, ledger_on, factor_steps,
                                 inv_steps),
        'world': world,
        'device': dev.type,
    }

    def fwd_bwd_of(model):
        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            F.cross_entropy(model(x), y).backward()
            fd._average_grads(model)
        return fwd_bwd

    def real_steps(model, p, n):
        for _ in range(n):
            fwd_bwd_of(model)()
            p.step()

    if kind == 'overlap':
        real_steps(on_m, on_p, inv_steps + 1)
        detail['timing'] = profile_overlap_delta(on_p, fwd_bwd_of(on_m),
                                                 iters=3)
        card: dict[str, Any] = {
            'measured': False,
            'reason': f'{NOT_MEASURABLE}: no CUDA side stream on the CPU'}
        if dev.type == 'cuda':
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile

            real = on_p._refresh_state

            def marked(*args):
                if threading.current_thread() is not threading.main_thread():
                    torch.cuda._sleep(1000)  # the side stream's marker
                return real(*args)

            on_p._refresh_state = marked
            # The window: a due step R, whose deferred refresh is issued
            # at its end, and step R + 1, whose forward and backward run
            # beside it before the collect point.
            while on_p.steps % inv_steps != 0:
                real_steps(on_m, on_p, 1)
            due = on_p.steps
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                real_steps(on_m, on_p, 2)
                torch.cuda.synchronize()
            on_p._refresh_state = real
            window = _side_stream_window(torch, prof)
            card = ({'measured': True, 'side_stream_ms': window[0],
                     'concurrent_ms': window[1],
                     'window_steps': [due, due + 1]} if window is not None
                    else {'measured': False,
                          'reason': f'{NOT_MEASURABLE}: the profiler '
                                    'delivered no side-stream marker'})
        detail['card'] = card
        on_p.join_deferred_refresh()
    else:
        bucket_rows = [row for row in ledger_on
                       if row.phase.startswith('grad_col_allgather/bucket')]
        order = list(on_p._second_order.pipeline_order)
        cols = on_p.grid.cols
        detail['bucket_rows'] = [
            {'phase': row.phase, 'bytes_per_device': row.bytes_per_device,
             'payload_bytes': row.payload_bytes,
             # The issue order's key, JAX's gather payload: the port's
             # gather adds one f32 kl-clip term a slot to it.
             'order_key_bytes': cols * b.seg * b.g_pad * b.a_pad * 4,
             'overlapped': row.overlapped}
            for row, b in zip(bucket_rows, (on_p.plan.bucket(k)
                                            for k in order))]
        detail['issue_order'] = order
        # The same steps on both, then one precondition of the same
        # gradients through each tail.
        real_steps(off_m, off_p, inv_steps + 1)
        real_steps(on_m, on_p, inv_steps + 1)
        grads = {}
        for name, model, p in (('sync', off_m, off_p),
                               ('pipelined', on_m, on_p)):
            fwd_bwd_of(model)()
            p._precondition(*p._tail_hyperparams())
            grads[name] = [q.grad.detach().clone()
                           for q in model.parameters()]
        detail['parity'] = {
            'max_abs_diff': max(float((a - b).abs().max()) for a, b in
                                zip(grads['sync'], grads['pipelined'])),
            'tensors': len(grads['sync']),
        }
        card = {'measured': False,
                'reason': f'{NOT_MEASURABLE}: gloo on CPU tensors has no '
                          'device stream to overlap'}
        if dev.type == 'cuda':
            times = {}
            for name, model, p in (('sync', off_m, off_p),
                                   ('pipelined', on_m, on_p)):
                fwd_bwd_of(model)()

                def pre(p=p):
                    p._precondition(*p._tail_hyperparams())
                    torch.cuda.synchronize()

                times[name] = bench_fn(pre, 5, dev)
            card = {'measured': True,
                    'sync_precondition_ms': times['sync'],
                    'pipelined_precondition_ms': times['pipelined'],
                    'pipelined_over_sync': times['pipelined'] / times['sync']}
        detail['card'] = card
    fd._finish_world(world)
    if rank == 0:
        with open(spec['out'], 'w') as fh:
            json.dump(detail, fh, indent=1)


def _run_world_smoke(kind: str, json_out: str, device: str, world: int,
                     features: tuple[int, ...]) -> dict | None:
    import tempfile

    from kfac_pytorch_tpu_torch.scripts import fault_drill as fd

    work = tempfile.mkdtemp(prefix=f'{kind}_smoke_')
    out = os.path.join(work, 'detail.json')
    rcs, _, _ = fd._run_world(f'{kind} smoke', f'--{kind}-child', {
        'device': device, 'features': list(features), 'out': out,
    }, world, module=MODULE)
    if any(rcs) or not os.path.isfile(out):
        print(f'{kind} smoke: the world failed: {rcs}')
        return None
    with open(out) as fh:
        return json.load(fh)


def run_overlap_smoke(json_out: str, device: str = 'cuda',
                      world: int = SMOKE_WORLD) -> int:
    """``overlap_comm`` on against off on ``MLP((32,)*8 + (10,))``, a
    world of ``world`` ranks at fraction 0.5 (at least 4, so the
    deferred decomposition gather has a row of 2), factor 1, inv 2: the
    modeled exposed and hidden bytes, the in-band against deferred
    refresh timing, and on the card the side stream's concurrency."""
    features = (32,) * 9 + (10,)
    detail = _run_world_smoke('overlap', json_out, device, world, features)
    if detail is None:
        return 1
    ledger = detail['ledger']
    payload = {
        'metric': 'kfac_overlap_comm_smoke',
        'value': round(ledger['exposed_on_bytes']
                       / max(ledger['total_on_bytes'], 1e-12), 6),
        'unit': 'exposed_comm_fraction_overlap_on',
        'vs_baseline': round(ledger['exposed_off_bytes']
                             / max(ledger['total_off_bytes'], 1e-12), 6),
        'detail': {
            'model': f'MLP(32, (32,)*8 + (10,)) on a world of {world}, '
                     'hybrid (fraction=0.5), factor=1 inv=2',
            **detail,
            'policy': 'the ledger split is the modeled claim; the card '
                      'block is the side-stream concurrency the profiler '
                      'saw; the timing delta is measured',
        },
    }
    write_json_atomic(payload, json_out)
    print(f'wrote {json_out}')
    return validate_overlap_artifact(json_out)


def run_pipeline_smoke(json_out: str, device: str = 'cuda',
                       world: int = SMOKE_WORLD) -> int:
    """``pipeline_grads`` on against off on ``MLP((64, 64, 32, 32,
    10))``, a world of ``world`` ranks at fraction 0.5, factor 1, inv 2:
    the modeled per-bucket gather rows (only the cheapest, last, exposed),
    the LPT issue order, and on the card the pipelined precondition's
    time against the synchronous one."""
    features = (64, 64, 64, 32, 32, 10)
    detail = _run_world_smoke('pipeline', json_out, device, world, features)
    if detail is None:
        return 1
    ledger = detail['ledger']
    payload = {
        'metric': 'kfac_pipeline_grads_smoke',
        'value': round(ledger['exposed_on_bytes']
                       / max(ledger['total_on_bytes'], 1e-12), 6),
        'unit': 'exposed_comm_fraction_pipeline_on',
        'vs_baseline': round(ledger['exposed_off_bytes']
                             / max(ledger['total_off_bytes'], 1e-12), 6),
        'detail': {
            'model': f'MLP(64, (64, 64, 32, 32, 10)) on a world of {world}, '
                     'hybrid (fraction=0.5), factor=1 inv=2',
            **detail,
            'policy': 'the ledger split is the modeled claim; the '
                      'parity block holds the pipelined gradients to the '
                      'synchronous ones bit for bit; the card block times '
                      'both preconditions',
        },
    }
    write_json_atomic(payload, json_out)
    print(f'wrote {json_out}')
    return validate_pipeline_artifact(json_out)


# ----------------------------------------------------------------------
# --adaptive-smoke
# ----------------------------------------------------------------------


def _adaptive_replay(events, geometry, leg):
    """Re-derive the adaptive cadence contracts from the raw event trace
    ``(step, kind, shard, max_age)`` and the run geometry: the refresh
    count, each shard's refresh gaps against the staleness floor, and the
    per-interval budget cap.  Returns ``(problems, derived)``."""
    problems = []
    inv = int(geometry['inv_steps'])
    n_shards = int(geometry['n_shards'])
    steps = int(geometry['steps'])
    floor = int(geometry['staleness_factor']) * inv
    refresh_kinds = ('scheduled', 'early', 'forced')
    valid_kinds = refresh_kinds + ('full', 'skip')
    refreshes = skips = 0
    last_refresh = {k: None for k in range(n_shards)}
    interval_shards: dict[int, set] = {}
    for ev in events:
        if not (isinstance(ev, (list, tuple)) and len(ev) == 4):
            problems.append(f'{leg}: malformed event {ev!r}')
            return problems, None
        step, kind, shard, max_age = ev
        if kind not in valid_kinds:
            problems.append(f'{leg}: unknown event kind {kind!r}')
            continue
        if isinstance(max_age, (int, float)) and max_age > floor:
            problems.append(
                f'{leg}: staleness floor violated at step {step}: recorded '
                f'max shard age {max_age} > floor {floor} '
                f'({geometry["staleness_factor"]}x inv={inv})')
        if kind == 'full':
            for k in range(n_shards):
                last_refresh[k] = step
            continue
        if kind == 'skip':
            skips += 1
            continue
        refreshes += 1
        if shard is None or not 0 <= int(shard) < n_shards:
            problems.append(f'{leg}: refresh event at step {step} names '
                            f'invalid shard {shard!r}')
            continue
        shard = int(shard)
        prev = last_refresh[shard]
        if prev is not None and step - prev > floor:
            problems.append(
                f'{leg}: staleness floor violated: shard {shard} went '
                f'{step - prev} steps between refreshes (steps {prev} -> '
                f'{step}) > floor {floor}')
        last_refresh[shard] = step
        iv = step // inv
        seen = interval_shards.setdefault(iv, set())
        if shard in seen:
            problems.append(f'{leg}: budget cap violated: shard {shard} '
                            f'refreshed twice in interval {iv}')
        seen.add(shard)
    cap = min(n_shards, inv)
    for iv, seen in interval_shards.items():
        if len(seen) > cap:
            problems.append(f'{leg}: budget cap violated: {len(seen)} '
                            f'refreshes in interval {iv} > fixed-cadence '
                            f'work {cap}')
    # The fixed cadence's count over the same horizon: one shard per
    # opportunity step, the bootstrap (step 0) excluded.
    fixed = sum(1 for s in range(1, steps) if s % inv < n_shards)
    return problems, {'refreshes': refreshes, 'skips': skips,
                      'fixed': fixed}


def validate_adaptive_artifact(path: str) -> int:
    """Gate of an adaptive-smoke artifact, every number re-derived from
    the raw event traces (:func:`_adaptive_replay`): on the plateau a
    reduction of at least ``ADAPTIVE_MIN_REDUCTION`` with skips and loss
    parity; on the drift no more refreshes than the fixed cadence; on
    both the floor, the budget cap and counters consistent with the
    trace."""
    payload = _read(path, 'adaptive')
    if payload is None:
        return 1
    problems = []
    detail = payload.get('detail', {})
    derived = {}
    for leg in ('plateau', 'drifting'):
        block = detail.get(leg)
        if not isinstance(block, dict):
            problems.append(f'missing {leg} leg')
            continue
        geometry = block.get('geometry')
        events = (block.get('adaptive') or {}).get('events')
        if not isinstance(geometry, dict) or not isinstance(events, list) \
                or not events:
            problems.append(f'{leg}: geometry/events missing or empty')
            continue
        leg_problems, leg_derived = _adaptive_replay(events, geometry, leg)
        problems.extend(leg_problems)
        if leg_derived is None:
            continue
        derived[leg] = leg_derived
        claimed = (block.get('adaptive') or {}).get('refreshes')
        if claimed != leg_derived['refreshes']:
            problems.append(f'{leg}: claimed {claimed} refreshes but the '
                            'event trace replays to '
                            f'{leg_derived["refreshes"]}')
        counters = (block.get('adaptive') or {}).get('counters', {})
        counted = sum(counters.get(k, 0)
                      for k in ('early', 'forced', 'scheduled'))
        if counted != leg_derived['refreshes']:
            problems.append(f'{leg}: counters sum to {counted} refreshes but '
                            'the event trace replays to '
                            f'{leg_derived["refreshes"]}')
        if counters.get('skipped', 0) != leg_derived['skips']:
            problems.append(f'{leg}: skipped counter '
                            f'{counters.get("skipped")} disagrees with '
                            f'{leg_derived["skips"]} skip events')
        gap = block.get('final_loss_gap')
        if not _finite(gap):
            problems.append(f'{leg}: final_loss_gap missing: {gap!r}')
        elif gap > ADAPTIVE_PARITY_TOL:
            problems.append(f'{leg}: final-loss gap {gap} exceeds parity '
                            f'tolerance {ADAPTIVE_PARITY_TOL}')
    plateau = derived.get('plateau')
    if plateau is not None:
        if plateau['skips'] == 0:
            problems.append('plateau: zero skip events: the adaptive run '
                            'never coasted, so the reduction is vacuous')
        reduction = 1.0 - plateau['refreshes'] / max(plateau['fixed'], 1)
        if reduction < ADAPTIVE_MIN_REDUCTION:
            problems.append(f'plateau: replayed refresh reduction '
                            f'{reduction:.3f} below the '
                            f'{ADAPTIVE_MIN_REDUCTION:.0%} acceptance floor')
        claimed_value = payload.get('value')
        if not isinstance(claimed_value, (int, float)) or abs(
                claimed_value - reduction) > 0.005:
            problems.append(f'headline value {claimed_value!r} disagrees '
                            f'with the replayed reduction {reduction:.4f}')
    drifting = derived.get('drifting')
    if drifting is not None and drifting['refreshes'] > drifting['fixed']:
        problems.append(f'drifting: {drifting["refreshes"]} adaptive '
                        f'refreshes exceed the fixed cadence\'s '
                        f'{drifting["fixed"]}: the budget cap failed')
    if problems:
        for problem in problems:
            print(f'adaptive gate: {problem}')
        return 1
    print(f'adaptive gate: {path} OK (plateau {plateau["refreshes"]} vs '
          f'fixed {plateau["fixed"]} refreshes, {plateau["skips"]} skips; '
          f'drifting {drifting["refreshes"]} <= fixed {drifting["fixed"]})')
    return 0


def flax_init(model, seed: int):
    """``model``'s Linear layers initialized as Flax's ``Dense`` is
    (a truncated-normal ``lecun_normal`` kernel, zero bias), the JAX
    smoke's model: deep ReLU stacks under torch's default initialization
    shrink their activations about three times faster per layer."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / .87962566103423978
                w = torch.empty_like(m.weight)
                torch.nn.init.trunc_normal_(w, std=std, a=-2 * std,
                                            b=2 * std, generator=gen)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def run_adaptive_smoke(json_out: str, device: str = 'cuda') -> int:
    """The drift-adaptive refresh: savings on a plateauing stationary
    task (``bench.measure_adaptive_refresh``), the budget cap and the
    staleness floor on a drifting one (a memorized fixed batch), both
    with their event traces."""
    import torch
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.bench import measure_adaptive_refresh

    dev = _device(device)
    plateau = measure_adaptive_refresh(dev)
    geometry = dict(plateau['geometry'])
    inv, n_shards = geometry['inv_steps'], geometry['n_shards']
    drift_steps = 96
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn(128, 128, generator=gen, device=dev)
    y = torch.randint(0, 10, (128,), generator=gen, device=dev)

    def run(adaptive):
        model = flax_init(kt.models.MLP(128, (128,) * 8 + (10,)), 2).to(dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        p = kt.KFACPreconditioner(
            model, factor_update_steps=1, inv_update_steps=inv,
            damping=0.001, lr=0.05, stagger_refresh=n_shards,
            adaptive=adaptive)
        loop = p.train_loop(opt, F.cross_entropy)
        loss = None
        for _ in range(drift_steps):
            loss, _ = loop.step(x, loss_args=(y,))
        return p, float(loss)

    _, fixed_loss = run(None)
    adapt_p, adapt_loss = run(kt.AdaptiveRefreshConfig(
        geometry['threshold'], staleness_factor=geometry['staleness_factor'],
        record_events=True))
    ctl = adapt_p.adaptive_controller
    counters = ctl.counters()
    drifting = {
        'geometry': {**geometry, 'steps': drift_steps},
        'fixed': {
            'refreshes': sum(1 for s in range(1, drift_steps)
                             if s % inv < n_shards),
            'final_loss': round(fixed_loss, 6),
        },
        'adaptive': {
            'refreshes': (counters['early'] + counters['forced']
                          + counters['scheduled']),
            'counters': counters,
            'final_loss': round(adapt_loss, 6),
            'events': [[s, k, sh, age] for s, k, sh, age in ctl.events],
        },
        'final_loss_gap': round(abs(adapt_loss - fixed_loss), 6),
    }
    payload = {
        'metric': 'kfac_adaptive_refresh_savings_mlp_smoke',
        'value': plateau['refresh_reduction'],
        'unit': 'refresh_reduction_vs_fixed_cadence',
        'vs_baseline': ADAPTIVE_MIN_REDUCTION,
        'detail': {
            'plateau': plateau,
            'drifting': drifting,
            'device': dev.type,
            'policy': 'every contract re-derived from the raw event traces '
                      'by --validate-adaptive',
        },
    }
    write_json_atomic(payload, json_out)
    print(f'wrote {json_out}')
    return validate_adaptive_artifact(json_out)


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------

SMOKES = {
    'smoke': (run_smoke, 'profile_smoke.json'),
    'stagger_smoke': (run_stagger_smoke, 'stagger_smoke.json'),
    'iterative_smoke': (run_iterative_smoke, 'iterative_smoke.json'),
    'placement_smoke': (run_placement_smoke, 'placement_plan.json'),
    'overlap_smoke': (run_overlap_smoke, 'overlap_smoke.json'),
    'pipeline_smoke': (run_pipeline_smoke, 'pipeline_smoke.json'),
    'adaptive_smoke': (run_adaptive_smoke, 'adaptive_smoke.json'),
}
VALIDATORS = {
    'validate': validate_artifact,
    'validate_stagger': validate_stagger_artifact,
    'validate_iterative': validate_iterative_artifact,
    'validate_placement': validate_placement_artifact,
    'validate_overlap': validate_overlap_artifact,
    'validate_pipeline': validate_pipeline_artifact,
    'validate_adaptive': validate_adaptive_artifact,
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='where to run (default cuda; cuda without a card '
                         'raises)')
    ap.add_argument('--model', default='resnet50',
                    choices=sorted(VARIANT_CONFIGS))
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--lowrank', type=int, default=None,
                    help='profile with lowrank_rank=K instead of exact eigen')
    ap.add_argument('--method', default='eigen',
                    choices=['eigen', 'inverse', 'iterative'],
                    help='second-order compute method to profile')
    ap.add_argument('--ekfac', action='store_true',
                    help='profile with EKFAC scale re-estimation')
    ap.add_argument('--json-out', default=None,
                    help='write the artifact there (the smokes default to '
                         'logs/profile/<smoke>.json)')
    ap.add_argument('--world', type=int, default=SMOKE_WORLD,
                    help='world of the overlap and pipeline smokes')
    for name in SMOKES:
        ap.add_argument('--' + name.replace('_', '-'), action='store_true')
    for name in VALIDATORS:
        ap.add_argument('--' + name.replace('_', '-'), metavar='JSON')
    ap.add_argument('--overlap-child', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--pipeline-child', default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for kind in ('overlap', 'pipeline'):
        spec = getattr(args, f'{kind}_child')
        if spec is not None:
            _smoke_rank(kind, json.loads(spec))
            return 0
    for name, fn in VALIDATORS.items():
        if getattr(args, name):
            return fn(getattr(args, name))
    if args.lowrank is not None and args.method != 'eigen':
        ap.error('--lowrank requires --method eigen')
    if args.ekfac and (args.lowrank is not None or args.method != 'eigen'):
        ap.error('--ekfac requires exact eigen (no --lowrank/--method)')
    if args.device == 'cuda':
        import torch

        if not torch.cuda.is_available():
            ap.error('--device cuda needs a CUDA card; pass --device cpu to '
                     'run on the CPU')
    for name, (fn, default) in SMOKES.items():
        if getattr(args, name):
            out = args.json_out or os.path.join(REPO, 'logs', 'profile',
                                                default)
            kw = {'device': args.device}
            if name in ('overlap_smoke', 'pipeline_smoke'):
                kw['world'] = args.world
            return fn(out, **kw)
    run_variants(args.model, args.device, args.iters, method=args.method,
                 lowrank=args.lowrank, ekfac=args.ekfac,
                 json_out=args.json_out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
