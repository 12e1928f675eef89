"""The port's static gate: the torch lint, the trace contracts, the SPMD
lint (JAX ``scripts/lint_jax.py``).

``--check PATH [PATH ...]``
    The AST lint (:mod:`kfac_pytorch_tpu_torch.analysis.lint`) over files
    or directory trees.  Pure AST: run by path (``python
    kfac_pytorch_tpu_torch/scripts/lint_torch.py --check ...``) it
    imports neither torch nor the package it lints.  Exit 1 on findings;
    a deliberate one takes a same-line ``# torchlint: allow(<rule>)
    <reason>`` pragma.

``--contracts``
    The fake-tensor dry run of every step variant
    (:mod:`kfac_pytorch_tpu_torch.analysis.contracts`) on the CPU: a
    small MLP's default, replicated, inverse, non-prediv, staggered,
    overlap and consistency engines, ResNet-50 at full width built on
    fake tensors, the default-off observe parity pin, and the
    precondition tail's graph breaks.  Nothing is allocated at model
    size; the pass takes seconds.

``--spmd [PATH ...]``
    The SPMD collective lint (:mod:`kfac_pytorch_tpu_torch.analysis.\
collective`); defaults to the whole package.

``--comm-audit OUT.json [--device cpu|cuda]``
    The collective audit (:mod:`kfac_pytorch_tpu_torch.analysis.audit`):
    8 gloo ranks (JAX's world; on ``cuda`` they share card 0) run JAX's
    14 lanes and record every collective; the payload is written to
    ``OUT.json`` and printed as a table.  Exit 1 on a violation.

``--comm-audit-validate PATH [--baseline PATH]``
    Re-check a payload from its stored entries (digests, rank schedules,
    wire dtypes, parity, pins); with ``--baseline`` also the memory
    drift gate.  Exit 1 on an error.

``--list-rules``
    The rule ids and one-line descriptions.

Run it as ``python -m kfac_pytorch_tpu_torch.scripts.lint_torch`` or by
path.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.dirname(HERE)
ANALYSIS = os.path.join(PACKAGE, 'analysis')
_STANDALONE = '_kfac_torch_analysis'


def _analysis_module(name: str) -> types.ModuleType:
    """``analysis/<name>.py``, loaded without importing the package (and
    so without torch) when the package is not imported already: the
    analysis directory becomes a package of its own name."""
    if 'kfac_pytorch_tpu_torch' in sys.modules:
        return importlib.import_module(f'kfac_pytorch_tpu_torch.analysis.'
                                       f'{name}')
    if _STANDALONE not in sys.modules:
        pkg = types.ModuleType(_STANDALONE)
        pkg.__path__ = [ANALYSIS]
        sys.modules[_STANDALONE] = pkg
    return importlib.import_module(f'{_STANDALONE}.{name}')


def run_check(paths: list[str]) -> int:
    lint = _analysis_module('lint')
    findings = lint.lint_paths(paths)
    for f in findings:
        print(f.format())
    if findings:
        print(f'{len(findings)} finding(s). Deliberate? annotate the line '
              'with  # torchlint: allow(<rule>) <reason>')
        return 1
    print(f'torchlint: clean ({", ".join(paths)})')
    return 0


def run_spmd(paths: list[str]) -> int:
    collective = _analysis_module('collective')
    findings = collective.lint_paths(paths or [PACKAGE])
    for f in findings:
        print(f.format())
    if findings:
        print(f'{len(findings)} SPMD finding(s)')
        return 1
    print(f'spmd-lint: clean ({", ".join(paths or [PACKAGE])})')
    return 0


def run_list_rules() -> int:
    rules = dict(_analysis_module('lint').RULES)
    rules.update(_analysis_module('collective').SPMD_RULES)
    width = max(len(r) for r in rules)
    for rule, desc in rules.items():
        print(f'{rule:<{width}}  {desc}')
    return 0


def run_contracts() -> int:
    import time

    import torch
    import torch.nn.functional as F
    from torch._subclasses.fake_tensor import FakeTensorMode

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.analysis import contracts
    from kfac_pytorch_tpu_torch.models import TinyModel
    from kfac_pytorch_tpu_torch.models.resnet import ResNet
    from kfac_pytorch_tpu_torch.observe import ObserveConfig

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 10, generator=gen)
    y = torch.randint(0, 10, (8,), generator=gen)

    def setup(**kw):
        torch.manual_seed(2)
        return kt.KFACPreconditioner(
            TinyModel(hidden=20, out=10), damping=1e-3, lr=0.1,
            factor_update_steps=1, inv_update_steps=2, **kw)

    configs = {
        'default (bucketed eigen, prediv)': {},
        'replicated (bucketed=False)': {'bucketed': False},
        'inverse method': {'compute_method': 'inverse'},
        'no prediv': {'compute_eigenvalue_outer_product': False},
        'staggered refresh (K=2)': {'stagger_refresh': 2},
        'deferred refresh (overlap_comm)': {'overlap_comm': True},
        'consistency guard': {'consistency': kt.ConsistencyConfig()},
    }
    rc = 0
    sigs = {}
    for name, kw in configs.items():
        try:
            sigs[name] = contracts.validate_engine(
                setup(**kw), (x,), (y,), loss_fn=F.cross_entropy)
            print(f'contracts OK: {name} ({len(sigs[name])} step variants)')
        except contracts.ContractError as e:
            print(f'contracts FAILED: {name}\n{e}')
            rc = 1

    seed = sigs.get('default (bucketed eigen, prediv)')
    if seed is not None:
        off = contracts.step_signatures(
            setup(observe=ObserveConfig(monitor=False, annotate=False,
                                        timeline=False)),
            (x,), (y,), loss_fn=F.cross_entropy)
        diffs = contracts.parity_diffs(seed, off)
        if diffs:
            rc = 1
            print('parity FAILED: observability off traces other '
                  f'signatures: {sorted(diffs)}')
        else:
            print('parity OK: observability off == the seed signatures')

    t0 = time.perf_counter()
    with FakeTensorMode():
        model = ResNet((3, 4, 6, 3), num_classes=1000)
        precond = kt.KFACPreconditioner(model, factor_update_steps=10,
                                        inv_update_steps=100)
        images = torch.empty(32, 3, 224, 224)
        labels = torch.zeros(32, dtype=torch.long)
    try:
        out = contracts.validate_engine(precond, (images,), (labels,),
                                        loss_fn=F.cross_entropy)
        print(f'contracts OK: ResNet-50 b32 224x224 on fake tensors '
              f'({len(out)} step variants, {len(precond.plan.buckets)} '
              f'buckets, {time.perf_counter() - t0:.1f} s)')
    except contracts.ContractError as e:
        print(f'contracts FAILED: ResNet-50\n{e}')
        rc = 1
    breaks = contracts.tail_graph_breaks(precond)
    print(f'graph breaks of the ResNet-50 precondition tail: {breaks}')
    if breaks:
        rc = 1
    return rc


def run_comm_audit(out: str, device: str) -> int:
    import json

    from kfac_pytorch_tpu_torch.analysis import audit

    payload = audit.run_audit(device=device)
    with open(out, 'w') as fh:
        json.dump(payload, fh)
    print(audit.format_payload(payload))
    return 0 if payload['verified'] else 1


def run_comm_audit_validate(path: str, baseline: str | None) -> int:
    import json

    from kfac_pytorch_tpu_torch.analysis import audit

    with open(path) as fh:
        payload = json.load(fh)
    base = None
    if baseline is not None:
        with open(baseline) as fh:
            base = json.load(fh)
    errs = audit.check_payload(payload, base)
    for e in errs:
        print(e)
    print(f'comm-audit: {"valid" if not errs else f"{len(errs)} error(s)"} '
          f'({path})')
    return 1 if errs else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument('--check', nargs='+', metavar='PATH',
                      help='AST lint of files / directory trees')
    mode.add_argument('--contracts', action='store_true',
                      help='fake-tensor dry run of every step variant')
    mode.add_argument('--spmd', nargs='*', metavar='PATH',
                      help='SPMD collective lint (default: the package)')
    mode.add_argument('--list-rules', action='store_true',
                      help='print the rule ids')
    mode.add_argument('--comm-audit', metavar='OUT',
                      help='record the collectives of every audit lane')
    mode.add_argument('--comm-audit-validate', metavar='PATH',
                      help='re-check a collective audit payload')
    ap.add_argument('--device', default='cpu',
                    help="the audit ranks' device: cpu (default) or cuda")
    ap.add_argument('--baseline', default=None,
                    help='a payload to hold peak memory against')
    args = ap.parse_args(argv)
    if args.comm_audit:
        return run_comm_audit(args.comm_audit, args.device)
    if args.comm_audit_validate:
        return run_comm_audit_validate(args.comm_audit_validate,
                                       args.baseline)
    if args.check:
        return run_check(args.check)
    if args.spmd is not None:
        return run_spmd(args.spmd)
    if args.list_rules:
        return run_list_rules()
    return run_contracts()


if __name__ == '__main__':
    sys.exit(main())
