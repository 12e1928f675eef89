"""The CUDA kernel against its plain version, on the card.

Needs an NVIDIA card with ``nvcc`` (``sm_90a``); skips without one.
Imports nothing of JAX, so on a machine without JAX it runs as::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

Tolerance: f32 at ``tests/test_pallas.py``'s bar (``rtol 1e-5, atol
1e-4``) for orthonormal eigenbases, where every intermediate is O(1)
and the two sides differ only in summation order; clips bitwise equal
across two runs (the kernel sums without atomics); bf16 operands
within a mean relative error of 1e-3 of the plain bf16 chain.  Under a
quarantine mask (the health guardrails and the consistency guard) the
sharded entry point substitutes the identity after the kernel: the
quarantined slots are the raw gradient bit for bit.  A step after a
streaming restore runs the kernel on the restored stacks with no
``eigh``, bitwise the uninterrupted run.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition
from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition_reference

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]


def _inputs(L, gp, ap, device, seed=0):
    rng = np.random.default_rng(seed)

    def orth(n):
        return np.linalg.qr(rng.normal(size=(L, n, n)))[0]

    arrays = [
        rng.normal(size=(L, gp, ap)), orth(ap), orth(gp),
        rng.uniform(0.1, 1.0, size=(L, gp, ap)),
    ]
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


#: ResNet-32's six bucket stacks at full L, two shapes whose rows are
#: not 16-byte multiples (the masked copy path), and one that takes the
#: large-gp tiling (four launches); bf16 at two of them.  Then GPT-125M's
#: five bucket stacks under full coverage (all large-gp), bf16 at two.
#: Then ImageNet ResNet-50's 21 bucket stacks, bf16 at two.  Then two
#: of BERT-large's: ``qa_head`` (``a1152g32``, the two-launch narrow path
#: at ``ap`` 1152) and ``fc_out`` (``a4224g1024``, at L=2), bf16 at the
#: first.  Then the MoE flavour's stacks at Switch-Base-8 widths (the
#: expert stacks ``[8, 3072, 769]`` and ``[8, 768, 3073]``, the dense
#: layers as stacks of one) and the GPipe flavour's stage layers at
#: GPT-125M widths, unpadded (``ap`` 769 and 3073: the unaligned load
#: path), bf16 at two.
CASES = [
    (9, 64, 576, 'f32'), (1, 64, 320, 'f32'), (9, 32, 320, 'f32'),
    (11, 32, 192, 'f32'), (1, 32, 128, 'f32'), (1, 32, 32, 'f32'),
    (3, 40, 70, 'f32'), (2, 33, 100, 'f32'), (2, 256, 1152, 'f32'),
    (9, 64, 576, 'bf16'), (2, 33, 100, 'bf16'),
    (12, 768, 3200, 'f32'), (12, 3072, 896, 'f32'), (12, 2304, 896, 'f32'),
    (12, 768, 896, 'f32'), (25, 768, 32, 'f32'),
    (12, 3072, 896, 'bf16'), (25, 768, 32, 'bf16'),
    (3, 512, 4608, 'f32'), (6, 256, 2304, 'f32'), (1, 1024, 2176, 'f32'),
    (1, 2048, 1024, 'f32'), (2, 512, 2048, 'f32'), (3, 2048, 512, 'f32'),
    (4, 128, 1152, 'f32'), (1, 512, 1024, 'f32'), (1, 1024, 512, 'f32'),
    (5, 256, 1024, 'f32'), (6, 1024, 256, 'f32'), (3, 64, 576, 'f32'),
    (1, 256, 512, 'f32'), (1, 512, 256, 'f32'), (3, 128, 512, 'f32'),
    (4, 512, 128, 'f32'), (1, 128, 256, 'f32'), (2, 64, 256, 'f32'),
    (4, 256, 64, 'f32'), (1, 64, 192, 'f32'), (1, 64, 64, 'f32'),
    (3, 512, 4608, 'bf16'), (4, 256, 64, 'bf16'),
    (1, 32, 1152, 'f32'), (2, 1024, 4224, 'f32'), (1, 32, 1152, 'bf16'),
    (8, 3072, 769, 'f32'), (8, 768, 3073, 'f32'), (1, 768, 769, 'f32'),
    (1, 8, 768, 'f32'), (1, 8, 769, 'f32'), (1, 2304, 769, 'f32'),
    (1, 3072, 769, 'f32'), (1, 768, 3073, 'f32'), (8, 3072, 769, 'bf16'),
    (1, 768, 3073, 'bf16'),
]


@pytest.mark.parametrize('L,gp,ap,dtype', CASES)
def test_kernel_matches_plain_on_card(L, gp, ap, dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(L, gp, ap, 'cuda', seed=L + gp + ap)
    if dtype == 'bf16':
        args = [a.to(torch.bfloat16) for a in args]
    before = fused_eigen_precondition.launches
    pg, clip = fused_eigen_precondition(*args)
    pg2, clip2 = fused_eigen_precondition(*args)
    torch.cuda.synchronize()
    assert fused_eigen_precondition.launches == before + 2
    want_pg, want_clip = fused_eigen_precondition_reference(*args)
    assert torch.equal(clip, clip2) and torch.equal(pg, pg2)
    if dtype == 'bf16':
        # Against the plain bf16 chain (v2 rounded at the same point).
        err = (pg - want_pg).abs().mean() / want_pg.abs().mean()
        assert float(err) < 1e-3
        return
    torch.testing.assert_close(pg, want_pg, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(clip, want_clip, rtol=1e-5, atol=1e-3)


#: ResNet-32's six bucket stacks, f32 and bf16, for the quarantine
#: substitution behind the kernel.
QUARANTINE_CASES = [
    (9, 64, 576), (1, 64, 320), (9, 32, 320), (11, 32, 192), (1, 32, 128),
    (1, 32, 32),
]


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('L,gp,ap', QUARANTINE_CASES)
def test_kernel_with_quarantine_matches_plain_on_card(L, gp, ap, dtype):
    """The sharded entry point (no gather on one rank) with a quarantine
    mask: the kernel, then the identity substitution on its output,
    against the plain chain with the same mask.  Quarantined slots are
    the f32 gradient bit for bit, with the clip term ``<g, g>``; the
    other slots are the kernel's own output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition_sharded
    from kfac_pytorch_tpu_torch.ops import (
        fused_eigen_precondition_sharded_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(L, gp, ap, 'cuda', seed=L + gp + ap + 1)
    raw = args[0]
    if dtype == 'bf16':
        args = [a.to(torch.bfloat16) for a in args]
    mask = torch.zeros(L, dtype=torch.bool, device='cuda')
    mask[::2] = True
    before = fused_eigen_precondition.launches
    pg, clip = fused_eigen_precondition_sharded(*args, quarantined=mask,
                                                raw=raw)
    torch.cuda.synchronize()
    assert fused_eigen_precondition.launches == before + 1
    kpg, kclip = fused_eigen_precondition(*args)
    want_pg, want_clip = fused_eigen_precondition_sharded_reference(
        *args, quarantined=mask, raw=raw)
    q = mask.cpu()
    assert torch.equal(pg[q], raw[q])
    assert torch.equal(clip[q], torch.sum(raw * raw, dim=(1, 2))[q])
    assert torch.equal(pg[~q], kpg[~q]) and torch.equal(clip[~q], kclip[~q])
    if dtype == 'bf16':
        err = (pg - want_pg).abs().mean() / want_pg.abs().mean()
        assert float(err) < 1e-3
        return
    torch.testing.assert_close(pg, want_pg, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(clip, want_clip, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_health_verdict_on_card(dtype):
    """The step verdict's fused reduction (``torch._foreach_norm`` with
    ``ord=inf`` over ResNet-50-like tensor sizes) on CUDA tensors: a NaN
    or an infinity in any one tensor, at any position, fails it (the
    multi-tensor kernel propagates NaN into the max), and the zeroing
    select is bitwise where the verdict passes."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from kfac_pytorch_tpu_torch import health

    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    sizes = [(64, 3, 7, 7), (64,), (256, 64, 1, 1), (1000, 2048), (1000,),
             (512, 512, 3, 3), (7,), (1,)]
    tensors = [torch.randn(s, generator=gen, device='cuda').to(dtype)
               for s in sizes]
    ok = health.tree_all_finite(tensors)
    assert bool(ok)
    zeroed = health.zero_unless(ok, tensors)
    assert all(torch.equal(a, b) for a, b in zip(zeroed, tensors))
    for k in range(len(sizes)):
        for value in (float('nan'), float('inf'), float('-inf')):
            bad = [t.clone() for t in tensors]
            flat = bad[k].view(-1)
            flat[(k * 7919) % flat.numel()] = value
            verdict = health.tree_all_finite(bad)
            assert not bool(verdict), (k, value)
            assert all(float(t.abs().sum()) == 0.0
                       for t in health.zero_unless(verdict, bad))


def test_restore_then_step_on_card(tmp_path):
    """A streaming generation (``elastic.save_streaming``) restored into a
    fresh LeNet engine on the card installs the saved stacks with no
    ``eigh``; the next step launches the kernel once per bucket that keeps
    ``dgda``, gives the uninterrupted run's preconditioned gradients bit
    for bit, and the kernel on the restored stacks matches its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _restore_then_step(tmp_path)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _restore_then_step(tmp_path):
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch import elastic
    from kfac_pytorch_tpu_torch.models import LeNet

    hp = dict(factor_update_steps=1, inv_update_steps=3, damping=0.003,
              kl_clip=0.001, lr=0.1)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    x = torch.randn(16, 1, 12, 12, generator=gen, device='cuda')
    y = torch.randint(0, 10, (16,), generator=gen, device='cuda')

    def engine(seed):
        torch.manual_seed(seed)
        model = LeNet(image_size=12).cuda()
        return model, kt.KFACPreconditioner(model, **hp)

    def step(model, precond):
        model.zero_grad()
        F.cross_entropy(model(x), y).backward()
        precond.step()
        return [p.grad.clone() for p in model.parameters()]

    model, precond = engine(0)
    for _ in range(4):
        step(model, precond)
    elastic.save_streaming(str(tmp_path), precond)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    want = step(model, precond)
    model, fresh = engine(1)
    model.load_state_dict(weights)
    calls = []
    real = torch.linalg.eigh
    torch.linalg.eigh = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        info = elastic.restore_streaming(str(tmp_path), fresh)
        before = fused_eigen_precondition.launches
        got = step(model, fresh)
    finally:
        torch.linalg.eigh = real
    launched = fused_eigen_precondition.launches - before
    assert not calls and info['decompositions_installed']
    so = fresh._second_order
    assert launched == sum(so.bucket_prediv(b.key)
                           for b in fresh.plan.buckets) > 0
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    for b in fresh.plan.buckets:
        bs = fresh.buckets[b.key]
        if bs.dgda is None:
            continue
        g = torch.randn(bs.dgda.shape, generator=gen, device='cuda')
        pg, clip = fused_eigen_precondition(g, bs.qa, bs.qg, bs.dgda)
        want_pg, want_clip = fused_eigen_precondition_reference(
            g, bs.qa, bs.qg, bs.dgda)
        torch.testing.assert_close(pg, want_pg, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(clip, want_clip, rtol=1e-5, atol=1e-3)


def kernel_ranges(trace_path, prefix='kfac/'):
    """``[(kernel name, [enclosing range names])]`` of every CUDA kernel in
    a ``torch.profiler`` chrome trace: a kernel is inside a
    ``record_function`` range when the host call that launched it (the
    CUDA API event of the same correlation id) falls inside the range on
    the same thread."""
    import json

    with open(trace_path) as fh:
        events = json.load(fh)['traceEvents']
    ranges = [e for e in events if e.get('cat') == 'user_annotation'
              and e.get('name', '').startswith(prefix)]
    launches = {e['args']['correlation']: e for e in events
                if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                and 'correlation' in e.get('args', {})}
    out = []
    for k in events:
        if k.get('cat') != 'kernel':
            continue
        host = launches.get(k.get('args', {}).get('correlation'))
        inside = [] if host is None else [
            r['name'] for r in ranges
            if r['tid'] == host['tid'] and r['pid'] == host['pid']
            and r['ts'] <= host['ts'] <= r['ts'] + r['dur']]
        out.append((k['name'], inside))
    return out


def test_observed_step_on_card(tmp_path):
    """One observed step (``ObserveConfig(monitor=True, annotate=True)``)
    of LeNet on the card: ``observe/kl_nu`` equals the kl-clip scale of
    the plain version on the same stacks and gradients (relative 1e-5),
    and every fused-kernel launch of the step falls inside the
    ``kfac/precondition`` range of the profiler trace."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch import ops
    from kfac_pytorch_tpu_torch.models import LeNet
    from kfac_pytorch_tpu_torch.observe import ObserveConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = LeNet(image_size=12).cuda()
    precond = kt.KFACPreconditioner(
        model, observe=ObserveConfig(monitor=True, annotate=True),
        factor_update_steps=1, inv_update_steps=3, damping=0.003,
        kl_clip=0.001, lr=0.1)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    x = torch.randn(16, 1, 12, 12, generator=gen, device='cuda')
    y = torch.randint(0, 10, (16,), generator=gen, device='cuda')
    for _ in range(2):
        model.zero_grad()
        F.cross_entropy(model(x), y).backward()
        precond.step()
    model.zero_grad()
    F.cross_entropy(model(x), y).backward()
    raw = {n: h.get_grad().clone() for n, h in precond.helpers.items()}
    before = fused_eigen_precondition.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        precond.step()
        torch.cuda.synchronize()
    launches = fused_eigen_precondition.launches - before
    so = precond._second_order
    terms = []
    for b in precond.plan.buckets:
        bs = precond.buckets[b.key]
        g = so._grad_stack(b, raw).contiguous()
        _, clip = fused_eigen_precondition_reference(g, bs.qa, bs.qg, bs.dgda)
        terms.append(torch.sum(clip) * 0.1 ** 2)
    scale = float(ops.kl_clip_scale(terms, 0.001))
    nu = float(precond.last_step_info['observe/kl_nu'])
    assert abs(nu - scale) <= 1e-5 * abs(scale), (nu, scale)
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    fused = [inside for name, inside in kernel_ranges(path)
             if 'precond_' in name or 'wide_pass' in name]
    assert launches == len(precond.plan.buckets)
    assert fused and all('kfac/precondition' in r for r in fused), fused


def test_symmetric_eigh_near_identity_on_card():
    """Factors within ~1e-9 of a multiple of the identity (a factor EMA in
    its first steps from the identity seed), beside a well-spread one:
    ``ops.symmetric_eigh`` gives the float64 spectrum to 1e-5 of its
    scale, an eigen-residual under 1e-4 and orthonormal eigenvectors
    (1e-3) for every matrix, where cuSOLVER's plain f32 ``eigh`` returned
    an eigenvalue of 165 for 0.698 on the ResNet-50 factor these stand
    for (a failed one is redone shifted); the spread matrix keeps the
    plain decomposition bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the check runs on CUDA tensors')
    from kfac_pytorch_tpu_torch import ops

    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    n = 1024
    r = torch.randn(4, n, 8, generator=gen, device='cuda')
    m = 0.6983372 * torch.eye(n, device='cuda') + 1e-9 * (r @ r.mT)
    w = torch.randn(n, n, generator=gen, device='cuda')
    m[3] = w @ w.mT / n + 1e-3 * torch.eye(n, device='cuda')
    d, q = ops.symmetric_eigh(m)
    want = torch.linalg.eigvalsh(m.double())
    eye = torch.eye(n, device='cuda')
    scale = want.abs().amax(-1)
    assert bool(((d.double() - want).abs().amax(-1) <= 1e-5 * scale).all())
    resid = (m @ q - q * d[:, None, :]).abs().amax(dim=(1, 2))
    assert bool((resid < 1e-4 * scale.float()).all())
    assert float((q.mT @ q - eye).abs().max()) < 1e-3
    d0, q0 = torch.linalg.eigh(m)
    assert torch.equal(d[3], d0[3]) and torch.equal(q[3], q0[3])


def test_flavours_on_card():
    """The MoE and GPipe flavours (one process, tiny widths) on the card
    against the same run on the CPU: the fused kernel launched once a
    layer a step, the losses and preconditioned gradients within 1e-4
    relative (cuSOLVER against LAPACK on identity-seeded factors)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch.gpt import MoEKFACPreconditioner
    from kfac_pytorch_tpu_torch.gpt import PipelineKFACPreconditioner
    from kfac_pytorch_tpu_torch.models.moe import MoEConfig
    from kfac_pytorch_tpu_torch.models.moe import tiny_moe_model
    from kfac_pytorch_tpu_torch.models.pipeline import PipeLMConfig
    from kfac_pytorch_tpu_torch.models.pipeline import pipeline_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    hp = dict(factor_update_steps=1, inv_update_steps=1, damping=0.003)

    # Built on the CPU and copied: the card's generator draws other
    # weights.
    def moe(device):
        model = tiny_moe_model(MoEConfig(4, 16, 32), 12,
                               device='cpu').to(device)
        x = torch.randn(8, 6, 12, generator=torch.Generator().manual_seed(1))
        y = torch.arange(8) % 8
        return model, MoEKFACPreconditioner(
            model, lambda o, t: F.cross_entropy(o[0], t) + 0.01 * o[1],
            **hp), (x.to(device),), (y.to(device),)

    def pipe(device):
        model = pipeline_lm(PipeLMConfig(n_stages=2, max_seq_len=16),
                            device='cpu').to(device)
        tok = torch.arange(64).reshape(4, 16) % 256
        return model, PipelineKFACPreconditioner(
            model, lambda o, t: F.cross_entropy(o.reshape(-1, 256),
                                                t.reshape(-1)),
            n_microbatches=2, **hp), (tok.to(device),), (tok.to(device),)

    for build in (moe, pipe):
        out = {}
        for device in ('cpu', 'cuda'):
            model, precond, args, loss_args = build(device)
            fused_eigen_precondition.launches = 0
            loss = precond.step(*args, loss_args=loss_args)
            out[device] = (float(loss), {n: p.grad.cpu() for n, p in
                                         model.named_parameters()},
                           fused_eigen_precondition.launches)
        assert out['cuda'][2] == len(precond.layers)
        assert abs(out['cuda'][0] - out['cpu'][0]) <= 1e-5
        for n, g in out['cpu'][1].items():
            err = float((out['cuda'][1][n] - g).norm() / g.norm())
            assert err <= 1e-4, (build.__name__, n, err)


@pytest.mark.parametrize('L,gp,ap', [(9, 64, 576), (2, 256, 1152),
                                     (3, 512, 4608)])
def test_custom_op_compiled_matches_eager_kernel_on_card(L, gp, ap):
    """The kernel through ``kfac_torch::fused_eigen_precond`` under
    ``torch.compile(fullgraph=True)`` (Inductor): the eager kernel's
    output within the gate, one counted launch a call."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    from torch import _dynamo

    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(L, gp, ap, 'cuda', seed=L * gp + ap)
    lr = torch.tensor(0.1, dtype=torch.float32, device='cuda')

    def tail(g, qa, qg, dgda, lr):
        pg, clip = fused_eigen_precondition(g, qa, qg, dgda)
        return pg, torch.sum(clip) * lr ** 2

    _dynamo.reset()
    try:
        compiled = torch.compile(tail, fullgraph=True)
        want = tail(*args, lr)
        before = fused_eigen_precondition.launches
        got = compiled(*args, lr)
        got = compiled(*args, lr)
        torch.cuda.synchronize()
        assert fused_eigen_precondition.launches - before == 2
    finally:
        _dynamo.reset()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=1e-5)


def test_plain_steps_have_no_host_sync_on_card():
    """JAX's transfer-guard pin in torch: after a warm-up cycle, the
    ``plain`` steps of a LeNet engine run under
    ``torch.cuda.set_sync_debug_mode('error')`` (any synchronizing CUDA
    call raises), with a per-step lr schedule, so every step makes a new
    canonical scalar."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import torch.nn.functional as F

    import kfac_pytorch_tpu_torch as kt
    from kfac_pytorch_tpu_torch.models import LeNet

    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    x = torch.randn(16, 1, 12, 12, generator=gen, device='cuda')
    y = torch.randint(0, 10, (16,), generator=gen, device='cuda')
    torch.manual_seed(0)
    model = LeNet(image_size=12).cuda()
    precond = kt.KFACPreconditioner(model, factor_update_steps=4,
                                    inv_update_steps=8,
                                    lr=lambda s: 0.1 / (1 + s))

    def step():
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(x), y).backward()
        precond.step()

    for _ in range(9):
        step()
    assert precond.steps % 4 == 1
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(3):  # plain steps 9, 10, 11
            step()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert precond.steps == 12
