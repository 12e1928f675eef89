"""The fused kernel as the custom op ``kfac_torch::fused_eigen_precond``.

On the CPU the op runs the plain chain, so ``fused_eigen_precondition``
through the op gives the plain version's bits; its fake implementation
gives ``FakeTensorMode`` and ``torch.compile`` the CPU output's shapes
and dtypes; ``torch.library.opcheck`` holds the registration (schema,
fake, no aliasing); the op traces with no graph break and counts its
four contractions under ``FlopCounterMode``; and the seeded inputs
agree with the JAX package's Pallas kernel (interpret mode) within
``tests/test_pallas.py``'s bar (``rtol 1e-5, atol 1e-4`` on ``pg``,
``rtol 1e-3`` on the clip terms).  The op on the card, eager and
compiled, is in ``tests/test_torch_kernel_cuda.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from kfac_pytorch_tpu.ops.pallas_precond import (
    fused_eigen_precondition as jax_fused,
)
from kfac_pytorch_tpu_torch.ops import fused_eigen_precond_op
from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition
from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition_reference

from test_torch_fused_precond import rand_inputs
from test_torch_fused_precond import torch_args
from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

#: A few of test_torch_fused_precond.py's shapes, gp above and below 64.
SHAPES = [(1, 32, 32), (3, 64, 128), (2, 128, 64), (2, 32, 320)]
DTYPES = [torch.float32, torch.bfloat16]


def _ids(v):
    return str(v).replace('torch.', '') if isinstance(v, torch.dtype) else None


def test_op_is_registered_under_its_name():
    packet = torch.ops.kfac_torch.fused_eigen_precond
    schema = str(packet.default._schema)
    assert schema.startswith('kfac_torch::fused_eigen_precond(Tensor g, '
                             'Tensor qa, Tensor qg, Tensor dgda)')
    assert schema.endswith('-> (Tensor, Tensor)')


@pytest.mark.parametrize('dtype', DTYPES, ids=_ids)
@pytest.mark.parametrize('L,gp,ap', SHAPES)
def test_opcheck_passes(L, gp, ap, dtype):
    args = torch_args(rand_inputs(L, gp, ap, seed=L + gp + ap), dtype)
    torch.library.opcheck(fused_eigen_precond_op, tuple(args))


@pytest.mark.parametrize('dtype', DTYPES, ids=_ids)
@pytest.mark.parametrize('L,gp,ap', SHAPES)
def test_fake_outputs_match_cpu_outputs(L, gp, ap, dtype):
    args = torch_args(rand_inputs(L, gp, ap, seed=L * gp), dtype)
    real = fused_eigen_precondition(*args)
    with FakeTensorMode() as mode:
        fake = fused_eigen_precondition(*[mode.from_tensor(a) for a in args])
    for r, f in zip(real, fake):
        assert type(f).__name__ == 'FakeTensor'
        assert (tuple(f.shape), f.dtype, f.device.type) == (
            tuple(r.shape), r.dtype, r.device.type)
    assert real[0].dtype == real[1].dtype == torch.float32


@pytest.mark.parametrize('dtype', DTYPES, ids=_ids)
@pytest.mark.parametrize('L,gp,ap', SHAPES)
def test_op_gives_the_plain_versions_bits_on_cpu(L, gp, ap, dtype):
    args = torch_args(rand_inputs(L, gp, ap, seed=3 * L + ap), dtype)
    before = fused_eigen_precondition.launches
    pg, clip = fused_eigen_precondition(*args)
    want_pg, want_clip = fused_eigen_precondition_reference(*args)
    assert torch.equal(pg, want_pg) and torch.equal(clip, want_clip)
    # A CPU call runs the plain version: no kernel launch is counted.
    assert fused_eigen_precondition.launches == before


@pytest.mark.parametrize('L,gp,ap', SHAPES)
def test_op_matches_the_jax_kernel(L, gp, ap):
    arrays = rand_inputs(L, gp, ap, seed=L * gp + ap)
    want_pg, want_clip = jax_fused(*[jnp.asarray(a) for a in arrays],
                                   interpret=True)
    pg, clip = fused_eigen_precondition(*torch_args(arrays))
    np.testing.assert_allclose(pg.numpy(), np.asarray(want_pg),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(clip.numpy(), np.asarray(want_clip),
                               rtol=1e-3)


def test_op_compiles_with_no_graph_break():
    import torch._dynamo

    args = torch_args(rand_inputs(2, 64, 128, seed=7))

    def tail(g, qa, qg, dgda, lr):
        pg, clip = fused_eigen_precondition(g, qa, qg, dgda)
        return pg * torch.sum(clip) * lr ** 2

    lr = torch.tensor(0.1, dtype=torch.float32)
    torch._dynamo.reset()
    try:
        explained = torch._dynamo.explain(tail)(*args, lr)
        assert explained.graph_break_count == 0
        assert explained.graph_count == 1
        compiled = torch.compile(tail, fullgraph=True, backend='eager')
        np.testing.assert_allclose(compiled(*args, lr).numpy(),
                                   tail(*args, lr).numpy(), rtol=1e-6)
    finally:
        torch._dynamo.reset()


def test_flop_counter_counts_the_four_contractions():
    from torch.utils.flop_counter import FlopCounterMode

    L, gp, ap = 3, 64, 128
    args = torch_args(rand_inputs(L, gp, ap, seed=1))
    with FlopCounterMode(display=False) as counter:
        fused_eigen_precondition(*args)
    assert counter.get_total_flops() == (
        4 * L * gp * ap * (gp + ap) + 3 * L * gp * ap)


def test_wrapper_checks_before_the_op():
    g, qa, qg, dgda = torch_args(rand_inputs(2, 32, 64, seed=2))
    with pytest.raises(ValueError, match='qa must have shape'):
        fused_eigen_precondition(g, qa[:, :32, :32], qg, dgda)
    with pytest.raises(TypeError, match='operands share one dtype'):
        fused_eigen_precondition(g, qa.double(), qg, dgda)
    meta = [t.to('meta') for t in (g, qa, qg, dgda)]
    with pytest.raises(ValueError, match='unsupported device'):
        fused_eigen_precondition(*meta)
