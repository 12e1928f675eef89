"""The CUDA kernel against its plain version, on the card.

Needs an NVIDIA card with ``nvcc`` (``sm_90a``); skips without one.
Imports nothing of JAX, so on a machine without JAX it runs as::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

Tolerance: f32 at ``tests/test_pallas.py``'s bar (``rtol 1e-5, atol
1e-4``) for orthonormal eigenbases, where every intermediate is O(1)
and the two sides differ only in summation order; clips bitwise equal
across two runs (the kernel sums without atomics).
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


@pytest.mark.parametrize(
    'L,gp,ap', [(9, 64, 576), (1, 32, 32), (3, 40, 70)],
)
def test_kernel_matches_plain_on_card(L, gp, ap):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(L, gp, ap, 'cuda', seed=L + gp + ap)
    before = fused_eigen_precondition.launches
    pg, clip = fused_eigen_precondition(*args)
    pg2, clip2 = fused_eigen_precondition(*args)
    torch.cuda.synchronize()
    assert fused_eigen_precondition.launches == before + 2
    want_pg, want_clip = fused_eigen_precondition_reference(*args)
    torch.testing.assert_close(pg, want_pg, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(clip, want_clip, rtol=1e-5, atol=1e-3)
    assert torch.equal(clip, clip2) and torch.equal(pg, pg2)
