"""The port's ring attention against the JAX package's, on the CPU.

* The single-block path (``links=None``) against JAX's ``seq_axis=None``
  path, causal and not: the output and the gradients of ``q``, ``k`` and
  ``v`` under a fixed cotangent, ``atol 2e-5`` (``tests/test_gpt.py``'s
  bar).
* Four gloo ranks (subprocesses of this file, no JAX) ring over a
  sequence group of 4, against JAX's ring on a ``('seq',)`` mesh of 4
  devices: each rank's output shard and its shards' gradients, causal
  and not, ``atol 2e-5``; the ``batch_isend_irecv`` hand-off that NCCL
  takes (driven over gloo on CPU tensors, ``dist.get_backend`` patched
  while the links are built) bitwise the pair-group broadcasts', with
  the same bytes handed on.
* The ring GPT (``gpt_tiny(attention_impl='ring', seq_axis='seq')``,
  each rank a quarter of the tokens) against JAX's ring model on the
  same mesh from the same weights: logits ``atol 1e-5``.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict  # noqa
from kfac_pytorch_tpu_torch.models import gpt_tiny  # noqa: E402
from kfac_pytorch_tpu_torch.parallel import ring_attention as ra  # noqa
from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

WORLD = 4
SHAPE = (2, 32, 2, 8)  # [B, T, H, D]
TOKENS = (2, 32)
ATOL = 2e-5
SPAWN_TIMEOUT_S = 300
BRANCHES = ('broadcast', 'send_recv')


def qkv_data():
    rng = np.random.default_rng(11)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def tokens_data():
    return np.random.default_rng(12).integers(0, 256, TOKENS).astype(np.int32)


def port_attend(q, k, v, cot, causal, links=None):
    """The port's output and ``(dq, dk, dv)`` of ``sum(out * cot)``."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ra.ring_self_attention(q, k, v, causal=causal, links=links)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


# -- the worker ranks (no JAX) ---------------------------------------------


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init}', rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    grid = axis_groups(1, world, names=('data', 'seq'))
    links = {'broadcast': ra.sequence_links(grid)}
    with mock.patch.object(ra.dist, 'get_backend', lambda *a: 'nccl'):
        links['send_recv'] = ra.sequence_links(grid)
    assert links['send_recv'].backend == 'nccl'
    q, k, v, cot = qkv_data()
    t = SHAPE[1] // world
    cols = slice(rank * t, (rank + 1) * t)
    res = {}
    for causal in (True, False):
        for kind in BRANCHES:
            before = links[kind].sent_bytes
            o, grads = port_attend(q[:, cols], k[:, cols], v[:, cols],
                                   cot[:, cols], causal, links[kind])
            res[(causal, kind)] = dict(out=o, grads=grads,
                                       sent=links[kind].sent_bytes - before)
    weights = torch.load(out / 'init.pt')
    model = gpt_tiny(device='cpu', attention_impl='ring', seq_axis='seq',
                     seq_links=links['broadcast'])
    model.load_state_dict(weights, strict=True)
    tt = TOKENS[1] // world
    tokens = torch.from_numpy(tokens_data()[:, rank * tt:(rank + 1) * tt])
    with torch.no_grad():
        res['logits'] = model(tokens.long()).numpy()
    torch.save(res, out / f'rank{rank}.pt')
    dist.destroy_process_group()


def spawn(out: Path) -> list[subprocess.Popen]:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    return [
        subprocess.Popen(
            [sys.executable, __file__, '--worker', str(rank), str(WORLD),
             str(out / 'pg_init'), str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(WORLD)
    ]


def join(procs, deadline) -> None:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail('worker ranks timed out and were killed')
    bad = [(i, p.returncode, log[-3000:])
           for i, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        pytest.fail(f'worker ranks failed: {bad}')


# -- the JAX references (parent only) --------------------------------------


def seq_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:WORLD]), ('seq',))


def jax_attend(causal, seq_axis):
    """JAX's output and ``(dq, dk, dv)`` of ``sum(out * cot)``, on the
    seq mesh when ``seq_axis`` is given."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from kfac_pytorch_tpu.parallel.ring_attention import ring_self_attention
    from kfac_pytorch_tpu.utils.compat import set_mesh

    q, k, v, cot = qkv_data()

    def f(a, b, c):
        return ring_self_attention(a, b, c, causal=causal, seq_axis=seq_axis)

    def loss(a, b, c):
        return jnp.sum(f(a, b, c) * cot)

    args = (q, k, v)
    if seq_axis is None:
        out = f(*args)
        grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    else:
        mesh = seq_mesh()
        spec = NamedSharding(mesh, P(None, seq_axis))
        args = tuple(jax.device_put(x, spec) for x in args)
        with set_mesh(mesh):
            out = jax.jit(f)(*args)
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def jax_ring_gpt():
    """The JAX ring model's logits and its (unboxed) weights."""
    import flax.linen as fnn
    import jax

    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from kfac_pytorch_tpu.utils.compat import set_mesh

    tokens = tokens_data()
    model = jax_gpt_tiny(attention_impl='ring', seq_axis='seq')
    variables = fnn.meta.unbox(jax.jit(jax_gpt_tiny().init)(
        jax.random.PRNGKey(0), tokens))
    with set_mesh(seq_mesh()):
        logits = jax.jit(model.apply)(variables, tokens)
    return np.asarray(logits), jax.tree.map(np.asarray, variables)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The four ranks' results, computed while the parent runs JAX."""
    out = tmp_path_factory.mktemp('ring')
    logits, variables = jax_ring_gpt()
    torch.save(flax_to_torch_state_dict(variables), out / 'init.pt')
    deadline = time.time() + SPAWN_TIMEOUT_S
    procs = spawn(out)
    ref = {'logits': logits}
    try:
        for causal in (True, False):
            ref[causal] = jax_attend(causal, 'seq')
    finally:
        join(procs, deadline)
    res = [torch.load(out / f'rank{r}.pt', weights_only=False)
           for r in range(WORLD)]
    return ref, res


@pytest.mark.parametrize('causal', [True, False])
def test_single_block_matches_jax(causal):
    want_out, want_grads = jax_attend(causal, None)
    out, grads = port_attend(*qkv_data(), causal)
    np.testing.assert_allclose(out, want_out, atol=ATOL)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, atol=ATOL)


@pytest.mark.parametrize('causal', [True, False])
def test_ring_of_four_matches_jax_ring(ranks, causal):
    ref, res = ranks
    want_out, want_grads = ref[causal]
    out = np.concatenate([r[(causal, 'broadcast')]['out'] for r in res], 1)
    np.testing.assert_allclose(out, want_out, atol=ATOL)
    for i, w in enumerate(want_grads):
        g = np.concatenate([r[(causal, 'broadcast')]['grads'][i]
                            for r in res], 1)
        np.testing.assert_allclose(g, w, atol=ATOL)


@pytest.mark.parametrize('causal', [True, False])
def test_send_recv_hand_offs_match_broadcast(ranks, causal):
    """The NCCL branch (``batch_isend_irecv``) bitwise the gloo branch,
    the same bytes handed on: three rotations forward and three back of
    the ``[2, B, T/4, H, D]`` K/V block."""
    _, res = ranks
    B, T, H, D = SHAPE
    want_sent = 2 * (WORLD - 1) * 2 * B * (T // WORLD) * H * D * 4
    for r in res:
        bc, p2p = r[(causal, 'broadcast')], r[(causal, 'send_recv')]
        assert np.array_equal(p2p['out'], bc['out'])
        for g, w in zip(p2p['grads'], bc['grads']):
            assert np.array_equal(g, w)
        assert p2p['sent'] == bc['sent'] == want_sent


def test_ring_gpt_logits_match_jax_ring_model(ranks):
    ref, res = ranks
    got = np.concatenate([r['logits'] for r in res], 1)
    np.testing.assert_allclose(got, ref['logits'], atol=1e-5)


def test_single_block_gpt_matches_dense_attention():
    """``attention_impl='ring'`` without a group is the single-block path:
    the logits of the ``'dense'`` model (SDPA) from the same weights."""
    tokens = torch.from_numpy(tokens_data()).long()
    with torch.no_grad():
        ring = gpt_tiny(device='cpu', attention_impl='ring')(tokens)
        dense = gpt_tiny(device='cpu')(tokens)
    np.testing.assert_allclose(ring.numpy(), dense.numpy(), atol=1e-5)


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    run_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
             Path(sys.argv[5]))
