"""The sharded fused preconditioning op across four ranks against the JAX
package's ``fused_eigen_precondition_sharded``.

Four gloo ranks on the CPU, launched as subprocesses of this file (they
import no JAX), each take their ``[seg, ...]`` slice of the same numpy
stacks (``L = 4 * seg``), run the port's
``fused_eigen_precondition_sharded`` over the row of a ``1 x 4`` grid
(MEM-OPT) — the plain version on CPU tensors — and gather the full
``[L, ...]`` outputs.  The reference is the JAX function in interpret
mode under ``shard_map`` on a 4-device column mesh, as
``tests/test_pallas.py`` runs it.  Tolerances are that test's own:
``pg`` at ``rtol 1e-5, atol 1e-5``, clip terms at ``rtol 1e-4``.  The
eigenbases are orthonormal, as every eigenbasis is, so ``pg`` is O(1).

The same spawn gathers an uneven decomposition split (5 slots over a
column of 4 ranks, shares padded to 2 slots) and checks it slot for slot,
once as the eigen triple and once as a mixed tuple of two buckets
(identity- and zero-padded square stacks, f32 and int32 per-slot
vectors; 5 and 2 slots, so two ranks hold an empty share of the second).
"""
from __future__ import annotations

import datetime
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # worker processes run this file directly
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch.ops import fused_eigen_precondition  # noqa: E402
from kfac_pytorch_tpu_torch.ops import (  # noqa: E402
    fused_eigen_precondition_sharded,
    fused_eigen_precondition_sharded_reference,
)
from kfac_pytorch_tpu_torch.parallel import collectives  # noqa: E402
from kfac_pytorch_tpu_torch.parallel.mesh import kaisa_grid  # noqa: E402
from test_torch_distributed import join  # noqa: E402
from test_torch_distributed import spawn  # noqa: E402

pytestmark = pytest.mark.torch_port

WORLD = 4
#: ``(L, gp, ap)``: test_pallas.py's sharded case, then ResNet-32's
#: a192g32 bucket at its MEM-OPT shard (seg 5 on each of 4 ranks).
SHAPES = [(8, 32, 64), (20, 32, 192)]
IDS = [f'L{L}-g{gp}-a{ap}' for L, gp, ap in SHAPES]
SPAWN_TIMEOUT_S = 120
UNEVEN_SEG = 5


def rand_inputs(L, gp, ap, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(L, gp, ap)).astype(np.float32)
    qa = np.linalg.qr(rng.normal(size=(L, ap, ap)))[0].astype(np.float32)
    qg = np.linalg.qr(rng.normal(size=(L, gp, gp)))[0].astype(np.float32)
    dgda = rng.uniform(0.1, 1.0, size=(L, gp, ap)).astype(np.float32)
    return g, qa, qg, dgda


def slot_stack(slots, n):
    """``[len(slots), n, n]`` with slot ``i`` filled with ``i + 1``."""
    return torch.tensor([float(i + 1) for i in slots]).reshape(
        -1, 1, 1).expand(-1, n, n).contiguous()


#: Pad rules of :func:`mixed_share`'s fields.
MIXED_IDENTITY = (True, False, False, False)


def mixed_share(seg: int, world: int, rank: int) -> tuple:
    """This rank's share of a ``seg``-slot column in four fields: a
    square stack, a zero-padded square stack, an f32 and an int32
    ``[share]`` vector, each slot ``i`` holding ``i + 1``."""
    share = range(*collectives.share_bounds(seg, world, rank))
    vec = torch.tensor([float(i + 1) for i in share])
    return (slot_stack(share, 3), slot_stack(share, 2), vec,
            vec.to(torch.int32))


def run_rank(rank: int, world: int, init: Path, out: Path) -> None:
    dist.init_process_group(
        'gloo', init_method=f'file://{init}', rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60),
    )
    row = kaisa_grid(1.0 / world)   # 1 x world: the row is the world
    col = kaisa_grid(1.0)           # world x 1: the column is the world
    results = {}
    for L, gp, ap in SHAPES:
        seg = L // world
        local = [
            torch.from_numpy(a[rank * seg:(rank + 1) * seg])
            for a in rand_inputs(L, gp, ap, seed=L * gp + ap)
        ]
        fused_eigen_precondition.launches = 0
        results[L, gp, ap] = dict(
            sharded=fused_eigen_precondition_sharded(
                *local, group=row.row_group,
            ),
            reference=fused_eigen_precondition_sharded_reference(
                *local, group=row.row_group,
            ),
            launches=fused_eigen_precondition.launches,
        )
    start, stop = collectives.share_bounds(UNEVEN_SEG, world, rank)
    share = range(start, stop)
    (got,) = collectives.all_gather_decompositions(
        [(slot_stack(share, 4), slot_stack(share, 2),
          slot_stack(share, 2)[:, :, :1].expand(-1, 2, 4).contiguous())],
        [UNEVEN_SEG], col.col_group, identity=[(True, True, False)],
    )
    results['uneven'] = got
    results['mixed'] = collectives.all_gather_decompositions(
        [mixed_share(UNEVEN_SEG, world, rank), mixed_share(2, world, rank)],
        [UNEVEN_SEG, 2], col.col_group, identity=[MIXED_IDENTITY] * 2,
    )
    torch.save(results, out / f'rank{rank}.pt')
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """``(jax outputs by shape, per-rank port results)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kfac_pytorch_tpu.ops.pallas_precond import (
        fused_eigen_precondition_sharded as jax_sharded,
    )

    out = tmp_path_factory.mktemp('sharded')
    procs = spawn(__file__, WORLD, out)
    deadline = time.time() + SPAWN_TIMEOUT_S
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ('col',))
    spec = NamedSharding(mesh, P('col'))
    want = {}
    try:
        for L, gp, ap in SHAPES:
            args = [
                jax.device_put(jnp.asarray(a), spec)
                for a in rand_inputs(L, gp, ap, seed=L * gp + ap)
            ]
            pg, clip = jax_sharded(
                *args, mesh=mesh, shard_axis='col', interpret=True,
            )
            want[L, gp, ap] = (np.asarray(pg), np.asarray(clip))
    finally:
        join(procs, deadline)
    return want, [torch.load(out / f'rank{r}.pt') for r in range(WORLD)]


@pytest.mark.parametrize('shape', SHAPES, ids=IDS)
def test_sharded_matches_jax_sharded_kernel(runs, shape):
    want, ranks = runs
    want_pg, want_clip = want[shape]
    for res in ranks:
        pg, clip = res[shape]['sharded']
        assert tuple(pg.shape) == shape and tuple(clip.shape) == shape[:1]
        np.testing.assert_allclose(pg.numpy(), want_pg, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(clip.numpy(), want_clip, rtol=1e-4)


@pytest.mark.parametrize('shape', SHAPES, ids=IDS)
def test_every_rank_gathers_the_same_bits(runs, shape):
    _, ranks = runs
    pg0, clip0 = ranks[0][shape]['sharded']
    for res in ranks:
        pg, clip = res[shape]['sharded']
        ref_pg, ref_clip = res[shape]['reference']
        # CPU tensors take the plain version, uncounted.
        assert torch.equal(pg, pg0) and torch.equal(clip, clip0)
        assert torch.equal(pg, ref_pg) and torch.equal(clip, ref_clip)
        assert res[shape]['launches'] == 0


def test_uneven_decomposition_split_gathers_in_slot_order(runs):
    _, ranks = runs
    for res in ranks:
        qa, qg, dgda = res['uneven']
        slots = range(UNEVEN_SEG)
        assert torch.equal(qa, slot_stack(slots, 4))
        assert torch.equal(qg, slot_stack(slots, 2))
        assert torch.equal(dgda[:, 0, 0], torch.arange(1.0, 6.0))
        assert tuple(dgda.shape) == (UNEVEN_SEG, 2, 4)


@pytest.mark.parametrize('bucket,seg', [(0, UNEVEN_SEG), (1, 2)])
def test_mixed_decomposition_tuple_gathers_in_slot_order(runs, bucket, seg):
    _, ranks = runs
    want = mixed_share(seg, 1, 0)
    for res in ranks:
        got = res['mixed'][bucket]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_padding_rule_per_field():
    """Identity fields pad with identity blocks, the others with zeros."""
    x = slot_stack(range(1), 3)
    v = torch.ones(1, dtype=torch.int32)
    assert torch.equal(collectives._pad_slots(x, 3, True)[1:],
                       torch.eye(3).expand(2, 3, 3))
    assert not collectives._pad_slots(x, 3, False)[1:].any()
    assert collectives._pad_slots(v, 3, False).tolist() == [1, 0, 0]


def test_one_column_gathers_nothing():
    args = [torch.from_numpy(a) for a in rand_inputs(3, 32, 64, seed=1)]
    pg, clip = fused_eigen_precondition_sharded(*args, group=None)
    want_pg, want_clip = fused_eigen_precondition(*args)
    assert torch.equal(pg, want_pg) and torch.equal(clip, want_clip)


def test_share_bounds_cover_every_slot_once():
    for n_slots in range(1, 12):
        for parts in (1, 2, 4, 8):
            covered = []
            for i in range(parts):
                start, stop = collectives.share_bounds(n_slots, parts, i)
                assert stop - start <= -(-n_slots // parts)
                covered.extend(range(start, stop))
            assert covered == list(range(n_slots))


if __name__ == '__main__' and sys.argv[1:2] == ['--worker']:
    _, _, rank_s, world_s, init_s, out_s = sys.argv
    torch.set_num_threads(1)
    run_rank(int(rank_s), int(world_s), Path(init_s), Path(out_s))
