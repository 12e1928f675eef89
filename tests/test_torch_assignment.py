"""KAISA placement: the port's assignment, grid and bucket plans against
the JAX package's on the same inputs.

All of it is integer and string logic on the host, so it must agree
exactly: ``KAISAAssignment`` (greedy LPT placement, worker and receiver
partitions, per-rank views) on work dictionaries drawn from a numpy seed,
``resolve_grad_worker_fraction`` and ``grid_shape`` at world 1, 2, 4 and
8 under each strategy, each rank's grid row and column against the
partitions its process groups are built from, and ``make_bucket_plan`` for ResNet-32 and LeNet at
``n_cols`` 1, 2, 4 and 8, key for key and slot for slot.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kfac_pytorch_tpu import enums as jax_enums
from kfac_pytorch_tpu.assignment import KAISAAssignment as JaxAssignment
from kfac_pytorch_tpu.capture import ModelCapture as JaxCapture
from kfac_pytorch_tpu.models import resnet32 as jax_resnet32
from kfac_pytorch_tpu.models.tiny import LeNet as JaxLeNet
from kfac_pytorch_tpu.parallel import bucketing as jax_bucketing
from kfac_pytorch_tpu.parallel import mesh as jax_mesh
from kfac_pytorch_tpu_torch import enums
from kfac_pytorch_tpu_torch.assignment import KAISAAssignment
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.models import LeNet
from kfac_pytorch_tpu_torch.models import resnet32
from kfac_pytorch_tpu_torch.parallel import bucketing
from kfac_pytorch_tpu_torch.parallel import mesh

pytestmark = pytest.mark.torch_port

WORLDS = (1, 2, 4, 8)
STRATEGIES = ('COMM_OPT', 'HYBRID_OPT', 'MEM_OPT')


def work(seed: int, n_layers: int = 13) -> dict[str, dict[str, float]]:
    """Per-layer ``{'A': cost, 'G': cost}`` with a few exact ties."""
    rng = np.random.default_rng(seed)
    dims = rng.choice([32, 64, 128, 192, 320, 576], size=(n_layers, 2))
    return {
        f'layer{i}': {'A': float(a) ** 3, 'G': float(g) ** 3}
        for i, (a, g) in enumerate(dims)
    }


def fractions(world: int) -> list[float]:
    return sorted({
        jax_enums.resolve_grad_worker_fraction(
            jax_enums.DistributedStrategy[s], world,
        )[0]
        for s in STRATEGIES
    })


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('strategy', STRATEGIES)
def test_resolve_fraction_and_grid_shape_match_jax(world, strategy):
    got = enums.resolve_grad_worker_fraction(
        enums.DistributedStrategy[strategy], world,
    )
    want = jax_enums.resolve_grad_worker_fraction(
        jax_enums.DistributedStrategy[strategy], world,
    )
    assert got[0] == want[0] and got[1].name == want[1].name
    assert mesh.grid_shape(world, got[0]) == jax_mesh.grid_shape(
        world, want[0],
    )


def test_fraction_validation_matches_jax():
    for world in WORLDS:
        for fraction in (0.0, 0.125, 0.25, 0.3, 0.5, 0.75, 1.0):
            outcomes = []
            for resolve in (enums.resolve_grad_worker_fraction,
                            jax_enums.resolve_grad_worker_fraction):
                try:
                    frac, strat = resolve(fraction, world)
                    outcomes.append((frac, strat.name))
                except ValueError:
                    outcomes.append('ValueError')
            assert outcomes[0] == outcomes[1], (world, fraction, outcomes)
    with pytest.raises(ValueError):
        mesh.grid_shape(8, 0.4)


@pytest.mark.parametrize('world', WORLDS)
def test_partitions_and_grid_ranks_match_jax(world):
    for fraction in fractions(world):
        rows, cols = mesh.grid_shape(world, fraction)
        workers = KAISAAssignment.partition_grad_workers(world, rows)
        receivers = KAISAAssignment.partition_grad_receivers(world, rows)
        assert workers == JaxAssignment.partition_grad_workers(world, rows)
        assert receivers == JaxAssignment.partition_grad_receivers(
            world, rows,
        )
        # kaisa_grid's groups: the partitions, sorted.
        row_ranks = sorted(sorted(r) for r in receivers)
        col_ranks = sorted(sorted(c) for c in workers)
        assert len(row_ranks) == rows and len(col_ranks) == cols
        for rank in range(world):
            grid = mesh.KaisaGrid(rows=rows, cols=cols, rank=rank)
            assert rank in row_ranks[grid.row]
            assert rank in col_ranks[grid.col]
            assert row_ranks[grid.row].index(rank) == grid.col
            assert col_ranks[grid.col].index(rank) == grid.row


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('colocate', [True, False])
def test_kaisa_assignment_matches_jax(world, colocate):
    for seed in range(3):
        w = work(seed)
        for fraction in fractions(world):
            for rank in range(world):
                kw = dict(local_rank=rank, world_size=world,
                          grad_worker_fraction=fraction,
                          colocate_factors=colocate)
                got = KAISAAssignment(w, **kw)
                want = JaxAssignment(w, **kw)
                assert got.get_layers() == want.get_layers()
                assert got.broadcast_gradients() == want.broadcast_gradients()
                assert got.broadcast_inverses() == want.broadcast_inverses()
                for layer in w:
                    for factor in ('A', 'G'):
                        assert (got.inv_worker(layer, factor)
                                == want.inv_worker(layer, factor))
                    assert (got.grad_worker_group(layer)
                            == want.grad_worker_group(layer))
                    assert (got.grad_receiver_group(layer)
                            == want.grad_receiver_group(layer))
                    assert (got.is_grad_worker(layer)
                            == want.is_grad_worker(layer))
                    assert (got.src_grad_worker(layer)
                            == want.src_grad_worker(layer))


def test_greedy_assignment_matches_jax():
    for seed in range(10):
        w = work(100 + seed, n_layers=7 + seed)
        for world in WORLDS:
            for n_groups in {1, world}:
                groups = [list(range(i, world, n_groups))
                          for i in range(n_groups)]
                for colocate in (True, False):
                    args = (w, groups, world, colocate)
                    assert (KAISAAssignment.greedy_assignment(*args)
                            == JaxAssignment.greedy_assignment(*args))


def _jax_helpers(name: str) -> dict:
    if name == 'resnet32':
        model = jax_resnet32(num_classes=10)
        x = jnp.zeros((2, 32, 32, 3))
        kw = dict(train=True)
        variables = model.init(jax.random.PRNGKey(0), x, **kw)
        specs = JaxCapture(model).register(
            variables, x, mutable=['batch_stats'], **kw,
        )
    else:
        model = JaxLeNet()
        x = jnp.zeros((2, 28, 28, 1))
        variables = model.init(jax.random.PRNGKey(0), x)
        specs = JaxCapture(model).register(variables, x)
    return {'/'.join(s.helper.path): s.helper for s in specs.values()}


def _port_helpers(name: str) -> dict:
    model = resnet32(device='cpu') if name == 'resnet32' else LeNet()
    return ModelCapture(model).helpers


@pytest.fixture(scope='module')
def helpers():
    return {
        name: (_port_helpers(name), _jax_helpers(name))
        for name in ('resnet32', 'lenet')
    }


@pytest.mark.parametrize('n_cols', [1, 2, 4, 8])
@pytest.mark.parametrize('name', ['resnet32', 'lenet'])
def test_bucket_plan_matches_jax(helpers, name, n_cols):
    port_helpers, jax_helpers = helpers[name]
    got = bucketing.make_bucket_plan(port_helpers, n_cols=n_cols)
    want = jax_bucketing.make_bucket_plan(jax_helpers, n_cols=n_cols)
    assert got.n_cols == want.n_cols == n_cols
    assert [b.key for b in got.buckets] == [b.key for b in want.buckets]
    for gb, wb in zip(got.buckets, want.buckets):
        # torch module names join with '.', Flax paths with '/'.
        slots = tuple(
            None if s is None else s.replace('.', '/') for s in gb.slots
        )
        assert slots == wb.slots, gb.key
        assert (gb.a_pad, gb.g_pad, gb.seg) == (wb.a_pad, wb.g_pad, wb.seg)
        for c in range(n_cols):
            assert gb.column_slots(c) == gb.slots[c * gb.seg:(c + 1) * gb.seg]
            for name in gb.column_slots(c):
                if name is not None:
                    assert wb.column_of(name.replace('.', '/')) == c
    assert {
        k.replace('.', '/'): v for k, v in got.slot_of.items()
    } == dict(want.slot_of)


def test_resnet32_mem_opt_segments(helpers):
    """World 4 MEM-OPT: the shard shapes each rank launches on."""
    plan = bucketing.make_bucket_plan(helpers['resnet32'][0], n_cols=4)
    assert [(b.key, b.seg) for b in plan.buckets] == [
        ('a576g64', 3), ('a320g64', 1), ('a320g32', 4), ('a192g32', 5),
        ('a128g32', 1), ('a32g32', 1),
    ]
