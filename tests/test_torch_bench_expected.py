"""The port bench's prediction blocks against the JAX bench's.

``kfac_pytorch_tpu_torch.bench``'s ``registration_dims``,
``predict_ratio``, ``predict_kaisa_scaling``,
``predict_comm_aware_scaling`` and ``comm_model_2level`` against the
repo-root ``bench.py``'s ``_registration_dims``, ``predict_ratio``,
``predict_kaisa_scaling``, ``predict_comm_aware_scaling`` and
``_comm_model_2level``:

* the registration dims of ResNet-32, ResNet-50 and the 3x512 MLP as
  multisets of ``(a, g, rows_per_example)``;
* every number of the blocks within 1e-9 relative, given the same inputs
  and JAX's constants (394 TFLOP/s, 0.30, 45 GB/s; the two-level pod at
  45 and 4.5 GB/s), and the crossover and planner worlds identical;
* the SGD FLOPs counted on fake tensors within 3% of
  ``artifacts/bench_expected.json``'s (XLA's cost analysis);
* the defaults are the H100's data sheet, no TPU constant.
"""
from __future__ import annotations

import collections
import json
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch import bench as tbench  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

#: JAX's constants, passed to the port so the two compute the same model.
JAX_PEAK, JAX_MFU, JAX_ICI = 394.0, 0.30, 45.0
REL = 1e-9
#: Text fields: each package words its notes and constants its own way.
SKIP = {'note', 'basis', 'constants', 'kind', 'topology_template'}


@pytest.fixture(scope='module')
def jbench():
    import bench as jax_bench

    assert jax_bench.PEAK_TFLOPS == JAX_PEAK
    assert jax_bench.ASSUMED_MFU == JAX_MFU
    assert jax_bench.ICI_GBYTES_PER_S == JAX_ICI
    return jax_bench


@pytest.fixture(scope='module')
def artifact():
    return json.loads((ROOT / 'artifacts' / 'bench_expected.json')
                      .read_text())


@pytest.fixture(scope='module')
def dims(jbench):
    """``{model: (jax dims, port dims)}``."""
    from kfac_pytorch_tpu.models import MLP
    from kfac_pytorch_tpu.models import resnet32
    from kfac_pytorch_tpu.models import resnet50

    return {
        'resnet50': (
            jbench._registration_dims(resnet50(num_classes=1000),
                                      (1, 224, 224, 3), train=True),
            tbench.registration_dims(tbench._model_builder('resnet50'),
                                     (1, 3, 224, 224))),
        'resnet32': (
            jbench._registration_dims(resnet32(num_classes=10),
                                      (1, 32, 32, 3), train=True),
            tbench.registration_dims(tbench._model_builder('resnet32'),
                                     (1, 3, 32, 32))),
        'mlp': (
            jbench._registration_dims(MLP(features=(512, 512, 10)),
                                      (1, 512)),
            tbench.registration_dims(tbench._model_builder('mlp'),
                                     (1, 512))),
    }


def assert_close(got, want, path='') -> None:
    """Numbers within ``REL``, everything else equal, recursively (the
    text fields of :data:`SKIP` left out)."""
    if isinstance(want, dict):
        assert set(got) - SKIP == set(want) - SKIP, path
        for k in set(want) - SKIP:
            assert_close(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, float) or isinstance(got, float):
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0), (
            path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize('model', ['resnet50', 'resnet32', 'mlp'])
def test_registration_dims_match_jax(dims, model):
    jax_dims, port_dims = dims[model]
    assert collections.Counter(map(tuple, port_dims)) == collections.Counter(
        map(tuple, jax_dims))
    assert len(port_dims) == {'resnet50': 54, 'resnet32': 32, 'mlp': 3}[model]


@pytest.mark.parametrize('variant', [
    dict(), dict(method='inverse'), dict(lowrank_rank=512),
    dict(ekfac=True),
], ids=['eigen', 'inverse', 'lowrank512', 'ekfac'])
def test_predict_ratio_matches_jax(jbench, dims, artifact, variant):
    jax_dims, port_dims = dims['resnet50']
    flops = artifact['sgd_flops']['resnet50_imagenet_b32']
    want = jbench.predict_ratio(flops, jax_dims, 10, 100, batch=32, **variant)
    for d in (jax_dims, port_dims):
        assert_close(tbench.predict_ratio(flops, d, 10, 100, batch=32,
                                          **variant), want)
    # The committed artifact holds the same model.
    name = {(): 'headline_rn50_imagenet',
            ('method',): 'secondary_rn50_inverse',
            ('lowrank_rank',): 'secondary_rn50_lowrank512',
            ('ekfac',): 'secondary_rn50_ekfac'}[tuple(variant)]
    assert_close(want, artifact['variants'][name])


@pytest.mark.parametrize('model,flops_key,batch,cadence', [
    ('resnet32', 'resnet32_cifar_b128', 128, (1, 10)),
    ('mlp', 'micro_mlp_b128', 128, (10, 100)),
])
def test_predict_ratio_other_models(jbench, dims, artifact, model,
                                    flops_key, batch, cadence):
    jax_dims, port_dims = dims[model]
    flops = artifact['sgd_flops'][flops_key]
    assert_close(tbench.predict_ratio(flops, port_dims, *cadence, batch=batch),
                 jbench.predict_ratio(flops, jax_dims, *cadence, batch=batch))


@pytest.mark.parametrize('method', ['eigen', 'inverse'])
def test_kaisa_scaling_matches_jax(jbench, dims, artifact, method):
    jax_dims, port_dims = dims['resnet50']
    flops = artifact['sgd_flops']['resnet50_imagenet_b32']
    want = jbench.predict_kaisa_scaling(flops, jax_dims, 10, 100, batch=32,
                                        method=method)
    assert_close(tbench.predict_kaisa_scaling(flops, port_dims, 10, 100,
                                              batch=32, method=method), want)
    assert_close(want, artifact['kaisa_scaling'][method])


@pytest.mark.parametrize('method', ['eigen', 'inverse'])
def test_flat_comm_model_matches_jax(jbench, dims, artifact, method):
    jax_dims, port_dims = dims['resnet50']
    flops = artifact['sgd_flops']['resnet50_imagenet_b32']
    want = jbench.predict_comm_aware_scaling(flops, jax_dims, 10, 100,
                                             batch=32, method=method)
    got = tbench.predict_comm_aware_scaling(
        flops, port_dims, 10, 100, batch=32, method=method,
        peak_tflops=JAX_PEAK, assumed_mfu=JAX_MFU, link_gbytes_per_s=JAX_ICI)
    assert_close(got, want)
    assert got['crossover']['comm_beats_mem_at_world'] == (
        want['crossover']['comm_beats_mem_at_world'])
    assert_close(want, artifact['kaisa_scaling']['comm_model'][method])


def test_two_level_model_matches_jax(jbench, dims, artifact):
    jax_dims, port_dims = dims['resnet50']
    flops = artifact['sgd_flops']['resnet50_imagenet_b32']
    want = jbench._comm_model_2level(flops, jax_dims)
    got = tbench.comm_model_2level(
        flops, port_dims, peak_tflops=JAX_PEAK, assumed_mfu=JAX_MFU,
        intra_gbytes_per_s=JAX_ICI, inter_gbytes_per_s=JAX_ICI / 10.0)
    assert_close(got, want)
    for block in ('eigen', 'inverse', 'eigen_refresh_dense'):
        for key in ('diverges_from_named_at_worlds',
                    'auto_beats_all_fixed_at_worlds'):
            assert got[block]['planner'][key] == want[block]['planner'][key]
    assert want['eigen_refresh_dense']['planner'][
        'auto_beats_all_fixed_at_worlds'] == [16, 32, 64]


@pytest.mark.parametrize('model,batch,image,key', [
    ('resnet50', 32, 224, 'resnet50_imagenet_b32'),
    ('resnet32', 128, 32, 'resnet32_cifar_b128'),
    ('mlp', 128, None, 'micro_mlp_b128'),
])
def test_sgd_flops_within_3pct_of_xla(artifact, model, batch, image, key):
    got = tbench.sgd_step_flops(model, batch, image)
    want = artifact['sgd_flops'][key]
    assert abs(got - want) <= 0.03 * want, (got, want, got / want)


def test_defaults_are_the_h100_data_sheet():
    import inspect

    from kfac_pytorch_tpu_torch.placement import PodTopology

    assert tbench.BF16_PEAK_TFLOPS[tbench.DEFAULT_CARD] == 989.0
    assert tbench.ASSUMED_MFU == 0.30
    topo = PodTopology(ici_size=2, n_groups=2)
    assert (tbench.NVLINK_GBYTES_PER_S, tbench.INFINIBAND_GBYTES_PER_S) == (
        topo.ici_gbytes_per_s, topo.dcn_gbytes_per_s) == (450.0, 50.0)
    sig = inspect.signature(tbench.predict_comm_aware_scaling)
    assert sig.parameters['link_gbytes_per_s'].default == 450.0
    sig = inspect.signature(tbench.comm_model_2level)
    assert (sig.parameters['intra_gbytes_per_s'].default,
            sig.parameters['inter_gbytes_per_s'].default) == (450.0, 50.0)
    assert not any(getattr(tbench, n, None) in (JAX_PEAK, JAX_ICI)
                   for n in dir(tbench) if n.isupper())


def test_result_line_carries_the_model_blocks():
    expected = tbench.compute_expected()
    results = {'resnet50': {'sgd_ms': 60.0, 'kfac_ms': 90.0, 'inv_steps': 20,
                            'cycles': 1, 'sgd_flops': 7e11,
                            'kfac_plain_flops': 8e11},
               'resnet32_cifar': None}
    line = tbench.result_line(results, {'device': tbench.DEFAULT_CARD},
                              expected)
    d = line['detail']
    assert d['expected']['kind'] == 'model'
    assert d['kaisa_scaling']['kind'] == 'model'
    assert set(d['expected']['variants']) == set(tbench.VARIANT_OF.values())
    evm = d['expected_vs_measured']['resnet50']
    assert evm['cadence'] == 'factor=10 inv=20'
    assert evm['measured_ratio'] == pytest.approx(1.5)
    inp = expected['inputs']['headline_rn50_imagenet']
    assert evm['expected_ratio'] == tbench.predict_ratio(
        inp['sgd_flops'], inp['dims'], 10, 20, batch=32)['expected_ratio']
    assert 'resnet32_cifar' not in d['expected_vs_measured']
    json.dumps(line)
