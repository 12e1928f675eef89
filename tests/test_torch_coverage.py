"""The port's transformer K-FAC pieces against the JAX package's.

* Every new ``ops`` function (the embedding's diagonal A, the LayerNorm
  scale+bias statistics, the tied attend contributions, the KFAC-reduce
  rows, the diagonal-A preconditioning of both methods, the diagonal
  EMA seed) against ``kfac_pytorch_tpu.ops`` on the same numpy inputs,
  f32, ``rtol 1e-5, atol 1e-6`` (same formulas, different summation
  order).
* The helpers' factors against the JAX helpers', and their gradient
  round trips.
* Registration on the port's GPT: the kinds, the tie, and every
  configuration error the JAX capture raises.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from kfac_pytorch_tpu import ops as jops
from kfac_pytorch_tpu.layers import coverage as jcov
from kfac_pytorch_tpu.layers import helpers as jhelpers
from kfac_pytorch_tpu_torch import KFACPreconditioner
from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.layers import coverage
from kfac_pytorch_tpu_torch.layers import EmbedHelper
from kfac_pytorch_tpu_torch.layers import TiedAttend
from kfac_pytorch_tpu_torch.models import gpt_tiny

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-5, 1e-6
FULL = ('linear', 'conv2d', 'embedding', 'layernorm')
V, D = 40, 12


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64),
        rtol=rtol, atol=atol,
    )


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def arrays():
    rng = np.random.default_rng(31)
    ids = rng.integers(0, V, size=(3, 700))
    ids[0, :3] = (-2, V, V + 5)  # clipped to the table's edges
    orth = np.linalg.qr(rng.standard_normal((D, D)))[0]
    return dict(
        ids=ids,
        x=(rng.standard_normal((3, 5, D)) * 3 + 1).astype(np.float32),
        cots=rng.standard_normal((3, 700, V)).astype(np.float32),
        grad=rng.standard_normal((D, V)).astype(np.float32),
        a_diag=rng.uniform(0.0, 0.2, size=V).astype(np.float32),
        qg=orth.astype(np.float32),
        dg=rng.uniform(0.0, 2.0, size=D).astype(np.float32),
        g_inv=(orth @ np.diag(rng.uniform(0.5, 2, D)) @ orth.T)
        .astype(np.float32),
        ema=rng.uniform(0.0, 0.5, size=V).astype(np.float32),
    )


#: name -> (port call, JAX call), each taking the dict of arrays.
OPS = {
    'embed_a_diag': (
        lambda a: ops.embed_a_diag(t(a['ids']), V),
        lambda a: jops.embed_a_diag(jnp.asarray(a['ids']), V)),
    'layernorm_normalized': (
        lambda a: ops.layernorm_normalized(t(a['x']), 1e-6),
        lambda a: jops.layernorm_normalized(a['x'], 1e-6)),
    'scale_bias_a_rows': (
        lambda a: ops.scale_bias_a_rows(t(a['x']), 1e-5)[0],
        lambda a: jops.scale_bias_a_rows(a['x'], 1e-5)[0]),
    'scale_bias_a_factor': (
        lambda a: ops.scale_bias_a_factor(t(a['x']), 1e-6),
        lambda a: jops.scale_bias_a_factor(a['x'], 1e-6)),
    'attend_a_diag': (  # 2100 rows: three chunks of the reduction
        lambda a: ops.attend_a_diag(t(a['cots']), V),
        lambda a: jops.attend_a_diag(a['cots'], V)),
    'attend_g_factor': (
        lambda a: ops.attend_g_factor(t(a['x'])),
        lambda a: jops.attend_g_factor(a['x'])),
    'reduce_sum_shared': (
        lambda a: ops.reduce_sum_shared(t(a['x'])),
        lambda a: jops.reduce_sum_shared(a['x'])),
    'linear_reduce_a_rows': (
        lambda a: ops.linear_reduce_a_rows(t(a['x']))[0],
        lambda a: jops.linear_reduce_a_rows(a['x'])[0]),
    'linear_reduce_g_rows': (
        lambda a: ops.linear_reduce_g_rows(t(a['x']))[0],
        lambda a: jops.linear_reduce_g_rows(a['x'])[0]),
    'precondition_grad_eigen_diag_a': (
        lambda a: ops.precondition_grad_eigen_diag_a(
            t(a['grad']), t(a['a_diag']), t(a['qg']), t(a['dg']), 0.003),
        lambda a: jops.precondition_grad_eigen_diag_a(
            a['grad'], a['a_diag'], a['qg'], a['dg'], 0.003)),
    'precondition_grad_inverse_diag_a': (
        lambda a: ops.precondition_grad_inverse_diag_a(
            t(a['grad']), t(1.0 / (a['a_diag'] + 0.003)), t(a['g_inv'])),
        lambda a: jops.precondition_grad_inverse_diag_a(
            a['grad'], 1.0 / (a['a_diag'] + 0.003), a['g_inv'])),
    'ema_update_factor_diag_first': (
        lambda a: ops.ema_update_factor(
            torch.zeros(V), t(a['ema']), 0.95, True),
        lambda a: jops.ema_update_factor(
            jnp.zeros(V), a['ema'], 0.95, True)),
    'ema_update_factor_diag': (
        lambda a: ops.ema_update_factor(
            t(a['a_diag']), t(a['ema']), 0.95, False),
        lambda a: jops.ema_update_factor(
            a['a_diag'], a['ema'], 0.95, False)),
}


@pytest.mark.parametrize('name', list(OPS))
def test_op_matches_jax(name):
    port, ref = OPS[name]
    a = arrays()
    got, want = port(a), ref(a)
    assert tuple(got.shape) == tuple(np.shape(want))
    close(got, want)


def test_embed_a_diag_counts_ids_uncast():
    """Ids beyond bf16's exact integers (> 256) land in their own bins."""
    ids = torch.tensor([[257, 257, 258, 1000]])
    diag = ops.embed_a_diag(ids, 1001)
    assert diag[257] == 0.5 and diag[258] == 0.25 and diag[1000] == 0.25
    assert float(diag.sum()) == 1.0


# -- helpers --------------------------------------------------------------

def helper_pair(kind):
    """``(port helper, JAX helper)`` of the same layer."""
    common = dict(name='l', has_bias=True, in_features=D, out_features=7)
    if kind in ('embed', 'tied_embed', 'tied_attend'):
        common.update(has_bias=False, in_features=V, out_features=D)
    port_cls, jax_cls = {
        'dense': (coverage.DenseHelper, jhelpers.DenseHelper),
        'expand': (coverage.KfacExpandHelper, jcov.KfacExpandHelper),
        'reduce': (coverage.KfacReduceHelper, jcov.KfacReduceHelper),
        'embed': (EmbedHelper, jhelpers.EmbedHelper),
        'tied_embed': (coverage.TiedEmbedHelper, jcov.TiedEmbedHelper),
        'tied_attend': (coverage.TiedAttendHelper, jcov.TiedAttendHelper),
        'scale_bias': (coverage.ScaleBiasHelper, jcov.ScaleBiasHelper),
    }[kind]
    extra = {}
    if kind == 'scale_bias':
        common.update(in_features=1, out_features=D)
        extra = dict(epsilon=1e-5)
    return (port_cls(module=None, **common, **extra),
            jax_cls(path=('l',), **common, **extra))


def helper_inputs(kind, a):
    """``(A-side input, G-side input)`` of one captured call."""
    rng = np.random.default_rng(5)
    if kind in ('embed', 'tied_embed'):
        return a['ids'], rng.standard_normal((3, 700, D)).astype(np.float32)
    if kind == 'tied_attend':  # A from the cotangents, G from the inputs
        return a['cots'], rng.standard_normal((3, 700, D)).astype(np.float32)
    if kind == 'scale_bias':
        return a['x'], rng.standard_normal((3, 5, D)).astype(np.float32)
    return a['x'], rng.standard_normal((3, 5, 7)).astype(np.float32)


HELPER_KINDS = ['dense', 'expand', 'reduce', 'embed', 'tied_embed',
                'tied_attend', 'scale_bias']


@pytest.mark.parametrize('kind', HELPER_KINDS)
def test_helper_factors_match_jax(kind):
    port, ref = helper_pair(kind)
    a_in, g_in = helper_inputs(kind, arrays())
    assert port.a_factor_shape == ref.a_factor_shape
    assert port.diagonal_a == ref.diagonal_a
    assert port.swap_capture == ref.swap_capture
    close(port.get_a_factor(t(a_in)), ref.get_a_factor(jnp.asarray(a_in)))
    close(port.get_g_factor(t(g_in)), ref.get_g_factor(jnp.asarray(g_in)))


def test_reduce_differs_from_expand_under_sharing():
    port, _ = helper_pair('reduce')
    expand, _ = helper_pair('expand')
    x = t(arrays()['x'])
    assert not torch.allclose(port.get_a_factor(x), expand.get_a_factor(x))
    x2 = x[:, 0]  # no shared axis: reduce is the dense path, bit for bit
    assert torch.equal(port.get_a_factor(x2), expand.get_a_factor(x2))


GRAD_MODULES = {
    'embedding': lambda: nn.Embedding(V, D),
    'layernorm': lambda: nn.LayerNorm(D),
}


@pytest.mark.parametrize('kind', list(GRAD_MODULES))
def test_grad_round_trip(kind):
    """``get_grad`` gives the JAX combined layout (embedding ``[D, V]``,
    LayerNorm ``[D, 2]`` scale first) and ``set_grad`` inverts it."""
    module = GRAD_MODULES[kind]()
    gen = torch.Generator().manual_seed(0)
    for p in module.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    want = [p.grad.clone() for p in module.parameters()]
    if kind == 'embedding':
        helper = EmbedHelper(name='e', module=module, has_bias=False,
                             in_features=V, out_features=D)
        combined = helper.get_grad()
        ref = jhelpers.EmbedHelper(name='e', path=('e',), has_bias=False,
                                   in_features=V, out_features=D).get_grad(
            {'embedding': jnp.asarray(want[0].numpy())})
    else:
        helper = coverage.ScaleBiasHelper(
            name='n', module=module, has_bias=True, in_features=1,
            out_features=D)
        combined = helper.get_grad()
        ref = np.stack([want[0].numpy(), want[1].numpy()], axis=1)
    np.testing.assert_array_equal(combined.numpy(), np.asarray(ref))
    combined = combined.clone()  # get_grad may return a view of .grad
    for p in module.parameters():
        p.grad.zero_()
    helper.set_grad(combined)
    for p, w in zip(module.parameters(), want):
        assert torch.equal(p.grad, w)


# -- registration ---------------------------------------------------------

def test_full_coverage_registration_on_gpt():
    model = gpt_tiny(device='cpu')
    cap = ModelCapture(model, layer_types=FULL, tied_weights=('wte',))
    kinds = {n: type(h).__name__ for n, h in cap.helpers.items()}
    assert kinds['wte'] == 'TiedEmbedHelper'
    assert kinds['ln_f'] == 'ScaleBiasHelper'
    assert cap.helpers['h_0.ln_1'].epsilon == pytest.approx(1e-6)
    assert sum(k == 'DenseHelper' for k in kinds.values()) == 8
    assert sum(k == 'ScaleBiasHelper' for k in kinds.values()) == 5
    head, attend = cap.attend['wte']
    assert head == 'head' and attend.swap_capture
    assert attend.a_factor_shape == (256,)


def test_default_registration_on_gpt_is_the_dense_layers():
    cap = ModelCapture(gpt_tiny(device='cpu'))
    assert len(cap.helpers) == 8 and not cap.attend
    assert all(type(h).__name__ == 'DenseHelper'
               for h in cap.helpers.values())


def test_kfac_approx_mapping_selects_per_layer():
    cap = ModelCapture(gpt_tiny(device='cpu'),
                       kfac_approx={r'fc_in': 'reduce', r'qkv': 'expand'})
    kinds = {n: type(h).__name__ for n, h in cap.helpers.items()}
    assert kinds['h_0.mlp.fc_in'] == 'KfacReduceHelper'
    assert kinds['h_1.attn.qkv'] == 'KfacExpandHelper'
    assert kinds['h_0.mlp.fc_out'] == 'DenseHelper'


class NoAffine(nn.Module):
    def __init__(self):
        super().__init__()
        self.ln = nn.LayerNorm(5, elementwise_affine=False)
        self.head = nn.Linear(5, 4)

    def forward(self, x):
        return self.head(self.ln(x))


def test_layernorm_without_affine_rejected():
    cap = ModelCapture(NoAffine(), layer_types=('linear', 'layernorm'))
    assert set(cap.helpers) == {'head'}
    assert 'scale and bias' in cap.rejected['ln']


class Untied(nn.Module):
    def __init__(self):
        super().__init__()
        self.wte = nn.Embedding(V, D)
        self.head = nn.Linear(D, V)

    def forward(self, ids):
        return self.head(self.wte(ids))


CONFIG_ERRORS = {
    'tied_needs_embedding': (
        lambda: ModelCapture(gpt_tiny(device='cpu'), tied_weights=('wte',)),
        ValueError, "'embedding' is not in layer_types"),
    'skip_pattern_on_tied': (
        lambda: ModelCapture(gpt_tiny(device='cpu'), layer_types=FULL,
                             tied_weights=('wte',), skip_layers=('wte',)),
        ValueError, 'tied_weights declares'),
    'skip_class_on_tied_head': (
        lambda: ModelCapture(gpt_tiny(device='cpu'), layer_types=FULL,
                             tied_weights=('wte',),
                             skip_layers=('TiedAttend',)),
        ValueError, 'tied_weights declares'),
    'tied_unknown_name': (
        lambda: ModelCapture(gpt_tiny(device='cpu'), layer_types=FULL,
                             tied_weights=('embed',)),
        ValueError, 'no nn.Embedding'),
    'tied_without_head': (
        lambda: ModelCapture(Untied(), layer_types=FULL,
                             tied_weights=('wte',)),
        ValueError, 'no TiedAttend'),
    'unknown_approx_mode': (
        lambda: ModelCapture(gpt_tiny(device='cpu'), kfac_approx='sum'),
        ValueError, 'kfac_approx'),
    'unmatched_approx_pattern': (
        lambda: ModelCapture(gpt_tiny(device='cpu'),
                             kfac_approx={'nope': 'reduce'}),
        ValueError, 'matched no'),
    'approx_pattern_matches_only_other_kinds': (
        lambda: ModelCapture(gpt_tiny(device='cpu'), layer_types=FULL,
                             tied_weights=('wte',),
                             kfac_approx={'ln_1': 'reduce'}),
        ValueError, 'linear/dense_general'),
    'unknown_kind': (
        lambda: ModelCapture(gpt_tiny(device='cpu'), layer_types=('rnn',)),
        ValueError, 'Unknown layer types'),
}


@pytest.mark.parametrize('case', list(CONFIG_ERRORS))
def test_configuration_errors(case):
    build, exc, match = CONFIG_ERRORS[case]
    with pytest.raises(exc, match=match):
        build()


def test_head_with_another_weight_raises():
    model = gpt_tiny(device='cpu')
    precond = KFACPreconditioner(model, layer_types=FULL,
                                 tied_weights=('wte',))
    assert precond._capture.armed
    with pytest.raises(RuntimeError, match='weight other than'):
        model.head(torch.zeros(1, 2, 32), torch.zeros(256, 32))


def test_attend_capture_is_kept_apart():
    """The lookup's and the head's captures come back as two roles of
    the one ``wte`` group, each with its own call."""
    model = gpt_tiny(device='cpu')
    cap = ModelCapture(model, layer_types=FULL, tied_weights=('wte',))
    cap.armed = True
    ids = torch.randint(0, 256, (2, 6), generator=torch.Generator()
                        .manual_seed(0))
    model(ids).sum().backward()
    roles = cap.take()['wte']
    assert [type(h).__name__ for h, _, _ in roles] == [
        'TiedEmbedHelper', 'TiedAttendHelper']
    (_, ids_cap, g_look), (_, x_att, g_att) = roles
    assert torch.equal(ids_cap[0], ids) and ids_cap[0].dtype == torch.int64
    assert g_look[0].shape == (2, 6, 32) and x_att[0].shape == (2, 6, 32)
    assert g_att[0].shape == (2, 6, 256)


def test_tied_attend_module_is_parameter_free():
    head = TiedAttend('wte', dtype=torch.bfloat16)
    assert not list(head.parameters())
    out = head(torch.ones(2, 3), torch.ones(5, 3))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 5)
