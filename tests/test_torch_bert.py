"""The port's BERT and its K-FAC against the JAX package's.

* ``bert_tiny`` (vocab 256, 2 blocks, ``d_model`` 32, f32) start and end
  logits against the Flax model from the same bridged weights, with a
  mask (the last 4 positions of two rows), without and with ``type_ids``
  (the Flax model has ``tte`` only when ``init`` saw them; the port's
  ``type_embedding`` flag), ``atol 1e-5``; masked positions hold
  ``-1e9``.
* The default registration of the 8 Dense layers and ``qa_head``
  (``tests/test_bert.py``'s count); ``remat=True`` runs.
* A 3-step full-coverage ``KFACPreconditioner`` trajectory (Dense,
  ``wte`` with its ``[V]`` diagonal A, the 5 LayerNorms) against the
  JAX ``step``, ``type_ids=None`` as ``examples/squad_bert.py`` passes
  them, on the span loss (the mean of the start and end cross
  entropies), with the hyperparameters and tolerances of
  ``tests/test_torch_dense_general.py``.
"""
from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kfac_pytorch_tpu.models.bert import bert_tiny as jax_bert_tiny
from kfac_pytorch_tpu_torch.capture import ModelCapture
from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict
from kfac_pytorch_tpu_torch.models import bert_tiny

from test_torch_dense_general import check_trajectories
from test_torch_dense_general import jax_trajectory
from test_torch_dense_general import port_trajectory
from test_torch_dense_general import STEPS
from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

FULL = dict(layer_types=('linear', 'embedding', 'layernorm'))


def batches():
    """``(tokens, mask, type ids, starts, ends)`` per step; rows 0 and 1
    mask their last 4 positions."""
    rng = np.random.default_rng(31)
    out = []
    for _ in range(STEPS):
        tokens = rng.integers(0, 256, size=(4, 16)).astype(np.int32)
        mask = np.ones((4, 16), bool)
        mask[:2, -4:] = False
        types = rng.integers(0, 2, size=(4, 16)).astype(np.int32)
        starts = rng.integers(0, 12, size=4).astype(np.int32)
        ends = rng.integers(0, 12, size=4).astype(np.int32)
        out.append((tokens, mask, types, starts, ends))
    return out


def flax_init(with_types):
    tokens, mask, types, *_ = batches()[0]
    variables = fnn.meta.unbox(jax_bert_tiny().init(
        jax.random.PRNGKey(0), tokens, types if with_types else None, mask))
    return jax.tree.map(np.asarray, variables)


def port_model(init, with_types=False):
    model = bert_tiny(device='cpu', type_embedding=with_types)
    model.load_state_dict(flax_to_torch_state_dict(init), strict=True)
    return model.train()


def jax_span_loss(out, starts, ends):
    def xent(logits, y):
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], -1))
    return (xent(out[0], starts) + xent(out[1], ends)) / 2


def port_span_loss(out, starts, ends):
    return (F.cross_entropy(out[0], starts.long())
            + F.cross_entropy(out[1], ends.long())) / 2


@pytest.mark.parametrize('with_types', [False, True],
                         ids=['no_type_ids', 'type_ids'])
def test_logits_match_flax(with_types):
    init = flax_init(with_types)
    assert ('tte' in init['params']) == with_types
    tokens, mask, types, *_ = batches()[0]
    types = types if with_types else None
    want = jax_bert_tiny().apply(init, tokens, types, mask)
    model = port_model(init, with_types)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(),
                    None if types is None else torch.from_numpy(types).long(),
                    torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (4, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        assert bool((g[:2, -4:] == -1e9).all())


def test_type_ids_need_the_type_embedding():
    tokens, mask, types, *_ = batches()[0]
    with pytest.raises(ValueError, match='type_embedding'):
        bert_tiny(device='cpu')(torch.from_numpy(tokens).long(),
                                torch.from_numpy(types).long())


def test_registers_all_dense_layers():
    cap = ModelCapture(bert_tiny(device='cpu'))
    names = set(cap.helpers)
    # 2 blocks x 4 Dense (qkv, proj, fc_in, fc_out) + qa_head.
    assert len(names) == 2 * 4 + 1
    assert 'qa_head' in names


def test_remat_raises():
    """``remat=True`` used to raise (item 26); it now builds and gives
    the ``remat=False`` logits bitwise (``tests/test_torch_remat.py``
    holds the gradients and factors)."""
    tokens = torch.arange(16).reshape(2, 8)
    out = [bert_tiny(device='cpu', remat=r)(tokens) for r in (False, True)]
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_full_coverage_trajectory_matches_jax():
    init = flax_init(False)
    data = batches()
    jax_trace = jax_trajectory(
        jax_bert_tiny(), init,
        [((t, None, m), (s, e)) for t, m, _, s, e in data],
        jax_span_loss, FULL)

    def loss_of(model, step):
        t, m, _, s, e = (torch.from_numpy(a) for a in data[step])
        return port_span_loss(model(t.long(), None, m), s, e)

    port_trace = port_trajectory(port_model(init), jax_trace, loss_of, FULL)
    check_trajectories(jax_trace, port_trace, 15)
    assert port_trace[0][1]['wte'][0].shape == (256,)  # the [V] diagonal
