"""The port's ``tiny_gpt_lm`` and ``squad_bert`` examples against the JAX
package's, on the CPU.

* The data: ``load_corpus``, ``batches`` (``np.random.RandomState``
  windows), ``build_realtext_qa`` and ``load_data`` (the real-text task,
  ``--synthetic``, ``--data-file``) bitwise the JAX modules' numpy
  arrays.
* ``span_loss`` against JAX's (``rtol 1e-6``) and the optax
  ``warmup_cosine_decay_schedule`` reproduced (``rtol 1e-6``) at the
  warmup, its end, the cosine and past the decay.
* ``tiny_gpt_lm.run()`` at the example's default widths (2 layers,
  ``d_model`` 64, 128 positions, batch 32) with full coverage, factor 1,
  inv 3, six steps, from the JAX example's initial weights, against
  JAX's ``run()``: the tail loss of SGD and of K-FAC within ``1e-4``
  relative (six steps of f32 training through two refreshes, whose f32
  eigendecompositions differ between the libraries in the last bits).
* ``squad_bert.main()`` on ``bert_tiny`` in one process on the CPU: one
  epoch of two steps from a ``--data-file`` of eight real-text
  examples, a finite loss, and the checkpoint it writes loads with the
  model, optimizer and K-FAC states.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from kfac_pytorch_tpu_torch.convert import flax_to_torch_state_dict  # noqa
from kfac_pytorch_tpu_torch.examples import squad_bert  # noqa: E402
from kfac_pytorch_tpu_torch.examples import tiny_gpt_lm  # noqa: E402
from kfac_pytorch_tpu_torch.examples import utils  # noqa: E402
from kfac_pytorch_tpu_torch.observe import Emitter  # noqa: E402
from kfac_pytorch_tpu_torch.utils.metrics import MetricsWriter  # noqa

from test_torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

LM_TOL = 1e-4
LM_ARGS = ['--steps', '6', '--factor-update-steps', '1',
           '--inv-update-steps', '3', '--full-coverage', '--device', 'cpu']


# -- the data ----------------------------------------------------------------


def test_corpus_and_batches_are_jax_bitwise():
    from examples import tiny_gpt_lm as jax_lm

    tokens = tiny_gpt_lm.load_corpus()
    np.testing.assert_array_equal(tokens, jax_lm.load_corpus())
    got = list(tiny_gpt_lm.batches(tokens, 4, 16, 3, seed=7))
    want = list(jax_lm.batches(tokens, 4, 16, 3, seed=7))
    assert len(got) == len(want) == 3
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize('kind', ['realtext', 'synthetic', 'file'])
def test_qa_data_is_jax_bitwise(kind, tmp_path):
    from examples import squad_bert as jax_squad

    if kind == 'file':
        t, s, e, m = jax_squad.build_realtext_qa(48, n_examples=6, seed=3)
        path = tmp_path / 'qa.npz'
        np.savez(path, tokens=t, starts=s, ends=e, mask=m)
    args = argparse.Namespace(
        data_file=str(path) if kind == 'file' else '',
        synthetic=kind == 'synthetic', seq_len=96, seed=1)
    got, want = squad_bert.load_data(args), jax_squad.load_data(args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        squad_bert.build_realtext_qa(40, n_examples=5, query_len=6, seed=2)[0],
        jax_squad.build_realtext_qa(40, n_examples=5, query_len=6, seed=2)[0])


def test_span_loss_matches_jax():
    import jax.numpy as jnp

    from examples import squad_bert as jax_squad

    rng = np.random.default_rng(4)
    start = rng.standard_normal((4, 24)).astype(np.float32)
    end = rng.standard_normal((4, 24)).astype(np.float32)
    starts = rng.integers(0, 24, 4).astype(np.int32)
    ends = rng.integers(0, 24, 4).astype(np.int32)
    want, _ = jax_squad.span_loss((jnp.asarray(start), jnp.asarray(end)),
                                  jnp.asarray(starts), jnp.asarray(ends))
    got, aux = squad_bert.span_loss(
        (torch.from_numpy(start), torch.from_numpy(end)),
        torch.from_numpy(starts), torch.from_numpy(ends))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert set(aux) == {'start', 'end'}


@pytest.mark.parametrize('warmup,total', [(1, 7), (4, 20), (2, 3)])
def test_schedule_matches_optax(warmup, total):
    import optax

    with pytest.raises(ValueError, match='decay_steps'):
        optax.warmup_cosine_decay_schedule(0.0, 3e-5, warmup, warmup)
    with pytest.raises(ValueError, match='decay_steps'):
        squad_bert.warmup_cosine_decay_schedule(0.0, 3e-5, warmup, warmup)

    want = optax.warmup_cosine_decay_schedule(0.0, 3e-5, warmup, total)
    got = squad_bert.warmup_cosine_decay_schedule(0.0, 3e-5, warmup, total)
    for step in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                        total - 1, total, total + 5}):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))


def test_coverage_kwargs_are_the_ports():
    full = tiny_gpt_lm.coverage_layer_kwargs(True)
    assert full == dict(
        layer_types=('linear', 'conv2d', 'embedding', 'layernorm'),
        tied_weights=('wte',))
    assert tiny_gpt_lm.coverage_layer_kwargs(False, embedding=True) == dict(
        layer_types=('linear', 'conv2d', 'embedding'))
    assert tiny_gpt_lm.coverage_layer_kwargs(False) == {}


# -- tiny_gpt_lm.run() against JAX's -----------------------------------------


def jax_run_both(args):
    """JAX's ``run()`` for SGD and K-FAC, and its initial weights."""
    import jax
    import jax.numpy as jnp
    import flax.linen as fnn

    from examples import tiny_gpt_lm as jax_lm
    from kfac_pytorch_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from kfac_pytorch_tpu.observe import Emitter as JaxEmitter
    from kfac_pytorch_tpu.utils.metrics import MetricsWriter as JaxWriter

    model = jax_gpt_tiny(vocab_size=256, n_layers=args.layers,
                         d_model=args.d_model, d_ff=2 * args.d_model,
                         max_seq_len=args.seq_len)
    params = fnn.meta.unbox(model.init(
        jax.random.PRNGKey(args.seed),
        jnp.zeros((1, args.seq_len), jnp.int32)))['params']
    weights = flax_to_torch_state_dict(
        {'params': jax.tree.map(np.asarray, params)})
    with JaxWriter(args.log_dir, use_tensorboard=False) as writer, \
            JaxEmitter.to_dir(args.log_dir) as emitter:
        out = {tag: jax_lm.run(tag == 'kfac', args, writer, emitter)
               for tag in ('sgd', 'kfac')}
    return out, weights


@pytest.fixture(scope='module')
def lm(tmp_path_factory):
    args = tiny_gpt_lm.parse_args(
        LM_ARGS + ['--log-dir', str(tmp_path_factory.mktemp('tiny_gpt'))])
    want, weights = jax_run_both(args)
    got, kept = {}, {}
    with MetricsWriter(args.log_dir, use_tensorboard=False) as writer, \
            Emitter.to_dir(args.log_dir) as emitter:
        for tag in ('sgd', 'kfac'):
            kept[tag] = {}
            got[tag] = tiny_gpt_lm.run(tag == 'kfac', args, writer, emitter,
                                       weights=weights, keep=kept[tag])
    return dict(want=want, got=got, kept=kept, args=args)


@pytest.mark.parametrize('tag', ['sgd', 'kfac'])
def test_tiny_gpt_lm_run_matches_jax(lm, tag):
    got, want = lm['got'][tag], lm['want'][tag]
    assert np.isfinite(got)
    assert abs(got - want) <= LM_TOL * abs(want), (tag, got, want)


def test_tiny_gpt_lm_run_keeps_the_run(lm):
    """The K-FAC run covers every parameter but ``wpe``, its losses are
    finite and fall, and the loss curve reached the metrics file."""
    import json

    kept = lm['kept']['kfac']
    report = kept['precond'].coverage_report()
    assert report['uncovered'] == ['wpe']
    losses = kept['losses']
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert lm['kept']['sgd']['precond'] is None
    lines = [json.loads(x) for x in
             Path(lm['args'].log_dir, 'metrics.jsonl').read_text()
             .splitlines()]
    tags = {x.get('tag') for x in lines}
    assert {'sgd/loss', 'kfac/loss'} <= tags


# -- squad_bert.main() ---------------------------------------------------------


def test_squad_bert_main_runs_and_checkpoints(tmp_path):
    t, s, e, m = squad_bert.build_realtext_qa(32, n_examples=8)
    path = tmp_path / 'qa.npz'
    np.savez(path, tokens=t, starts=s, ends=e, mask=m)
    out = squad_bert.main([
        '--device', 'cpu', '--model', 'bert_tiny', '--seq-len', '32',
        '--epochs', '1', '--data-file', str(path), '--log-dir',
        str(tmp_path / 'logs'), '--kfac-factor-update-steps', '1',
        '--kfac-inv-update-steps', '1', '--optimizer', 'sgd',
    ])
    assert len(out['losses']) == 2 and np.all(np.isfinite(out['losses']))
    assert out['epoch_losses'] == [pytest.approx(np.mean(out['losses']))]
    assert out['precond'].steps == 2
    ckpt = utils.load_checkpoint(out['checkpoint'])
    assert ckpt['epoch'] == 0
    assert set(ckpt['train_state']) == {'model', 'optimizer'}
    assert 'h_0.qkv.weight' in ckpt['train_state']['model']
    assert ckpt['kfac']['steps'] == 2
    assert len(ckpt['kfac']['layers']) == 2 * 4 + 1
