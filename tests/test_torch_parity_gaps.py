"""Two library functions the port takes over from the JAX package:
``utils/orbaxio.load_model`` (a model directory read back whole) and
``parallel/multihost.global_batch`` (a rank's rows for the sharded
steps) on one rank in this process; ``tests/test_torch_parallel.py``
holds ``global_batch`` on a 2x2 world of ranks.  Everything is
compared exactly: nothing is computed."""
import os

import jax
import numpy as np
import torch

from test_torch_parallel import one_rank_mesh

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
GERMAN = os.path.join(REPO, 'pretrained', 'model_german.h5')


def _german():
    """The german model's tree as CPU tensors (as a rater saves it), its
    configuration, vocabulary and history."""
    from ocrd_keraslm_torch.models.lstm_lm import params_from_numpy
    from ocrd_keraslm_torch.utils import h5io
    params, cfg, vocab, history = h5io.load_model(GERMAN)
    return params_from_numpy(params, 'cpu'), cfg, vocab, history


def test_load_model_round_trips_save_model(tmp_path):
    from ocrd_keraslm_torch.models.lstm_lm import param_leaves
    from ocrd_keraslm_torch.utils import orbaxio
    params, cfg, vocab, history = _german()
    path = str(tmp_path / 'german.orbax')
    orbaxio.save_model(path, params, cfg, vocab, history)
    got, got_cfg, got_vocab, got_history = orbaxio.load_model(path)
    assert got_cfg == cfg
    np.testing.assert_array_equal(got_vocab.to_codepoints(),
                                  vocab.to_codepoints())
    assert got_history == history
    for a, b in zip(param_leaves(got), param_leaves(params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_model_takes_the_embedding_rows(tmp_path):
    """An embedding with more rows than the stored ``voc_size`` (two rows
    past the vocabulary here) sets ``voc_size``, as JAX's
    ``load_model`` reconciles them."""
    from ocrd_keraslm_torch.utils import orbaxio
    params, cfg, vocab, history = _german()
    emb = params['char_embedding']
    params['char_embedding'] = torch.cat([emb, emb[:2]])
    orbaxio.save_model(str(tmp_path), params, cfg, vocab, history)
    assert orbaxio.load_config(str(tmp_path))[0].voc_size == vocab.size
    assert orbaxio.load_model(str(tmp_path))[1].voc_size == vocab.size + 2


def test_global_batch_on_one_rank_matches_jax():
    """One rank: its rows are the whole batch, as in ``shard_batch`` and
    ``shard_carry``, and as JAX's ``global_batch`` gives them in one
    process over two devices."""
    from jax.sharding import Mesh as JMesh
    from ocrd_keraslm_tpu.parallel import multihost as jmh
    from ocrd_keraslm_torch.data import Batch
    from ocrd_keraslm_torch.parallel import multihost
    from ocrd_keraslm_torch.parallel.mesh import shard_batch, shard_carry
    rng = np.random.default_rng(3)
    B, T, D, W = 4, 6, 2, 8
    x = rng.integers(1, 30, (B, T)).astype(np.int32)
    z = rng.integers(0, 20, (B,)).astype(np.int32)
    y = rng.integers(1, 30, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    carry = tuple(rng.normal(size=(D, B, W)).astype(np.float32)
                  for _ in range(2))
    jmesh = JMesh(np.array(jax.devices('cpu')[:2]).reshape(2, 1),
                  ('data', 'model'))
    jx, jzs, jy, jmask, jcarry = jmh.global_batch(jmesh, x, [z], y, mask,
                                                  carry)
    with one_rank_mesh() as mesh:
        gx, gzs, gy, gmask, gcarry = multihost.global_batch(
            mesh, x, [z], y, mask, carry)
        want = shard_batch(mesh, Batch(x=x, zs=[z], y=y, mask=mask))
        want_carry = shard_carry(mesh, carry)
    for got, sharded, jax_rows in (
            (gx, want.x, jx), (gzs[0], want.zs[0], jzs[0]), (gy, want.y, jy),
            (gmask, want.mask, jmask), (gcarry[0], want_carry[0], jcarry[0]),
            (gcarry[1], want_carry[1], jcarry[1])):
        np.testing.assert_array_equal(got.numpy(), sharded)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_rows))
