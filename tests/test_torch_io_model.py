"""Parity of the PyTorch port's h5 reading and model step with the JAX
package: both bundled checkpoints load bit-equal, and ``forward_step``
agrees on the German model's weights."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from ocrd_keraslm_tpu.models import lstm_lm as jlm
from ocrd_keraslm_tpu.utils import h5io as jh5
from ocrd_keraslm_torch.models import lstm_lm as tlm
from ocrd_keraslm_torch.utils import h5io as th5

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

PRETRAINED = os.path.join(os.path.dirname(__file__), '..', 'pretrained')
MODELS = ['model_german.h5', 'model_synthetic.h5']


def _flat(params):
    out = {'char_embedding': params['char_embedding']}
    for i, e in enumerate(params['context_embeddings']):
        out['context%d' % i] = e
    for i, lp in enumerate(params['lstm']):
        for name in ('kernel', 'recurrent', 'bias'):
            out['lstm%d.%s' % (i, name)] = lp[name]
    return out


@pytest.mark.parametrize('name', MODELS)
def test_h5_loads_bit_equal(name):
    path = os.path.join(PRETRAINED, name)
    jcfg, jvocab, jhist = jh5.load_config(path)
    tcfg, tvocab, thist = th5.load_config(path)
    # the JAX package's keys equal; the port's AWD-LSTM keys at their
    # defaults (one width, no head bias, no weight drop or locked dropout)
    tdict = dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jcfg) == {k: tdict[k]
                                        for k in dataclasses.asdict(jcfg)}
    assert {k: v for k, v in tdict.items()
            if k not in dataclasses.asdict(jcfg)} == {
        'widths': (), 'head_bias': False,
        'weight_drop': 0.0, 'dropout_input': 0.0, 'dropout_hidden': 0.0,
        'dropout_output': 0.0}
    np.testing.assert_array_equal(jvocab.to_codepoints(),
                                  tvocab.to_codepoints())
    assert jvocab.c2i == tvocab.c2i and jhist == thist
    jp = _flat(jh5.load_weights(path, jcfg))
    tp = _flat(th5.load_weights(path, tcfg))
    assert jp.keys() == tp.keys()
    for key in jp:
        a, b = np.asarray(jp[key]), np.asarray(tp[key])
        assert a.dtype == b.dtype == np.float32, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_params_from_numpy_round_trip():
    path = os.path.join(PRETRAINED, 'model_german.h5')
    cfg, _, _ = th5.load_config(path)
    tree = th5.load_weights(path, cfg)
    params = tlm.params_from_numpy(tree, 'cpu')
    W = cfg.width
    assert tuple(params['lstm'][0]['kernel'].shape) == (cfg.input_dim, 4 * W)
    assert tuple(params['lstm'][1]['recurrent'].shape) == (W, 4 * W)
    assert tuple(params['lstm'][1]['bias'].shape) == (4 * W,)
    back = {k: v.numpy() for k, v in _flat(params).items()}
    for key, want in _flat(tree).items():
        assert back[key].dtype == np.float32
        np.testing.assert_array_equal(back[key], want, err_msg=key)


@pytest.mark.parametrize('depth', [1, 2])
@pytest.mark.parametrize('n_ctx', [0, 1])
def test_forward_step_matches_jax(depth, n_ctx):
    """The German model's weights, cut to ``depth`` layers and to
    ``n_ctx`` context variables (without one, layer 0 keeps only its
    char rows): probabilities agree within 1e-6 (f32, another
    summation order), the carry within 1e-5."""
    path = os.path.join(PRETRAINED, 'model_german.h5')
    cfg, vocab, _ = jh5.load_config(path)
    tree = jh5.load_weights(path, cfg)
    W = cfg.width
    tree['lstm'] = tree['lstm'][:depth]
    contexts = cfg.contexts[:n_ctx]
    tree['context_embeddings'] = tree['context_embeddings'][:n_ctx]
    if not n_ctx:
        tree['lstm'][0] = dict(tree['lstm'][0],
                               kernel=tree['lstm'][0]['kernel'][:W])
    jcfg = cfg.replace(depth=depth, contexts=contexts)
    tcfg = tlm.LMConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(11)
    B = 6
    x = rng.integers(1, vocab.size, B).astype(np.int32)
    zs = [rng.integers(0, n, B).astype(np.int32) for n, _ in contexts]
    h = rng.normal(0, 0.5, (depth, B, W)).astype(np.float32)
    c = rng.normal(0, 0.5, (depth, B, W)).astype(np.float32)
    pj, (hj, cj) = jlm.forward_step(tree, jcfg, x, zs, (h, c))
    T = torch.from_numpy
    pt, (ht, ct) = tlm.forward_step(
        tlm.params_from_numpy(tree, 'cpu'), tcfg, T(x).long(),
        [T(z).long() for z in zs], (T(h), T(c)))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=1e-5)
