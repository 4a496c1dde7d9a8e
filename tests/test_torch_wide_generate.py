"""Parity of the port's generation engine (``generate_device``,
``generate_device_best`` and the ``Rater`` paths through them) on the
CPU with the JAX package's XLA engine, the JAX default on the CPU.

On ``pretrained/model_german.h5``: the records of ``generate_device``
(chars and backpointers equal, costs rtol 1e-5), the best path of
``generate_device_best``, and ``Rater.generate`` (one and several
variants) and ``generate_batch`` (a leading stream axis) under
``fused_generate`` False (the engine), True and ``'force'`` (the beam-step
kernel's plain version at this model): the same strings.  Then a seeded
D=2, W=512 model that no layout of the beam-step kernel takes: the
default switch routes it to the engine, which gives JAX's strings."""
import numpy as np
import pytest
import torch

from ocrd_keraslm_tpu.ops import beam_device as jbd
from ocrd_keraslm_tpu.rater import Rater as JRater
from ocrd_keraslm_torch.ops import beam_device as tbd
from ocrd_keraslm_torch.ops import gen_kernel as gk
from ocrd_keraslm_torch.rater import Rater

from test_torch_rater import port_of
from test_torch_scoring import GERMAN

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def raters():
    jr = JRater()
    tr = Rater(device='cpu')
    for r in (jr, tr):
        r.load_config(GERMAN)
        r.configure()
        r.load_weights(GERMAN)
    return jr, tr


def _prefix(rater, prompt):
    ids = rater.vocab.encode(prompt)
    P = 64
    pid = np.zeros((P,), np.int32)
    pmask = np.zeros((P,), np.float32)
    pid[:len(ids)] = ids
    pmask[:len(ids) - 1] = 1.0
    return pid, pmask


def test_generate_device_records_match_jax(raters):
    """16 steps after 'Die Vernunft ': every step's fringe (chars,
    backpointers, costs) and the best path walked on the device."""
    jr, tr = raters
    pid, pmask = _prefix(tr, 'Die Vernunft ')
    jw = jbd._gen_weights(jr, [0])
    tw = tbd._gen_weights(tr, [0])
    want = jbd.generate_device(*jw[:4], pid, pmask, 16, int(jw[4]))
    got = tbd.generate_device(*tw[:4], pid[None], pmask[None], 16,
                              int(tw[4]))
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    seq_w, cost_w = jbd.generate_device_best(*jw[:4], pid, pmask, 16, 11,
                                             int(jw[4]))
    seq_g, cost_g = tbd.generate_device_best(*tw[:4], pid[None],
                                             pmask[None], 16, 11, int(tw[4]))
    np.testing.assert_array_equal(seq_g[0].numpy(), np.asarray(seq_w))
    assert float(cost_g[0]) == pytest.approx(float(cost_w), rel=1e-5)


@pytest.mark.parametrize('mode', [False, True, 'force'])
@pytest.mark.parametrize('variants', [1, 3])
def test_generate_matches_jax(raters, mode, variants):
    """``Rater.generate`` under each switch against the JAX default (its
    XLA engine); False runs the engine ('gen-best', 'gen-walk': its step
    counter moves), True and 'force' the kernel's plain version."""
    jr, tr = raters
    steps = tbd.generate_device.steps
    tr.fused_generate = mode
    try:
        got = tr.generate('Was ist ', 12, [179], variants)
    finally:
        tr.fused_generate = True
    assert (tbd.generate_device.steps > steps) == (mode is False)
    assert got == jr.generate('Was ist ', 12, [179], variants)
    assert len(got) == variants


def test_generate_batch_engine_matches_jax(raters):
    """Three prompts in one engine search with a leading stream axis:
    the JAX package's vmapped streams, and each prompt alone."""
    jr, tr = raters
    prompts = ['Die Vernunft ', 'Was ist Aufklärung? ', 'Der Mensch']
    tr.fused_generate = False
    try:
        got = tr.generate_batch(prompts, 10)
        alone = [tr.generate(p, 10)[0] for p in prompts]
    finally:
        tr.fused_generate = True
    assert got == jr.generate_batch(prompts, 10) == alone


def _wide_params(rng, V, W, D, ctx):
    """Seeded weights of a D-layer, width-W model whose softmax is not
    flat (embeddings N(0, 0.5)): few near-ties in the beam."""
    def normal(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    lstm = []
    for d in range(D):
        n_in = W + (ctx if d == 0 else 0)
        bias = np.zeros((4 * W,), np.float32)
        bias[W:2 * W] = 1.0
        lstm.append({'kernel': normal(n_in, 4 * W, scale=n_in ** -0.5),
                     'recurrent': normal(W, 4 * W, scale=W ** -0.5),
                     'bias': bias})
    return {'char_embedding': normal(V, W, scale=0.5),
            'context_embeddings': [normal(200, ctx, scale=0.001)],
            'lstm': lstm}


def test_wide_model_generates_through_the_engine(monkeypatch):
    """D=2, W=512: ``gen_layouts`` is empty, so with ``fused_generate``
    at its default the engine runs (the kernel's wrapper is never
    called); strings equal the JAX package's, one prompt and a batch."""
    import jax.numpy as jnp
    jr = JRater()
    jr.width, jr.depth, jr.length = 512, 2, 32
    jr.contexts = ((200, 10),)
    jr.vocab.assign('abcdefghijklmnopqrstuvwxyz .,')
    jr.voc_size = jr.vocab.size
    jr.configure()
    params = _wide_params(np.random.default_rng(0), jr.voc_size, 512, 2,
                          10)
    jr.params = {'char_embedding': jnp.asarray(params['char_embedding']),
                 'context_embeddings': [jnp.asarray(e) for e in
                                        params['context_embeddings']],
                 'lstm': [{k: jnp.asarray(v) for k, v in lp.items()}
                          for lp in params['lstm']]}
    jr.status = 2
    tr = port_of(jr)
    assert gk.gen_layouts(256, 2, 512, 128, 10, jr.voc_size) == []

    def no_kernel(*a, **k):
        raise AssertionError('gen_beam was called')
    monkeypatch.setattr(gk, 'gen_beam', no_kernel)
    assert tr.generate('the ', 8) == jr.generate('the ', 8)
    assert tr.generate('the ', 8, variants=2) == \
        jr.generate('the ', 8, variants=2)
    assert tr.generate_batch(['the ', 'a b'], 8) == \
        jr.generate_batch(['the ', 'a b'], 8)
