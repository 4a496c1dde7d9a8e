"""Parity of the port's plain generation kernels (``gen_beam_ref`` and
``traceback_ref``, what ``gen_beam`` and ``traceback`` run for CPU
tensors) with the JAX Pallas kernels ``_gen_pallas_raw`` and
``_traceback_pallas`` in interpret mode.

The beam search runs on the weights of ``pretrained/model_german.h5``
(trained weights: on exactly equal logits the two packages may keep
different members of a tied set, ``gen_kernel.py:42-48`` of the JAX
package), from the fringe that JAX's ``_prefix_fringe`` conditions on a
seeded prefix, at K=256/TOPK=10 and K=32/TOPK=4.  Tolerances: over live
slots (cost < 1e38) chars and backpointers equal, costs within rtol
1e-5; the port's prefix fringe within atol 1e-5 of JAX's, plus rtol
2e-5 (cell states grow to ~80 over a long prompt, where one f32 ulp is
7.6e-6)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ocrd_keraslm_tpu.ops import gen_kernel as jgk
from ocrd_keraslm_tpu.ops.beam_device import _gen_weights as j_gen_weights
from ocrd_keraslm_tpu.rater import Rater as JRater
from ocrd_keraslm_torch.ops import gen_kernel as gk
from ocrd_keraslm_torch.ops.beam_device import _prefix_arrays
from ocrd_keraslm_torch.rater import Rater

from test_torch_scoring import GERMAN

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

WORDS = ('Die Vernunft ist das Vermögen der Prinzipien und der Mensch '
         'denkt über die Natur').split()


@pytest.fixture(scope='module')
def weights():
    """(numpy generation weights of the german model, v_real, JAX rater)"""
    jr = JRater()
    jr.load_config(GERMAN)
    jr.configure()
    jr.load_weights(GERMAN)
    emb, embT, wcat, bias, v_real = j_gen_weights(
        jr, jr.underspecify_contexts())
    return ([np.array(a) for a in (emb, embT, wcat, bias)], int(v_real),
            jr)


def _seeded_prefix(rng, n_words):
    return ' '.join(WORDS[i] for i in rng.integers(len(WORDS),
                                                   size=n_words)) + ' '


def _jax_fringe(weights, prefix, fringe):
    ws, v_real, jr = weights
    ids, mask = _prefix_arrays([jr.vocab.encode(prefix)])
    state0, cost0 = jgk._prefix_fringe(*ws, jnp.asarray(ids[0]),
                                       jnp.asarray(mask[0]), v_real, fringe)
    return ids, mask, np.array(state0), np.array(cost0)


def _hold_live(got, want):
    """got, want: (T, 3, K) records; live slots equal as the module
    docstring says.  Returns the number of live slots compared."""
    live = want[:, 2] < 1e38
    np.testing.assert_array_equal(got[:, 2] < 1e38, live)
    for q in (0, 1):
        np.testing.assert_array_equal(got[:, q][live], want[:, q][live])
    np.testing.assert_allclose(got[:, 2][live], want[:, 2][live],
                               rtol=1e-5)
    return int(live.sum())


@pytest.mark.parametrize('fringe, topk, length', [
    (256, 10, 8), (256, 10, 16), (32, 4, 16)])
def test_gen_beam_ref_matches_pallas(weights, fringe, topk, length):
    ws, v_real, _ = weights
    rng = np.random.default_rng(100 * fringe + length)
    _, _, state0, cost0 = _jax_fringe(weights, _seeded_prefix(rng, 3),
                                      fringe)
    want = np.asarray(jgk._gen_pallas_raw(
        *ws, state0, cost0, length, v_real, topk, fringe, 0.004))[:, :3]
    T = torch.from_numpy
    got = gk.gen_beam_ref(*map(T, ws), T(state0)[None], T(cost0)[None, :, 0],
                          length=length, v_real=v_real, topk=topk)
    assert got.shape == (1, length, 3, fringe)
    n_live = _hold_live(got[0].numpy(), want)
    assert n_live > fringe  # the fringe fills after the first steps


@pytest.mark.parametrize('n_words', [1, 3, 14])
def test_prefix_fringe_matches_jax(weights, n_words):
    """Prompts of one word, of a few and of more than 64 chars (the
    second prefix bucket), two streams at once in the port."""
    ws, v_real, jr = weights
    rng = np.random.default_rng(n_words)
    prefixes = [_seeded_prefix(rng, n_words), 'Was ist ']
    ids, mask = _prefix_arrays([jr.vocab.encode(p) for p in prefixes])
    T = torch.from_numpy
    state0, cost0 = gk._prefix_fringe(*map(T, ws), ids, mask, v_real, 16)
    for s in range(2):
        j_state, j_cost = jgk._prefix_fringe(
            *ws, jnp.asarray(ids[s]), jnp.asarray(mask[s]), v_real, 16)
        np.testing.assert_allclose(state0[s].numpy(), np.asarray(j_state),
                                   rtol=2e-5, atol=1e-5)
        np.testing.assert_array_equal(cost0[s].numpy(),
                                      np.asarray(j_cost)[:, 0])
    assert len(prefixes[0]) > 64 or n_words < 14


def _records(rng, T, K):
    """Seeded consistent records (T, 8, K) as the TPU kernel lays them
    out: chars in 1..69, backpointers into the K slots, costs."""
    rec = np.zeros((T, 8, K), np.float32)
    rec[:, 0] = rng.integers(1, 70, (T, K))
    rec[:, 1] = rng.integers(0, K, (T, K))
    rec[:, 2] = np.sort(rng.uniform(0, 50, (T, K)), axis=1)
    return rec


@pytest.mark.parametrize('out_length', [32, 21, 1])
def test_traceback_ref_matches_pallas(out_length):
    rng = np.random.default_rng(out_length)
    T, K = 32, 16
    rec = _records(rng, T, K)
    best = rng.choice(K, 3, replace=False).astype(np.int32)
    want = np.asarray(jgk._traceback_pallas(jnp.asarray(rec),
                                            jnp.asarray(best), out_length))
    got = gk.traceback_ref(torch.from_numpy(rec[None, :, :3].copy()),
                           torch.from_numpy(best[None]), out_length)[0]
    np.testing.assert_array_equal(got[:, :out_length].numpy(),
                                  want[:, :out_length])
    assert not got[:, out_length:].any()


def test_final_state_resumes_the_search(weights):
    """t steps, then the rest from the returned fringe (state and the
    last records' costs), give the records of one run over all steps."""
    ws, v_real, _ = weights
    _, _, state0, cost0 = _jax_fringe(weights, 'Der Mensch ', 32)
    args = [torch.from_numpy(w) for w in ws]
    st, co = torch.from_numpy(state0)[None], torch.from_numpy(cost0)[None, :, 0]
    whole = gk.gen_beam(*args, st, co, length=9, v_real=v_real, topk=4)
    head, state = gk.gen_beam(*args, st, co, length=4, v_real=v_real, topk=4,
                              final_state=True)
    tail = gk.gen_beam(*args, state, head[:, -1, 2].contiguous(), length=5,
                       v_real=v_real, topk=4)
    assert torch.equal(torch.cat([head, tail], 1), whole)


def test_cpu_tensors_take_the_plain_versions(weights):
    """On CPU tensors both wrappers run their plain versions and count no
    kernel launch; inputs on two devices are refused."""
    ws, v_real, _ = weights
    args = [torch.from_numpy(w) for w in ws]
    state0 = torch.cat([args[0][5].expand(1, 8, 128),
                        torch.zeros(1, 8, 4 * 128)], 2)
    cost0 = torch.full((1, 8), gk.BIG)
    cost0[0, 0] = 0.0
    gk.gen_beam.launches = gk.traceback.launches = 0
    rec = gk.gen_beam(*args, state0, cost0, length=3, v_real=v_real)
    best = torch.zeros((1, 2), dtype=torch.int32)
    seqs = gk.traceback(rec, best, 3)
    assert seqs.shape == (1, 2, 3) and (seqs > 0).all()
    assert gk.gen_beam.launches == gk.traceback.launches == 0
    with pytest.raises(ValueError, match='span devices'):
        gk.gen_beam(*args, state0.to('meta'), cost0, length=3,
                    v_real=v_real)
    with pytest.raises(ValueError, match='span devices'):
        gk.traceback(rec, best.to('meta'), 3)


def test_rater_generation_uses_the_wrappers(monkeypatch):
    """``Rater.generate`` runs the beam-step and traceback wrappers once
    a call, for one prompt or a batch."""
    rater = Rater(device='cpu')
    rater.load_config(GERMAN)
    rater.configure()
    rater.load_weights(GERMAN)
    calls = []
    for name in ('gen_beam_ref', 'traceback_ref'):
        fn = getattr(gk, name)
        monkeypatch.setattr(gk, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    assert len(rater.generate('Die ', 5, variants=2)) == 2
    assert calls == ['gen_beam_ref', 'traceback_ref']
    assert len(rater.generate_batch(['Die ', 'Der '], 5)) == 2
    assert calls[2:] == ['gen_beam_ref', 'traceback_ref']
