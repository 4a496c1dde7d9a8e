"""Parity of the port's batched serving decode (``Rater.rate_best_batch``,
``_begin``/``_finish``, ``concat_graphs``) on the CPU with the JAX
``Rater``'s document-batched fused path (``decode_lattice_pallas_batch``
in interpret mode: ``fused_decode = True``) on the same weights, over
the lattices of ``test_decode_kernel.py`` (batch against sequential,
block chaining, ``concat_graphs``, interleaved begin/finish) and
``test_decode_exhaustive.py`` (the brute-force golden).

Paths are identical element for element (element and TextEquiv);
per-char scores and entropies agree within 1e-4.  Glyph lattices (every
alternative a single char) take the unmerged prep in both packages; the
JAX package decides that only when its native C++ scan loads, so the
comparisons that depend on it skip, saying why, when it does not."""
import gc

import numpy as np
import pytest
import torch

from ocrd_keraslm_tpu import native
from ocrd_keraslm_tpu.rater import Rater as JRater
from ocrd_keraslm_torch.rater import (DECODE_MERGE_MAX,
                                      NonLinearLatticeError, _decode_scan,
                                      _linear_edges)
from ocrd_keraslm_torch.rater import Rater as TRater
from ocrd_keraslm_tpu.wrapper.page import TextEquivType

from test_decode_exhaustive import (brute_force, make_rater,
                                    random_lattice,
                                    random_multichar_lattice)
from test_decode_kernel import _toy_graph
from test_torch_parallel import one_rank_mesh
from test_torch_rater import port_of

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-4


def _native_or_skip():
    if native.load_decode_prep() is None:
        pytest.skip("the JAX package's native decode prep did not load "
                    "(g++ at first use): without it the JAX batch path "
                    "keeps the merged prep, so its per-char scores are not "
                    "the port's unmerged ones")


@pytest.fixture(scope='module')
def raters():
    jr = make_rater(5)
    jr.fused_decode = True   # JAX's Pallas batch kernel, interpret mode
    return jr, port_of(jr)


def _same(got, want, tol=TOL):
    """Identical paths (element and TextEquiv), scores and entropies
    within ``tol``."""
    assert len(got) == len(want)
    for (p_g, e_g), (p_w, e_w) in zip(got, want):
        assert [(el, te) for el, te, _ in p_g] == \
            [(el, te) for el, te, _ in p_w]
        np.testing.assert_allclose([s for _, _, s in p_g],
                                   [s for _, _, s in p_w], rtol=0, atol=tol)
        assert e_g == pytest.approx(e_w, abs=tol)


def _text(path):
    return ''.join(te.Unicode for _, te, _ in path)


def _lattices():
    specs = [(['abcd'], {(0, 2): [('x', 0.92), ('c', 0.90)]}),
             (['abcd', 'abcd'], {(1, 1): [('y', 0.92), ('b', 0.90)]}),
             (['ab'], None)]
    out = [_toy_graph(w, alternatives=a)[0] for w, a in specs]
    out.append(random_lattice(np.random.default_rng(1), 5, 3)[0])
    out.append(random_multichar_lattice(np.random.default_rng(21), 5,
                                        2)[0])
    return out


@pytest.mark.parametrize('merge', [True, False])
def test_decode_scan_matches_native(merge):
    """The port's Python scan gives the JAX package's native
    ``decode_scan`` (prepared edges, longest alternative) and the
    edge count of the port's own prep."""
    _native_or_skip()
    tr = TRater(device='cpu')
    tr.vocab.assign('abcdefghijk')
    for graph in _lattices():
        raw = _linear_edges(graph)
        for merge_max in (1, DECODE_MERGE_MAX):
            got = _decode_scan(raw, merge, merge_max)
            assert got == tuple(native.decode_scan(raw, merge, merge_max))
        assert got[0] == len(tr._prepare_decode_edges(raw, merge=merge))


def test_batch_matches_jax_and_sequential(raters):
    """``test_pallas_batch_decode_matches_sequential``'s lattices: the
    port's batch equals the JAX batch, its strings and entropies equal
    the merged sequential decode, and its per-char scores the unmerged
    sequential decode (the batch took the unmerged prep)."""
    _native_or_skip()
    jr, tr = raters
    graphs = _lattices()[:3]
    got = tr.rate_best_batch(graphs, lm_weight=0.7, beam_width=4)
    _same(got, jr.rate_best_batch(graphs, lm_weight=0.7, beam_width=4))
    seq = [tr.rate_best_device(g, 0, 0, lm_weight=0.7, beam_width=4)[:2]
           for g in graphs]
    tr.merge_runs = False
    try:
        seq_u = [tr.rate_best_device(g, 0, 0, lm_weight=0.7,
                                     beam_width=4)[:2] for g in graphs]
    finally:
        tr.merge_runs = True
    for (p_b, e_b), (p_s, e_s) in zip(got, seq):
        assert _text(p_b) == _text(p_s)
        assert abs(e_b - e_s) < 1e-3
    _same(got, seq_u)


def test_blocks_and_groups_match_jax(raters):
    """``test_pallas_batch_decode_blocks_and_groups``: 18 documents
    (two JAX groups of 16 at K=8, one batch here) chained over forced
    16-edge blocks on both sides, against the JAX batch and the port's
    sequential decodes."""
    jr, tr = raters
    specs = []
    for k in range(18):
        n_words = 1 + k % 5
        alts = {(wi, ci): [('abcd '[(ci + 1 + k) % 5], 0.85),
                           ('abcd'[ci], 0.90)]
                for wi in range(n_words) for ci in range(4)}
        specs.append((['abcd'] * n_words, alts))
    graphs = [_toy_graph(w, alternatives=a)[0] for w, a in specs]
    jr.fused_batch_E_blk = tr.fused_batch_E_blk = 16
    try:
        got = tr.rate_best_batch(graphs, lm_weight=0.6, beam_width=4)
        want = jr.rate_best_batch(graphs, lm_weight=0.6, beam_width=4)
    finally:
        jr.fused_batch_E_blk = tr.fused_batch_E_blk = None
    _same(got, want)
    seq = [tr.rate_best_device(g, 0, 0, lm_weight=0.6, beam_width=4)[:2]
           for g in graphs]
    _same(got, seq)


def test_chained_blocks_walk_back_through_every_block(raters):
    """Five random 3-alternative lattices of 37-45 edges over forced
    16-edge blocks: the best final hypothesis enters a block through
    another slot than the best one at that block's end, so every block's
    walk must start where the walk of the block after it ended."""
    jr, tr = raters
    graphs = [random_lattice(np.random.default_rng(40 + k), 37 + 2 * k,
                             3)[0] for k in range(5)]
    jr.fused_batch_E_blk = tr.fused_batch_E_blk = 16
    try:
        got = tr.rate_best_batch(graphs, lm_weight=0.6, beam_width=4)
        want = jr.rate_best_batch(graphs, lm_weight=0.6, beam_width=4)
    finally:
        jr.fused_batch_E_blk = tr.fused_batch_E_blk = None
    _same(got, want)
    _same(got, [tr.rate_best_device(g, 0, 0, lm_weight=0.6,
                                    beam_width=4)[:2] for g in graphs])


def test_concat_graphs_multipage(raters):
    """``test_batch_decode_multipage_concat``: two pages joined by
    ``concat_graphs`` decode as the page chain of ``rate_best_device``
    with the carried beam, elements kept for re-splitting; the JAX
    package's ``concat_graphs`` and batch give the same."""
    _native_or_skip()
    jr, tr = raters
    pages = [_toy_graph(['abcd'])[0], _toy_graph(['abcd'])[0]]
    doc1 = TRater.concat_graphs(pages)
    j_doc1 = JRater.concat_graphs(pages)
    assert list(doc1.edges(data=True)) == list(j_doc1.edges(data=True))
    doc2 = _toy_graph(['ab'])[0]
    got = tr.rate_best_batch([doc1, doc2], beam_width=4)
    _same(got, jr.rate_best_batch([j_doc1, doc2], beam_width=4))
    p1, e1, tb = tr.rate_best_device(pages[0], 0, 0, beam_width=4)
    p2, e2, _ = tr.rate_best_device(pages[1], 0, 0, device_traceback=tb,
                                    beam_width=4)
    assert _text(got[0][0]) == _text(p1) + _text(p2)
    assert got[0][1] == pytest.approx(e1 + e2, abs=1e-3)
    elements = [el for el, _, _ in got[0][0]]
    assert elements.count('w0_c0') == 2


def test_interleaved_begin_finish(raters):
    """``test_batch_begin_finish_double_buffered_matches_sync``: batch B
    launched before batch A finishes gives the synchronous results, in
    either finish order; empty and single-document batches resolve in
    begin.  The synchronous results equal the JAX batch's."""
    _native_or_skip()
    jr, tr = raters
    specs_a = [(['abcd'], {(0, 2): [('x', 0.92), ('c', 0.90)]}),
               (['abcd', 'ab'], None), (['dcba'], None)]
    specs_b = [(['ab', 'cd'], None),
               (['abcd'], {(0, 0): [('d', 0.95), ('a', 0.94)]})]
    graphs_a = [_toy_graph(w, alternatives=al)[0] for w, al in specs_a]
    graphs_b = [_toy_graph(w, alternatives=al)[0] for w, al in specs_b]
    sync_a = tr.rate_best_batch(graphs_a, beam_width=4)
    sync_b = tr.rate_best_batch(graphs_b, beam_width=4, lm_weight=0.7)
    _same(sync_a, jr.rate_best_batch(graphs_a, beam_width=4))
    _same(sync_b, jr.rate_best_batch(graphs_b, beam_width=4,
                                     lm_weight=0.7))
    for order in ('ab', 'ba'):
        pending = {'a': tr.rate_best_batch_begin(graphs_a, beam_width=4),
                   'b': tr.rate_best_batch_begin(graphs_b, beam_width=4,
                                                 lm_weight=0.7)}
        got = {k: tr.rate_best_batch_finish(pending[k]) for k in order}
        assert got['a'] == sync_a and got['b'] == sync_b
    assert tr.rate_best_batch_finish(tr.rate_best_batch_begin(
        [], beam_width=4)) == []
    single = tr.rate_best_batch_begin([graphs_a[0]], beam_width=4)
    assert single[0] == 'done'
    _same(tr.rate_best_batch_finish(single),
          jr.rate_best_batch([graphs_a[0]], beam_width=4))
    # one live document among empty ones: the single-document decode
    # (merged prep), as in JAX
    docs = [_toy_graph([])[0], graphs_a[1], _toy_graph([])[0]]
    got = tr.rate_best_batch(docs, beam_width=4)
    assert got[0] == got[2] == ([], 0.0)
    _same(got, jr.rate_best_batch(docs, beam_width=4))
    _same(got[1:2], [tr.rate_best_device(graphs_a[1], 0, 0,
                                         beam_width=4)[:2]])


@pytest.mark.parametrize('multichar', [False, True])
def test_batch_matches_exhaustive(multichar):
    """``test_batch_decode_matches_exhaustive`` (and its multi-char
    twin): every document's globally optimal path, as the JAX batch
    finds it."""
    jr = make_rater(7 if multichar else 5)
    jr.fused_decode = True
    tr = port_of(jr)
    docs = []
    for seed in ((31, 32, 33) if multichar else (11, 12, 13)):
        rng = np.random.default_rng(seed)
        if multichar:
            graph, alts = random_multichar_lattice(rng, 3 + seed % 3, 2)
        else:
            graph, alts = random_lattice(rng, 3 + seed % 3, 3)
        docs.append((graph, alts) + brute_force(jr, alts, 0.6))
    graphs = [d[0] for d in docs]
    got = tr.rate_best_batch(graphs, lm_weight=0.6, beam_width=27)
    for (_, alts, want_choice, want_cost), (path, entropy) in zip(docs,
                                                                   got):
        assert tuple(alts[e].index(te) for e, (_, te, _) in
                     enumerate(path)) == want_choice
        assert abs(entropy - want_cost) < 1e-2, (entropy, want_cost)
    if not multichar:   # single-char glyphs: the unmerged prep
        _native_or_skip()
    _same(got, jr.rate_best_batch(graphs, lm_weight=0.6, beam_width=27))


def test_unported_and_invalid_batches_raise(raters, monkeypatch):
    """A branching lattice raises ``NonLinearLatticeError`` (no host
    fallback in the batch API, as in JAX); a beam wider than 32 or an
    alternative longer than 64 chars takes the unbounded engine (pending
    ``'xlab'``), each document as it decodes alone; over a mesh of one
    rank the documents go through the sharded path (``parallel/
    decode.py``: padded, walked, gathered) and decode bit for bit as
    without one."""
    _, tr = raters
    g = _toy_graph(['ab'])[0]
    branching = g.copy()
    branching.add_edge(0, 'detour', element=None, alternatives=[])
    with pytest.raises(NonLinearLatticeError, match='linear lattice'):
        tr.rate_best_batch([g, branching], beam_width=4)
    long_alt = _toy_graph(['ab'])[0]
    long_alt.add_edge(2, 3, element='long', alternatives=[
        TextEquivType(Unicode='a' * 65, conf=0.9, index=0),
        TextEquivType(Unicode='b', conf=0.8, index=1)])
    for docs, beam in (([g, g], 40), ([g, long_alt], 4)):
        pending = tr.rate_best_batch_begin(docs, beam_width=beam)
        assert pending[0] == 'xlab'
        _same(tr.rate_best_batch_finish(pending),
              [tr.rate_best_device(d, 0, 0, beam_width=beam)[:2]
               for d in docs])
    want = tr.rate_best_batch([g, long_alt], beam_width=4)
    with one_rank_mesh() as mesh:
        monkeypatch.setattr(tr, 'mesh', mesh)
        pending = tr.rate_best_batch_begin([g, long_alt], beam_width=4)
        assert pending[0] == 'sharded'
        _same(tr.rate_best_batch_finish(pending), want, tol=0.0)


def test_gc_paused_restores_collector_state(raters):
    """``test_gc_paused_restores_collector_state``: the collector's
    state survives a batch, its error path and an outer disable."""
    _, tr = raters
    graph = _toy_graph(['ab'])[0]
    assert gc.isenabled()
    tr.rate_best_batch([graph, graph], beam_width=4)
    assert gc.isenabled()
    with pytest.raises(Exception):
        tr.rate_best_batch_finish(object())
    assert gc.isenabled()
    gc.disable()
    try:
        tr.rate_best_batch([graph, graph], beam_width=4)
        assert not gc.isenabled()
    finally:
        gc.enable()
