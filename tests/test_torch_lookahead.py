"""Lookahead write-back in the port (``lookahead_writeback=true``, the
reference's lock-in, lib/rating.py:736-741): page N's path is the one
the globally best final path runs through, found by walking the pages
in reverse with the entry slot chained.  Held against the JAX package:
the walk's mechanics, the decode of the concatenated pages, the
processor's write order and its failed-walk policy, and the entry
slot's anchor (``test_decode_kernel.py``'s
``test_cross_page_entry_slot_anchor``)."""
import os

import numpy as np
import pytest
import torch

from ocrd_keraslm_tpu.rater import Rater as JRater
from ocrd_keraslm_torch.rater import Rater as TRater
from ocrd_keraslm_torch.wrapper.page import TextEquivType

from helpers import build_workspace, make_tiny_model, train_tiny_model
from test_decode_kernel import _toy_graph
from test_torch_rater import port_of

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)


class _TE:
    def __init__(self, u):
        self.Unicode = u
        self.conf = 0.9


def _rows(bp, alt, cost):
    return np.asarray([list(bp) + list(alt) + list(cost)], np.float32)


@pytest.mark.parametrize('rater_cls', ['port', 'jax'])
def test_walk_chaining_mechanics(rater_cls):
    """Two one-edge pages of records: the later page's walk decides the
    earlier page's start slot, in the port as in the JAX package."""
    r = TRater(device='cpu') if rater_cls == 'port' else JRater()
    K = 4
    meta = [{'alts': [_TE('a'), _TE('b'), _TE('c'), _TE('d')],
             'parts': None, 'element': None}]
    header = np.zeros((1, 3 * K), np.float32)
    page2 = np.concatenate([header, _rows([1, 0, 2, 3], [2, 0, 1, 3],
                                          [5., 6., 7., 8.])])
    page1 = np.concatenate([header, _rows([0, 2, 1, 3], [0, 3, 1, 2],
                                          [1., 2., 3., 4.])])
    pend2 = ('blocks', meta, [page2], K)
    pend1 = ('blocks', meta, [page1], K)
    (path2, _), entry = r.rate_best_device_finish(pend2, start_slot=0,
                                                  return_entry=True)
    assert entry == 1 and path2[0][1].Unicode == 'c'
    (path1, _), entry1 = r.rate_best_device_finish(
        pend1, start_slot=entry, return_entry=True)
    assert path1[0][1].Unicode == 'd' and entry1 == 2
    assert r.rate_best_device_finish(pend1)[0][0][1].Unicode == 'a'
    single = ('single', meta, [np.zeros((2, 2), np.float32)], K)
    with pytest.raises(ValueError, match='defer_walk'):
        r.rate_best_device_finish(single, return_entry=True)


@pytest.fixture(scope='module')
def raters(tmp_path_factory):
    model = make_tiny_model(tmp_path_factory.mktemp('m') / 'model.h5')
    jr = JRater()
    jr.load_config(model)
    jr.stateful, jr.incremental = False, True
    jr.configure()
    jr.load_weights(model)
    return jr, port_of(jr), model


def _pages(vocab, rng, n_pages=3, n_edges=12):
    import networkx as nx
    chars = [c for c in vocab.c2i if c.strip()]
    pages = []
    for _ in range(n_pages):
        g = nx.DiGraph()
        g.add_node(0)
        for e in range(n_edges):
            tes = [TextEquivType(Unicode=chars[rng.integers(len(chars))],
                                 conf=float(0.5 + 0.5 * rng.random()),
                                 index=i) for i in range(3)]
            g.add_edge(e, e + 1, element='g%d' % e, alternatives=tes)
        pages.append(g)
    return pages


def _lookahead_texts(r, pages):
    tb, pendings = None, []
    for g in pages:
        pending, tb = r.rate_best_device_begin(
            g, 0, len(g.edges), device_traceback=tb, beam_width=8,
            defer_walk=True)
        assert pending[0] == 'blocks'
        pendings.append(pending)
    pendings = r.fetch_pendings(pendings)
    slot, texts = 0, [None] * len(pages)
    for pi in range(len(pages) - 1, -1, -1):
        (path, _), slot = r.rate_best_device_finish(
            pendings[pi], start_slot=slot, return_entry=True)
        texts[pi] = ''.join(te.Unicode for _, te, _ in path)
    return texts


@pytest.mark.parametrize('seed', [7, 19, 42])
def test_lookahead_equals_concatenated_decode(raters, seed):
    """Per-page decodes walked with lookahead give exactly the decode
    of all pages as one lattice (the globally best path), in the port
    and in the JAX package (Pallas kernel in interpret mode)."""
    jr, tr, _ = raters
    pages = _pages(tr.vocab, np.random.default_rng(seed))
    whole = tr.concat_graphs(pages)
    path_all = tr.rate_best_device(whole, 0, len(whole.edges),
                                   beam_width=8)[0]
    text_all = ''.join(te.Unicode for _, te, _ in path_all)
    assert ''.join(_lookahead_texts(tr, pages)) == text_all
    jr.fused_decode = True
    try:
        assert _lookahead_texts(jr, pages) == _lookahead_texts(tr, pages)
    finally:
        jr.fused_decode = False


PAGES = {'page%d' % i: [['the', 'fox'], ['dog', 'ran']] for i in (1, 2, 3)}
ALTS = {(0, 0, 1): [('h', 0.9), ('b', 0.88)],
        (1, 1, 0): [('r', 0.8), ('v', 0.79)]}


def _processor(cls, ws, model, **kw):
    proc = cls(workspace=ws, input_file_grp='OCR-D-OCR',
               output_file_grp='OCR-D-LM', parameter={
                   'model_file': model, 'textequiv_level': 'word',
                   'lookahead_writeback': True}, **kw)
    proc.setup()
    return proc


def test_lookahead_write_order_and_jax(tmp_path, raters):
    """Every page is written, in forward page order; the output content
    equals the JAX processor's."""
    from ocrd_keraslm_tpu.wrapper import KerasRate as JKerasRate
    from ocrd_keraslm_torch.wrapper import KerasRate
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    from test_page_fast import _page_content
    _, _, model = raters
    outs = {}
    for name in ('port', 'jax'):
        d = str(tmp_path / name)
        ws = build_workspace(d, PAGES, glyph_alternatives=ALTS)
        if name == 'port':
            proc = _processor(KerasRate, ws, model, device='cpu')
        else:
            proc = _processor(JKerasRate, ws, model)
            proc.rater.fused_decode = True
        proc.process_workspace(proc.workspace)
        files = list(Workspace(d).mets.find_files(fileGrp='OCR-D-LM'))
        paths = sorted(os.path.join(d, f.local_filename) for f in files)
        assert len(paths) == 3
        mtimes = [os.stat(p).st_mtime_ns for p in paths]
        assert mtimes == sorted(mtimes)
        outs[name] = [_page_content(open(p, encoding='utf-8').read())[1]
                      for p in paths]
    assert outs['port'] == outs['jax']


def test_lookahead_walk_failure_restarts_at_slot_0(tmp_path, raters,
                                                   monkeypatch):
    """A walk that fails on one page does not abort the document: the
    chain restarts at slot 0, the page is finished again in the write
    loop under the page policy, and every page is written."""
    from ocrd_keraslm_torch.wrapper import KerasRate
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    _, _, model = raters
    d = str(tmp_path / 'ws')
    ws = build_workspace(d, PAGES, glyph_alternatives=ALTS)
    monkeypatch.setenv('OCRD_MISSING_OUTPUT', 'SKIP')
    proc = _processor(KerasRate, ws, model, device='cpu')
    orig = proc.rater.rate_best_device_finish
    calls = []

    def flaky(pending, start_slot=0, return_entry=False):
        if return_entry:
            calls.append(start_slot)
            if len(calls) == 2:     # the middle page of the reverse walk
                raise RuntimeError('injected walk failure')
        return orig(pending, start_slot=start_slot,
                    return_entry=return_entry)

    monkeypatch.setattr(proc.rater, 'rate_best_device_finish', flaky)
    proc.process_workspace(proc.workspace)
    assert len(calls) == 3 and calls[0] == 0 and calls[2] == 0
    assert len(list(Workspace(d).mets.find_files(fileGrp='OCR-D-LM'))) == 3


@pytest.fixture(scope='module')
def ambig(tmp_path_factory):
    """A model trained on 'abcd' and 'abxe': after 'ab', 'c' and 'x' are
    near-equally likely and only the next page resolves which."""
    path = tmp_path_factory.mktemp('ma') / 'lm.h5'
    model, _ = train_tiny_model(str(path), 'abcd abxe ' * 300, width=24,
                                length=64, steps=1500)
    jr = JRater()
    jr.load_config(model)
    jr.configure()
    jr.load_weights(model)
    return jr, port_of(jr)


def _anchor(r):
    """Decode two pages, the second walked from its records; returns
    (entry slot, entropy, text) of page 2 after checking the anchor."""
    g1, s1, e1 = _toy_graph(['abcd', 'abc'],
                            alternatives={(1, 2): [('x', 0.95), ('c', 0.5)]})
    path1, _, tb = r.rate_best_device(g1, s1, e1, beam_width=4)
    assert path1[-1][1].Unicode == 'x'
    g2, s2, e2 = _toy_graph(['d', 'ab'])
    pending, _ = r.rate_best_device_begin(
        g2, s2, e2, device_traceback=tb, beam_width=4, defer_walk=True)
    pending = r.fetch_pendings([pending])[0]
    (path2, ent2), entry = r.rate_best_device_finish(pending,
                                                     return_entry=True)
    assert entry != 0
    cost0 = np.asarray(tb[-1], np.float64).reshape(-1)
    rows = np.concatenate([np.asarray(b)[1:] for b in pending[2]])
    K, nE = pending[3], len(pending[1])
    final_cost = float(rows[nE - 1, 2 * K])
    assert ent2 == pytest.approx(final_cost - cost0[entry], abs=1e-4)
    assert cost0[entry] > cost0.min() + 1e-6
    return entry, ent2, ''.join(te.Unicode for _, te, _ in path2)


@pytest.mark.parametrize('side', ['port', 'jax'])
def test_cross_page_entry_slot_anchor(ambig, side):
    """Page 2's best path continues from a NON-best slot of page 1's
    final beam; its entropy is the final cost minus that ENTRY slot's
    carried cost (each side), and the port's entry slot, path and
    entropy equal the JAX package's (Pallas kernel in interpret
    mode)."""
    jr, tr = ambig
    jr.fused_decode = True
    try:
        got = _anchor(tr if side == 'port' else jr)
        if side == 'port':
            want = _anchor(jr)
            assert (got[0], got[2]) == (want[0], want[2])
            assert abs(got[1] - want[1]) <= 1e-4
    finally:
        jr.fused_decode = False
