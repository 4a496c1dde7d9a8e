"""The port's host decode engine against the JAX package's on the same
weights: ``Rater.predict``, ``rate_best`` with ``next_path`` (diamond
DAG, three pages with the traceback carried, history clustering), and
the processor with ``device_decoding=false`` and with branching pages
bailing from the device lane into the host engine.

Both packages run on the CPU (the port's ``_predict_step`` in PyTorch,
JAX's jitted XLA step); costs are accounted in float64 on the host by
the same code, so paths must be equal and entropies agree within 1e-4,
written confs within 1e-5 (written as '%.6g'), probabilities and states
of ``predict`` within 1e-5."""
import logging
import os
import re
import subprocess
import sys

import networkx as nx
import numpy as np
import pytest
import torch

from helpers import build_workspace, train_tiny_model
from ocrd_keraslm_tpu.rater import NonLinearLatticeError as JNonLinear
from ocrd_keraslm_tpu.rater import Rater as JRater
from ocrd_keraslm_tpu.wrapper import KerasRate as JKerasRate
from ocrd_keraslm_tpu.wrapper import rate as jrate
from ocrd_keraslm_tpu.wrapper.mets import Workspace
from ocrd_keraslm_tpu.wrapper.page import TextEquivType as JTE
from ocrd_keraslm_torch import Node
from ocrd_keraslm_torch.rater import NonLinearLatticeError
from ocrd_keraslm_torch.rater import Rater as TRater
from ocrd_keraslm_torch.wrapper import KerasRate as TKerasRate
from ocrd_keraslm_torch.wrapper import rate as trate
from ocrd_keraslm_torch.wrapper.page import TextEquivType as TTE

from test_torch_processor import GERMAN, REPO, _assert_same, _outputs

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

PAGES = {
    'phys_0001': [['abc', 'cab'], ['bca', 'acb']],
    'phys_0002': [['cba', 'bac'], ['abc', 'cab']],
    'phys_0003': [['bca', 'abc'], ['cab', 'cba']],
}
ALTS = {(li, wi, 0): [('a', 0.93), ('b', 0.91)]
        for li in range(2) for wi in range(2)}
# run timestamps and the device_decoding label differ between runs by
# construction; everything else must match byte for byte
_VOLATILE = re.compile(
    rb'<(Created|LastChange)>[^<]*</\1>'
    rb'|<Label [^>]*type="device_decoding"[^>]*/?>')


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """A tiny model trained on 'abcd ' cycles, loaded by both packages
    for incremental decoding."""
    path = tmp_path_factory.mktemp('m') / 'lm.h5'
    model, _ = train_tiny_model(str(path), 'abcd ' * 200, steps=100)
    raters = []
    for cls, kw in ((JRater, {}), (TRater, {'device': 'cpu'})):
        r = cls(**kw)
        r.load_config(model)
        r.stateful, r.incremental = False, True
        r.configure()
        r.load_weights(model)
        raters.append(r)
    return model, raters[0], raters[1]


@pytest.mark.parametrize('n', [1, 3, 600])
def test_predict_matches_jax(trained, n):
    """Probabilities and states of one step for n hypotheses (600: past
    the largest step bucket), some with states, some fresh."""
    _, jr, tr = trained
    rng = np.random.default_rng(n)
    D, W = jr.depth, jr.width
    chars = [str(rng.choice(list('abcd \n'))) for _ in range(n)]
    states = [None if i % 3 == 0 else
              [rng.normal(0, 0.5, (1, W)).astype(np.float32)
               for _ in range(2 * D)] for i in range(n)]
    jp, js = jr.predict(chars, states, context=[0])
    tp, ts = tr.predict(chars, states, context=[0])
    assert len(tp) == len(jp) == n and len(ts) == n
    np.testing.assert_allclose(np.stack(tp), np.stack(jp), atol=1e-5)
    for j_state, t_state in zip(js, ts):
        assert len(t_state) == 2 * D
        for a, b in zip(t_state, j_state):
            assert a.shape == (1, W)
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_predict_chain_matches_rate2(trained):
    """Chaining the port's incremental engine char by char reproduces
    its whole-sequence probabilities (float16 resolution, as rate()
    ships them) and JAX's chain."""
    model, jr, tr = trained
    text = 'abcd ab'
    chains = []
    for r in (jr, tr):
        states = [None]
        probs = [1.0]
        for i, char in enumerate(text[:-1]):
            preds, states = r.predict([char], states)
            probs.append(float(preds[0][r.vocab.get(text[i + 1])]))
        chains.append(probs)
    whole = TRater(device='cpu')
    whole.load_config(model)
    whole.configure()
    whole.load_weights(model)
    np.testing.assert_allclose(chains[1], whole.rate(text), rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_allclose(chains[1], chains[0], atol=1e-5)


def _diamond(te):
    g = nx.DiGraph()
    g.add_node(0)
    # 0 -> 1 -> 3 (text 'ab') against 0 -> 2 -> 3 (text 'dc')
    for u, v, ch in ((0, 1, 'a'), (1, 3, 'b'), (0, 2, 'd'), (2, 3, 'c')):
        g.add_edge(u, v, element='e%d%d' % (u, v),
                   alternatives=[te(Unicode=ch, conf=0.9, index=0)])
    return g


def _flat(path):
    return [(el, te.Unicode) for el, te, _ in path]


def _same_paths(got, want, tol=1e-4):
    (tp, te), (jp, je) = got, want
    assert _flat(tp) == _flat(jp)
    for (_, _, a), (_, _, b) in zip(tp, jp):
        assert abs(a - b) <= tol, (a, b)
    assert abs(te - je) <= tol, (te, je)


def test_branching_dag_host_decodes_device_rejects(trained):
    """The diamond DAG: the host engine takes the trained text 'ab' over
    'dc', on the same path and entropy as JAX; the device engines refuse
    it with the package's NonLinearLatticeError pointing at rate_best."""
    _, jr, tr = trained
    results = []
    for r, te in ((jr, JTE), (tr, TTE)):
        path, ent, tb = r.rate_best(_diamond(te), 0, 3, beam_width=4)
        pathf, entf, _ = r.next_path(tb[0], ([], tb[1]))
        assert ''.join(t.Unicode for _, t, _ in path + pathf) == 'ab'
        results.append((path + pathf, ent + entf))
    _same_paths(results[1], results[0])
    with pytest.raises(NonLinearLatticeError, match='rate_best'):
        tr.rate_best_device(_diamond(TTE), 0, 3, beam_width=4)
    with pytest.raises(NonLinearLatticeError, match='linear lattice'):
        tr.rate_best_batch([_diamond(TTE)], beam_width=4)


def _page_graph(te, rng, n, page):
    """A linear page lattice of n edges over 'abcd ' with two or three
    alternatives on some of them."""
    g = nx.DiGraph()
    g.add_node(0)
    for i in range(n):
        true = 'abcd '[i % 5]
        alts = [te(Unicode=true, conf=0.9, index=0)]
        if rng.random() < 0.5:
            for j, wrong in enumerate(rng.choice(list('abcd'), 2,
                                                 replace=False)):
                alts.append(te(Unicode=str(wrong),
                               conf=float(rng.uniform(0.8, 0.95)),
                               index=j + 1))
        g.add_edge(i, i + 1, element='p%d_e%d' % (page, i),
                   alternatives=alts)
    return g


def _decode_pages(r, te, clustering, beam_width=4):
    """Three pages with the traceback carried and the final lock-in:
    per page (path, entropy) as the processor writes them."""
    out, tb = [], None
    for page in range(3):
        g = _page_graph(te, np.random.default_rng(page), 12, page)
        path, ent, tb = r.rate_best(g, 0, 12, start_traceback=tb,
                                    beam_width=beam_width,
                                    beam_clustering_dist=clustering)
        out.append((path, ent))
    out.append(r.next_path(tb[0], ([], tb[1]))[:2])
    return out


@pytest.mark.parametrize('clustering', [0, 5])
def test_three_page_carry_with_lock_in(trained, clustering):
    """Page N locks in when page N+1 decodes (the first call returns
    the empty path), the last at next_path; every page's path and
    entropy equal JAX's, with and without history clustering at the
    processor's distance 5."""
    _, jr, tr = trained
    want = _decode_pages(jr, JTE, clustering)
    got = _decode_pages(tr, TTE, clustering)
    assert not got[0][0] and all(p for p, _ in got[1:])
    for g, w in zip(got, want):
        _same_paths(g, w)


def test_clustering_drops_redundant_hypotheses(trained):
    """At distance 5 the host engine keeps one hypothesis per text among
    near states (the tiny model's states are small), so its beam after
    a page is narrower than without clustering, in both packages."""
    _, jr, tr = trained
    widths = {}
    for name, r, te in (('jax', jr, JTE), ('torch', tr, TTE)):
        for dist in (0, 5):
            g = _page_graph(te, np.random.default_rng(7), 8, 0)
            tb = r.rate_best(g, 0, 8, beam_width=8,
                             beam_clustering_dist=dist)[2]
            widths[name, dist] = len(tb[0])
    assert widths['torch', 5] == widths['jax', 5]
    assert widths['torch', 0] == widths['jax', 0]
    assert widths['torch', 5] < widths['torch', 0]


def test_node_is_exported():
    root = Node(None, 'a', 1.0)
    child = Node(None, 'b', 0.5, parent=root)
    assert child.cum_cost == 1.5 and child.length == 2
    assert child.to_sequence() == [root, child]
    assert root < child


def _run(ws_dir, model, package, device_decoding, out_grp='OCR-D-LM',
         **params):
    parameter = dict({'model_file': model, 'textequiv_level': 'glyph',
                      'device_decoding': device_decoding,
                      'beam_width': 4}, **params)
    ws = Workspace(ws_dir)
    if package == 'jax':
        proc = JKerasRate(workspace=ws, output_file_grp=out_grp,
                          parameter=parameter)
    else:
        proc = TKerasRate(workspace=ws, output_file_grp=out_grp,
                          parameter=parameter, device='cpu')
    proc.setup()
    proc.process_workspace(ws)


def _both(tmp_path, monkeypatch, pages, alts, model, device_decoding,
          **params):
    monkeypatch.setenv('KERASLM_NATIVE_PAGE', '0')
    out = {}
    for package in ('jax', 'torch'):
        d = str(tmp_path / package)
        build_workspace(d, pages, glyph_alternatives=alts)
        _run(d, model, package, device_decoding, **params)
        out[package] = _outputs(d)
    return out['jax'], out['torch']


@pytest.mark.parametrize('level', ['glyph', 'word'])
def test_processor_host_lane_matches_jax(tmp_path, monkeypatch, trained,
                                         level):
    """``device_decoding=false``: the three pages through the host
    engine, written one page behind, the last locked in at the end."""
    want, got = _both(tmp_path, monkeypatch, PAGES, ALTS, trained[0], False,
                      textequiv_level=level)
    if level == 'glyph':
        _assert_same(want, got, 1e-5)
        return
    assert got[0] == want[0] and len(got[0]) == 3
    assert got[2] == want[2]   # word, line and region texts
    words = [_word_confs(str(tmp_path / p)) for p in ('jax', 'torch')]
    assert words[1].keys() == words[0].keys() and words[0]
    for wid, (text, conf) in words[0].items():
        assert words[1][wid][0] == text
        assert abs(words[1][wid][1] - conf) <= 1e-5, wid


def _word_confs(directory):
    """{word id: (Unicode, conf)} of the one TextEquiv each word keeps."""
    from ocrd_keraslm_tpu.wrapper.page import parse_page
    out = {}
    ws = Workspace(directory)
    for f in ws.mets.find_files(fileGrp='OCR-D-LM'):
        pcgts = parse_page(os.path.join(directory, f.local_filename))
        for region in pcgts.get_Page().get_TextRegion():
            for line in region.get_TextLine():
                for word in line.get_Word():
                    (te,) = word.get_TextEquiv()
                    out[word.id] = (te.Unicode, te.conf)
    return out


def test_processor_host_lane_german_page(tmp_path, monkeypatch):
    """One page at full width (model_german.h5, W=128) through the host
    engine at the default beam of 10."""
    pages = {'phys_0001': [['Was', 'ist', 'Aufklärung'],
                           ['Sie', 'ist', 'der', 'Ausgang']]}
    alts = {(0, 2, 3): [('k', 0.9), ('l', 0.88)],
            (1, 3, 1): [('o', 0.9), ('u', 0.86), ('a', 0.85)]}
    want, got = _both(tmp_path, monkeypatch, pages, alts, GERMAN, False,
                      beam_width=10)
    _assert_same(want, got, 1e-5)


def test_cli_host_lane_runs_on_cpu(tmp_path, trained):
    """``-P device_decoding false`` reaches the processor through the
    CLI and writes every page."""
    build_workspace(str(tmp_path), PAGES, glyph_alternatives=ALTS)
    env = dict(os.environ, KERASLM_PLATFORM='cpu', KERASLM_NATIVE_PAGE='0')
    proc = subprocess.run(
        [sys.executable, '-m', 'ocrd_keraslm_torch.wrapper.cli',
         '-m', str(tmp_path / 'mets.xml'), '-I', 'OCR-D-OCR',
         '-O', 'OCR-D-LM', '-P', 'model_file', trained[0],
         '-P', 'device_decoding', 'false', '-P', 'beam_width', '4'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    files, glyphs, _ = _outputs(str(tmp_path))
    assert len(files) == len(PAGES)
    assert glyphs and all(len(tes) == 1 for tes in glyphs.values())


def _branching_builder(orig, te, branch_pages):
    """The chain builder, but for the given page ids a DiGraph with a
    diamond bypass (two routes between two chain nodes)."""
    def build(level, pcgts, logger=None):
        edges = orig(level, pcgts, logger=logger)
        if pcgts.get_pcGtsId() not in branch_pages:
            return edges
        g = nx.DiGraph()
        g.add_node(0)
        for i, e in enumerate(edges):
            g.add_edge(i, i + 1, **e)
        m = len(edges) // 2
        g.add_edge(m, 'bypass', element=None,
                   alternatives=[te(Unicode=' ', conf=0.4, index=0)])
        g.add_edge('bypass', m + 1, element=None,
                   alternatives=[te(Unicode=' ', conf=0.4, index=0)])
        return g
    return build


def _patch_builders(monkeypatch, branch_pages):
    monkeypatch.setenv('KERASLM_NATIVE_PAGE', '0')
    for mod, te in ((jrate, JTE), (trate, TTE)):
        monkeypatch.setattr(mod, 'page_get_linear_lattice_at',
                            _branching_builder(
                                mod.page_get_linear_lattice_at, te,
                                branch_pages))


def _read_outputs(ws_dir, grp='OCR-D-LM'):
    out = {}
    grp_dir = os.path.join(ws_dir, grp)
    for name in sorted(os.listdir(grp_dir)):
        with open(os.path.join(grp_dir, name), 'rb') as fh:
            out[name] = _VOLATILE.sub(b'', fh.read())
    return out


def test_single_branching_page_matches_pure_host(tmp_path, monkeypatch,
                                                 caplog, trained):
    """One branching page: the device-lane run bails into the host
    engine and writes what the pure host run writes, byte for byte;
    both equal JAX's device-lane run."""
    model = trained[0]
    pages = {'phys_0001': PAGES['phys_0001']}
    _patch_builders(monkeypatch, {'phys_0001'})
    dirs = {}
    for name in ('jax', 'torch'):
        dirs[name] = str(tmp_path / name)
        build_workspace(dirs[name], pages, glyph_alternatives=ALTS)
    with caplog.at_level(logging.INFO):
        _run(dirs['torch'], model, 'torch', True)
    assert any('host DAG engine' in rec.message for rec in caplog.records)
    _run(dirs['torch'], model, 'torch', False, out_grp='OCR-D-HOST')
    _run(dirs['jax'], model, 'jax', True)
    dev = _read_outputs(dirs['torch'], 'OCR-D-LM')
    host = _read_outputs(dirs['torch'], 'OCR-D-HOST')
    assert len(dev) == len(host) == 1
    for (_, a), (_, b) in zip(sorted(dev.items()), sorted(host.items())):
        assert a.replace(b'OCR-D-LM', b'OCR-D-HOST') == b
    _assert_same(_outputs(dirs['jax']), _outputs(dirs['torch']), 1e-5)


def test_mixed_document_branching_middle_page(tmp_path, monkeypatch,
                                              trained):
    """Three pages, the middle one branching: every page is written
    (the outer ones by the device engine), the middle one equals a
    pure-host run of that page alone (the carry reset makes it
    self-contained), and the whole document equals JAX's."""
    model = trained[0]
    _patch_builders(monkeypatch, {'phys_0002'})
    dirs = {}
    for name in ('jax', 'torch'):
        dirs[name] = str(tmp_path / name)
        build_workspace(dirs[name], PAGES, glyph_alternatives=ALTS)
        _run(dirs[name], model, name, True)
    outs = _read_outputs(dirs['torch'])
    assert len(outs) == 3
    files, glyphs, _ = _outputs(dirs['torch'])
    _assert_same(_outputs(dirs['jax']), (files, glyphs, _), 1e-5)
    solo = str(tmp_path / 'solo')
    build_workspace(solo, {'phys_0002': PAGES['phys_0002']},
                    glyph_alternatives=ALTS)
    _run(solo, model, 'torch', False)
    mixed_mid = [v for k, v in outs.items() if 'phys_0002' in k][0]
    assert mixed_mid == list(_read_outputs(solo).values())[0]


def test_device_engines_refuse_branching_graph(trained):
    """API level: the device engines refuse a diamond with the pointer
    to rate_best, as JAX's do; the host engine decodes it."""
    _, jr, tr = trained
    for r, te, err in ((jr, JTE, JNonLinear), (tr, TTE,
                                              NonLinearLatticeError)):
        g = nx.DiGraph()
        for i, ch in enumerate('abc'):
            g.add_edge(i, i + 1, element='e%d' % i,
                       alternatives=[te(Unicode=ch, conf=0.9, index=0)])
        g.add_edge(0, 'x', element=None,
                   alternatives=[te(Unicode=' ', conf=0.5, index=0)])
        g.add_edge('x', 1, element=None,
                   alternatives=[te(Unicode=' ', conf=0.5, index=0)])
        with pytest.raises(err, match='rate_best'):
            r.rate_best_device(g, 0, 3, beam_width=4)
        with pytest.raises(err, match='rate_best'):
            r.rate_best_batch([g], beam_width=4)
        _, _, tb = r.rate_best(g, 0, 3, beam_width=4)
        path, entropy, _ = r.next_path(tb[0], ([], tb[1]))
        assert path and np.isfinite(entropy)
