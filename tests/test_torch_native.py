"""The port's native (C++) host lane against its Python lane and the JAX
package's native lane: the decode prep (``native.decode_scan``,
``decode_fill``, ``decode_emit``), the multi-block walk strides, the
training windows (``native.build_stream_batches``), the build (two
processes on a cold cache, a failed build), and the lanes' choice by
``KERASLM_NATIVE``.

Arrays are compared bit for bit (conf bits within rtol 1e-6 where the
two lanes take -log2 apart), paths element for element and TextEquiv
for TextEquiv, scores and entropies within 1e-5."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ocrd_keraslm_tpu import native as jnative
from ocrd_keraslm_tpu.data import _stream_windows_numpy as j_windows
from ocrd_keraslm_torch import native
from ocrd_keraslm_torch import rater as rater_mod
from ocrd_keraslm_torch.data import _stream_windows_numpy
from ocrd_keraslm_torch.rater import DECODE_MERGE_MAX, Rater as TRater
from ocrd_keraslm_torch.utils.buckets import bucket
from ocrd_keraslm_torch.wrapper.page import TextEquivType

from test_decode_exhaustive import make_rater
from test_torch_rater import port_of

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')


def te(u, conf):
    return TextEquivType(Unicode=u, conf=conf)


def _edges():
    """Runs that merge and overflow, unmapped chars, an empty and a
    long alternative, more than four alternatives, a missing conf."""
    return [
        {'element': 'e0', 'alternatives': [te('ab', 0.9)]},
        {'element': 'e1', 'alternatives': [te('cde', 0.5)]},
        {'element': 'e2', 'alternatives': [te('fgh', None)]},
        {'element': 'e3', 'alternatives': [te('a', 0.7)]},
        {'element': 'e4', 'alternatives': [
            te('ab', 0.8), te('xq', 0.3), te('', 0.2)]},
        {'element': 'e5', 'alternatives': [
            te('abcdefgh' * 3, 0.9), te('b', 0.6), te('c', 0.5),
            te('d', 0.4), te('e', 0.3)]},
        {'element': 'e6', 'alternatives': [te(' ', 1.0)]},
        {'element': 'e7', 'alternatives': [te('gh', 0.95)]},
        {'element': 'e8', 'alternatives': [te('', 0.0)]},
    ]


def _rater():
    r = TRater(device='cpu')
    r.vocab.grow(list('abcdefgh '))
    return r


def _python_lane(monkeypatch):
    monkeypatch.setenv('KERASLM_NATIVE', '0')


@pytest.mark.parametrize('merge', [True, False])
def test_decode_prep_equals_python_and_jax(merge, monkeypatch):
    """Scan and fill of the C++ lane equal the port's Python lane
    (``_decode_scan``, ``_prepare_decode_edges``,
    ``_fill_decode_arrays``) and the JAX package's native lane."""
    r = _rater()
    edges = _edges()
    n_prep, maxlen = native.decode_scan(edges, merge, DECODE_MERGE_MAX)
    assert (n_prep, maxlen) == rater_mod._decode_scan(
        edges, merge, DECODE_MERGE_MAX)
    assert (n_prep, maxlen) == tuple(jnative.decode_scan(
        edges, merge, DECODE_MERGE_MAX))
    prepared = r._prepare_decode_edges(edges, merge=merge)
    assert n_prep == len(prepared)
    A, L = 4, bucket(maxlen, rater_mod.L_BUCKETS)
    E = bucket(n_prep, rater_mod.E_BUCKETS)
    ref = r._fill_decode_arrays(prepared, E, A, L)
    meta, *got = native.decode_fill(edges, merge, DECODE_MERGE_MAX, E, A,
                                    L, r.vocab._table())
    jmeta, *jgot = jnative.decode_fill(edges, merge, DECODE_MERGE_MAX, E,
                                       A, L, r.vocab._table())
    for name, g, w, j in zip(('chars', 'mask', 'conf', 'valid'), got, ref,
                             jgot):
        if name == 'conf':
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, j, err_msg=name)
    assert len(meta) == len(prepared) == len(jmeta)
    for m, pe, jm in zip(meta, prepared, jmeta):
        assert m['alts'] is pe['alts'] is jm['alts']
        assert m['parts'] == jm['parts']
        if pe['parts'] is None:
            assert m['parts'] is None and m['element'] == pe['element']
        else:
            assert m['parts'] == pe['parts']
    _python_lane(monkeypatch)
    assert native.decode_scan(edges, merge, DECODE_MERGE_MAX) is None
    assert native.decode_fill(edges, merge, DECODE_MERGE_MAX, E, A, L,
                              r.vocab._table()) is None


def test_decode_emit_equals_python_and_jax(monkeypatch):
    """Path emission: merged runs expand with a uniform score, the
    chosen alternative scores by its length, an out-of-range choice
    takes the last alternative, scores clamp at 1."""
    a1, a2, a3 = te('ab', 0.9), te('cde', 0.5), te('x', 0.7)
    meta = [
        {'alts': [a1], 'element': None,
         'parts': [('e0', a1, 2), ('e1', te('q', 0.1), 1)]},
        {'alts': [a2, a3], 'parts': None, 'element': 'el2'},
        {'alts': [a3], 'parts': None, 'element': 'el3'},
        {'alts': [a1], 'parts': None, 'element': 'el4'},
    ]
    choices, costs = [0, 1, 5, 0], [3.0, 7.5, 9.0, 8.5]
    r = _rater()
    got = r._emit_path(meta, choices, costs, 1.0)
    jgot = jnative.decode_emit(meta, choices, costs, 1.0)
    _python_lane(monkeypatch)
    want = r._emit_path(meta, choices, costs, 1.0)
    for out in (got, jgot):
        assert out[1] == want[1]
        assert [(e, t) for e, t, _ in out[0]] == \
            [(e, t) for e, t, _ in want[0]]
        assert [s for _, _, s in out[0]] == [s for _, _, s in want[0]]
    assert got[0][-1][2] == 1.0


@pytest.fixture(scope='module')
def raters():
    jr = make_rater(5)
    return jr, port_of(jr)


def _chain(rng, n, chars='abcdefghijk', multi=3):
    """A linear lattice of ``n`` edges, every third a single
    alternative (runs merge), the others ``multi`` alternatives."""
    import networkx as nx
    g = nx.DiGraph()
    g.add_node(0)
    for e in range(n):
        k = 1 if e % 3 == 0 else multi
        tes = [te(chars[rng.integers(len(chars))],
                  float(rng.uniform(0.3, 1.0))) for _ in range(k)]
        g.add_edge(e, e + 1, element='g%d' % e, alternatives=tes)
    return g


def _same_path(a, b, tol=1e-5):
    (pa, ea), (pb, eb) = a, b
    assert [(e, t) for e, t, _ in pa] == [(e, t) for e, t, _ in pb]
    assert max(abs(x - y) for (_, _, x), (_, _, y) in zip(pa, pb)) <= tol
    assert abs(ea - eb) <= tol


@pytest.mark.parametrize('e_buckets', [None, (8, 16)])
def test_device_decode_lanes_equal(raters, monkeypatch, e_buckets):
    """``rate_best_device`` through the C++ prep equals the Python prep
    and the JAX package's fused path (native lane, Pallas kernel in
    interpret mode).  With blocks of 16 edges the 40-edge page chains
    three blocks: the C++ whole-document fill gives 16 rows a block, the
    Python fill 16, 16 and 8, and the walk takes each block's rows from
    the fetched records."""
    jr, tr = raters
    g = _chain(np.random.default_rng(11), 40)
    if e_buckets is not None:
        monkeypatch.setattr(rater_mod, 'E_BUCKETS', e_buckets)
        jr._E_BUCKETS = e_buckets
    try:
        pending, _ = tr.rate_best_device_begin(g, 0, 40, beam_width=8)
        assert pending[0] == ('blocks' if e_buckets else 'single')
        if e_buckets:
            assert [len(b.numpy()) for b in pending[2]] == [17, 17, 17]
        got = tr.rate_best_device_finish(pending)
        jr.fused_decode = True
        want = jr.rate_best_device(g, 0, 40, beam_width=8)[:2]
    finally:
        jr.fused_decode = False
        jr._E_BUCKETS = type(jr)._E_BUCKETS
    _python_lane(monkeypatch)
    pending, _ = tr.rate_best_device_begin(g, 0, 40, beam_width=8)
    if e_buckets:
        assert [len(b.numpy()) for b in pending[2]] == [17, 17, 9]
    python = tr.rate_best_device_finish(pending)
    assert len(got[0]) == 40
    _same_path(got, python)
    _same_path(got, want)


def test_batch_begin_takes_the_native_prep(raters, monkeypatch):
    """The serving batch preps with the C++ scan and fill; its results
    equal the Python lane's."""
    _, tr = raters
    rng = np.random.default_rng(3)
    graphs = [_chain(rng, n) for n in (7, 12, 9)]
    calls = []
    fill = native.decode_fill
    monkeypatch.setattr(native, 'decode_fill',
                        lambda *a, **k: calls.append(1) or fill(*a, **k))
    got = tr.rate_best_batch(graphs, beam_width=8)
    assert len(calls) == len(graphs)
    _python_lane(monkeypatch)
    want = tr.rate_best_batch(graphs, beam_width=8)
    for a, b in zip(got, want):
        _same_path(a, b)


@pytest.mark.parametrize('n, batch, length', [
    (5000, 8, 16), (1000, 32, 64), (97, 4, 16), (2, 8, 16)])
def test_stream_batches_equal_numpy(n, batch, length):
    """The C++ windows equal the port's numpy windows and the JAX
    package's C++ windows."""
    ids = np.random.default_rng(n).integers(1, 50, n).astype(np.int32)
    xs, ys, masks = native.build_stream_batches(ids, batch, length)
    ref = list(_stream_windows_numpy(ids, n, batch, length))
    assert len(xs) == len(ref) == len(list(j_windows(ids, n, batch,
                                                     length)))
    for w, (rx, ry, rm) in enumerate(ref):
        np.testing.assert_array_equal(xs[w], rx)
        np.testing.assert_array_equal(ys[w], ry)
        np.testing.assert_array_equal(masks[w], rm)
    jx, jy, jm = jnative.build_stream_batches(ids, batch, length)
    for a, b in ((xs, jx), (ys, jy), (masks, jm)):
        np.testing.assert_array_equal(a, b)


def test_stream_batches_short_text_and_python_lane(monkeypatch):
    assert native.build_stream_batches(np.array([1], np.int32), 8,
                                       16) is None
    _python_lane(monkeypatch)
    assert native.load_library() is None
    assert native.build_stream_batches(np.arange(100, dtype=np.int32), 8,
                                       16) is None


_CHILD = r'''
import sys
import numpy as np
sys.path.insert(0, %r)
from ocrd_keraslm_torch import native
x, y, m = native.build_stream_batches(np.arange(1, 400, dtype=np.int32),
                                      4, 16)
assert native.load_decode_prep().decode_scan is not None
print(len(x), int(x.sum()))
'''


def test_cold_cache_build_from_two_processes(tmp_path):
    """Two processes that build at once into an empty directory each
    load a whole library: each writes its own temporary file and moves
    it into place."""
    env = dict(os.environ, KERASLM_NATIVE_DIR=str(tmp_path / 'build'))
    env.pop('KERASLM_NATIVE', None)
    procs = [subprocess.Popen([sys.executable, '-c', _CHILD % REPO],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert outs[0][0] == outs[1][0] and outs[0][0].strip()
    built = sorted(os.listdir(tmp_path / 'build'))
    assert len(built) == 2 and all(b.endswith('.so') for b in built), built


def test_failed_build_raises(tmp_path, monkeypatch):
    """With the native lane asked for, a build that fails raises with
    the compiler's output; nothing falls back to the Python lane."""
    monkeypatch.setenv('KERASLM_NATIVE_DIR', str(tmp_path))
    monkeypatch.setattr(native, 'CXX_FLAGS',
                        native.CXX_FLAGS + ['-fno-such-flag'])
    monkeypatch.setattr(native, '_LIBS', {})
    with pytest.raises(RuntimeError, match='(?s)g\\+\\+ failed.*no-such-flag'):
        native.load_decode_prep()
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.decode_scan(_edges(), True, DECODE_MERGE_MAX)
    assert not [f for f in os.listdir(tmp_path) if f.endswith('.so')]


def test_failed_build_raises_from_the_processor(tmp_path, monkeypatch):
    """The processor asks for the native lane by default: a build that
    fails raises out of the run before its page loop, and is not taken
    for a failure of each page under the page policy."""
    from helpers import build_workspace
    from ocrd_keraslm_torch.wrapper import KerasRate
    german = os.path.join(REPO, 'pretrained', 'model_german.h5')
    ws = build_workspace(str(tmp_path / 'ws'), {'p1': [['Das', 'ist']]})
    proc = KerasRate(workspace=ws, parameter={'model_file': german},
                     device='cpu')
    proc.setup()
    monkeypatch.setenv('OCRD_MISSING_OUTPUT', 'SKIP')
    monkeypatch.setenv('KERASLM_NATIVE_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(native, 'CXX_FLAGS',
                        native.CXX_FLAGS + ['-fno-such-flag'])
    monkeypatch.setattr(native, '_LIBS', {})
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        proc.process_workspace(ws)
    assert not os.path.exists(str(tmp_path / 'ws' / 'OCR-D-LM'))
