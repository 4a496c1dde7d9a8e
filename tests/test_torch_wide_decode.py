"""Parity of the port's unbounded decode engine on the CPU with the JAX
package's XLA engine on the same weights: ``decode_lattice_device``
itself (both packings, a leading document axis), and the ``Rater``
paths that reach it (``fused_decode`` off, beam widths above 32,
alternatives over 64 chars, the carry handed between the kernel and the
engine in both directions, blocks chained over 1024 edges, lookahead
records, the batch's ``'xlab'`` call and its per-document fallback, and
a width-512 model that no kernel layout takes).  The JAX side runs as
jitted XLA on the CPU (its default there), no Pallas but where a test
says so.

Tolerances: costs rtol 1e-5, states atol 1e-5, backpointers and
choices equal; paths equal element for element with per-char scores and
entropies within 1e-4."""
import string

import networkx as nx
import numpy as np
import pytest
import torch

import jax
from ocrd_keraslm_tpu.models.lstm_lm import init_params as j_init_params
from ocrd_keraslm_tpu.ops.beam_device import \
    decode_lattice_device as j_decode
from ocrd_keraslm_tpu.parallel.decode import make_batch_decode
from ocrd_keraslm_tpu.rater import Rater as JRater
from ocrd_keraslm_tpu.wrapper.page import TextEquivType
from ocrd_keraslm_torch import rater as trater_mod
from ocrd_keraslm_torch.ops import scan_layout as sl
from ocrd_keraslm_torch.ops.beam_device import \
    decode_lattice_device as t_decode

from test_decode_exhaustive import make_rater, random_lattice
from test_torch_rater import port_of

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(scope='module')
def raters():
    jr = make_rater(5)
    tr = port_of(jr)
    tr.fused_decode = False
    return jr, tr


def _engine_inputs(rng, N, E, K, L, D, W, v=12):
    """Seeded engine inputs: alternatives of 1..L chars (some edges'
    alternatives invalid), a carry with three live slots."""
    A = 4
    lead = (N,) if N else ()
    chars = rng.integers(1, v, lead + (E, A, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, lead + (E, A))
    mask = (np.arange(L) < lens[..., None]).astype(np.float32)
    chars *= mask.astype(np.int32)
    conf = (rng.uniform(0, 2, lead + (E, A, L)) * mask).astype(np.float32)
    valid = (rng.uniform(size=lead + (E, A)) < 0.8).astype(np.float32)
    valid[..., 0] = 1.0
    h0 = (0.1 * rng.normal(size=lead + (D, K, W))).astype(np.float32)
    c0 = (0.1 * rng.normal(size=lead + (D, K, W))).astype(np.float32)
    x0 = rng.integers(1, v, lead + (K,)).astype(np.int32)
    cost0 = np.full(lead + (K,), 3e38, np.float32)
    cost0[..., :3] = [0.0, 0.5, 0.5]
    return (chars, mask, conf, valid), (h0, c0, x0, cost0)


def _same_outputs(got, want, K, walk):
    """packed, h, c, x, cost of the two engines."""
    packed_w, packed_g = np.asarray(want[0]), got[0].numpy()
    assert packed_g.shape == packed_w.shape
    if walk:
        np.testing.assert_array_equal(packed_g[..., 1:, 0],
                                      packed_w[..., 1:, 0])
        np.testing.assert_allclose(packed_g[..., 1], packed_w[..., 1],
                                   rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(packed_g[..., 1:, :2 * K],
                                      packed_w[..., 1:, :2 * K])
        np.testing.assert_allclose(packed_g[..., 2 * K:],
                                   packed_w[..., 2 * K:], rtol=1e-5)
    np.testing.assert_allclose(packed_g[..., 0, 0], packed_w[..., 0, 0],
                               rtol=1e-5)
    for name, g, w in zip(('h', 'c'), got[1:3], want[1:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-5)


@pytest.mark.parametrize('K, L', [(8, 1), (8, 8), (8, 80), (64, 1),
                                  (64, 8), (64, 80)])
def test_decode_lattice_device_matches_jax(raters, K, L):
    """Both packings (the device walk and the records) at K in {8, 64}
    and L in {1, 8, 80}, from a carry with dead slots."""
    jr, tr = raters
    rng = np.random.default_rng(100 * K + L)
    E = 3
    arrays, carry = _engine_inputs(rng, 0, E, K, L, jr.depth, jr.width)
    zs = (np.array([3], np.int32),)
    for walk in (True, False):
        want = j_decode(jr.params, jr.cfg, *arrays, zs, *carry, 0.7, E, 4,
                        L, K, device_walk=walk)
        got = t_decode(tr.params, tr.cfg,
                       *(torch.from_numpy(a) for a in arrays), zs,
                       *(torch.from_numpy(a) for a in carry), 0.7,
                       device_walk=walk)
        _same_outputs(got, want, K, walk)


def test_decode_lattice_device_document_axis(raters):
    """A leading document axis: the JAX package's vmapped engine
    (``make_batch_decode``) on three documents."""
    jr, tr = raters
    rng = np.random.default_rng(7)
    N, E, K, L = 3, 4, 8, 2
    arrays, carry = _engine_inputs(rng, N, E, K, L, jr.depth, jr.width)
    zs = (np.array([3], np.int32),)
    fn = make_batch_decode(jr.cfg, E, 4, L, K, 0.6)
    want = fn(jr.params, *arrays, zs, *carry)
    got = t_decode(tr.params, tr.cfg, *(torch.from_numpy(a) for a in arrays),
                   zs, *(torch.from_numpy(a) for a in carry), 0.6,
                   device_walk=True)
    np.testing.assert_array_equal(got[0].numpy()[:, 1:, 0],
                                  np.asarray(want)[:, 1:, 0])
    np.testing.assert_allclose(got[0].numpy()[..., 1],
                               np.asarray(want)[..., 1], rtol=1e-5)
    for n in range(N):   # each document as it decodes alone
        one = t_decode(tr.params, tr.cfg,
                       *(torch.from_numpy(a[n]) for a in arrays), zs,
                       *(torch.from_numpy(a[n]) for a in carry), 0.6,
                       device_walk=True)
        np.testing.assert_array_equal(one[0].numpy(), got[0].numpy()[n])


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


def _one_edge_graph(alternatives):
    graph = nx.DiGraph()
    graph.add_edge(0, 1, element='e0', alternatives=[
        TextEquivType(Unicode=text, conf=conf, index=i)
        for i, (text, conf) in enumerate(alternatives)])
    return graph


def _decode_both(jr, tr, graphs, **kw):
    """Decode a document's pages in order with the carry, in both
    packages; returns ([(path, entropy)] JAX, port)."""
    out = []
    for r in (jr, tr):
        tb, res = None, []
        for g in graphs:
            path, ent, tb = r.rate_best_device(g, 0, 0,
                                               device_traceback=tb, **kw)
            res.append((path, ent))
        out.append(res)
    return out


@pytest.mark.parametrize('beam', [40, 4])
def test_wide_beam_and_engine_switch(raters, beam):
    """Beam 40 (K=64) takes the engine even with ``fused_decode`` on;
    beam 4 with it off; three pages with the carry."""
    jr, tr = raters
    rng = np.random.default_rng(beam)
    graphs = [random_lattice(rng, 6, 3)[0] for _ in range(3)]
    tr.fused_decode = beam > 32
    try:
        want, got = _decode_both(jr, tr, graphs, lm_weight=0.7,
                                 beam_width=beam)
    finally:
        tr.fused_decode = False
    _same(got, want)


def test_long_alternative(raters):
    """An 80-char alternative (the kernel takes 64) decodes in full
    through the engine, with ``fused_decode`` on."""
    jr, tr = raters
    good = 'abcdefghij' * 8
    bad = good[:65] + 'kkkkkkkkkkkkkkk'
    g = _one_edge_graph([(bad, 0.97), (good, 0.90)])
    tr.fused_decode = True
    try:
        want, got = _decode_both(jr, tr, [g, _one_edge_graph(
            [('abc', 0.9), ('abd', 0.8)])], lm_weight=0.9, beam_width=4)
    finally:
        tr.fused_decode = False
    _same(got, want)


def test_mixed_engine_carry_both_ways(raters):
    """JAX ``test_decode_limits.py::test_mixed_engine_traceback``: a
    kernel page, then a page with a 73-char alternative through the
    engine (kernel carry to engine), then a short page through the
    kernel again (engine carry to kernel); against the JAX package
    doing the same (its Pallas kernel in interpret mode) and the port's
    all-engine run."""
    jr, tr = raters

    def pages():
        return [_one_edge_graph([('abcd ab', 0.9), ('abce ab', 0.85)]),
                _one_edge_graph([('cd ' + 'abcd ' * 14, 0.9)]),
                _one_edge_graph([('cd a', 0.9), ('cd b', 0.88)])]
    all_engine = _decode_both(jr, tr, pages(), beam_width=4)[1]
    jr.fused_decode = tr.fused_decode = True
    try:
        want, got = _decode_both(jr, tr, pages(), beam_width=4)
    finally:
        jr.fused_decode = tr.fused_decode = False
    _same(got, want)
    for (p_g, e_g), (p_e, e_e) in zip(got, all_engine):
        assert [te.Unicode for _, te, _ in p_g] == \
            [te.Unicode for _, te, _ in p_e]
        assert e_g == pytest.approx(e_e, rel=1e-3)


def test_engine_carry_narrowed_to_the_kernel_lanes(raters):
    """A beam-300 engine page (K=512) hands its best 128 slots to a
    kernel page; the JAX package keeps the same slots."""
    jr, tr = raters
    rng = np.random.default_rng(3)
    graphs = [random_lattice(rng, 4, 4)[0], random_lattice(rng, 3, 3)[0]]
    out = []
    for r in (jr, tr):
        r.fused_decode = True
        try:
            _, _, tb = r.rate_best_device(graphs[0], 0, 0, beam_width=300)
            out.append(r.rate_best_device(graphs[1], 0, 0,
                                          device_traceback=tb,
                                          beam_width=8)[:2])
        finally:
            r.fused_decode = False
    _same([out[1]], [out[0]])


def test_blocks_chain_over_1024_edges(raters):
    """1100 edges: two engine blocks (1024 + 76) chained through the
    carry, walked on the host."""
    jr, tr = raters
    graph = random_lattice(np.random.default_rng(11), 1100, 2)[0]
    want, got = _decode_both(jr, tr, [graph], lm_weight=0.6, beam_width=6)
    _same(got, want)


def test_lookahead_records(raters):
    """``defer_walk`` records of two engine pages walked in reverse from
    chained entry slots, as lookahead write-back walks them."""
    jr, tr = raters
    rng = np.random.default_rng(12)
    graphs = [random_lattice(rng, 5, 3)[0] for _ in range(2)]
    res = []
    for r in (jr, tr):
        tb, pendings = None, []
        for g in graphs:
            p, tb = r.rate_best_device_begin(g, 0, 0, device_traceback=tb,
                                             beam_width=40, defer_walk=True)
            pendings.append(p)
        out, slot = [], 0
        for p in reversed(pendings):
            path_ent, slot = r.rate_best_device_finish(
                p, start_slot=slot, return_entry=True)
            out.append(path_ent)
        res.append((out, slot))
    _same(res[1][0], res[0][0])
    assert res[1][1] == res[0][1]


def test_batch_engine_call(raters, monkeypatch):
    """``rate_best_batch`` at beam 40: one engine call over every live
    document (pending ``'xlab'``), an empty document in between."""
    jr, tr = raters
    rng = np.random.default_rng(13)
    graphs = [random_lattice(rng, n, 3)[0] for n in (4, 7, 5)]
    graphs.insert(1, nx.DiGraph())
    calls = []
    launch = trater_mod.Rater._launch_engine
    monkeypatch.setattr(trater_mod.Rater, '_launch_engine',
                        lambda self, *a, **k: calls.append(a[0][0].shape)
                        or launch(self, *a, **k))
    pending = tr.rate_best_batch_begin(graphs, lm_weight=0.7,
                                       beam_width=40)
    assert pending[0] == 'xlab'
    got = tr.rate_best_batch_finish(pending)
    assert calls == [(3, 7, 4, 1)]
    _same(got, jr.rate_best_batch(graphs, lm_weight=0.7, beam_width=40))
    seq = [tr.rate_best_device(g, 0, 0, lm_weight=0.7, beam_width=40)[:2]
           for g in graphs]
    _same(got, seq)


def test_batch_long_document_decodes_alone(raters):
    """A document over 1024 prepared edges at beam 40: every document
    decodes through the single-document path, as in the JAX package."""
    jr, tr = raters
    rng = np.random.default_rng(14)
    graphs = [random_lattice(rng, 1030, 2)[0], random_lattice(rng, 5, 3)[0]]
    assert tr.rate_best_batch_begin(graphs, beam_width=40)[0] == 'done'
    _same(tr.rate_best_batch(graphs, beam_width=40),
          jr.rate_best_batch(graphs, beam_width=40))


def _wide_models():
    """The D=2, W=512, V=64 model of JAX's
    ``test_fused_wide_model_falls_back`` (seeded), in both packages."""
    jr = JRater()
    jr.width, jr.depth, jr.length = 512, 2, 32
    jr.stateful = False
    jr.incremental = True
    jr.voc_size = 64
    jr.vocab.assign(string.printable[:63])
    jr.configure()
    jr.params = j_init_params(jr.cfg, jax.random.PRNGKey(0))
    jr.status = 2
    return jr, port_of(jr)


def test_wide_model_takes_the_engine_by_the_gate(monkeypatch):
    """No layout of the decode kernels takes D=2, W=512 at beam 10
    (K=16; the one-block layout needs 312,304 bytes of a block's shared
    memory): with ``fused_decode`` on, the gate alone routes the single
    decode and the batch to the engine (neither kernel's wrapper is
    called)."""
    jr, tr = _wide_models()
    assert tr.fused_decode
    assert tr.fused_gate_arrays(5, 1, 10) is None

    def no_kernel(*a, **k):
        raise AssertionError('a decode kernel was called')
    monkeypatch.setattr(trater_mod, 'decode_lattice', no_kernel)
    monkeypatch.setattr(trater_mod, 'decode_lattice_batch', no_kernel)
    g = nx.DiGraph()
    g.add_node(0)
    for i, ch in enumerate('abcab'):
        g.add_edge(i, i + 1, element='c%d' % i,
                   alternatives=[TextEquivType(Unicode=ch, conf=0.9),
                                 TextEquivType(Unicode='x', conf=0.8)])
    path, ent, _ = tr.rate_best_device(g, 0, 5, beam_width=10)
    want = jr.rate_best_device(g, 0, 5, beam_width=10)
    _same([(path, ent)], [want[:2]])
    batch = tr.rate_best_batch([g, g], beam_width=10)
    _same(batch, jr.rate_best_batch([g, g], beam_width=10))


def test_backward_layout_at_width_512():
    """At W=512 the backward's chain takes the grid layout: 4 groups of
    32 streams on 32 blocks each, staged in chunks of 8 (179,216 bytes of
    shared memory a block).  The one-block layout shrinks its streams a
    block to fit: 4 there (4 x 15 x 512 floats = 122,880 bytes; 8 would
    need 245,760), and ``check`` accepts it; the forward kinds keep 8
    there and every kind fits at W=1024.  Up to W=256 nothing
    changes."""
    def fits(lay):
        return 8
    lay = sl.choose('bwd', 128, 512, 1, fits, 132)
    assert (lay.rb, lay.cl, lay.rt, lay.reg, lay.grid, lay.smem) == \
        (32, 32, 8, False, True, 179216)
    sl.check('bwd', 128, 512, 1, lay)
    lay = sl.one_block_layout('bwd', 128, 512, 1)
    assert (lay.rb, lay.cl, lay.rt, lay.reg, lay.smem) == \
        (4, 1, 4, False, 122880)
    sl.check('bwd', 128, 512, 1, lay)
    with pytest.raises(ValueError):
        sl.check('bwd', 128, 512, 1, lay._replace(
            rb=8, rt=8, smem=sl.plan_bytes('bwd', 512, 1, 8, False)))
    for kind, D in (('lstm', 1), ('score', 2), ('bwd', 1)):
        for W in (512, 1024):
            one = sl.one_block_layout(kind, 128, W, D, Vp=128)
            assert one.smem <= sl.SMEM_MAX
            sl.check(kind, 128, W, D, one, Vp=128)
        for W in (64, 128, 256):
            assert sl.one_block_layout(kind, 128, W, D, Vp=128).rb == 8
    assert sl.one_block_layout('lstm', 128, 512, 1).rb == 8
    assert sl.one_block_layout('bwd', 3, 512, 1).rb == 4
