"""Parity of the port's ``Rater`` decode path with the JAX ``Rater``'s
fused path (Pallas kernel in interpret mode) on the lattices of
``test_decode_kernel.py`` and ``test_decode_exhaustive.py``: the host
prep arrays are bit-equal, paths and entropies agree (including the
beam carried across pages and a beam width that changes between
pages), and the brute-force golden holds for the port."""
import numpy as np
import pytest
import torch

from ocrd_keraslm_tpu.rater import Rater as JRater
from ocrd_keraslm_tpu.rater import _alt_steps as j_alt_steps
from ocrd_keraslm_torch.models.lstm_lm import params_from_numpy
from ocrd_keraslm_torch.rater import NonLinearLatticeError
from ocrd_keraslm_torch.rater import Rater as TRater
from ocrd_keraslm_torch.rater import _alt_steps as t_alt_steps

from test_decode_exhaustive import (brute_force, make_rater,
                                    random_lattice,
                                    random_multichar_lattice)
from test_decode_kernel import _toy_graph
from test_torch_parallel import one_rank_mesh

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)


def port_of(jr):
    """The port's Rater on the CPU holding ``jr``'s model."""
    tr = TRater(device='cpu')
    tr.width, tr.depth, tr.length = jr.width, jr.depth, jr.length
    tr.contexts, tr.stateful = jr.contexts, jr.stateful
    tr.vocab, tr.voc_size = jr.vocab, jr.voc_size
    tr.configure()
    tr.params = params_from_numpy(
        {'char_embedding': np.asarray(jr.params['char_embedding']),
         'context_embeddings': [np.asarray(e) for e in
                                jr.params['context_embeddings']],
         'lstm': [{k: np.asarray(v) for k, v in lp.items()}
                  for lp in jr.params['lstm']]}, 'cpu')
    tr.status = 2
    return tr


def _lattices():
    """(name, graph) of every lattice shape the two JAX test files
    decode."""
    out = [('toy_alts', _toy_graph(['abcd'], {
        (0, 2): [('x', 0.92), ('c', 0.90)],
        (1, 1): [('y', 0.92), ('b', 0.90)]})[0]),
        ('toy_two_words', _toy_graph(['abcd', 'abcd'], {
            (1, 1): [('y', 0.92), ('b', 0.90)]})[0]),
        ('toy_plain', _toy_graph(['ab'])[0])]
    for seed in (1, 2, 3):
        out.append(('exhaustive_%d' % seed, random_lattice(
            np.random.default_rng(seed), 5, 3)[0]))
    for seed in (21, 22):
        out.append(('multichar_%d' % seed, random_multichar_lattice(
            np.random.default_rng(seed), 5, 2)[0]))
    return out


def _edges(graph):
    return [d for _, _, d in sorted(graph.edges(data=True))]


@pytest.fixture(scope='module')
def raters():
    jr = make_rater(5)
    return jr, port_of(jr)


@pytest.mark.parametrize('merge', [True, False])
def test_prep_arrays_bit_equal(raters, merge):
    jr, tr = raters
    for name, graph in _lattices():
        edges = _edges(graph)
        jp = jr._prepare_decode_edges(edges, merge=merge)
        tp = tr._prepare_decode_edges(edges, merge=merge)
        assert len(jp) == len(tp), name
        for E, L in ((16, 4), (64, 8)):
            ja = JRater._fill_decode_arrays(jp, E, 4, L)
            ta = TRater._fill_decode_arrays(tp, E, 4, L)
            for a, b in zip(ja, ta):
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(j_alt_steps(ja[1]),
                                          t_alt_steps(ta[1]))


def _same_path(p_j, e_j, p_t, e_t, tol=1e-5):
    assert [te for _, te, _ in p_t] == [te for _, te, _ in p_j]
    assert [el for el, _, _ in p_t] == [el for el, _, _ in p_j]
    np.testing.assert_allclose([s for _, _, s in p_t],
                               [s for _, _, s in p_j], rtol=0, atol=tol)
    assert e_t == pytest.approx(e_j, abs=1e-4)


def test_paths_match_jax_fused(raters):
    jr, tr = raters
    jr.fused_decode = True
    try:
        for name, graph in _lattices():
            for beam in (4, 10):
                p_j, e_j, _ = jr.rate_best_device(graph, 0, 0,
                                                  lm_weight=0.7,
                                                  beam_width=beam)
                p_t, e_t, _ = tr.rate_best_device(graph, 0, 0,
                                                  lm_weight=0.7,
                                                  beam_width=beam)
                _same_path(p_j, e_j, p_t, e_t)
    finally:
        jr.fused_decode = False


def test_cross_page_carry_and_beam_change(raters):
    """Three pages with the beam carried across them (the
    ``test_pallas_decode_cross_page`` chain); the beam width widens
    (K 8 -> 32) and then narrows (K 32 -> 16) between pages."""
    jr, tr = raters
    pages = [_toy_graph(['abcd'], {(0, 2): [('x', 0.92), ('c', 0.90)]})[0],
             _toy_graph(['abcd', 'ab'])[0],
             _toy_graph(['dcba'], {(0, 0): [('d', 0.95), ('a', 0.94)]})[0]]
    jr.fused_decode = True
    try:
        tb_j = tb_t = None
        for graph, beam in zip(pages, (4, 20, 10)):
            p_j, e_j, tb_j = jr.rate_best_device(
                graph, 0, 0, device_traceback=tb_j, beam_width=beam)
            p_t, e_t, tb_t = tr.rate_best_device(
                graph, 0, 0, device_traceback=tb_t, beam_width=beam)
            _same_path(p_j, e_j, p_t, e_t)
            np.testing.assert_allclose(tb_t[0].numpy(),
                                       np.asarray(tb_j[0]), atol=1e-5)
            np.testing.assert_allclose(tb_t[1].numpy(),
                                       np.asarray(tb_j[1]), rtol=1e-5,
                                       atol=1e-4)
    finally:
        jr.fused_decode = False


def test_multi_block_page_matches_single_block(raters, monkeypatch):
    """A page longer than the largest edge block chains kernel launches
    (records walked on the host): with the blocks cut to 8 edges the
    result equals the single-block decode."""
    import ocrd_keraslm_torch.rater as trm
    _, tr = raters
    graph = _toy_graph(['abcd', 'abcd', 'abcd'], {
        (wi, ci): [('abcd'[(ci + 1) % 4], 0.85), ('abcd'[ci], 0.9)]
        for wi in range(3) for ci in range(4)})[0]
    p1, e1, _ = tr.rate_best_device(graph, 0, 0, beam_width=4)
    monkeypatch.setattr(trm, 'E_BUCKETS', (8,))
    p2, e2, _ = tr.rate_best_device(graph, 0, 0, beam_width=4)
    _same_path(p1, e1, p2, e2)


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_port_matches_exhaustive(seed):
    rng = np.random.default_rng(seed)
    jr = make_rater(seed)
    tr = port_of(jr)
    graph, alts = random_lattice(rng, 5, 3)
    want_choice, want_cost = brute_force(jr, alts, 0.7)
    path, entropy, _ = tr.rate_best_device(graph, 0, 5, lm_weight=0.7,
                                           beam_width=27)
    got = tuple(alts[e].index(te) for e, (_, te, _) in enumerate(path))
    assert got == want_choice
    assert abs(entropy - want_cost) < 1e-2, (entropy, want_cost)


@pytest.mark.parametrize('seed', [21, 22])
def test_port_matches_exhaustive_multichar(seed):
    rng = np.random.default_rng(seed)
    jr = make_rater(seed)
    tr = port_of(jr)
    graph, alts = random_multichar_lattice(rng, 5, 2)
    want_choice, want_cost = brute_force(jr, alts, 0.7)
    path, entropy, _ = tr.rate_best_device(graph, 0, 5, lm_weight=0.7,
                                           beam_width=27)
    got = tuple(alts[e].index(te) for e, (_, te, _) in enumerate(path))
    assert got == want_choice
    assert abs(entropy - want_cost) < 1e-2, (entropy, want_cost)


def test_unported_paths_raise(raters, monkeypatch):
    """A batch decode over a mesh of one rank takes the sharded path and
    returns the unsharded paths bit for bit (a beam wider than 32
    decodes through the unbounded engine: two chars, two path entries);
    a branching lattice raises the package's ``NonLinearLatticeError``
    (the processor bails into the host engine on it, as JAX's does)."""
    _, tr = raters
    graph = _toy_graph(['ab'])[0]
    path, entropy, tb = tr.rate_best_device(graph, 0, 0, beam_width=40)
    assert len(path) == 2 and entropy > 0 and len(tb) == 4
    branching = graph.copy()
    u = next(iter(branching.edges))[0]   # a node that has a successor
    branching.add_edge(u, 'detour', element=None, alternatives=[])
    with pytest.raises(NonLinearLatticeError, match='rate_best'):
        tr.rate_best_device(branching, 0, 0)
    want = tr.rate_best_batch([graph, graph])
    with one_rank_mesh() as mesh:
        monkeypatch.setattr(tr, 'mesh', mesh)
        got = tr.rate_best_batch([graph, graph])
    assert [(el, te, s) for p, _ in got for el, te, s in p] == \
        [(el, te, s) for p, _ in want for el, te, s in p]
    assert [e for _, e in got] == [e for _, e in want]
    assert torch.is_tensor(tr._decode_weights(None)['wcat'])
