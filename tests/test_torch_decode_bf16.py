"""The bf16 decode mode (``Rater.decode_bf16 = True``: emb, embT and
wcat in bf16, the carried state and every cost in f32) against the JAX
package's, on the CPU.

The plain versions (``decode_lattice_ref``, ``decode_lattice_batch_ref``:
what the wrappers run for CPU tensors under bf16 weights) round every
matmul operand to bf16 and sum the exact products in f32; JAX's Pallas
kernels in interpret mode take the same bf16 weights
(``preferred_element_type=float32``).  Tolerances
(``chip_smoke.BF16_DECODE_TOL``): stateF within atol 4e-3, costs within
rtol 1e-5 / atol 4e-3, backpointers and alternatives equal on every edge
(ranks whose costs lie within 4e-3 of each other may swap; see
``chip_smoke.compare_decode``): where the two packages' f32 h differ in
the last bit, some h round to neighbouring bf16 values (a step of 2^-8
relative), which moves a cost by up to ~1e-3 bits (the f32 parity
tests' 1e-5 and 1e-4 hold where no h flips).  Through the ``Rater``
paths are identical and per-char scores and entropies within 4e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (BF16_DECODE_TOL, batch_doc, batch_lattice,
                        compare_decode, random_lattice)
from ocrd_keraslm_tpu.ops.decode_kernel import (decode_lattice_pallas,
                                                decode_lattice_pallas_batch)
from ocrd_keraslm_torch.ops import decode_kernel as dk

from test_decode_exhaustive import make_rater
from test_decode_kernel import _toy_graph
from test_torch_rater import port_of

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

D, W, VP, V_REAL, A, E = 2, 16, 128, 30, 4, 16
S = (2 * D + 1) * W
TOL = BF16_DECODE_TOL['cost_atol']


def _weights(rng):
    """(emb, embT, wcat, bias) as float32 numpy arrays; emb, embT and
    wcat are rounded to bf16 values by each side's own cast."""
    emb = np.zeros((VP, W), np.float32)
    emb[:V_REAL] = rng.normal(0, 1, (V_REAL, W))
    wcat = rng.normal(0, 0.3, (D, 2 * W, 4 * W)).astype(np.float32)
    bias = rng.normal(0, 0.1, (D, 1, 4 * W)).astype(np.float32)
    return emb, emb.T.copy(), wcat, bias


def _jax_bf16(weights):
    emb, embT, wcat, bias = weights
    return (jnp.asarray(emb, jnp.bfloat16), jnp.asarray(embT, jnp.bfloat16),
            jnp.asarray(wcat, jnp.bfloat16), bias)


def _torch_bf16(weights):
    emb, embT, wcat, bias = (torch.from_numpy(w) for w in weights)
    return (emb.bfloat16(), embT.bfloat16(), wcat.bfloat16(), bias)


@pytest.mark.parametrize('walk', [True, False])
@pytest.mark.parametrize('L', [1, 4])
@pytest.mark.parametrize('K', [8, 16])
def test_ref_matches_pallas_bf16(K, L, walk):
    """Two chained blocks (the second with pad edges), each side its own
    carry, from a fresh beam whose xemb rows are bf16 embedding
    values."""
    rng = np.random.default_rng(7000 + 100 * K + 10 * L + walk)
    weights = _weights(rng)
    j_w, t_w = _jax_bf16(weights), _torch_bf16(weights)
    lw = 0.7
    state0 = np.zeros((K, S), np.float32)
    state0[:, :W] = t_w[0][3].float().numpy()
    cost0 = np.full((1, 128), dk.BIG, np.float32)
    cost0[0, 0] = 0.0
    j_state, j_cost = state0, cost0
    t_state, t_cost = torch.from_numpy(state0), torch.from_numpy(cost0)
    T = torch.from_numpy
    for n_real in (E, 11):
        chars, mask, conf, valid, steps = random_lattice(rng, E, n_real, A,
                                                         L, V_REAL)
        want = decode_lattice_pallas(
            *j_w, chars, mask, conf, valid[:, :, None], j_state, j_cost,
            n_edges=E, n_alts=A, alt_len=L, beam=K, depth=D, width=W,
            v_pad=VP, v_real=V_REAL, lm_weight=lw, device_walk=walk,
            alt_steps=steps[:, None], n_real=np.int32(n_real))
        want = [np.asarray(x) for x in want]
        got = dk.decode_lattice(
            *t_w, T(chars), T(mask), T(conf), T(valid), t_state, t_cost,
            lm_weight=lw, v_real=V_REAL, device_walk=walk,
            alt_steps=T(steps), n_real=n_real)
        assert all(x.dtype == torch.float32 for x in got)
        err, n_cmp, diverged = compare_decode(
            [x.numpy() for x in got], want, K, W, c_rtol=0.0,
            **BF16_DECODE_TOL)
        assert diverged is None and n_cmp == E
        j_state, j_cost = want[1], want[2]
        t_state, t_cost = got[1], got[2]


@pytest.mark.parametrize('L', [1, 4])
@pytest.mark.parametrize('N', [2, 3])
def test_batch_ref_matches_pallas_bf16(N, L):
    """Documents of different lengths in one batch, two chained
    blocks, at K=8."""
    K = 8
    rng = np.random.default_rng(7100 + 10 * N + L)
    weights = _weights(rng)
    j_w, t_w = _jax_bf16(weights), _torch_bf16(weights)
    lw = 0.7
    state0 = np.zeros((N * K, S), np.float32)
    state0[:, :W] = t_w[0][3].float().numpy()
    cost0 = np.full((N * K, 1), dk.BIG, np.float32)
    cost0[::K] = 0.0
    j_carry = (state0, cost0)
    t_carry = (torch.from_numpy(state0), torch.from_numpy(cost0))
    T = torch.from_numpy
    for n_real in (E, 11):
        n_reals = [n_real] + [int(rng.integers(3, n_real + 1))
                              for _ in range(N - 1)]
        chars, mask, conf, valid, steps = batch_lattice(
            rng, N, n_reals, E, A, L, V_REAL)
        want = decode_lattice_pallas_batch(
            *j_w, chars, mask, conf, valid, *j_carry, n_docs=N, n_edges=E,
            n_alts=A, alt_len=L, beam=K, depth=D, width=W, v_pad=VP,
            v_real=V_REAL, lm_weight=lw, alt_steps=steps,
            n_real=np.int32(n_real))
        want = [np.asarray(x) for x in want]
        want[0] = want[0][:, 0:3, :N * K]
        got = dk.decode_lattice_batch(
            *t_w, T(chars), T(mask), T(conf), T(valid), *t_carry, n_docs=N,
            lm_weight=lw, v_real=V_REAL, alt_steps=T(steps), n_real=n_real)
        got = [x.numpy() for x in got]
        for n in range(N):
            _, n_cmp, diverged = compare_decode(
                batch_doc(*got, n, K), batch_doc(*want, n, K), K, W,
                c_rtol=0.0, **BF16_DECODE_TOL)
            assert diverged is None and n_cmp == E, n
        j_carry = (want[1], want[2])
        t_carry = (torch.from_numpy(got[1]), torch.from_numpy(got[2]))


def test_weights_must_share_one_dtype():
    """f32 and bf16 weights do not mix; bf16 weights give f32 outputs
    that differ from the f32 weights' (the mode changes results off the
    TPU)."""
    rng = np.random.default_rng(7200)
    weights = _weights(rng)
    t32 = [torch.from_numpy(w) for w in weights]
    t16 = list(_torch_bf16(weights))
    arrays = [torch.from_numpy(a) for a in random_lattice(rng, 6, 6, A, 2,
                                                          V_REAL)]
    state0 = torch.zeros((8, S))
    state0[:, :W] = t16[0][3].float()
    cost0 = torch.full((1, 128), dk.BIG)
    cost0[0, 0] = 0.0
    kw = dict(lm_weight=0.5, v_real=V_REAL, alt_steps=arrays[4])
    out16 = dk.decode_lattice(*t16, *arrays[:4], state0, cost0, **kw)
    out32 = dk.decode_lattice(*t32, *arrays[:4], state0, cost0, **kw)
    assert not torch.equal(out16[1], out32[1])
    for mixed in ([t16[0], t32[1], t16[2], t32[3]],
                  [t32[0], t32[1], t16[2], t32[3]]):
        with pytest.raises(ValueError, match='all be float32 or all '
                                             'bfloat16'):
            dk.decode_lattice(*mixed, *arrays[:4], state0, cost0, **kw)


@pytest.fixture(scope='module')
def raters():
    """A JAX and a port Rater on the same random model, both with the
    bf16 decode mode on (JAX: its Pallas kernels in interpret mode)."""
    jr = make_rater(5)
    jr.fused_decode = True
    jr.decode_bf16 = True
    tr = port_of(jr)
    tr.decode_bf16 = True
    return jr, tr


def _same_path(p_g, e_g, p_w, e_w, tol=TOL):
    assert [(el, te.Unicode) for el, te, _ in p_g] == \
        [(el, te.Unicode) for el, te, _ in p_w]
    np.testing.assert_allclose([s for _, _, s in p_g],
                               [s for _, _, s in p_w], rtol=0, atol=tol)
    assert abs(e_g - e_w) <= tol, (e_g, e_w)


TOY = [(['abcd'], {(0, 2): [('x', 0.92), ('c', 0.90)],
                   (1, 1): [('y', 0.92), ('b', 0.90)]}),
       (['abcd', 'abcd'], {(1, 1): [('y', 0.92), ('b', 0.90)]}),
       (['ab', 'cab', 'dad'], {(0, 1): [('b', 0.6), ('h', 0.55)],
                               (2, 0): [('d', 0.8), ('e', 0.7),
                                        ('f', 0.65)]})]


@pytest.mark.parametrize('case', range(len(TOY)))
def test_rate_best_device_matches_jax_bf16(raters, case):
    """A page through ``rate_best_device`` (merged runs: L > 1) with the
    beam carried into a second page, in both packages' bf16 mode."""
    jr, tr = raters
    words, alts = TOY[case]
    graph = _toy_graph(words, alts)[0]
    j_tb = t_tb = None
    for page in range(2):
        jp, je, j_tb = jr.rate_best_device(graph, 0, 0, beam_width=4,
                                           device_traceback=j_tb)
        tp, te, t_tb = tr.rate_best_device(graph, 0, 0, beam_width=4,
                                           device_traceback=t_tb)
        _same_path(tp, te, jp, je)
    assert tr._decode_weights(None, bf16=True) in \
        tr._decode_cache.values()


def test_kernel_engine_kernel_carry_bf16(raters):
    """A bf16 kernel page, then a page at beam 40 (the unbounded engine,
    f32 in both packages: the carry converts, x recovered against the
    bf16-rounded table), then a kernel page again: JAX's paths."""
    jr, tr = raters
    graph = _toy_graph(*TOY[2])[0]
    j_tb = t_tb = None
    for beam in (4, 40, 4):
        jp, je, j_tb = jr.rate_best_device(graph, 0, 0, beam_width=beam,
                                           device_traceback=j_tb)
        tp, te, t_tb = tr.rate_best_device(graph, 0, 0, beam_width=beam,
                                           device_traceback=t_tb)
        _same_path(tp, te, jp, je)
        assert len(t_tb) == (4 if beam > 32 else 2)


def test_engine_recovers_x_from_a_bf16_carry(raters):
    """Every xemb row of a bf16 kernel carry is a bf16 embedding row:
    ``_engine_traceback`` finds its char exactly (distance 0), where the
    f32 table would leave a rounding distance."""
    _, tr = raters
    graph = _toy_graph(*TOY[1])[0]
    _, _, tb = tr.rate_best_device(graph, 0, 0, beam_width=4)
    state = tb[0]
    x = tr._engine_traceback(tb, state.shape[0])[2].long()
    emb16 = tr.params['char_embedding'].bfloat16().float()
    assert torch.equal(emb16[x], state[:, :tr.width])
    emb32 = tr.params['char_embedding']
    assert not torch.equal(emb32[x], state[:, :tr.width])


def test_batch_matches_jax_bf16(raters):
    """``rate_best_batch`` of three documents (the batched kernel's
    plain version in bf16) against JAX's fused batch path in bf16."""
    jr, tr = raters
    graphs = [_toy_graph(words, alts)[0] for words, alts in TOY]
    want = jr.rate_best_batch(graphs, beam_width=4)
    got = tr.rate_best_batch(graphs, beam_width=4)
    for (p_g, e_g), (p_w, e_w) in zip(got, want):
        _same_path(p_g, e_g, p_w, e_w)


def test_decode_weights_by_dtype(raters):
    """``_decode_weights(ctx, bf16)``: emb, embT and wcat in bf16 (the
    f32 set's values rounded), bias in f32, one cache entry per (context,
    dtype); the flag's default None is off, as off the TPU in JAX."""
    _, tr = raters
    w16 = tr._decode_weights(None, bf16=True)
    w32 = tr._decode_weights(None)
    for name in ('emb', 'embT', 'wcat'):
        assert w16[name].dtype == torch.bfloat16
        assert w32[name].dtype == torch.float32
        assert torch.equal(w16[name], w32[name].bfloat16())
    assert w16['bias'].dtype == torch.float32
    assert torch.equal(w16['bias'], w32['bias'])
    assert tr._decode_weights(None, bf16=True) is w16
    assert tr._decode_weights(None, bf16=False) is w32
    ctx = tuple(tr.underspecify_contexts())
    assert tr._decode_cache[(ctx, True)] is w16
    assert tr._decode_cache[(ctx, False)] is w32
    fresh = port_of(make_rater(5))
    assert fresh.decode_bf16 is None and fresh._decode_bf16() is False


def test_generation_ignores_the_flag(raters):
    """Generation runs on f32 weights whatever ``decode_bf16`` says."""
    _, tr = raters
    tr.decode_bf16 = False
    try:
        want = tr.generate('ab', 12, variants=2)
    finally:
        tr.decode_bf16 = True
    assert tr.generate('ab', 12, variants=2) == want
