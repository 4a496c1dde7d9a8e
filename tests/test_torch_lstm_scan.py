"""One LSTM layer's scan and the full-sequence forward of the port
against the JAX package on the CPU.

``lstm_scan_ref`` (the plain version of the CUDA kernel
``csrc/lstm_scan.cu``, which the wrapper ``lstm_scan`` runs for CPU
tensors) is held against the Pallas kernel ``_lstm_scan_pallas_raw`` in
interpret mode, with and without the ``c_all`` output, and the port's
``forward_seq`` against JAX ``forward_seq`` (layered scans, tied-softmax
logits, final carry).  Inputs and weights are made with numpy from a
seed and given to both.  Tolerance: atol 1e-5 on h/c and logits (f32
products summed in another order over 16 steps stay within a few ulps
of values of order 1)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ocrd_keraslm_tpu.models import lstm_lm as jlm
from ocrd_keraslm_tpu.ops.lstm_cell import _lstm_scan_pallas_raw
from ocrd_keraslm_torch.models import lstm_lm as tlm
from ocrd_keraslm_torch.ops import lstm_cell

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

ATOL = 1e-5


def _layer_inputs(seed, B=2, T=16, W=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, T, 4 * W)).astype(np.float32),
            rng.normal(0, 0.5, (B, W)).astype(np.float32),
            rng.normal(0, 0.5, (B, W)).astype(np.float32),
            rng.normal(0, 1 / np.sqrt(W), (W, 4 * W)).astype(np.float32))


@pytest.mark.parametrize('want_c_all', [False, True])
def test_lstm_scan_ref_matches_pallas(want_c_all):
    arrays = _layer_inputs(0)
    want = _lstm_scan_pallas_raw(*map(jnp.asarray, arrays),
                                 want_c_all=want_c_all)
    got = lstm_cell.lstm_scan_ref(*map(torch.from_numpy, arrays),
                                  want_c_all=want_c_all)
    assert (got[1] is None) == (want[1] is None) == (not want_c_all)
    for g, w in zip(got, want):
        if w is not None:
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize('want_c_all', [False, True])
def test_lstm_scan_ref_matches_pallas_at_width_512(want_c_all):
    """At W=512, the width the grid layout of ``csrc/lstm_scan.cu``
    takes on the card (16 blocks of 32 terms a gate column): the plain
    version against the Pallas kernel, B=2, T=3."""
    arrays = _layer_inputs(512, B=2, T=3, W=512)
    want = _lstm_scan_pallas_raw(*map(jnp.asarray, arrays),
                                 want_c_all=want_c_all)
    got = lstm_cell.lstm_scan_ref(*map(torch.from_numpy, arrays),
                                  want_c_all=want_c_all)
    for g, w in zip(got, want):
        if w is not None:
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_lstm_scan_on_cpu_runs_the_plain_version():
    """For CPU tensors the wrapper returns the plain version's values
    and launches nothing."""
    arrays = [torch.from_numpy(a) for a in _layer_inputs(1, B=3, T=5)]
    before = lstm_cell.lstm_scan.launches
    got = lstm_cell.lstm_scan(*arrays, want_c_all=True)
    want = lstm_cell.lstm_scan_ref(*arrays, want_c_all=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert lstm_cell.lstm_scan.launches == before
    h_all, c_all, hT, cT = lstm_cell.lstm_scan(*[a[:, :0] if a.dim() == 3
                                                 else a for a in arrays])
    assert h_all.shape == (0, 3, 32) and c_all is None
    torch.testing.assert_close(hT, arrays[1])


def _params(cfg, seed):
    """Seeded f32 numpy parameters in the shared tree layout."""
    rng = np.random.default_rng(seed)
    W = cfg.width

    def normal(scale, shape):
        return rng.normal(0, scale, shape).astype(np.float32)
    return {'char_embedding': normal(1, (cfg.voc_size, W)),
            'context_embeddings': [normal(1, (n, d))
                                   for n, d in cfg.contexts],
            'lstm': [{'kernel': normal(1 / np.sqrt(fan_in),
                                       (fan_in, 4 * W)),
                      'recurrent': normal(1 / np.sqrt(W), (W, 4 * W)),
                      'bias': normal(0.1, (4 * W,))}
                     for fan_in in [cfg.input_dim] + [W] * (cfg.depth - 1)]}


@pytest.mark.parametrize('depth, contexts', [(1, ()), (2, ((20, 4),)),
                                             (3, ((20, 4), (7, 3)))])
def test_forward_seq_matches_jax(depth, contexts):
    cfg = jlm.LMConfig(width=32, depth=depth, length=16, voc_size=13,
                       contexts=contexts)
    tcfg = tlm.LMConfig(**dataclasses.asdict(cfg))
    tree = _params(cfg, depth)
    rng = np.random.default_rng(depth)
    B, T = 2, 16
    x = rng.integers(0, cfg.voc_size, (B, T)).astype(np.int32)
    zs = [rng.integers(0, n, (B,)).astype(np.int32) for n, _ in contexts]
    h0 = rng.normal(0, 0.5, (depth, B, cfg.width)).astype(np.float32)
    c0 = rng.normal(0, 0.5, (depth, B, cfg.width)).astype(np.float32)
    jparams = {'char_embedding': jnp.asarray(tree['char_embedding']),
               'context_embeddings': [jnp.asarray(e) for e in
                                      tree['context_embeddings']],
               'lstm': [{k: jnp.asarray(v) for k, v in lp.items()}
                        for lp in tree['lstm']]}
    for use_pallas in (False, True):
        want, (wh, wc) = jlm.forward_seq(
            jparams, cfg, jnp.asarray(x), [jnp.asarray(z) for z in zs],
            (jnp.asarray(h0), jnp.asarray(c0)), use_pallas=use_pallas)
        got, (gh, gc) = tlm.forward_seq(
            tlm.params_from_numpy(tree, 'cpu'), tcfg,
            torch.from_numpy(x).long(),
            [torch.from_numpy(z).long() for z in zs],
            (torch.from_numpy(h0), torch.from_numpy(c0)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=ATOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=ATOL)
    # no carry: zeros, as in JAX
    want, _ = jlm.forward_seq(jparams, cfg, jnp.asarray(x),
                              [jnp.asarray(z) for z in zs], None)
    got, _ = tlm.forward_seq(tlm.params_from_numpy(tree, 'cpu'), tcfg,
                             torch.from_numpy(x).long(),
                             [torch.from_numpy(z).long() for z in zs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize('case, item', [
    ('train', 'Training'), ('bfloat16', 'h5 writing and the rest'),
    ('x_mask', 'h5 writing and the rest')])
def test_forward_seq_unported_modes_raise(case, item):
    """Training mode (dropout), the bfloat16 compute dtype and the
    masked scan raised ``NotImplementedError`` naming the ROADMAP.md
    item ``item`` until they were ported (the test keeps its name and
    ids from then); now none raises, and each gives the JAX package's
    result (``test_torch_model_core.py`` holds
    them in more shapes).  Tolerance: atol 1e-5 in f32, 2e-3 under
    bfloat16 (an activation may round to the neighbouring bf16 value)."""
    cfg = jlm.LMConfig(width=8, depth=2, voc_size=5, contexts=(),
                       dropout=0.5,
                       compute_dtype='bfloat16' if case == 'bfloat16'
                       else 'float32')
    tcfg = tlm.LMConfig(**dataclasses.asdict(cfg))
    tree = _params(cfg, 0)
    params = tlm.params_from_numpy(tree, 'cpu')
    jparams = {'char_embedding': jnp.asarray(tree['char_embedding']),
               'context_embeddings': [],
               'lstm': [{k: jnp.asarray(v) for k, v in lp.items()}
                        for lp in tree['lstm']]}
    x = np.array([[1, 4, 2], [3, 0, 2]], np.int32)
    mask = np.array([[0, 1, 1], [1, 1, 1]], np.float32)
    tx = torch.from_numpy(x).long()
    if case == 'train':
        # the dropout masks differ between the packages' generators:
        # hold the port's dropped logits against its own clean run
        got, (h, _) = tlm.forward_seq(
            params, tcfg, tx, [], train=True,
            rng=torch.Generator().manual_seed(1))
        clean, (hc, _) = tlm.forward_seq(params, tcfg, tx, [], train=True)
        want, _ = jlm.forward_seq(jparams, cfg, jnp.asarray(x), [],
                                  train=True, rng=None)
        np.testing.assert_allclose(clean.numpy(), np.asarray(want),
                                   atol=ATOL)
        assert not torch.equal(got, clean) and torch.equal(h, hc)
        return
    kw = {'x_mask': mask} if case == 'x_mask' else {}
    want, (wh, _) = jlm.forward_seq(
        jparams, cfg, jnp.asarray(x), [],
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got, (gh, _) = tlm.forward_seq(
        params, tcfg, tx, [],
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    atol = 2e-3 if case == 'bfloat16' else ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=atol)


# ---- the layout of the recurrence kernels (host arithmetic) ----

# cluster occupancy of an H100 for the chooser tests: how many clusters
# of each size the card holds at once
H100_FITS = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


@pytest.mark.parametrize('B, W, bf16, want', [
    # one group of 4 streams: one stream a cluster of 16 blocks, U's
    # weights in registers (8 units a block, a lane two gate columns of
    # one 32-term block)
    (4, 128, False, (1, 16, 1, True)),
    (4, 128, True, (1, 16, 1, True)),
    # the training shape: 64 two-block clusters of 2 streams fill 128
    # SMs in one wave, a thread's chain 2 streams long
    (128, 128, False, (2, 2, 2, True)),
    (128, 128, True, (2, 2, 2, True)),
    (33, 128, False, (1, 2, 1, True)),
    (4, 64, False, (1, 8, 1, True)),
    # more clusters than the card holds at once: they run in waves, 4
    # waves of 66 still faster than one wave of 64 one-block blocks...
    (512, 128, False, (2, 2, 2, True)),
    (128, 256, False, (2, 8, 2, True)),
    # ... 8 waves not: the one-block layout
    (1024, 128, False, (8, 1, 8, False)),
    (4096, 128, True, (8, 1, 8, False)),
    # twelve 32-term blocks a column: the one-block layout
    (4, 384, False, (4, 1, 4, False)),
    # sixteen (W=512): the grid layout, 4 groups of one stream on 32
    # blocks each
    (4, 512, True, (1, 32, 1, False)),
])
def test_scan_layout_chooser(B, W, bf16, want):
    from ocrd_keraslm_torch.ops import scan_layout as sl
    lay = sl.choose('lstm', B, W, 1, lambda lay: H100_FITS[lay.cl], 132,
                    bf16=bf16)
    assert (lay.rb, lay.cl, lay.rt, lay.reg) == want
    assert lay.grid == (W == 512)
    assert lay.smem == (
        sl.grid_plan_bytes('lstm', W, lay.rb, lay.rt) if lay.grid else
        sl.plan_bytes('lstm', W, 1, lay.rb, lay.reg, bf16=bf16))
    sl.check('lstm', B, W, 1, lay, bf16=bf16)


@pytest.mark.parametrize('B', [1, 3, 4, 9, 33, 128, 4096])
def test_scan_layout_without_clusters_is_the_one_block_layout(B):
    """A card (or a shape) where no cluster fits gets one
    block of rows_per_block(B) streams, each thread running whole
    columns: the first port's layout, its shared memory the rows h, c
    and z (and h rounded to bf16 under a bf16 U)."""
    from ocrd_keraslm_torch.ops import scan_layout as sl
    rb = sl.rows_per_block(B)
    for bf16 in (False, True):
        lay = sl.choose('lstm', B, 128, 1, lambda lay: 0, 132, bf16=bf16)
        assert lay == sl.one_block_layout('lstm', B, 128, 1, bf16)
        assert (lay.rb, lay.cl, lay.rt, lay.reg) == (rb, 1, rb, False)
        assert lay.smem == 4 * rb * 128 * (7 if bf16 else 6)


@pytest.mark.parametrize('W, reg', [
    (32, False), (36, True), (64, True), (68, False), (96, False),
    (100, True), (128, True), (160, False), (224, False), (228, True),
    (256, True), (288, False), (384, False), (1024, False)])
def test_scan_layout_holds_the_weights_in_registers_where_they_fit(W, reg):
    """The register layout takes a width whose columns have 2, 4 or 8
    blocks of 32 terms (W in (32, 64], (96, 128], (224, 256]); widths
    over 512 run the wide layout, every other width the one-block
    layout, its weights read from L2."""
    from ocrd_keraslm_torch.ops import scan_layout as sl
    lay = sl.choose('lstm', 4, W, 1, lambda lay: 1 << 20, 132)
    assert lay.reg == reg
    if reg:
        assert lay.smem == 2 * lay.rb * sl.padded_width(W) * 4 + 16
    elif W > 512:
        assert lay == sl.wide_layout_for('lstm', 4, W, 132)
    else:
        assert lay == sl.one_block_layout('lstm', 4, W, 1)


def test_scan_layout_plan_bytes():
    """The shared memory of each layout, array by array: the register
    layout's padded rows (2, rb, W + 4 a 32-term block) and two 8-byte
    mbarriers a layer group; the one-block layout's rows."""
    from ocrd_keraslm_torch.ops import scan_layout as sl
    assert sl.padded_width(128) == 144 and sl.padded_width(100) == 116
    assert sl.plan_bytes('lstm', 128, 1, 2, True) == 4 * 2 * 2 * 144 + 16
    assert sl.plan_bytes('score', 128, 3, 1, True) == \
        3 * (4 * 2 * 1 * 144 + 16)
    assert sl.plan_bytes('lstm', 128, 1, 8, False) == 4 * 8 * 6 * 128
    assert sl.plan_bytes('lstm', 128, 1, 8, False, bf16=True) == \
        4 * 8 * 7 * 128
    # score: the carry (2, D, rb, W) and z rows (rb, max(4W, Vp))
    assert sl.plan_bytes('score', 128, 2, 4, False, Vp=128) == \
        4 * (2 * 2 * 4 * 128 + 4 * 512)
    assert sl.plan_bytes('score', 32, 1, 2, False, Vp=256) == \
        4 * (2 * 1 * 2 * 32 + 2 * 256)
    # a W that 16 does not divide: 7 units a block, the last owns 2
    assert sl.units_per_block(100, 16) == 7
    assert sl.reg_layout_for('lstm', 100, 1, 4, 16) is None  # 15*7 > 100
    assert sl.reg_layout_for('lstm', 100, 1, 4, 8).cl == 8    # 7*13 < 100
    with pytest.raises(ValueError, match='kind is lstm or score'):
        sl.plan_bytes('decode', 128, 1, 1, True)


@pytest.mark.parametrize('B, W', [(1, 4), (3, 36), (9, 100), (33, 128),
                                  (200, 256), (5, 1024)])
def test_scan_layout_every_choice_is_valid(B, W):
    """Whatever the occupancy, the chosen layout passes the kernels'
    checks, and forced register layouts of every cluster size do too."""
    from ocrd_keraslm_torch.ops import scan_layout as sl
    for bf16 in (False, True):
        for fits in (lambda lay: 0, lambda lay: H100_FITS[lay.cl],
                     lambda lay: 1 << 20):
            sl.check('lstm', B, W, 1,
                     sl.choose('lstm', B, W, 1, fits, 132, bf16=bf16),
                     bf16=bf16)
        for cl in sl.CLUSTERS:
            lay = sl.reg_layout_for('lstm', W, 1, 1, cl)
            if lay is not None:
                sl.check('lstm', B, W, 1, lay, bf16=bf16)


@pytest.mark.parametrize('field, value, message', [
    ('rb', 3, 'a register layout that fits'),
    ('cl', 32, 'a register layout that fits'),
    ('rt', 4, 'a register layout that fits'),
    ('smem', 1024, 'smem equal'),
    ('reg', False, 'the one-block layout')])
def test_scan_layout_check_refuses(field, value, message):
    from ocrd_keraslm_torch.ops import scan_layout as sl
    lay = sl.reg_layout_for('lstm', 128, 1, 4, 4)
    lay = lay._replace(**{field: value})
    with pytest.raises(ValueError, match=message):
        sl.check('lstm', 4, 128, 1, lay)
    with pytest.raises(ValueError, match='multiple of 4'):
        sl.check('lstm', 4, 126, 1, sl.reg_layout_for('lstm', 128, 1, 4, 4))
    # at W=2048 the one-block layout takes 4 streams a block, whose rows
    # fit a block's shared memory (8 would not); at W=10240 not even one
    # stream's rows fit
    one = sl.one_block_layout('lstm', 8, 2048, 1)
    assert one.rb == 4
    sl.check('lstm', 8, 2048, 1, one)
    with pytest.raises(ValueError, match='the one-block layout'):
        sl.check('lstm', 8, 2048, 1, one._replace(
            rb=8, rt=8, smem=sl.plan_bytes('lstm', 2048, 1, 8, False)))
    with pytest.raises(ValueError, match='smem <= '):
        sl.check('lstm', 8, 10240, 1,
                 sl.one_block_layout('lstm', 8, 10240, 1))


@pytest.mark.parametrize('W, rb, cl, rt, threads, score_threads', [
    (128, 4, 16, 1, 256, 512), (128, 1, 16, 1, 64, 128),
    (128, 2, 2, 2, 512, 1024), (100, 4, 8, 1, 416, 832),
    (64, 2, 4, 1, 128, 256), (256, 1, 16, 1, 256, 512)])
def test_register_layout_threads(W, rb, cl, rt, threads, score_threads):
    """A layer group of ``lstm_scan``'s register layout takes 2 lanes
    (one a gate pair) per 32-term block for each unit and row group,
    ``score_scan``'s 4 (one a gate), rounded up to whole warps; the
    layout takes the fewest streams a chain whose groups fit a block's
    512 threads, and holds the rows (2, rb, W + 4 per 32-term block) and
    two mbarriers."""
    from ocrd_keraslm_torch.ops import scan_layout as sl
    assert sl.reg_group_threads('lstm', W, rb, cl, rt) == threads
    assert sl.reg_group_threads('score', W, rb, cl, rt) == score_threads
    lay = sl.reg_layout_for('lstm', W, 1, rb, cl)
    assert lay.reg and lay.rt == rt
    assert lay.smem == 2 * rb * sl.padded_width(W) * 4 + 16
    # one or more than eight 32-term blocks
    assert sl.reg_layout_for('lstm', 32, 1, 1, 2) is None
    assert sl.reg_layout_for('lstm', 384, 1, 1, 16) is None
    # at most 2 streams a chain: 8 streams of W=128 on 4 blocks do not fit
    assert sl.reg_layout_for('lstm', 128, 1, 8, 4) is None


def test_scan_layout_cost_model():
    """A step's cost: the register layout's by its chain and threads,
    the one-block layout's by one thread's FMAs a step (4 streams x 128
    terms at W=128: ~5 us, as the first port's kernel takes), each times
    the waves of clusters or blocks the card runs one after another."""
    from ocrd_keraslm_torch.ops import scan_layout as sl
    reg = sl.reg_layout_for('lstm', 128, 1, 2, 2)
    assert sl.step_cost('lstm', 128, 1, reg) == pytest.approx(
        sl.REG_STEP + 2 * sl.REG_PER_ROW + sl.REG_PER_BLOCK)
    one = sl.one_block_layout('lstm', 4, 128, 1)
    assert sl.step_cost('lstm', 128, 1, one) == pytest.approx(
        sl.ONE_PER_FMA * 4 * 128)
    # score: 2D-1 matrices of 4W columns and the logits, a thread's share
    one = sl.one_block_layout('score', 4, 384, 2, Vp=128)
    assert sl.step_cost('score', 384, 2, one, Vp=128) == pytest.approx(
        sl.ONE_PER_FMA * 4 * 384 * (3 * 3 + 1))
    assert sl.waves(128, reg, lambda lay: 66, 132) == 1
    assert sl.waves(512, reg, lambda lay: 66, 132) == 4
    assert sl.waves(512, reg, lambda lay: 0, 132) == 0
    assert sl.waves(2048, sl.one_block_layout('lstm', 2048, 128, 1),
                    lambda lay: 0, 132) == 2
