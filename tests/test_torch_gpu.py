"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: without a CUDA device every test here skips.  On the
card (no JAX there, so without the repository's conftest)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu.py

Decode tolerances are those of ``chip_smoke.compare_decode``: costs
rtol 1e-5 / atol 1e-4, stateF atol 1e-5 (cell states also rtol 2e-5),
backpointers and alternatives equal up to the order of ranks whose
costs lie within 1e-3; where a near-tie at the K-th rank sends the two
f32 runs down different hypotheses, ``chip_smoke.parity_block``
resumes both from the kernel's state after that edge.  Scoring and
LSTM-scan tolerances are those of ``chip_smoke.compare_score`` and
``compare_lstm``: probs and h atol 1e-5, cell states c atol 1e-5 plus
rtol ``chip_smoke.C_RTOL`` (|c| reaches ~3.6e3 over a 4096-step chunk),
NLL sums rtol 1e-5; ratings through the ``Rater`` (float16 probs) atol
1e-3.  The LSTM backward is held as ``chip_smoke.compare_bwd`` holds it
(dx_proj, dh0, dc0 atol 1e-5 + rtol 1e-4; dU 5e-6 of its max: other
summation orders over T*B terms); the forward under a bf16 U to
``chip_smoke.BF16_FWD_ATOL`` (an h may round to the neighbouring bf16
value); gradients of ``forward_seq`` card against CPU rtol 1e-3 / atol
1e-5 of each tensor's max.  Generation records are held as
``chip_smoke.compare_gen`` holds them (chars and backpointers equal,
live costs rtol 1e-5; at a near-tie of the K-th candidate
``chip_smoke.gen_parity`` resumes both runs from the kernel's fringe);
strings are compared exactly, card against CPU and batch against single
calls.  The batched decode kernel is held against its plain version per
document as ``chip_smoke.parity_batch`` holds it (the decode tolerances
above), against single-document launches bit for bit, and its walk
exactly; batched paths equal single-document and CPU paths, scores and
entropies within 1e-4 (card against CPU also two ulps of the document's
f32 cumulative cost, ``chip_smoke.same_results``).  The batched final
states are held within ``chip_smoke.BATCH_STATE_ATOL`` (two f32
versions, each up to ~1e-5 from the exact state).  Under bf16 decode
weights two runs part from the first h that rounds to the other bf16
value and drift apart, so the decode kernels are held to their plain
versions edge by edge from the kernel's beam
(``chip_smoke.parity_stepwise``, ``chip_smoke.BF16_EDGE_TOL``), and the
chained one-edge launches to the block launch bit for bit."""
import contextlib
import os

import numpy as np
import pytest
import torch

from chip_smoke import (BF16_FWD_ATOL, MODEL, batch_lattice, build_workspace,
                        compare_bwd, compare_lstm, compare_score, gen_parity,
                        german_rater, lstm_bwd_args, lstm_train_inputs,
                        parity_batch, parity_block, random_lattice,
                        same_results, score_inputs, workspace_graphs)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _random_weights(rng, D, W, v_real, Vp=128):
    emb = np.zeros((Vp, W), np.float32)
    emb[:v_real] = rng.normal(0, 1, (v_real, W))
    wcat = rng.normal(0, 0.3, (D, 2 * W, 4 * W)).astype(np.float32)
    bias = rng.normal(0, 0.1, (D, 1, 4 * W)).astype(np.float32)
    return [torch.from_numpy(a) for a in (emb, emb.T.copy(), wcat, bias)]


def _german(device):
    from ocrd_keraslm_torch.rater import Rater
    rater = Rater(device=device)
    rater.load_config(MODEL)
    rater.configure()
    rater.load_weights(MODEL)
    w = rater._decode_weights(None)
    return [w['emb'], w['embT'], w['wcat'], w['bias']], w['v_real']


def _runner(weights, v_real, device):
    def run(fn, arrays, n_real, state, cost, walk):
        chars, mask, conf, valid, steps = (torch.from_numpy(a).to(device)
                                           for a in arrays)
        out = fn(*weights, chars, mask, conf, valid, state, cost,
                 lm_weight=0.5, v_real=v_real, device_walk=walk,
                 alt_steps=steps, n_real=n_real)
        torch.cuda.synchronize()
        return out
    return run


@pytest.mark.parametrize('K', [8, 16, 32])
@pytest.mark.parametrize('L', [1, 8])
@pytest.mark.parametrize('model', ['german', 'd1w16', 'd3w32'])
def test_kernel_matches_plain(cuda, model, L, K):
    """Two chained blocks (a full one and one with pad edges), every
    edge held against the plain version by ``chip_smoke.parity_block``;
    the kernel's in-kernel walk equals the host walk of its records."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng(
        [('german', 'd1w16', 'd3w32').index(model), L, K])
    if model == 'german':
        weights, v_real = _german(cuda)
    else:
        D, W = (1, 16) if model == 'd1w16' else (3, 32)
        v_real = 40
        weights = [t.to(cuda) for t in _random_weights(rng, D, W, v_real)]
    D, W = weights[2].shape[0], weights[0].shape[1]
    run = _runner(weights, v_real, cuda)
    state = torch.zeros((K, (2 * D + 1) * W), device=cuda)
    state[:, :W] = weights[0][1]
    cost = torch.full((1, 128), 1e30, device=cuda)
    cost[0, 0] = 0.0
    for E, n_real in ((256, 256), (64, 41)):
        arrays = random_lattice(rng, E, n_real, 4, L, v_real)
        before = dk.decode_lattice.launches
        _, ties, state, cost = parity_block(
            run, dk.decode_lattice, dk.decode_lattice_ref, arrays, n_real,
            state, cost, K, W)
        assert dk.decode_lattice.launches >= before + 2 + len(ties)


def test_kernel_matches_plain_long_alternatives(cuda):
    """Alternatives of up to 64 chars (line level) at K=32: in the
    one-block layout the 32-row chunk no longer fits in shared memory and
    the launcher takes 16-row chunks; the wrapper takes the cluster layout
    in its sharded plan (16 blocks).  Both against the plain version."""
    from chip_smoke import decode_cluster
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    K, L = 32, 64
    rng = np.random.default_rng([K, L])
    weights, v_real = _german(cuda)
    D, W = weights[2].shape[0], weights[0].shape[1]
    lib = dk._library()
    assert lib.decode_lattice_smem_bytes(4, L, K, D, W, 128, v_real, 1, 0) \
        < lib.decode_lattice_smem_bytes(4, 8, K, D, W, 128, v_real, 1, 0)
    assert dk.cluster_blocks(cuda, False, 1, K, 4, L, D, W, 128,
                             v_real) == 16
    assert dk.cluster_shard(K, 4, L, D, W, 128, v_real, 16)
    assert lib.decode_lattice_smem_bytes(4, L, K, D, W, 128, v_real, 16, 1) \
        == dk.cluster_smem_bytes(4, L, K, D, W, 128, v_real, 16)
    run = _runner(weights, v_real, cuda)
    for cl in (16, 1):
        state = torch.zeros((K, (2 * D + 1) * W), device=cuda)
        state[:, :W] = weights[0][1]
        cost = torch.full((1, 128), 1e30, device=cuda)
        cost[0, 0] = 0.0
        with decode_cluster(cl):
            for E, n_real in ((64, 64), (64, 41)):
                _, _, state, cost = parity_block(
                    run, dk.decode_lattice, dk.decode_lattice_ref,
                    random_lattice(rng, E, n_real, 4, L, v_real), n_real,
                    state, cost, K, W)


@pytest.mark.parametrize('K', [8, 16])
def test_kernel_matches_plain_long_alternatives_small_beams(cuda, K):
    """Alternatives of up to 64 chars at K in {8, 16}, in the layout the
    wrapper takes, against the plain version on every edge."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    L = 64
    rng = np.random.default_rng([K, L, 2])
    weights, v_real = _german(cuda)
    D, W = weights[2].shape[0], weights[0].shape[1]
    run = _runner(weights, v_real, cuda)
    state = torch.zeros((K, (2 * D + 1) * W), device=cuda)
    state[:, :W] = weights[0][1]
    cost = torch.full((1, 128), 1e30, device=cuda)
    cost[0, 0] = 0.0
    for E, n_real in ((64, 64), (64, 41)):
        _, _, state, cost = parity_block(
            run, dk.decode_lattice, dk.decode_lattice_ref,
            random_lattice(rng, E, n_real, 4, L, v_real), n_real, state,
            cost, K, W)


@pytest.mark.parametrize('K', [8, 16, 32])
@pytest.mark.parametrize('L', [1, 8, 64])
@pytest.mark.parametrize('model', ['german', 'd1w32', 'd2w64'])
def test_decode_cluster_sizes_agree(cuda, model, L, K):
    """Every cluster size the layout takes and the one-block layout give
    ``decode_lattice`` the same bits (records, device walk, final beam
    and costs) over two chained blocks (one with pad edges); the chosen
    size is one of them (at K=32, W=128: 16 blocks in the sharded plan).
    (The plain version holds the kernel in ``test_kernel_matches_plain*``,
    which run the chosen layout.)"""
    from chip_smoke import decode_cluster
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng([('german', 'd1w32', 'd2w64').index(model),
                                 L, K])
    if model == 'german':
        weights, v_real = _german(cuda)
    else:
        D, W = (1, 32) if model == 'd1w32' else (2, 64)
        v_real = 40
        weights = [t.to(cuda) for t in _random_weights(rng, D, W, v_real)]
    D, W = weights[2].shape[0], weights[0].shape[1]
    sizes = dk.cluster_sizes(K, 4, L, D, W, 128, v_real)
    assert dk.cluster_blocks(cuda, False, 1, K, 4, L, D, W, 128,
                             v_real) in sizes + ([1] if not sizes else [])
    run = _runner(weights, v_real, cuda)
    state = torch.zeros((K, (2 * D + 1) * W), device=cuda)
    state[:, :W] = weights[0][1]
    cost = torch.full((1, 128), 1e30, device=cuda)
    cost[0, 0] = 0.0
    for E, n_real in ((48, 48), (32, 21)):
        arrays = random_lattice(rng, E, n_real, 4, L, v_real)
        outs = {}
        for cl in [1] + sizes:
            with decode_cluster(cl):
                outs[cl] = [run(dk.decode_lattice, arrays, n_real, state,
                                cost, walk) for walk in (False, True)]
        for cl in sizes:
            for got, want in zip(outs[cl], outs[1]):
                assert all(torch.equal(g, w) for g, w in zip(got, want)), cl
        state, cost = outs[1][0][1:]


def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    from ocrd_keraslm_torch.ops import _build
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    monkeypatch.setattr(dk, 'decode_lattice_ref', None)
    rng = np.random.default_rng(3)
    weights = [t.to(cuda) for t in _random_weights(rng, 2, 16, 30)]
    state = torch.zeros((8, 5 * 16), device=cuda)
    cost = torch.full((1, 128), 1e30, device=cuda)
    cost[0, 0] = 0.0
    before = dk.decode_lattice.launches
    _runner(weights, 30, cuda)(dk.decode_lattice,
                               random_lattice(rng, 16, 12, 4, 2, 30), 12,
                               state, cost, True)
    assert dk.decode_lattice.launches == before + 1
    assert os.path.isdir(_build.BUILD_DIR)


@pytest.mark.parametrize('want_c_all', [False, True])
@pytest.mark.parametrize('B, T, W', [(3, 50, 32), (9, 64, 32),
                                     (4, 4096, 128), (1, 64, 128),
                                     (33, 40, 128), (128, 32, 128),
                                     (9, 24, 100), (3, 16, 384),
                                     (5, 8, 1024), (300, 12, 128)])
def test_lstm_scan_matches_plain(cuda, B, T, W, want_c_all):
    """Small widths, a grid of several blocks or clusters (B=9, 33,
    128; B=300: clusters in waves, the last partly empty), the main path's full width (W=128, a 4096-step chunk), a width
    that the cluster does not divide (W=100), and widths that take the
    one-block layout (W=384, 1024)."""
    from ocrd_keraslm_torch.ops import lstm_cell
    rng = np.random.default_rng([B, T, W])
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.normal(0, 1, (B, T, 4 * W)).astype(np.float32),
        rng.normal(0, 0.5, (B, W)).astype(np.float32),
        rng.normal(0, 0.5, (B, W)).astype(np.float32),
        rng.normal(0, 1 / np.sqrt(W), (W, 4 * W)).astype(np.float32))]
    before = lstm_cell.lstm_scan.launches
    got = lstm_cell.lstm_scan(*args, want_c_all=want_c_all)
    torch.cuda.synchronize()
    assert lstm_cell.lstm_scan.launches == before + 1
    assert (got[1] is None) == (not want_c_all)
    compare_lstm(got, lstm_cell.lstm_scan_ref(*args, want_c_all=want_c_all))


@pytest.mark.parametrize('case', ['d1w32', 'd2w32b9', 'd3w32',
                                  'german_b1', 'german_b4', 'german_d1',
                                  'd1w128b1', 'd2w128b3', 'd3w64b33',
                                  'd2w128b128', 'd2w100b9', 'd2w384b3',
                                  'd3w384b1'])
def test_score_scan_matches_plain(cuda, case):
    """Small widths at depth 1-3 (B=9: two groups of streams, one partly
    empty), and the german model's full width (D=2, W=128, V=70 padded
    to 128) over a 4096-step chunk, from a seeded nonzero carry with a
    partial mask; ``german_d1`` keeps its layer 0 only (the dummy layer
    operands of D=1); B in {1, 3, 33, 128} at depth 1-3; a width that
    the cluster does not divide (W=100) and a width that takes the
    one-block layout (W=384, the widest the fused path takes)."""
    from ocrd_keraslm_torch.ops import score_kernel as sk
    rng = np.random.default_rng(len(case))
    args = score_inputs(rng, case, cuda)
    before = sk.score_scan.launches
    got = sk.score_scan(*args)
    torch.cuda.synchronize()
    assert sk.score_scan.launches == before + 1
    compare_score(got, sk.score_scan_ref(*args))


@pytest.mark.parametrize('fused', [True, False])
def test_rater_scoring_launches_and_matches_cpu(cuda, fused):
    """The german model rates on the card through the fused kernel (one
    score_scan launch per 4096-char chunk) or the layered path (one
    lstm_scan launch per layer and chunk), and agrees with the CPU."""
    from ocrd_keraslm_torch.ops import lstm_cell
    from ocrd_keraslm_torch.ops import score_kernel as sk
    from ocrd_keraslm_torch.rater import Rater
    raters = {}
    for device in (cuda, 'cpu'):
        r = Rater(device=device)
        r.load_config(MODEL)
        r.configure()
        r.load_weights(MODEL)
        r.fused_score = fused
        raters[str(device)] = r
    rng = np.random.default_rng(5)
    chars = sorted(raters['cuda'].vocab.c2i)
    texts = [''.join(chars[i] for i in rng.integers(0, len(chars), n))
             for n in (5000, 300, 1)]
    s0, l0 = sk.score_scan.launches, lstm_cell.lstm_scan.launches
    got = raters['cuda'].rate_batch(texts, [[179], None, [2]])
    torch.cuda.synchronize()
    chunks = 2   # the 5000-char text takes 2 chunks of 4096
    if fused:
        assert sk.score_scan.launches - s0 == chunks
        assert lstm_cell.lstm_scan.launches == l0
    else:
        assert sk.score_scan.launches == s0
        assert lstm_cell.lstm_scan.launches - l0 == 2 * chunks
    want = raters['cpu'].rate_batch(texts, [[179], None, [2]])
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)


def test_cuda_scoring_never_takes_the_plain_versions(cuda, monkeypatch):
    from ocrd_keraslm_torch.ops import lstm_cell
    from ocrd_keraslm_torch.ops import score_kernel as sk
    from ocrd_keraslm_torch.rater import Rater
    monkeypatch.setattr(sk, 'score_scan_ref', None)
    monkeypatch.setattr(lstm_cell, 'lstm_scan_ref', None)
    r = Rater(device=cuda)
    r.load_config(MODEL)
    r.configure()
    r.load_weights(MODEL)
    for fused in (True, False):
        r.fused_score = fused
        _, ppl = r.rate2('Was ist Aufklärung?', [179])
        assert np.isfinite(ppl) and ppl > 1


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('B, T, W', [(3, 7, 32), (13, 33, 32), (11, 1, 128),
                                     (128, 256, 128), (1, 16, 128),
                                     (33, 12, 128), (9, 10, 100),
                                     (9, 6, 384)])
def test_lstm_bwd_and_bf16_scan_match_plain(cuda, B, T, W, bf16):
    """The training kernels against their plain versions: small widths,
    ragged B (13 = 8 + 5: two blocks, one partly empty), one step, the
    main path's full shape, B in {1, 33}, a width that the cluster does
    not divide (W=100) and one whose forward takes the one-block layout
    (W=384); ``dU`` bit-equal over two launches."""
    from ocrd_keraslm_torch.ops import lstm_cell
    rng = np.random.default_rng([B, T, W, int(bf16)])
    fwd, cot = lstm_train_inputs(rng, cuda, bf16, B=B, T=T, W=W)
    s0, b0 = lstm_cell.lstm_scan.launches, lstm_cell.lstm_bwd.launches
    got = lstm_cell.lstm_scan(*fwd, want_c_all=True)
    torch.cuda.synchronize()
    compare_lstm(got, lstm_cell.lstm_scan_ref(*fwd, want_c_all=True),
                 atol=BF16_FWD_ATOL if bf16 else 1e-5)
    args = lstm_bwd_args(fwd, cot, got[:2])
    outs = [lstm_cell.lstm_bwd(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert lstm_cell.lstm_scan.launches == s0 + 1
    assert lstm_cell.lstm_bwd.launches == b0 + 2
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][1].dtype == torch.float32
    compare_bwd(outs[0], lstm_cell.lstm_bwd_ref(*args))


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('B, T, W', [(1, 40, 64), (3, 1, 128), (3, 40, 128),
                                     (129, 30, 128), (128, 256, 128),
                                     (9, 20, 256), (1, 1, 64), (33, 7, 100)])
def test_lstm_bwd_every_layout_matches_plain(cuda, B, T, W, bf16):
    """``lstm_bwd`` in every layout the chooser can take (the register
    layout on clusters of 1-16 blocks of 1-8 streams, and the one-block
    layout) against its plain version: B in {1, 3, 33, 129} (not a
    multiple of a cluster's streams), T = 1, W in {64, 100, 128, 256};
    the chosen layout is one of them."""
    from chip_smoke import scan_layout, scan_layouts
    from ocrd_keraslm_torch.ops import lstm_cell
    rng = np.random.default_rng([B, T, W, int(bf16), 5])
    fwd, cot = lstm_train_inputs(rng, cuda, bf16, B=B, T=T, W=W)
    args = lstm_bwd_args(fwd, cot, lstm_cell.lstm_scan(
        *fwd, want_c_all=True)[:2])
    want = lstm_cell.lstm_bwd_ref(*args)
    layouts = scan_layouts('bwd', B, W, 1)
    assert len(layouts) > 2
    for rb, cl, reg in layouts:
        with scan_layout(rb, cl, reg):
            compare_bwd(lstm_cell.lstm_bwd(*args), want)
    lay = lstm_cell.bwd_layout_on(cuda, B, W)
    assert (lay.rb, lay.cl, lay.reg) in layouts


@pytest.mark.parametrize('B, T, W', [(4, 300, 128), (33, 40, 128),
                                     (9, 30, 100), (3, 40, 64),
                                     (2, 30, 256), (129, 17, 128)])
def test_lstm_bwd_cluster_sizes_agree(cuda, B, T, W):
    """Every layout the chooser can return gives ``lstm_bwd`` (f32 and
    bf16 U) the bits of the one-block layout of the first port: the z
    recompute and the blocked sums of dh keep their order."""
    from chip_smoke import scan_layout, scan_layouts
    from ocrd_keraslm_torch.ops import lstm_cell
    from ocrd_keraslm_torch.ops import scan_layout as sl
    one_block = (sl.rows_per_block(B), 1, False)
    for bf16 in (False, True):
        rng = np.random.default_rng([B, T, W, int(bf16), 6])
        fwd, cot = lstm_train_inputs(rng, cuda, bf16, B=B, T=T, W=W)
        args = lstm_bwd_args(fwd, cot, lstm_cell.lstm_scan(
            *fwd, want_c_all=True)[:2])
        outs = {}
        for rb, cl, reg in scan_layouts('bwd', B, W, 1):
            with scan_layout(rb, cl, reg):
                outs[rb, cl, reg] = lstm_cell.lstm_bwd(*args)
        want = outs[one_block]
        assert len(outs) > 2
        for key, got in outs.items():
            assert all(torch.equal(g, w) for g, w in zip(got, want)), key


def test_cuda_training_never_takes_the_plain_versions(cuda, monkeypatch):
    from ocrd_keraslm_torch.ops import lstm_cell
    monkeypatch.setattr(lstm_cell, 'lstm_scan_ref', None)
    monkeypatch.setattr(lstm_cell, 'lstm_bwd_ref', None)
    rng = np.random.default_rng(4)
    fwd, cot = lstm_train_inputs(rng, cuda, False, B=5, T=6, W=32)
    leaves = [t.clone().requires_grad_() for t in fwd]
    h_all, hT, cT = lstm_cell.LSTMScan.apply(*leaves)
    b0 = lstm_cell.lstm_bwd.launches
    ((h_all * cot[0]).sum() + (hT * cot[1]).sum()
     + (cT * cot[2]).sum()).backward()
    assert lstm_cell.lstm_bwd.launches == b0 + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)
    with pytest.raises(ValueError, match='dtype'):
        lstm_cell.lstm_scan(*fwd[:3], fwd[3].half())


@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
def test_forward_seq_gradients_match_cpu(cuda, compute_dtype):
    """Loss and parameter gradients of one training forward and
    backward (dropout on, same seed) on the card and on the CPU."""
    from ocrd_keraslm_torch.models import lstm_lm as tlm
    from ocrd_keraslm_torch.ops import lstm_cell
    cfg = tlm.LMConfig(width=64, depth=2, length=40, voc_size=50,
                       contexts=((200, 10),), dropout=0.1,
                       compute_dtype=compute_dtype)
    base = tlm.init_params(cfg, torch.Generator().manual_seed(2))
    base['char_embedding'] = base['char_embedding'] * 300
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(1, 50, (13, 40)))
    y = torch.from_numpy(rng.integers(1, 50, (13, 40)))
    z = torch.from_numpy(rng.integers(0, 200, (13,)))
    grads, losses = {}, {}
    for device in (cuda, torch.device('cpu')):
        params = tlm.params_from_numpy(tlm.params_to_numpy(base), device)
        for t in tlm.param_leaves(params):
            t.requires_grad_()
        b0 = lstm_cell.lstm_bwd.launches
        logits, _ = tlm.forward_seq(
            params, cfg, x.to(device), [z.to(device)], train=True,
            rng=torch.Generator().manual_seed(9))
        loss = tlm.sequence_xent(logits, y.to(device))[0] \
            + tlm.regularization_loss(params)
        loss.backward()
        assert lstm_cell.lstm_bwd.launches - b0 == \
            (2 if device.type == 'cuda' else 0)
        losses[device.type] = loss.item()
        grads[device.type] = [t.grad.cpu() for t in tlm.param_leaves(params)]
    tol = 1e-3 if compute_dtype == 'float32' else 3e-2
    assert abs(losses['cuda'] - losses['cpu']) <= 1e-5 * abs(losses['cpu'])
    for g, w in zip(grads['cuda'], grads['cpu']):
        torch.testing.assert_close(g, w, rtol=tol,
                                   atol=tol * 1e-2 * float(w.abs().max()))


def _gen_inputs(device, prompts, fringe=256):
    """The german rater on ``device``, its generation weights, v_real and
    the prefix-conditioned fringes (N, K, S), (N, K) of ``prompts``."""
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    from ocrd_keraslm_torch.ops.beam_device import _prefix_arrays
    from ocrd_keraslm_torch.rater import Rater
    rater = Rater(device=device)
    rater.load_config(MODEL)
    rater.configure()
    rater.load_weights(MODEL)
    w = rater._decode_weights(None)
    weights = [w['emb'], w['embT'], w['wcat'], w['bias']]
    ids, mask = _prefix_arrays([rater.vocab.encode(p) for p in prompts])
    state0, cost0 = gk._prefix_fringe(*weights, ids, mask, w['v_real'],
                                      fringe)
    return rater, weights, w['v_real'], state0, cost0


@pytest.mark.parametrize('fringe, topk', [(256, 10), (128, 10), (32, 4)])
def test_gen_beam_matches_plain(cuda, fringe, topk):
    """48 steps from a prompt, every step held against the plain version
    on the same card (16, 8 and 4 fringe rows a block)."""
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    _, weights, v_real, state0, cost0 = _gen_inputs(
        cuda, ['Die Vernunft '], fringe)
    gen_parity(gk.gen_beam, gk.gen_beam_ref, weights, state0, cost0, 48,
               v_real, topk=topk)


def test_gen_beam_streams_are_independent(cuda):
    """Three streams in one launch give each stream's records of its own
    launch, bit for bit (one block cluster a stream, or g clusters a
    stream in row groups), in every layout the chooser can take for
    three streams."""
    from chip_smoke import gen_layout, gen_layouts_on
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    _, weights, v_real, state0, cost0 = _gen_inputs(
        cuda, ['Die Vernunft ', 'Was ist ', 'Der Mensch '])
    lays = gen_layouts_on(cuda, 256, 2, 128, 128, 10, v_real, 3)
    assert any(lay.g > 1 for lay in lays)
    for lay in lays:
        with gen_layout(lay):
            together = gk.gen_beam(*weights, state0, cost0, length=20,
                                   v_real=v_real)
            for s in range(3):
                alone = gk.gen_beam(*weights, state0[s:s + 1].contiguous(),
                                    cost0[s:s + 1].contiguous(), length=20,
                                    v_real=v_real)
                assert torch.equal(together[s], alone[0]), (lay, s)


def _small_gen_inputs(device, D, W, K, N, seed):
    """Seeded random weights of a D-layer model of width W (v_real 70 of
    128) and the fringes (N, K, S) of N seeded random prefixes."""
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    rng = np.random.default_rng(seed)
    weights = [t.to(device) for t in _random_weights(rng, D, W, 70)]
    ids = rng.integers(1, 70, (N, 5)).astype(np.int32)
    mask = np.ones((N, 5), np.float32)
    mask[:, -1] = 0.0
    state0, cost0 = gk._prefix_fringe(*weights, ids, mask, 70, K)
    return weights, state0, cost0


@pytest.mark.parametrize('D, W, K', [(2, 128, 256), (1, 64, 256),
                                     (2, 64, 128), (2, 32, 64),
                                     (1, 96, 256), (2, 128, 32)])
def test_gen_beam_cluster_sizes_agree(cuda, D, W, K):
    """Every layout the chooser can take (the unit layout on 4, 8 or 16
    blocks a cluster, one cluster a stream or g in row groups where all
    N*g fit at once, the rows layout of the first design on 8 or 16)
    gives the same records and final fringe, bit for bit, for one stream
    and for nine streams a launch (more clusters of 16 blocks than the
    card holds at once: they run in waves): the rows or units a block
    holds change, not the arithmetic."""
    from chip_smoke import gen_layout, gen_layouts_on
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    weights, state0, cost0 = _small_gen_inputs(cuda, D, W, K, 9, [D, W, K])
    one = gen_layouts_on(cuda, K, D, W, 128, 10, 70)
    assert any(lay.units for lay in one) and any(not lay.units
                                                for lay in one)
    assert any(lay.g > 1 for lay in one)
    for N in (1, 9):
        lays = gen_layouts_on(cuda, K, D, W, 128, 10, 70, N)
        outs = {}
        for lay in lays:
            with gen_layout(lay):
                outs[lay] = gk.gen_beam(*weights, state0[:N].contiguous(),
                                        cost0[:N].contiguous(), length=24,
                                        v_real=70, final_state=True)
        want = outs[[lay for lay in lays if lay.g == 1][-1]]
        for lay, got in outs.items():
            assert torch.equal(got[0], want[0]), lay
            assert torch.equal(got[1], want[1]), lay
    assert gk.layout_on(cuda, 1, K, D, W, 128, 10, 70) in one
    assert gk.layout_on(cuda, 9, K, D, W, 128, 10, 70) in lays


@pytest.mark.parametrize('K, D, W, Vp, v_real', [
    (256, 2, 128, 128, 70), (256, 1, 64, 128, 70), (64, 2, 32, 128, 70),
    (32, 2, 128, 128, 70), (256, 1, 96, 128, 128)])
def test_gen_layout_plans_match_the_source(cuda, K, D, W, Vp, v_real):
    """The host's shared-memory plans (``gen_kernel.units_plan_bytes``,
    ``rows_plan_bytes``) are the source's, for every layout the shape
    takes, and the card holds a cluster of each the chooser may take."""
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    lib = gk._library()
    index = torch.cuda.current_device()
    lays = gk.gen_layouts(K, D, W, Vp, 10, v_real)
    assert lays
    for lay in lays:
        if lay.units:
            assert lay.smem == lib.gen_beam_units_smem_bytes(
                K, lay.cl, lay.rh, lay.tr, lay.g, D, W, Vp, v_real, 10), lay
        else:
            assert lay.smem == lib.gen_beam_smem_bytes(K, lay.cl, D, W, Vp,
                                                       10), lay
    chosen = gk.layout_on(cuda, 1, K, D, W, Vp, 10, v_real)
    assert gk.clusters_that_fit(index, K, D, W, Vp, 10, v_real, chosen) > 0


def test_gen_beam_row_groups_counter(cuda):
    """``gen_beam.row_groups`` counts the row groups of launches in row
    groups: a one-stream ``generate`` request takes one such launch of
    the chooser's g clusters, a 16-stream ``generate_batch`` none; the
    strings equal the CPU's."""
    from chip_smoke import german_rater
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    rater = german_rater(cuda)
    w = rater._decode_weights(None)
    lay = gk.layout_on(cuda, 1, 256, rater.depth, rater.width,
                       w['emb'].shape[0], 10, w['v_real'])
    assert lay.units and lay.g > 1
    for n in (1, 2):
        launches, groups = gk.gen_beam.launches, gk.gen_beam.row_groups
        for _ in range(n):
            got = rater.generate('Die Vernunft ', 40, variants=2)
        assert gk.gen_beam.launches - launches == n
        assert gk.gen_beam.row_groups - groups == n * lay.g
    cpu = german_rater(torch.device('cpu'))
    assert got == cpu.generate('Die Vernunft ', 40, variants=2)
    prompts = ['Die ', 'Was ist ', 'Der Mensch ', 'Aber '] * 4
    launches, groups = gk.gen_beam.launches, gk.gen_beam.row_groups
    rater.generate_batch(prompts, 16)
    assert gk.gen_beam.launches - launches == 1
    assert gk.gen_beam.row_groups == groups


def test_gen_beam_final_state_resumes(cuda):
    """The fringe after step t (``final_state``) and its last costs
    resume the search: 8 steps, then 16 from there, equal 24 steps in one
    launch, bit for bit, in every layout."""
    from chip_smoke import gen_layout, gen_layouts_on
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    _, weights, v_real, state0, cost0 = _gen_inputs(
        cuda, ['Die Vernunft ', 'Was ist '])
    for lay in gen_layouts_on(cuda, 256, 2, 128, 128, 10, v_real, 2):
        with gen_layout(lay):
            full = gk.gen_beam(*weights, state0, cost0, length=24,
                               v_real=v_real)
            head, fringe = gk.gen_beam(*weights, state0, cost0, length=8,
                                       v_real=v_real, final_state=True)
            tail = gk.gen_beam(*weights, fringe.contiguous(),
                               head[:, -1, 2].contiguous(), length=16,
                               v_real=v_real)
        assert torch.equal(full, torch.cat([head, tail], 1)), lay


@pytest.mark.parametrize('B, T, W', [(4, 300, 128), (33, 40, 128),
                                     (9, 30, 100), (3, 40, 64),
                                     (2, 30, 256)])
def test_lstm_cluster_sizes_agree(cuda, B, T, W):
    """Every layout the chooser can return (the register layout on
    clusters of 1-16 blocks of 1-8 streams, and the one-block layout)
    gives ``lstm_scan`` (f32 and bf16 U, ``c_all`` on) and ``score_scan``
    the same bits as the one-block layout of the first port: the
    blocked sums keep their order."""
    from chip_smoke import scan_layout, scan_layouts
    from ocrd_keraslm_torch.ops import lstm_cell
    from ocrd_keraslm_torch.ops import score_kernel as sk
    from ocrd_keraslm_torch.ops import scan_layout as sl
    rng = np.random.default_rng([B, T, W])
    one_block = (sl.rows_per_block(B), 1, False)
    for bf16 in (False, True):
        fwd, _ = lstm_train_inputs(rng, cuda, bf16, B=B, T=T, W=W)
        outs = {}
        for rb, cl, reg in scan_layouts('lstm', B, W, 1):
            with scan_layout(rb, cl, reg):
                outs[rb, cl, reg] = lstm_cell.lstm_scan(*fwd,
                                                        want_c_all=True)
        want = outs[one_block]
        assert len(outs) > 3
        for key, got in outs.items():
            assert all(torch.equal(g, w) for g, w in zip(got, want)), key
    D = 1 if W > 128 else 2
    args = score_inputs(rng, 'd%dw%db%d' % (D, W, B), cuda)
    outs = {}
    for rb, cl, reg in scan_layouts('score', B, W, D):
        with scan_layout(rb, cl, reg):
            p, n, (h, c) = sk.score_scan(*args)
        outs[rb, cl, reg] = (p, n, h, c)
    want = outs[one_block]
    assert len(outs) > 1
    for key, got in outs.items():
        assert all(torch.equal(g, w) for g, w in zip(got, want)), key
    for bf16 in (False, True):
        lay = lstm_cell.scan_layout_on(cuda, B, W, bf16)
        assert lay.reg and (lay.rb, lay.cl, True) in scan_layouts(
            'lstm', B, W, 1)
    lay = sk.scan_layout_on(cuda, B, W, D, args[-2].shape[1])
    assert lay.reg and (lay.rb, lay.cl, True) in scan_layouts('score', B,
                                                              W, D)


@pytest.mark.parametrize('variants', [1, 5, 256])
def test_traceback_matches_plain(cuda, variants):
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    _, weights, v_real, state0, cost0 = _gen_inputs(
        cuda, ['Die Vernunft ', 'Was ist '])
    rec = gk.gen_beam(*weights, state0, cost0, length=64, v_real=v_real)
    for out_length in (64, 37, 1):
        best = torch.argsort(rec[:, out_length - 1, 2], dim=1,
                             stable=True)[:, :variants].int().contiguous()
        got = gk.traceback(rec, best, out_length)
        torch.cuda.synchronize()
        assert torch.equal(got, gk.traceback_ref(rec, best, out_length))


@pytest.mark.parametrize('N, T, K, VARS, out_length, segment', [
    (1, 1024, 256, 3, 1000, None),   # the main path: generate -n 1000 -v 3
    (16, 256, 256, 1, 256, None),    # generate_batch of 16 prompts
    (3, 4096, 256, 3, 4000, None),   # T*K beyond one block's shared memory
    (2, 1024, 256, 1024, 1024, None),  # 1024 cursors, four a thread
    (2, 130, 8, 1024, 130, 16),      # K=8: 32 sub-segments a segment
    (1, 5000, 200, 2, 4999, 64),     # more than TB_MAPS maps to compose
    (5, 16, 256, 3, 16, None),       # one segment: the walk launch alone
    (1, 512, 256, 3, 500, 1),        # one step a segment
    (1, 300, 24, 7, 111, 7),
])
def test_traceback_segments_match_plain(cuda, N, T, K, VARS, out_length,
                                        segment):
    """Seeded records (half the backpointers at slot K-1, so 255 at
    K=256): the segmented walk equals the plain version, one launch
    counted a call."""
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    rng = np.random.default_rng(N * 131 + T + K + VARS)
    rec = np.zeros((N, T, 3, K), np.float32)
    rec[:, :, 0] = rng.integers(1, 70, (N, T, K))
    rec[:, :, 1] = np.where(rng.random((N, T, K)) < 0.5, K - 1,
                            rng.integers(0, K, (N, T, K)))
    best = rng.integers(0, K, (N, VARS)).astype(np.int32)
    best[:, 0] = K - 1
    rec, best = torch.from_numpy(rec), torch.from_numpy(best)
    t0 = gk.traceback.launches
    got = gk.traceback(rec.to(cuda), best.to(cuda), out_length, segment)
    torch.cuda.synchronize()
    assert gk.traceback.launches == t0 + 1
    assert torch.equal(got.cpu(), gk.traceback_ref(rec, best, out_length))


def test_traceback_refuses_what_it_does_not_take(cuda):
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    rec = torch.zeros((1, 8, 3, 264), device=cuda)
    best = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match='K <= 256'):
        gk.traceback(rec, best, 8)
    with pytest.raises(ValueError, match='multiple of 4'):
        gk.traceback(rec[..., :6].contiguous(), best, 8)
    with pytest.raises(ValueError, match='VARS <= 1024'):
        gk.traceback(rec[..., :8].contiguous(),
                     torch.zeros((1, 1025), dtype=torch.int32, device=cuda),
                     8)


def test_generate_batch_launches_and_matches_single_calls(cuda):
    """``generate_batch`` launches each kernel once for all prompts and
    returns what single ``generate`` calls return, on the card as on the
    CPU; ``generate`` with 3 variants launches each kernel once."""
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    prompts = ['Die Vernunft ', 'Was ist ', 'Der Mensch ', 'Natur ', 'x']
    rater = _gen_inputs(cuda, prompts[:1])[0]
    cpu = _gen_inputs(torch.device('cpu'), prompts[:1])[0]
    b0, t0 = gk.gen_beam.launches, gk.traceback.launches
    batch = rater.generate_batch(prompts, 40)
    assert (gk.gen_beam.launches - b0, gk.traceback.launches - t0) == (1, 1)
    assert batch == [rater.generate(p, 40)[0] for p in prompts]
    assert batch == cpu.generate_batch(prompts, 40)
    b0, t0 = gk.gen_beam.launches, gk.traceback.launches
    three = rater.generate('Die Vernunft ', 64, variants=3)
    assert (gk.gen_beam.launches - b0, gk.traceback.launches - t0) == (1, 1)
    assert three == cpu.generate('Die Vernunft ', 64, variants=3)


def test_cuda_generation_never_takes_the_plain_versions(cuda, monkeypatch):
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    monkeypatch.setattr(gk, 'gen_beam_ref', None)
    monkeypatch.setattr(gk, 'traceback_ref', None)
    rater, weights, v_real, state0, cost0 = _gen_inputs(cuda, ['Die '], 16)
    b0 = gk.gen_beam.launches
    assert len(rater.generate('Die ', 9, variants=2)) == 2
    assert gk.gen_beam.launches == b0 + 1
    with pytest.raises(ValueError, match='multiple of 8'):
        gk.gen_beam(*weights, state0[:, :12].contiguous(),
                    cost0[:, :12].contiguous(), length=4, v_real=v_real)


def _batch_runner(weights, v_real, device, N):
    def run(fn, arrays, n_real, state, cost):
        chars, mask, conf, valid, steps = (
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays)
        out = fn(*weights, chars, mask, conf, valid, state, cost, n_docs=N,
                 lm_weight=0.5, v_real=v_real, alt_steps=steps,
                 n_real=n_real)
        torch.cuda.synchronize()
        return out
    return run


def _fresh_beams(weights, N, K):
    D, W = weights[2].shape[0], weights[0].shape[1]
    state = torch.zeros((N * K, (2 * D + 1) * W), device=weights[0].device)
    state[:, :W] = weights[0][1]
    cost = torch.full((N * K, 1), 1e30, device=weights[0].device)
    cost[::K] = 0.0
    return state, cost


@pytest.mark.parametrize('K', [8, 16])
@pytest.mark.parametrize('L', [1, 8])
@pytest.mark.parametrize('model', ['german', 'd3w32'])
def test_batch_kernel_matches_plain(cuda, model, L, K):
    """Three documents of different lengths over two chained blocks,
    every document's every edge held against the plain version by
    ``chip_smoke.parity_batch``."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng([('german', 'd3w32').index(model), L, K])
    if model == 'german':
        weights, v_real = _german(cuda)
    else:
        v_real = 40
        weights = [t.to(cuda) for t in _random_weights(rng, 3, 32, v_real)]
    N, W = 3, weights[0].shape[1]
    run = _batch_runner(weights, v_real, cuda, N)
    state, cost = _fresh_beams(weights, N, K)
    for E, n_real in ((64, 64), (64, 41)):
        arrays = batch_lattice(rng, N, [n_real, n_real // 2, 5], E, 4, L,
                               v_real)
        before = dk.decode_lattice_batch.launches
        _, ties, state, cost = parity_batch(
            run, dk.decode_lattice_batch, dk.decode_lattice_batch_ref,
            arrays, n_real, state, cost, N, K, W)
        assert dk.decode_lattice_batch.launches == before + 1 + 2 * len(ties)


@pytest.mark.parametrize('L', [1, 8])
def test_batch_equals_single_document_launches(cuda, L):
    """Every document of a batched launch gets, bit for bit, the records,
    final beam and costs of a single-document ``decode_lattice`` launch
    over its edges (the kernels share their device code)."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng([7, L])
    weights, v_real = _german(cuda)
    N, K, A, E = 5, 16, 4, 64
    arrays = batch_lattice(rng, N, [64, 30, 64, 9, 50], E, A, L, v_real)
    state, cost = _fresh_beams(weights, N, K)
    rec, stateF, costF = _batch_runner(weights, v_real, cuda, N)(
        dk.decode_lattice_batch, arrays, E, state, cost)
    for n in range(N):
        one = [np.ascontiguousarray(a[:, n * A:(n + 1) * A])
               for a in arrays[:4]]
        cost_n = torch.full((1, 128), 1e30, device=cuda)
        cost_n[0, :K] = cost[n * K:(n + 1) * K, 0]
        single = dk.decode_lattice(
            *weights, *(torch.from_numpy(a).to(cuda)
                        for a in one[:3] + [one[3][..., 0].copy()]),
            state[n * K:(n + 1) * K].contiguous(), cost_n, lm_weight=0.5,
            v_real=v_real, n_real=E,
            alt_steps=torch.from_numpy(arrays[4][:, 0].copy()).to(cuda))
        assert torch.equal(single[0][1:].reshape(E, 3, K),
                           rec[:, :, n * K:(n + 1) * K])
        assert torch.equal(single[1], stateF[n * K:(n + 1) * K])
        assert torch.equal(single[2][0, :K], costF[n * K:(n + 1) * K, 0])


@pytest.mark.parametrize('N', [1, 32, 33])
def test_batch_sizes_equal_single_document_launches(cuda, N):
    """A batch of N documents of unequal length (n_real from 64 down to
    1 edge; the batch's cluster size chosen for N, each single launch's
    for one document) equals, document by document and bit for bit, its
    single-document ``decode_lattice`` launches; so does the batch in the
    one-block layout."""
    from chip_smoke import decode_cluster
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng([8, N])
    weights, v_real = _german(cuda)
    K, A, E, L = 16, 4, 64, 8
    D, W = weights[2].shape[0], weights[0].shape[1]
    n_reals = [E] + [int(rng.integers(1, E + 1)) for _ in range(N - 1)]
    arrays = batch_lattice(rng, N, n_reals, E, A, L, v_real)
    state, cost = _fresh_beams(weights, N, K)
    run = _batch_runner(weights, v_real, cuda, N)
    got = run(dk.decode_lattice_batch, arrays, E, state, cost)
    with decode_cluster(1):
        one_block = run(dk.decode_lattice_batch, arrays, E, state, cost)
    assert all(torch.equal(a, b) for a, b in zip(got, one_block))
    rec, stateF, costF = got
    for n in range(N):
        one = [np.ascontiguousarray(a[:, n * A:(n + 1) * A])
               for a in arrays[:4]]
        cost_n = torch.full((1, 128), 1e30, device=cuda)
        cost_n[0, :K] = cost[n * K:(n + 1) * K, 0]
        single = dk.decode_lattice(
            *weights, *(torch.from_numpy(a).to(cuda)
                        for a in one[:3] + [one[3][..., 0].copy()]),
            state[n * K:(n + 1) * K].contiguous(), cost_n, lm_weight=0.5,
            v_real=v_real, n_real=E,
            alt_steps=torch.from_numpy(arrays[4][:, 0].copy()).to(cuda))
        assert torch.equal(single[0][1:].reshape(E, 3, K),
                           rec[:, :, n * K:(n + 1) * K]), n
        assert torch.equal(single[1], stateF[n * K:(n + 1) * K]), n
        assert torch.equal(single[2][0, :K], costF[n * K:(n + 1) * K, 0]), n
    assert dk.cluster_blocks(cuda, True, N, K, A, L, D, W, 128, v_real) >= 1


@pytest.mark.parametrize('L', [1, 8])
def test_k32_sharded_plan_equals_one_block(cuda, L):
    """K=32 at the german model's width (beam_width 17-32): the cluster
    layout in its sharded plan (16 blocks) gives ``decode_lattice`` the
    one-block layout's bits (records, device walk, final beam and costs)
    over two chained blocks, one with pad edges; and forced at K=16 the
    sharded plan gives the rows plan's bits, under f32 and bf16
    weights."""
    from chip_smoke import decode_cluster
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng([32, L, 17])
    weights, v_real = _german(cuda)
    D, W = weights[2].shape[0], weights[0].shape[1]
    assert dk.cluster_sizes(32, 4, L, D, W, 128, v_real) == [16]
    assert dk.cluster_shard(32, 4, L, D, W, 128, v_real, 16)
    for K, wts, layouts in (
            (32, weights, ((16, None), (1, None))),
            (16, weights, ((16, False), (16, True), (1, None))),
            (16, _bf16(weights), ((16, False), (16, True)))):
        run = _runner(wts, v_real, cuda)
        state = torch.zeros((K, (2 * D + 1) * W), device=cuda)
        state[:, :W] = weights[0][1]
        cost = torch.full((1, 128), 1e30, device=cuda)
        cost[0, 0] = 0.0
        for E, n_real in ((64, 64), (48, 29)):
            arrays = random_lattice(rng, E, n_real, 4, L, v_real)
            outs = []
            for cl, shard in layouts:
                with decode_cluster(cl, shard):
                    outs.append([run(dk.decode_lattice, arrays, n_real,
                                     state, cost, walk)
                                 for walk in (False, True)])
            for out, lay in zip(outs[1:], layouts[1:]):
                for got, want in zip(out, outs[0]):
                    assert all(torch.equal(g, w)
                               for g, w in zip(got, want)), (K, lay)
            state, cost = outs[0][0][1:]


@pytest.mark.parametrize('N', [1, 32])
def test_k32_batch_equals_single_document_launches(cuda, N):
    """The batched kernel at K=32 (the serving batch at beam_width 32),
    in the 16-block cluster layout (the sharded plan) and in the one-block
    layout, equals its single-document ``decode_lattice`` launches
    document by document and bit for bit."""
    from chip_smoke import decode_cluster
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng([32, N])
    weights, v_real = _german(cuda)
    K, A, E, L = 32, 4, 48, 8
    n_reals = [E] + [int(rng.integers(1, E + 1)) for _ in range(N - 1)]
    arrays = batch_lattice(rng, N, n_reals, E, A, L, v_real)
    state, cost = _fresh_beams(weights, N, K)
    run = _batch_runner(weights, v_real, cuda, N)
    with decode_cluster(16):
        got = run(dk.decode_lattice_batch, arrays, E, state, cost)
    with decode_cluster(1):
        one_block = run(dk.decode_lattice_batch, arrays, E, state, cost)
    assert all(torch.equal(a, b) for a, b in zip(got, one_block))
    rec, stateF, costF = got
    for n in range(N):
        one = [np.ascontiguousarray(a[:, n * A:(n + 1) * A])
               for a in arrays[:4]]
        cost_n = torch.full((1, 128), 1e30, device=cuda)
        cost_n[0, :K] = cost[n * K:(n + 1) * K, 0]
        single = dk.decode_lattice(
            *weights, *(torch.from_numpy(a).to(cuda)
                        for a in one[:3] + [one[3][..., 0].copy()]),
            state[n * K:(n + 1) * K].contiguous(), cost_n, lm_weight=0.5,
            v_real=v_real, n_real=E,
            alt_steps=torch.from_numpy(arrays[4][:, 0].copy()).to(cuda))
        assert torch.equal(single[0][1:].reshape(E, 3, K),
                           rec[:, :, n * K:(n + 1) * K]), n
        assert torch.equal(single[1], stateF[n * K:(n + 1) * K]), n
        assert torch.equal(single[2][0, :K], costF[n * K:(n + 1) * K, 0]), n


@pytest.mark.parametrize('N, K', [(1, 8), (33, 16), (200, 32)])
def test_walk_kernel_matches_plain(cuda, N, K):
    """The walk kernel over two chained blocks of random records (more
    documents than one block of threads at N=200) equals its plain
    version exactly."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng([N, K])
    k = k_ref = torch.from_numpy(rng.integers(0, K, N).astype(np.int32)) \
        .to(cuda)
    for E in (40, 17):
        rec = np.zeros((E, 3, N * K), np.float32)
        rec[:, 0] = rng.integers(0, K, (E, N * K))
        rec[:, 1] = rng.integers(0, 4, (E, N * K))
        rec[:, 2] = rng.normal(0, 10, (E, N * K))
        rec = torch.from_numpy(rec).to(cuda)
        before = dk.walk_records_batch.launches
        k, walk = dk.walk_records_batch(rec, k, n_docs=N, beam=K)
        k_ref, walk_ref = dk.walk_records_batch_ref(rec, k_ref, n_docs=N,
                                                    beam=K)
        torch.cuda.synchronize()
        assert dk.walk_records_batch.launches == before + 1
        assert torch.equal(k, k_ref) and torch.equal(walk, walk_ref)


@pytest.mark.parametrize('K', [1, 16, 32])
@pytest.mark.parametrize('E', [1, 7, 1024])
@pytest.mark.parametrize('N', [1, 31, 33, 100])
def test_walk_kernel_ragged_shapes(cuda, N, E, K):
    """The staged walk at ragged numbers of documents, edges and beam
    rows (chains of one step, of fewer steps than segments, of 1024),
    from non-zero start slots, equals its plain version exactly."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng([N, E, K])
    rec = np.zeros((E, 3, N * K), np.float32)
    rec[:, 0] = rng.integers(0, K, (E, N * K))
    rec[:, 1] = rng.integers(0, 4, (E, N * K))
    rec[:, 2] = rng.normal(0, 10, (E, N * K))
    rec = torch.from_numpy(rec).to(cuda)
    k_in = np.full(N, K - 1, np.int32)
    k_in[::2] = rng.integers(0, K, k_in[::2].shape)
    k_in = torch.from_numpy(k_in).to(cuda)
    got = dk.walk_records_batch(rec, k_in, n_docs=N, beam=K)
    want = dk.walk_records_batch_ref(rec, k_in, n_docs=N, beam=K)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rate_best_batch_launches_and_matches_single_and_cpu(cuda, tmp_path):
    """``Rater.rate_best_batch`` of seeded glyph pages (one alone, three
    joined with ``concat_graphs``) on the card: one batched launch and
    one walk launch per block of edges (16-edge blocks forced), paths
    equal to each document's own ``rate_best_device`` decode (same merge
    choice) and to the CPU's batch."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rater = german_rater(cuda)
    build_workspace(str(tmp_path), np.random.default_rng(3), 4, 2,
                    rater.vocab, alt_share=0.3)
    pages = workspace_graphs(str(tmp_path))
    docs = [pages[0], rater.concat_graphs(pages[1:])]
    rater.fused_batch_E_blk = 16
    b0, w0 = dk.decode_lattice_batch.launches, dk.walk_records_batch.launches
    got = rater.rate_best_batch(docs)
    rater.fused_batch_E_blk = None
    n_blocks = -(-max(len(p) for p, _ in got) // 16)
    assert dk.decode_lattice_batch.launches - b0 == n_blocks
    assert dk.walk_records_batch.launches - w0 == n_blocks
    rater.merge_runs = False   # glyph pages: the batch's unmerged prep
    same_results(got, [rater.rate_best_device(g, 0, 0)[:2] for g in docs])
    rater.merge_runs = True
    same_results(got, german_rater('cpu').rate_best_batch(docs),
                 cost_ulps=2)


def test_host_engine_card_matches_cpu(cuda, tmp_path):
    """The host decode engine on the card: ``rate_best`` over three
    seeded glyph pages with the traceback carried (history clustering at
    the processor's distance 5) and ``next_path``'s lock-in give the
    CPU's paths, scores and entropies within 1e-4; ``predict`` its
    probabilities and states within 1e-5."""
    card, cpu = german_rater(cuda), german_rater('cpu')
    build_workspace(str(tmp_path), np.random.default_rng(5), 3, 2,
                    card.vocab, alt_share=0.3)
    pages = workspace_graphs(str(tmp_path))
    results = []
    for r in (card, cpu):
        out, tb = [], None
        for g in pages:
            path, ent, tb = r.rate_best(g, 0, g.number_of_edges(),
                                        start_traceback=tb,
                                        beam_clustering_dist=5)
            out.append((path, ent))
        out.append(r.next_path(tb[0], ([], tb[1]))[:2])
        results.append(out)
    assert sum(len(p) for p, _ in results[0]) == sum(
        g.number_of_edges() for g in pages)
    for (pg, eg), (pc, ec) in zip(*results):
        assert [(e, t.Unicode) for e, t, _ in pg] == \
            [(e, t.Unicode) for e, t, _ in pc]
        assert all(abs(a - b) <= 1e-4 for (_, _, a), (_, _, b) in
                   zip(pg, pc))
        assert abs(eg - ec) <= 1e-4
    rng = np.random.default_rng(6)
    states = [[rng.normal(0, 0.5, (1, 128)).astype(np.float32)
               for _ in range(4)] if i % 2 else None for i in range(5)]
    (pg, sg), (pc, sc) = (r.predict(list('Kant '), states)
                          for r in (card, cpu))
    np.testing.assert_allclose(np.stack(pg), np.stack(pc), atol=1e-5)
    np.testing.assert_allclose(np.stack([np.concatenate(x) for x in sg]),
                               np.stack([np.concatenate(x) for x in sc]),
                               atol=1e-5)


def test_cuda_batch_never_takes_the_plain_versions(cuda, tmp_path,
                                                   monkeypatch):
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    monkeypatch.setattr(dk, 'decode_lattice_batch_ref', None)
    monkeypatch.setattr(dk, 'walk_records_batch_ref', None)
    rater = german_rater(cuda)
    build_workspace(str(tmp_path), np.random.default_rng(4), 2, 1,
                    rater.vocab)
    b0 = dk.decode_lattice_batch.launches
    assert all(path for path, _ in
               rater.rate_best_batch(workspace_graphs(str(tmp_path))))
    assert dk.decode_lattice_batch.launches == b0 + 1


def _arrays_launches(rater, docs, group):
    """Per page (choices, costs, start_cost) and the final carry of the
    native docs ``docs`` decoded in one group launch, or in a launch a
    page (``group`` false)."""
    from ocrd_keraslm_torch.rater import DECODE_MERGE_MAX
    table = rater.vocab._table()
    lats = [doc.lattice('glyph', True, DECODE_MERGE_MAX) for doc in docs]
    if group:
        E, L = rater.fused_gate_arrays(sum(n for _, n, _ in lats),
                                       max(m for _, _, m in lats), 10)
        segs = [(n,) + doc.fill(table, n, 4, L)
                for doc, (_, n, _) in zip(docs, lats)]
        pending, tb = rater.rate_best_device_begin_arrays_group(segs)
        return [rater.rate_best_device_finish_group(pending, i)
                for i in range(len(docs))], tb
    out, tb = [], None
    for doc, (_, n, m) in zip(docs, lats):
        E, L = rater.fused_gate_arrays(n, m, 10)
        pending, tb = rater.rate_best_device_begin_arrays(
            n, E, L, *doc.fill(table, E, 4, L), device_traceback=tb)
        out.append(rater.rate_best_device_finish_arrays(pending))
    return out, tb


def test_group_launch_equals_per_page_launches_bitwise(cuda, tmp_path):
    """Six seeded glyph pages in ONE group launch (records walked on the
    host from each page's last edge) against a launch a page (walked on
    the device): every page's choices, costs and anchor, and the final
    carry, equal bit for bit."""
    from chip_smoke import native_docs
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rater = german_rater(cuda)
    build_workspace(str(tmp_path), np.random.default_rng(23), 6, 3,
                    rater.vocab, alt_share=0.3)
    n0 = dk.decode_lattice.launches
    grouped, (gs, gc) = _arrays_launches(rater, native_docs(str(tmp_path)),
                                         True)
    assert dk.decode_lattice.launches == n0 + 1
    pages, (ps, pc) = _arrays_launches(rater, native_docs(str(tmp_path)),
                                       False)
    assert dk.decode_lattice.launches == n0 + 7
    for (gch, gco, g0), (pch, pco, p0) in zip(grouped, pages):
        assert np.array_equal(gch, pch) and np.array_equal(gco, pco)
        assert g0 == p0
    assert torch.equal(gs, ps) and torch.equal(gc, pc)


def test_native_lane_card_matches_cpu(cuda, tmp_path):
    """The processor's default lanes (native pages in page groups) on
    the card against the CPU: the lane served every page on both, the
    same choice per glyph, confs within 1e-4; on the card the record
    lane writes the native lane's content exactly."""
    from chip_smoke import (LANES, env_vars, output_glyphs, page_contents,
                            read_lanes, run_cli, zero_counts)
    rater = german_rater('cpu')
    outs = {}
    for name, platform, lane in (('card', 'cuda', 'native'),
                                 ('cpu', 'cpu', 'native'),
                                 ('records', 'cuda', 'records')):
        d = str(tmp_path / name)
        build_workspace(d, np.random.default_rng(29), 3, 4, rater.vocab,
                        alt_share=0.3)
        zero_counts()
        with env_vars(**LANES[lane]):
            run_cli(d, platform)
        assert read_lanes()['pages'] == (3 if lane == 'native' else 0)
        outs[name] = (output_glyphs(d)[0], page_contents(d))
    card, cpu = outs['card'][0], outs['cpu'][0]
    assert card.keys() == cpu.keys() and card
    for gid, ((u_g, c_g),) in card.items():
        ((u_c, c_c),) = cpu[gid]
        assert u_g == u_c and abs(c_g - c_c) <= 1e-4, (gid, u_g, u_c)
    assert outs['records'][1] == outs['card'][1]


def test_decode_engine_card_matches_cpu(cuda, tmp_path):
    """The unbounded decode engine on the card against the CPU: three
    seeded glyph pages at beam 40 (K=64) with the carry, each page's
    path equal, scores and entropies within 1e-4 (plus two ulps of the
    cumulative cost); no kernel launched."""
    from chip_smoke import NO_LAUNCHES, read_counts, zero_counts
    build_workspace(str(tmp_path), np.random.default_rng(41), 3, 3,
                    german_rater('cpu').vocab, alt_share=0.3)
    pages = workspace_graphs(str(tmp_path))
    out = {}
    for device in ('cuda', 'cpu'):
        rater = german_rater(device)
        zero_counts()
        tb, res = None, []
        for g in pages:
            path, ent, tb = rater.rate_best_device(g, 0, 0,
                                                   device_traceback=tb,
                                                   beam_width=40)
            res.append((path, ent))
        assert read_counts() == NO_LAUNCHES
        assert len(tb) == 4 and tb[0].device.type == device
        out[device] = res
    same_results(out['cuda'], out['cpu'], cost_ulps=2)


def test_generation_engine_card_matches_cpu(cuda):
    """``fused_generate`` off: the generation engine on the card gives
    the CPU's strings (three variants, and a batch of two prompts), with
    no ``gen_beam`` or ``gen_traceback`` launch."""
    from chip_smoke import read_counts, zero_counts
    out = {}
    for device in ('cuda', 'cpu'):
        rater = german_rater(device)
        rater.fused_generate = False
        zero_counts()
        out[device] = (rater.generate('Die Vernunft ', 24, variants=3),
                       rater.generate_batch(['Was ist ', 'Der '], 24))
        counts = read_counts()
        assert counts['gen_beam'] == counts['gen_traceback'] == 0
    assert out['cuda'] == out['cpu']
    assert len(out['cuda'][0]) == 3


def test_wide_model_runs_on_the_card(cuda):
    """A D=2, W=512 model (``chip_smoke.wide_rater``): the decode of a
    64-edge lattice and a 2-document batch take the engine (no decode
    kernel fits), generation takes the engine (no ``gen_beam`` layout),
    each equal to the CPU's; a backward through ``forward_seq`` launches
    ``lstm_bwd`` in its grid layout (5 streams in 4 groups of 2) without
    a CUDA error, its gradients those of the CPU."""
    from chip_smoke import (NO_LAUNCHES, read_counts, wide_lattice,
                            wide_rater, zero_counts)
    from ocrd_keraslm_torch.models.lstm_lm import forward_seq
    from ocrd_keraslm_torch.ops import lstm_cell
    rng = np.random.default_rng(43)
    out = {}
    for device in ('cuda', 'cpu'):
        rater = wide_rater(device)
        graphs = [wide_lattice(rng, rater.vocab, n) for n in (64, 23)] \
            if not out else graphs
        zero_counts()
        out[device] = (rater.rate_best_device(graphs[0], 0, 0)[:2],
                       rater.rate_best_batch(graphs),
                       rater.generate('Die ', 16, variants=2))
        assert read_counts() == NO_LAUNCHES
    same_results([out['cuda'][0]], [out['cpu'][0]], cost_ulps=2)
    same_results(out['cuda'][1], out['cpu'][1], cost_ulps=2)
    assert out['cuda'][2] == out['cpu'][2]
    lay = lstm_cell.bwd_layout_on(cuda, 5, 512)
    assert (lay.rb, lay.cl, lay.reg, lay.grid) == (2, 32, False, True)
    grads = {}
    x = torch.from_numpy(rng.integers(1, 60, (5, 8)))
    for device in ('cuda', 'cpu'):
        rater = wide_rater(device)
        params = {k: v for k, v in rater.params.items()}
        leaves = [lp['recurrent'].requires_grad_() for lp in params['lstm']]
        b0 = lstm_cell.lstm_bwd.launches
        logits, _ = forward_seq(params, rater.cfg, x.to(device),
                                [torch.zeros((5,), dtype=torch.long,
                                             device=device)], None)
        logits.square().mean().backward()
        if device == 'cuda':
            torch.cuda.synchronize()
            assert lstm_cell.lstm_bwd.launches == b0 + 2
        grads[device] = [leaf.grad.cpu() for leaf in leaves]
    for g, w in zip(grads['cuda'], grads['cpu']):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-5 * scale)


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('B, T', [(3, 9), (13, 7), (128, 16), (512, 8)])
def test_lstm_bwd_at_width_512_matches_plain(cuda, B, T, bf16):
    """``lstm_bwd`` at W=512, where the chain takes the grid layout
    (groups of ceil(B / groups) streams on 32 blocks each, as many groups
    as the card's SMs hold): against its plain version, ``dU`` bit-equal
    over two launches."""
    from ocrd_keraslm_torch.ops import lstm_cell
    from ocrd_keraslm_torch.ops import scan_layout as sl
    rng = np.random.default_rng([B, T, 512, int(bf16)])
    fwd, cot = lstm_train_inputs(rng, cuda, bf16, B=B, T=T, W=512)
    lay = lstm_cell.bwd_layout_on(cuda, B, 512)
    groups = min(B, sl.grid_groups(512, torch.cuda.get_device_properties(
        cuda).multi_processor_count))
    assert lay == sl.grid_layout_for('bwd', B, 512, -(-B // groups))
    got = lstm_cell.lstm_scan(*fwd, want_c_all=True)
    compare_lstm(got, lstm_cell.lstm_scan_ref(*fwd, want_c_all=True),
                 atol=BF16_FWD_ATOL if bf16 else 1e-5)
    args = lstm_bwd_args(fwd, cot, got[:2])
    outs = [lstm_cell.lstm_bwd(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0][1], outs[1][1])
    compare_bwd(outs[0], lstm_cell.lstm_bwd_ref(*args))


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('B, T', [(3, 9), (128, 16), (512, 8)])
def test_grid_layout_equals_one_block_at_width_512(cuda, B, T, bf16):
    """The grid layout and the one-block layout on the same inputs at
    W=512: ``lstm_scan`` (``c_all`` on and off) and ``lstm_bwd`` give
    the same bits in every output, and the chooser takes the grid
    layout for both."""
    from chip_smoke import GRID, scan_layout
    from ocrd_keraslm_torch.ops import lstm_cell
    rng = np.random.default_rng([B, T, 512, int(bf16), 8])
    fwd, cot = lstm_train_inputs(rng, cuda, bf16, B=B, T=T, W=512)
    assert lstm_cell.scan_layout_on(cuda, B, 512, bf16).grid
    assert lstm_cell.bwd_layout_on(cuda, B, 512).grid
    outs = {}
    for reg in (False, GRID):
        with scan_layout(reg=reg):
            saved = lstm_cell.lstm_scan(*fwd, want_c_all=True)
            args = lstm_bwd_args(fwd, cot, saved[:2]) if not reg else args
            outs[reg] = (tuple(lstm_cell.lstm_scan(*fwd)) + tuple(saved)
                         + tuple(lstm_cell.lstm_bwd(*args)))
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(outs[GRID], outs[False])):
        assert (g is None) == (w is None), i
        assert g is None or torch.equal(g, w), i


@pytest.mark.parametrize('W', [128, 256])
def test_one_block_rows_keep_the_bits(cuda, W):
    """The one-block layout at 8, 4, 2 and 1 streams a block gives
    ``lstm_scan`` and ``lstm_bwd`` the same bits: a smaller block only
    changes which block runs a stream."""
    from chip_smoke import scan_layout
    from ocrd_keraslm_torch.ops import lstm_cell
    rng = np.random.default_rng([W, 7])
    fwd, cot = lstm_train_inputs(rng, cuda, False, B=11, T=12, W=W)
    outs = []
    for rb in (8, 4, 2, 1):
        with scan_layout(rb, reg=False):
            saved = lstm_cell.lstm_scan(*fwd, want_c_all=True)
            outs.append(tuple(saved) + tuple(lstm_cell.lstm_bwd(
                *lstm_bwd_args(fwd, cot, saved[:2]))))
    for got in outs[1:]:
        assert all(torch.equal(g, w) for g, w in zip(got, outs[0]))


# ---- the bf16 decode mode (bf16 emb, embT and wcat) ----

def _bf16(weights):
    return [w.bfloat16() for w in weights[:3]] + [weights[3]]


def _stepwise(cuda, weights, v_real, arrays, n_real, state, cost, K, W):
    """``chip_smoke.parity_stepwise`` of ``decode_lattice`` under bf16
    weights (every edge from the kernel's beam, ``BF16_EDGE_TOL``), and
    the chained one-edge launches equal to the block launch bit for bit;
    returns the block's final state and cost."""
    from chip_smoke import BF16_EDGE_TOL, compare_decode, parity_stepwise
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    run = _runner(weights, v_real, cuda)

    def step(part, n, s, c):
        return (run(dk.decode_lattice, part, n, s, c, False),
                run(dk.decode_lattice_ref, part, n, s, c, False))

    def compare(got, want):
        e, _, div = compare_decode(got, want, K, W, **BF16_EDGE_TOL)
        return e, div

    block = run(dk.decode_lattice, arrays, n_real, state, cost, False)
    _, _, recs, state_k, cost_k = parity_stepwise(step, compare, arrays,
                                                  n_real, state, cost)
    assert torch.equal(torch.cat([r[1:] for r in recs]), block[0][1:])
    assert torch.equal(state_k, block[1]) and torch.equal(cost_k, block[2])
    return block[1], block[2]


@pytest.mark.parametrize('L', [1, 8])
@pytest.mark.parametrize('cl', [16, 1], ids=['cluster', 'one-block'])
def test_bf16_kernel_matches_plain(cuda, cl, L):
    """The german model's bf16 decode weights in the cluster layout (16
    blocks, gate products on the tensor cores) and the one-block layout:
    two chained blocks, every edge against the plain version from the
    kernel's beam; only bf16 launches are counted."""
    from chip_smoke import decode_cluster
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    weights, v_real = _german(cuda)
    weights = _bf16(weights)
    D, W, K = weights[2].shape[0], weights[0].shape[1], 16
    rng = np.random.default_rng([cl, L, 12])
    state = torch.zeros((K, (2 * D + 1) * W), device=cuda)
    state[:, :W] = weights[0][1].float()
    cost = torch.full((1, 128), 1e30, device=cuda)
    cost[0, 0] = 0.0
    before = dk.decode_lattice.launches, dk.decode_lattice.launches_bf16
    with decode_cluster(cl):
        for E, n_real in ((96, 96), (48, 31)):
            state, cost = _stepwise(
                cuda, weights, v_real,
                random_lattice(rng, E, n_real, 4, L, v_real), n_real, state,
                cost, K, W)
    assert dk.decode_lattice.launches == before[0]
    assert dk.decode_lattice.launches_bf16 > before[1]


@pytest.mark.parametrize('L', [1, 8])
def test_bf16_cluster_sizes_agree(cuda, L):
    """At W=64, D=2 (clusters of 4, 8 and 16 blocks: 8, 4 and 2 n8 tiles
    a block) bf16 weights give every cluster size the same bits, and the
    kernel holds against the plain version edge by edge."""
    from chip_smoke import decode_cluster
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng([64, L])
    v_real, K = 40, 16
    weights = _bf16([t.to(cuda) for t in _random_weights(rng, 2, 64,
                                                         v_real)])
    D, W = 2, 64
    sizes = dk.cluster_sizes(K, 4, L, D, W, 128, v_real)
    assert sizes == [4, 8, 16]
    run = _runner(weights, v_real, cuda)
    state = torch.zeros((K, (2 * D + 1) * W), device=cuda)
    state[:, :W] = weights[0][1].float()
    cost = torch.full((1, 128), 1e30, device=cuda)
    cost[0, 0] = 0.0
    arrays = random_lattice(rng, 64, 57, 4, L, v_real)
    outs = []
    for cl in sizes:
        with decode_cluster(cl):
            outs.append(run(dk.decode_lattice, arrays, 57, state, cost,
                            True))
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
    with decode_cluster(16):
        _stepwise(cuda, weights, v_real, arrays, 57, state, cost, K, W)


def test_bf16_batch_equals_single_document_launches(cuda):
    """The batched kernel under the german model's bf16 weights: every
    document's records and final beam equal a single-document bf16
    launch bit for bit, every edge of every document holds against the
    plain version from the kernel's beams, and only bf16 launches are
    counted."""
    from chip_smoke import (BF16_EDGE_TOL, batch_doc, compare_decode,
                            parity_stepwise)
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    weights, v_real = _german(cuda)
    weights = _bf16(weights)
    D, W = weights[2].shape[0], weights[0].shape[1]
    N, E, K, A, L = 4, 40, 16, 4, 8
    rng = np.random.default_rng([N, E, 12])
    n_reals = [E] + [int(rng.integers(5, E + 1)) for _ in range(N - 1)]
    arrays = batch_lattice(rng, N, n_reals, E, A, L, v_real)
    state = torch.zeros((N * K, (2 * D + 1) * W), device=cuda)
    state[:, :W] = weights[0][1].float()
    cost = torch.full((N * K, 1), 1e30, device=cuda)
    cost[::K] = 0.0

    def run(fn, arr, n_real, s, c):
        ins = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
               for a in arr]
        out = fn(*weights, *ins[:4], s, c, n_docs=N, lm_weight=0.5,
                 v_real=v_real, alt_steps=ins[4], n_real=n_real)
        torch.cuda.synchronize()
        return out

    def compare(got, want):
        err, div = 0.0, None
        for d in range(N):
            e, _, dv = compare_decode(batch_doc(*got, d, K),
                                      batch_doc(*want, d, K), K, W,
                                      **BF16_EDGE_TOL)
            err, div = max(err, e), div if div is not None else dv
        return err, div

    before = dk.decode_lattice_batch.launches
    rec, stateF, costF = run(dk.decode_lattice_batch, arrays, E, state, cost)
    _, _, recs, state_k, _ = parity_stepwise(
        lambda part, n, s, c: (run(dk.decode_lattice_batch, part, n, s, c),
                               run(dk.decode_lattice_batch_ref, part, n, s,
                                   c)),
        compare, arrays, E, state, cost)
    assert torch.equal(torch.cat(recs), rec) and torch.equal(state_k, stateF)
    assert dk.decode_lattice_batch.launches == before
    for n in range(N):
        one = [np.ascontiguousarray(a[:, n * A:(n + 1) * A])
               for a in arrays[:4]]
        cost_n = torch.full((1, 128), 1e30, device=cuda)
        cost_n[0, :K] = cost[n * K:(n + 1) * K, 0]
        single = dk.decode_lattice(
            *weights, *(torch.from_numpy(a).to(cuda)
                        for a in one[:3] + [one[3][..., 0].copy()]),
            state[n * K:(n + 1) * K].contiguous(), cost_n, lm_weight=0.5,
            v_real=v_real, n_real=E,
            alt_steps=torch.from_numpy(arrays[4][:, 0].copy()).to(cuda))
        assert torch.equal(single[0][1:].reshape(E, 3, K),
                           rec[:, :, n * K:(n + 1) * K]), n
        assert torch.equal(single[1], stateF[n * K:(n + 1) * K]), n
        assert torch.equal(single[2][0, :K], costF[n * K:(n + 1) * K, 0]), n


def _train_steps(cuda, steps=3, seed=5):
    """Three ``train_step``s at W=32 from one initialisation and dropout
    seed on the card; returns the gradients of each step and the final
    parameters."""
    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.models.lstm_lm import param_leaves, zero_carry
    from ocrd_keraslm_torch.rater import Rater
    from ocrd_keraslm_torch.utils.vocab import Vocab
    rater = Rater(device=cuda)
    rater.width, rater.depth, rater.length = 32, 2, 16
    rater.vocab = Vocab()
    rater.vocab.assign('abcdefghij ')
    rater.voc_size = rater.vocab.size
    rater.configure()
    params = training.copy_params(rater.params, requires_grad=True)
    optimizer = training.make_optimizer(params)
    cfg, gen = rater.cfg, torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    carry = zero_carry(cfg, 64, cuda)
    grads = []
    for _ in range(steps):
        # many repeats of few chars: the rows of a table row meet often
        x = torch.from_numpy(rng.integers(1, 12, (64, 16))).to(cuda)
        y = torch.from_numpy(rng.integers(1, 12, (64, 16))).to(cuda)
        zs = [torch.from_numpy(rng.integers(0, 20, (64,))).to(cuda)]
        mask = torch.ones((64, 16), device=cuda)
        optimizer.zero_grad(set_to_none=True)
        loss, (_, _, carry) = training._loss_fn(params, cfg, x, zs, y, mask,
                                                carry, gen, True)
        loss.backward()
        grads.append([p.grad.clone() for p in param_leaves(params)])
        optimizer.step()
        carry = (carry[0].detach(), carry[1].detach())
    return grads, [p.detach().clone() for p in param_leaves(params)]


def test_training_steps_are_the_same_from_run_to_run(cuda):
    """The embedding lookups of a training step on the card sum their
    gradient in a fixed order (a one-hot product), so two runs from one
    initialisation give the same gradients and parameters bit for bit:
    a resumed run can replay an uninterrupted one."""
    (g1, p1), (g2, p2) = _train_steps(cuda), _train_steps(cuda)
    for step, (a, b) in enumerate(zip(g1, g2)):
        assert all(torch.equal(u, v) for u, v in zip(a, b)), step
    assert all(torch.equal(u, v) for u, v in zip(p1, p2))


def test_resume_matches_uninterrupted_on_the_card(cuda, tmp_path,
                                                  monkeypatch):
    """``train --resume-dir`` on the card: a run killed in epoch 2
    resumes from its epoch-1 snapshot with the uninterrupted run's
    history, equal exactly."""
    import random

    from ocrd_keraslm_torch import training
    from ocrd_keraslm_torch.rater import Rater
    from ocrd_keraslm_torch.utils.orbaxio import load_train_state
    rng = np.random.default_rng(4)
    words = ('die', 'der', 'und', 'ist', 'kant', 'vernunft', 'mensch')
    files = []
    for name in ('a_eins_1781.txt', 'b_zwei_1790.txt', 'c_drei_1800.txt'):
        (tmp_path / name).write_text('\n'.join(
            ' '.join(words[i] for i in rng.integers(0, 7, 10))
            for _ in range(60)))
        files.append(str(tmp_path / name))

    class Killed(BaseException):
        pass

    def run(resume_dir, tag):
        monkeypatch.setattr(training, 'EPOCHS', 3)
        random.seed(11)
        np.random.seed(13)
        r = Rater(device=cuda)
        r.width, r.depth, r.length, r.batch_size = 32, 2, 16, 16
        r.ckpt_dir = str(tmp_path / ('ckpt_' + tag))
        r.resume_dir = resume_dir
        r.configure()
        r.train(files)
        return r
    want = run(None, 'a').history
    real = training.Prefetcher
    made = []

    class Dying:
        def __init__(self, gen):
            made.append(1)
            self.inner = real(gen)

        def __iter__(self):
            for n, b in enumerate(iter(self.inner)):
                if len(made) == 3 and n == 1:
                    self.inner.close()
                    raise Killed()
                yield b
    monkeypatch.setattr(training, 'Prefetcher', Dying)
    snap = str(tmp_path / 'snap')
    with pytest.raises(Killed):
        run(snap, 'b')
    monkeypatch.setattr(training, 'Prefetcher', real)
    assert load_train_state(snap)['meta']['epoch_done'] == 1
    assert run(snap, 'c').history == want


def test_trace_holds_one_event_per_decode_launch(cuda, tmp_path):
    """The decoding CLI with ``--jax-trace`` over a seeded 4-page
    workspace, three times in this process (which has run CUDA work and
    traces before): each Chrome trace holds one ``decode_lattice``
    kernel event for each launch the wrapper counted."""
    import glob

    from chip_smoke import platform_env, read_counts, trace_events, zero_counts
    from ocrd_keraslm_torch.wrapper.cli import ocrd_keraslm_rate
    vocab = german_rater(cuda).vocab
    for i in range(3):
        d = str(tmp_path / ('ws%d' % i))
        build_workspace(d, np.random.default_rng(7), 4, 40, vocab)
        tdir = str(tmp_path / ('trace%d' % i))
        zero_counts()
        with platform_env('cuda'):
            ocrd_keraslm_rate.main(args=[
                '-m', os.path.join(d, 'mets.xml'), '-I', 'OCR-D-OCR', '-O',
                'OCR-D-LM', '-l', 'WARNING', '--jax-trace', tdir, '-P',
                'model_file', MODEL, '-P', 'textequiv_level', 'glyph', '-P',
                'beam_width', '10'], standalone_mode=False)
        launches = read_counts()['decode_lattice']
        path, = glob.glob(os.path.join(tdir, '*.pt.trace.json'))
        named = trace_events(path)[2]
        assert launches > 0 and len(named) == launches, (i, len(named),
                                                         launches)


def test_fetch_span_holds_its_kernels_end(cuda, tmp_path):
    """Under ``devtrace.start_trace`` (the CLI's ``--jax-trace``) a
    one-page workspace: the ``keraslm.fetch`` span in which the page
    loop waits for the page's result starts before its
    ``decode_lattice`` kernel ends and ends at or after it, so spans and
    kernels share one clock."""
    import json

    from ocrd_keraslm_torch.utils import devtrace
    from ocrd_keraslm_torch.wrapper import KerasRate
    from ocrd_keraslm_torch.wrapper.mets import Workspace
    rater = german_rater(cuda)
    d = str(tmp_path / 'ws')
    build_workspace(d, np.random.default_rng(11), 1, 40, rater.vocab)
    proc = KerasRate(parameter={'model_file': MODEL}, device='cuda')
    proc.setup()
    stop = devtrace.start_trace(str(tmp_path / 'trace'))
    try:
        proc.process_workspace(Workspace(d))
    finally:
        path = stop()
    with open(path, encoding='utf-8') as fh:
        events = json.load(fh)['traceEvents']
    kernel, = [e for e in events if e.get('cat') == 'kernel'
               and 'decode_lattice' in e.get('name', '')]
    end = kernel['ts'] + kernel['dur']
    fetches = [e for e in events if e.get('name') == 'keraslm.fetch']
    assert fetches
    assert any(f['ts'] < end <= f['ts'] + f['dur'] for f in fetches), (
        end, [(f['ts'], f['ts'] + f['dur']) for f in fetches])
    # spans are host ranges: none is mirrored among the card's events
    assert not [e for e in events if e.get('name', '').startswith(
        devtrace.PREFIX) and e.get('cat') in ('kernel', 'gpu_memcpy',
                                              'gpu_memset',
                                              'gpu_user_annotation')]


# generation's prompt steps: one captured CUDA graph of a step, replayed

PROMPT_TEXT = ('Was ist Aufklärung? Aufklärung ist der Ausgang des Menschen '
               'aus seiner selbstverschuldeten Unmündigkeit.')
PROMPT_LENGTHS = (1, 2, 6, 36, 64, 65)


def _prompt_arrays(rater, lengths):
    from ocrd_keraslm_torch.ops.beam_device import _prefix_arrays
    return _prefix_arrays([rater.vocab.encode(PROMPT_TEXT[:n])
                           for n in lengths])


def _prompt_weights(rater):
    w = rater._decode_weights(None)
    return w['emb'], w['wcat'], w['bias']


@pytest.mark.parametrize('N', [1, 16])
def test_prompt_graph_roots_equal_plain_steps(cuda, N):
    """For each prompt length (N=16: 16 streams ending at that length,
    one char shorter each): the root rows of the captured step's replays
    equal the plain steps' on the card bit for bit, with one replay a
    step and at most one capture, at the first request."""
    from ocrd_keraslm_torch.ops import beam_device as bd
    rater = german_rater(cuda)
    weights = _prompt_weights(rater)
    captures = []
    for n_chars in PROMPT_LENGTHS:
        ids, mask = _prompt_arrays(
            rater, [max(n_chars - s, 1) for s in range(N)])
        r0 = bd._prefix_state.replays
        got = bd._prefix_state(*weights, ids, mask)
        assert bd._prefix_state.replays - r0 == max(n_chars - 1, 0)
        captures.append(bd._prefix_state.captures)
        assert torch.equal(got, bd._prefix_eager(*weights, ids, mask)), \
            (N, n_chars)
    assert len(set(captures)) == 1, captures


def test_second_request_replays_without_capture(cuda):
    """``generate`` and ``generate_batch``: a second request with the
    same stream count adds one replay a prompt step and no capture."""
    from ocrd_keraslm_torch.ops import beam_device as bd
    rater = german_rater(cuda)
    for call, prompts in (
            (lambda p: rater.generate(p[0], 20, variants=3),
             (['Die Vernunft '], ['Was ist der Mensch? '])),
            (lambda p: rater.generate_batch(p, 20),
             (['Die ', 'Natur ', 'x', 'Was ist '],
              ['Der Mensch ', 'Vernunft ', 'ab', 'Die Natur ']))):
        call(prompts[0])
        c0, r0 = bd._prefix_state.captures, bd._prefix_state.replays
        call(prompts[1])
        assert bd._prefix_state.captures == c0
        assert bd._prefix_state.replays - r0 == max(
            len(rater.vocab.encode(p)) for p in prompts[1]) - 1


def test_captures_share_one_stream(cuda):
    """A capture for a new stream count takes the stream of the
    captures before it, so cuBLAS sets up no further workspace: the
    card's allocated memory grows by less than 1 MiB."""
    from ocrd_keraslm_torch.ops import beam_device as bd
    rater = german_rater(cuda)
    weights = _prompt_weights(rater)
    bd._prefix_state(*weights, *_prompt_arrays(rater, [6]))
    torch.cuda.synchronize()
    m0, c0 = torch.cuda.memory_allocated(), bd._prefix_state.captures
    root = bd._prefix_state(*weights, *_prompt_arrays(rater, [6] * 7))
    torch.cuda.synchronize()
    assert bd._prefix_state.captures == c0 + 1 and root.shape[0] == 7
    assert torch.cuda.memory_allocated() - m0 < 1 << 20


def test_prompt_graph_captures_anew_for_reloaded_weights(cuda, tmp_path):
    """Weights reloaded by ``load_weights`` (the german model's, scaled
    by 0.9, through an h5 file) capture a new graph, whose root rows are
    the new weights' (equal to the plain steps over them)."""
    from ocrd_keraslm_torch.models.lstm_lm import param_leaves
    from ocrd_keraslm_torch.ops import beam_device as bd
    rater = german_rater(cuda)
    ids, mask = _prompt_arrays(rater, [36])
    old = bd._prefix_state(*_prompt_weights(rater), ids, mask)
    with torch.no_grad():
        for p in param_leaves(rater.params):
            p.mul_(0.9)
    path = str(tmp_path / 'scaled.h5')
    rater.save(path)
    rater.load_weights(path)
    weights = _prompt_weights(rater)
    c0 = bd._prefix_state.captures
    new = bd._prefix_state(*weights, ids, mask)
    assert bd._prefix_state.captures == c0 + 1
    assert torch.equal(new, bd._prefix_eager(*weights, ids, mask))
    assert not torch.equal(new, old)


def test_trace_holds_the_prompt_graph_kernels(cuda, tmp_path):
    """A ``generate`` request under ``devtrace.start_trace`` (its graph
    captured before): the Chrome trace holds one ``cudaGraphLaunch`` a
    prompt step and the kernels each replay ran, as many a replay, so
    that the device's busy time and the ``gen.*`` spans read the
    prompt's work."""
    import json

    from ocrd_keraslm_torch.ops import beam_device as bd
    from ocrd_keraslm_torch.utils import devtrace
    rater = german_rater(cuda)
    prompt = PROMPT_TEXT[:36]
    rater.generate(prompt, 16)
    r0 = bd._prefix_state.replays
    stop = devtrace.start_trace(str(tmp_path / 'trace'))
    try:
        rater.generate(prompt, 16)
    finally:
        path = stop()
    steps = bd._prefix_state.replays - r0
    assert steps == 35
    with open(path, encoding='utf-8') as fh:
        events = json.load(fh)['traceEvents']
    launches = {e['args']['correlation'] for e in events
                if e.get('cat') == 'cuda_runtime'
                and e.get('name') == 'cudaGraphLaunch'}
    assert len(launches) == steps
    kernels = [e for e in events if e.get('cat') == 'kernel'
               and e.get('args', {}).get('correlation') in launches]
    per = len(kernels) // steps
    assert per >= 2 * rater.depth and len(kernels) == per * steps, (
        len(kernels), steps)
    assert [e for e in events if e.get('name') == 'keraslm.gen.prompt']


def test_gen_digests_hold_with_the_prompt_graph(cuda):
    """``chip_smoke.GEN_DIGESTS`` (``gen_beam``'s records and final
    fringe from prompts conditioned on the card) hold with the prompt
    steps replayed from a captured graph."""
    from chip_smoke import GEN_DIGESTS, gen_digests
    from ocrd_keraslm_torch.ops import beam_device as bd
    r0 = bd._prefix_state.replays
    got = gen_digests(german_rater(cuda), cuda)
    assert bd._prefix_state.replays > r0
    bad = sorted((k, tuple(lay)) for (k, lay), v in got.items()
                 if v != GEN_DIGESTS[k])
    assert not bad, bad
