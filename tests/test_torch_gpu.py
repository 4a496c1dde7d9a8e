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
1e-5 of each tensor's max."""
import os

import numpy as np
import pytest
import torch

from chip_smoke import (BF16_FWD_ATOL, MODEL, compare_bwd, compare_lstm,
                        compare_score, lstm_bwd_args, lstm_train_inputs,
                        parity_block, random_lattice, score_inputs)

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
    """Alternatives of up to 64 chars (line level) at K=32: the 32-row
    chunk no longer fits in shared memory and the launcher takes
    16-row chunks."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    K, L = 32, 64
    rng = np.random.default_rng([K, L])
    weights, v_real = _german(cuda)
    D, W = weights[2].shape[0], weights[0].shape[1]
    assert dk._library().decode_lattice_smem_bytes(4, L, K, D, W, 128) \
        < dk._library().decode_lattice_smem_bytes(4, 8, K, D, W, 128)
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
                                     (4, 4096, 128)])
def test_lstm_scan_matches_plain(cuda, B, T, W, want_c_all):
    """Small widths, a grid of several blocks (B=9) and the main path's
    full width (W=128, a 4096-step chunk)."""
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
                                  'german_b1', 'german_b4', 'german_d1'])
def test_score_scan_matches_plain(cuda, case):
    """Small widths at depth 1-3 (B=9: two blocks, one partly empty),
    and the german model's full width (D=2, W=128, V=70 padded to 128)
    over a 4096-step chunk, from a seeded nonzero carry with a partial
    mask; ``german_d1`` keeps its layer 0 only (the dummy layer
    operands of D=1)."""
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
                                     (128, 256, 128)])
def test_lstm_bwd_and_bf16_scan_match_plain(cuda, B, T, W, bf16):
    """The training kernels against their plain versions: small widths,
    ragged B (13 = 8 + 5: two blocks, one partly empty), one step, and
    the main path's full shape; ``dU`` bit-equal over two launches."""
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
