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
