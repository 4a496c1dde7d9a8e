"""The fused scoring kernel's plain version against the JAX package on
the CPU.

``score_scan_ref`` (the plain version of the CUDA kernel
``csrc/score_scan.cu``, which the wrapper ``score_scan`` runs for CPU
tensors) is held against the Pallas kernel ``score_scan_pallas`` in
interpret mode at D in {1, 2, 3}, W=32, B=2, T=16, from a seeded
nonzero carry with a partial mask and a vocabulary padded from 13 to
128; ``pack_score_weights`` against its JAX counterpart.  Tolerances:
probs atol 1e-5 (f32, before any float16 rounding), NLL sums rtol 1e-4
(f32 sums of 16 terms), carry atol 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ocrd_keraslm_tpu.models.lstm_lm import LMConfig as JCfg
from ocrd_keraslm_tpu.ops import score_kernel as jsk
from ocrd_keraslm_torch.models.lstm_lm import LMConfig as TCfg
from ocrd_keraslm_torch.models.lstm_lm import params_from_numpy
from ocrd_keraslm_torch.ops import score_kernel as tsk

from test_torch_lstm_scan import _params

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

B, T, W, V = 2, 16, 32, 13


def _inputs(D, seed):
    """(model tree, xp1, y, mask, h0, c0) as numpy, seeded."""
    cfg = JCfg(width=W, depth=D, voc_size=V, contexts=((20, 4),))
    tree = _params(cfg, seed)
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0   # stream 1 ends mid-chunk
    return (cfg, tree,
            rng.normal(0, 1, (B, T, 4 * W)).astype(np.float32),
            rng.integers(0, V, (B, T)).astype(np.int32), mask,
            rng.normal(0, 0.5, (D, B, W)).astype(np.float32),
            rng.normal(0, 0.5, (D, B, W)).astype(np.float32))


def _jax_packed(cfg, tree):
    jparams = {'char_embedding': jnp.asarray(tree['char_embedding']),
               'lstm': [{k: jnp.asarray(v) for k, v in lp.items()}
                        for lp in tree['lstm']]}
    return jsk.pack_score_weights(jparams, cfg)


@pytest.mark.parametrize('D', [1, 2, 3])
def test_pack_score_weights_matches_jax(D):
    cfg, tree = _inputs(D, D)[:2]
    want = _jax_packed(cfg, tree)
    got = tsk.pack_score_weights(params_from_numpy(tree, 'cpu'),
                                 TCfg(width=W, depth=D, voc_size=V,
                                      contexts=((20, 4),)))
    assert got[-1] == want[-1] == V
    for g, w in zip(got[:-1], want[:-1]):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('D', [1, 2, 3])
def test_score_scan_ref_matches_pallas(D):
    cfg, tree, xp1, y, mask, h0, c0 = _inputs(D, 10 + D)
    packed = _jax_packed(cfg, tree)
    probs_w, nll_w, (h_w, c_w) = jsk.score_scan_pallas(
        *map(jnp.asarray, (xp1, y, mask, h0, c0)), *packed[:-1], packed[-1])
    tpacked = [torch.from_numpy(np.array(a)) for a in packed[:-1]]
    probs, nll, (h, c) = tsk.score_scan_ref(
        *map(torch.from_numpy, (xp1, y, mask, h0, c0)), *tpacked,
        packed[-1])
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_w),
                               atol=1e-5)
    assert (probs.numpy()[mask == 0] == 0).all()
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_w), rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_w), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_w), atol=1e-5)


def test_score_scan_on_cpu_runs_the_plain_version():
    """For CPU tensors the wrapper returns the plain version's values
    and launches nothing; T=0 hands the carry back unchanged."""
    cfg, tree, xp1, y, mask, h0, c0 = _inputs(2, 5)
    packed = tsk.pack_score_weights(params_from_numpy(tree, 'cpu'),
                                    TCfg(width=W, depth=2, voc_size=V))
    args = [torch.from_numpy(a) for a in (xp1, y, mask, h0, c0)]
    before = tsk.score_scan.launches
    got = tsk.score_scan(*args, *packed)
    want = tsk.score_scan_ref(*args, *packed)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    assert tsk.score_scan.launches == before
    probs, nll, (h, c) = tsk.score_scan(args[0][:, :0], args[1][:, :0],
                                        args[2][:, :0], *args[3:],
                                        *packed)
    assert probs.shape == (B, 0) and (nll == 0).all()
    torch.testing.assert_close(h, args[3])
