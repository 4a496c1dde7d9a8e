"""Parity of the port's plain decode (``decode_lattice_ref``, what
``decode_lattice`` runs for CPU tensors) with the JAX Pallas kernel
``decode_lattice_pallas`` in interpret mode, at D=2, W=16, V_pad=128.

Each case chains two launches (state and cost carried, each side its
own carry): a full block and one with pad edges (n_real < E).  The
lattices mix invalid alternatives and merged multi-char runs, and the
first edges leave most beam slots dead (only slot 0 starts alive).
Tolerances: stateF within atol 1e-5, costs within rtol 1e-5 / atol
1e-4, backpointers and alternatives equal on every edge (ranks whose
costs lie within 1e-3 of each other may swap; see
``chip_smoke.compare_decode``)."""
import numpy as np
import pytest
import torch

from chip_smoke import compare_decode, random_lattice
from ocrd_keraslm_tpu.ops.decode_kernel import decode_lattice_pallas
from ocrd_keraslm_torch.ops import decode_kernel as dk

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

D, W, VP, V_REAL, A, E = 2, 16, 128, 30, 4, 16


def _weights(rng):
    emb = np.zeros((VP, W), np.float32)
    emb[:V_REAL] = rng.normal(0, 1, (V_REAL, W))
    wcat = rng.normal(0, 0.3, (D, 2 * W, 4 * W)).astype(np.float32)
    bias = rng.normal(0, 0.1, (D, 1, 4 * W)).astype(np.float32)
    return emb, emb.T.copy(), wcat, bias


@pytest.mark.parametrize('walk', [True, False])
@pytest.mark.parametrize('L', [1, 4])
@pytest.mark.parametrize('K', [8, 16])
def test_ref_matches_pallas(K, L, walk):
    rng = np.random.default_rng(1000 * K + 10 * L + walk)
    weights = _weights(rng)
    lw = 0.7
    state0 = np.zeros((K, (2 * D + 1) * W), np.float32)
    state0[:, :W] = weights[0][3]
    cost0 = np.full((1, 128), dk.BIG, np.float32)
    cost0[0, 0] = 0.0
    j_state, j_cost = state0, cost0
    t_state, t_cost = torch.from_numpy(state0), torch.from_numpy(cost0)
    for n_real in (E, 11):
        chars, mask, conf, valid, steps = random_lattice(rng, E, n_real, A,
                                                         L, V_REAL)
        want = decode_lattice_pallas(
            *weights, chars, mask, conf, valid[:, :, None], j_state,
            j_cost, n_edges=E, n_alts=A, alt_len=L, beam=K, depth=D,
            width=W, v_pad=VP, v_real=V_REAL, lm_weight=lw,
            device_walk=walk, alt_steps=steps[:, None],
            n_real=np.int32(n_real))
        want = [np.asarray(x) for x in want]
        T = torch.from_numpy
        got = dk.decode_lattice(
            *map(T, weights), T(chars), T(mask), T(conf), T(valid),
            t_state, t_cost, lm_weight=lw, v_real=V_REAL,
            device_walk=walk, alt_steps=T(steps), n_real=n_real)
        err, n_cmp, diverged = compare_decode(
            [x.numpy() for x in got], want, K, W, c_rtol=0.0)
        assert diverged is None and n_cmp == E
        j_state, j_cost = want[1], want[2]
        t_state, t_cost = got[1], got[2]


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch; inputs on two devices are refused."""
    rng = np.random.default_rng(5)
    weights = [torch.from_numpy(w) for w in _weights(rng)]
    chars, mask, conf, valid, steps = [
        torch.from_numpy(a) for a in random_lattice(rng, 4, 3, A, 1,
                                                    V_REAL)]
    state0 = torch.zeros((8, (2 * D + 1) * W))
    cost0 = torch.full((1, 128), dk.BIG)
    cost0[0, 0] = 0
    calls = []
    real_ref = dk.decode_lattice_ref
    monkeypatch.setattr(dk, 'decode_lattice_ref',
                        lambda *a, **k: calls.append(1) or real_ref(*a, **k))
    before = dk.decode_lattice.launches
    dk.decode_lattice(*weights, chars, mask, conf, valid, state0, cost0,
                      lm_weight=0.5, v_real=V_REAL, alt_steps=steps)
    assert calls == [1] and dk.decode_lattice.launches == before
    with pytest.raises(ValueError, match='span devices'):
        dk.decode_lattice(*weights, chars, mask, conf, valid, state0,
                          cost0.to('meta'), lm_weight=0.5, v_real=V_REAL)
