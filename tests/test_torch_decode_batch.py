"""Parity of the port's plain batched decode (``decode_lattice_batch_ref``,
what ``decode_lattice_batch`` runs for CPU tensors) with the JAX Pallas
kernel ``decode_lattice_pallas_batch`` in interpret mode, and of
``walk_records_batch_ref`` with JAX's ``walk_records_batch``, at D=2,
W=16, V_pad=128, K in {8, 16, 32} (32: ``beam_width`` 17-32).

Each case chains two launches (state and cost carried, each side its
own carry): a full block and one with pad edges (n_real < E).  The
documents differ in length (a shorter one ends in free pad edges), the
lattices mix invalid alternatives and merged multi-char runs, the
per-edge char steps are the maximum over the documents, and the first
edges leave most beam slots dead (only slot 0 of each document starts
alive).  Tolerances, per document: stateF within atol 1e-5, costs
within rtol 1e-5 / atol 1e-4, backpointers and alternatives equal on
every edge (ranks whose costs lie within 1e-3 of each other may swap;
see ``chip_smoke.compare_decode``).  The walk is exact."""
import numpy as np
import pytest
import torch

from chip_smoke import batch_doc, batch_lattice, compare_decode
from ocrd_keraslm_tpu.ops.decode_kernel import (decode_lattice_pallas_batch,
                                                walk_records_batch)
from ocrd_keraslm_torch.ops import decode_kernel as dk

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

D, W, VP, V_REAL, A, E = 2, 16, 128, 30, 4, 16
S = (2 * D + 1) * W


def _weights(rng):
    emb = np.zeros((VP, W), np.float32)
    emb[:V_REAL] = rng.normal(0, 1, (V_REAL, W))
    wcat = rng.normal(0, 0.3, (D, 2 * W, 4 * W)).astype(np.float32)
    bias = rng.normal(0, 0.1, (D, 1, 4 * W)).astype(np.float32)
    return emb, emb.T.copy(), wcat, bias


def fresh_beam(emb, N, K):
    state0 = np.zeros((N * K, S), np.float32)
    state0[:, :W] = emb[3]
    cost0 = np.full((N * K, 1), dk.BIG, np.float32)
    cost0[::K] = 0.0
    return state0, cost0


@pytest.mark.parametrize('L', [1, 4])
@pytest.mark.parametrize('K', [8, 16, 32])
@pytest.mark.parametrize('N', [2, 3])
def test_batch_ref_matches_pallas(N, K, L):
    rng = np.random.default_rng(100 * N + 10 * K + L)
    weights = _weights(rng)
    lw = 0.7
    state0, cost0 = fresh_beam(weights[0], N, K)
    j_carry = (state0, cost0)
    t_carry = (torch.from_numpy(state0), torch.from_numpy(cost0))
    T = torch.from_numpy
    j_recs, t_recs = [], []
    for n_real in (E, 11):
        n_reals = [n_real] + [int(rng.integers(3, n_real + 1))
                              for _ in range(N - 1)]
        chars, mask, conf, valid, steps = batch_lattice(
            rng, N, n_reals, E, A, L, V_REAL)
        want = decode_lattice_pallas_batch(
            *weights, chars, mask, conf, valid, *j_carry, n_docs=N,
            n_edges=E, n_alts=A, alt_len=L, beam=K, depth=D, width=W,
            v_pad=VP, v_real=V_REAL, lm_weight=lw, alt_steps=steps,
            n_real=np.int32(n_real))
        want = [np.asarray(x) for x in want]
        want[0] = want[0][:, 0:3, :N * K]
        got = dk.decode_lattice_batch(
            *map(T, weights), T(chars), T(mask), T(conf), T(valid),
            *t_carry, n_docs=N, lm_weight=lw, v_real=V_REAL,
            alt_steps=T(steps), n_real=n_real)
        got = [x.numpy() for x in got]
        assert got[0].shape == (E, 3, N * K)
        for n in range(N):
            err, n_cmp, diverged = compare_decode(
                batch_doc(*got, n, K), batch_doc(*want, n, K), K, W,
                c_rtol=0.0)
            assert diverged is None and n_cmp == E, (n, diverged)
        j_carry, j_recs = (want[1], want[2]), j_recs + [want[0]]
        t_carry, t_recs = (T(got[1]), T(got[2])), t_recs + [T(got[0])]
    # the walk: the later block first from slot 0, the earlier from the
    # slots the later one reached
    j_k = np.zeros((N,), np.int32)
    t_k = torch.zeros((N,), dtype=torch.int32)
    for j_rec, t_rec in zip(reversed(j_recs), reversed(t_recs)):
        full = np.zeros((E, 8, 128), np.float32)
        full[:, 0:3, :N * K] = j_rec
        j_k, j_walk = walk_records_batch(full, j_k, n_docs=N, beam=K)
        t_k, t_walk = dk.walk_records_batch(t_rec, t_k, n_docs=N, beam=K)
        assert t_k.dtype == torch.int32 and t_walk.shape == (N, E, 2)
        np.testing.assert_array_equal(t_walk[..., 0].numpy(),
                                      np.asarray(j_walk)[..., 0])
        np.testing.assert_allclose(t_walk[..., 1].numpy(),
                                   np.asarray(j_walk)[..., 1], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(t_k.numpy(), np.asarray(j_k))


@pytest.mark.parametrize('K', [8, 16])
def test_walk_ref_matches_jax_exactly(K):
    """The walk alone, on the same records in both packages, with
    chained start slots: equal bit for bit."""
    rng = np.random.default_rng(K)
    N, E_w = 3, 40
    records = np.zeros((E_w, 8, 128), np.float32)
    records[:, 0, :N * K] = rng.integers(0, K, (E_w, N * K))
    records[:, 1, :N * K] = rng.integers(0, A, (E_w, N * K))
    records[:, 2, :N * K] = rng.normal(0, 10, (E_w, N * K))
    j_k = np.array([0, K - 1, 3], np.int32)
    t_k = torch.from_numpy(j_k.copy())
    for lo, hi in ((20, 40), (0, 20)):
        j_k, j_walk = walk_records_batch(records[lo:hi], j_k, n_docs=N,
                                         beam=K)
        t_k, t_walk = dk.walk_records_batch(
            torch.from_numpy(records[lo:hi, 0:3, :N * K].copy()), t_k,
            n_docs=N, beam=K)
        np.testing.assert_array_equal(t_walk.numpy(), np.asarray(j_walk))
        np.testing.assert_array_equal(t_k.numpy(), np.asarray(j_k))


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers run the plain versions and count no
    launch; inputs on two devices, and documents that do not divide the
    rows, are refused."""
    rng = np.random.default_rng(5)
    weights = [torch.from_numpy(w) for w in _weights(rng)]
    arrays = [torch.from_numpy(a)
              for a in batch_lattice(rng, 2, [4, 3], E, A, 1, V_REAL)]
    state0, cost0 = map(torch.from_numpy,
                        fresh_beam(weights[0].numpy(), 2, 8))
    calls = []
    real_ref = dk.decode_lattice_batch_ref
    monkeypatch.setattr(dk, 'decode_lattice_batch_ref',
                        lambda *a, **k: calls.append(1) or real_ref(*a, **k))
    before = (dk.decode_lattice_batch.launches,
              dk.walk_records_batch.launches)
    rec, _, _ = dk.decode_lattice_batch(
        *weights, *arrays[:4], state0, cost0, n_docs=2, lm_weight=0.5,
        v_real=V_REAL, alt_steps=arrays[4], n_real=4)
    dk.walk_records_batch(rec, torch.zeros(2, dtype=torch.int32), n_docs=2,
                          beam=8)
    assert calls == [1]
    assert (dk.decode_lattice_batch.launches,
            dk.walk_records_batch.launches) == before
    with pytest.raises(ValueError, match='span devices'):
        dk.decode_lattice_batch(*weights, *arrays[:4], state0,
                                cost0.to('meta'), n_docs=2, lm_weight=0.5,
                                v_real=V_REAL)
    with pytest.raises(ValueError, match='do not divide'):
        dk.decode_lattice_batch(*weights, *arrays[:4], state0, cost0,
                                n_docs=3, lm_weight=0.5, v_real=V_REAL)
