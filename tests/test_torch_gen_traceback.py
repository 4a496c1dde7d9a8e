"""How the traceback kernel cuts a walk into segments, and a numpy model
of what its two launches compute, against ``traceback_ref`` (what
``traceback`` runs for CPU tensors) and JAX's ``_traceback_pallas`` in
interpret mode.  No card needed.

``csrc/gen_traceback.cu`` stages each segment's backpointers as bytes,
maps each segment's entry slots to its exit slots (split into
sub-segments where K is below the block's threads), composes the maps
of the later segments from every cursor's end slot, walks each segment
again from its entry and gathers the chars.  The model below does the
same in the same order; integer outputs, so every comparison is
exact."""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ocrd_keraslm_tpu.ops import gen_kernel as jgk
from ocrd_keraslm_torch.ops import _build
from ocrd_keraslm_torch.ops import gen_kernel as gk

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)


def _records(rng, N, T, K, hot=None):
    """Seeded records (N, T, 3, K): chars in 1..69, backpointers into
    the K slots (with probability 1/2 the slot ``hot`` where given),
    ascending costs."""
    rec = np.zeros((N, T, 3, K), np.float32)
    rec[:, :, 0] = rng.integers(1, 70, (N, T, K))
    bp = rng.integers(0, K, (N, T, K))
    if hot is not None:
        bp = np.where(rng.random((N, T, K)) < 0.5, hot, bp)
    rec[:, :, 1] = bp
    rec[:, :, 2] = np.sort(rng.uniform(0, 50, (N, T, K)), axis=-1)
    return rec


def model_traceback(rec, best, out_length, lay):
    """The kernel's two launches in numpy: segment maps (sub-segments
    chained), their composition from each cursor's end slot, the walk
    of each segment from its entry, the gather; zeros from
    ``out_length``."""
    N, T, _, K = rec.shape
    VARS = best.shape[1]
    L, G, Gt = lay.L, lay.G, lay.Gt
    # a backpointer is clamped to [0, K) as a float, then truncated
    bp = np.clip(rec[:, :, 1], 0, K - 1).astype(np.int64)
    P = gk.TB_NT // K if K < gk.TB_NT else 1
    maps = np.zeros((N, G, K), np.int64)
    for g in range(G):
        lo, hi = g * L, min(g * L + L, out_length)
        Ls = -(-(hi - lo) // P)
        sub = np.zeros((N, P, K), np.int64)
        for p in range(P):
            k = np.broadcast_to(np.arange(K), (N, K)).copy()
            for t in range(min(lo + (p + 1) * Ls, hi) - 1, lo + p * Ls - 1,
                           -1):
                k = np.take_along_axis(bp[:, t], k, 1)
            sub[:, p] = k
        k = np.broadcast_to(np.arange(K), (N, K)).copy()
        for p in range(P - 1, -1, -1):
            k = np.take_along_axis(sub[:, p], k, 1)
        maps[:, g] = k
    out = np.zeros((N, VARS, T), np.int32)
    end = np.clip(best, 0, K - 1).astype(np.int64)
    for g in range(Gt):
        lo, hi = g * L, min(g * L + L, T)
        Lw = max(min(hi, out_length) - lo, 0)
        if not Lw:
            continue
        k = end.copy()
        for h in range(G - 1, g, -1):
            k = np.take_along_axis(maps[:, h], k, 1)
        for t in range(lo + Lw - 1, lo - 1, -1):
            out[:, :, t] = np.take_along_axis(rec[:, t, 0], k, 1)
            k = np.take_along_axis(bp[:, t], k, 1)
    return out


def _ref(rec, best, out_length):
    return gk.traceback_ref(torch.from_numpy(rec), torch.from_numpy(best),
                            out_length).numpy()


@pytest.mark.parametrize('N, T, K, VARS, out_length, segment', [
    (2, 64, 16, 3, 64, None),        # one segment: the walk launch alone
    (2, 64, 16, 3, 41, None),
    (1, 1024, 256, 3, 1000, None),   # the main path: generate -n 1000 -v 3
    (1, 1024, 256, 1, 1024, None),
    (16, 256, 256, 1, 256, None),    # generate_batch of 16 prompts
    (3, 4096, 256, 3, 4000, None),   # T*K bytes beyond a block's 232,448
    (1, 300, 256, 1024, 299, None),  # VARS 1024: four cursors a thread
    (2, 130, 8, 1024, 130, 16),      # K=8: 32 sub-segments a segment
    (2, 200, 24, 5, 111, 7),         # K not a power of two, odd segments
    (1, 5000, 200, 2, 4999, 64),     # more than TB_MAPS maps to compose
    (1, 16, 256, 3, 1, None),        # out_length 1
])
def test_model_matches_plain_version(N, T, K, VARS, out_length, segment):
    rng = np.random.default_rng(N * 7919 + T * 31 + K + VARS)
    rec = _records(rng, N, T, K)
    best = rng.integers(0, K, (N, VARS)).astype(np.int32)
    lay = gk.tb_layout(T, K, out_length, segment)
    want = _ref(rec, best, out_length)
    np.testing.assert_array_equal(model_traceback(rec, best, out_length,
                                                  lay), want)
    assert not want[:, :, out_length:].any()


@pytest.mark.parametrize('segment', [None, 1, 16, 64])
def test_backpointers_that_hit_slot_255(segment):
    """K=256: half the backpointers lead to slot 255, the byte's top."""
    rng = np.random.default_rng(255)
    rec = _records(rng, 2, 512, 256, hot=255)
    best = np.array([[255, 0, 17], [255, 255, 3]], np.int32)
    lay = gk.tb_layout(512, 256, 500, segment)
    np.testing.assert_array_equal(model_traceback(rec, best, 500, lay),
                                  _ref(rec, best, 500))


def test_clamping_matches_the_first_design():
    """Out-of-range end slots and backpointers (negative, fractional,
    beyond K) clamp to [0, K) before every read, as the first design's
    int clamp did: the model equals a walk that clamps the truncated
    int."""
    rng = np.random.default_rng(3)
    N, T, K = 1, 100, 16
    rec = _records(rng, N, T, K)
    rec[0, ::3, 1, :] = rng.uniform(-40, 40, (34, K)).astype(np.float32)
    best = np.array([[-5, 3, 99]], np.int32)
    want = np.zeros((N, 3, T), np.int32)
    for v in range(3):
        k = best[0, v]
        for t in range(T - 1, -1, -1):
            k = min(max(int(k), 0), K - 1)
            want[0, v, t] = int(rec[0, t, 0, k])
            k = int(rec[0, t, 1, k])   # truncation, as (int) in C
    for segment in (None, 4, 64):
        lay = gk.tb_layout(T, K, T, segment)
        np.testing.assert_array_equal(model_traceback(rec, best, T, lay),
                                      want)


def test_model_matches_the_tpu_kernel():
    """Several segments against JAX's Pallas traceback (interpret mode),
    which takes records (T, 8, K) and one stream."""
    rng = np.random.default_rng(80)
    T, K = 80, 16
    rec = _records(rng, 1, T, K)
    best = rng.choice(K, 3, replace=False).astype(np.int32)
    tpu = np.zeros((T, 8, K), np.float32)
    tpu[:, :3] = rec[0]
    for out_length in (80, 45):
        want = np.asarray(jgk._traceback_pallas(
            jnp.asarray(tpu), jnp.asarray(best), out_length))
        got = model_traceback(rec, best[None], out_length,
                              gk.tb_layout(T, K, out_length, 16))[0]
        np.testing.assert_array_equal(got[:, :out_length],
                                      want[:, :out_length])


def test_main_path_layout():
    """``generate -n 1000 -v 3``: 1024 steps, K=256, walked from step
    999 in 63 segments of 16 steps (two launches, 64 walk blocks); the
    16-prompt batch at 256 steps in 16 segments of 16 a stream; 4096
    steps in segments of 64 (fewer maps to compose a block)."""
    lay = gk.tb_layout(1024, 256, 1000)
    assert (lay.L, lay.G, lay.Gt) == (16, 63, 64)
    assert lay.maps_smem == 4 * 256 + 16 * 256
    assert lay.walk_smem == 4 * 256 * 17 + 64 * 256 + 16 * 256
    assert gk.tb_layout(256, 256, 256)[:3] == (16, 16, 16)
    assert gk.tb_layout(4096, 256, 4096)[:3] == (64, 64, 64)


@pytest.mark.parametrize('T', [1, 16, 63, 64])
def test_short_walks_take_one_launch(T):
    lay = gk.tb_layout(T, 256, T)
    assert (lay.L, lay.G, lay.Gt) == (T, 1, 1)


@pytest.mark.parametrize('K', [8, 16, 100, 256])
@pytest.mark.parametrize('T', [65, 256, 1024, 4096, 16384])
def test_segments_cover_the_walk_and_fit(K, T):
    for out_length in sorted({T, T - 1, 65}):
        lay = gk.tb_layout(T, K, out_length)
        assert gk.TB_SEG_MIN <= lay.L <= gk.TB_SEG_MAX
        assert (lay.G - 1) * lay.L < out_length <= lay.G * lay.L
        assert (lay.Gt - 1) * lay.L < T <= lay.Gt * lay.L
        assert max(lay.maps_smem, lay.walk_smem) <= gk.SMEM_MAX


@pytest.mark.parametrize('segment', [0, 65])
def test_forced_segment_out_of_range_raises(segment):
    with pytest.raises(ValueError, match='segment takes'):
        gk.tb_layout(1024, 256, 1000, segment)


def test_source_constants():
    """The host mirrors of ``csrc/gen_traceback.cu``'s constants."""
    with open(_build.source('gen_traceback.cu')) as fh:
        src = fh.read()
    consts = {k: int(v) for k, v in re.findall(r'#define (TB_\w+) (\d+)',
                                               src)}
    assert consts['TB_NT'] == gk.TB_NT
    assert consts['TB_MAPS'] == gk.TB_MAPS
    assert consts['TB_SEG_MAX'] == gk.TB_SEG_MAX
    assert consts['TB_NT'] * consts['TB_VPT'] == gk.MAX_VARIANTS


def test_cpu_wrapper_takes_the_plain_version():
    """CPU tensors: ``traceback`` returns ``traceback_ref``'s walk and
    counts no launch, whatever segment is asked."""
    rng = np.random.default_rng(5)
    rec = torch.from_numpy(_records(rng, 2, 90, 32))
    best = torch.from_numpy(rng.integers(0, 32, (2, 4)).astype(np.int32))
    gk.traceback.launches = 0
    got = gk.traceback(rec, best, 77, segment=8)
    assert torch.equal(got, gk.traceback_ref(rec, best, 77))
    assert gk.traceback.launches == 0
