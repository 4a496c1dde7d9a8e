"""Generation beam search: the beam-step and traceback CUDA kernels and
their plain PyTorch versions.

Counterpart of ``ocrd_keraslm_tpu/ops/gen_kernel.py``.
:func:`gen_beam` runs the whole character-by-character beam search of
one or more streams (prompts): per step, the D-layer LSTM over the K
fringe rows, the tied-softmax logsumexp, each row's exact top TOPK
characters, the absolute-probability threshold and the removal of the
unmapped char 0, the exact K of the K*TOPK candidates, and the
``(char, backptr, cost)`` record.  :func:`traceback` walks the records
back from chosen end slots.  Each launches its hand-written kernel
(``csrc/gen_beam.cu``, ``csrc/gen_traceback.cu``) for CUDA tensors and
runs its plain version (:func:`gen_beam_ref`, :func:`traceback_ref`) for
CPU tensors; nothing falls back.

The semantics are the TPU kernel's, not those of the JAX package's XLA
scan engine (``generate_device``):

* each row's candidates are its TOPK largest logits (the vocabulary's
  padding columns excluded), equal logits ordered by smaller char id;
* a candidate costs ``cost + max(lse - logit, 0)`` (nats) and is dead
  (``BIG``) below the probability threshold or under a dead parent;
  the char-0 candidate is removed by shifting the row's tail left, so
  every row stays ascending;
* the new fringe is the K smallest candidates by (cost, row-major
  index), in row-major order, not in cost order: slot order decides the
  order of variants at equal cost;
* the next state of slot s is ``[emb[char] | h, c of its source row]``
  (index gathers: no one-hot products are needed for exact f32 values).

Layouts: ``state0`` (N, K, S) with S = (2D+1)W and rows ``[xemb |
h_0..h_{D-1} | c_0..c_{D-1}]``, ``cost0`` (N, K); the records are
(N, T, 3, K) float32 rows ``[char | backptr | cost]`` (the TPU's
(T, 8, K) minus its five padding rows; ids are exact in float32).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from ._build import check as _check

BIG = 3.0e38   # cost of a dead slot
# the beam step kernel: a cluster of CLUSTER_WIDE or CLUSTER blocks per
# stream, each block K / blocks fringe rows; what it takes (else it
# raises)
CLUSTER, CLUSTER_WIDE = 8, 16
MAX_ROWS = 32        # fringe rows per block of an 8-block cluster
MAX_TOPK = 32        # candidates per row (one lane each)
MAX_VARIANTS = 1024  # traceback cursors (one thread each)

SOURCE = _build.source('gen_beam.cu')
TB_SOURCE = _build.source('gen_traceback.cu')


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gen_beam_launch.argtypes = [P] * 8 + [I] * 9 + [F, P]
    lib.gen_beam_launch.restype = ctypes.c_int
    lib.gen_beam_smem_bytes.argtypes = [I] * 6
    lib.gen_beam_smem_bytes.restype = ctypes.c_size_t
    lib.gen_beam_max_clusters.argtypes = [I] * 6
    lib.gen_beam_max_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _clusters_that_fit(index, blocks, K, D, W, Vp, topk) -> int:
    with torch.cuda.device(index):
        return _library().gen_beam_max_clusters(blocks, K, D, W, Vp, topk)


def cluster_blocks(index, N, K, D, W, Vp, topk) -> int:
    """Blocks a stream for N streams on CUDA device ``index``:
    ``CLUSTER_WIDE`` where the card holds N clusters of it at once (fewer
    rows a block: a shorter step) or where a ``CLUSTER``-block cluster
    does not fit at all (a wide model); else ``CLUSTER`` (its clusters
    fit the card twice as often)."""
    if K % CLUSTER_WIDE:
        return CLUSTER
    wide = _clusters_that_fit(index, CLUSTER_WIDE, K, D, W, Vp, topk)
    if wide >= N or (wide and not _clusters_that_fit(
            index, CLUSTER, K, D, W, Vp, topk)):
        return CLUSTER_WIDE
    return CLUSTER


@functools.lru_cache(maxsize=None)
def _tb_library() -> ctypes.CDLL:
    lib = _build.load(TB_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gen_traceback_launch.argtypes = [P, P, P, I, I, I, I, I, P]
    lib.gen_traceback_launch.restype = ctypes.c_int
    return lib


def log_threshold(threshold: float) -> float:
    """The log-probability threshold as the kernels compare it: the
    float32 log of the float32 threshold."""
    return float(np.float32(np.log(np.float32(threshold))))


def gen_beam(emb, embT, wcat, bias, state0, cost0, *, length: int,
             v_real: int, topk: int = 10, threshold: float = 0.004,
             final_state: bool = False):
    """``length`` beam steps of N independent streams in one launch.

    emb: (Vp, W); embT: (W, Vp); wcat: (D, 2W, 4W) fused
    ``[input-kernel; recurrent-kernel]``; bias: (D, 1, 4W) (context
    folded into layer 0); state0: (N, K, S) prefix-conditioned fringes;
    cost0: (N, K) (``BIG`` = dead).  Returns the records (N, length, 3,
    K) float32, with ``final_state`` also the fringe state after the last
    step (N, K, S) (its costs are the last records' costs)."""
    tensors = (emb, embT, wcat, bias, state0, cost0)
    device = _build.one_device('gen_beam', tensors)
    if device.type == 'cpu':
        return gen_beam_ref(emb, embT, wcat, bias, state0, cost0,
                            length=length, v_real=v_real, topk=topk,
                            threshold=threshold, final_state=final_state)
    if device.type != 'cuda':
        raise ValueError('gen_beam runs on cpu or cuda, not %s' % device)
    Vp, W = emb.shape
    D = wcat.shape[0]
    N, K, S = state0.shape
    TOPK = min(int(topk), int(v_real))
    if (S != (2 * D + 1) * W or W % 4 or K % CLUSTER
            or K // CLUSTER > MAX_ROWS or not 1 <= TOPK <= MAX_TOPK
            or v_real > Vp or Vp % 4 or length < 1 or N < 1):
        raise ValueError(
            'gen_beam kernel needs S = (2D+1)W, W %% 4 == 0, K a multiple '
            'of %d with at most %d rows a block, 1 <= min(topk, v_real) <= '
            '%d, v_real <= Vp, Vp %% 4 == 0, length >= 1 (got S=%d, D=%d, '
            'W=%d, K=%d, '
            'topk=%d, v_real=%d, Vp=%d, length=%d, N=%d)'
            % (CLUSTER, MAX_ROWS, MAX_TOPK, S, D, W, K, topk, v_real, Vp,
               length, N))
    f32 = torch.float32
    for name, t, shape in (
            ('emb', emb, (Vp, W)), ('embT', embT, (W, Vp)),
            ('wcat', wcat, (D, 2 * W, 4 * W)), ('bias', bias, (D, 1, 4 * W)),
            ('state0', state0, (N, K, S)), ('cost0', cost0, (N, K))):
        _check(name, t, shape, f32, device)
    rec = torch.empty((N, length, 3, K), dtype=f32, device=device)
    # the fringe state, double-buffered in device memory (L2-resident)
    scratch = torch.empty((2, N, K, S), dtype=f32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        blocks = cluster_blocks(torch.cuda.current_device(), N, K, D, W,
                                Vp, TOPK)
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.gen_beam_launch(
            emb.data_ptr(), embT.data_ptr(), wcat.data_ptr(),
            bias.data_ptr(), state0.data_ptr(), cost0.data_ptr(),
            rec.data_ptr(), scratch.data_ptr(), blocks, N, length, K, D,
            W, Vp, int(v_real), TOPK, log_threshold(threshold), stream)
    if status != 0:
        raise RuntimeError(
            'gen_beam kernel launch failed: CUDA error %d (%d bytes of '
            'shared memory asked a block, %d blocks a stream)'
            % (status, lib.gen_beam_smem_bytes(K, blocks, D, W, Vp, TOPK),
               blocks))
    gen_beam.launches += 1
    return (rec, scratch[(length - 1) & 1]) if final_state else rec


gen_beam.launches = 0


def traceback(rec, best, out_length: int):
    """Walk the records (N, T, 3, K) back from the slots ``best``
    (N, VARS) at step ``out_length - 1``; returns (N, VARS, T) int32
    char ids in forward order, 0 at steps >= ``out_length``.

    The TPU kernel walks its cursors in chunks sized to its scalar
    memory (``_TB_SMEM_OUT_BYTES``); on the card every cursor walks in
    one launch."""
    device = _build.one_device('traceback', (rec, best))
    if device.type == 'cpu':
        return traceback_ref(rec, best, out_length)
    if device.type != 'cuda':
        raise ValueError('traceback runs on cpu or cuda, not %s' % device)
    N, T, _, K = rec.shape
    VARS = best.shape[1] if best.dim() == 2 else 0
    if not (1 <= out_length <= T and 1 <= VARS <= MAX_VARIANTS):
        raise ValueError('traceback kernel needs 1 <= out_length <= T and '
                         '1 <= VARS <= %d (got out_length=%d, T=%d, '
                         'best %s)' % (MAX_VARIANTS, out_length, T,
                                       tuple(best.shape)))
    _check('rec', rec, (N, T, 3, K), torch.float32, device)
    _check('best', best, (N, VARS), torch.int32, device)
    out = torch.empty((N, VARS, T), dtype=torch.int32, device=device)
    lib = _tb_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.gen_traceback_launch(
            rec.data_ptr(), best.data_ptr(), out.data_ptr(), N, T, K, VARS,
            int(out_length), stream)
    if status != 0:
        raise RuntimeError('gen_traceback kernel launch failed: CUDA error '
                           '%d' % status)
    traceback.launches += 1
    return out


traceback.launches = 0


def gen_beam_ref(emb, embT, wcat, bias, state0, cost0, *, length: int,
                 v_real: int, topk: int = 10, threshold: float = 0.004,
                 final_state: bool = False):
    """Plain PyTorch version of :func:`gen_beam` (same arguments, same
    records), for CPU tensors: each row's top TOPK is a stable
    descending sort of its logits (ties to the smaller char id), the
    selection a stable ascending sort of the flat candidates cut at K
    and put back into flat-index order."""
    from .beam_device import _gen_layers
    N, K, S = state0.shape
    device = state0.device
    TOPK = min(int(topk), int(v_real))
    log_thresh = log_threshold(threshold)
    jiota = torch.arange(TOPK, device=device)
    base = (torch.arange(N, device=device) * K)[:, None]
    state = state0.reshape(N * K, S)
    cost = cost0.reshape(N * K, 1)
    recs = []
    for _ in range(length):
        hs, logits = _gen_layers(emb, embT, wcat, bias, v_real, state)
        mx = logits.max(dim=1, keepdim=True).values
        lse = mx + torch.log(torch.exp(logits - mx).sum(dim=1, keepdim=True))
        top = torch.sort(logits, dim=1, descending=True, stable=True)
        val, idx = top.values[:, :TOPK], top.indices[:, :TOPK]
        cand = cost + torch.clamp(lse - val, min=0.0)
        cand = torch.where(val - lse < log_thresh, BIG, cand)
        cand = torch.where(cost >= BIG / 2, BIG, cand)
        # the char-0 candidate leaves by a shift of the row's tail
        pos0 = torch.where(idx == 0, jiota, TOPK).min(dim=1,
                                                      keepdim=True).values
        tail = jiota >= pos0
        cand = torch.where(tail, torch.cat(
            [cand[:, 1:], torch.full_like(cand[:, :1], BIG)], 1), cand)
        idx = torch.where(tail, torch.cat(
            [idx[:, 1:], torch.zeros_like(idx[:, :1])], 1), idx)
        cand = torch.clamp(cand, max=BIG)
        flat = cand.reshape(N, K * TOPK)
        sel = torch.sort(torch.sort(flat, dim=1, stable=True).indices[:, :K],
                         dim=1).values
        row = torch.div(sel, TOPK, rounding_mode='floor')
        new_cost = flat.gather(1, sel)
        char = idx.reshape(N, K * TOPK).gather(1, sel)
        recs.append(torch.stack([char.float(), row.float(), new_cost], 1))
        state = torch.cat([emb[char.reshape(-1)],
                           hs[(row + base).reshape(-1)]], 1)
        cost = new_cost.reshape(N * K, 1)
    rec = torch.stack(recs, 1)
    return (rec, state.reshape(N, K, S)) if final_state else rec


def traceback_ref(rec, best, out_length: int):
    """Plain PyTorch version of :func:`traceback`."""
    N, T, _, K = rec.shape
    best = best.long()
    out = torch.zeros((N, best.shape[1], T), dtype=torch.int32,
                      device=rec.device)
    k = best
    for t in range(int(out_length) - 1, -1, -1):
        out[:, :, t] = rec[:, t, 0].gather(1, k).int()
        k = rec[:, t, 1].gather(1, k).long()
    return out


def _prefix_fringe(emb, embT, wcat, bias, prefix, prefix_mask, v_real,
                   fringe):
    """The initial fringes of N streams conditioned on their prefixes:
    every row holds the stream's root state, slot 0 alone is alive.
    prefix, prefix_mask: (N, P) numpy (see ``beam_device._prefix_state``).
    Returns (state0 (N, K, S), cost0 (N, K))."""
    from .beam_device import _prefix_state
    root = _prefix_state(emb, embT, wcat, bias, prefix, prefix_mask, v_real)
    N, S = root.shape
    state0 = root[:, None, :].expand(N, fringe, S).contiguous()
    cost0 = torch.full((N, fringe), BIG, dtype=torch.float32,
                       device=root.device)
    cost0[:, 0] = 0.0
    return state0, cost0


def generate_variants(emb, embT, wcat, bias, prefix, prefix_mask,
                      length: int, out_length: int, v_real: int,
                      variants: int, topk: int = 10, fringe: int = 256,
                      threshold: float = 0.004):
    """Prefix conditioning, the beam search over ``length`` steps (one
    :func:`gen_beam` launch for all N streams) and the ``variants``
    cheapest end slots at step ``out_length - 1`` walked back (one
    :func:`traceback` launch).  Slots order by ascending cost, ties by
    slot index (a stable argsort); ``variants`` must not exceed
    ``fringe`` (only that many end slots exist).  Returns (seqs (N,
    variants, length) int32, valid in [0, out_length); costs (N,
    variants))."""
    if not 1 <= variants <= fringe:
        raise ValueError('variants must lie in 1..fringe (%d), got %d'
                         % (fringe, variants))
    state0, cost0 = _prefix_fringe(emb, embT, wcat, bias, prefix,
                                   prefix_mask, v_real, fringe)
    rec = gen_beam(emb, embT, wcat, bias, state0, cost0, length=length,
                   v_real=v_real, topk=topk, threshold=threshold)
    costs_out = rec[:, out_length - 1, 2]
    order = torch.argsort(costs_out, dim=1, stable=True)[:, :variants]
    seqs = traceback(rec, order.int().contiguous(), out_length)
    return seqs, costs_out.gather(1, order)


def generate_best(emb, embT, wcat, bias, prefix, prefix_mask, length: int,
                  out_length: int, v_real: int, topk: int = 10,
                  fringe: int = 256, threshold: float = 0.004):
    """:func:`generate_variants` at one variant: (seqs (N, length),
    costs (N,)); the stable argsort takes the smallest slot at equal
    cost, as an argmin does."""
    seqs, costs = generate_variants(
        emb, embT, wcat, bias, prefix, prefix_mask, length, out_length,
        v_real, 1, topk, fringe, threshold)
    return seqs[:, 0], costs[:, 0]
