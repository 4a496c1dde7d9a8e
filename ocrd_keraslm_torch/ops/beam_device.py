"""On-device generation: the beam search of one prompt or of many, in
one kernel launch, and the strings built from its records.

Counterpart of the generation half of
``ocrd_keraslm_tpu/ops/beam_device.py``.  Semantics are the reference's
(per-hypothesis top-10 candidates, absolute probability threshold 0.004,
fringe capped at 256, cumulative-cost ordering), as the JAX package's
fused TPU kernel computes them (see :mod:`.gen_kernel`): the prefix is
consumed step by step in plain PyTorch, then one :func:`gen_kernel.
gen_beam` launch runs the whole search and one :func:`gen_kernel.
traceback` launch walks the chosen end slots back, so the host fetches
only (variants, bucket) char ids and their costs.

Each request is split in two: ``*_begin`` queues the device work and
starts a copy of the result into pinned host memory without waiting;
``*_finish`` waits for that copy and builds the strings.  A serving loop
can so queue the next prompt before it finishes the last.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models.lstm_lm import host_to_device
from ..utils.buckets import bucket_unbounded
from .gen_kernel import BIG, generate_best, generate_variants

NEG_INF = BIG
# prompt lengths and generated lengths round up to these, so that the
# fetched arrays take few shapes; surplus steps are computed and dropped
PREFIX_BUCKETS = (64, 256, 1024, 4096)
LENGTH_BUCKETS = (16, 64, 256, 1024, 4096)
FRINGE = 256


def _gen_weights(rater, context):
    """Device-resident generation weight set (shared with lattice
    decoding through ``Rater._decode_weights``): vocab-padded embedding
    and its transpose, fused per-layer ``[input; recurrent]`` kernels,
    biases with the context embedding folded into layer 0, and the real
    vocabulary size."""
    wts = rater._decode_weights(context)
    return (wts['emb'], wts['embT'], wts['wcat'], wts['bias'],
            wts['v_real'])


def _gen_layers(emb, embT, wcat, bias, v_real, state):
    """One LSTM stack step over packed rows ``[xemb | h_0.. | c_0..]``:
    returns (new ``[h.. | c..]`` rows, logits with the vocabulary's
    padding columns at ``-NEG_INF``)."""
    W = emb.shape[1]
    D = wcat.shape[0]
    new_h, new_c = [], []
    inp = state[:, :W]
    for d in range(D):
        operand = torch.cat([inp, state[:, (1 + d) * W:(2 + d) * W]], 1)
        z = operand @ wcat[d] + bias[d]
        i = torch.sigmoid(z[:, :W])
        f = torch.sigmoid(z[:, W:2 * W])
        g = torch.tanh(z[:, 2 * W:3 * W])
        o = torch.sigmoid(z[:, 3 * W:])
        c2 = f * state[:, (1 + D + d) * W:(2 + D + d) * W] + i * g
        h2 = o * torch.tanh(c2)
        new_h.append(h2)
        new_c.append(c2)
        inp = h2
    logits = inp @ embT
    col = torch.arange(logits.shape[1], device=logits.device)
    logits = torch.where(col[None, :] < v_real, logits, -NEG_INF)
    return torch.cat(new_h + new_c, 1), logits


def _prefix_state(emb, embT, wcat, bias, prefix, prefix_mask, v_real):
    """The (N, S) packed root states ``[xemb(last prefix char) | h.. |
    c..]`` of N streams.  prefix: (N, P) int32 ids, 0-padded right;
    prefix_mask: (N, P) float32, 1 over each stream's prefix[:-1] (numpy
    both).  Each masked position is one batch-N step of the LSTM stack;
    a stream whose prefix has ended keeps its state (the last prefix
    char becomes the first beam input, as in the host engine)."""
    device = emb.device
    W = emb.shape[1]
    D = wcat.shape[0]
    N = prefix.shape[0]
    steps = int(prefix_mask.sum(axis=1).max()) if prefix_mask.size else 0
    ids = host_to_device(torch.from_numpy(
        np.ascontiguousarray(prefix, np.int64)), device)
    mask = host_to_device(torch.from_numpy(
        np.ascontiguousarray(prefix_mask, np.float32)), device)
    state = torch.zeros((N, (2 * D + 1) * W), dtype=torch.float32,
                        device=device)
    for t in range(steps):
        xemb = emb[ids[:, t]]
        hs, _ = _gen_layers(emb, embT, wcat, bias, v_real,
                            torch.cat([xemb, state[:, W:]], 1))
        state = torch.where(mask[:, t, None] > 0,
                            torch.cat([xemb, hs], 1), state)
    n_prefix = torch.from_numpy(prefix_mask.sum(axis=1).astype(np.int64))
    last = ids.gather(1, n_prefix.to(device)[:, None])[:, 0]
    return torch.cat([emb[last], state[:, W:]], 1)


def _prefix_arrays(enc):
    """(N, P) prefix ids and masks of encoded prompts, P bucketed."""
    P = bucket_unbounded(max(len(e) for e in enc), PREFIX_BUCKETS)
    prefix_ids = np.zeros((len(enc), P), np.int32)
    prefix_mask = np.zeros((len(enc), P), np.float32)
    for s, ids in enumerate(enc):
        prefix_ids[s, :len(ids)] = ids
        # consume all but the last char; the last char is the first input
        prefix_mask[s, :max(len(ids) - 1, 0)] = 1.0
    return prefix_ids, prefix_mask


def _copy_to_host(t):
    """(host tensor, event): a copy of ``t`` started into pinned memory
    without blocking, and the event to wait on before reading it (None
    for a CPU tensor, which is its own host copy)."""
    if t.device.type != 'cuda':
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def _fetch(host, event):
    if event is not None:
        event.synchronize()
    return host.numpy()


def _decode(rater, ids) -> str:
    return ''.join(rater.vocab.i2c.get(int(i), '') for i in ids)


def generate_beam_begin(rater, prefix: str, length: int, context=None,
                        variants: int = 1):
    """Queue the beam search after ``prefix`` (``length`` >= 1 chars,
    the ``variants`` best, at most the fringe of 256) and start the
    fetch of its result; :func:`generate_beam_finish` builds the
    strings."""
    if not context:
        context = rater.underspecify_contexts()
    length = int(length)
    if length < 1:
        raise ValueError('generate needs a length >= 1, got %d' % length)
    meta = (rater, prefix, length, variants, context)
    nv = min(int(variants), FRINGE)
    if nv <= 0:
        return ('gen-empty', meta)
    prefix_ids, prefix_mask = _prefix_arrays([rater.vocab.encode(prefix)])
    emb, embT, wcat, bias, v_real = _gen_weights(rater, context)
    seqs, vcosts = generate_variants(
        emb, embT, wcat, bias, prefix_ids, prefix_mask,
        bucket_unbounded(length, LENGTH_BUCKETS), length, int(v_real), nv,
        fringe=FRINGE)
    # ids are exact in float32: ONE packed (variants, bucket + 1) fetch
    packed = torch.cat([seqs[0].float(), vcosts[0][:, None]], 1)
    return ('gen-fusedv',) + _copy_to_host(packed) + (nv, meta)


def generate_beam_finish(pending) -> List[str]:
    """Wait for a :func:`generate_beam_begin` result and build its
    strings (dead end slots, cost >= 1e38, are skipped)."""
    rater, prefix, length, _variants, _ctx = pending[-1]
    if pending[0] == 'gen-empty':
        return []
    _, host, event, nv, _ = pending
    packed = _fetch(host, event)
    # seqs span the whole bucket; positions >= length are not walked
    return [prefix[-1:] + _decode(rater, packed[v, :length])
            for v in range(nv) if packed[v, -1] < 1e38]


def generate_beam(rater, prefix: str, length: int, context=None,
                  variants: int = 1) -> List[str]:
    """Generation after one prefix (= begin + finish)."""
    return generate_beam_finish(generate_beam_begin(
        rater, prefix, length, context, variants))


def generate_streams_begin(rater, prefixes: List[str], length: int,
                           context=None):
    """Queue the best continuation of each of S prefixes, all in ONE
    :func:`gen_kernel.gen_beam` launch (one block cluster per stream, the
    card's counterpart of the JAX package's vmapped stream engine), and
    start the fetch; :func:`generate_streams_finish` builds the strings.
    Each stream returns what ``generate(prefix, length)`` returns."""
    if getattr(rater, 'mesh', None) is not None:
        raise NotImplementedError(
            'generation over a device mesh is not ported yet (ROADMAP.md '
            'Queue 1 #16, "Distributed")')
    if not context:
        context = rater.underspecify_contexts()
    length = int(length)
    meta = (rater, prefixes, length, context)
    if not prefixes:
        return ('gen-streams-empty', meta)
    if length < 1:
        raise ValueError('generate needs a length >= 1, got %d' % length)
    prefix_ids, prefix_mask = _prefix_arrays(
        [rater.vocab.encode(p) for p in prefixes])
    emb, embT, wcat, bias, v_real = _gen_weights(rater, context)
    seqs, costs = generate_best(
        emb, embT, wcat, bias, prefix_ids, prefix_mask,
        bucket_unbounded(length, LENGTH_BUCKETS), length, int(v_real),
        fringe=FRINGE)
    packed = torch.cat([seqs.float(), costs[:, None]], 1)
    return ('gen-streams',) + _copy_to_host(packed) + (meta,)


def generate_streams_finish(pending) -> List[str]:
    """Wait for a :func:`generate_streams_begin` result and build one
    string per stream ('' for a dead fringe)."""
    if pending[0] == 'gen-streams-empty':
        return []
    _, host, event, (rater, prefixes, length, _ctx) = pending
    packed = _fetch(host, event)
    return ['' if packed[s, -1] >= 1e38 else
            prefixes[s][-1:] + _decode(rater, packed[s, :length])
            for s in range(len(prefixes))]


def generate_streams(rater, prefixes: List[str], length: int,
                     context=None) -> List[str]:
    """Batched generation in one launch (= begin + finish)."""
    return generate_streams_finish(generate_streams_begin(
        rater, prefixes, length, context))
