"""On-device beam search: generation and lattice decoding.

Counterpart of ``ocrd_keraslm_tpu/ops/beam_device.py``.  Two engines
serve each search:

* the kernels: generation runs its prefix steps as replays of one
  captured CUDA graph of a step (plain PyTorch steps on the CPU), then
  one :func:`gen_kernel.gen_beam` launch for the whole search and one
  :func:`gen_kernel.traceback` launch that walks the chosen end slots
  back (the JAX package's fused TPU kernel); lattice decoding launches
  :func:`decode_kernel.decode_lattice` from ``Rater``;
* the unbounded engines, the counterparts of the JAX package's XLA
  scans: :func:`generate_device` / :func:`generate_device_best` and
  :func:`decode_lattice_device`, plain PyTorch on the rater's device
  (products, index gathers and stable sorts, a few dozen small launches
  per beam step).  They take every shape: any beam width, alternatives
  of any length, models no kernel layout takes (``Rater.fused_decode``,
  ``Rater.fused_generate``).

Semantics are the reference's (generation: per-hypothesis top-10
candidates, absolute probability threshold 0.004, fringe capped at 256,
cumulative-cost ordering; decoding: the per-char cost ``lm_weight *
-log2 p_LM + (1 - lm_weight) * -log2 conf`` and an exact top K per
edge).  Selections are stable sorts, so equal costs order by the lower
index, as ``lax.top_k`` orders them, on the CPU and on the card alike.

Each request is split in two: ``*_begin`` queues the device work and
starts a copy of the result into pinned host memory without waiting;
``*_finish`` waits for that copy and builds the strings.  A serving loop
can so queue the next prompt before it finishes the last.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import List

import numpy as np
import torch

from . import _build
from ..models.lstm_lm import forward_step, host_to_device
from ..utils.buckets import bucket_unbounded
from ..utils.devtrace import span
from .gen_kernel import (BIG, gen_layouts, generate_best, generate_variants,
                         log_threshold)

NEG_INF = BIG
# prompt lengths and generated lengths round up to these, so that the
# fetched arrays take few shapes; surplus steps are computed and dropped
PREFIX_BUCKETS = (64, 256, 1024, 4096)
LENGTH_BUCKETS = (16, 64, 256, 1024, 4096)
FRINGE = 256
TOPK = 10


def _gen_weights(rater, context):
    """Device-resident generation weight set (shared with lattice
    decoding through ``Rater._decode_weights``): vocab-padded embedding
    and its transpose, fused per-layer ``[input; recurrent]`` kernels,
    biases with the context embedding folded into layer 0, and the real
    vocabulary size.  Always f32: generation ignores the bf16 decode
    mode, as the JAX package's does."""
    wts = rater._decode_weights(context, bf16=False)
    return (wts['emb'], wts['embT'], wts['wcat'], wts['bias'],
            wts['v_real'])


def _gen_stack(wcat, bias, inp, state):
    """One LSTM stack step of the input rows ``inp`` (N, W) over the
    packed rows ``state`` ``[.. | h_0.. | c_0..]`` (its first W columns
    are not read): returns (new ``[h.. | c..]`` rows, the top layer's
    h)."""
    W = inp.shape[1]
    D = wcat.shape[0]
    new_h, new_c = [], []
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
    return torch.cat(new_h + new_c, 1), inp


def _gen_layers(emb, embT, wcat, bias, v_real, state):
    """One LSTM stack step over packed rows ``[xemb | h_0.. | c_0..]``:
    returns (new ``[h.. | c..]`` rows, logits with the vocabulary's
    padding columns at ``-NEG_INF``)."""
    hs, top = _gen_stack(wcat, bias, state[:, :emb.shape[1]], state)
    logits = top @ embT
    col = torch.arange(logits.shape[1], device=logits.device)
    logits = torch.where(col[None, :] < v_real, logits, -NEG_INF)
    return hs, logits


def _prompt_steps(prefix_mask) -> int:
    """The batch-N steps of a prompt: its longest stream's masked
    positions."""
    return int(prefix_mask.sum(axis=1).max()) if prefix_mask.size else 0


def _last_chars(prefix, prefix_mask):
    """(N,) int64: each stream's last prompt char (the first beam
    input), read on the host."""
    n_prefix = prefix_mask.sum(axis=1).astype(np.int64)
    return prefix[np.arange(prefix.shape[0]), n_prefix].astype(np.int64)


def _prefix_state(emb, wcat, bias, prefix, prefix_mask):
    """The (N, S) packed root states ``[xemb(last prefix char) | h.. |
    c..]`` of N streams.  prefix: (N, P) int32 ids, 0-padded right;
    prefix_mask: (N, P) float32, 1 over each stream's prefix[:-1] (numpy
    both).  Each masked position is one batch-N step of the LSTM stack;
    a stream whose prefix has ended keeps its state (the last prefix
    char becomes the first beam input, as in the host engine).  On a
    CUDA device the steps are replays of one captured step
    (:class:`_PromptSteps`), else plain PyTorch steps
    (:func:`_prefix_eager`); both give the same bits."""
    with span('gen.prompt'):
        if emb.device.type == 'cuda':
            return _prefix_graph(emb, wcat, bias, prefix, prefix_mask)
        return _prefix_eager(emb, wcat, bias, prefix, prefix_mask)


_prefix_state.captures = 0
_prefix_state.replays = 0


def _prefix_eager(emb, wcat, bias, prefix, prefix_mask):
    """:func:`_prefix_state` as plain PyTorch steps."""
    device = emb.device
    W = emb.shape[1]
    D = wcat.shape[0]
    N = prefix.shape[0]
    ids = host_to_device(torch.from_numpy(
        np.ascontiguousarray(prefix, np.int64)), device)
    mask = host_to_device(torch.from_numpy(
        np.ascontiguousarray(prefix_mask, np.float32)), device)
    state = torch.zeros((N, (2 * D + 1) * W), dtype=torch.float32,
                        device=device)
    for t in range(_prompt_steps(prefix_mask)):
        xemb = emb[ids[:, t]]
        hs, _ = _gen_stack(wcat, bias, xemb, state)
        state = torch.where(mask[:, t, None] > 0,
                            torch.cat([xemb, hs], 1), state)
    last = host_to_device(torch.from_numpy(
        _last_chars(prefix, prefix_mask)), device)
    return torch.cat([emb[last], state[:, W:]], 1)


class _PromptSteps:
    """The prompt steps of N streams over static buffers, for one step
    captured as a CUDA graph and replayed once per step.

    ``staged`` (int64) holds ``[t | each stream's last prompt char (N) |
    each step's ids and mask (capacity, 2, N)]``, copied in once per
    request from pinned memory; ``state`` the packed ``[xemb | h.. |
    c..]`` rows.  A step reads its ids and mask at the device's ``t``,
    takes the products and elementwise ops of :func:`_prefix_eager` in
    its order (so the same bits), keeps the state of the streams whose
    prompt has ended and advances ``t``: per step the host issues one
    replay and nothing else."""

    def __init__(self, emb, wcat, n: int, capacity: int):
        self.n, self.capacity = n, capacity
        self.staged = torch.zeros((1 + n + 2 * n * capacity,),
                                  dtype=torch.int64, device=emb.device)
        self.t = self.staged[:1]
        self.last = self.staged[1:1 + n]
        self.by_step = self.staged[1 + n:].view(capacity, 2, n)
        self.state = torch.zeros(
            (n, (2 * wcat.shape[0] + 1) * emb.shape[1]),
            dtype=torch.float32, device=emb.device)
        self.graph = None
        self.weights = ()

    def step(self, emb, wcat, bias):
        ids, mask = self.by_step.index_select(0, self.t)[0]
        xemb = emb[ids]
        hs, _ = _gen_stack(wcat, bias, xemb, self.state)
        torch.where(mask[:, None] > 0, torch.cat([xemb, hs], 1),
                    self.state, out=self.state)
        self.t.add_(1)

    def capture(self, emb, wcat, bias):
        """Capture one :meth:`step` (raises where CUDA refuses it).  The
        graph reads the weights where they lie: it is replayed only
        while :meth:`holds` them."""
        device = self.state.device
        side = _CAPTURE_STREAMS.get(device)
        if side is None:
            side = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        with torch.cuda.device(device):
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                # the kernels loaded, cuBLAS set up on the capture stream
                self.step(emb, wcat, bias)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                self.step(emb, wcat, bias)
            torch.cuda.current_stream().wait_stream(side)
        self.graph = graph
        self.weights = tuple(weakref.ref(w) for w in (emb, wcat, bias))

    def holds(self, emb, wcat, bias) -> bool:
        return all(r() is w for r, w in zip(self.weights,
                                            (emb, wcat, bias)))

    def alive(self) -> bool:
        return all(r() is not None for r in self.weights)

    def stage(self, prefix, prefix_mask, steps: int):
        """A request's ids, masks and last chars into ``staged`` (one
        copy, from pinned memory on the card), ``t`` and the state
        zeroed."""
        n = self.n
        host = torch.empty((1 + n + 2 * n * steps,), dtype=torch.int64,
                           pin_memory=self.staged.is_cuda)
        h = host.numpy()
        h[0] = 0
        h[1:1 + n] = _last_chars(prefix, prefix_mask)
        by_step = h[1 + n:].reshape(steps, 2, n)
        by_step[:, 0] = prefix[:, :steps].T
        by_step[:, 1] = prefix_mask[:, :steps].T > 0
        self.staged[:host.shape[0]].copy_(host, non_blocking=True)
        self.state.zero_()

    def root(self, emb):
        return torch.cat([emb[self.last], self.state[:, emb.shape[1]:]], 1)


# captured prompt steps by (weight tensors, stream count): at most
# PROMPT_GRAPHS, the least recently used out first; the lock keeps one
# request at a time on a graph and its buffers
PROMPT_GRAPHS = 8
_PROMPT_GRAPHS: 'OrderedDict[tuple, _PromptSteps]' = OrderedDict()
_PROMPT_LOCK = threading.Lock()
# the stream every capture on a device takes: cuBLAS keeps a workspace
# (32 MiB on Hopper) for each stream it has run on
_CAPTURE_STREAMS = {}


def _prompt_graph(emb, wcat, bias, n: int, steps: int) -> _PromptSteps:
    """The captured step of ``n`` streams over these weights that takes
    ``steps`` steps; captures one where none is kept (a new weight set
    or stream count, a longer prompt).  Under ``_PROMPT_LOCK``."""
    key = (id(emb), id(wcat), id(bias), n)
    run = _PROMPT_GRAPHS.get(key)
    if run is not None and run.holds(emb, wcat, bias) \
            and steps <= run.capacity:
        _PROMPT_GRAPHS.move_to_end(key)
        return run
    run = _PromptSteps(emb, wcat, n, bucket_unbounded(steps, PREFIX_BUCKETS))
    run.capture(emb, wcat, bias)
    _build.count(_prefix_state, 'captures')
    for k in [k for k, r in _PROMPT_GRAPHS.items()
              if k == key or not r.alive()]:
        _drop_prompt_graph(k)
    while len(_PROMPT_GRAPHS) >= PROMPT_GRAPHS:
        _drop_prompt_graph(next(iter(_PROMPT_GRAPHS)))
    _PROMPT_GRAPHS[key] = run
    return run


def _drop_prompt_graph(key):
    # no replay of a graph may be pending when it is destroyed
    torch.cuda.synchronize(_PROMPT_GRAPHS.pop(key).state.device)


def _prefix_graph(emb, wcat, bias, prefix, prefix_mask):
    """:func:`_prefix_state` on the card: the request staged into the
    captured step's buffers, one replay per step, the root rows."""
    steps = _prompt_steps(prefix_mask)
    with _PROMPT_LOCK:
        run = _prompt_graph(emb, wcat, bias, prefix.shape[0], steps)
        run.stage(prefix, prefix_mask, steps)
        for _ in range(steps):
            run.graph.replay()
        _build.count(_prefix_state, 'replays', steps)
        return run.root(emb)


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
    """The host copy of :func:`_copy_to_host`, once its event completed:
    where decode and generation wait for the card's results."""
    if event is not None:
        with span('fetch'):
            event.synchronize()
    return host.numpy()


def _decode(rater, ids) -> str:
    return ''.join(rater.vocab.i2c.get(int(i), '') for i in ids)


# ----------------------------------------------------------------------
# the generation engine
# ----------------------------------------------------------------------

def use_gen_kernel(rater, weights) -> bool:
    """Whether generation takes the beam-step kernel (``gen_beam``) or
    the engine (:func:`generate_device`): ``rater.fused_generate`` True
    (the default) takes the kernel where a layout of ``gen_beam`` takes
    the model (:func:`gen_kernel.gen_layouts`, a rule of shapes alone, so
    the CPU and the card choose alike), ``'force'`` always, False never
    (the JAX package's ``_use_fused_gen``)."""
    mode = getattr(rater, 'fused_generate', True)
    if mode == 'force':
        return True
    if not mode:
        return False
    emb, _, wcat, _, v_real = weights
    return bool(gen_layouts(FRINGE, wcat.shape[0], emb.shape[1],
                            emb.shape[0], TOPK, int(v_real)))


def generate_device(emb, embT, wcat, bias, prefix, prefix_mask,
                    length: int, v_real: int, topk: int = TOPK,
                    fringe: int = FRINGE, threshold: float = 0.004):
    """The beam search of N streams as plain PyTorch steps on the
    weights' device (the JAX package's ``generate_device``, with a
    leading stream axis).

    prefix, prefix_mask: (N, P) numpy (see :func:`_prefix_state`).  Per
    step: the LSTM stack over the K fringe rows, each row's ``topk``
    largest log-probabilities (a stable descending sort: ties to the
    smaller char id), candidates ``cost - logp`` (nats), dead below the
    probability threshold, for the unmapped char 0 and under a dead
    parent, then the K cheapest of the K*topk in cost order (a stable
    sort: ties to the smaller flat index); the next rows are gathered by
    index.  Returns (chars, backptrs, costs), each (N, length, K)."""
    root = _prefix_state(emb, wcat, bias, prefix, prefix_mask)
    N, S = root.shape
    K = fringe
    topk = min(int(topk), int(v_real))
    device = root.device
    state = root[:, None, :].expand(N, K, S).reshape(N * K, S)
    cost = torch.full((N * K,), NEG_INF, dtype=torch.float32, device=device)
    cost[::K] = 0.0
    log_thresh = log_threshold(threshold)
    base = (torch.arange(N, device=device) * K)[:, None]
    chars, backs, costs = [], [], []
    for _ in range(length):
        hs, logits = _gen_layers(emb, embT, wcat, bias, v_real, state)
        logp = logits - torch.logsumexp(logits, dim=1, keepdim=True)
        top = torch.sort(logp, dim=1, descending=True, stable=True)
        l_top, idx_top = top.values[:, :topk], top.indices[:, :topk]
        cand = cost[:, None] - l_top
        cand = torch.where(l_top < log_thresh, NEG_INF, cand)
        cand = torch.where(idx_top == 0, NEG_INF, cand)
        cand = torch.where(cost[:, None] >= NEG_INF / 2, NEG_INF, cand)
        sel = torch.sort(cand.reshape(N, K * topk), dim=1, stable=True)
        new_cost, flat = sel.values[:, :K], sel.indices[:, :K]
        backptr = torch.div(flat, topk, rounding_mode='floor')
        new_char = idx_top.reshape(N, K * topk).gather(1, flat)
        state = torch.cat([emb[new_char.reshape(-1)],
                           hs[(backptr + base).reshape(-1)]], 1)
        cost = new_cost.reshape(-1)
        chars.append(new_char)
        backs.append(backptr)
        costs.append(new_cost)
    generate_device.steps += length
    return (torch.stack(chars, 1), torch.stack(backs, 1),
            torch.stack(costs, 1))


generate_device.steps = 0


def _walk_back(chars, backs, slots, out_length: int):
    """Char ids (N, V, length) of the paths that end in ``slots`` (N, V)
    at step ``out_length - 1``, walked back through the backpointers by
    index gathers on the device; 0 at steps >= out_length."""
    N, T, _ = chars.shape
    k = slots
    ks = []
    for t in range(out_length - 1, -1, -1):
        ks.append(k)
        k = backs[:, t].gather(1, k)
    ks = torch.stack(ks[::-1], 1)                   # (N, out_length, V)
    out = torch.zeros((N, slots.shape[1], T), dtype=chars.dtype,
                      device=chars.device)
    out[:, :, :out_length] = chars[:, :out_length].gather(2, ks) \
        .permute(0, 2, 1)
    return out


def generate_device_best(emb, embT, wcat, bias, prefix, prefix_mask,
                         length: int, out_length: int, v_real: int,
                         topk: int = TOPK, fringe: int = FRINGE,
                         threshold: float = 0.004):
    """:func:`generate_device` and the walk of each stream's cheapest
    slot at step ``out_length - 1`` (the first at equal cost) on the
    device.  Returns (seqs (N, length), valid in [0, out_length); costs
    (N,))."""
    chars, backs, costs = generate_device(
        emb, embT, wcat, bias, prefix, prefix_mask, length, v_real, topk,
        fringe, threshold)
    costs_out = costs[:, out_length - 1]
    best = torch.argmin(costs_out, dim=1, keepdim=True)
    seqs = _walk_back(chars, backs, best, out_length)[:, 0]
    return seqs, costs_out.gather(1, best)[:, 0]


# ----------------------------------------------------------------------
# generation requests
# ----------------------------------------------------------------------

def generate_beam_begin(rater, prefix: str, length: int, context=None,
                        variants: int = 1):
    """Queue the beam search after ``prefix`` (``length`` >= 1 chars,
    the ``variants`` best, at most the fringe of 256) and start the
    fetch of its result; :func:`generate_beam_finish` builds the
    strings.  The kernels (:func:`use_gen_kernel`) walk the variants on
    the device; the engine walks one variant on the device
    (``'gen-best'``) and fetches all records for several
    (``'gen-walk'``)."""
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
    weights = _gen_weights(rater, context)
    emb, embT, wcat, bias, v_real = weights
    run_length = bucket_unbounded(length, LENGTH_BUCKETS)
    if use_gen_kernel(rater, weights):
        seqs, vcosts = generate_variants(
            emb, embT, wcat, bias, prefix_ids, prefix_mask, run_length,
            length, int(v_real), nv, fringe=FRINGE)
        # ids are exact in float32: ONE packed (variants, bucket + 1)
        # fetch
        packed = torch.cat([seqs[0].float(), vcosts[0][:, None]], 1)
        return ('gen-fusedv',) + _copy_to_host(packed) + (nv, meta)
    if nv == 1:
        seqs, costs = generate_device_best(
            emb, embT, wcat, bias, prefix_ids, prefix_mask, run_length,
            length, int(v_real))
        packed = torch.cat([seqs[0].float(), costs])
        return ('gen-best',) + _copy_to_host(packed) + (meta,)
    chars, backs, costs = generate_device(
        emb, embT, wcat, bias, prefix_ids, prefix_mask, run_length,
        int(v_real))
    packed = torch.stack([chars[0].float(), backs[0].float(), costs[0]])
    return ('gen-walk',) + _copy_to_host(packed) + (meta,)


def generate_beam_finish(pending) -> List[str]:
    """Wait for a :func:`generate_beam_begin` result and build its
    strings (dead end slots, cost >= 1e38, are skipped)."""
    kind = pending[0]
    rater, prefix, length, variants, _ctx = pending[-1]
    if kind == 'gen-empty':
        return []
    packed = _fetch(pending[1], pending[2])
    with span('gen.strings'):
        if kind == 'gen-fusedv':
            # seqs span the whole bucket; positions >= length are not
            # walked
            return [prefix[-1:] + _decode(rater, packed[v, :length])
                    for v in range(pending[3]) if packed[v, -1] < 1e38]
        if kind == 'gen-best':
            if packed[-1] >= 1e38:
                return []
            return [prefix[-1:] + _decode(rater, packed[:length])]
        chars = packed[0].astype(np.int64)          # (run_length, K)
        backs = packed[1].astype(np.int64)
        final = packed[2][length - 1]
        # stable: equal costs order by slot, as the kernels' variants do
        results = []
        for k in np.argsort(final, kind='stable')[:variants]:
            if final[k] >= 1e38:
                continue
            seq = []
            idx = int(k)
            for t in range(length - 1, -1, -1):
                seq.append(int(chars[t, idx]))
                idx = int(backs[t, idx])
            results.append(prefix[-1:] + _decode(rater, seq[::-1]))
        return results


def generate_beam(rater, prefix: str, length: int, context=None,
                  variants: int = 1) -> List[str]:
    """Generation after one prefix (= begin + finish)."""
    return generate_beam_finish(generate_beam_begin(
        rater, prefix, length, context, variants))


def generate_streams_begin(rater, prefixes: List[str], length: int,
                           context=None):
    """Queue the best continuation of each of S prefixes, all in one
    search with a leading stream axis (the card's counterpart of the
    JAX package's vmapped stream engine): ONE :func:`gen_kernel.gen_beam`
    launch (one block cluster per stream), or where the kernel does not
    take the model the engine (:func:`generate_device_best`); then start
    the fetch.  :func:`generate_streams_finish` builds the strings.  Each
    stream returns what ``generate(prefix, length)`` returns.  With
    ``rater.mesh`` set, the streams are split over the mesh's ``data``
    axis (``parallel/generate.py``; collective: every rank of the mesh
    calls it with the same prompts)."""
    mesh = getattr(rater, 'mesh', None)
    if not context:
        context = rater.underspecify_contexts()
    length = int(length)
    meta = (rater, prefixes, length, context)
    if not prefixes:
        return ('gen-streams-empty', meta)
    if length < 1:
        raise ValueError('generate needs a length >= 1, got %d' % length)
    enc = [rater.vocab.encode(p) for p in prefixes]
    weights = _gen_weights(rater, context)
    emb, embT, wcat, bias, v_real = weights
    best = generate_best if use_gen_kernel(rater, weights) \
        else generate_device_best
    if mesh is not None:
        from ..parallel.generate import make_stream_generate, padded_streams
        # pad rows repeat stream 0 and are dropped at the fetch
        enc = enc + [enc[0]] * (padded_streams(mesh, len(enc)) - len(enc))
        best = make_stream_generate(mesh, best)
    prefix_ids, prefix_mask = _prefix_arrays(enc)
    seqs, costs = best(
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
    """Batched generation in one search (= begin + finish)."""
    return generate_streams_finish(generate_streams_begin(
        rater, prefixes, length, context))


# ----------------------------------------------------------------------
# the lattice decode engine
# ----------------------------------------------------------------------

def decode_lattice_device(params, cfg, alt_chars, alt_mask, alt_conf_bits,
                          alt_valid, zs, h0, c0, x0, cost0, lm_weight,
                          device_walk: bool = False, steps=None):
    """Beam decode of a linear lattice as plain PyTorch steps on the
    device (the JAX package's ``decode_lattice_device``); the arrays may
    carry a leading document axis N, decoded side by side (the JAX
    package vmaps it, ``parallel/decode.py``).

    alt_chars (E, A, L) int char ids; alt_mask, alt_conf_bits (E, A, L)
    float32 (conf as -log2 bits per char); alt_valid (E, A); zs: the
    context ids, one per context variable (its first element counts);
    h0, c0 (D, K, W); x0 (K,) last consumed char ids; cost0 (K,), 3e38
    for an empty slot; ``steps``: char steps per edge (default: the
    longest alternative of the edge, read from ``alt_mask``).  Per edge
    the K beam rows expand to K*A hypotheses (row k*A + a: slot k,
    alternative a), :func:`models.lstm_lm.forward_step` runs once per
    char position (masked rows keep their state), each char costs
    ``lm_weight * -log2 max(p, 1e-99) + (1 - lm_weight) * conf_bits``,
    and the K cheapest hypotheses (a stable sort: ties to the lower
    index, as ``lax.top_k``) are the next beam, reordered by index.
    Steps after an edge's longest alternative are skipped: every row is
    masked there.

    Returns (packed, h, c, x, cost) with the leading axis where given.
    ``device_walk``: packed is (E+1, 2), the path walked back from slot 0
    (rows ``[choice, cumulative cost]``, header ``[cost0[entry slot],
    0]``); else (E+1, 3K) records ``[backptr | alt | cost]`` whose header
    holds ``min(cost0)`` and ``cost0`` in its last K columns."""
    batched = alt_chars.dim() == 4
    if not batched:
        alt_chars, alt_mask, alt_conf_bits, alt_valid, h0, c0, x0, cost0 = (
            a[None] for a in (alt_chars, alt_mask, alt_conf_bits,
                              alt_valid, h0, c0, x0, cost0))
    N, E, A, L = alt_chars.shape
    D, K, W = h0.shape[1:]
    KA = K * A
    device = h0.device
    if steps is None:
        steps = alt_mask.sum(3).amax(dim=(0, 2)).long().tolist()
    lw = float(np.float32(lm_weight))
    lw1 = float(np.float32(1.0) - np.float32(lm_weight))
    rows = torch.arange(N * KA, device=device)
    parent = torch.div(rows, A, rounding_mode='floor')
    zs_rows = [torch.full((N * KA,), int(np.asarray(z).reshape(-1)[0]),
                          dtype=torch.long, device=device) for z in zs]
    doc_base = (torch.arange(N, device=device) * KA)[:, None]
    h = h0.permute(1, 0, 2, 3).reshape(D, N * K, W)
    c = c0.permute(1, 0, 2, 3).reshape(D, N * K, W)
    x = x0.reshape(N * K).long()
    cost = cost0.reshape(N * K).float()
    alt_chars = alt_chars.long()
    bps, alts, costs = [], [], []
    for e in range(E):
        chars_e, mask_e, conf_e = (
            a[:, e, None].expand(N, K, A, L).reshape(N * KA, L)
            for a in (alt_chars, alt_mask, alt_conf_bits)) \
            if steps[e] else (None, None, None)
        valid_e = alt_valid[:, e, None].expand(N, K, A).reshape(N * KA)
        hh, cc, xx, cost_e = h[:, parent], c[:, parent], x[parent], \
            cost[parent]
        acc = torch.zeros((N * KA,), dtype=torch.float32, device=device)
        for t in range(steps[e]):
            probs, (h2, c2) = forward_step(params, cfg, xx, zs_rows,
                                           (hh, cc))
            cur, m = chars_e[:, t], mask_e[:, t]
            p = probs.gather(1, cur[:, None])[:, 0]
            acc = acc + m * (lw * -torch.log2(torch.clamp(p, min=1e-99))
                             + lw1 * conf_e[:, t])
            keep = m > 0
            hh = torch.where(keep[None, :, None], h2, hh)
            cc = torch.where(keep[None, :, None], c2, cc)
            xx = torch.where(keep, cur, xx)
        total = torch.where(valid_e > 0.5, cost_e + acc, NEG_INF)
        total = torch.where(cost_e >= NEG_INF / 2, NEG_INF, total)
        top = torch.sort(total.reshape(N, KA), dim=1, stable=True)
        sel = top.indices[:, :K]
        cost = top.values[:, :K].reshape(N * K)
        g = (sel + doc_base).reshape(N * K)
        h, c, x = hh[:, g], cc[:, g], xx[g]
        bps.append(torch.div(sel, A, rounding_mode='floor'))
        alts.append(sel % A)
        costs.append(top.values[:, :K])
    decode_lattice_device.edges += E
    decode_lattice_device.char_steps += sum(steps)
    bp, al, co = (torch.stack(v, 1) for v in (bps, alts, costs))
    cost0 = cost0.reshape(N, K).float()
    if device_walk:
        k = torch.zeros((N, 1), dtype=torch.long, device=device)
        ks = [None] * E
        for e in range(E - 1, -1, -1):
            ks[e] = k
            k = bp[:, e].gather(1, k)
        ks = torch.stack(ks, 1)                     # (N, E, 1)
        head = torch.cat([cost0.gather(1, k),
                          torch.zeros_like(cost0[:, :1])], 1)
        packed = torch.cat([head[:, None], torch.cat(
            [al.gather(2, ks).float(), co.gather(2, ks)], 2)], 1)
    else:
        head = torch.zeros((N, 1, 3 * K), dtype=torch.float32,
                           device=device)
        head[:, 0, 0] = cost0.min(dim=1).values
        head[:, 0, 2 * K:] = cost0
        packed = torch.cat([head, torch.cat([bp.float(), al.float(), co],
                                            2)], 1)
    out = (packed, h.reshape(D, N, K, W).permute(1, 0, 2, 3).contiguous(),
           c.reshape(D, N, K, W).permute(1, 0, 2, 3).contiguous(),
           x.reshape(N, K).int(), cost.reshape(N, K))
    return out if batched else tuple(a[0] for a in out)


decode_lattice_device.edges = 0
decode_lattice_device.char_steps = 0
