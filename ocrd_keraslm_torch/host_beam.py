"""Host beam engines: lattice decoding and generation.

Counterpart of ``ocrd_keraslm_tpu/host_beam.py``.

Lattice decoding (:func:`decode_lattice_host`, behind ``Rater.rate_best``
and ``Rater.next_path``) is the processor's engine for
``device_decoding=false`` and for pages whose lattice branches (a
customised lattice builder may return a real DAG, which the device
engines refuse).  It expands one lattice edge at a time with every
(hypothesis x alternative) pair advanced in lock-step as numpy arrays,
one batched :func:`ocrd_keraslm_torch.rater._predict_step` on the
rater's device per char position, keeps per-edge history as immutable
backpointer records and accounts costs in float64 on the host.
Cross-page continuation is the reference's one-page lookahead lock-in:
:func:`advance_traceback` emits the path up to the point where the new
best hypothesis crossed the previous page's beam, and the surviving
hypotheses condition the next page.

Generation (:func:`generate_host`): the fringe lives in flat numpy
arrays (costs, stacked states, per-step char and backpointer records);
every step is one batched ``_predict_step`` and a vectorised top-k on
the host.  ``Rater.generate`` runs it for an empty prefix, with
``device_beam`` off, and when the device search comes back empty (a
dead fringe).
"""
from __future__ import annotations

from math import log2
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class PathStep:
    """Immutable per-edge history record of a decode hypothesis:
    which ``textequiv`` was chosen for ``element``, at what cumulative
    cost (bits) after consuming it."""

    __slots__ = ('prev', 'element', 'textequiv', 'cost_after')

    def __init__(self, prev: Optional['PathStep'], element: Any,
                 textequiv: Any, cost_after: float):
        self.prev = prev
        self.element = element
        self.textequiv = textequiv
        self.cost_after = cost_after


class Hypothesis:
    """One live decode hypothesis: cumulative cost, LM state, the char
    id last consumed, and the chain of per-edge records."""

    __slots__ = ('cost', 'state', 'last_id', 'hist')

    def __init__(self, cost: float, state: Any, last_id: int,
                 hist: Optional[PathStep]):
        self.cost = cost
        self.state = state  # (h, c) each (D, W) float32, or None
        self.last_id = last_id
        self.hist = hist


def _edge_score(step: PathStep, anchor_cost: float) -> float:
    """Per-char average probability of one path step,
    2^(-bits/chars)."""
    base = step.prev.cost_after if step.prev else anchor_cost
    n = max(len(step.textequiv.Unicode), 1)
    return pow(2.0, -(step.cost_after - base) / n)


def _chain_between(rec: Optional[PathStep],
                   stop: Optional[PathStep]) -> List[PathStep]:
    """Records from ``stop`` (exclusive) through ``rec`` (inclusive),
    oldest first."""
    out: List[PathStep] = []
    while rec is not None and rec is not stop:
        out.append(rec)
        rec = rec.prev
    out.reverse()
    return out


def _descends(rec: Optional[PathStep],
              ancestor: Optional[PathStep]) -> bool:
    while rec is not None:
        if rec is ancestor:
            return True
        rec = rec.prev
    return ancestor is None


def advance_traceback(beam: Sequence[Hypothesis], traceback):
    """Lock in the path segment the whole beam agrees on.

    ``traceback`` is ``(prev_beam, prev_anchor)`` — the hypothesis set
    and emission anchor left by the previous page.  The new best
    hypothesis determines which previous-page hypothesis was right:
    everything from ``prev_anchor`` up to that crossing point is
    emitted (with per-edge average-probability scores), hypotheses not
    descending from it are dropped, and the crossing point becomes the
    next anchor.  An empty ``prev_beam`` flushes the best hypothesis
    completely (document end).

    Returns ``(path [(element, textequiv, score)], entropy_bits,
    (surviving hypotheses, new anchor))``.
    """
    prev_beam, prev_anchor = traceback
    anchor_cost = prev_anchor.cost_after if prev_anchor else 0.0
    best = min(beam, key=lambda hyp: hyp.cost)
    if prev_beam:
        crossings = {id(p.hist) for p in prev_beam}
        rec = best.hist
        while rec is not None and id(rec) not in crossings:
            rec = rec.prev
        if rec is None and id(None) not in crossings:
            raise AssertionError(
                'best hypothesis does not descend from the previous '
                'traceback')
        anchor = rec
    else:
        anchor = best.hist
    emitted = _chain_between(anchor, prev_anchor)
    path = [(step.element, step.textequiv,
             _edge_score(step, anchor_cost)) for step in emitted
            if step.textequiv is not None]
    survivors = sorted(
        (hyp for hyp in beam if _descends(hyp.hist, anchor)),
        key=lambda hyp: hyp.cost)
    new_cost = anchor.cost_after if anchor else 0.0
    return path, new_cost - anchor_cost, (survivors, anchor)


def _states_to_arrays(beam: Sequence[Hypothesis], depth: int,
                      width: int) -> Tuple[np.ndarray, np.ndarray]:
    h = np.zeros((depth, len(beam), width), np.float32)
    c = np.zeros((depth, len(beam), width), np.float32)
    for i, hyp in enumerate(beam):
        if hyp.state is not None:
            h[:, i] = hyp.state[0]
            c[:, i] = hyp.state[1]
    return h, c


def _expand_edge(rater, beam: List[Hypothesis], edge: Dict[str, Any],
                 context, lm_weight: float,
                 unmapped_seen: Dict[Any, set]) -> List[Hypothesis]:
    """Advance every (hypothesis, alternative) pair through the edge's
    full string, one batched device step per char position."""
    from .rater import STEP_BUCKETS, _predict_step
    from .utils.buckets import bucket_unbounded

    element = edge['element']
    tes = edge['alternatives']
    seqs = []
    bits = []
    for te in tes:
        ids = rater.vocab.encode_cached(te.Unicode)
        # reference-format unmapped-char diagnostics, deduplicated PER
        # EDGE (element), like the reference's per-edge seen-set — not
        # page-wide
        for pos in np.nonzero(ids == 0)[0]:
            char = te.Unicode[pos]
            key = (id(element), getattr(te, 'index', None))
            if char not in unmapped_seen.setdefault(key, set()):
                rater.logger.error(
                    'unmapped character "%s" at input alternative %s '
                    'of element %s', char, key[1],
                    element.id if hasattr(element, 'id') else
                    (element or 'space'))
                unmapped_seen[key].add(char)
        seqs.append(ids)
        conf = te.conf if te.conf is not None else 1.0
        bits.append(-log2(max(conf, 1e-99)))

    nB, nA = len(beam), len(tes)
    N = nB * nA
    D, W = rater.depth, rater.width
    # unbounded: beam * alternatives can exceed the largest step
    # bucket (wide beams / many-alternative edges); truncation would
    # crash the fill loop
    Np = bucket_unbounded(N, STEP_BUCKETS)
    h = np.zeros((D, Np, W), np.float32)
    c = np.zeros((D, Np, W), np.float32)
    x = np.zeros((Np,), np.int32)
    cost = np.zeros((N,), np.float64)
    hist: List[Optional[PathStep]] = [None] * N
    hb, cb = _states_to_arrays(beam, D, W)
    for bi, hyp in enumerate(beam):
        for ai in range(nA):
            i = bi * nA + ai
            h[:, i] = hb[:, bi]
            c[:, i] = cb[:, bi]
            x[i] = hyp.last_id
            cost[i] = hyp.cost
            hist[i] = hyp.hist
    zs = rater._context_arrays(context, Np)
    row = np.arange(Np)
    maxlen = max((len(s) for s in seqs), default=0)
    # hoisted per-edge constants (these were rebuilt in Python per
    # char step: O(maxlen * N) overhead on the CPU/parity path)
    bits_pad = np.zeros((Np,), np.float64)
    bits_pad[:N] = np.tile(np.asarray(bits, np.float64), nB)
    lens_pad = np.zeros((Np,), np.int64)
    lens_pad[:N] = np.tile(np.array([len(s) for s in seqs],
                                    np.int64), nB)
    seq_pad = np.zeros((Np, max(maxlen, 1)), np.int32)
    for ai, seq in enumerate(seqs):
        if len(seq):
            seq_pad[np.arange(nB) * nA + ai, :len(seq)] = seq
    for t in range(maxlen):
        probs, h2, c2 = _predict_step(rater.params, rater.cfg, x, zs,
                                      h, c)
        live = t < lens_pad
        nxt = np.where(live, seq_pad[:, t], x)
        p = probs[row, nxt]
        step_bits = (lm_weight * -np.log2(np.maximum(p, 1e-99))
                     + (1.0 - lm_weight) * bits_pad)
        cost = cost + np.where(live[:N], step_bits[:N], 0.0)
        h = np.where(live[None, :, None], h2, h)
        c = np.where(live[None, :, None], c2, c)
        x = np.where(live, nxt, x)
    out = []
    for i in range(N):
        te = tes[i % nA]
        step = PathStep(hist[i], element, te, float(cost[i]))
        # COPY the kept rows: views would pin the whole (D, Np, W)
        # expansion arrays for as long as any hypothesis survives
        # (O(edges x 100s of KB) dead state on long documents)
        out.append(Hypothesis(float(cost[i]),
                              (h[:, i].copy(), c[:, i].copy()),
                              int(x[i]), step))
    return out


def _cluster_beam(beam: List[Hypothesis], depth: int,
                  distance: float) -> List[Hypothesis]:
    """History clustering: among hypotheses whose latest edge produced
    the same text and whose per-layer states are all within
    ``distance``, keep only the cheapest (the reference's clustering,
    applied at edge completion)."""
    kept: List[Hypothesis] = []
    for hyp in beam:  # beam comes in cost order: first wins
        text = hyp.hist.textequiv.Unicode if hyp.hist else ''
        redundant = False
        for other in kept:
            other_text = (other.hist.textequiv.Unicode
                          if other.hist else '')
            if text != other_text:
                continue
            if hyp.state is None or other.state is None:
                continue
            if all(np.linalg.norm(hyp.state[k][d] - other.state[k][d])
                   < distance for k in range(2) for d in range(depth)):
                redundant = True
                break
        if not redundant:
            kept.append(hyp)
    return kept


def decode_lattice_host(rater, graph, start_node, end_node,
                        start_traceback=None, context=None,
                        lm_weight: float = 0.5, beam_width: int = 10,
                        clustering_dist: float = 0):
    """Beam decode a lattice DAG on the host (device steps batched per
    char position).  Same contract as the reference's ``rate_best``:
    returns the newly locked-in ``(path, entropy, traceback)`` via
    ``advance_traceback``."""
    import networkx as nx

    if not start_traceback:
        root = Hypothesis(cost=0.0, state=None,
                          last_id=rater.vocab.get('\n'), hist=None)
        start_traceback = ([root], None)
    node_beams: Dict[Any, List[Hypothesis]] = {
        start_node: list(start_traceback[0])}
    unmapped_seen: Dict[Any, set] = {}
    for v in nx.topological_sort(graph):
        if v not in node_beams:
            continue
        beam = sorted(node_beams[v], key=lambda hyp: hyp.cost)
        if clustering_dist:
            beam = _cluster_beam(beam, rater.depth, clustering_dist)
        node_beams[v] = beam = beam[:beam_width]
        if v == end_node:
            continue
        for _, w, edge in graph.out_edges(v, data=True):
            cands = _expand_edge(rater, beam, edge, context, lm_weight,
                                 unmapped_seen)
            node_beams.setdefault(w, []).extend(cands)
        # processed nodes are never revisited (topological order):
        # releasing their beams keeps live state at O(open nodes),
        # not O(edges), on long documents
        del node_beams[v]
    assert end_node in node_beams, \
        'no path from %s reached end node %s' % (start_node, end_node)
    return advance_traceback(node_beams[end_node], start_traceback)


def generate_host(rater, prefix: str, length: int, context=None,
                  variants: int = 1, topk: int = 10,
                  threshold: float = 0.004,
                  fringe_size: int = 256) -> List[str]:
    """The ``variants`` best continuations of ``prefix`` by ``length``
    chars: per-hypothesis top-``topk`` expansion, absolute probability
    threshold, fringe capped at ``fringe_size``; [] when the fringe
    dies."""
    from .rater import STEP_BUCKETS, _bucket, _predict_step

    if not context:
        context = rater.underspecify_contexts()
    D, W = rater.depth, rater.width
    ids = rater.vocab.encode(prefix)

    # consume the prefix (all but the final char) at batch 1
    h = np.zeros((D, 1, W), np.float32)
    c = np.zeros((D, 1, W), np.float32)
    zs1 = rater._context_arrays(context, 1)
    for cid in ids[:-1]:
        _, h, c = _predict_step(rater.params, rater.cfg,
                                np.array([cid], np.int32), zs1, h, c)

    # fringe arrays; slot 0 holds the prefix state
    n = 1
    cost = np.zeros((1,), np.float64)
    x = np.array([ids[-1] if len(ids) else 0], np.int32)
    steps: List[Tuple[np.ndarray, np.ndarray]] = []  # (chars, backptrs)
    topk = min(topk, rater.voc_size)
    for _ in range(length):
        Np = _bucket(n, STEP_BUCKETS)
        xp = np.zeros((Np,), np.int32)
        xp[:n] = x
        hp = np.zeros((D, Np, W), np.float32)
        cp = np.zeros((D, Np, W), np.float32)
        hp[:, :n] = h
        cp[:, :n] = c
        zs = rater._context_arrays(context, Np)
        probs, h2, c2 = _predict_step(rater.params, rater.cfg, xp, zs,
                                      hp, cp)
        probs = probs[:n]
        # per-hypothesis top-k expansion
        idx_top = np.argpartition(probs, -topk, axis=1)[:, -topk:]
        p_top = np.take_along_axis(probs, idx_top, axis=1)
        cand = cost[:, None] - np.log(np.maximum(p_top, 1e-99))
        cand[p_top < threshold] = np.inf     # absolute threshold
        cand[idx_top == 0] = np.inf          # unmapped/padding char
        flat = cand.ravel()
        keep = min(fringe_size, flat.size)
        sel = np.argpartition(flat, keep - 1)[:keep]
        sel = sel[np.isfinite(flat[sel])]
        if sel.size == 0:
            return []
        sel = sel[np.argsort(flat[sel], kind='stable')]
        parents = sel // topk
        chars = idx_top.ravel()[sel]
        steps.append((chars, parents))
        cost = flat[sel]
        x = chars.astype(np.int32)
        h = h2[:, parents]
        c = c2[:, parents]
        n = sel.size
    # reconstruct the best ``variants`` strings from the backpointers
    results = []
    for k in np.argsort(cost, kind='stable')[:variants]:
        out: List[int] = []
        idx = int(k)
        for chars, parents in reversed(steps):
            out.append(int(chars[idx]))
            idx = int(parents[idx])
        out.reverse()
        results.append((prefix[-1:] if prefix else '') +
                       ''.join(rater.vocab.i2c.get(i, '') for i in out))
    return results
