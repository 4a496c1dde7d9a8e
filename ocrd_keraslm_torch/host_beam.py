"""Beam-search generation on the host.

Counterpart of ``generate_host`` in ``ocrd_keraslm_tpu/host_beam.py``.
The fringe lives in flat numpy arrays (costs, stacked states, per-step
char and backpointer records); every step is one batched
:func:`ocrd_keraslm_torch.rater._predict_step` on the rater's device and
a vectorised top-k on the host.  ``Rater.generate`` runs it for an empty
prefix, with ``device_beam`` off, and when the device search comes back
empty (a dead fringe).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


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
