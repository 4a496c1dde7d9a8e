"""Plain PyTorch reference of ocrd_keraslm's generation beam search.

``keraslm-rate generate -n N -v V PREFIX``: the prefix but its last
char is fed from the zero state; the fringe starts as one hypothesis
whose next input is the prefix's last char.  Every step each
hypothesis offers its ten most probable next chars (the softmax over
the whole vocabulary; the unmapped id 0 and any char under probability
0.004 are dropped, not replaced), at cost ``cost - ln p``; the 256
cheapest candidates over the fringe survive.  After N steps the V
cheapest hypotheses are the result, each as the prefix's last char
followed by its N chars.

Nothing here imports the port.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .lm import LM

TOPK = 10
THRESHOLD = 0.004
FRINGE = 256


def beam_generate(lm: LM, prefixes: Sequence[Sequence[int]], length: int,
                  variants: int, z: int = 0, fringe: int = FRINGE
                  ) -> List[List[Tuple[float, List[int]]]]:
    """Per prefix (char ids), its ``variants`` best (cost in nats, the
    ``length`` generated ids), all prefixes searched at once; ``fringe``
    hypotheses survive a step (fewer: a narrowed search, planted as a
    fault)."""
    dev = lm.device
    R = len(prefixes)
    F = fringe
    P = max(len(p) for p in prefixes)
    ids = np.zeros((R, max(P - 1, 1)), np.int64)
    live = np.zeros((R, max(P - 1, 1)), bool)
    for r, p in enumerate(prefixes):
        ids[r, :len(p) - 1] = p[:-1]
        live[r, :len(p) - 1] = True
    zt = torch.full((R,), z, dtype=torch.long, device=dev)
    with torch.no_grad():
        h, c = lm.zeros(R)
        for t in range(P - 1):
            _, h2, c2 = lm.step(torch.as_tensor(ids[:, t], device=dev), zt,
                                h, c)
            lv = torch.as_tensor(live[:, t], device=dev)
            h = torch.where(lv[None, :, None], h2, h)
            c = torch.where(lv[None, :, None], c2, c)
        h = h.repeat_interleave(F, 1)
        c = c.repeat_interleave(F, 1)
        x = torch.as_tensor([p[-1] for p in prefixes], device=dev
                            ).repeat_interleave(F)
        cost = torch.full((R, F), float('inf'), dtype=torch.float64,
                          device=dev)
        cost[:, 0] = 0.0
        zr = torch.full((R * F,), z, dtype=torch.long, device=dev)
        back = []
        offs = torch.arange(R, device=dev)[:, None] * F
        for _ in range(length):
            logits, h2, c2 = lm.step(x, zr, h, c)
            probs = torch.softmax(logits.double(), -1)
            p_top, i_top = torch.topk(probs, TOPK, dim=1)
            cand = cost.reshape(-1)[:, None] - torch.log(
                p_top.clamp(min=1e-99))
            cand = torch.where((p_top < THRESHOLD) | (i_top == 0),
                               torch.full_like(cand, float('inf')), cand)
            flat = cand.view(R, F * TOPK)
            best, sel = torch.topk(flat, F, dim=1, largest=False,
                                   sorted=True)
            parent = sel // TOPK
            char = torch.gather(i_top.view(R, F * TOPK), 1, sel)
            back.append((parent.cpu().numpy(), char.cpu().numpy()))
            cost = best
            src = (parent + offs).reshape(-1)
            h, c = h2[:, src], c2[:, src]
            x = char.reshape(-1)
        cost = cost.cpu().numpy()
    out = []
    for r in range(R):
        res = []
        for k in np.argsort(cost[r], kind='stable')[:variants]:
            if not np.isfinite(cost[r, k]):
                continue
            seq = []
            kk = int(k)
            for parent, char in reversed(back):
                seq.append(int(char[r, kk]))
                kk = int(parent[r, kk])
            res.append((float(cost[r, k]), seq[::-1]))
        out.append(res)
    return out


def score_strings(lm: LM, prefixes: Sequence[Sequence[int]],
                  continuations: Sequence[Sequence[int]], z: int = 0
                  ) -> List[Tuple[float, float]]:
    """Per continuation after its prefix: its cost in nats, and the
    widest margin (nats) by which one of its chars lies outside what a
    beam step keeps, the step's tenth most probable char and the
    threshold (<= 0 where every char is kept)."""
    dev = lm.device
    streams = [list(p) + list(cn) for p, cn in zip(prefixes, continuations)]
    n = len(streams)
    T = max(len(s) for s in streams)
    ids = np.zeros((n, T), np.int64)
    for i, s in enumerate(streams):
        ids[i, :len(s)] = s
    ids_t = torch.as_tensor(ids, device=dev)
    zt = torch.full((n,), z, dtype=torch.long, device=dev)
    lp_all, gap_all = [], []
    with torch.no_grad():
        h, c = lm.zeros(n)
        for t in range(T - 1):
            logits, h, c = lm.step(ids_t[:, t], zt, h, c)
            logp = torch.log_softmax(logits.double(), -1)
            tok = ids_t[:, t + 1]
            kth = torch.topk(logp, TOPK, dim=1).values[:, -1]
            lp = logp.gather(1, tok[:, None])[:, 0]
            lp_all.append(lp)
            gap_all.append(torch.maximum(kth - lp,
                                         np.log(THRESHOLD) - lp))
    lp = torch.stack(lp_all, 1).cpu().numpy()
    gap = torch.stack(gap_all, 1).cpu().numpy()
    out = []
    for i, (p, cn) in enumerate(zip(prefixes, continuations)):
        span = slice(len(p) - 1, len(p) - 1 + len(cn))
        out.append((float(-lp[i, span].sum()), float(gap[i, span].max())))
    return out
