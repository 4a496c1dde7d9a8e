"""Plain PyTorch reference of ocrd_keraslm's lattice beam decoding.

A page's lattice is its glyphs in reading order, each with its OCR
alternatives (char, conf), joined by single-alternative spaces (between
words) and newlines (between lines); pages of a document follow one
another with nothing between them, and a document starts from the zero
state with a newline fed first.  A path costs, at every char,
``lm_weight * -log2 p_LM(char | path so far) + (1 - lm_weight) *
-log2 conf``; the beam keeps the ``K`` cheapest hypotheses after every
position.  The processor writes, for each glyph, the chosen
alternative, and for a glyph with several alternatives the conf
``2 ** -(bits of that char)`` (single-alternative runs get their run's
mean, which this check does not compare).

Nothing here imports the port.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .lm import LM, log2_softmax


def beam_decode(lm: LM, pages: Sequence[dict], z: int, start_id: int,
                K: int, lm_weight: float) -> List[Tuple[float, List[int]]]:
    """Beam search over several pages at once, each from its own history.

    ``pages``: dicts with ``history`` (char ids fed before the page, from
    the zero state after ``start_id``), ``alts`` (per position, a list
    of (char id, conf) alternatives).  Returns per page (cost in bits of
    the best path over the page, the chosen alternative per
    position)."""
    dev = lm.device
    S = len(pages)
    A = max(len(a) for p in pages for a in p['alts'])
    P = max(len(p['alts']) for p in pages)
    H = max(len(p['history']) for p in pages)
    # histories right-aligned so that every page starts at step H
    hist = np.zeros((S, H), np.int64)
    hlive = np.zeros((S, H), bool)
    for s, p in enumerate(pages):
        n = len(p['history'])
        hist[s, H - n:] = p['history']
        hlive[s, H - n:] = True
    chars = np.zeros((S, P, A), np.int64)
    bits = np.full((S, P, A), np.inf)
    plive = np.zeros((S, P), bool)
    for s, p in enumerate(pages):
        for t, alts in enumerate(p['alts']):
            plive[s, t] = True
            for a, (cid, conf) in enumerate(alts):
                chars[s, t, a] = cid
                bits[s, t, a] = -np.log2(max(conf, 1e-99))
    zt = torch.full((S,), z, dtype=torch.long, device=dev)
    with torch.no_grad():
        h, c = lm.zeros(S)
        x = torch.full((S,), start_id, dtype=torch.long, device=dev)
        logits, h, c = lm.step(x, zt, h, c)
        for t in range(H):
            live = torch.as_tensor(hlive[:, t], device=dev)
            xt = torch.as_tensor(hist[:, t], device=dev)
            lg2, h2, c2 = lm.step(xt, zt, h, c)
            logits = torch.where(live[:, None], lg2, logits)
            h = torch.where(live[None, :, None], h2, h)
            c = torch.where(live[None, :, None], c2, c)
        # beam rows: S * K, one live hypothesis per page at the start
        rows = S * K
        h = h.repeat_interleave(K, 1)
        c = c.repeat_interleave(K, 1)
        logits = logits.repeat_interleave(K, 0)
        cost = torch.full((S, K), float('inf'), dtype=torch.float64,
                          device=dev)
        cost[:, 0] = 0.0
        zr = torch.full((rows,), z, dtype=torch.long, device=dev)
        chars_t = torch.as_tensor(chars, device=dev)
        bits_t = torch.as_tensor(bits, device=dev)
        back = []
        for t in range(P):
            lp = log2_softmax(logits).view(S, K, -1)
            ct = chars_t[:, t]                                  # (S, A)
            lm_bits = -torch.gather(
                lp, 2, ct[:, None, :].expand(S, K, A))          # (S, K, A)
            cand = cost[:, :, None] + lm_weight * lm_bits \
                + (1.0 - lm_weight) * bits_t[:, t][:, None, :]
            flat = cand.view(S, K * A)
            best, idx = torch.topk(flat, K, dim=1, largest=False,
                                   sorted=True)
            live = torch.as_tensor(plive[:, t], device=dev)
            parent = torch.where(live[:, None], idx // A,
                                 torch.arange(K, device=dev)[None, :])
            alt = torch.where(live[:, None], idx % A,
                              torch.zeros_like(idx))
            cost = torch.where(live[:, None], best, cost)
            back.append((parent.cpu().numpy(), alt.cpu().numpy()))
            src = (parent + torch.arange(S, device=dev)[:, None] * K
                   ).reshape(-1)
            x = torch.gather(ct, 1, alt).reshape(-1)
            h, c = h[:, src], c[:, src]
            lg2, h2, c2 = lm.step(x, zr, h, c)
            lv = live.repeat_interleave(K)
            logits = torch.where(lv[:, None], lg2, logits[src])
            h = torch.where(lv[None, :, None], h2, h)
            c = torch.where(lv[None, :, None], c2, c)
        cost = cost.cpu().numpy()
    out = []
    for s, p in enumerate(pages):
        k = int(np.argmin(cost[s]))
        choice = [0] * len(p['alts'])
        for t in range(len(p['alts']) - 1, -1, -1):
            parent, alt = back[t]
            choice[t] = int(alt[s, k])
            k = int(parent[s, k])
        out.append((float(cost[s].min()), choice))
    return out


def path_bits(log2p: np.ndarray, confs: Sequence[float], lm_weight: float
              ) -> np.ndarray:
    """Bits of each position of a path: its chars' log2 p and the
    chosen alternatives' confs."""
    return lm_weight * -np.asarray(log2p, np.float64) + \
        (1.0 - lm_weight) * -np.log2(np.maximum(np.asarray(
            confs, np.float64), 1e-99))
