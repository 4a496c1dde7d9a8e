"""Plain PyTorch reference of ``keraslm-rate train``'s first steps.

Stateful training on parallel streams (ocrd_keraslm's layout in the
port's batched form): a training file's ids are cut into ``B``
contiguous streams (B = min(batch, (n - 1) // (T + 1)), the last
stream taking the remainder), and batch w holds window w of every
stream (x = ids[lo:lo+T], y = ids[lo+1:lo+T+1], masked past a stream's
end); the carry runs on from batch to batch of one file.  With
degradation, after each clean window one uniform draw u of the epoch's
data generator decides an extra degraded copy: u < char_degradation
zeroes input column int((T - 1) u / char_degradation); else, with u'
= (u - char_degradation) / (1 - char_degradation) < context_degradation,
the context is zeroed.  A step is the mean cross-entropy over the
unmasked targets plus the embedding regularizers, its gradient clipped
to [-1, 1] elementwise, then Adam (lr 1e-3, betas 0.9/0.999, eps 1e-7).
The output of every layer above the first is multiplied by a dropout
mask constant over time: one Bernoulli(1 - p) draw of shape (B, 1, W)
per such layer and step, in layer order, over 1 - p, from the run's CPU
dropout generator (the reference starts one from the state that the
trainer's generator had before its first step).

Nothing here imports the port.
"""
from __future__ import annotations

from math import ceil
from typing import Iterator, Sequence

import numpy as np
import torch

from .lm import LM


def context_of(name: str) -> int:
    """The year's decade of an ``author_title_year.txt`` name, 0 beyond
    the table or without a year."""
    base = name.rsplit('/', 1)[-1].split('.')[0].split('_')
    if len(base) == 3 and base[2].isdigit():
        bucket = ceil(int(base[2]) / 10)
        return bucket if bucket < 200 else 0
    return 0


def stream_batches(ids: np.ndarray, batch: int, T: int, rng,
                   char_deg: float, ctx_deg: float, z: int
                   ) -> Iterator[tuple]:
    """(x, z, y, mask, reset) of every training batch of one file, the
    degraded copies included."""
    size = len(ids)
    B = max(1, min(batch, (size - 1) // (T + 1)))
    stream_len = (size - 1) // B
    last_len = (size - 1) - (B - 1) * stream_len
    for w in range(max(-(-last_len // T), 1)):
        x = np.zeros((batch, T), np.int64)
        y = np.zeros((batch, T), np.int64)
        mask = np.zeros((batch, T), np.float32)
        for b in range(B):
            end = size - 1 if b == B - 1 else (b + 1) * stream_len
            lo = b * stream_len + w * T
            hi = min(lo + T, end)
            if hi > lo:
                x[b, :hi - lo] = ids[lo:hi]
                y[b, :hi - lo] = ids[lo + 1:hi + 1]
                mask[b, :hi - lo] = 1.0
        zs = np.full((batch,), z, np.int64)
        yield x, zs, y, mask, w == 0
        u = rng.uniform()
        if 0 < u < char_deg:
            xa = x.copy()
            xa[:, int((T - 1) * u / char_deg)] = 0
            yield xa, zs.copy(), y, mask, False
        u = (u - char_deg) / (1 - char_deg)
        if 0 < u < ctx_deg:
            yield x.copy(), np.zeros_like(zs), y, mask, False


def regularization(weights) -> torch.Tensor:
    emb = weights['char_embedding']
    mean_rest = emb[1:].mean(0).detach()
    loss = 1.0 * torch.sum((emb[0] - mean_rest) ** 2) \
        + 0.01 * torch.sum((1.0 - torch.sum(emb ** 2, 1)) ** 2)
    for e in weights['context_embeddings']:
        n = e.shape[0]
        loss = loss + 0.02 * torch.sum((1.0 - torch.sum(e ** 2, 1)) ** 2)
        loss = loss + 0.2 * torch.sum(e[1:n - 1].detach() @ e[2:n].T)
        vecs = e[1:]
        wgts = torch.sum(vecs * vecs, 1).detach()
        loss = loss + 2.0 * torch.sum(
            (e[0:1] - wgts[:, None] * vecs.mean(0).detach()) ** 2)
    return loss


def forward_loss(lm: LM, weights, x, z, y, mask, h0, c0, keep=None):
    """Mean NLL over the mask (nats) and the final carry of one window,
    through the tensors of ``weights`` (so that autograd reaches them);
    ``keep(layer)`` gives the dropout mask of the output of a layer above
    the first."""
    lm.emb = weights['char_embedding']
    lm.ctx = list(weights['context_embeddings'])
    lm.layers = [(lw['kernel'], lw['recurrent'], lw['bias'])
                 for lw in weights['lstm']]
    inp = lm.embed(x, z)
    hs, cs = [], []
    for layer, (kernel, _, bias) in enumerate(lm.layers):
        proj = lm.mm(inp, kernel) + bias
        h, c = h0[layer], c0[layer]
        outs = []
        for t in range(x.shape[1]):
            h, c = lm.cell(layer, proj[:, t], h, c)
            outs.append(h)
        inp = torch.stack(outs, 1)
        hs.append(h)
        cs.append(c)
        if layer > 0 and keep is not None:
            inp = inp * keep(layer)
    logits = lm.mm(inp, lm.emb.T)
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, y[..., None])[..., 0]
    loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return loss, torch.stack(hs).detach(), torch.stack(cs).detach()


def train_steps(lm: LM, weights, batches: Sequence[tuple], dropout: float,
                dropout_state: torch.Tensor, n_steps: int = 3, lr: float = 1e-3,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7
                ) -> dict:
    """Run ``n_steps`` steps from ``weights`` (a tree of tensors, copied)
    on ``batches``, the dropout masks drawn from a CPU generator in
    ``dropout_state``; returns the steps' losses, the first step's clipped
    gradient per leaf and the weights after the steps."""
    from .lm import leaves
    dev = lm.device
    tree = {'char_embedding': weights['char_embedding'].clone(),
            'context_embeddings': [e.clone() for e in
                                   weights['context_embeddings']],
            'lstm': [{k: v.clone() for k, v in lw.items()}
                     for lw in weights['lstm']]}
    named = leaves(tree)
    for _, t in named:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for _, t in named]
    v = [torch.zeros_like(t) for _, t in named]
    gen = torch.Generator()
    gen.set_state(dropout_state)
    W = lm.W
    h = c = None
    losses, first_grads = [], None
    for step in range(n_steps):
        x, z, y, mask, reset = batches[step]
        B = x.shape[0]
        if reset or h is None:
            h, c = lm.zeros(B)
        keep = None
        if dropout > 0:
            def keep(layer, B=B):
                return (torch.bernoulli(
                    torch.full((B, 1, W), 1.0 - dropout), generator=gen)
                    / (1.0 - dropout)).to(dev)

        def t(a):
            return torch.as_tensor(a, device=dev)
        loss, h, c = forward_loss(lm, tree, t(x), t(z), t(y), t(mask), h, c,
                                  keep)
        loss = loss + regularization(tree)
        for _, p in named:
            p.grad = None
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = [p.grad.clamp(-1.0, 1.0) for _, p in named]
            if first_grads is None:
                first_grads = [g.clone() for g in grads]
            for i, (_, p) in enumerate(named):
                m[i].mul_(b1).add_(grads[i], alpha=1 - b1)
                v[i].mul_(b2).addcmul_(grads[i], grads[i], value=1 - b2)
                mhat = m[i] / (1 - b1 ** (step + 1))
                vhat = v[i] / (1 - b2 ** (step + 1))
                p.sub_(lr * mhat / (vhat.sqrt() + eps))
    return {'losses': losses,
            'grads': {name: g for (name, _), g in zip(named, first_grads)},
            'weights': {name: p.detach() for name, p in named}}


def leaf_gaps(got: dict, want: dict, skip=()) -> dict:
    """Per leaf |norm(got) - norm(want)| over max(norm(want), the median
    leaf's norm), leaves in ``skip`` left out."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.vector_norm(got[k].double()))
                   - norms[k]) / max(norms[k], med, 1e-30)
            for k in want if k not in skip}
