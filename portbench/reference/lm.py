"""Plain PyTorch reference of the character LSTM language model.

The model of OCR-D/ocrd_keraslm (Keras 2.3): a char embedding (V x W)
concatenated with one embedding per context variable (here the year's
decade, a 200 x 10 table), ``depth`` LSTM layers (gates i, f, c~, o;
sigmoid, sigmoid, tanh, sigmoid; one bias of 4W; Keras' layout: kernel
(in, 4W), recurrent kernel (W, 4W)), and a softmax tied to the char
embedding (logits = h @ E^T, no bias).  Training adds, on the output
of every layer above the first, a variational dropout mask constant
over time (``reference/train.py``), and the embedding regularizers of ocrd_keraslm's ``Rater`` (char: the
unspecified row pulled to the mean of the others, row norms pulled to
1; context: the same norms, neighbour smoothness, the unspecified row
pulled to the weighted mean).

Nothing here imports the port.  It computes in float32 with TF32 off
(:func:`strict_float32`), or, as the benchmark's lower-precision
control, with every product in bfloat16 (``dtype='bfloat16'``: weights
and operands rounded to bfloat16, the product's result rounded by
PyTorch; sums of gates, the carry and the softmax stay float32).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import hdf5


def strict_float32() -> None:
    """Full float32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_h5(path: str) -> Tuple[dict, List[int]]:
    """(weights, codepoints) of a Keras-2.3 keraslm model file: weights
    as numpy float32 ``{'char_embedding', 'context_embeddings': [...],
    'lstm': [{'kernel', 'recurrent', 'bias'}, ...]}`` and the positional
    codepoint table of the vocabulary (0: unmapped)."""
    f = hdf5.File(path)
    try:
        config = f['config']
        codepoints = [int(c) for c in np.asarray(config['mapping'][()])]
        depth = int(config['depth'][()])
        n_ctx = (len(np.asarray(config['contexts'][()]))
                 if 'contexts' in config else 1)

        def layer(name):
            group = f[name]
            out = {}
            for wname in group.attrs['weight_names']:
                wname = wname.decode() if isinstance(wname, bytes) else wname
                short = wname.split('/')[-1].split(':')[0]
                out[short] = np.asarray(group[wname], np.float32)
            return out
        weights = {
            'char_embedding': layer('char_embedding')['embeddings'],
            'context_embeddings': [
                layer('context%d_embedding' % (i + 1))['embeddings']
                for i in range(n_ctx)],
            'lstm': []}
        for d in range(depth):
            lw = layer('lstm_%d' % (d + 1))
            bias = lw['bias']
            if bias.shape[0] == 2 * lw['kernel'].shape[1]:
                bias = bias[:bias.shape[0] // 2] + bias[bias.shape[0] // 2:]
            weights['lstm'].append({'kernel': lw['kernel'],
                                    'recurrent': lw['recurrent_kernel'],
                                    'bias': bias})
    finally:
        f.close()
    return weights, codepoints


def encoder(codepoints: Sequence[int]):
    """char -> id of a positional codepoint table (0 where unmapped)."""
    table = {chr(c): i for i, c in enumerate(codepoints) if c > 0}
    return lambda text: [table.get(ch, 0) for ch in text]


def init_weights(seed: int, voc_size: int, width: int, depth: int,
                 contexts: Sequence[Tuple[int, int]], device
                 ) -> Dict[str, object]:
    """Fresh weights drawn on ``device`` from ``seed`` as Keras draws
    them: embeddings N(0, 0.001), LSTM kernels Glorot-uniform, recurrent
    kernels orthogonal (rows of the Q of a square normal matrix, signs
    by R's diagonal), bias zero but the forget gate's at 1; one call
    per leaf."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    W = width
    out = {'char_embedding': 0.001 * torch.randn(
        (voc_size, W), generator=g, device=device),
        'context_embeddings': [0.001 * torch.randn(
            (n, d), generator=g, device=device) for n, d in contexts],
        'lstm': []}
    in0 = W + sum(d for _, d in contexts)
    for layer in range(depth):
        in_dim = in0 if layer == 0 else W
        limit = (6.0 / (in_dim + 4 * W)) ** 0.5
        kernel = (torch.rand((in_dim, 4 * W), generator=g, device=device)
                  * 2 - 1) * limit
        q, r = torch.linalg.qr(torch.randn((4 * W, 4 * W), generator=g,
                                           device=device))
        recurrent = (q * torch.sign(torch.diagonal(r)))[:W].contiguous()
        bias = torch.zeros((4 * W,), device=device)
        bias[W:2 * W] = 1.0
        out['lstm'].append({'kernel': kernel, 'recurrent': recurrent,
                            'bias': bias})
    return out


def leaves(weights) -> List[Tuple[str, object]]:
    """(name, tensor) of every weight, in a fixed order."""
    out = [('char_embedding', weights['char_embedding'])]
    out += [('context%d_embedding' % i, t)
            for i, t in enumerate(weights['context_embeddings'])]
    for d, lw in enumerate(weights['lstm']):
        out += [('lstm%d.%s' % (d, k), lw[k])
                for k in ('kernel', 'recurrent', 'bias')]
    return out


class LM:
    """The model's forward pass on ``device`` in ``dtype`` ('float32';
    'bfloat16': the lower-precision control)."""

    def __init__(self, weights, device, dtype: str = 'float32'):
        def t(a):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                   else a, dtype=torch.float32,
                                   device=device)
        self.device = torch.device(device)
        self.bf16 = dtype == 'bfloat16'
        self.emb = t(weights['char_embedding'])
        self.ctx = [t(e) for e in weights['context_embeddings']]
        self.layers = [(t(lw['kernel']), t(lw['recurrent']), t(lw['bias']))
                       for lw in weights['lstm']]
        self.V, self.W = self.emb.shape
        self.D = len(self.layers)

    def mm(self, a, b):
        if self.bf16:
            return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()
        return a @ b

    def embed(self, x, z):
        """x (N,) or (N, T) char ids, z (N,) context index: the layer-0
        input (N, [T,] W + sum(d))."""
        feats = [self.emb[x]]
        for table in self.ctx:
            rows = table[z.clamp(max=table.shape[0] - 1)]
            if x.dim() == 2:
                rows = rows[:, None, :].expand(x.shape[0], x.shape[1], -1)
            feats.append(rows)
        return torch.cat(feats, -1)

    def cell(self, layer, x_proj, h, c):
        _, recurrent, _ = self.layers[layer]
        g = x_proj + self.mm(h, recurrent)
        W = self.W
        i = torch.sigmoid(g[:, :W])
        f = torch.sigmoid(g[:, W:2 * W])
        cand = torch.tanh(g[:, 2 * W:3 * W])
        o = torch.sigmoid(g[:, 3 * W:])
        c = f * c + i * cand
        return o * torch.tanh(c), c

    def step(self, x, z, h, c):
        """Feed chars ``x`` (N,) from state (h, c), each (D, N, W):
        returns (logits (N, V) for the next char, h', c')."""
        inp = self.embed(x, z)
        hs, cs = [], []
        for layer, (kernel, _, bias) in enumerate(self.layers):
            h2, c2 = self.cell(layer, self.mm(inp, kernel) + bias,
                               h[layer], c[layer])
            hs.append(h2)
            cs.append(c2)
            inp = h2
        return self.mm(inp, self.emb.T), torch.stack(hs), torch.stack(cs)

    def zeros(self, n):
        h = torch.zeros((self.D, n, self.W), device=self.device)
        return h, torch.zeros_like(h)


def log2_softmax(logits):
    return torch.log_softmax(logits.double(), -1) / np.log(2.0)


def teacher_forced_log2p(lm: LM, streams: Sequence[Sequence[int]], z: int,
                         start_id: int) -> List[np.ndarray]:
    """log2 p of every char of each stream, fed one char at a time from
    the zero state with ``start_id`` first (all streams at once,
    shorter ones padded and left as they are)."""
    n = len(streams)
    T = max(len(s) for s in streams)
    ids = np.zeros((n, T), np.int64)
    live = np.zeros((n, T), bool)
    for i, s in enumerate(streams):
        ids[i, :len(s)] = s
        live[i, :len(s)] = True
    ids_t = torch.as_tensor(ids, device=lm.device)
    zt = torch.full((n,), z, dtype=torch.long, device=lm.device)
    h, c = lm.zeros(n)
    x = torch.full((n,), start_id, dtype=torch.long, device=lm.device)
    out = []
    with torch.no_grad():
        for t in range(T):
            logits, h, c = lm.step(x, zt, h, c)
            out.append(log2_softmax(logits).gather(
                1, ids_t[:, t:t + 1])[:, 0])
            x = ids_t[:, t]
    lp = torch.stack(out, 1).cpu().numpy()
    return [lp[i, :len(s)] for i, s in enumerate(streams)]
