"""Plain PyTorch reference of AWD-LSTM's char model and its first
training steps.

The model of Merity, Keskar & Socher, "An Analysis of Neural Language
Modeling at Multiple Scales" (arXiv:1803.08240), as its code
(https://github.com/salesforce/awd-lstm-lm, ``model.py`` with
``tie_weights``) builds it for enwik8: a char embedding E (V x emb),
LSTM layers of their own widths (layer l's input is layer l-1's output,
layer 0's the embedding), the last layer's width equal to emb, and a
softmax tied to E with a bias: logits = h E^T + b.  Gates i, f, g, o
(sigmoid, sigmoid, tanh, sigmoid), c = f c + i g, h = o tanh(c), in
Keras' layout: kernel (in, 4W), recurrent (W, 4W), one bias (4W,).
The one departure: AWD's PyTorch layers carry two biases a layer
(b_ih, b_hh), which add; here they are one, as in Keras.

Training regularises as AWD does, from masks the caller gives: the
weight drop multiplies each layer's recurrent matrix by its mask (U *
m, m in {0, 1/(1-p)}), and locked dropout multiplies the embedded
input, the output of every layer below the last and the last layer's
output by masks (B, 1, width) constant over time.  A step is the mean
cross-entropy over the unmasked targets plus the char embedding's
regularizers of the port's trainer, its gradient clipped to [-1, 1]
elementwise, then Adam (lr 1e-3, betas 0.9/0.999, eps 1e-7).

Everything is float32 with TF32 off (:func:`strict_float32`), or, as a
lower-precision control, with every product's operands and result in
bfloat16 (``bf16=True``).  Nothing here imports the port or JAX.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def strict_float32() -> None:
    """Full float32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_weights(seed: int, voc_size: int, widths: Sequence[int],
                 device) -> dict:
    """AWD's initialisation, drawn on ``device`` from ``seed``: the
    embedding uniform in [-0.1, 0.1], each LSTM layer's kernel, recurrent
    matrix and bias uniform in [-1/sqrt(W), 1/sqrt(W)] (PyTorch's LSTM;
    W the layer's width), the head bias 0; in that order, one draw a
    leaf."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    emb = widths[-1]

    def uniform(shape, a):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * a
    out = {'char_embedding': uniform((voc_size, emb), 0.1), 'lstm': []}
    in_dim = emb
    for W in widths:
        a = W ** -0.5
        out['lstm'].append({'kernel': uniform((in_dim, 4 * W), a),
                            'recurrent': uniform((W, 4 * W), a),
                            'bias': uniform((4 * W,), a)})
        in_dim = W
    out['head_bias'] = torch.zeros((voc_size,), device=device)
    return out


def leaves(weights) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every weight: the embedding, each layer's
    kernel, recurrent matrix and bias, the head bias."""
    out = [('char_embedding', weights['char_embedding'])]
    for d, lw in enumerate(weights['lstm']):
        out += [('lstm%d.%s' % (d, k), lw[k])
                for k in ('kernel', 'recurrent', 'bias')]
    return out + [('head_bias', weights['head_bias'])]


def _mm(a, b, bf16):
    if bf16:
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()
    return a @ b


def forward(weights, x, h0, c0, masks=None, bf16=False):
    """Logits (B, T, V) of chars ``x`` (B, T) from the states ``h0``,
    ``c0`` (lists of (B, W_l)), and the final states.  ``masks``:
    ``input`` (B, 1, emb), ``layers`` (one (B, 1, W_l) or None a layer)
    and ``weight`` (one (W_l, 4 W_l) or None a layer), each entry None
    for none."""
    masks = masks or {}
    inp = weights['char_embedding'][x]
    if masks.get('input') is not None:
        inp = inp * masks['input']
    hs, cs = [], []
    for layer, lw in enumerate(weights['lstm']):
        rec = lw['recurrent']
        wm = (masks.get('weight') or [None] * (layer + 1))[layer]
        if wm is not None:
            rec = rec * wm
        W = rec.shape[0]
        proj = _mm(inp, lw['kernel'], bf16) + lw['bias']
        h, c = h0[layer], c0[layer]
        outs = []
        for t in range(x.shape[1]):
            z = proj[:, t] + _mm(h, rec, bf16)
            i = torch.sigmoid(z[:, :W])
            f = torch.sigmoid(z[:, W:2 * W])
            g = torch.tanh(z[:, 2 * W:3 * W])
            o = torch.sigmoid(z[:, 3 * W:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            outs.append(h)
        inp = torch.stack(outs, 1)
        hs.append(h)
        cs.append(c)
        lm = (masks.get('layers') or [None] * (layer + 1))[layer]
        if lm is not None:
            inp = inp * lm
    logits = _mm(inp, weights['char_embedding'].T, bf16) \
        + weights['head_bias']
    return logits, hs, cs


def xent(logits, y, mask):
    """Mean NLL (nats) over the unmasked targets."""
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, y[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def regularization(weights) -> torch.Tensor:
    """The port's trainer's char embedding regularizers: the unspecified
    row (index 0) pulled to the mean of the others, row norms pulled to
    1."""
    emb = weights['char_embedding']
    mean_rest = emb[1:].mean(0).detach()
    return 1.0 * torch.sum((emb[0] - mean_rest) ** 2) \
        + 0.01 * torch.sum((1.0 - torch.sum(emb ** 2, 1)) ** 2)


def zeros(weights, B, device):
    """Zero states, one (B, W_l) a layer."""
    h = [torch.zeros((B, lw['recurrent'].shape[0]), device=device)
         for lw in weights['lstm']]
    return h, [t.clone() for t in h]


def train_steps(weights, batches, masks, device, bf16=False, lr=1e-3,
                b1=0.9, b2=0.999, eps=1e-7) -> dict:
    """Run one step a batch from ``weights`` (copied): ``batches`` of (x,
    y, mask, reset) tensors or arrays, ``masks`` one dict a step (see
    :func:`forward`), the carry running on from batch to batch unless
    ``reset``.  Returns the steps' losses, the first step's clipped
    gradient by leaf name and the weights after the steps."""
    tree = {'char_embedding': weights['char_embedding'].clone(),
            'lstm': [{k: v.clone() for k, v in lw.items()}
                     for lw in weights['lstm']],
            'head_bias': weights['head_bias'].clone()}
    named = leaves(tree)
    for _, t in named:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for _, t in named]
    v = [torch.zeros_like(t) for _, t in named]
    h = c = None
    losses, first = [], None
    for step, (x, y, mask, reset) in enumerate(batches):
        x, y, mask = (torch.as_tensor(a, device=device) for a in (x, y, mask))
        if reset or h is None:
            h, c = zeros(tree, x.shape[0], device)
        logits, h, c = forward(tree, x, h, c, masks[step], bf16)
        h = [t.detach() for t in h]
        c = [t.detach() for t in c]
        loss = xent(logits, y, mask) + regularization(tree)
        for _, p in named:
            p.grad = None
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = [p.grad.clamp(-1.0, 1.0) for _, p in named]
            if first is None:
                first = [g.clone() for g in grads]
            for i, (_, p) in enumerate(named):
                m[i].mul_(b1).add_(grads[i], alpha=1 - b1)
                v[i].mul_(b2).addcmul_(grads[i], grads[i], value=1 - b2)
                mhat = m[i] / (1 - b1 ** (step + 1))
                vhat = v[i] / (1 - b2 ** (step + 1))
                p.sub_(lr * mhat / (vhat.sqrt() + eps))
    return {'losses': losses,
            'grads': {name: g for (name, _), g in zip(named, first)},
            'weights': {name: p.detach() for name, p in named}}


def trainer_masks(state: torch.Tensor, n_steps: int, batch: int,
                  in_dim: int, widths: Sequence[int], weight_drop: float,
                  dropout_input: float, dropout_hidden: float,
                  dropout_output: float, device) -> list:
    """The masks of ``n_steps`` training steps (one :func:`forward`
    ``masks`` dict a step) as the port's trainer draws them from its
    CPU dropout generator, here restarted from ``state``: a step draws
    first, where the weight drop is on, one seed (``torch.randint`` below
    2**62) of a generator on ``device`` that draws each layer's mask of
    its recurrent matrix's shape (``Tensor.bernoulli_`` of 1 - p, over 1 -
    p); then, where its rate is above 0, the input's mask (B, 1, in_dim)
    and layer by layer the mask of its output (B, 1, W_l; the hidden rate
    below the last layer, the output rate at it), each a Bernoulli(1 -
    rate) draw of the CPU generator over 1 - rate."""
    gen = torch.Generator()
    gen.set_state(state)

    def locked(rate, width):
        keep = torch.bernoulli(torch.full((batch, 1, width), 1.0 - rate),
                               generator=gen)
        return (keep / (1.0 - rate)).to(device)
    out = []
    for _ in range(n_steps):
        masks = {'weight': None, 'input': None, 'layers': None}
        if weight_drop > 0:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            dev_gen = torch.Generator(device=device).manual_seed(seed)
            masks['weight'] = [
                torch.empty((w, 4 * w), device=device).bernoulli_(
                    1.0 - weight_drop, generator=dev_gen).div_(
                        1.0 - weight_drop) for w in widths]
        if dropout_input > 0:
            masks['input'] = locked(dropout_input, in_dim)
        layers = []
        for layer, w in enumerate(widths):
            rate = dropout_output if layer == len(widths) - 1 \
                else dropout_hidden
            layers.append(locked(rate, w) if rate > 0 else None)
        masks['layers'] = layers
        out.append(masks)
    return out
