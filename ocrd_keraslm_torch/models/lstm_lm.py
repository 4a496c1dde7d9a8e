"""Character-level stacked-LSTM language model — PyTorch core.

Counterpart of ``ocrd_keraslm_tpu/models/lstm_lm.py``: char embedding
(voc_size x width) concatenated with per-variable context embeddings,
``depth`` LSTM layers and a weight-tied softmax (softmax(h @ E^T), no
extra projection or bias).

``forward_seq`` runs each layer's recurrence through
:func:`ocrd_keraslm_torch.ops.lstm_cell.lstm_scan` (the CUDA kernel on
the card), after one large product for the layer's input projection;
where a gradient is needed, through
:class:`ocrd_keraslm_torch.ops.lstm_cell.LSTMScan`, whose backward is
the second kernel.  Training adds variational dropout, the embedding
regularizers and the cross-entropy.

Parameters keep the JAX package's tree layout, which is also the
Keras 2.3 layout of the h5 checkpoints: ``kernel`` (in, 4W),
``recurrent`` (W, 4W), ONE ``bias`` (4W,), gate order i, f, g (c~), o.
``torch.nn.LSTM`` stores transposed weights with two biases; it is not
used, so h5 weights, JAX params and this port's params are the same
arrays.
"""
from __future__ import annotations

import dataclasses
from math import sqrt
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.lstm_cell import LSTMScan, lstm_gates, lstm_scan

DEFAULT_CONTEXTS: Tuple[Tuple[int, int], ...] = ((200, 10),)

Params = Dict[str, Any]
Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c) each (depth, B, W)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Hyperparameters of the LM (travel inside checkpoints)."""
    width: int = 128
    depth: int = 2
    length: int = 256
    voc_size: int = 0
    # list of (table_size, embed_dim) per context variable:
    contexts: Tuple[Tuple[int, int], ...] = DEFAULT_CONTEXTS
    stateful: bool = True
    variable_length: bool = False
    # dropout rate between hidden layers (variational / time-constant):
    dropout: float = 0.1
    # compute dtype for the recurrent core ('float32' or 'bfloat16'):
    compute_dtype: str = 'float32'

    @property
    def n_contexts(self) -> int:
        return len(self.contexts)

    @property
    def input_dim(self) -> int:
        return self.width + sum(d for _, d in self.contexts)

    def replace(self, **kw) -> 'LMConfig':
        return dataclasses.replace(self, **kw)


def params_from_numpy(tree: Params, device) -> Params:
    """Carry a parameter tree of numpy arrays (as the h5 reader or the
    JAX package holds them) onto ``device`` as float32 tensors, in the
    same layout and nesting."""
    def conv(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return {
        'char_embedding': conv(tree['char_embedding']),
        'context_embeddings': [conv(e)
                               for e in tree['context_embeddings']],
        'lstm': [{name: conv(lp[name])
                  for name in ('kernel', 'recurrent', 'bias')}
                 for lp in tree['lstm']],
    }


def params_to_numpy(params: Params) -> Params:
    """The parameter tree as float32 numpy arrays on the host (what the
    h5 writer takes), in the same layout and nesting."""
    def conv(t):
        return t.detach().to('cpu', torch.float32).numpy()
    return {
        'char_embedding': conv(params['char_embedding']),
        'context_embeddings': [conv(e)
                               for e in params['context_embeddings']],
        'lstm': [{name: conv(lp[name])
                  for name in ('kernel', 'recurrent', 'bias')}
                 for lp in params['lstm']],
    }


def param_leaves(params: Params) -> list:
    """The tree's tensors in a fixed order (embedding, context tables,
    then kernel, recurrent, bias of each layer)."""
    return ([params['char_embedding']] + list(params['context_embeddings'])
            + [lp[name] for lp in params['lstm']
               for name in ('kernel', 'recurrent', 'bias')])


def init_params(cfg: LMConfig, generator: torch.Generator,
                device='cpu') -> Params:
    """Fresh parameters as Keras initialises them: embeddings
    N(0, 0.001), LSTM kernel glorot-uniform, recurrent kernel
    orthogonal, bias zero with the forget gate's at 1.  Drawn on the CPU
    from ``generator`` (so a seed gives the same weights on any device),
    then moved to ``device``."""
    W = cfg.width

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)
    params: Params = {
        'char_embedding': 0.001 * normal((cfg.voc_size, W)),
        'context_embeddings': [0.001 * normal((n, d))
                               for n, d in cfg.contexts],
        'lstm': [],
    }
    for layer in range(cfg.depth):
        in_dim = cfg.input_dim if layer == 0 else W
        limit = sqrt(6.0 / (in_dim + 4 * W))
        kernel = (torch.rand((in_dim, 4 * W), generator=generator,
                             dtype=torch.float32) * 2 - 1) * limit
        bias = torch.zeros((4 * W,), dtype=torch.float32)
        bias[W:2 * W] = 1.0  # unit forget bias
        params['lstm'].append({
            'kernel': kernel,
            'recurrent': _orthogonal(normal((4 * W, 4 * W)), W),
            'bias': bias})
    return {'char_embedding': params['char_embedding'].to(device),
            'context_embeddings': [e.to(device) for e in
                                   params['context_embeddings']],
            'lstm': [{k: v.to(device) for k, v in lp.items()}
                     for lp in params['lstm']]}


def _orthogonal(a: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The first ``n_rows`` rows of the orthogonal factor of the square
    normal matrix ``a`` (signs fixed by the diagonal of R, like Keras'
    Orthogonal): orthonormal rows."""
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r)))[:n_rows].contiguous()


def zero_carry(cfg: LMConfig, batch: int, device) -> Carry:
    h = torch.zeros((cfg.depth, batch, cfg.width), dtype=torch.float32,
                    device=device)
    return h, torch.zeros_like(h)


def embed_inputs(params: Params, x: torch.Tensor,
                 zs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Embed char indices x (B, T) and context indices zs[i] (B, T) or
    (B,) broadcast; concatenate along features -> (B, T, input_dim).
    A context index beyond its table reads the table's last row, as the
    JAX package's gather does (a year past the table's range).

    The lookups are ``torch.nn.functional.embedding``, and a
    time-constant context is looked up once per stream and then
    broadcast over time: the values are those of ``table[index]``, but
    the gradient sums the B*T rows that share a table row by sorting
    them, where the backward of an index expression goes row by row
    (most of a training step's device time at 32,768 positions).

    Where a CUDA table takes a gradient (training on the card), the
    lookup is a product with the indices' one-hot rows instead: the
    same values (one product by 1.0, the rest by 0.0), and a gradient
    summed by a matrix product, the same from run to run, where the
    CUDA backward of ``embedding`` sums the rows that share a table row
    in an order that changes from run to run (so that a resumed
    training run could not replay an uninterrupted one)."""
    feats = [_lookup(x, params['char_embedding'])]
    for z, table in zip(zs, params['context_embeddings']):
        rows = _lookup(z.clamp(max=table.shape[0] - 1), table)
        if z.dim() == 1:                        # time-constant context
            rows = rows[:, None, :].expand(x.shape + rows.shape[-1:])
        feats.append(rows)
    return torch.cat(feats, dim=-1)


def _lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[idx]``; see :func:`embed_inputs` for the one-hot product
    of a CUDA table that takes a gradient."""
    if table.is_cuda and table.requires_grad and torch.is_grad_enabled():
        one_hot = torch.nn.functional.one_hot(idx, table.shape[0])
        return one_hot.to(table.dtype) @ table
    return torch.nn.functional.embedding(idx, table)


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``.  For CUDA through pinned memory and
    without blocking: a copy from pageable memory makes the host wait
    for all the device work queued before it, and the device then idles
    while the host catches up with its launches."""
    device = torch.device(device)
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def forward_step(params: Params, cfg: LMConfig, x: torch.Tensor,
                 zs: Sequence[torch.Tensor], carry: Carry
                 ) -> Tuple[torch.Tensor, Carry]:
    """Single-step forward for a batch of hypotheses.

    x: (B,) int64; zs: (B,) each; carry: explicit (h, c).
    Returns (probs (B, V) float32 softmax, new carry)."""
    h0, c0 = carry
    inp = embed_inputs(params, x[:, None], zs)[:, 0]
    hs, cs = [], []
    for layer in range(cfg.depth):
        lp = params['lstm'][layer]
        x_proj = inp @ lp['kernel'] + lp['bias']
        h2, c2 = lstm_gates(x_proj, h0[layer], c0[layer], lp['recurrent'])
        hs.append(h2)
        cs.append(c2)
        inp = h2
    logits = inp @ params['char_embedding'].T
    return torch.softmax(logits, dim=-1), (torch.stack(hs),
                                           torch.stack(cs))


def _layer_scan_masked(x_proj, h0, c0, recurrent, mask):
    """One layer's scan with a per-position validity mask (B, T):
    masked positions pass the carry through unchanged, so a left-padded
    window behaves exactly like the shorter window.  Plain PyTorch in
    f32 (the JAX package runs this lane outside its kernels too).
    Returns (h_all (B, T, W), hT, cT)."""
    h, c = h0, c0
    hs = []
    for t in range(x_proj.shape[1]):
        keep = mask[:, t, None] > 0
        h2, c2 = lstm_gates(x_proj[:, t], h, c, recurrent)
        h = torch.where(keep, h2, h)
        c = torch.where(keep, c2, c)
        hs.append(h)
    return torch.stack(hs, dim=1), h, c


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 values, as float32: an operand of a
    product whose terms are then exact in f32 and summed in f32, as
    JAX's bf16 operands with ``preferred_element_type=float32`` (a
    bfloat16 ``@`` in PyTorch would round the result too)."""
    return t.to(torch.bfloat16).to(torch.float32)


def dropout_keep(cfg: LMConfig, batch: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """One layer's variational dropout mask (B, 1, W), constant over
    time: 1/(1-p) where a unit is kept, 0 where it is dropped.  Drawn on
    the CPU from ``generator`` and moved, so a seed gives the same mask
    on any device."""
    keep = torch.bernoulli(
        torch.full((batch, 1, cfg.width), 1.0 - cfg.dropout),
        generator=generator)
    return host_to_device(keep / (1.0 - cfg.dropout), device)


def forward_seq(params: Params, cfg: LMConfig, x: torch.Tensor,
                zs: Sequence[torch.Tensor], carry: Optional[Carry] = None,
                *, train: bool = False,
                rng: Optional[torch.Generator] = None,
                x_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Carry]:
    """Full-sequence forward.

    x: (B, T) int64 char indices; zs: context indices (B,) or (B, T);
    carry: explicit (h, c) or None for zeros.  Each layer's input
    projection over all T steps is one product; its recurrence is one
    :func:`lstm_scan`, or one :class:`LSTMScan` where a gradient is
    needed.  x_mask: optional (B, T) validity mask: masked positions
    leave the recurrent state untouched (variable-length windows; a
    plain loop in full f32 with the unrounded weights).  With ``train``
    and an ``rng`` (a CPU ``torch.Generator``) the output of every
    layer above the first is multiplied by a time-constant dropout mask.
    Under ``cfg.compute_dtype == 'bfloat16'`` the operands of the input
    projections and of ``h @ U`` are rounded to bfloat16; sums, gates,
    carry and logits stay f32.  Returns (logits (B, T, V), final
    carry)."""
    if cfg.compute_dtype not in ('float32', 'bfloat16'):
        raise ValueError('compute_dtype %r: expected float32 or bfloat16'
                         % cfg.compute_dtype)
    bf16 = cfg.compute_dtype == 'bfloat16'
    B = x.shape[0]
    if carry is None:
        carry = zero_carry(cfg, B, x.device)
    h0, c0 = carry
    inp = embed_inputs(params, x, zs)
    if bf16:
        inp = _bf16_values(inp)
    hs, cs = [], []
    for layer in range(cfg.depth):
        lp = params['lstm'][layer]
        kernel = _bf16_values(lp['kernel']) if bf16 else lp['kernel']
        x_proj = (inp @ kernel + lp['bias']).contiguous()
        h0l, c0l = h0[layer].contiguous(), c0[layer].contiguous()
        if x_mask is not None:
            inp, hT, cT = _layer_scan_masked(x_proj, h0l, c0l,
                                             lp['recurrent'], x_mask)
        else:
            rec = lp['recurrent'].to(torch.bfloat16) if bf16 \
                else lp['recurrent']
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (x_proj, h0l, c0l, rec)):
                h_all, hT, cT = LSTMScan.apply(x_proj, h0l, c0l, rec)
            else:
                h_all, _, hT, cT = lstm_scan(x_proj, h0l, c0l, rec)
            inp = h_all.transpose(0, 1)
        hs.append(hT)
        cs.append(cT)
        if layer > 0 and train and cfg.dropout > 0 and rng is not None:
            inp = inp * dropout_keep(cfg, B, rng, x.device)
        if bf16:
            inp = _bf16_values(inp)
    logits = inp @ params['char_embedding'].T
    return logits, (torch.stack(hs), torch.stack(cs))


# ----------------------------------------------------------------------
# losses / regularizers
# ----------------------------------------------------------------------

def char_embedding_regularizer(emb: torch.Tensor) -> torch.Tensor:
    """Underspecification + lowrank loss on the char embedding matrix,
    train phase only: the index-0 vector pulled to the mean of all
    others (no gradient through the mean), and all row norms pulled
    toward 1."""
    if emb.shape[0] <= 1:
        return emb.new_zeros(())
    mean_rest = emb[1:].mean(dim=0).detach()
    underspec = 1.0 * torch.sum(torch.square(emb[0:1] - mean_rest))
    norms = torch.sum(torch.square(emb), dim=1)
    lowrank = 0.01 * torch.sum(torch.square(1.0 - norms))
    return lowrank + underspec


def context_embedding_regularizer(emb: torch.Tensor) -> torch.Tensor:
    """Lowrank + adjacency smoothness + weighted-mean underspecification
    on a context embedding matrix."""
    n = emb.shape[0]
    norms = torch.sum(torch.square(emb), dim=1)
    lowrank = 0.02 * torch.sum(torch.square(1.0 - norms))
    vecs1 = emb[1:n - 1].detach()
    vecs2 = emb[2:n]
    smooth = 0.2 * torch.sum(vecs1 @ vecs2.T)
    vecs = emb[1:]
    wgts = torch.sum(vecs * vecs, dim=1).detach()
    mean_rest = vecs.mean(dim=0).detach()
    underspec = 2.0 * torch.sum(torch.square(
        emb[0:1] - wgts[:, None] * mean_rest))
    return lowrank + smooth + underspec


def regularization_loss(params: Params) -> torch.Tensor:
    loss = char_embedding_regularizer(params['char_embedding'])
    for emb in params['context_embeddings']:
        loss = loss + context_embedding_regularizer(emb)
    return loss


def sequence_xent(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean categorical cross-entropy (natural log) and accuracy.

    logits: (..., V); targets: int indices (...); mask: optional (...)
    float.  Returns (mean NLL, mean accuracy) over the masked items."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    correct = (logits.argmax(dim=-1) == targets).float()
    if mask is None:
        return nll.mean(), correct.mean()
    denom = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / denom, (correct * mask).sum() / denom
