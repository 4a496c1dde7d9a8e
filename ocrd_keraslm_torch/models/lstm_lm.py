"""Character-level stacked-LSTM language model — PyTorch core.

Counterpart of ``ocrd_keraslm_tpu/models/lstm_lm.py``: char embedding
(voc_size x width) concatenated with per-variable context embeddings,
``depth`` LSTM layers and a weight-tied softmax (softmax(h @ E^T), no
extra projection or bias).

``forward_seq`` runs each layer's recurrence through
:func:`ocrd_keraslm_torch.ops.lstm_cell.lstm_scan` (the CUDA kernel on
the card), after one large product for the layer's input projection.

Parameters keep the JAX package's tree layout, which is also the
Keras 2.3 layout of the h5 checkpoints: ``kernel`` (in, 4W),
``recurrent`` (W, 4W), ONE ``bias`` (4W,), gate order i, f, g (c~), o.
``torch.nn.LSTM`` stores transposed weights with two biases; it is not
used, so h5 weights, JAX params and this port's params are the same
arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.lstm_cell import lstm_gates, lstm_scan

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


def zero_carry(cfg: LMConfig, batch: int, device) -> Carry:
    h = torch.zeros((cfg.depth, batch, cfg.width), dtype=torch.float32,
                    device=device)
    return h, torch.zeros_like(h)


def embed_inputs(params: Params, x: torch.Tensor,
                 zs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Embed char indices x (B, T) and context indices zs[i] (B, T) or
    (B,) broadcast; concatenate along features -> (B, T, input_dim).
    A context index beyond its table reads the table's last row, as the
    JAX package's gather does (a year past the table's range)."""
    feats = [params['char_embedding'][x]]
    for z, table in zip(zs, params['context_embeddings']):
        if z.dim() == 1:                        # time-constant context
            z = z[:, None].expand(x.shape)
        feats.append(table[z.clamp(max=table.shape[0] - 1)])
    return torch.cat(feats, dim=-1)


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


def forward_seq(params: Params, cfg: LMConfig, x: torch.Tensor,
                zs: Sequence[torch.Tensor], carry: Optional[Carry] = None,
                *, train: bool = False, rng=None,
                x_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Carry]:
    """Full-sequence forward for inference.

    x: (B, T) int64 char indices; zs: context indices (B,) or (B, T);
    carry: explicit (h, c) or None for zeros.  Each layer's input
    projection over all T steps is one product; its recurrence is one
    :func:`lstm_scan`.  Returns (logits (B, T, V), final carry).

    Training mode (dropout), the masked scan of variable-length windows
    and the bfloat16 compute dtype are not ported yet and raise."""
    if train:
        raise NotImplementedError(
            'forward_seq(train=True) with dropout is not ported yet '
            '(ROADMAP.md Queue 1, "Training")')
    if x_mask is not None or cfg.compute_dtype != 'float32':
        raise NotImplementedError(
            'forward_seq with %s is not ported yet (ROADMAP.md Queue 1, '
            '"h5 writing and the rest of the model core")'
            % ('x_mask' if x_mask is not None
               else "compute_dtype=%r" % cfg.compute_dtype))
    B = x.shape[0]
    if carry is None:
        carry = zero_carry(cfg, B, x.device)
    h0, c0 = carry
    inp = embed_inputs(params, x, zs)
    hs, cs = [], []
    for layer in range(cfg.depth):
        lp = params['lstm'][layer]
        x_proj = (inp @ lp['kernel'] + lp['bias']).contiguous()
        h_all, _, hT, cT = lstm_scan(x_proj, h0[layer].contiguous(),
                                     c0[layer].contiguous(),
                                     lp['recurrent'])
        hs.append(hT)
        cs.append(cT)
        inp = h_all.transpose(0, 1)
    logits = inp @ params['char_embedding'].T
    return logits, (torch.stack(hs), torch.stack(cs))
