"""The train and evaluation steps over a ``(data, model)`` mesh.

Counterpart of ``ocrd_keraslm_tpu/parallel/train.py``, where ``jit``
over the mesh computes the loss of the global batch and XLA inserts the
collectives.  Here each rank holds its data share of the rows and, on
the ``model`` axis, its shard of the tied embedding's rows, and the
step says every reduction:

* Data parallelism: the cross-entropy is not a mean of per-rank means.
  The sums of ``nll * mask``, ``correct * mask`` and ``mask`` are
  all-reduced over ``data`` and divided (batches with partial windows
  differ in their mask sums between ranks); each rank backpropagates
  its rows' share of the global mean, the gradients are summed over
  ``data``, then clipped elementwise at 1.0 and given to Adam (optax's
  ``chain(clip(1.0), adam)`` order).  The regularizers enter once, on
  data index 0.
* Dropout: each rank draws the full ``(B, 1, W)`` mask of every layer
  from the shared generator and keeps its rows, so the sharded step
  sees the masks of the unsharded one.
* Tensor parallelism over the vocabulary: the embedding lookup is masked
  to the rank's rows and summed over ``model``
  (:class:`comm.ReduceFromModel`); the logits ``h @ shardᵀ`` follow
  :class:`comm.CopyToModel`, so ``dh`` is summed over ``model``; the
  log-softmax takes an all-reduced max and an all-reduced sum of
  ``exp``, the target's logit from the rank that owns it; accuracy takes
  the global argmax with ``argmax``'s lowest-index rule; the char
  embedding regularizer takes row 0 from shard 0 and the mean of rows
  1..V-1 over all shards.  LSTM weights and context tables are
  replicated; their gradients come out equal on every rank of a
  ``model`` group.

Each rank's LSTM runs the single-rank layer code: on the card
``lstm_scan`` forward and ``lstm_bwd`` backward (``LSTMScan``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.lstm_lm import (LMConfig, Params, _lookup, context_inputs,
                              context_embedding_regularizer, hidden_seq,
                              param_leaves)
from . import comm
from .mesh import DATA_AXIS, Mesh, shard_params, vocab_range


def broadcast_params(mesh: Mesh, params: Params) -> Params:
    """Rank 0's parameter tree on every rank (collective): every rank
    starts from the same weights whatever it drew."""
    if mesh.world.trivial:
        return params

    def bc(t):
        return comm.broadcast(t.detach().contiguous(), 0, mesh.world)
    return {'char_embedding': bc(params['char_embedding']),
            'context_embeddings': [bc(e) for e in
                                   params['context_embeddings']],
            'lstm': [{k: bc(v) for k, v in lp.items()}
                     for lp in params['lstm']]}


def embed_sharded(mesh: Mesh, params: Params, cfg: LMConfig, x, zs):
    """The embedded inputs (B, T, input_dim) from this rank's rows of the
    char embedding: the lookup masked to the shard, then summed over
    ``model`` (exact: one rank contributes each row)."""
    if mesh.n_model == 1:
        return None
    lo, hi = vocab_range(mesh, cfg.voc_size)
    own = (x >= lo) & (x < hi)
    emb = params['char_embedding']
    rows = _lookup(torch.where(own, x - lo, 0), emb) \
        * own[..., None].to(emb.dtype)
    rows = comm.ReduceFromModel.apply(rows, mesh.second)
    return torch.cat([rows] + context_inputs(params, x.shape, zs), dim=-1)


def logits_sharded(mesh: Mesh, params: Params, h):
    """This rank's columns of the logits ``h @ embᵀ``."""
    if mesh.n_model > 1:
        h = comm.CopyToModel.apply(h, mesh.second)
    return h @ params['char_embedding'].T


def xent_sums(mesh: Mesh, cfg: LMConfig, logits, y, mask
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sums over this rank's rows of ``nll * mask`` (differentiable),
    ``correct * mask`` and ``mask``, from vocabulary-sharded logits."""
    mask = mask.float()
    if mesh.n_model == 1:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, y[..., None])[..., 0]
        correct = (logits.argmax(dim=-1) == y).float()
    else:
        g = mesh.second
        lo, hi = vocab_range(mesh, cfg.voc_size)
        m = comm.all_reduce(logits.detach().amax(dim=-1), g, 'max')
        shifted = logits - m[..., None]
        sumexp = comm.ReduceFromModel.apply(shifted.exp().sum(dim=-1), g)
        own = (y >= lo) & (y < hi)
        tgt = shifted.gather(-1, torch.where(own, y - lo, 0)[..., None])
        tgt = comm.ReduceFromModel.apply(tgt[..., 0] * own, g)
        nll = torch.log(sumexp) - tgt
        # the global argmax, ties to the lowest index: shards are in
        # vocabulary order, so the first shard holding the max wins
        lmax, larg = logits.detach().max(dim=-1)
        maxes = comm.all_gather_rows(lmax[None], g)
        args = comm.all_gather_rows(larg[None], g)
        best = maxes.argmax(dim=0, keepdim=True)
        gidx = best[0] * (hi - lo) + args.gather(0, best)[0]
        correct = (gidx == y).float()
    return (nll * mask).sum(), (correct * mask).sum(), mask.sum()


def regularization_sharded(mesh: Mesh, params: Params, cfg: LMConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(this rank's differentiable share of the regularizers, their full
    value).  The char embedding's terms are split by rows: each shard's
    lowrank rows, and the underspecification of row 0 on shard 0
    against the mean of rows 1..V-1 of all shards."""
    emb = params['char_embedding']
    ctx = emb.new_zeros(())
    for table in params['context_embeddings']:
        ctx = ctx + context_embedding_regularizer(table)
    V = cfg.voc_size
    if V <= 1:
        char = emb.new_zeros(())
    else:
        lo, _ = vocab_range(mesh, V)
        norms = torch.sum(torch.square(emb), dim=1)
        char = 0.01 * torch.sum(torch.square(1.0 - norms))
        rest = emb.detach().sum(dim=0) - (emb[0].detach() if lo == 0
                                          else 0.0)
        if mesh.n_model > 1:
            rest = comm.all_reduce(rest, mesh.second)
        if lo == 0:
            char = char + torch.sum(torch.square(emb[0:1] - rest / (V - 1)))
    full_char = char.detach()
    if mesh.n_model > 1:
        full_char = comm.all_reduce(full_char, mesh.second)
    return char + ctx, full_char + ctx.detach()


def all_reduce_grads(group: comm.Group, leaves) -> None:
    """Sum the leaves' gradients over ``group`` in one collective (a
    missing gradient counts as zeros)."""
    if group.trivial:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                           group)
    off = 0
    for p, g in zip(leaves, grads):
        p.grad = flat[off:off + g.numel()].view_as(g).clone()
        off += g.numel()


def _forward(mesh, params, cfg, x, zs, y, carry, train, rng, x_mask):
    B = x.shape[0]
    rows = (B * mesh.shape[DATA_AXIS], mesh.data_index * B)
    h, carry = hidden_seq(params, cfg, x, zs, carry, train=train, rng=rng,
                          x_mask=x_mask, rows=rows,
                          embedded=embed_sharded(mesh, params, cfg, x, zs))
    if y.dim() == 1:   # stateless windowed: predict only the next char
        h = h[:, -1, :]
    return logits_sharded(mesh, params, h), carry


def make_sharded_train_step(mesh: Mesh, cfg: LMConfig, optimizer=None):
    """Return ``(step, shard_fn)``.  ``shard_fn(params)`` takes a
    canonical tree, makes rank 0's weights every rank's, and returns
    this rank's leaves (its embedding shard; they require grad) with an
    Adam over them (``optimizer(leaves)``, default
    :func:`training.make_optimizer`).  ``step(params, opt, x, zs, y,
    mask, carry, rng, x_mask=None)`` takes this rank's rows and carry
    and returns ``(carry, loss, nll, acc)`` of the global batch, all
    detached."""
    from ..training import copy_params, make_optimizer
    make_opt = optimizer or make_optimizer

    def shard_fn(params: Params):
        local = copy_params(shard_params(mesh, broadcast_params(mesh,
                                                                params)),
                            requires_grad=True)
        return local, make_opt(local)

    def step(params, opt, x, zs, y, mask, carry, rng, x_mask=None):
        opt.zero_grad(set_to_none=True)
        logits, carry = _forward(mesh, params, cfg, x, zs, y, carry, True,
                                 rng, x_mask)
        nll_s, cor_s, cnt = xent_sums(mesh, cfg, logits, y, mask)
        totals = comm.all_reduce(torch.stack([nll_s.detach(), cor_s, cnt]),
                                 mesh.data)
        denom = totals[2].clamp(min=1.0)
        loss = nll_s / denom
        reg, reg_value = regularization_sharded(mesh, params, cfg)
        if mesh.data_index == 0:
            loss = loss + reg
        loss.backward()
        leaves = param_leaves(params)
        all_reduce_grads(mesh.data, leaves)
        torch.nn.utils.clip_grad_value_(leaves, 1.0)
        opt.step()
        nll = totals[0] / denom
        return ((carry[0].detach(), carry[1].detach()),
                nll + reg_value, nll, totals[1] / denom)

    return step, shard_fn


def make_sharded_eval_step(mesh: Mesh, cfg: LMConfig):
    """``estep(params, x, zs, y, mask, carry, x_mask=None) -> (nll, acc,
    carry)``: the forward of :func:`make_sharded_train_step` without
    dropout or gradient, over this rank's rows (the training loop's
    validation over a mesh).  On a pipeline mesh the ``pipe`` ranks of
    a data row compute alike with the canonical weights."""

    def estep(params, x, zs, y, mask, carry, x_mask=None
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[tuple]]:
        with torch.no_grad():
            logits, carry = _forward(mesh, params, cfg, x, zs, y, carry,
                                     False, None, x_mask)
            nll_s, cor_s, cnt = xent_sums(mesh, cfg, logits, y, mask)
            totals = comm.all_reduce(torch.stack([nll_s, cor_s, cnt]),
                                     mesh.data)
        denom = totals[2].clamp(min=1.0)
        return totals[0] / denom, totals[1] / denom, carry

    return estep
