"""Pipeline-parallel training: the LSTM stack cut into stages over the
``pipe`` axis of a ``(data, pipe)`` mesh.

Counterpart of ``ocrd_keraslm_tpu/parallel/pipeline.py``.  Stage ``p``
of a data row runs the layers ``[p * D/S, (p + 1) * D/S)``; each rank's
rows are cut into ``n_micro`` microbatches that stream through the
stages GPipe-style:

* forward: stage 0 embeds microbatch ``m``, every stage runs its layers
  (the single-rank layer code, ``lstm_scan`` on the card) and sends the
  ``(mb, T, W)`` block to the next stage; the last stage computes the
  loss of ``m`` (its share of the global mean);
* backward, microbatches in reverse: the last stage differentiates its
  loss, every other stage ``torch.autograd.backward(out, grad)`` with
  the gradient received from the next stage (torch's send and recv are
  not differentiable), and sends its input's gradient back (``lstm_bwd``
  on the card);
* the tied embedding is replicated on the stages (stage 0 embeds, the
  last stage projects), the context tables and all layers too: every
  gradient is summed over the whole mesh (a stage's layers have a
  gradient on that stage only, so the sum over ``pipe`` hands each
  stage's gradient to the others, and the sum over ``data`` is data
  parallelism), and every rank then takes the same Adam step.  The
  canonical parameters, Adam's moments and (gathered over ``pipe`` at
  the end of the step) the carry stay whole and equal on every rank of
  a data row, so validation, checkpoints and resume are those of one
  rank.

Dropout follows the JAX package's rule in spirit, not in bits: a
layer's mask comes from a generator seeded by one draw of the shared
generator per step, the data index and the global layer index, so the
stages need no generator hand-off.  Parity is held with dropout 0, as
the JAX package's own pipeline tests hold it.

:func:`pack_pipeline_params`, :func:`unpack_pipeline_params`,
:func:`pack_carry` and :func:`unpack_carry` give the numpy layout of
the JAX package's stacked stage parameters (the kernels of the layers
above 0 zero-padded to layer 0's input width).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.lstm_lm import (LMConfig, Params, dropout_keep,
                              embed_inputs, lstm_stack, param_leaves,
                              regularization_loss)
from . import comm
from .mesh import DATA_AXIS, PIPE_AXIS, Mesh, make_mesh
from .train import all_reduce_grads, broadcast_params, xent_sums


def make_pipe_mesh(n_devices: Optional[int] = None,
                   pipe_parallel: int = 2) -> Mesh:
    """A ``(data, pipe)`` mesh over the ranks of the world."""
    return make_mesh(n_devices, pipe_parallel, second_axis=PIPE_AXIS)


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().to('cpu').numpy()
    return np.asarray(a)


def pack_pipeline_params(params, cfg: LMConfig, n_stages: int) -> dict:
    """Stack the per-layer LSTM parameters into ``(n_stages,
    layers_per_stage, ...)`` numpy arrays; the kernels of the layers
    above 0 are zero-padded to layer 0's input width."""
    D, W, I = cfg.depth, cfg.width, cfg.input_dim
    if D % n_stages:
        raise ValueError('depth %d not divisible by %d pipeline stages'
                         % (D, n_stages))
    ls = D // n_stages
    kernels = []
    for layer in range(D):
        k = _np(params['lstm'][layer]['kernel'])
        if k.shape[0] < I:
            k = np.concatenate([k, np.zeros((I - k.shape[0], 4 * W),
                                            k.dtype)], 0)
        kernels.append(k)
    return {
        'char_embedding': _np(params['char_embedding']),
        'context_embeddings': [_np(e) for e in
                               params['context_embeddings']],
        'kernel': np.stack(kernels).reshape(n_stages, ls, I, 4 * W),
        'recurrent': np.stack([_np(lp['recurrent']) for lp in
                               params['lstm']]).reshape(n_stages, ls, W,
                                                        4 * W),
        'bias': np.stack([_np(lp['bias']) for lp in params['lstm']])
        .reshape(n_stages, ls, 4 * W),
    }


def unpack_pipeline_params(packed, cfg: LMConfig) -> dict:
    """Back to the canonical numpy tree (the padded rows sliced off)."""
    D, W, I = cfg.depth, cfg.width, cfg.input_dim
    kernel = _np(packed['kernel']).reshape(D, I, 4 * W)
    rec = _np(packed['recurrent']).reshape(D, W, 4 * W)
    bias = _np(packed['bias']).reshape(D, 4 * W)
    return {'char_embedding': _np(packed['char_embedding']),
            'context_embeddings': [_np(e) for e in
                                   packed['context_embeddings']],
            'lstm': [{'kernel': kernel[layer, :I if layer == 0 else W],
                      'recurrent': rec[layer], 'bias': bias[layer]}
                     for layer in range(D)]}


def pack_carry(carry, n_stages: int):
    """``(depth, B, W)`` carry pair -> ``(n_stages, layers_per_stage, B,
    W)``."""
    h, c = carry
    shp = (n_stages, h.shape[0] // n_stages) + tuple(h.shape[1:])
    return h.reshape(shp), c.reshape(shp)


def unpack_carry(pcarry):
    h, c = pcarry
    shp = (h.shape[0] * h.shape[1],) + tuple(h.shape[2:])
    return h.reshape(shp), c.reshape(shp)


def _check(mesh: Mesh, cfg: LMConfig) -> int:
    n_stages = int(mesh.shape[PIPE_AXIS])
    if cfg.depth % n_stages:
        raise ValueError('depth %d not divisible by %d pipeline stages'
                         % (cfg.depth, n_stages))
    if cfg.variable_length:
        raise NotImplementedError(
            'pipeline training covers the stateful-streams layout; '
            'variable-length masked windows use the dp/tp step '
            '(parallel/train.py)')
    return n_stages


def make_pipeline_train_step_canonical(mesh: Mesh, cfg: LMConfig,
                                       n_micro: int, optimizer=None):
    """Return ``(step, shard_fn)`` on canonical parameters, as
    :func:`parallel.train.make_sharded_train_step` does: ``shard_fn``
    makes rank 0's weights every rank's and returns leaves that require
    grad with their Adam; ``step(params, opt, x, zs, y, mask, carry,
    rng)`` takes this rank's data rows and its ``(depth, B_loc, W)``
    carry, runs one GPipe step and returns ``(carry, loss, nll, acc)``
    of the global batch."""
    from ..training import copy_params, make_optimizer
    n_stages = _check(mesh, cfg)
    make_opt = optimizer or make_optimizer
    ls = cfg.depth // n_stages
    p = mesh.second_index
    layers = range(p * ls, (p + 1) * ls)
    last = p == n_stages - 1
    pipe = mesh.second

    def shard_fn(params: Params):
        local = copy_params(broadcast_params(mesh, params),
                            requires_grad=True)
        return local, make_opt(local)

    def keeps(rng, B, device):
        """The dropout masks (B, 1, W) of this stage's layers above 0."""
        if rng is None or cfg.dropout <= 0:
            return None
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))
        out = {}
        for layer in layers:
            if layer > 0:
                gen = torch.Generator().manual_seed(
                    (seed + 1000003 * mesh.data_index + 7919 * layer)
                    % 2 ** 63)
                out[layer] = dropout_keep(cfg, B, gen, device)
        return out

    def step(params, opt, x, zs, y, mask, carry, rng, x_mask=None):
        if x_mask is not None:
            raise ValueError('pipeline training takes no x_mask')
        B, T = x.shape
        if B % n_micro:
            raise ValueError('local batch %d not divisible by %d '
                             'microbatches' % (B, n_micro))
        mb = B // n_micro
        dev = x.device
        opt.zero_grad(set_to_none=True)
        denom = comm.all_reduce(mask.float().sum(), mesh.data) \
            .clamp(min=1.0)
        masks = keeps(rng, B, dev)
        h = carry[0][p * ls:(p + 1) * ls]
        c = carry[1][p * ls:(p + 1) * ls]
        # the new carry goes elsewhere: the scans keep their inputs
        h2, c2 = torch.empty_like(h), torch.empty_like(c)
        block = torch.empty((mb, T, cfg.width), device=dev)
        ins, outs = [], []
        sums = torch.zeros((3,), device=dev)
        for m in range(n_micro):
            r = slice(m * mb, (m + 1) * mb)
            if p == 0:
                inp = embed_inputs(params, x[r], [z[r] for z in zs])
            else:
                inp = comm.recv(block, p - 1, pipe).requires_grad_()
            ins.append(inp)
            keep = None if masks is None else (
                lambda layer, r=r: masks[layer][r])
            out, (hT, cT) = lstm_stack(params, cfg, inp,
                                       (h[:, r], c[:, r]), layers,
                                       keep=keep)
            h2[:, r], c2[:, r] = hT.detach(), cT.detach()
            if last:
                logits = out @ params['char_embedding'].T
                nll_s, cor_s, cnt = xent_sums(mesh, cfg, logits, y[r],
                                              mask[r])
                sums = sums + torch.stack([nll_s.detach(), cor_s, cnt])
                outs.append(nll_s / denom)
            else:
                comm.send(out.detach(), p + 1, pipe)
                outs.append(out)
        for m in reversed(range(n_micro)):
            if last:
                outs[m].backward()
            else:
                torch.autograd.backward(outs[m],
                                        comm.recv(block, p + 1, pipe))
            if p > 0:
                comm.send(ins[m].grad, p - 1, pipe)
        reg = regularization_loss(params)
        if mesh.rank == 0:
            reg.backward()
        leaves = param_leaves(params)
        all_reduce_grads(mesh.world, leaves)
        torch.nn.utils.clip_grad_value_(leaves, 1.0)
        opt.step()
        totals = comm.all_reduce(sums, mesh.world)
        nll = totals[0] / denom
        carry = (comm.all_gather_rows(h2, pipe),
                 comm.all_gather_rows(c2, pipe))
        return carry, nll + reg.detach(), nll, totals[1] / denom

    return step, shard_fn


__all__ = ['DATA_AXIS', 'PIPE_AXIS', 'make_pipe_mesh',
           'make_pipeline_train_step_canonical', 'pack_carry',
           'pack_pipeline_params', 'unpack_carry', 'unpack_pipeline_params']
