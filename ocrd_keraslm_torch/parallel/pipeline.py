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
  last stage projects) and so are the context tables.

The two step factories run that one staged forward and backward
(:func:`_make_staged`, as JAX's two share its ``_make_staged``) and
differ in what a rank holds and over which ranks each gradient is
summed:

* :func:`make_pipeline_train_step_canonical` keeps the canonical tree
  whole on every rank: every gradient is summed over the whole mesh (a
  stage's layers have a gradient on that stage only, so the sum over
  ``pipe`` hands each stage's gradient to the others, and the sum over
  ``data`` is data parallelism), and every rank then takes the same
  Adam step.  The canonical parameters, Adam's moments and (gathered
  over ``pipe`` at the end of the step) the carry stay whole and equal
  on every rank of a data row, so validation, checkpoints and resume
  are those of one rank.  The training loop takes this one.
* :func:`make_pipeline_train_step` works on the packed layout: a rank
  at pipe position ``s`` holds stage ``s``'s stacked ``kernel``,
  ``recurrent`` and ``bias`` and their moments (JAX's
  ``_packed_shardings``: the stacks sharded on ``pipe``, the embeddings
  replicated) and its data rows of the stage's carry (JAX's
  ``P(pipe, None, data, None)``).  A stage's layer gradients are summed
  over its ``data`` group only, the embeddings' over the whole mesh,
  and each rank takes Adam on what it holds: the canonical step's
  update with 1/``pp`` of the layers' parameters and moments a rank.

Both sum a gradient over ``pipe`` first, then over ``data``: the sum
over ``pipe`` has at most two terms that are not zero (the embedding's
on the first and the last stage), so the two steps give equal bits
wherever a ``data`` group has at most two ranks.

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
from .mesh import DATA_AXIS, PIPE_AXIS, Mesh, local_rows, make_mesh
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
    _divides(D, n_stages)
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


def _divides(depth: int, n_stages: int) -> None:
    # an AssertionError, as the JAX package's assert raises
    if depth % n_stages:
        raise AssertionError('depth %d not divisible by %d pipeline stages'
                             % (depth, n_stages))


def _make_staged(mesh: Mesh, cfg: LMConfig, n_micro: int):
    """The GPipe forward and backward of one step on this rank's stage,
    shared by both step factories.  Refuses a depth the stages do not
    divide and variable-length windows, as JAX's ``_make_staged`` does.
    Returns ``(staged, layers)``: this stage's global layer indices, and
    ``staged(params, x, zs, y, mask, carry, rng, x_mask=None)``, where
    ``params['lstm'][layer]`` holds each of those layers and ``carry``
    their ``(ls, B_loc, W)`` pair.  It backpropagates this rank's share
    of the loss into the leaves' ``.grad`` (the regularizers on rank 0),
    summed over no rank, and returns ``(the stage's new carry, (loss,
    nll, acc) of the global batch)``."""
    n_stages = int(mesh.shape[PIPE_AXIS])
    _divides(cfg.depth, n_stages)
    if cfg.variable_length:
        raise NotImplementedError(
            'pipeline training covers the stateful-streams layout; '
            'variable-length masked windows use the dp/tp step '
            '(parallel/train.py)')
    ls = cfg.depth // n_stages
    p = mesh.second_index
    layers = range(p * ls, (p + 1) * ls)
    last = p == n_stages - 1
    pipe = mesh.second

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

    def staged(params, x, zs, y, mask, carry, rng, x_mask=None):
        if x_mask is not None:
            raise ValueError('pipeline training takes no x_mask')
        B, T = x.shape
        if B % n_micro:
            raise ValueError('local batch %d not divisible by %d '
                             'microbatches' % (B, n_micro))
        mb = B // n_micro
        dev = x.device
        denom = comm.all_reduce(mask.float().sum(), mesh.data) \
            .clamp(min=1.0)
        masks = keeps(rng, B, dev)
        h, c = carry
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
        totals = comm.all_reduce(sums, mesh.world)
        nll = totals[0] / denom
        return (h2, c2), (nll + reg.detach(), nll, totals[1] / denom)

    return staged, layers


def _update(mesh: Mesh, optimizer, replicated, stage=()) -> None:
    """Sum the gradients of the ``replicated`` leaves over the whole mesh
    and those of the ``stage`` leaves over ``data``, clip them
    elementwise at 1.0 and take the optimizer's step."""
    replicated, stage = list(replicated), list(stage)
    all_reduce_grads(mesh.second, replicated)
    all_reduce_grads(mesh.data, replicated + stage)
    torch.nn.utils.clip_grad_value_(replicated + stage, 1.0)
    optimizer.step()


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
    staged, layers = _make_staged(mesh, cfg, n_micro)
    make_opt = optimizer or make_optimizer
    own = slice(layers.start, layers.stop)

    def shard_fn(params: Params):
        local = copy_params(broadcast_params(mesh, params),
                            requires_grad=True)
        return local, make_opt(local)

    def step(params, opt, x, zs, y, mask, carry, rng, x_mask=None):
        opt.zero_grad(set_to_none=True)
        stage, sums = staged(params, x, zs, y, mask,
                             (carry[0][own], carry[1][own]), rng, x_mask)
        _update(mesh, opt, param_leaves(params))
        carry = tuple(comm.all_gather_rows(t, mesh.second) for t in stage)
        return (carry,) + sums

    return step, shard_fn


_STACKS = ('kernel', 'recurrent', 'bias')


def make_pipeline_train_step(mesh: Mesh, cfg: LMConfig, n_micro: int,
                             optimizer=None):
    """Return ``(step, shard_fn)`` on the packed layout of
    :func:`pack_pipeline_params` and :func:`pack_carry` (see the module
    docstring).

    ``shard_fn(packed, pcarry)`` takes the whole packed tree and carry
    (numpy or torch) and returns ``(local, opt, carry)``: this rank's
    tree on its device, rank 0's values, as leaves that require grad
    (``char_embedding``, ``context_embeddings`` whole; ``kernel (ls, I,
    4W)``, ``recurrent (ls, W, 4W)``, ``bias (ls, 4W)`` of its stage),
    Adam over those leaves only (``optimizer(local)``, default
    :func:`training.make_optimizer`), and its data rows of its stage's
    carry, a ``(ls, B_loc, W)`` pair.  ``step(local, opt, x, zs, y, mask,
    carry, rng)`` takes this rank's data rows, runs one GPipe step and
    returns ``(carry, loss, nll, acc)`` of the global batch.
    :func:`gather_pipeline_params` and :func:`gather_pipeline_carry`
    bring the whole packed tree and carry back."""
    from ..training import make_optimizer
    staged, layers = _make_staged(mesh, cfg, n_micro)
    make_opt = optimizer or make_optimizer
    p = mesh.second_index

    def shard_fn(packed, pcarry):
        def put(a, group):
            t = torch.as_tensor(_np(a)).to(mesh.device)
            return comm.broadcast(t.contiguous(), 0, group).clone() \
                .requires_grad_()
        local = {'char_embedding': put(packed['char_embedding'],
                                       mesh.world),
                 'context_embeddings': [put(e, mesh.world) for e in
                                        packed['context_embeddings']]}
        for k in _STACKS:
            local[k] = put(_np(packed[k])[p], mesh.data)
        carry = tuple(torch.as_tensor(local_rows(mesh, _np(a)[p], axis=1))
                      .to(mesh.device) for a in pcarry)
        return local, make_opt(local), carry

    def step(local, opt, x, zs, y, mask, carry, rng):
        opt.zero_grad(set_to_none=True)
        # the stage's layers as views of the stacks (layer 0's kernel
        # takes all input rows, the others the first W)
        view = dict(local, lstm={layer: {
            'kernel': local['kernel'][i, :cfg.input_dim if layer == 0
                                      else cfg.width],
            'recurrent': local['recurrent'][i], 'bias': local['bias'][i]}
            for i, layer in enumerate(layers)})
        carry, sums = staged(view, x, zs, y, mask, carry, rng)
        leaves = param_leaves(local)
        _update(mesh, opt, leaves[:-len(_STACKS)], leaves[-len(_STACKS):])
        return (carry,) + sums

    return step, shard_fn


def gather_pipeline_params(mesh: Mesh, local) -> dict:
    """The whole packed numpy tree from every rank's ``local`` tree of
    :func:`make_pipeline_train_step` (collective over ``pipe``)."""
    def whole(t):
        t = comm.all_gather_rows(t.detach(), mesh.second)
        return _np(t.reshape((mesh.shape[PIPE_AXIS], -1)
                             + tuple(t.shape[1:])))
    out = {'char_embedding': _np(local['char_embedding']),
           'context_embeddings': [_np(e) for e in
                                  local['context_embeddings']]}
    out.update({k: whole(local[k]) for k in _STACKS})
    return out


def gather_pipeline_carry(mesh: Mesh, carry):
    """The whole packed ``(n_stages, ls, B, W)`` numpy carry pair from
    every rank's block (collective over the mesh)."""
    out = []
    for t in carry:
        t = comm.all_gather_rows(comm.all_gather_rows(t, mesh.data, dim=1),
                                 mesh.second)
        out.append(_np(t.reshape((mesh.shape[PIPE_AXIS], -1)
                                 + tuple(t.shape[1:]))))
    return tuple(out)


__all__ = ['DATA_AXIS', 'PIPE_AXIS', 'gather_pipeline_carry',
           'gather_pipeline_params', 'make_pipe_mesh',
           'make_pipeline_train_step', 'make_pipeline_train_step_canonical',
           'pack_carry', 'pack_pipeline_params', 'unpack_carry',
           'unpack_pipeline_params']
