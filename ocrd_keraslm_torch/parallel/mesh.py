"""The rank mesh and the placement of parameters, batches and carries.

Counterpart of ``ocrd_keraslm_tpu/parallel/mesh.py``: a mesh of
``data x <second axis>`` ranks, the second axis ``model`` (tensor
parallelism over the vocabulary of the tied char embedding, the one
dimension of this model family that grows with the task) or ``pipe``
(pipeline stages over the layer stack, ``parallel/pipeline.py``).  Rank
``r`` sits at ``(r // second, r % second)``: data-major, the second
axis on consecutive ranks, as JAX lays out its devices.

A :class:`Mesh` keeps JAX's call-site idiom (``mesh.shape['data']``,
``mesh.shape.get('model', 1)``, ``'pipe' in mesh.axis_names``) and
holds this rank's coordinates and three :class:`comm.Group`s: the whole
mesh, the ranks along ``data`` (same second coordinate) and the ranks
along the second axis (same data coordinate).  Its backend is chosen
once, from the layout: NCCL where every rank has a card of its own,
gloo on the CPU and wherever ranks share a card.

Placement, JAX's shardings made explicit: a rank holds its data share
of the batch rows and of the carry (:func:`shard_batch`,
:func:`shard_carry`), and on the ``model`` axis its shard of the
embedding rows (:func:`shard_params`, the boundaries of JAX's
``P('model', None)``; a vocabulary that the axis does not divide is
refused, as JAX refuses it).  Adam's moments live beside their
parameters, so they are sharded alike (:func:`gather_adam_state` and
:func:`shard_adam_state` carry them to and from the canonical layout of
a snapshot).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm

LOG = logging.getLogger(__name__)

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
PIPE_AXIS = 'pipe'


class Mesh:
    """A ``(data, second)`` grid of ranks; see the module docstring."""

    def __init__(self, n_data: int, n_second: int, second_axis: str,
                 rank: int, device: torch.device, backend: str,
                 world: comm.Group, data: comm.Group,
                 second: comm.Group, multihost: bool):
        self.axis_names = (DATA_AXIS, second_axis)
        self.shape = {DATA_AXIS: n_data, second_axis: n_second}
        self.rank = rank
        self.data_index, self.second_index = divmod(rank, n_second)
        self.device = device
        self.backend = backend
        self.world = world
        self.data = data
        self.second = second
        self.multihost = multihost

    @property
    def n_model(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    def __repr__(self):
        return 'Mesh(%s, rank %d at %s, %s on %s)' % (
            self.shape, self.rank, (self.data_index, self.second_index),
            self.backend, self.device)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              second_axis: str = MODEL_AXIS) -> Mesh:
    """Build a ``(data, second_axis)`` mesh over the ranks of the world,
    ``model_parallel`` of them along ``second_axis``.  Collective: every
    rank calls it with the same arguments.  Outside a process group a
    mesh of one rank joins a world of one; a larger mesh needs the ranks
    (``torchrun``, or the ``KERASLM_*`` variables)."""
    from . import multihost
    n = n_devices or multihost.world_size()
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                'a mesh of %d ranks needs %d processes: launch them with '
                'torchrun --nproc-per-node %d, or set KERASLM_COORDINATOR/'
                'KERASLM_NUM_PROCESSES/KERASLM_PROCESS_ID' % (n, n, n))
        multihost.init_file(multihost.local_store())
    world = dist.get_world_size()
    if n != world:
        raise ValueError('the mesh has %d ranks but the world has %d '
                         'processes: they must be equal' % (n, world))
    if model_parallel < 1 or n % model_parallel:
        raise ValueError('n_devices must be divisible by the %s-axis size'
                         % second_axis)
    lay = multihost.layout()
    device = multihost.rank_device()
    backend = 'nccl' if (lay.cuda and lay.own_cards) else 'gloo'
    if backend == 'nccl' and not dist.is_nccl_available():
        raise RuntimeError('every rank has a card of its own but this '
                           'PyTorch has no NCCL')
    n_data, mp = n // model_parallel, model_parallel
    rank = dist.get_rank()
    d, m = divmod(rank, mp)

    def group(ranks):
        ranks = list(ranks)
        pg = None
        # gloo: the default group serves the whole world, and a group of
        # one needs none; NCCL: a communicator for every group, so that
        # even a world of one runs its collectives through NCCL
        if backend == 'nccl' or 1 < len(ranks) < n:
            pg = dist.new_group(ranks, backend=backend,
                                timeout=multihost.TIMEOUT)
        return comm.Group(ranks, ranks.index(rank) if rank in ranks
                          else -1, backend, pg, device)

    # every rank creates every group, in one order
    world_g = group(range(n))
    data_gs = [group(range(j, n, mp)) for j in range(mp)]
    second_gs = [group(range(i * mp, (i + 1) * mp)) for i in range(n_data)]
    mesh = Mesh(n_data, mp, second_axis, rank, device, backend, world_g,
                data_gs[m], second_gs[d], lay.multihost)
    if backend == 'nccl':
        # bring the communicators up now: a failure raises here, not in
        # the middle of a step
        for g in (mesh.world, mesh.data, mesh.second):
            comm.barrier(g, device)
    LOG.info('mesh %s over %d host(s): backend %s, rank %d on %s',
             mesh.shape, lay.n_hosts, backend, rank, device)
    return mesh


def vocab_range(mesh: Mesh, voc_size: int) -> Tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of the vocabulary: equal shares of
    the ``model`` axis in order.  Raises where the axis does not divide
    the vocabulary (JAX's ``P('model', None)`` refuses it too)."""
    mp = mesh.n_model
    if voc_size % mp:
        raise ValueError(
            'the vocabulary of %d rows is not divisible by the model axis '
            '%d (the embedding is sharded in equal row blocks)'
            % (voc_size, mp))
    k = voc_size // mp
    j = mesh.second_index if mp > 1 else 0
    return j * k, (j + 1) * k


def shard_params(mesh: Mesh, params: dict) -> dict:
    """This rank's parameter tree: its rows of ``char_embedding`` on the
    ``model`` axis, everything else as it is (replicated)."""
    if mesh.n_model == 1:
        return dict(params)
    emb = params['char_embedding']
    lo, hi = vocab_range(mesh, emb.shape[0])
    return dict(params, char_embedding=emb[lo:hi].contiguous())


def gather_params(mesh: Mesh, params: dict) -> dict:
    """The canonical tree from every rank's shard (collective over the
    ``model`` axis; the inverse of :func:`shard_params`)."""
    if mesh.n_model == 1:
        return dict(params)
    return dict(params, char_embedding=comm.all_gather_rows(
        params['char_embedding'].detach(), mesh.second))


def gather_adam_state(mesh: Mesh, optimizer: torch.optim.Optimizer
                      ) -> dict:
    """``optimizer.state_dict()`` with the moments of the embedding shard
    (leaf 0) gathered into the canonical rows (collective over
    ``model``)."""
    state = optimizer.state_dict()
    if mesh.n_model == 1 or 0 not in state['state']:
        return state
    st = dict(state['state'][0])
    for key in ('exp_avg', 'exp_avg_sq'):
        st[key] = comm.all_gather_rows(st[key], mesh.second)
    return dict(state, state={**state['state'], 0: st})


def shard_adam_state(mesh: Mesh, state: dict) -> dict:
    """The inverse of :func:`gather_adam_state`: this rank's rows of the
    embedding's moments in a canonical optimizer state."""
    if mesh.n_model == 1 or 0 not in state['state']:
        return state
    st = dict(state['state'][0])
    lo, hi = vocab_range(mesh, st['exp_avg'].shape[0])
    for key in ('exp_avg', 'exp_avg_sq'):
        st[key] = st[key][lo:hi].contiguous()
    return dict(state, state={**state['state'], 0: st})


def local_rows(mesh: Mesh, arr, axis: int = 0):
    """This rank's rows of a full-batch array (numpy or torch): the
    ``data`` coordinate's equal share along ``axis``; the ranks of one
    ``model`` or ``pipe`` group share their rows."""
    n_data = mesh.shape[DATA_AXIS]
    n = arr.shape[axis]
    if n % n_data:
        raise ValueError('batch of %d rows not divisible by mesh data axis '
                         '%d' % (n, n_data))
    k = n // n_data
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
    out = arr[tuple(sl)]
    return np.ascontiguousarray(out) if isinstance(out, np.ndarray) \
        else out.contiguous()


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a training :class:`data.Batch` (every array's
    first axis; JAX's ``batch_shardings``)."""
    def rows(a):
        return None if a is None else local_rows(mesh, np.asarray(a))
    return dataclasses.replace(
        batch, x=rows(batch.x), zs=[rows(z) for z in batch.zs],
        y=rows(batch.y), mask=rows(batch.mask), x_mask=rows(batch.x_mask))


def shard_carry(mesh: Mesh, carry):
    """This rank's rows of a ``(depth, B, W)`` carry pair (JAX's
    ``carry_sharding``)."""
    return tuple(local_rows(mesh, c, axis=1) for c in carry)
