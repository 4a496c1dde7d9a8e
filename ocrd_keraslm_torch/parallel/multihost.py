"""Joining the process group, the layout of the ranks on their hosts,
and the global mesh.

Counterpart of ``ocrd_keraslm_tpu/parallel/multihost.py``.  JAX has two
kinds of mesh: one process driving every local device, and one process
per host (``jax.distributed``).  PyTorch's idiom is one process per
rank, so in the port every mesh is a ``torch.distributed`` group and the
program is SPMD: every rank runs the same command, draws the same full
batches and works on its own rows (:func:`local_rows`), as the JAX
package's multihost training loop does.

A rank joins the group in one of two ways:

* through the JAX package's variables, :func:`init_multihost`:
  ``KERASLM_COORDINATOR`` (``host:port`` of rank 0),
  ``KERASLM_NUM_PROCESSES``, ``KERASLM_PROCESS_ID``;
  ``KERASLM_MULTIHOST`` (a boolean flag) alone reads the standard
  ``torchrun`` variables instead;
* through the ``torchrun`` variables (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``), :func:`join_from_env`.

The default group is gloo: it forms the world and carries the small
host-side agreements (the layout below, seeds).  Each mesh then makes
its own groups with the backend that its layout allows
(``parallel/mesh.py``).

Layout: a rank's host peers are read from ``LOCAL_WORLD_SIZE`` and
``LOCAL_RANK`` where ``torchrun`` set them, else from the host names
that every rank reports at the join.  A world whose ranks all run on one
host stands for the JAX package's single-controller mesh (pipeline
meshes and train-state snapshots allowed); a world over several hosts is
its multihost case, with its refusals.  A rank's device is
``cuda:{local_rank % device_count}``, or the CPU where
``KERASLM_PLATFORM=cpu`` asks for it: a rank never moves its work to the
CPU by itself.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import random
import socket
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import comm
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, local_rows, make_mesh

LOG = logging.getLogger(__name__)

# every rendezvous and collective gives up after this long: a world that
# never forms (one rank raised before it joined) fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the ranks of the world run: this rank's index among its
    host's ranks and their number, the number of hosts, whether this
    rank computes on CUDA, and whether NCCL can serve the world (every
    rank has a card of its own)."""
    local_rank: int
    local_world_size: int
    n_hosts: int
    cuda: bool
    own_cards: bool

    @property
    def multihost(self) -> bool:
        return self.n_hosts > 1


_LAYOUT: Optional[Layout] = None


def _flag(name: str) -> bool:
    """A boolean environment flag: unset, '', '0', 'false' and 'no' are
    off."""
    return os.environ.get(name, '').strip().lower() not in (
        '', '0', 'false', 'no')


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Join (or create) the process group.

    No-op when already in one.  With no arguments, reads the
    ``KERASLM_*`` variables; with none of those set, the ``torchrun``
    variables (the counterpart of JAX's cluster auto-detection), and
    raises RuntimeError where there are none either.  A partial
    configuration raises ValueError with the JAX package's wording."""
    if dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get('KERASLM_COORDINATOR')
    if num_processes is None:
        n = os.environ.get('KERASLM_NUM_PROCESSES')
        num_processes = int(n) if n else None
    if process_id is None:
        p = os.environ.get('KERASLM_PROCESS_ID')
        process_id = int(p) if p else None
    if not coordinator and (num_processes is not None
                            or process_id is not None):
        raise ValueError(
            'KERASLM_NUM_PROCESSES/KERASLM_PROCESS_ID are set but '
            'KERASLM_COORDINATOR is not — refusing to silently '
            'auto-detect (each process would train independently)')
    if coordinator and (num_processes is None or process_id is None):
        raise ValueError(
            'KERASLM_COORDINATOR is set but KERASLM_NUM_PROCESSES/'
            'KERASLM_PROCESS_ID are not — an explicit coordinator '
            'needs both (auto-detected environments should set none '
            'of the three)')
    if coordinator:
        _join('tcp://' + coordinator, num_processes, process_id)
    elif _torchrun_env():
        _join('env://', int(os.environ['WORLD_SIZE']),
              int(os.environ['RANK']))
    else:
        raise RuntimeError(
            'no cluster environment detected: neither KERASLM_COORDINATOR '
            'nor the torchrun variables (RANK, WORLD_SIZE, MASTER_ADDR, '
            'MASTER_PORT) are set')


def init_file(store: str, num_processes: int = 1,
              process_id: int = 0) -> None:
    """Join a group whose rendezvous is the file ``store`` (every rank
    passes the same path on a shared file system; a world of one needs
    no other process).  No-op when already in a group."""
    if not dist.is_initialized():
        _join('file://' + os.path.abspath(store), num_processes,
              process_id)


def join_from_env() -> bool:
    """Join the group that the environment describes (the ``KERASLM_*``
    variables or ``KERASLM_MULTIHOST``, else ``torchrun``'s); returns
    whether this process is now in a group.  The command line calls it
    first, before any device work."""
    if _flag('KERASLM_MULTIHOST') or any(os.environ.get(v) for v in (
            'KERASLM_COORDINATOR', 'KERASLM_NUM_PROCESSES',
            'KERASLM_PROCESS_ID')):
        init_multihost()
    elif _torchrun_env() and not dist.is_initialized():
        _join('env://', int(os.environ['WORLD_SIZE']),
              int(os.environ['RANK']))
    return dist.is_initialized()


def _torchrun_env() -> bool:
    return all(os.environ.get(v) for v in ('RANK', 'WORLD_SIZE',
                                           'MASTER_ADDR', 'MASTER_PORT'))


def _join(init_method: str, world_size: int, rank: int) -> None:
    global _LAYOUT
    if not 0 <= rank < world_size:
        raise ValueError('process id %d outside a world of %d'
                         % (rank, world_size))
    dist.init_process_group('gloo', init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    _LAYOUT = None
    lay = layout()
    if lay.cuda:
        torch.cuda.set_device(rank_device())
    LOG.info('rank %d of %d joined (%d host(s), local rank %d of %d)',
             rank, world_size, lay.n_hosts, lay.local_rank,
             lay.local_world_size)


def layout() -> Layout:
    """The world's :class:`Layout` (collective at its first call after
    the join: every rank reports its host and cards)."""
    global _LAYOUT
    if _LAYOUT is not None:
        return _LAYOUT
    from ..rater import resolve_device
    cuda = resolve_device().type == 'cuda'
    n_cards = torch.cuda.device_count() if cuda else 0
    if not dist.is_initialized():
        return Layout(0, 1, 1, cuda, True)
    lws = os.environ.get('LOCAL_WORLD_SIZE')
    me = (socket.gethostname(), cuda, n_cards)
    peers = [None] * dist.get_world_size()
    dist.all_gather_object(peers, me)
    rank = dist.get_rank()
    if lws:
        local_world_size = int(lws)
        local_rank = int(os.environ.get('LOCAL_RANK',
                                        rank % local_world_size))
        n_hosts = -(-len(peers) // local_world_size)
    else:
        local_world_size = sum(p[0] == me[0] for p in peers)
        local_rank = sum(p[0] == me[0] for p in peers[:rank])
        n_hosts = len({p[0] for p in peers})
    own_cards = all(p[1] for p in peers) and all(
        sum(q[0] == p[0] for q in peers) <= p[2] for p in peers)
    _LAYOUT = Layout(local_rank, local_world_size, n_hosts, cuda,
                     own_cards)
    return _LAYOUT


def rank_device() -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}``, or the
    CPU where the caller asked for it."""
    lay = layout()
    if not lay.cuda:
        return torch.device('cpu')
    return torch.device('cuda', lay.local_rank % torch.cuda.device_count())


def is_multihost() -> bool:
    """Whether the world spans more than one host."""
    return dist.is_initialized() and layout().multihost


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(model_parallel: int = 1) -> Mesh:
    """(data, model) mesh over every rank of the world, data-major, with
    the ``model`` axis on consecutive ranks of one host so that its
    collectives never cross hosts."""
    per_host = layout().local_world_size
    if model_parallel > per_host or per_host % model_parallel:
        raise ValueError('model axis must fit inside one host (%d ranks/'
                         'host)' % per_host)
    return make_mesh(world_size(), model_parallel)


def global_batch(mesh: Mesh, x_local, zs_local, y_local, mask_local,
                 carry_local):
    """This rank's ``(x, zs, y, mask, carry)`` for the sharded steps,
    from its local rows (numpy or torch): JAX's ``global_batch``, which
    assembles the globally sharded arrays from every process's rows.  A
    rank holds its ``data`` share already, so its rows stay its own,
    moved to its device (inputs, contexts and targets as int64, the mask
    and the carry as float32); ``carry_local`` is its ``(depth, B_loc,
    W)`` rows, those :func:`mesh.shard_carry` gives it from the whole
    carry.  The ranks along the second axis share a data row and take
    the rows of its first rank.  Raises unless every rank passes rows of
    the same shapes (JAX builds the global shape as the local one times
    the process count).  Collective."""
    arrays = [x_local] + list(zs_local) + [y_local, mask_local] \
        + list(carry_local)
    shapes = [tuple(a.shape) if torch.is_tensor(a) else np.shape(a)
              for a in arrays]
    if world_size() > 1:
        every = [None] * world_size()
        dist.all_gather_object(every, shapes)
        if any(s != shapes for s in every):
            raise ValueError('every process passes local rows of the same '
                             'shapes; got %s' % every)

    def put(a, dtype):
        t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
        t = t.to(device=mesh.device, dtype=dtype).contiguous()
        return comm.broadcast(t, 0, mesh.second)
    n = len(zs_local)
    x, *zs = [put(a, torch.int64) for a in arrays[:n + 1]]
    y = put(y_local, torch.int64)
    mask = put(mask_local, torch.float32)
    carry = tuple(put(c, torch.float32) for c in carry_local)
    return x, zs, y, mask, carry


def align_seed() -> None:
    """Seed numpy's and Python's global generators with rank 0's draw on
    every rank: the file order (``random.shuffle``), the window split,
    the data seeds and the dropout seed all come from them, and every
    rank must draw alike."""
    if world_size() == 1:
        return
    box = [int(np.random.randint(0, 2 ** 31 - 1))]
    dist.broadcast_object_list(box, src=0)
    np.random.seed(box[0])
    random.seed(box[0])


def shutdown() -> None:
    """Leave the process group (every rank calls it)."""
    global _LAYOUT
    if dist.is_initialized():
        dist.destroy_process_group()
    _LAYOUT = None


def local_store(tag: str = 'keraslm') -> str:
    """A fresh file path for the rendezvous of a world of one."""
    fd, path = tempfile.mkstemp(prefix=tag + '_store_')
    os.close(fd)
    os.unlink(path)
    return path


__all__ = ['DATA_AXIS', 'MODEL_AXIS', 'Layout', 'align_seed', 'global_batch',
           'init_file', 'init_multihost', 'is_multihost', 'join_from_env',
           'layout', 'local_rows', 'local_store', 'make_global_mesh', 'rank',
           'rank_device', 'shutdown', 'world_size']
