"""Collectives between the ranks of a mesh.

The JAX package has no file for these: XLA inserts the psums and
all-gathers that sharding propagation asks for.  The port runs one
process per rank, so the same reductions are explicit
``torch.distributed`` calls on a :class:`Group` (the ranks along one
mesh axis, or the whole mesh).

Backends: NCCL where every rank has a card of its own, gloo on the CPU
and wherever ranks share a card (NCCL refuses two ranks on one device).
gloo takes only some collectives on CUDA tensors and send/recv not at
all, so under gloo a CUDA tensor is copied into a pinned host buffer,
reduced or moved there, and copied back; :data:`staged_bytes` counts
both copies and :data:`staged_seconds` their host time (the copy to
the host waits for the device work queued before it).  :data:`seconds`
sums the host time of every collective call, staging included (under
NCCL that is the enqueue only), :data:`calls` their number.

Two ``torch.autograd.Function`` regions carry the vocabulary-parallel
(Megatron-style) softmax of the train step: :class:`CopyToModel`
(identity forward, all-reduce backward, before the vocab-sharded
products) and :class:`ReduceFromModel` (all-reduce forward, identity
backward, after the vocab-sharded lookup and around the partial sums
of the softmax, whose consumers are replicated on the group).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional, Sequence

import torch
import torch.distributed as dist

staged_bytes = 0
staged_seconds = 0.0
seconds = 0.0
calls = 0


def reset_counters() -> None:
    global staged_bytes, staged_seconds, seconds, calls
    staged_bytes, staged_seconds, seconds, calls = 0, 0.0, 0.0, 0


class Group:
    """The ranks along one mesh axis (or all of them): ``ranks`` are
    global ranks in axis order, ``index`` this rank's position among
    them, ``backend`` ``'nccl'`` or ``'gloo'``, ``pg`` the torch process
    group (None for the default group, or for a gloo group of one, which
    needs no collective: :attr:`trivial`)."""

    def __init__(self, ranks: Sequence[int], index: int, backend: str,
                 pg=None, device: Optional[torch.device] = None):
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.backend = backend
        self.pg = pg
        # where NCCL takes a host tensor's collective: the rank's card
        self.device = device

    @property
    def trivial(self) -> bool:
        return self.size == 1 and self.pg is None

    def __repr__(self):
        return 'Group(ranks=%s, index=%d, backend=%s)' % (
            list(self.ranks), self.index, self.backend)


@contextmanager
def _timed():
    global seconds, calls
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds += time.perf_counter() - t0
        calls += 1


def _staged(group: Group, t: torch.Tensor) -> bool:
    return group.backend == 'gloo' and t.is_cuda


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t`` (the copy waits for
    the work that writes ``t``)."""
    global staged_bytes, staged_seconds
    t0 = time.perf_counter()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    staged_bytes += buf.numel() * buf.element_size()
    staged_seconds += time.perf_counter() - t0
    return buf


def _to_device(buf: torch.Tensor, device) -> torch.Tensor:
    global staged_bytes, staged_seconds
    t0 = time.perf_counter()
    out = buf.to(device)
    staged_bytes += buf.numel() * buf.element_size()
    staged_seconds += time.perf_counter() - t0
    return out


def _work_copy(group: Group, t: torch.Tensor) -> torch.Tensor:
    """The buffer a collective runs on: a contiguous copy of ``t`` where
    the backend takes it, a pinned host copy under gloo staging, a copy
    on the rank's card for a host tensor under NCCL."""
    t = t.detach()
    if _staged(group, t):
        return _to_host(t.contiguous())
    if group.backend == 'nccl' and not t.is_cuda:
        return t.to(group.device)
    return t.contiguous().clone()


def _result(group: Group, buf: torch.Tensor, like: torch.Tensor):
    """``buf`` where ``like`` lives."""
    if _staged(group, like):
        return _to_device(buf, like.device)
    return buf.to(like.device)


_OPS = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group: Group, op: str = 'sum'
               ) -> torch.Tensor:
    """A new tensor: the elementwise ``op`` (``'sum'`` or ``'max'``) of
    ``t`` over the group's ranks."""
    if group.trivial:
        return t
    with _timed():
        buf = _work_copy(group, t)
        dist.all_reduce(buf, op=_OPS[op], group=group.pg)
        return _result(group, buf, t)


def all_gather_rows(t: torch.Tensor, group: Group, dim: int = 0
                    ) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    the group's rank order.  Moved as bytes, so any dtype goes."""
    if group.trivial:
        return t
    with _timed():
        moved = t.movedim(dim, 0).contiguous()
        buf = _work_copy(group, moved.reshape(-1).view(torch.uint8))
        outs = [torch.empty_like(buf) for _ in range(group.size)]
        dist.all_gather(outs, buf, group=group.pg)
        cat = _result(group, torch.cat(outs), t)
        shape = (group.size * moved.shape[0],) + tuple(moved.shape[1:])
        return cat.view(t.dtype).reshape(shape).movedim(0, dim)


def broadcast(t: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """A new tensor holding the values of ``t`` on the group's rank at
    index ``src`` (every rank passes a tensor of the same shape)."""
    if group.trivial:
        return t
    with _timed():
        buf = _work_copy(group, t)
        dist.broadcast(buf, group.ranks[src], group=group.pg)
        return _result(group, buf, t)


def send(t: torch.Tensor, dst: int, group: Group) -> None:
    """Send ``t`` to the group's rank at index ``dst`` (blocking)."""
    with _timed():
        dist.send(_work_copy(group, t), group.ranks[dst], group=group.pg)


def recv(like: torch.Tensor, src: int, group: Group) -> torch.Tensor:
    """Receive a tensor shaped and placed like ``like`` from the group's
    rank at index ``src`` (blocking)."""
    with _timed():
        buf = _work_copy(group, like)
        dist.recv(buf, group.ranks[src], group=group.pg)
        return _result(group, buf, like)


def barrier(group: Group, device: Optional[torch.device] = None) -> None:
    """Wait for every rank of the group (one small all-reduce on
    ``device``, which also brings up an NCCL communicator)."""
    if not group.trivial:
        all_reduce(torch.zeros((1,), device=device), group)
        if device is not None and device.type == 'cuda':
            torch.cuda.synchronize(device)


class CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient is summed over the group.  Placed
    before a product with a vocabulary shard: each rank's ``dh`` holds
    its shard's part only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """Sum over the group forward; identity backward.  Placed where
    every rank's partial value enters a result that all ranks then hold
    and differentiate alike (the masked embedding lookup, the softmax's
    partial sums)."""

    @staticmethod
    def forward(ctx, x, group):
        out = all_reduce(x, group)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return grad, None
