"""Sharded batch decoding: the documents of a serving batch split over
the mesh's ``data`` axis.

Counterpart of ``ocrd_keraslm_tpu/parallel/decode.py``.  The document
axis is padded to a multiple of the ``data`` axis with repeats of the
first live document (dropped after), as the JAX package pads it; each
rank decodes its documents through the port's unsharded routing, with
replicated weights and no collective on the search path:

* :func:`make_batch_decode`: the engine (``decode_lattice_device`` with
  a leading document axis, walked on the device);
* :func:`make_fused_batch_decode`: the kernels, ``decode_lattice_batch``
  launched once per block of edges for the rank's documents, with the
  per-shard char-step bounds that the rank's own alternatives give,
  then ``walk_records_batch`` once per block.

:func:`finish` then gathers every document's walk (its choices, the
cumulative costs and the start cost) over ``data`` and emits every
path on every rank, so each rank returns the whole batch's results.
A document's decode is independent of the others in its launch, so
the sharded result equals the unsharded one document for document.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import comm
from .mesh import DATA_AXIS, Mesh


def shard_docs(mesh: Mesh, live: Sequence[int]) -> List[int]:
    """This rank's share of the live documents (indices into the batch)
    after padding to a multiple of the ``data`` axis."""
    n_data = mesh.shape[DATA_AXIS]
    N = -(-len(live) // n_data) * n_data
    fill = [live[i % len(live)] for i in range(N)]
    k = N // n_data
    return fill[mesh.data_index * k:(mesh.data_index + 1) * k]


def make_batch_decode(mesh: Mesh):
    """``fn(rater, raw_list, live, results, context, lm_weight,
    beam_width)``: the engine over this rank's documents; returns the
    sharded pending for :func:`finish`."""
    def fn(rater, raw_list, live, results, context, lm_weight,
           beam_width):
        mine = shard_docs(mesh, live)
        inner = rater._rate_best_batch_engine(
            raw_list, mine, [None] * len(raw_list), context, lm_weight,
            beam_width)
        return ('sharded', mesh, inner, live, raw_list, None, results)
    return fn


def make_fused_batch_decode(mesh: Mesh):
    """``fn(rater, raw_list, merge, sizes, live, maxlen, results, context,
    lm_weight, beam_width)``: the batch kernel and its walk over this
    rank's documents; returns the sharded pending for :func:`finish`."""
    def fn(rater, raw_list, merge, sizes, live, maxlen, results, context,
           lm_weight, beam_width):
        mine = shard_docs(mesh, live)
        prepared: List = [None] * len(raw_list)
        gpending = rater._rate_best_batch_fused_begin(
            raw_list, merge, sizes, prepared, mine, maxlen, context,
            lm_weight, beam_width)
        return ('sharded', mesh, ('fusedb', gpending, prepared,
                                  [None] * len(raw_list)),
                live, raw_list, merge, results)
    return fn


def finish(rater, pending) -> list:
    """Gather the walks of every rank's documents over ``data`` and fill
    ``results[i] = (path, entropy)`` for each live document (collective:
    every rank finishes its batches in the same order)."""
    _, mesh, inner, live, raw_list, merge, results = pending
    walked = rater._batch_walks(inner)
    mine = shard_docs(mesh, live)
    n = comm.all_reduce(torch.tensor([max(len(w[0]) for w in walked)]),
                        mesh.data, 'max')
    n = int(n[0])
    rows = np.zeros((len(walked), 2 + 2 * n), np.float64)
    for row, (choices, costs, start) in zip(rows, walked):
        k = len(choices)
        row[0], row[1] = start, k
        row[2:2 + k] = choices
        row[2 + n:2 + n + k] = costs
    gathered = comm.all_gather_rows(torch.from_numpy(rows), mesh.data)
    gathered = gathered.numpy()
    prepared = inner[2] if inner[0] == 'fusedb' else inner[1]
    own = set(mine)
    for j, i in enumerate(live):   # the first len(live) padded rows
        row = gathered[j]
        k = int(row[1])
        edges = prepared[i] if i in own and prepared[i] is not None \
            else rater._prepare_decode_edges(raw_list[i], merge=merge)
        results[i] = rater._emit_path(edges, row[2:2 + k].astype(np.int64),
                                      row[2 + n:2 + n + k], float(row[0]))
    return results
