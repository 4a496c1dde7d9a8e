"""Sharded generation: the streams of a generation batch split over the
mesh's ``data`` axis.

Counterpart of ``ocrd_keraslm_tpu/parallel/generate.py``.
``ops.beam_device.generate_streams_begin`` takes this path when
``rater.mesh`` is set: the stream count is padded to a multiple of the
``data`` axis (the pad rows repeat stream 0 and are dropped after the
fetch, as the JAX package pads them), every rank takes its streams
through the port's unsharded routing (one ``gen_beam`` and one
``gen_traceback`` launch where a layout takes the model, else the
engine ``generate_device_best``) with replicated weights, and the best
sequences and their costs are gathered back in stream order.  Each
stream's beam is independent of the others, so a sharded answer equals
an unsharded one stream for stream.
"""
from __future__ import annotations

from . import comm
from .mesh import DATA_AXIS, Mesh, local_rows


def data_size(mesh: Mesh) -> int:
    """Number of ranks along the mesh's ``data`` axis."""
    return int(mesh.shape[DATA_AXIS])


def padded_streams(mesh: Mesh, n_streams: int) -> int:
    """The stream count padded to a multiple of the ``data`` axis."""
    n = data_size(mesh)
    return -(-n_streams // n) * n


def make_stream_generate(mesh: Mesh, best):
    """``fn(emb, embT, wcat, bias, prefix_ids (S, P), prefix_mask,
    run_length, out_length, v_real, fringe) -> (seqs (S, run_length),
    costs (S,))``: ``best`` (``gen_kernel.generate_best`` or
    ``beam_device.generate_device_best``) over this rank's streams, the
    results gathered over ``data``; S must be a multiple of the axis
    (:func:`padded_streams`)."""

    def fn(emb, embT, wcat, bias, prefix_ids, prefix_mask, run_length,
           out_length, v_real, fringe):
        seqs, costs = best(emb, embT, wcat, bias,
                           local_rows(mesh, prefix_ids),
                           local_rows(mesh, prefix_mask), run_length,
                           out_length, v_real, fringe=fringe)
        return (comm.all_gather_rows(seqs, mesh.data),
                comm.all_gather_rows(costs, mesh.data))

    return fn
