"""Sharded scoring: the stream rows of a scoring batch split over the
mesh's ``data`` axis.

Counterpart of ``ocrd_keraslm_tpu/parallel/score.py``.  ``Rater``'s
``_score_batch`` takes this path when ``rater.mesh`` is set, its
``data`` axis is larger than one and divides the batch's row bucket (as
the JAX package decides).  Every rank scores its rows through the
port's unsharded routing (one ``score_scan`` launch per chunk, or one
``lstm_scan`` per layer), with the replicated weights; the rows are
independent streams, so the forward needs no collective.  The per-char
probabilities, NLL sums and final carry are then gathered back into
full row order on every rank.
"""
from __future__ import annotations

from . import comm
from .mesh import Mesh, local_rows


def make_sharded_score_step(mesh: Mesh):
    """``fn(params, cfg, xflat, zs, lens, last, carry, n_chunks,
    packed)``: ``rater._score_stream`` over this rank's rows of the
    full-batch arguments, its outputs gathered over ``data``: (probs
    (C, B, T) float16, NLL sums (B,), carry)."""
    from ..rater import _score_stream

    def fn(params, cfg, xflat, zs, lens, last, carry, n_chunks, packed):
        def rows(a, axis=0):
            return local_rows(mesh, a, axis)
        probs, nll, carry = _score_stream(
            params, cfg, rows(xflat), [rows(z) for z in zs], rows(lens),
            rows(last), tuple(rows(c, 1) for c in carry), n_chunks, packed)
        g = mesh.data
        return (comm.all_gather_rows(probs, g, dim=1),
                comm.all_gather_rows(nll, g),
                tuple(comm.all_gather_rows(c, g, dim=1) for c in carry))

    return fn
