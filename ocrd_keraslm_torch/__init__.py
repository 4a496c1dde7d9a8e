"""ocrd_keraslm_torch — the PyTorch/CUDA port of ocrd_keraslm_tpu.

Character-level stacked-LSTM language model (char + metadata-context
embeddings, weight-tied softmax) trained, saved to and loaded from the
same h5 checkpoints; the ``ocrd-keraslm-rate`` processor that
beam-decodes the lattice of OCR alternatives in PAGE-XML pages (on the
device, or with the host decode engine for ``device_decoding=false``
and for branching lattices; by default through the native page lane,
a C++ byte scan with splice write-back, with consecutive pages fused
into one kernel launch; ``lookahead_writeback`` walks the pages in
reverse with chained entry slots) or scores their text, standalone or
as a processing server, a spool-queue worker, through a METS server or
on a genuine OCR-D core; batched serving decode of documents; and every
command of ``keraslm-rate`` (training with resumable train-state
snapshots, rating, generation, the charset tools and the embedding
plots), with ``--jax-trace`` device traces.  On
CUDA they run through hand-written kernels (``csrc/decode_lattice.cu``,
``csrc/decode_lattice_batch.cu``, ``csrc/score_scan.cu``,
``csrc/lstm_scan.cu``, ``csrc/lstm_bwd.cu``, ``csrc/gen_beam.cu``,
``csrc/gen_traceback.cu``); its host C++ (``native_src/*.cpp``: the
decode prep, the PAGE scanner, the training windows) is built with
``g++`` at first use (``native.py``).
It never imports JAX or ``ocrd_keraslm_tpu``.
"""
__version__ = '0.1.0'

from .beam import Node
from .rater import Rater

__all__ = ['Rater', 'Node', '__version__']
