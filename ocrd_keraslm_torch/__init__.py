"""ocrd_keraslm_torch — the PyTorch/CUDA port of ocrd_keraslm_tpu.

Character-level stacked-LSTM language model (char + metadata-context
embeddings, weight-tied softmax) trained, saved to and loaded from the
same h5 checkpoints; the ``ocrd-keraslm-rate`` processor that
beam-decodes the lattice of OCR alternatives in PAGE-XML pages or
scores their text; and the ``train``, ``apply``, ``test`` and
``print-history`` commands of ``keraslm-rate``.  On CUDA they run
through hand-written kernels (``csrc/decode_lattice.cu``,
``csrc/score_scan.cu``, ``csrc/lstm_scan.cu``, ``csrc/lstm_bwd.cu``).
It never imports JAX or ``ocrd_keraslm_tpu``.
"""
__version__ = '0.1.0'

from .rater import Rater

__all__ = ['Rater', '__version__']
