"""One LSTM layer's forward recurrence: the CUDA kernel and its plain
PyTorch version.

Counterpart of ``ocrd_keraslm_tpu/ops/lstm_cell.py::
_lstm_scan_pallas_raw`` (forward only, f32).  :func:`lstm_scan` launches
the hand-written kernel ``csrc/lstm_scan.cu`` for CUDA tensors and runs
:func:`lstm_scan_ref`, a Python loop over :func:`lstm_gates`, for CPU
tensors.  Nothing falls back: a CUDA tensor either goes through the
kernel or the call raises.

The input projection ``x @ kernel + bias`` of the whole sequence comes
in precomputed (one large product outside the kernel, as in JAX); the
kernel runs the sequential part.  Gate order i, f, g, o.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

SOURCE = _build.source('lstm_scan.cu')


def gate_math(z: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', c') from the gate pre-activations z (B, 4W) and c (B, W)."""
    W = c.shape[-1]
    i = torch.sigmoid(z[..., 0 * W:1 * W])
    f = torch.sigmoid(z[..., 1 * W:2 * W])
    g = torch.tanh(z[..., 2 * W:3 * W])
    o = torch.sigmoid(z[..., 3 * W:4 * W])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_gates(x_proj: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               recurrent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step given the precomputed input projection.

    x_proj: (B, 4W) = x @ kernel + bias;  h, c: (B, W);
    recurrent: (W, 4W).  Gate order i, f, g, o.  Returns (h', c')."""
    return gate_math(x_proj + h @ recurrent, c)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lstm_scan_launch.argtypes = [P] * 8 + [I] * 3 + [P]
    lib.lstm_scan_launch.restype = ctypes.c_int
    lib.lstm_scan_smem_bytes.argtypes = [I, I]
    lib.lstm_scan_smem_bytes.restype = ctypes.c_size_t
    return lib


def lstm_scan(x_proj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
              recurrent: torch.Tensor, want_c_all: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                         torch.Tensor, torch.Tensor]:
    """Scan one LSTM layer over time.

    x_proj: (B, T, 4W); h0, c0: (B, W); recurrent: (W, 4W); all f32.
    Returns (h_all (T, B, W) time-major, c_all (T, B, W) or None unless
    ``want_c_all``, hT (B, W), cT (B, W))."""
    device = _build.one_device('lstm_scan', (x_proj, h0, c0, recurrent))
    if device.type == 'cpu':
        return lstm_scan_ref(x_proj, h0, c0, recurrent, want_c_all)
    if device.type != 'cuda':
        raise ValueError('lstm_scan runs on cpu or cuda, not %s' % device)
    B, T, G = x_proj.shape
    W = h0.shape[-1]
    if G != 4 * W or W % 4 or B < 1:
        raise ValueError('lstm_scan needs x_proj (B, T, 4W) with B >= 1 '
                         'and W % 4 == 0 (got %s, W=%d)'
                         % (tuple(x_proj.shape), W))
    f32 = torch.float32
    for name, t, shape in (('x_proj', x_proj, (B, T, G)),
                           ('h0', h0, (B, W)), ('c0', c0, (B, W)),
                           ('recurrent', recurrent, (W, G))):
        _build.check(name, t, shape, f32, device)
    h_all = torch.empty((T, B, W), dtype=f32, device=device)
    c_all = (torch.empty((T, B, W), dtype=f32, device=device)
             if want_c_all else None)
    hT = torch.empty((B, W), dtype=f32, device=device)
    cT = torch.empty((B, W), dtype=f32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.lstm_scan_launch(
            x_proj.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            recurrent.data_ptr(), h_all.data_ptr(),
            c_all.data_ptr() if want_c_all else None, hT.data_ptr(),
            cT.data_ptr(), B, T, W, stream)
    if status != 0:
        raise RuntimeError('lstm_scan kernel launch failed: CUDA error %d '
                           '(%d bytes of shared memory asked)'
                           % (status, lib.lstm_scan_smem_bytes(B, W)))
    lstm_scan.launches += 1
    return h_all, c_all, hT, cT


lstm_scan.launches = 0


def lstm_scan_ref(x_proj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                  recurrent: torch.Tensor, want_c_all: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`lstm_scan` (same arguments, same
    outputs): a loop over time of :func:`lstm_gates`."""
    h, c = h0, c0
    hs, cs = [], []
    for t in range(x_proj.shape[1]):
        h, c = lstm_gates(x_proj[:, t], h, c, recurrent)
        hs.append(h)
        cs.append(c)
    B, W = h0.shape

    def stack(seq):
        return (torch.stack(seq) if seq else
                torch.zeros((0, B, W), dtype=h0.dtype, device=h0.device))
    return stack(hs), (stack(cs) if want_c_all else None), h, c
