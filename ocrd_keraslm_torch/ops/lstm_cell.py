"""One LSTM layer's recurrence, forward and backward: the CUDA kernels
and their plain PyTorch versions.

Counterpart of ``ocrd_keraslm_tpu/ops/lstm_cell.py``:

* :func:`lstm_scan` (``_lstm_scan_pallas_raw``) launches the
  hand-written kernel ``csrc/lstm_scan.cu`` for CUDA tensors (on
  thread-block clusters laid out by :mod:`.scan_layout`) and runs
  :func:`lstm_scan_ref`, a Python loop over :func:`lstm_gates`, for CPU
  tensors;
* :func:`lstm_bwd` (``_lstm_bwd_pallas``) launches ``csrc/lstm_bwd.cu``
  for CUDA tensors (its chain on thread-block clusters laid out by
  :mod:`.scan_layout`, kind ``bwd``) and runs :func:`lstm_bwd_ref`, an
  explicit reverse loop, for CPU tensors;
* :class:`LSTMScan` (the ``lstm_scan_pallas`` custom VJP) is the
  ``torch.autograd.Function`` over the two.

Nothing falls back: a CUDA tensor either goes through the kernel or the
call raises.

The input projection ``x @ kernel + bias`` of the whole sequence comes
in precomputed (one large product outside the kernel, as in JAX); the
kernels run the sequential part.  Gate order i, f, g, o.  The recurrent
weight U is float32 or bfloat16: under a bfloat16 U the h operand of
``h @ U`` is rounded to bfloat16, the products are summed in float32,
and gates, carry and outputs stay float32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, scan_layout

SOURCE = _build.source('lstm_scan.cu')
BWD_SOURCE = _build.source('lstm_bwd.cu')


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
    recurrent: (W, 4W), float32 or bfloat16 (then h is rounded to
    bfloat16 for the product, which is summed in x_proj's dtype).  Gate
    order i, f, g, o.  Returns (h', c')."""
    return gate_math(x_proj + recurrent_product(h, recurrent), c)


def recurrent_product(h: torch.Tensor, recurrent: torch.Tensor
                      ) -> torch.Tensor:
    """``h @ recurrent`` in h's dtype; under a bfloat16 ``recurrent``
    with h rounded to bfloat16 first (exact products of bfloat16 values,
    summed in h's dtype: what JAX's ``preferred_element_type=float32``
    gives, and not ``h.bfloat16() @ recurrent``, whose result PyTorch
    rounds to bfloat16)."""
    if recurrent.dtype == torch.bfloat16:
        return h.to(torch.bfloat16).to(h.dtype) @ recurrent.to(h.dtype)
    return h @ recurrent


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.lstm_scan_launch.argtypes = [P] * 9 + [I] * 8 + [S, P]
    lib.lstm_scan_launch.restype = ctypes.c_int
    lib.lstm_scan_max_clusters.argtypes = [I] * 5 + [S]
    lib.lstm_scan_max_clusters.restype = ctypes.c_int
    return lib


def clusters_that_fit(index: int, W: int, bf16: bool,
                      layout: scan_layout.Layout) -> int:
    """How many clusters of the register ``layout`` card ``index`` holds
    at once."""
    with torch.cuda.device(index):
        return _library().lstm_scan_max_clusters(
            W, int(bf16), layout.rb, layout.cl, layout.rt, layout.smem)


@functools.lru_cache(maxsize=None)
def _layout(index: int, B: int, W: int, bf16: bool) -> scan_layout.Layout:
    lay = scan_layout.choose(
        'lstm', B, W, 1, lambda lay: clusters_that_fit(index, W, bf16, lay),
        torch.cuda.get_device_properties(index).multi_processor_count,
        bf16=bf16)
    scan_layout.check('lstm', B, W, 1, lay, bf16=bf16)
    return lay


def scan_layout_on(device: torch.device, B: int, W: int,
                   bf16: bool) -> scan_layout.Layout:
    """The layout :func:`lstm_scan` launches B streams of width W with on
    the CUDA ``device`` (:func:`scan_layout.choose` with the card's SMs
    and cluster occupancy; chosen once per device and shape)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _layout(index, B, W, bool(bf16))


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    S = ctypes.c_size_t
    lib.lstm_bwd_launch.argtypes = [P] * 15 + [I] * 8 + [S, P]
    lib.lstm_bwd_launch.restype = ctypes.c_int
    lib.lstm_bwd_splits.argtypes = [I, I]
    lib.lstm_bwd_splits.restype = ctypes.c_int
    lib.lstm_bwd_smem_bytes.argtypes = [I, I, I, I]
    lib.lstm_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.lstm_bwd_max_clusters.argtypes = [I] * 4 + [S]
    lib.lstm_bwd_max_clusters.restype = ctypes.c_int
    return lib


def bwd_clusters_that_fit(index: int, W: int,
                          layout: scan_layout.Layout) -> int:
    """How many clusters of the backward's register ``layout`` card
    ``index`` holds at once."""
    with torch.cuda.device(index):
        return _bwd_library().lstm_bwd_max_clusters(
            W, layout.rb, layout.cl, layout.rt, layout.smem)


@functools.lru_cache(maxsize=None)
def _bwd_layout(index: int, B: int, W: int) -> scan_layout.Layout:
    lay = scan_layout.choose(
        'bwd', B, W, 1, lambda lay: bwd_clusters_that_fit(index, W, lay),
        torch.cuda.get_device_properties(index).multi_processor_count)
    scan_layout.check('bwd', B, W, 1, lay)
    return lay


def bwd_layout_on(device: torch.device, B: int,
                  W: int) -> scan_layout.Layout:
    """The layout :func:`lstm_bwd` runs the chain of B streams of width W
    in on the CUDA ``device`` (:func:`scan_layout.choose`, kind ``bwd``;
    chosen once per device and shape; the same for f32 and bf16 U)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _bwd_layout(index, B, W)


def _mode(layout: scan_layout.Layout) -> int:
    """The layout as the sources' launch functions take it: 0 the
    one-block layout, 1 the register layout, 2 the grid layout
    (``MODE_*`` in ``csrc/scan_common.cuh``)."""
    return 2 if layout.grid else int(layout.reg)


def _group_flags(layout: scan_layout.Layout, B: int,
                 device: torch.device) -> torch.Tensor:
    """The grid layout's scratch: one counter a group of streams (the
    launch zeroes them); empty for the other layouts."""
    n = -(-B // layout.rb) if layout.grid else 0
    return torch.empty((n,), dtype=torch.int32, device=device)


def _weight_dtype(name: str, recurrent: torch.Tensor) -> bool:
    """Whether ``recurrent`` is bfloat16; raises unless it is that or
    float32 (what the kernels take)."""
    if recurrent.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError('%s: recurrent has dtype %s, expected float32 or '
                         'bfloat16' % (name, recurrent.dtype))
    return recurrent.dtype == torch.bfloat16


def lstm_scan(x_proj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
              recurrent: torch.Tensor, want_c_all: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                         torch.Tensor, torch.Tensor]:
    """Scan one LSTM layer over time.

    x_proj: (B, T, 4W), h0, c0: (B, W), f32; recurrent: (W, 4W), f32 or
    bf16.  Returns (h_all (T, B, W) time-major, c_all (T, B, W) or None unless
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
    bf16 = _weight_dtype('lstm_scan', recurrent)
    for name, t, shape in (('x_proj', x_proj, (B, T, G)),
                           ('h0', h0, (B, W)), ('c0', c0, (B, W))):
        _build.check(name, t, shape, f32, device)
    _build.check('recurrent', recurrent, (W, G), recurrent.dtype, device)
    h_all = torch.empty((T, B, W), dtype=f32, device=device)
    c_all = (torch.empty((T, B, W), dtype=f32, device=device)
             if want_c_all else None)
    hT = torch.empty((B, W), dtype=f32, device=device)
    cT = torch.empty((B, W), dtype=f32, device=device)
    lib = _library()
    lay = scan_layout_on(device, B, W, bf16)
    flags = _group_flags(lay, B, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.lstm_scan_launch(
            x_proj.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            recurrent.data_ptr(), h_all.data_ptr(),
            c_all.data_ptr() if want_c_all else None, hT.data_ptr(),
            cT.data_ptr(), flags.data_ptr() if lay.grid else None, B, T, W,
            int(bf16), lay.rb, lay.cl, lay.rt, _mode(lay), lay.smem, stream)
    if status != 0:
        raise RuntimeError('lstm_scan kernel launch failed: CUDA error %d '
                           '(layout %s)' % (status, lay))
    _build.count(lstm_scan)
    return h_all, c_all, hT, cT


lstm_scan.launches = 0


def lstm_scan_ref(x_proj: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                  recurrent: torch.Tensor, want_c_all: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`lstm_scan` (same arguments, same
    outputs): a loop over time of :func:`lstm_gates`, in x_proj's dtype
    (a float64 x_proj gives the float64 run that accuracy is held
    against; a bfloat16 ``recurrent`` rounds h either way)."""
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


def lstm_bwd(xp_tm: torch.Tensor, hprev_tm: torch.Tensor,
             cprev_tm: torch.Tensor, call_tm: torch.Tensor,
             dhout_tm: torch.Tensor, recurrent: torch.Tensor,
             dhT: torch.Tensor, dcT: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Backward of :func:`lstm_scan` over time-major sequences.

    xp_tm: (T, B, 4W) the input projection; hprev_tm, cprev_tm: (T, B, W)
    the states before each step (row 0 is (h0, c0)); call_tm: (T, B, W)
    the cell states after each step; dhout_tm: (T, B, W) the cotangent
    of h_all; dhT, dcT: (B, W) the cotangents of the final carry; all
    f32.  recurrent: (W, 4W), f32 or bf16.  The gates are recomputed
    from the saved states.  Returns (dxp_tm (T, B, 4W), dU (W, 4W) f32,
    dh0 (B, W), dc0 (B, W))."""
    tensors = (xp_tm, hprev_tm, cprev_tm, call_tm, dhout_tm, recurrent,
               dhT, dcT)
    device = _build.one_device('lstm_bwd', tensors)
    if device.type == 'cpu':
        return lstm_bwd_ref(*tensors)
    if device.type != 'cuda':
        raise ValueError('lstm_bwd runs on cpu or cuda, not %s' % device)
    T, B, G = xp_tm.shape
    W = dhT.shape[-1]
    if G != 4 * W or W % 4 or B < 1:
        raise ValueError('lstm_bwd needs xp_tm (T, B, 4W) with B >= 1 and '
                         'W % 4 == 0 (got %s, W=%d)'
                         % (tuple(xp_tm.shape), W))
    f32 = torch.float32
    bf16 = _weight_dtype('lstm_bwd', recurrent)
    for name, t, shape in (('xp_tm', xp_tm, (T, B, G)),
                           ('hprev_tm', hprev_tm, (T, B, W)),
                           ('cprev_tm', cprev_tm, (T, B, W)),
                           ('call_tm', call_tm, (T, B, W)),
                           ('dhout_tm', dhout_tm, (T, B, W)),
                           ('dhT', dhT, (B, W)), ('dcT', dcT, (B, W))):
        _build.check(name, t, shape, f32, device)
    _build.check('recurrent', recurrent, (W, G), recurrent.dtype, device)
    lib = _bwd_library()
    # the weight's values as f32, transposed (4W, W): outside the kernel,
    # as in JAX
    recT = recurrent.T.to(f32).contiguous()
    dxp = torch.empty((T, B, G), dtype=f32, device=device)
    dU = torch.empty((W, G), dtype=f32, device=device)
    dh0 = torch.empty((B, W), dtype=f32, device=device)
    dc0 = torch.empty((B, W), dtype=f32, device=device)
    part = torch.empty((lib.lstm_bwd_splits(B, T), W, G), dtype=f32,
                       device=device)
    lay = bwd_layout_on(device, B, W)
    flags = _group_flags(lay, B, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.lstm_bwd_launch(
            xp_tm.data_ptr(), hprev_tm.data_ptr(), cprev_tm.data_ptr(),
            call_tm.data_ptr(), dhout_tm.data_ptr(), recurrent.data_ptr(),
            recT.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), dxp.data_ptr(),
            dU.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), part.data_ptr(),
            flags.data_ptr() if lay.grid else None, B, T, W, int(bf16),
            lay.rb, lay.cl, lay.rt, _mode(lay), lay.smem, stream)
    if status != 0:
        raise RuntimeError('lstm_bwd kernel launch failed: CUDA error %d '
                           '(layout %s)' % (status, lay))
    _build.count(lstm_bwd)
    return dxp, dU, dh0, dc0


lstm_bwd.launches = 0


def lstm_bwd_ref(xp_tm: torch.Tensor, hprev_tm: torch.Tensor,
                 cprev_tm: torch.Tensor, call_tm: torch.Tensor,
                 dhout_tm: torch.Tensor, recurrent: torch.Tensor,
                 dhT: torch.Tensor, dcT: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Plain PyTorch version of :func:`lstm_bwd` (same arguments, same
    outputs): an explicit loop over time in reverse, in xp_tm's dtype,
    with no call to autograd."""
    T, B, G = xp_tm.shape
    W = G // 4
    dtype = xp_tm.dtype
    rec = recurrent.to(dtype)
    recT = rec.T
    quantize = recurrent.dtype == torch.bfloat16
    dh, dc = dhT, dcT
    dU = torch.zeros((W, G), dtype=dtype, device=xp_tm.device)
    dxp = []
    for t in range(T - 1, -1, -1):
        c_prev, c_cur = cprev_tm[t], call_tm[t]
        # z from the same operands as the forward, so the gates are the
        # forward's
        hq = hprev_tm[t]
        if quantize:
            hq = hq.to(torch.bfloat16).to(dtype)
        z = xp_tm[t] + hq @ rec
        i = torch.sigmoid(z[:, 0 * W:1 * W])
        f = torch.sigmoid(z[:, 1 * W:2 * W])
        g = torch.tanh(z[:, 2 * W:3 * W])
        o = torch.sigmoid(z[:, 3 * W:4 * W])
        dh_total = dhout_tm[t] + dh
        tc = torch.tanh(c_cur)
        do = dh_total * tc
        dc_total = dc + dh_total * o * (1.0 - tc * tc)
        di = dc_total * g
        df = dc_total * c_prev
        dg = dc_total * i
        dz = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                        dg * (1.0 - g * g), do * o * (1.0 - o)], dim=1)
        dxp.append(dz)
        dh = dz @ recT
        dc = dc_total * f
        # dU sees the rounded h (the derivative goes through the cast)
        dU = dU + hq.T @ dz
    dxp.reverse()
    dxp_tm = (torch.stack(dxp) if dxp else
              torch.zeros((0, B, G), dtype=dtype, device=xp_tm.device))
    return dxp_tm, dU, dh, dc


class LSTMScan(torch.autograd.Function):
    """:func:`lstm_scan` with :func:`lstm_bwd` as its backward: ``(x_proj
    (B, T, 4W), h0, c0, recurrent) -> (h_all (T, B, W) time-major, hT,
    cT)``.  The forward keeps ``c_all`` for the backward, which
    recomputes the gates; the cotangent of a bfloat16 ``recurrent`` is
    bfloat16, as in JAX."""

    @staticmethod
    def forward(ctx, x_proj, h0, c0, recurrent):
        h_all, c_all, hT, cT = lstm_scan(x_proj, h0, c0, recurrent,
                                         want_c_all=True)
        ctx.save_for_backward(x_proj, h0, c0, recurrent, h_all, c_all)
        return h_all, hT, cT

    @staticmethod
    def backward(ctx, dh_all, dhT, dcT):
        x_proj, h0, c0, recurrent, h_all, c_all = ctx.saved_tensors
        # the states before each step: row 0 is the initial carry
        hprev = torch.cat([h0[None], h_all[:-1]])
        cprev = torch.cat([c0[None], c_all[:-1]])
        dxp_tm, dU, dh0, dc0 = lstm_bwd(
            x_proj.transpose(0, 1).contiguous(), hprev, cprev, c_all,
            dh_all.contiguous(), recurrent, dhT.contiguous(),
            dcT.contiguous())
        return dxp_tm.transpose(0, 1), dh0, dc0, dU.to(recurrent.dtype)
