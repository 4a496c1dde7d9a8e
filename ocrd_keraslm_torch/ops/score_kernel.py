"""Teacher-forced chunk scoring: the CUDA kernel and its plain PyTorch
version.

Counterpart of ``ocrd_keraslm_tpu/ops/score_kernel.py::
score_scan_pallas`` and ``pack_score_weights``.  :func:`score_scan`
launches the hand-written kernels of ``csrc/score_scan.cu`` for CUDA
tensors (in the layout :mod:`.scan_layout` chooses: the recurrence on
thread-block clusters, then the tied softmax and the NLL sums over all
steps at once; or one block of streams running all of a step) and runs :func:`score_scan_ref`, the same function in
plain PyTorch, for CPU tensors.  Nothing falls back: a CUDA tensor
either goes through the kernels or the call raises.

One call scores one chunk of T steps of B independent streams: all D
LSTM layers (layer 0's input projection comes in precomputed), the
tied-softmax logits masked at ``v_real``, the true next char's
probability and NLL per step, the per-stream NLL sums, and the
``(D, B, W)`` carry in and out.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build, scan_layout
from .lstm_cell import gate_math

BIG = 1.0e30
LANE = 128

SOURCE = _build.source('score_scan.cu')


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.score_scan_launch.argtypes = [P] * 16 + [I] * 10 + [S, P]
    lib.score_scan_launch.restype = ctypes.c_int
    lib.score_scan_max_clusters.argtypes = [I] * 5 + [S]
    lib.score_scan_max_clusters.restype = ctypes.c_int
    return lib


def clusters_that_fit(index: int, D: int, W: int,
                      layout: scan_layout.Layout) -> int:
    """How many clusters of the register ``layout`` card ``index`` holds
    at once."""
    with torch.cuda.device(index):
        return _library().score_scan_max_clusters(
            D, W, layout.rb, layout.cl, layout.rt, layout.smem)


@functools.lru_cache(maxsize=None)
def _layout(index: int, B: int, W: int, D: int,
            Vp: int) -> scan_layout.Layout:
    lay = scan_layout.choose(
        'score', B, W, D, lambda lay: clusters_that_fit(index, D, W, lay),
        torch.cuda.get_device_properties(index).multi_processor_count, Vp=Vp)
    scan_layout.check('score', B, W, D, lay, Vp=Vp)
    return lay


def scan_layout_on(device: torch.device, B: int, W: int, D: int,
                   Vp: int) -> scan_layout.Layout:
    """The layout :func:`score_scan` launches B streams of a D-layer
    model of width W (``embT`` of Vp columns) with on the CUDA
    ``device`` (:func:`scan_layout.choose` with the card's SMs and
    cluster occupancy; chosen once per device and shape)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _layout(index, B, W, D, Vp)


def pack_score_weights(params, cfg):
    """The kernel's weight operands: layer 0's recurrent kernel (W, 4W);
    the stacked input and recurrent kernels (max(D-1, 1), W, 4W) and
    biases (max(D-1, 1), 1, 4W) of layers >= 1 (zeros at D=1, which
    keep the signature); the vocab-padded transposed tied embedding
    (W, Vp), Vp a multiple of 128; and ``v_real``.  Raises ValueError
    for a model of several widths or a head bias."""
    from ..models.lstm_lm import require_uniform
    require_uniform(cfg, 'the scoring kernel')
    W = cfg.width
    lstm = params['lstm']
    emb = params['char_embedding']
    device = emb.device
    if cfg.depth > 1:
        kcat = torch.stack([lstm[d]['kernel'] for d in range(1, cfg.depth)])
        ucat = torch.stack([lstm[d]['recurrent']
                            for d in range(1, cfg.depth)])
        bias = torch.stack([lstm[d]['bias'][None, :]
                            for d in range(1, cfg.depth)])
    else:
        kcat = torch.zeros((1, W, 4 * W), dtype=torch.float32,
                           device=device)
        ucat = torch.zeros_like(kcat)
        bias = torch.zeros((1, 1, 4 * W), dtype=torch.float32,
                           device=device)
    v_real = emb.shape[0]
    v_pad = -(-max(v_real, LANE) // LANE) * LANE
    embT = torch.zeros((W, v_pad), dtype=torch.float32, device=device)
    embT[:, :v_real] = emb.T
    return (lstm[0]['recurrent'].contiguous(), kcat.contiguous(),
            ucat.contiguous(), bias.contiguous(), embT, v_real)


def score_scan(xp1: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
               h0: torch.Tensor, c0: torch.Tensor, rec1: torch.Tensor,
               kcat: torch.Tensor, ucat: torch.Tensor, bias: torch.Tensor,
               embT: torch.Tensor, v_real: int
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Tuple[torch.Tensor, torch.Tensor]]:
    """Fused scoring of one chunk.

    xp1: (B, T, 4W) layer-0 input projection (embed @ K0 + b0);
    y: (B, T) int32 targets, 0 <= y < v_real; mask: (B, T) f32;
    h0, c0: (D, B, W) carry; rec1: (W, 4W); kcat, ucat:
    (max(D-1, 1), W, 4W); bias: (max(D-1, 1), 1, 4W); embT: (W, Vp)
    with rows of the embedding beyond ``v_real`` padding.

    Returns (probs (B, T) f32, per-stream NLL sums (B,) f32,
    (hT, cT) each (D, B, W))."""
    device = _build.one_device('score_scan', (xp1, y, mask, h0, c0, rec1,
                                              kcat, ucat, bias, embT))
    if device.type == 'cpu':
        return score_scan_ref(xp1, y, mask, h0, c0, rec1, kcat, ucat, bias,
                              embT, v_real)
    if device.type != 'cuda':
        raise ValueError('score_scan runs on cpu or cuda, not %s' % device)
    B, T, G = xp1.shape
    D, _, W = h0.shape
    Vp = embT.shape[1]
    Dw = kcat.shape[0]
    if G != 4 * W or W % 4 or B < 1 or Dw != max(D - 1, 1) or \
            not 0 < v_real <= Vp:
        raise ValueError('score_scan needs xp1 (B, T, 4W) with B >= 1, '
                         'W % 4 == 0, kcat of max(D-1, 1) layers and '
                         '0 < v_real <= Vp (got xp1 %s, carry %s, kcat %s, '
                         'v_real %d, Vp %d)'
                         % (tuple(xp1.shape), tuple(h0.shape),
                            tuple(kcat.shape), v_real, Vp))
    f32 = torch.float32
    for name, t, shape, dtype in (
            ('xp1', xp1, (B, T, G), f32), ('y', y, (B, T), torch.int32),
            ('mask', mask, (B, T), f32), ('h0', h0, (D, B, W), f32),
            ('c0', c0, (D, B, W), f32), ('rec1', rec1, (W, G), f32),
            ('kcat', kcat, (Dw, W, G), f32), ('ucat', ucat, (Dw, W, G), f32),
            ('bias', bias, (Dw, 1, G), f32), ('embT', embT, (W, Vp), f32)):
        _build.check(name, t, shape, dtype, device)
    probs = torch.empty((B, T), dtype=f32, device=device)
    nll = torch.empty((B,), dtype=f32, device=device)
    hT = torch.empty((D, B, W), dtype=f32, device=device)
    cT = torch.empty((D, B, W), dtype=f32, device=device)
    lib = _library()
    lay = scan_layout_on(device, B, W, D, Vp)
    # the register layout's scratch: the top layer's h of every step and
    # each step's NLL
    htop = torch.empty((B, T, W) if lay.reg else (0,), dtype=f32,
                       device=device)
    nl = torch.empty((B, T) if lay.reg else (0,), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.score_scan_launch(
            xp1.data_ptr(), y.data_ptr(), mask.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), rec1.data_ptr(), kcat.data_ptr(),
            ucat.data_ptr(), bias.data_ptr(), embT.data_ptr(),
            probs.data_ptr(), nll.data_ptr(), hT.data_ptr(), cT.data_ptr(),
            htop.data_ptr() if lay.reg else None,
            nl.data_ptr() if lay.reg else None, B, T, D, W, Vp, int(v_real),
            lay.rb, lay.cl, lay.rt, int(lay.reg), lay.smem, stream)
    if status != 0:
        raise RuntimeError('score_scan kernel launch failed: CUDA error %d '
                           '(layout %s)' % (status, lay))
    _build.count(score_scan)
    return probs, nll, (hT, cT)


score_scan.launches = 0


def score_scan_ref(xp1, y, mask, h0, c0, rec1, kcat, ucat, bias, embT,
                   v_real):
    """Plain PyTorch version of :func:`score_scan` (same arguments, same
    outputs): a loop over time, the sums in the JAX kernel's order."""
    B, T, _ = xp1.shape
    D = h0.shape[0]
    hs, cs = list(h0), list(c0)
    keep = torch.arange(embT.shape[1], device=embT.device) < v_real
    yl = y.long()
    probs, nlls = [], []
    for t in range(T):
        hs[0], cs[0] = gate_math(xp1[:, t] + hs[0] @ rec1, cs[0])
        inp = hs[0]
        for d in range(1, D):
            z = inp @ kcat[d - 1] + hs[d] @ ucat[d - 1] + bias[d - 1]
            hs[d], cs[d] = gate_math(z, cs[d])
            inp = hs[d]
        logits = torch.where(keep, inp @ embT,
                             torch.full_like(keep, -BIG, dtype=embT.dtype))
        mx = logits.max(dim=1, keepdim=True).values
        lse = (mx + torch.log(torch.exp(logits - mx).sum(
            dim=1, keepdim=True)))[:, 0]
        tgt = logits.gather(1, yl[:, t:t + 1])[:, 0]
        m = mask[:, t]
        probs.append(torch.exp(tgt - lse) * m)
        nlls.append((lse - tgt) * m)
    if T:
        probs_bt = torch.stack(probs, 1)
        nll_sum = torch.stack(nlls).sum(0)
    else:
        probs_bt = torch.zeros((B, 0), dtype=xp1.dtype, device=xp1.device)
        nll_sum = torch.zeros((B,), dtype=xp1.dtype, device=xp1.device)
    return probs_bt, nll_sum, (torch.stack(hs), torch.stack(cs))
