"""Lattice beam decode, one document or a batch: the CUDA kernels and
their plain PyTorch versions.

Counterpart of ``ocrd_keraslm_tpu/ops/decode_kernel.py::
decode_lattice_pallas`` and ``decode_lattice_pallas_batch`` (with
``walk_records_batch``).  :func:`decode_lattice` launches the
hand-written kernel ``csrc/decode_lattice.cu`` for CUDA tensors and runs
:func:`decode_lattice_ref`, the same function in plain PyTorch, for CPU
tensors; :func:`decode_lattice_batch` and :func:`walk_records_batch`
do the same with ``csrc/decode_lattice_batch.cu`` and
:func:`decode_lattice_batch_ref`/:func:`walk_records_batch_ref`.  Both
kernels run the device code of ``csrc/decode_common.cuh``: a document
on a thread-block cluster of CL blocks where the cluster layout takes
the shape (:func:`cluster_blocks` chooses CL from the number of
documents and the clusters the card holds at once), else on one block
(the first port's code); both layouts give the same bits.  Nothing
falls back: a CUDA tensor either goes through the kernel or the call
raises.

Layouts are the JAX package's: the packed beam state is (K, S) with
S = (2D+1)W and rows ``[xemb | h_0..h_{D-1} | c_0..c_{D-1}]``; the cost
carry is a (1, 128) vector whose lanes >= K hold ``BIG``; the output is
either the device-walked ``(E+1, 2)`` path (header ``[cost0[k_fin], 0]``)
or the ``(E+1, 3K)`` records ``[backptr | alt | cost]`` whose header
carries ``min(cost0)`` and the initial-beam costs.

The weights ``emb``/``embT``/``wcat`` are all float32 (the default) or
all bfloat16 (the JAX package's opt-in bf16 decode mode); everything
else, the carried state and all cost arithmetic stay float32.  Under
bf16 weights every matmul operand (``[input | h_d]`` of a layer, the top
h of the logits) is rounded to bf16 and each product summed in f32:
JAX's ``preferred_element_type=float32`` on bf16 inputs.  The kernels
then run their gate products on the tensor cores (``mma.sync`` bf16 with
f32 sums) and count their launches in ``launches_bf16``, apart from the
f32 launches in ``launches``.

The kernels are compiled at first use by :mod:`._build` (``nvcc`` for
``sm_90a``, loaded with ``ctypes``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from ._build import check as _check

BIG = 1.0e30
LANE = 128
INV_LN2 = 1.4426950408889634

SOURCE = _build.source('decode_lattice.cu')

# ---- the cluster layout of decode_common.cuh (decode_edges_cluster) ----
CNT = 256                # threads per block of the cluster layout
KCH = 32                 # terms per partial sum
DC_RC = 16               # rows per chunk
KMAX = 32                # beam rows the kernels take
CLUSTERS = (4, 8, 16)    # blocks per document (16: non-portable)
SMEM_MAX = 232448        # dynamic shared memory a block may ask (Hopper)
# Time of one document by blocks a document, relative to one block (the
# first port's code): the cost model of choose_cluster, fitted to
# gen_beam_phases.py decode on an H100 (rows 1 and 2 of PERF.md at W=128:
# 16 blocks 0.19-0.21; W=64, D=2: 4 blocks 0.36, 8 blocks 0.26)
CL_COST = {1: 1.0, 4: 0.36, 8: 0.26, 16: 0.19}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def padded_width(W: int) -> int:
    """A padded row of the cluster layout: 4 floats after each 32-term
    block (``cluster_common.cuh`` ``hpad``)."""
    return W + 4 * _ceil(W, KCH)


def cluster_ok(W: int, D: int, cl: int, K: int = 1) -> bool:
    """Whether the cluster layout takes width W, depth D and cl blocks
    (``decode_cluster_ok``): W in 32, 64, 128 (2, 4 or 8 blocks of 32
    terms in a gate column of [input | h]), D <= 2 (a lane's 32 weights
    a layer in registers), cl in :data:`CLUSTERS`, a row group (4 x 2W/32
    lanes per unit) in a block of CNT threads, and K <= 32."""
    if W not in (32, 64, 128) or not 1 <= D <= 2 or cl not in CLUSTERS \
            or not 1 <= K <= KMAX:
        return False
    return W // cl * 4 * (2 * W // KCH) <= CNT


def cluster_smem_bytes(A: int, L: int, K: int, D: int, W: int, Vp: int,
                       v_real: int, cl: int) -> int:
    """A block's dynamic shared memory in the cluster layout
    (``decode_cluster_smem_bytes``): two mbarriers, the ring of two h
    buffers, the padded [xemb | h] rows of the beam and of the K*A
    candidates and the parents' new h, the c of their own units, the
    chunk's gate sums, new h and c of the own units, the logits' 32-term
    blocks and logsumexp of the block's rows, the own bias, the per-edge
    arrays and embT's ``v_real`` real columns."""
    WP = padded_width(W)
    XP, upb, KA, RL = (D + 1) * WP, W // cl, K * A, _ceil(DC_RC, cl)
    floats = (16 + 2 * DC_RC * WP + (K + KA) * XP + K * D * WP
              + (2 * K + KA) * D * upb
              + DC_RC * 4 * upb + DC_RC * upb + D * DC_RC * upb
              + RL * (W // KCH) * Vp + RL + D * 4 * upb
              + K + 2 * KA + 2 * A * L + A + W * v_real
              + K + 2 * KA + A * L + 4)
    return 16 + 4 * floats


def cluster_sizes(K: int, A: int, L: int, D: int, W: int, Vp: int,
                  v_real: int) -> list:
    """The cluster sizes the layout takes for the shape: those of
    :func:`cluster_ok` whose shared memory fits a block's, where an
    edge's A x L chars fit a block's threads."""
    if A * L > CNT:
        return []
    return [cl for cl in CLUSTERS if cluster_ok(W, D, cl, K)
            and cluster_smem_bytes(A, L, K, D, W, Vp, v_real, cl)
            <= SMEM_MAX]


def one_block_smem_bytes(A: int, L: int, K: int, D: int, W: int, Vp: int,
                         rb: int) -> int:
    """A block's dynamic shared memory in the one-block layout at ``rb``
    rows a chunk (``decode_smem_floats``): the beam, the chunk's rows,
    its gates or logits, then the per-edge arrays."""
    S, KA = (2 * D + 1) * W, K * A
    return 4 * (K * S + rb * S + rb * max(4 * W, Vp)
                + K + 2 * KA + rb + 2 * A * L + A + K + KA + A * L + 4)


def decode_smem_fits(A: int, L: int, K: int, D: int, W: int, Vp: int,
                     v_real: int) -> bool:
    """Whether :func:`decode_lattice` can lay the shape out within a
    block's shared memory: the one-block layout at its smallest chunk
    (8 rows; ``decode_chunk_rows``), or a cluster size
    (:func:`cluster_sizes`).  f32 and bf16 weights share one plan."""
    return one_block_smem_bytes(A, L, K, D, W, Vp, 8) <= SMEM_MAX or \
        bool(cluster_sizes(K, A, L, D, W, Vp, v_real))


def choose_cluster(N: int, K: int, A: int, L: int, D: int, W: int, Vp: int,
                   v_real: int, fits, n_sm: int) -> int:
    """Blocks a document for a launch of N documents: of the cluster
    sizes the layout takes (:func:`cluster_sizes`) and the card holds
    (``fits(cl)``: how many such clusters it holds at once), the lowest
    ``CL_COST[cl]`` times the waves of clusters wins, ties to more
    blocks; 1 (one block a document, the first port's code, ``n_sm`` at
    once) where none does or it costs no more."""
    best = (CL_COST[1] * _ceil(N, n_sm), 1)
    for cl in cluster_sizes(K, A, L, D, W, Vp, v_real):
        at_once = fits(cl)
        if at_once > 0:
            best = min(best, (CL_COST[cl] * _ceil(N, at_once), -cl))
    return abs(best[1])


@functools.lru_cache(maxsize=None)
def _clusters_that_fit(index: int, batch: bool, cl: int, A: int, L: int,
                       K: int, D: int, W: int, Vp: int, v_real: int,
                       bf16: bool) -> int:
    with torch.cuda.device(index):
        if batch:
            return _batch_library().decode_lattice_batch_max_clusters(
                A, L, K, D, W, Vp, v_real, cl, int(bf16))
        return _library().decode_lattice_max_clusters(A, L, K, D, W, Vp,
                                                      v_real, cl, int(bf16))


@functools.lru_cache(maxsize=None)
def _cluster_choice(index: int, batch: bool, N: int, K: int, A: int,
                    L: int, D: int, W: int, Vp: int, v_real: int,
                    bf16: bool) -> int:
    return choose_cluster(
        N, K, A, L, D, W, Vp, v_real,
        lambda cl: _clusters_that_fit(index, batch, cl, A, L, K, D, W, Vp,
                                      v_real, bf16),
        torch.cuda.get_device_properties(index).multi_processor_count)


def cluster_blocks(device: torch.device, batch: bool, N: int, K: int,
                   A: int, L: int, D: int, W: int, Vp: int,
                   v_real: int, bf16: bool = False) -> int:
    """Blocks a document of :func:`decode_lattice` (``batch`` false, N
    1) or :func:`decode_lattice_batch` (N documents) on the CUDA
    ``device``: :func:`choose_cluster` with the card's SMs and the
    cluster occupancy of the kernel of the weights' dtype (``bf16``),
    chosen once per device, shape and dtype.  Both dtypes share one
    shared-memory plan, so the layouts a shape takes
    (:func:`cluster_sizes`) do not depend on it."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _cluster_choice(index, bool(batch), N, K, A, L, D, W, Vp,
                           int(v_real), bool(bf16))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_lattice_launch.argtypes = \
        [P] * 16 + [I] * 9 + [F, F, I, I, P]
    lib.decode_lattice_launch.restype = ctypes.c_int
    lib.decode_lattice_smem_bytes.argtypes = [I] * 8
    lib.decode_lattice_smem_bytes.restype = ctypes.c_size_t
    lib.decode_lattice_max_clusters.argtypes = [I] * 9
    lib.decode_lattice_max_clusters.restype = ctypes.c_int
    return lib


def weight_dtype(emb, embT, wcat) -> torch.dtype:
    """The dtype of the decode weights: ``emb``, ``embT`` and ``wcat``
    all float32 or all bfloat16 (the plain versions also take float64,
    the f32 mode in float64); raises on a mix or another dtype."""
    dtypes = {emb.dtype, embT.dtype, wcat.dtype}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16,
                                          torch.float64}:
        raise ValueError('emb, embT and wcat must all be float32 or all '
                         'bfloat16 (got %s, %s, %s)'
                         % (emb.dtype, embT.dtype, wcat.dtype))
    return dtypes.pop()


def _kernel_weight_dtype(emb, embT, wcat) -> torch.dtype:
    """:func:`weight_dtype` of a kernel launch: float32 or bfloat16."""
    wdt = weight_dtype(emb, embT, wcat)
    if wdt == torch.float64:
        raise ValueError('the decode kernels take float32 or bfloat16 '
                         'weights, not float64')
    return wdt


def _shapes(emb, wcat, alt_chars, state0):
    E, A, L = alt_chars.shape
    K, S = state0.shape
    Vp, W = emb.shape
    D = wcat.shape[0]
    if S != (2 * D + 1) * W:
        raise ValueError('state0 width %d != (2D+1)W = %d'
                         % (S, (2 * D + 1) * W))
    return E, A, L, K, S, Vp, W, D


def decode_lattice(emb, embT, wcat, bias, alt_chars, alt_mask, alt_conf,
                   alt_valid, state0, cost0, *, lm_weight: float,
                   v_real: int, device_walk: bool = False,
                   alt_steps: Optional[torch.Tensor] = None,
                   n_real: Optional[int] = None):
    """One-launch lattice decode of E edges.

    emb: (Vp, W); embT: (W, Vp); wcat: (D, 2W, 4W) fused
    ``[input-kernel; recurrent-kernel]``, the three float32 or bfloat16
    (:func:`weight_dtype`); bias: (D, 1, 4W) (context folded into layer
    0); alt_chars: (E, A, L) int32; alt_mask,
    alt_conf: (E, A, L) float32 (conf as -log2 bits per char);
    alt_valid: (E, A); state0: (K, S); cost0: (1, 128);
    alt_steps: (E,) int32 char steps per edge (default L);
    n_real: edges < n_real are real, the rest pad (default E).

    Returns (packed output, stateF (K, S), costF (1, 128))."""
    tensors = (emb, embT, wcat, bias, alt_chars, alt_mask, alt_conf,
               alt_valid, state0, cost0)
    device = _build.one_device('decode_lattice', tensors + (
        () if alt_steps is None else (alt_steps,)))
    if device.type == 'cpu':
        return decode_lattice_ref(
            emb, embT, wcat, bias, alt_chars, alt_mask, alt_conf,
            alt_valid, state0, cost0, lm_weight=lm_weight, v_real=v_real,
            device_walk=device_walk, alt_steps=alt_steps, n_real=n_real)
    if device.type != 'cuda':
        raise ValueError('decode_lattice runs on cpu or cuda, not %s'
                         % device)
    E, A, L, K, S, Vp, W, D = _shapes(emb, wcat, alt_chars, state0)
    if W % 4 or K > 32 or E < 1:
        raise ValueError('decode kernel needs W % 4 == 0, K <= 32 and '
                         'E >= 1 (got W=%d, K=%d, E=%d)' % (W, K, E))
    if alt_steps is None:
        alt_steps = torch.full((E,), L, dtype=torch.int32, device=device)
    alt_steps = alt_steps.reshape(E)
    f32, wdt = torch.float32, _kernel_weight_dtype(emb, embT, wcat)
    for name, t, shape, dtype in (
            ('emb', emb, (Vp, W), wdt), ('embT', embT, (W, Vp), wdt),
            ('wcat', wcat, (D, 2 * W, 4 * W), wdt),
            ('bias', bias, (D, 1, 4 * W), f32),
            ('alt_chars', alt_chars, (E, A, L), torch.int32),
            ('alt_mask', alt_mask, (E, A, L), f32),
            ('alt_conf', alt_conf, (E, A, L), f32),
            ('alt_valid', alt_valid, (E, A), f32),
            ('alt_steps', alt_steps, (E,), torch.int32),
            ('state0', state0, (K, S), f32),
            ('cost0', cost0, (1, LANE), f32)):
        _check(name, t, shape, dtype, device)
    n_real = E if n_real is None else int(n_real)
    records = torch.empty((E + 1, 3 * K), dtype=f32, device=device)
    walk = (torch.empty((E + 1, 2), dtype=f32, device=device)
            if device_walk else None)
    stateF = torch.empty((K, S), dtype=f32, device=device)
    costF = torch.empty((1, LANE), dtype=f32, device=device)
    stateE = torch.empty((K * A, S), dtype=f32, device=device)
    lib = _library()
    bf16 = wdt == torch.bfloat16
    cl = cluster_blocks(device, False, 1, K, A, L, D, W, Vp, v_real, bf16)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.decode_lattice_launch(
            emb.data_ptr(), embT.data_ptr(), wcat.data_ptr(),
            bias.data_ptr(), alt_chars.data_ptr(), alt_mask.data_ptr(),
            alt_conf.data_ptr(), alt_valid.data_ptr(),
            alt_steps.data_ptr(), state0.data_ptr(), cost0.data_ptr(),
            records.data_ptr(), walk.data_ptr() if device_walk else None,
            stateF.data_ptr(), costF.data_ptr(), stateE.data_ptr(),
            E, n_real, A, L, K, D, W, Vp, int(v_real),
            float(lm_weight), float(1.0 - lm_weight), cl, int(bf16), stream)
    if status != 0:
        raise RuntimeError('decode_lattice kernel launch failed: CUDA '
                           'error %d (%s weights, %d blocks, %d bytes of '
                           'shared memory asked)'
                           % (status, 'bf16' if bf16 else 'f32', cl,
                              lib.decode_lattice_smem_bytes(
                                  A, L, K, D, W, Vp, v_real, cl)))
    if bf16:
        _build.count(decode_lattice, 'launches_bf16')
    else:
        _build.count(decode_lattice)
    return (walk if device_walk else records), stateF, costF


decode_lattice.launches = 0        # f32 weights
decode_lattice.launches_bf16 = 0   # bf16 weights


def _plain_weights(emb, embT, wcat, dtype):
    """The plain versions' weights in the compute ``dtype`` (the
    state's) and the rounding of their matmul operands: under bf16
    weights (:func:`weight_dtype`) the weights are widened exactly and
    each operand is rounded to bf16 (nearest even) and widened, so that
    every product is exact and summed in ``dtype`` (JAX's
    ``preferred_element_type=float32`` on bf16 inputs; a bfloat16 ``@``
    in PyTorch would round its result too); under f32 weights nothing
    changes."""
    if weight_dtype(emb, embT, wcat) == torch.bfloat16:
        def rnd(x):
            return x.to(torch.bfloat16).to(dtype)
    else:
        def rnd(x):
            return x
    return emb.to(dtype), embT.to(dtype), wcat.to(dtype), rnd


def _lstm_logits(stateE, embT, wcat, bias, D, W, v_real, rnd):
    """The D-layer LSTM stack over packed rows and the tied softmax,
    each matmul operand through ``rnd`` (:func:`_plain_weights`):
    returns (new h per layer, new c per layer, logits (rows, v_real),
    their logsumexp (rows,))."""
    inp = stateE[:, :W]
    hs, cs = [], []
    for d in range(D):
        operand = torch.cat([inp, stateE[:, (1 + d) * W:(2 + d) * W]], 1)
        z = rnd(operand) @ wcat[d] + bias[d]
        i = torch.sigmoid(z[:, 0 * W:1 * W])
        f = torch.sigmoid(z[:, 1 * W:2 * W])
        g = torch.tanh(z[:, 2 * W:3 * W])
        o = torch.sigmoid(z[:, 3 * W:4 * W])
        c2 = f * stateE[:, (1 + D + d) * W:(2 + D + d) * W] + i * g
        h2 = o * torch.tanh(c2)
        hs.append(h2)
        cs.append(c2)
        inp = h2
    logits = (rnd(inp) @ embT)[:, :v_real]
    return hs, cs, logits, torch.logsumexp(logits, dim=1)


def _char_step(stateE, chars, emb, embT, wcat, bias, D, W, v_real, rnd):
    """One char step of the LSTM stack over packed rows plus the
    tied-softmax -log2 p of ``chars``; returns (new packed rows,
    nll2)."""
    hs, cs, logits, lse = _lstm_logits(stateE, embT, wcat, bias, D, W,
                                       v_real, rnd)
    nll2 = (lse - logits.gather(1, chars[:, None])[:, 0]) * INV_LN2
    return torch.cat([emb[chars]] + hs + cs, 1), nll2


def decode_lattice_ref(emb, embT, wcat, bias, alt_chars, alt_mask,
                       alt_conf, alt_valid, state0, cost0, *,
                       lm_weight: float, v_real: int,
                       device_walk: bool = False,
                       alt_steps: Optional[torch.Tensor] = None,
                       n_real: Optional[int] = None):
    """Plain PyTorch version of :func:`decode_lattice` (same arguments,
    same outputs): every candidate row runs every char step of its
    edge, masked rows keep their state, and the top K is a stable sort
    by cost, so ties go to the lower candidate index.  Arithmetic in
    the state's dtype, bf16 weights as :func:`_plain_weights` says."""
    E, A, L, K, S, Vp, W, D = _shapes(emb, wcat, alt_chars, state0)
    emb, embT, wcat, rnd = _plain_weights(emb, embT, wcat, state0.dtype)
    device = state0.device
    n_real = E if n_real is None else int(n_real)
    steps = ([L] * E if alt_steps is None
             else alt_steps.reshape(E).tolist())
    KA = K * A
    cand = torch.arange(KA, device=device)
    parent, aidx = cand // A, cand % A
    chars_l = alt_chars.long()
    lw, lw1 = float(lm_weight), float(1.0 - lm_weight)
    state = state0
    cost = cost0[0, :K]
    rows = []
    for t in range(E):
        if t >= n_real:
            rows.append(torch.cat([torch.arange(K, device=device).float(),
                                   torch.zeros(K, device=device), cost]))
            continue
        stateE = state[parent]
        acc = torch.zeros(KA, device=device)
        for s in range(int(steps[t])):
            m = alt_mask[t, aidx, s]
            new, nll2 = _char_step(stateE, chars_l[t, aidx, s], emb, embT,
                                   wcat, bias, D, W, v_real, rnd)
            acc = acc + m * (lw * nll2 + lw1 * alt_conf[t, aidx, s])
            stateE = torch.where((m > 0)[:, None], new, stateE)
        total = torch.where(alt_valid[t, aidx] > 0.5, cost[parent] + acc,
                            torch.full_like(acc, BIG))
        sel = torch.sort(total, stable=True).indices[:K]
        rows.append(torch.cat([(sel // A).float(), (sel % A).float(),
                               total[sel]]))
        cost = total[sel]
        state = stateE[sel]
    records = torch.stack(rows) if rows else \
        torch.zeros((0, 3 * K), device=device)
    costF = cost0.clone()
    if n_real > 0:
        costF[0, :K] = cost
        costF[0, K:] = BIG
    cost0_k = cost0[0, :K]
    if device_walk:
        rec = records.cpu()
        k = 0
        walk = torch.zeros((E + 1, 2))
        for t in range(E - 1, -1, -1):
            walk[t + 1, 0] = rec[t, K + k]
            walk[t + 1, 1] = rec[t, 2 * K + k]
            k = int(rec[t, k])
        walk[0, 0] = cost0_k[k]
        return walk.to(device), state.clone(), costF
    header = torch.zeros((1, 3 * K), device=device)
    header[0, 0] = cost0_k.min()
    header[0, 2 * K:] = cost0_k
    return torch.cat([header, records]), state.clone(), costF


# ----------------------------------------------------------------------
# document-batched decode
# ----------------------------------------------------------------------

BATCH_SOURCE = _build.source('decode_lattice_batch.cu')


@functools.lru_cache(maxsize=None)
def _batch_library() -> ctypes.CDLL:
    lib = _build.load(BATCH_SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_lattice_batch_launch.argtypes = \
        [P] * 15 + [I] * 10 + [F, F, I, I, P]
    lib.decode_lattice_batch_launch.restype = ctypes.c_int
    lib.decode_lattice_batch_smem_bytes.argtypes = [I] * 8
    lib.decode_lattice_batch_smem_bytes.restype = ctypes.c_size_t
    lib.decode_lattice_batch_max_clusters.argtypes = [I] * 9
    lib.decode_lattice_batch_max_clusters.restype = ctypes.c_int
    lib.walk_records_batch_launch.argtypes = [P] * 4 + [I] * 3 + [P]
    lib.walk_records_batch_launch.restype = ctypes.c_int
    lib.walk_records_batch_smem_bytes.argtypes = [I] * 2
    lib.walk_records_batch_smem_bytes.restype = ctypes.c_size_t
    return lib


WALK_NT = 512     # threads of the walk kernel a document
WALK_SEGS = 64    # segments of its chain, at most
WALK_MAX_K = 255  # beam rows the walk takes (a backpointer in a byte)


def walk_smem_bytes(E: int, K: int) -> int:
    """Dynamic shared memory of the walk kernel's block
    (``walk_records_batch_smem_bytes``): each step's slot, the chain
    segments' exit slots by entry and entry slots, and the document's
    E*K backpointers as bytes."""
    G = min(WALK_NT // K, WALK_SEGS)
    return 4 * (E + G * K + G) + E * K


def _batch_shapes(emb, wcat, alt_chars, state0, n_docs):
    E, NA, L = alt_chars.shape
    NK, S = state0.shape
    N = int(n_docs)
    if N < 1 or NA % N or NK % N:
        raise ValueError('%d documents do not divide %d alternative rows '
                         'and %d beam rows' % (N, NA, NK))
    Vp, W = emb.shape
    D = wcat.shape[0]
    if S != (2 * D + 1) * W:
        raise ValueError('state0 width %d != (2D+1)W = %d'
                         % (S, (2 * D + 1) * W))
    return E, N, NA // N, L, NK // N, S, Vp, W, D


def decode_lattice_batch(emb, embT, wcat, bias, alt_chars, alt_mask,
                         alt_conf, alt_valid, state0, cost0, *,
                         n_docs: int, lm_weight: float, v_real: int,
                         alt_steps: Optional[torch.Tensor] = None,
                         n_real: Optional[int] = None):
    """One-launch decode of E edges of N independent documents.

    Layouts are the JAX package's (document-major): alt_chars (E, N*A,
    L) int32; alt_mask, alt_conf (E, N*A, L) float32; alt_valid (E, N*A,
    1); state0 (N*K, S) packed beams; cost0 (N*K, 1) (``BIG`` = dead
    slot); alt_steps (E, 1) int32 char steps per edge (default L), the
    same for every document; n_real: edges < n_real are real, the rest
    pad (default E).  Weights as :func:`decode_lattice`'s.

    Returns (records (E, 3, N*K) rows ``[bp | alt | cost]`` over the
    documents' K slots, stateF (N*K, S), costF (N*K, 1)); each
    document's part equals a single-document decode of its edges."""
    tensors = (emb, embT, wcat, bias, alt_chars, alt_mask, alt_conf,
               alt_valid, state0, cost0)
    device = _build.one_device('decode_lattice_batch', tensors + (
        () if alt_steps is None else (alt_steps,)))
    if device.type == 'cpu':
        return decode_lattice_batch_ref(
            emb, embT, wcat, bias, alt_chars, alt_mask, alt_conf,
            alt_valid, state0, cost0, n_docs=n_docs, lm_weight=lm_weight,
            v_real=v_real, alt_steps=alt_steps, n_real=n_real)
    if device.type != 'cuda':
        raise ValueError('decode_lattice_batch runs on cpu or cuda, not %s'
                         % device)
    E, N, A, L, K, S, Vp, W, D = _batch_shapes(emb, wcat, alt_chars, state0,
                                               n_docs)
    if W % 4 or K > 32 or E < 1:
        raise ValueError('decode kernel needs W % 4 == 0, K <= 32 and '
                         'E >= 1 (got W=%d, K=%d, E=%d)' % (W, K, E))
    if alt_steps is None:
        alt_steps = torch.full((E, 1), L, dtype=torch.int32, device=device)
    f32, wdt = torch.float32, _kernel_weight_dtype(emb, embT, wcat)
    for name, t, shape, dtype in (
            ('emb', emb, (Vp, W), wdt), ('embT', embT, (W, Vp), wdt),
            ('wcat', wcat, (D, 2 * W, 4 * W), wdt),
            ('bias', bias, (D, 1, 4 * W), f32),
            ('alt_chars', alt_chars, (E, N * A, L), torch.int32),
            ('alt_mask', alt_mask, (E, N * A, L), f32),
            ('alt_conf', alt_conf, (E, N * A, L), f32),
            ('alt_valid', alt_valid, (E, N * A, 1), f32),
            ('alt_steps', alt_steps, (E, 1), torch.int32),
            ('state0', state0, (N * K, S), f32),
            ('cost0', cost0, (N * K, 1), f32)):
        _check(name, t, shape, dtype, device)
    n_real = E if n_real is None else int(n_real)
    records = torch.empty((E, 3, N * K), dtype=f32, device=device)
    stateF = torch.empty((N * K, S), dtype=f32, device=device)
    costF = torch.empty((N * K, 1), dtype=f32, device=device)
    stateE = torch.empty((N, K * A, S), dtype=f32, device=device)
    lib = _batch_library()
    bf16 = wdt == torch.bfloat16
    cl = cluster_blocks(device, True, N, K, A, L, D, W, Vp, v_real, bf16)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.decode_lattice_batch_launch(
            emb.data_ptr(), embT.data_ptr(), wcat.data_ptr(),
            bias.data_ptr(), alt_chars.data_ptr(), alt_mask.data_ptr(),
            alt_conf.data_ptr(), alt_valid.data_ptr(),
            alt_steps.data_ptr(), state0.data_ptr(), cost0.data_ptr(),
            records.data_ptr(), stateF.data_ptr(), costF.data_ptr(),
            stateE.data_ptr(), N, E, n_real, A, L, K, D, W, Vp,
            int(v_real), float(lm_weight), float(1.0 - lm_weight), cl,
            int(bf16), stream)
    if status != 0:
        raise RuntimeError('decode_lattice_batch kernel launch failed: '
                           'CUDA error %d (%s weights, %d blocks a document, '
                           '%d bytes of shared memory asked)'
                           % (status, 'bf16' if bf16 else 'f32', cl,
                              lib.decode_lattice_batch_smem_bytes(
                                  A, L, K, D, W, Vp, v_real, cl)))
    if bf16:
        _build.count(decode_lattice_batch, 'launches_bf16')
    else:
        _build.count(decode_lattice_batch)
    return records, stateF, costF


decode_lattice_batch.launches = 0        # f32 weights
decode_lattice_batch.launches_bf16 = 0   # bf16 weights


def decode_lattice_batch_ref(emb, embT, wcat, bias, alt_chars, alt_mask,
                             alt_conf, alt_valid, state0, cost0, *,
                             n_docs: int, lm_weight: float, v_real: int,
                             alt_steps: Optional[torch.Tensor] = None,
                             n_real: Optional[int] = None):
    """Plain PyTorch version of :func:`decode_lattice_batch` (same
    arguments, same outputs), all documents at once: char step 0 of an
    edge runs on the parent rows (all candidates of a parent share its
    state there, as in the kernel), later steps on every candidate row
    (masked rows keep their state), and each document's top K is a
    stable sort of its candidates by cost, so ties go to the lower
    candidate index.  Arithmetic as :func:`decode_lattice_ref`'s."""
    E, N, A, L, K, S, Vp, W, D = _batch_shapes(emb, wcat, alt_chars,
                                               state0, n_docs)
    emb, embT, wcat, rnd = _plain_weights(emb, embT, wcat, state0.dtype)
    device = state0.device
    n_real = E if n_real is None else int(n_real)
    steps = ([L] * E if alt_steps is None
             else alt_steps.reshape(E).tolist())
    KA = K * A
    cand = torch.arange(N * KA, device=device)
    doc, local = cand // KA, cand % KA
    parent = doc * K + local // A        # beam row of each candidate
    alt = doc * A + local % A            # alternative row of each
    first = (torch.arange(N, device=device) * KA)[:, None]
    chars_l = alt_chars.long()
    lw, lw1 = float(lm_weight), float(1.0 - lm_weight)
    state = state0
    cost = cost0[:, 0]
    slots = torch.arange(K, device=device).float().repeat(N)
    rows = []
    for t in range(E):
        if t >= n_real:
            rows.append(torch.stack([slots, torch.zeros_like(slots), cost]))
            continue
        stateE = state[parent]
        acc = torch.zeros(N * KA, device=device)
        for s in range(int(steps[t])):
            m = alt_mask[t, alt, s]
            ch = chars_l[t, alt, s]
            if s == 0:
                hs, cs, logits, lse = _lstm_logits(state, embT, wcat, bias,
                                                   D, W, v_real, rnd)
                nll2 = (lse[parent] - logits[parent, ch]) * INV_LN2
                new = torch.cat([emb[ch], torch.cat(hs + cs, 1)[parent]], 1)
            else:
                new, nll2 = _char_step(stateE, ch, emb, embT, wcat, bias, D,
                                       W, v_real, rnd)
            acc = acc + m * (lw * nll2 + lw1 * alt_conf[t, alt, s])
            stateE = torch.where((m > 0)[:, None], new, stateE)
        total = torch.where(alt_valid[t, alt, 0] > 0.5, cost[parent] + acc,
                            torch.full_like(acc, BIG))
        sel = torch.sort(total.view(N, KA), dim=1, stable=True).indices[:, :K]
        pick = (first + sel).reshape(-1)
        cost = total[pick]
        rows.append(torch.stack([(sel // A).reshape(-1).float(),
                                 (sel % A).reshape(-1).float(), cost]))
        state = stateE[pick]
    records = torch.stack(rows) if rows else \
        torch.zeros((0, 3, N * K), device=device)
    return records, state.clone(), cost[:, None].clone()


def walk_records_batch(records, k_in, *, n_docs: int, beam: int):
    """Reverse backpointer walk of a block of batched records, one walk
    per document: records (E, 3, N*K), k_in (N,) int32 the start slot of
    each document (0, the best final hypothesis, for the last block; a
    block's ``k_out`` for the block before it).  Returns (k_out (N,)
    int32, walks (N, E, 2) ``[alt | cost]`` per edge).  One launch of the
    walk kernel on CUDA (a block per document: its backpointers staged in
    shared memory, the chain walked there in segments, the values gathered
    by every thread); :func:`walk_records_batch_ref` on the CPU."""
    device = _build.one_device('walk_records_batch', (records, k_in))
    if device.type == 'cpu':
        return walk_records_batch_ref(records, k_in, n_docs=n_docs,
                                      beam=beam)
    if device.type != 'cuda':
        raise ValueError('walk_records_batch runs on cpu or cuda, not %s'
                         % device)
    E, N, K = records.shape[0], int(n_docs), int(beam)
    if not 1 <= K <= WALK_MAX_K or walk_smem_bytes(E, K) > SMEM_MAX:
        raise ValueError('walk_records_batch kernel needs 1 <= beam <= %d '
                         'and E*beam backpointers in a block\'s shared '
                         'memory (got E=%d, beam=%d: %d bytes of %d)'
                         % (WALK_MAX_K, E, K, walk_smem_bytes(E, K),
                            SMEM_MAX))
    _check('records', records, (E, 3, N * K), torch.float32, device)
    _check('k_in', k_in, (N,), torch.int32, device)
    k_out = torch.empty((N,), dtype=torch.int32, device=device)
    walks = torch.empty((N, E, 2), dtype=torch.float32, device=device)
    lib = _batch_library()
    with torch.cuda.device(device):
        status = lib.walk_records_batch_launch(
            records.data_ptr(), k_in.data_ptr(), k_out.data_ptr(),
            walks.data_ptr(), N, E, K,
            torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError('walk_records_batch kernel launch failed: CUDA '
                           'error %d (%d bytes of shared memory asked a '
                           'block)' % (status, walk_smem_bytes(E, K)))
    _build.count(walk_records_batch)
    return k_out, walks


walk_records_batch.launches = 0


def walk_records_batch_ref(records, k_in, *, n_docs: int, beam: int):
    """Plain PyTorch version of :func:`walk_records_batch`."""
    E, N, K = records.shape[0], int(n_docs), int(beam)
    rec = records.reshape(E, 3, N, K)
    docs = torch.arange(N, device=records.device)
    k = k_in.long()
    walks = torch.zeros((N, E, 2), dtype=torch.float32,
                        device=records.device)
    for t in range(E - 1, -1, -1):
        walks[:, t, 0] = rec[t, 1, docs, k]
        walks[:, t, 1] = rec[t, 2, docs, k]
        k = rec[t, 0, docs, k].long()
    return k.int(), walks
