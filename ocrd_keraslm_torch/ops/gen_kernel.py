"""Generation beam search: the beam-step and traceback CUDA kernels and
their plain PyTorch versions.

Counterpart of ``ocrd_keraslm_tpu/ops/gen_kernel.py``.
:func:`gen_beam` runs the whole character-by-character beam search of
one or more streams (prompts): per step, the D-layer LSTM over the K
fringe rows, the tied-softmax logsumexp, each row's exact top TOPK
characters, the absolute-probability threshold and the removal of the
unmapped char 0, the exact K of the K*TOPK candidates, and the
``(char, backptr, cost)`` record.  :func:`traceback` walks the records
back from chosen end slots.  Each launches its hand-written kernel
(``csrc/gen_beam.cu``, ``csrc/gen_traceback.cu``) for CUDA tensors and
runs its plain version (:func:`gen_beam_ref`, :func:`traceback_ref`) for
CPU tensors; nothing falls back.

The semantics are the TPU kernel's, not those of the JAX package's XLA
scan engine (``generate_device``):

* each row's candidates are its TOPK largest logits (the vocabulary's
  padding columns excluded), equal logits ordered by smaller char id;
* a candidate costs ``cost + max(lse - logit, 0)`` (nats) and is dead
  (``BIG``) below the probability threshold or under a dead parent;
  the char-0 candidate is removed by shifting the row's tail left, so
  every row stays ascending;
* the new fringe is the K smallest candidates by (cost, row-major
  index), in row-major order, not in cost order: slot order decides the
  order of variants at equal cost;
* the next state of slot s is ``[emb[char] | h, c of its source row]``
  (index gathers: no one-hot products are needed for exact f32 values).

Layouts: ``state0`` (N, K, S) with S = (2D+1)W and rows ``[xemb |
h_0..h_{D-1} | c_0..c_{D-1}]``, ``cost0`` (N, K); the records are
(N, T, 3, K) float32 rows ``[char | backptr | cost]`` (the TPU's
(T, 8, K) minus its five padding rows; ids are exact in float32).

On the card a stream runs in one of two layouts of ``csrc/gen_beam.cu``
(:class:`GenLayout`): the unit layout (each block owns some units' gate
columns of every layer, their weights in registers for all steps, for
all rows or one of two row halves; the rows' h and c pass through L2
buffers), on one thread-block cluster a stream or, where few streams
leave the card idle, on ``g`` clusters a stream, each over its row group
of K/g rows (the step's candidates cross them through L2 behind a
counter; every cluster of the launch resident at once), and the rows
layout of the first design (one cluster a stream; each block owns some
fringe rows and reads every weight from L2 at each step).  :func:`choose`
picks one from a cost model of a step times the waves of clusters the
card holds, cached per device and shape (:func:`layout_on`).  All give
the same records bit for bit.

The traceback cuts the walked steps into segments (:func:`tb_layout`):
one launch stages each segment's backpointers in shared memory as bytes
and maps its entry slots to its exit slots; a second composes the later
segments' maps from each cursor's end slot, walks its own segment again
and gathers the chars (one launch where a segment holds the walk).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import _build
from ._build import check as _check

BIG = 3.0e38   # cost of a dead slot
UNT = 256            # threads per block of the unit layout
KCH = 32             # terms per partial sum
URT = 4              # rows one thread's chains take at once (unit layout)
SMEM_MAX = 232448    # dynamic shared memory a block may ask (Hopper)
# blocks a stream of the two layouts of csrc/gen_beam.cu: the unit layout
# (a block owns the units of one of cl/rh groups, their weights in
# registers, for the rows of one of rh halves) and the rows layout of the
# first design (a block owns K/cl fringe rows)
UNIT_CLUSTERS = (4, 8, 16)
ROW_HALVES = (1, 2)
# clusters a stream of the unit layout, each over a row group of K/g rows
# (g > 1: a cooperative launch, every cluster resident at once)
ROW_GROUPS = (1, 2, 4, 8, 16)
ROWS_CLUSTERS = (8, 16)
TILES = (32, 16)     # rows per staged tile of the unit layout, first fit
MAX_ROWS = 32        # fringe rows (own rows) a block
MAX_TOPK = 32        # candidates per row (one lane each)
UNIT_MAX_VREAL = 128  # a row's logits in 4 registers a lane (unit layout)
# the traceback kernels of csrc/gen_traceback.cu (host mirrors of its
# TB_* constants): blocks of TB_NT threads, up to TB_NT * 4 cursors a
# stream, K <= 256 slots (a backpointer is one byte in shared memory), a
# multiple of 4 (a float4 of backpointers a load)
MAX_VARIANTS = 1024  # traceback cursors
TB_NT = 256
TB_MAPS = 64         # segment maps a walk block stages at once
TB_SEG_MAX = 64      # steps a segment, at most
TB_MAX_SLOTS = 256
# the steps of a segment: a walk of at most TB_SEG_MAX steps is one
# segment (one launch); a longer one is cut into segments of
# ceil(out_length / TB_SEGS) steps, clamped to [TB_SEG_MIN, TB_SEG_MAX]
# (a launch for the segment maps, one for the walk).  Fitted to
# gen_beam_phases.py tb's sweep on an H100 (NVIDIA H100 80GB HBM3,
# 700 W): shorter segments stage less a block, but each walk block
# composes the maps of every later segment of its stream
TB_SEGS = 64
TB_SEG_MIN = 16
# The cost model of a step in microseconds, fitted to
# gen_beam_phases.py's layout sweep on an H100 (NVIDIA H100 80GB HBM3,
# 700 W; rows 6 and 6b of PERF.md: the german model, K=256, one stream x
# 1024 steps and 16 x 256): the unit layout UNIT_STEP, plus UNIT_PER_MFMA
# per million FMAs of a block's step (its columns' gate products over its
# rows and its own rows' logits), plus UNIT_PER_KWORD per thousand x words
# a block loads a step (its rows' [x | h] of every layer); the rows layout
# ROWS_STEP plus ROWS_PER_MFMA per million FMAs of its rows (the first
# design reads every weight from L2 at each step)
UNIT_STEP, UNIT_PER_MFMA, UNIT_PER_KWORD = 12.5, 11.62, 0.057
# In g > 1 row groups a step's candidates cross the clusters through L2
# in place of the cluster barrier and distributed shared memory that
# UNIT_STEP holds: UNIT_XCHG (the difference of the two exchanges' fixed
# parts: the L2 one's is smaller) plus UNIT_XCHG_PER_BLOCK a block of the
# stream (its arrivals on the one counter); fitted to the same sweep at
# row 6 (g = 2, 4, 8 on clusters of 8 and 16 blocks; rms 0.56 us)
UNIT_XCHG, UNIT_XCHG_PER_BLOCK = -3.02, 0.0772
ROWS_STEP, ROWS_PER_MFMA = 46.3, 7.92

SOURCE = _build.source('gen_beam.cu')
TB_SOURCE = _build.source('gen_traceback.cu')


class GenLayout(NamedTuple):
    cl: int       # blocks a cluster (a stream's row group)
    units: bool   # the unit layout (else the rows layout)
    rh: int       # row halves of the unit layout (0: rows layout)
    tr: int       # rows per staged tile of the unit layout (0: rows)
    smem: int     # dynamic shared memory a block, bytes
    g: int = 1    # row groups a stream, one cluster each (unit layout)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _a4(n: int) -> int:
    return (n + 3) & ~3


def own_rows_cap(R: int) -> int:
    """Rows a block's row tiles run for R own rows (pad rows zero):
    8, 16 or 32 (``rows_cap``, ``own_rows_cap`` in the source)."""
    return 8 if R <= 8 else (16 if R <= 16 else 32)


def rows_plan_bytes(K, cl, D, W, Vp, topk) -> int:
    """A block's dynamic shared memory in the rows layout (``make_plan``):
    its rows ``[xemb | h.. | c..]``, their gates then logits, costs and
    candidates, every row's candidates, the per-row counts and prefixes,
    the own slots' sources."""
    RB, S, G = own_rows_cap(K // cl), (2 * D + 1) * W, max(4 * W, Vp)
    return 4 * (_a4(RB * S) + _a4(RB * G) + _a4(RB) + 2 * _a4(RB * topk)
                + 2 * _a4(K * topk) + 4 * _a4(K) + 2 * _a4(RB) + 4)


def unit_geometry(W: int, cl: int, rh: int = 1, K: int = 0,
                  g: int = 1) -> dict:
    """The unit layout's block (``make_ugeo``): units a block ``upb`` (W
    over the cl/rh unit groups), its gate columns ``nc``, 32-term blocks of
    a column's 2W terms ``nkb``, thread roles ``nrole`` (a column pair's
    block each), row groups of its threads ``nrg``, the padded staged row
    ``xp`` and a block-sum row ``ps`` (floats); with K, the rows a block's
    layers run over ``kh`` (its half of its stream's row group of K/g) and
    its own rows ``own`` (logits and candidates): the block is the same
    whatever g, its rows are not."""
    upb = W // (cl // rh)
    nc, nkb = 4 * upb, 2 * W // KCH
    nrole = nc // 2 * nkb
    out = dict(upb=upb, nc=nc, nkb=nkb, nrole=nrole,
               nrg=UNT // nrole if nrole else 0, xp=2 * W + 4 * nkb + 4,
               ps=nc + upb)
    if K:
        out.update(kh=K // g // rh, own=K // g // cl)
    return out


def units_plan_bytes(K, cl, rh, tr, D, W, Vp, topk, v_real=None,
                     g=1) -> int:
    """A block's dynamic shared memory in the unit layout
    (``make_uplan``): two staged tiles of ``tr`` padded ``[x | h]`` rows
    (then the own rows' top-layer h), three of the own units' old c, two
    tiles' block sums (then the own rows' logits), the own bias, embT's
    ``v_real`` real columns (rounded up to 4), the own rows' costs and
    candidates (K/(g*cl) rows), every row's candidates, the per-row counts
    and prefixes, every slot's source and char, the radix select's 256
    counts."""
    geo = unit_geometry(W, cl, rh)
    RB = own_rows_cap(K // g // cl)
    return 4 * (_a4(max(2 * tr * geo['xp'], RB * W))
                + _a4(3 * tr * geo['upb'])
                + _a4(max(2 * geo['nkb'] * tr * geo['ps'], RB * Vp))
                + _a4(D * geo['nc']) + W * _a4(Vp if v_real is None
                                               else v_real)
                + _a4(RB) + 2 * _a4(RB * topk)
                + 2 * _a4(K * topk) + 7 * _a4(K) + 256 + 4)


def units_ok(K, D, W, cl, rh, tr, v_real=0, g=1) -> bool:
    """Whether the unit layout takes the shape (``units_ok``): K in ``g``
    row groups of :data:`ROW_GROUPS` of KG = K/g rows, one cluster each,
    of cl in :data:`UNIT_CLUSTERS` blocks of ``rh`` in :data:`ROW_HALVES`
    row halves by cl/rh unit groups of W/(cl/rh) units, a multiple of 4
    (the copies of c), D <= 2 (a thread's weights of every layer in
    registers), W a multiple of 16, the roles in UNT threads, tiles of
    ``tr`` in :data:`TILES` rows that split evenly into the row groups
    of the threads and into chains of URT rows, KG/rh a multiple of
    ``tr``, KG a multiple of cl with at most MAX_ROWS own rows a block,
    v_real <= UNIT_MAX_VREAL."""
    if g not in ROW_GROUPS or K % g:
        return False
    KG = K // g
    if cl not in UNIT_CLUSTERS or rh not in ROW_HALVES or not 1 <= D <= 2 \
            or W < cl // rh or W % (cl // rh) or (W // (cl // rh)) % 4 \
            or W % 16 or tr not in TILES or KG % (rh * tr) or KG % cl \
            or KG // cl > MAX_ROWS or v_real > UNIT_MAX_VREAL:
        return False
    g = unit_geometry(W, cl, rh)
    if not 1 <= g['nrole'] <= UNT or tr % g['nrg']:
        return False
    rpt = tr // g['nrg']
    return rpt >= URT and rpt % URT == 0


def _common_ok(topk, v_real, Vp, W) -> bool:
    return 1 <= topk <= MAX_TOPK and v_real <= Vp and Vp % 4 == 0 \
        and W % 4 == 0


def units_layout_for(K, D, W, Vp, topk, cl, rh=1, v_real=None,
                     g=1) -> Optional[GenLayout]:
    """The unit layout on ``g`` clusters of cl blocks a stream in ``rh``
    row halves with the largest tile of :data:`TILES` whose plan fits a
    block's shared memory, or None."""
    v_real = Vp if v_real is None else v_real
    if not _common_ok(topk, v_real, Vp, W):
        return None
    for tr in TILES:
        smem = units_plan_bytes(K, cl, rh, tr, D, W, Vp, topk, v_real, g)
        if units_ok(K, D, W, cl, rh, tr, v_real, g) and smem <= SMEM_MAX:
            return GenLayout(cl, True, rh, tr, smem, g)
    return None


def rows_layout_for(K, D, W, Vp, topk, cl,
                    v_real=None) -> Optional[GenLayout]:
    """The rows layout on cl blocks a stream, or None: cl in
    :data:`ROWS_CLUSTERS`, K a multiple of cl with at most MAX_ROWS rows
    a block, its plan in a block's shared memory."""
    if cl not in ROWS_CLUSTERS or K % cl or K // cl > MAX_ROWS \
            or not _common_ok(topk, Vp if v_real is None else v_real, Vp,
                              W):
        return None
    smem = rows_plan_bytes(K, cl, D, W, Vp, topk)
    return GenLayout(cl, False, 0, 0, smem) if smem <= SMEM_MAX else None


def gen_layouts(K, D, W, Vp, topk, v_real=None) -> list:
    """Every layout that takes the shape: the unit layout at each size of
    :data:`UNIT_CLUSTERS` and of :data:`ROW_HALVES` on one cluster a
    stream, the rows layout at each of :data:`ROWS_CLUSTERS`, then the
    unit layout in each number of :data:`ROW_GROUPS` above one."""
    out = [units_layout_for(K, D, W, Vp, topk, cl, rh, v_real)
           for cl in UNIT_CLUSTERS for rh in ROW_HALVES]
    out += [rows_layout_for(K, D, W, Vp, topk, cl, v_real)
            for cl in ROWS_CLUSTERS]
    out += [units_layout_for(K, D, W, Vp, topk, cl, rh, v_real, g)
            for g in ROW_GROUPS[1:] for cl in UNIT_CLUSTERS
            for rh in ROW_HALVES]
    return [lay for lay in out if lay is not None]


def step_cost(lay: GenLayout, K, D, W, v_real) -> float:
    """The cost model of one step of one cluster in microseconds (the
    constants above); in row groups a cluster computes K/g rows and the
    step adds the exchange through L2."""
    rows = K // lay.g
    own = rows // lay.cl * W * v_real
    if lay.units:
        fmas = rows * D * 2 * W * 4 * W // lay.cl + own
        words = rows // lay.rh * D * 2 * W   # x words a block loads a step
        return UNIT_STEP + UNIT_PER_MFMA * fmas / 1e6 \
            + UNIT_PER_KWORD * words / 1e3 \
            + (UNIT_XCHG + UNIT_XCHG_PER_BLOCK * lay.g * lay.cl
               if lay.g > 1 else 0.0)
    return ROWS_STEP + ROWS_PER_MFMA * (
        K // lay.cl * D * 2 * W * 4 * W + own) / 1e6


def choose(N, K, D, W, Vp, topk, v_real, fits: Callable[[GenLayout], int]
           ) -> GenLayout:
    """The layout of a launch of N streams: of :func:`gen_layouts` that
    the card holds (``fits(layout)``: how many clusters of it at once;
    row groups only where all N*g clusters fit at once), the lowest
    :func:`step_cost` times the waves of clusters wins, ties to the unit
    layout, then to more row groups (the model rates g groups of cl
    blocks as g/2 groups of 2cl; the smaller clusters measured faster:
    27.2 against 27.7 us a step at row 6), then to more blocks.  Raises
    ValueError where no layout takes the shape or none fits the card."""
    best = None
    for lay in gen_layouts(K, D, W, Vp, topk, v_real):
        at_once = fits(lay)
        if lay.g > 1 and at_once < N * lay.g:
            continue
        if at_once > 0:
            key = (step_cost(lay, K, D, W, v_real) * _ceil(N, at_once),
                   not lay.units, -lay.g, -lay.cl)
            if best is None or key < best[0]:
                best = (key, lay)
    if best is None:
        raise ValueError(
            'gen_beam: no layout takes K=%d, D=%d, W=%d, Vp=%d, topk=%d, '
            'v_real=%d on this card (unit layout: D <= 2, W a multiple of '
            '16 in %s blocks, K a multiple of 16; rows layout: at most %d '
            'rows a block of %s; both: shared memory <= %d bytes)'
            % (K, D, W, Vp, topk, v_real, UNIT_CLUSTERS, MAX_ROWS,
               ROWS_CLUSTERS, SMEM_MAX))
    return best[1]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gen_beam_launch.argtypes = [P] * 8 + [I] * 9 + [F, P]
    lib.gen_beam_launch.restype = ctypes.c_int
    lib.gen_beam_smem_bytes.argtypes = [I] * 6
    lib.gen_beam_smem_bytes.restype = ctypes.c_size_t
    lib.gen_beam_max_clusters.argtypes = [I] * 6
    lib.gen_beam_max_clusters.restype = ctypes.c_int
    lib.gen_beam_units_launch.argtypes = [P] * 13 + [I] * 12 + [F, P]
    lib.gen_beam_units_launch.restype = ctypes.c_int
    lib.gen_beam_units_smem_bytes.argtypes = [I] * 10
    lib.gen_beam_units_smem_bytes.restype = ctypes.c_size_t
    lib.gen_beam_units_max_clusters.argtypes = [I] * 10
    lib.gen_beam_units_max_clusters.restype = ctypes.c_int
    return lib


def clusters_that_fit(index, K, D, W, Vp, topk, v_real,
                      lay: GenLayout) -> int:
    """How many clusters of ``lay`` CUDA device ``index`` holds at once
    (``cudaOccupancyMaxActiveClusters``; 0 where none, and for row groups
    where the card takes no cooperative launch)."""
    return _fits(index, lay.cl, lay.units, lay.rh, lay.tr, lay.g, K, D, W,
                 Vp, topk, v_real)


@functools.lru_cache(maxsize=None)
def _fits(index, cl, units, rh, tr, g, K, D, W, Vp, topk, v_real) -> int:
    with torch.cuda.device(index):
        if units:
            return _library().gen_beam_units_max_clusters(
                cl, rh, tr, g, K, D, W, Vp, v_real, topk)
        return _library().gen_beam_max_clusters(cl, K, D, W, Vp, topk)


# CUDA devices that refused a launch in row groups (a cooperative
# launch of clusters): they take one cluster a stream from then on
_GROUPS_REFUSED: set = set()


@functools.lru_cache(maxsize=None)
def _layout(index, N, K, D, W, Vp, topk, v_real) -> GenLayout:
    def fits(lay):
        if lay.g > 1 and index in _GROUPS_REFUSED:
            return 0
        return clusters_that_fit(index, K, D, W, Vp, topk, v_real, lay)
    return choose(N, K, D, W, Vp, topk, v_real, fits)


def layout_on(device, N, K, D, W, Vp, topk, v_real) -> GenLayout:
    """:func:`choose` for CUDA ``device``, cached per device and shape
    (``_layout.cache_clear()`` drops the cache)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _layout(index, N, K, D, W, Vp, topk, v_real)


@functools.lru_cache(maxsize=None)
def _tb_library() -> ctypes.CDLL:
    lib = _build.load(TB_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gen_traceback_launch.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.gen_traceback_launch.restype = ctypes.c_int
    for name in ('gen_traceback_maps_smem_bytes',
                 'gen_traceback_walk_smem_bytes'):
        getattr(lib, name).argtypes = [I, I]
        getattr(lib, name).restype = ctypes.c_size_t
    return lib


class TbLayout(NamedTuple):
    L: int           # steps a segment
    G: int           # segments of the walked steps (maps launched if > 1)
    Gt: int          # segments of all T steps (walk blocks a stream)
    maps_smem: int   # dynamic shared memory a maps block, bytes
    walk_smem: int   # dynamic shared memory a walk block, bytes


def tb_layout(T: int, K: int, out_length: int,
              segment: Optional[int] = None) -> TbLayout:
    """The segments of the traceback of a stream of T steps and K slots
    walked from step ``out_length - 1`` (``segment`` forces the steps a
    segment; every stream of a launch is cut the same way), with each
    launch's shared memory as the source computes it
    (``gen_traceback_*_smem_bytes``)."""
    if segment is None:
        if out_length <= TB_SEG_MAX:
            segment = min(T, TB_SEG_MAX)
        else:
            segment = min(max(_ceil(out_length, TB_SEGS), TB_SEG_MIN),
                          TB_SEG_MAX)
    L = int(segment)
    if not 1 <= L <= TB_SEG_MAX:
        raise ValueError('a traceback segment takes 1..%d steps, got %d'
                         % (TB_SEG_MAX, L))
    sub = TB_NT // K if K < TB_NT else 1
    return TbLayout(L, _ceil(out_length, L), _ceil(T, L),
                    4 * sub * K + L * K,
                    4 * TB_NT * (L | 1) + TB_MAPS * K + L * K)


def log_threshold(threshold: float) -> float:
    """The log-probability threshold as the kernels compare it: the
    float32 log of the float32 threshold."""
    return float(np.float32(np.log(np.float32(threshold))))


def gen_beam(emb, embT, wcat, bias, state0, cost0, *, length: int,
             v_real: int, topk: int = 10, threshold: float = 0.004,
             final_state: bool = False):
    """``length`` beam steps of N independent streams in one launch.

    emb: (Vp, W); embT: (W, Vp); wcat: (D, 2W, 4W) fused
    ``[input-kernel; recurrent-kernel]``; bias: (D, 1, 4W) (context
    folded into layer 0); state0: (N, K, S) prefix-conditioned fringes;
    cost0: (N, K) (``BIG`` = dead).  Returns the records (N, length, 3,
    K) float32, with ``final_state`` also the fringe state after the last
    step (N, K, S) (its costs are the last records' costs)."""
    tensors = (emb, embT, wcat, bias, state0, cost0)
    device = _build.one_device('gen_beam', tensors)
    if device.type == 'cpu':
        return gen_beam_ref(emb, embT, wcat, bias, state0, cost0,
                            length=length, v_real=v_real, topk=topk,
                            threshold=threshold, final_state=final_state)
    if device.type != 'cuda':
        raise ValueError('gen_beam runs on cpu or cuda, not %s' % device)
    Vp, W = emb.shape
    D = wcat.shape[0]
    N, K, S = state0.shape
    TOPK = min(int(topk), int(v_real))
    if (S != (2 * D + 1) * W or W % 4 or K % 8 or K // 8 > MAX_ROWS
            or not 1 <= TOPK <= MAX_TOPK or v_real > Vp or Vp % 4
            or length < 1 or N < 1):
        raise ValueError(
            'gen_beam kernel needs S = (2D+1)W, W %% 4 == 0, K a multiple '
            'of 8 with at most %d rows a block, 1 <= min(topk, v_real) <= '
            '%d, v_real <= Vp, Vp %% 4 == 0, length >= 1 (got S=%d, D=%d, '
            'W=%d, K=%d, topk=%d, v_real=%d, Vp=%d, length=%d, N=%d)'
            % (MAX_ROWS, MAX_TOPK, S, D, W, K, topk, v_real, Vp, length, N))
    f32 = torch.float32
    for name, t, shape in (
            ('emb', emb, (Vp, W)), ('embT', embT, (W, Vp)),
            ('wcat', wcat, (D, 2 * W, 4 * W)), ('bias', bias, (D, 1, 4 * W)),
            ('state0', state0, (N, K, S)), ('cost0', cost0, (N, K))):
        _check(name, t, shape, f32, device)
    lay = layout_on(device, N, K, D, W, Vp, TOPK, int(v_real))
    rec = torch.empty((N, length, 3, K), dtype=f32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if lay.units:
            # every row's h and c by step parity (L2-resident) and the
            # fringe after the last step
            hc = torch.empty((2, N, 2, D, K, W), dtype=f32, device=device)
            fin = torch.empty((N, K, S), dtype=f32, device=device) \
                if final_state else None
            xc = xh = flags = None
            if lay.g > 1:
                # the step's candidates by parity, one counter a stream
                xc = torch.empty((2, N, K * TOPK), dtype=f32, device=device)
                xh = torch.empty((2, N, K * TOPK), dtype=torch.int32,
                                 device=device)
                flags = torch.zeros((N,), dtype=torch.int32, device=device)
            status = lib.gen_beam_units_launch(
                emb.data_ptr(), embT.data_ptr(), wcat.data_ptr(),
                bias.data_ptr(), state0.data_ptr(), cost0.data_ptr(),
                rec.data_ptr(), hc[0].data_ptr(), hc[1].data_ptr(),
                *(t.data_ptr() if t is not None else None
                  for t in (fin, xc, xh, flags)),
                lay.cl, lay.rh, lay.tr, lay.g, N, length, K, D, W, Vp,
                int(v_real), TOPK, log_threshold(threshold), stream)
        else:
            # the fringe state, double-buffered in device memory
            scratch = torch.empty((2, N, K, S), dtype=f32, device=device)
            fin = scratch[(length - 1) & 1]
            status = lib.gen_beam_launch(
                emb.data_ptr(), embT.data_ptr(), wcat.data_ptr(),
                bias.data_ptr(), state0.data_ptr(), cost0.data_ptr(),
                rec.data_ptr(), scratch.data_ptr(), lay.cl, N, length, K,
                D, W, Vp, int(v_real), TOPK, log_threshold(threshold),
                stream)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if status != 0 and lay.g > 1 and index not in _GROUPS_REFUSED:
        # CUDA refused the cooperative launch of the row groups:
        # the device takes one cluster a stream from now on
        _GROUPS_REFUSED.add(index)
        _layout.cache_clear()
        return gen_beam(emb, embT, wcat, bias, state0, cost0,
                        length=length, v_real=v_real, topk=topk,
                        threshold=threshold, final_state=final_state)
    if status != 0:
        raise RuntimeError(
            'gen_beam kernel launch failed: CUDA error %d (%d bytes of '
            'shared memory asked a block, %d blocks a cluster, %d '
            'cluster(s) a stream, the %s layout)'
            % (status, lay.smem, lay.cl, lay.g,
               'unit' if lay.units else 'rows'))
    _build.count(gen_beam)
    if lay.g > 1:
        _build.count(gen_beam, 'row_groups', lay.g)
    return (rec, fin) if final_state else rec


gen_beam.launches = 0
gen_beam.row_groups = 0   # the row groups of its launches in row groups


def traceback(rec, best, out_length: int, segment: Optional[int] = None):
    """Walk the records (N, T, 3, K) back from the slots ``best``
    (N, VARS) at step ``out_length - 1``; returns (N, VARS, T) int32
    char ids in forward order, 0 at steps >= ``out_length``.

    The TPU kernel walks its cursors in chunks sized to its scalar
    memory (``_TB_SMEM_OUT_BYTES``).  On the card the steps are cut into
    segments (:func:`tb_layout`; ``segment`` forces the steps a
    segment): one launch maps each segment's entry slots to its exit
    slots, a second composes those maps from every cursor's end slot and
    walks and gathers each segment in parallel (one launch where a
    segment holds every walked step).  One call counts one launch."""
    device = _build.one_device('traceback', (rec, best))
    if device.type == 'cpu':
        return traceback_ref(rec, best, out_length)
    if device.type != 'cuda':
        raise ValueError('traceback runs on cpu or cuda, not %s' % device)
    N, T, _, K = rec.shape
    VARS = best.shape[1] if best.dim() == 2 else 0
    if not (1 <= out_length <= T and 1 <= VARS <= MAX_VARIANTS
            and 4 <= K <= TB_MAX_SLOTS and K % 4 == 0 and N <= 65535):
        raise ValueError('traceback kernel needs 1 <= out_length <= T, '
                         '1 <= VARS <= %d, K <= %d slots (a multiple of 4) '
                         'and at most 65535 streams (got out_length=%d, rec '
                         '%s, best %s)' % (MAX_VARIANTS, TB_MAX_SLOTS,
                                           out_length, tuple(rec.shape),
                                           tuple(best.shape)))
    _check('rec', rec, (N, T, 3, K), torch.float32, device)
    _check('best', best, (N, VARS), torch.int32, device)
    lay = tb_layout(T, K, int(out_length), segment)
    out = torch.empty((N, VARS, T), dtype=torch.int32, device=device)
    maps = torch.empty((N * lay.G * K if lay.G > 1 else 0,),
                       dtype=torch.uint8, device=device)
    lib = _tb_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.gen_traceback_launch(
            rec.data_ptr(), best.data_ptr(), maps.data_ptr(),
            out.data_ptr(), N, T, K, VARS, int(out_length), lay.L, stream)
    if status != 0:
        raise RuntimeError('gen_traceback kernel launch failed: CUDA error '
                           '%d (segments of %d steps, %d and %d bytes of '
                           'shared memory a block)'
                           % (status, lay.L, lay.maps_smem, lay.walk_smem))
    _build.count(traceback)
    return out


traceback.launches = 0


def gen_beam_ref(emb, embT, wcat, bias, state0, cost0, *, length: int,
                 v_real: int, topk: int = 10, threshold: float = 0.004,
                 final_state: bool = False):
    """Plain PyTorch version of :func:`gen_beam` (same arguments, same
    records), for CPU tensors: each row's top TOPK is a stable
    descending sort of its logits (ties to the smaller char id), the
    selection a stable ascending sort of the flat candidates cut at K
    and put back into flat-index order."""
    from .beam_device import _gen_layers
    N, K, S = state0.shape
    device = state0.device
    TOPK = min(int(topk), int(v_real))
    log_thresh = log_threshold(threshold)
    jiota = torch.arange(TOPK, device=device)
    base = (torch.arange(N, device=device) * K)[:, None]
    state = state0.reshape(N * K, S)
    cost = cost0.reshape(N * K, 1)
    recs = []
    for _ in range(length):
        hs, logits = _gen_layers(emb, embT, wcat, bias, v_real, state)
        mx = logits.max(dim=1, keepdim=True).values
        lse = mx + torch.log(torch.exp(logits - mx).sum(dim=1, keepdim=True))
        top = torch.sort(logits, dim=1, descending=True, stable=True)
        val, idx = top.values[:, :TOPK], top.indices[:, :TOPK]
        cand = cost + torch.clamp(lse - val, min=0.0)
        cand = torch.where(val - lse < log_thresh, BIG, cand)
        cand = torch.where(cost >= BIG / 2, BIG, cand)
        # the char-0 candidate leaves by a shift of the row's tail
        pos0 = torch.where(idx == 0, jiota, TOPK).min(dim=1,
                                                      keepdim=True).values
        tail = jiota >= pos0
        cand = torch.where(tail, torch.cat(
            [cand[:, 1:], torch.full_like(cand[:, :1], BIG)], 1), cand)
        idx = torch.where(tail, torch.cat(
            [idx[:, 1:], torch.zeros_like(idx[:, :1])], 1), idx)
        cand = torch.clamp(cand, max=BIG)
        flat = cand.reshape(N, K * TOPK)
        sel = torch.sort(torch.sort(flat, dim=1, stable=True).indices[:, :K],
                         dim=1).values
        row = torch.div(sel, TOPK, rounding_mode='floor')
        new_cost = flat.gather(1, sel)
        char = idx.reshape(N, K * TOPK).gather(1, sel)
        recs.append(torch.stack([char.float(), row.float(), new_cost], 1))
        state = torch.cat([emb[char.reshape(-1)],
                           hs[(row + base).reshape(-1)]], 1)
        cost = new_cost.reshape(N * K, 1)
    rec = torch.stack(recs, 1)
    return (rec, state.reshape(N, K, S)) if final_state else rec


def traceback_ref(rec, best, out_length: int):
    """Plain PyTorch version of :func:`traceback`."""
    N, T, _, K = rec.shape
    best = best.long()
    out = torch.zeros((N, best.shape[1], T), dtype=torch.int32,
                      device=rec.device)
    k = best
    for t in range(int(out_length) - 1, -1, -1):
        out[:, :, t] = rec[:, t, 0].gather(1, k).int()
        k = rec[:, t, 1].gather(1, k).long()
    return out


def _prefix_fringe(emb, embT, wcat, bias, prefix, prefix_mask, v_real,
                   fringe):
    """The initial fringes of N streams conditioned on their prefixes:
    every row holds the stream's root state, slot 0 alone is alive.
    prefix, prefix_mask: (N, P) numpy (see ``beam_device._prefix_state``).
    Returns (state0 (N, K, S), cost0 (N, K))."""
    from .beam_device import _prefix_state
    root = _prefix_state(emb, wcat, bias, prefix, prefix_mask)
    N, S = root.shape
    state0 = root[:, None, :].expand(N, fringe, S).contiguous()
    cost0 = torch.full((N, fringe), BIG, dtype=torch.float32,
                       device=root.device)
    cost0[:, 0] = 0.0
    return state0, cost0


def generate_variants(emb, embT, wcat, bias, prefix, prefix_mask,
                      length: int, out_length: int, v_real: int,
                      variants: int, topk: int = 10, fringe: int = 256,
                      threshold: float = 0.004):
    """Prefix conditioning, the beam search over ``length`` steps (one
    :func:`gen_beam` launch for all N streams) and the ``variants``
    cheapest end slots at step ``out_length - 1`` walked back (one
    :func:`traceback` launch).  Slots order by ascending cost, ties by
    slot index (a stable argsort); ``variants`` must not exceed
    ``fringe`` (only that many end slots exist).  Returns (seqs (N,
    variants, length) int32, valid in [0, out_length); costs (N,
    variants))."""
    if not 1 <= variants <= fringe:
        raise ValueError('variants must lie in 1..fringe (%d), got %d'
                         % (fringe, variants))
    state0, cost0 = _prefix_fringe(emb, embT, wcat, bias, prefix,
                                   prefix_mask, v_real, fringe)
    rec = gen_beam(emb, embT, wcat, bias, state0, cost0, length=length,
                   v_real=v_real, topk=topk, threshold=threshold)
    costs_out = rec[:, out_length - 1, 2]
    order = torch.argsort(costs_out, dim=1, stable=True)[:, :variants]
    seqs = traceback(rec, order.int().contiguous(), out_length)
    return seqs, costs_out.gather(1, order)


def generate_best(emb, embT, wcat, bias, prefix, prefix_mask, length: int,
                  out_length: int, v_real: int, topk: int = 10,
                  fringe: int = 256, threshold: float = 0.004):
    """:func:`generate_variants` at one variant: (seqs (N, length),
    costs (N,)); the stable argsort takes the smallest slot at equal
    cost, as an argmin does."""
    seqs, costs = generate_variants(
        emb, embT, wcat, bias, prefix, prefix_mask, length, out_length,
        v_real, 1, topk, fringe, threshold)
    return seqs[:, 0], costs[:, 0]
