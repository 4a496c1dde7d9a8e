"""How the LSTM recurrence kernels lay a launch out on the card: the two
forward recurrences and the backward's chain.

Pure host arithmetic, shared by :mod:`.lstm_cell` (``csrc/lstm_scan.cu``,
kind ``lstm``; ``csrc/lstm_bwd.cu``, kind ``bwd``) and
:mod:`.score_kernel` (``csrc/score_scan.cu``, kind ``score``); the
sources refuse a launch whose layout or shared-memory size differs from
what this module computes (``reg_layout_ok`` in ``scan_common.cuh``,
``bwd_layout_ok`` in ``lstm_bwd.cu``).

Two layouts:

* the register layout (``reg``), where a block's columns times 32-term
  blocks fit its threads (2, 4 or 8 blocks of 32 terms a column: W in
  (32, 64], (96, 128] or (224, 256]): a group of ``rb`` streams runs on a
  thread-block cluster of ``cl`` blocks; block k owns the units
  ``[k*upb, (k+1)*upb)`` (``upb = ceil(W/cl)``; the last block may own
  fewer) and the four gate columns of each; each thread keeps the 32
  weights of one column's 32-term block in registers for the whole scan
  (of both matrices of a layer above 0 in ``score``) and runs ``rt``
  streams in its chain; a block holds only the padded h rows of every
  layer in shared memory.  In ``bwd`` a lane keeps the 32 weights of one
  32-term block of two of a unit's four quarters of U^T (the W-term sums
  of ``dh = dz @ U^T``) and a block holds the padded dz rows (4W a
  stream);
* the one-block layout of the first port everywhere else, and where
  its cost model rates it faster (a large B, whose clusters would run in
  many waves one after another): blocks of ``rows_per_block(B)``
  streams, fewer where a block's rows would not fit its shared memory
  (:func:`one_block_rows`: the backward at W=512 takes 4), each thread
  running whole columns from weights read from L2 at every step.

* the grid layout (``grid``) of the forward and the backward's chain at
  W=512, where a column has 16 blocks of 32 terms and the register
  layout's groups would not fit a block: a group of ``rb`` streams runs
  on ``cl = W/16`` blocks of 256 threads, one block an SM, every group
  of the launch resident at once (``n_sm // cl`` groups at most, so
  ``rb = ceil(B / groups)``); block k owns 16 units, whose 64 columns x
  W terms a block's threads keep in registers (128 weights a thread) for
  the whole launch; the rows a step reads cross the group's blocks
  through device memory, each block arriving on the group's counter
  after writing its units, and are staged into shared memory in chunks
  of ``rt`` streams.

* the wide layout (``wide``) of the forward and the backward's chain at
  widths no other layout takes (W > 512; ``csrc/wide_common.cuh``): one
  block an SM, every block resident at once (a cooperative launch), each
  step a product of all B <= 128 streams' rows with the block's 64
  packed columns of U (forward: the four gate columns of 16 units;
  backward: one quarter of U^T for 64 units), the rows and the columns
  streamed into shared memory by TMA in 32-term chunks, since U (54 MB
  at W = 1840) fits neither a block nor L2; the rows a step writes cross
  the blocks through device memory behind the launch's one counter (the
  backward's chain: two a step, the quarters' sums then the gate
  derivatives).

All give the same bits: each column's dot product is summed in blocks
of 32 terms, the blocks added to 0 in order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

NT = 512             # threads per block
KCH = 32             # terms per partial sum
RBMAX = 8            # streams per block or cluster
SMEM_MAX = 232448    # dynamic shared memory a block may ask (Hopper)
CLUSTERS = (1, 2, 4, 8, 16)   # blocks per cluster of the register layout
MIN_UNITS = 8        # units a block owns at least (else fewer blocks)
# the cost model of a step, in microseconds, fitted to the times of
# gen_beam_phases.py scan on an H100 (its layout sweep at rows 3, 4s, 4t
# and 4b of PERF.md, and its widths): a register-layout step costs
# REG_STEP, REG_PER_ROW per stream of a thread's chain and REG_PER_BLOCK
# per NT threads a layer; a one-block step ONE_PER_FMA per FMA of one
# thread's serial work (streams x W terms x the columns it runs, for
# each weight matrix of the step and, in score, the logits)
REG_STEP, REG_PER_ROW, REG_PER_BLOCK = 0.656, 0.498, 0.254
ONE_PER_FMA = 0.0098
# streams one thread's chain takes at most (its registers hold them
# beside 64 weights and their step's loads; more spill; the backward's
# lanes, whose loads wait in one lane a row, take 4), and the gate columns a lane holds (lstm: two, so one load
# of h feeds two FMAs; score: one of each of a layer's two matrices;
# bwd: two quarters of U^T, whose terms are the dz of two gates)
REG_RT_MAX = 2
REG_RT_MAX_OF = {'lstm': REG_RT_MAX, 'score': REG_RT_MAX, 'bwd': 4}
REG_GATES = {'lstm': 2, 'score': 1, 'bwd': 2}
# the grid layout: units a block, 32-term blocks of a W-term sum (so
# W = 512), streams a staged chunk (GRID_RT in lstm_scan.cu and
# lstm_bwd.cu; at most 16, one of a block's 256 threads a stream and
# unit) and the partial sums' row of one 32-term block, padded
# (GRID_PS in the sources: a block's 64 gate columns, or a quarter's 16
# units); its cost model a step in microseconds, GRID_STEP and
# GRID_PER_ROW per stream of a group, fitted to gen_beam_phases.py wide
GRID_UNITS, GRID_NKB = 16, 16
GRID_RT = {'lstm': 16, 'bwd': 8}
GRID_PS = {'lstm': 4 * GRID_UNITS + 4, 'bwd': GRID_UNITS + 4}
GRID_GV = 8          # bwd: a (stream, unit)'s gate values, padded
GRID_STEP = {'lstm': 2.56, 'bwd': 4.31}
GRID_PER_ROW = {'lstm': 0.3039, 'bwd': 0.805}
# the wide layout (WIDE_* in csrc/wide_common.cuh): widths it takes
# (above the grid layout's), streams at most, columns a block, units a
# forward block, stages of a block's ring; its cost model a step in
# microseconds, WIDE_STEP (the counter's waits, the ring's first chunks,
# the gate update; the chain's two waits and its gate derivatives) and
# WIDE_PER_CHUNK per 32-term chunk of a W-term sum (every block runs
# all 128 rows, so B does not enter), fitted to gen_beam_phases.py
# wide1840 on an H100 (forward: 104.7-109.4 us a step at W=1840 and
# 63.8 at W=1024; the chain: 126.6 at W=1840)
WIDE_MIN_W = GRID_NKB * KCH
WIDE_RB, WIDE_NC, WIDE_UPB, WIDE_ST = 128, 64, 16, 8
# dynamic shared memory of a block of the wide layout, whatever B: 1024
# bytes to align the ring, WIDE_ST stages of a chunk's rows (room for
# WIDE_RB rows of 32 floats: a thread reads its rows past B too) and
# its 32 x WIDE_NC packed columns, an mbarrier a stage
# (WIDE_SMEM_BYTES in csrc/wide_common.cuh)
WIDE_SMEM = 1024 + WIDE_ST * (WIDE_RB + WIDE_NC) * KCH * 4 + WIDE_ST * 8
WIDE_STEP = {'lstm': 13.1, 'bwd': 34.7}
WIDE_PER_CHUNK = {'lstm': 1.585, 'bwd': 1.585}


class Layout(NamedTuple):
    rb: int      # streams per block, cluster or group
    cl: int      # blocks per cluster or group
    rt: int      # streams per thread chain, or a staged chunk's (grid);
    #              0 in the wide layout
    smem: int    # dynamic shared memory per block, bytes
    reg: bool    # the register layout

    @property
    def grid(self) -> bool:
        """The grid layout: not the register layout, and a group of more
        blocks than a cluster holds (the one-block layout has one) that
        stages its rows in chunks (rt > 0: not the wide layout)."""
        return not self.reg and self.rt > 0 and self.cl > CLUSTERS[-1]

    @property
    def wide(self) -> bool:
        """The wide layout: not the register layout, and no stream split
        of a thread or a chunk (rt = 0; every block runs all B rows)."""
        return not self.reg and self.rt == 0


def rows_per_block(B: int) -> int:
    """The power of two >= B, at most RBMAX (the one-block layout's
    streams per block)."""
    rb = 1
    while rb < B and rb < RBMAX:
        rb *= 2
    return rb


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _kind(kind: str) -> str:
    if kind not in REG_GATES:
        raise ValueError('kind is lstm or score (the forward scans) or bwd '
                         '(the backward), not %r' % kind)
    return kind


def units_per_block(W: int, cl: int) -> int:
    return _ceil(W, cl)


def padded_width(W: int) -> int:
    """A padded h row of the register layout: 4 floats after each
    32-term block (``scan_common.cuh`` ``hpad``)."""
    return W + 4 * _ceil(W, KCH)


def quarter_width(W: int) -> int:
    """A quarter of a dz row of the backward's register layout: the
    padded width, rounded up to 8 (mod 16) floats (``lstm_bwd.cu``
    ``quarter_width``), so that a lane group's float4 loads of two
    quarters fall into distinct banks."""
    wp = padded_width(W)
    return wp + (24 - wp % 16) % 16


def layer_groups(kind: str, D: int) -> int:
    return D if _kind(kind) == 'score' else 1


def reg_lanes(kind: str, W: int) -> int:
    """Lanes of one unit's group in the register layout: one per gate
    pair (``lstm``), gate (``score``) or quarter of U^T (``bwd``) and
    32-term block."""
    return 4 // REG_GATES[_kind(kind)] * _ceil(W, KCH)


def reg_group_threads(kind: str, W: int, rb: int, cl: int, rt: int) -> int:
    """Threads one layer group of the register layout takes: a group of
    :func:`reg_lanes` per stream group and unit, rounded up to whole
    warps."""
    n = (rb // rt) * units_per_block(W, cl) * reg_lanes(kind, W)
    return (n + 31) & ~31


def plan_bytes(kind: str, W: int, D: int, rb: int, reg: bool,
               bf16: bool = False, Vp: int = 0) -> int:
    """Dynamic shared memory of one block, in bytes.  The register
    layout: the padded h rows of every layer, double-buffered
    (``layer_groups`` x 2 x rb x ``padded_width``), and two mbarriers a
    layer; ``bwd`` the padded dz rows (2 x rb x 4 x
    :func:`quarter_width`) and two mbarriers.  The one-block layout: ``lstm`` h, c and z rows
    (rb x (W + W + 4W)) and, under a bf16 U (``bf16``), h rounded to bf16
    (rb x W); ``score`` the carry (2 x D x rb x W) and z rows (rb x
    max(4W, Vp)); ``bwd`` h, dh and dc rows, z and dz rows and the four
    partial sums of dh (rb x (3W + 2 x 4W + 4W))."""
    if reg:
        if _kind(kind) == 'bwd':
            return 4 * 2 * rb * 4 * quarter_width(W) + 16
        return layer_groups(kind, D) * (4 * 2 * rb * padded_width(W) + 16)
    if _kind(kind) == 'bwd':
        return 4 * rb * 15 * W
    if kind == 'lstm':
        return 4 * rb * (6 * W + (W if bf16 else 0))
    return 4 * (2 * D * rb * W + rb * max(4 * W, Vp))


def grid_plan_bytes(kind: str, W: int, rb: int, rt: int) -> int:
    """Dynamic shared memory of one block of the grid layout, in bytes:
    1024 to align the rows for the copies' swizzle, the ring of two
    chunks of ``rt`` staged rows (``lstm``: h; ``bwd``: dz), the partial
    sums of a chunk
    (rt x 16 x ``GRID_PS``, in ``bwd`` for each quarter), in ``bwd`` the
    values of a chunk's gate derivatives that do not depend on dh (rt x
    16 x ``GRID_GV``), the carried state of the group's units (c, or dc:
    rb x 16) and the two buffers' mbarriers."""
    rows = W if kind == 'lstm' else 4 * W
    sums = GRID_NKB * GRID_PS[kind] * (1 if kind == 'lstm' else 4)
    vals = 0 if kind == 'lstm' else rt * GRID_UNITS * GRID_GV
    return 1024 + 4 * (2 * rt * rows + rt * sums + vals
                       + rb * GRID_UNITS) + 16


def grid_groups(W: int, n_sm: int) -> int:
    """Groups of the grid layout the card holds at once: one block an
    SM, ``W / GRID_UNITS`` blocks a group."""
    return n_sm // (W // GRID_UNITS)


def grid_layout_for(kind: str, B: int, W: int,
                    rb: int) -> Optional[Layout]:
    """The grid layout of B streams in groups of ``rb``, or None where it
    does not fit: kinds ``lstm`` and ``bwd``, W = 512 (16 blocks of 32
    terms a column), 1 <= rb <= B, chunks of ``min(rb, GRID_RT[kind])``
    streams halved until the plan fits a block's shared memory."""
    if kind not in GRID_RT or W != GRID_NKB * KCH or not 1 <= rb <= B:
        return None
    rt = min(rb, GRID_RT[kind])
    while rt > 1 and grid_plan_bytes(kind, W, rb, rt) > SMEM_MAX:
        rt //= 2
    smem = grid_plan_bytes(kind, W, rb, rt)
    if smem > SMEM_MAX:
        return None
    return Layout(rb, W // GRID_UNITS, rt, smem, False)


def wide_blocks(kind: str, W: int) -> int:
    """Blocks of the wide layout: ``lstm`` one a ``WIDE_UPB`` units
    (their four gate columns), ``bwd`` one a ``WIDE_NC`` units of each
    quarter of U^T."""
    if kind == 'lstm':
        return _ceil(W, WIDE_UPB)
    return 4 * _ceil(W, WIDE_NC)


def wide_layout_for(kind: str, B: int, W: int,
                    n_sm: int) -> Optional[Layout]:
    """The wide layout of B streams, or None where it does not take
    them: kinds ``lstm`` and ``bwd``, W > ``WIDE_MIN_W`` (wider than the
    grid layout) and a multiple of 4, 1 <= B <= ``WIDE_RB``, and
    :func:`wide_blocks` at most ``n_sm`` (one block an SM)."""
    if kind not in GRID_RT or W <= WIDE_MIN_W or W % 4 or \
            not 1 <= B <= WIDE_RB or wide_blocks(kind, W) > n_sm:
        return None
    return Layout(B, wide_blocks(kind, W), 0, WIDE_SMEM, False)


def one_block_rows(kind: str, B: int, W: int, D: int, bf16: bool = False,
                   Vp: int = 0) -> int:
    """Streams a block of the one-block layout: the largest power of two
    <= ``rows_per_block(B)`` whose plan fits a block's shared memory
    (``rows_per_block(B)`` itself up to W=256; 4 for the backward at
    W=512), at least 1."""
    rb = rows_per_block(B)
    while rb > 1 and plan_bytes(kind, W, D, rb, False, bf16, Vp) > SMEM_MAX:
        rb //= 2
    return rb


def one_block_layout(kind: str, B: int, W: int, D: int, bf16: bool = False,
                     Vp: int = 0) -> Layout:
    """The first port's layout: one block of :func:`one_block_rows`
    streams, each thread running every stream of its columns, and
    ``ceil(B / rb)`` blocks."""
    rb = one_block_rows(kind, B, W, D, bf16, Vp)
    return Layout(rb, 1, rb, plan_bytes(kind, W, D, rb, False, bf16, Vp),
                  False)


def reg_layout_for(kind: str, W: int, D: int, rb: int,
                   cl: int) -> Optional[Layout]:
    """The register layout of ``rb`` streams on ``cl`` blocks, or None
    where it does not fit: 2, 4 or 8 blocks of 32 terms a column, every
    block owning a unit, and ``layer_groups`` groups of threads of at
    most ``REG_RT_MAX_OF[kind]`` streams a chain in a block's NT threads;
    the most row groups that fit win."""
    nkb = _ceil(W, KCH)
    if nkb not in (2, 4, 8) or W % 4 or rb not in (1, 2, 4, RBMAX) or \
            cl not in CLUSTERS or (cl - 1) * units_per_block(W, cl) >= W:
        return None
    rt = max(1, rb // RBMAX)
    while rt <= min(rb, REG_RT_MAX_OF[kind], reg_lanes(kind, W)):
        if layer_groups(kind, D) * reg_group_threads(kind, W, rb, cl,
                                                     rt) <= NT:
            return Layout(rb, cl, rt, plan_bytes(kind, W, D, rb, True),
                          True)
        rt *= 2
    return None


def step_cost(kind: str, W: int, D: int, layout: Layout,
              Vp: int = 0) -> float:
    """The cost model of one step of ``layout`` in microseconds (the
    constants above), for one wave of blocks."""
    if layout.grid:
        return GRID_STEP[kind] + GRID_PER_ROW[kind] * layout.rb
    if layout.wide:
        return WIDE_STEP[kind] + WIDE_PER_CHUNK[kind] * _ceil(W, KCH)
    if layout.reg:
        return REG_STEP + layer_groups(kind, D) * (
            REG_PER_ROW * layout.rt + REG_PER_BLOCK * reg_group_threads(
                kind, W, layout.rb, layout.cl, layout.rt) / NT)
    # bwd: the z recompute and dh = dz @ U^T, 4W columns of W terms each
    fmas = layout.rb * W * _ceil(4 * W, NT) * (
        {'lstm': 1, 'bwd': 2}.get(kind, 2 * D - 1))
    if kind == 'score':
        fmas += layout.rb * W * _ceil(Vp, NT)
    return ONE_PER_FMA * fmas


def waves(B: int, layout: Layout, fits: Callable[[Layout], int],
          n_sm: int) -> int:
    """Waves of clusters (or blocks) the card runs one after another:
    ``fits(layout)`` clusters of the register layout at once, ``n_sm``
    blocks of the one-block layout; the grid layout's groups all at once
    (1) or not at all (0), and so the wide layout's blocks; 0 where none
    fits."""
    if layout.wide:
        return int(layout.cl <= n_sm)
    if layout.grid:
        return int(_ceil(B, layout.rb) * layout.cl <= n_sm)
    at_once = fits(layout) if layout.reg else n_sm
    return _ceil(_ceil(B, layout.rb), at_once) if at_once > 0 else 0


def choose(kind: str, B: int, W: int, D: int,
           fits: Callable[[Layout], int], n_sm: int, bf16: bool = False,
           Vp: int = 0) -> Layout:
    """The layout of ``B`` streams: of the register layouts of ``cl`` in
    CLUSTERS blocks of ``rb`` <= ``rows_per_block(B)`` streams, where
    each block owns at least MIN_UNITS units and the card holds a
    cluster (``fits(layout)``: how many clusters of that layout the card
    holds at once), and of the grid layout in as few groups as the card
    holds at once (:func:`grid_layout_for` with ``rb = ceil(B /
    groups)``, ``groups = min(B, grid_groups(W, n_sm))``), and of the wide
    layout (:func:`wide_layout_for`), the lowest :func:`step_cost` times
    :func:`waves` wins, ties to fewer blocks a cluster (at three tied
    shapes the smaller cluster took 10-13% less time), then to more
    streams a cluster; where none does or
    :func:`one_block_layout` costs no more (on ``n_sm`` SMs), the
    one-block layout."""
    one = one_block_layout(kind, B, W, D, bf16, Vp)
    best = (step_cost(kind, W, D, one, Vp) * waves(B, one, fits, n_sm),
            0, 0), one
    groups = grid_groups(W, n_sm) if W >= GRID_UNITS else 0
    grid = grid_layout_for(kind, B, W, _ceil(B, min(B, groups))) \
        if groups else None
    if grid is not None and waves(B, grid, fits, n_sm):
        key = (step_cost(kind, W, D, grid) * waves(B, grid, fits, n_sm),
               grid.cl, -grid.rb)
        if key < best[0]:
            best = (key, grid)
    wide = wide_layout_for(kind, B, W, n_sm)
    if wide is not None:
        key = (step_cost(kind, W, D, wide), wide.cl, -wide.rb)
        if key < best[0]:
            best = (key, wide)
    for cl in CLUSTERS:
        if W < MIN_UNITS * cl:
            continue
        rb = rows_per_block(B)
        while rb >= 1:
            lay = reg_layout_for(kind, W, D, rb, cl)
            n = waves(B, lay, fits, n_sm) if lay is not None else 0
            if n:
                key = (step_cost(kind, W, D, lay) * n, cl, -rb)
                if key < best[0]:
                    best = (key, lay)
            rb //= 2
    return best[1]


def check(kind: str, B: int, W: int, D: int, layout: Layout,
          bf16: bool = False, Vp: int = 0) -> None:
    """Raise ValueError unless the kernels take ``layout`` for B streams
    of width W (what the sources refuse with an invalid-value error),
    or its shared memory exceeds a block's."""
    problems = []
    if B < 1 or W < 4 or W % 4:
        problems.append('B >= 1 and W a positive multiple of 4')
    elif layout.wide:
        if layout != wide_layout_for(kind, B, W, layout.cl):
            problems.append('the wide layout (kind lstm or bwd, W > %d, 1 '
                            '<= B <= %d streams, %d blocks, rt 0, smem '
                            '%d)'
                            % (WIDE_MIN_W, WIDE_RB, wide_blocks(kind, W),
                               WIDE_SMEM))
    elif layout.grid:
        if layout != grid_layout_for(kind, B, W, layout.rb):
            problems.append('the grid layout (kind lstm or bwd, W = %d, %d '
                            'blocks a group of 1 <= rb <= B streams, rt = '
                            'min(rb, %s) halved to fit, smem equal to '
                            'grid_plan_bytes and <= %d)'
                            % (GRID_NKB * KCH, W // GRID_UNITS,
                               GRID_RT.get(kind), SMEM_MAX))
    elif layout.reg:
        if reg_layout_for(kind, W, D, layout.rb, layout.cl) is None or \
                layout.rt not in (1, 2, 4) or \
                layout.rt > REG_RT_MAX_OF[kind] or \
                layout.rt > layout.rb or layout.rb % layout.rt or \
                layer_groups(kind, D) * reg_group_threads(
                    kind, W, layout.rb, layout.cl, layout.rt) > NT:
            problems.append('a register layout that fits (2, 4 or 8 '
                            'blocks of 32 terms, rb in 1, 2, 4, %d, cl in '
                            '%s, every block owning a unit, rt <= %d '
                            'dividing rb, the threads of a block)'
                            % (RBMAX, ', '.join(map(str, CLUSTERS)),
                               REG_RT_MAX_OF[kind]))
    else:
        rb = one_block_rows(kind, B, W, D, bf16, Vp)
        if (layout.rb, layout.cl, layout.rt) != (rb, 1, rb):
            problems.append('the one-block layout (rb = rt = %d, cl 1)'
                            % rb)
    if not problems and not (layout.grid or layout.wide) and \
            layout.smem != plan_bytes(
            kind, W, D, layout.rb, layout.reg, bf16, Vp):
        problems.append('smem equal to plan_bytes')
    if not problems and layout.smem > SMEM_MAX:
        problems.append('smem <= %d' % SMEM_MAX)
    if problems:
        raise ValueError('%s scan layout %s for B=%d, W=%d, D=%d needs %s'
                         % (kind, tuple(layout), B, W, D,
                            '; '.join(problems)))
