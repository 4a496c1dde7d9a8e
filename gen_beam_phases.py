#!/usr/bin/env python3
"""Where a step of the generation beam-step kernel, or of the LSTM
recurrences, goes, on one GPU.

    python3 gen_beam_phases.py          # gen_beam
    python3 gen_beam_phases.py gen-rows [--root DIR]    # rows 6, 6b alone
    python3 gen_beam_phases.py scan     # lstm_scan and score_scan
    python3 gen_beam_phases.py host     # their host time per call
    python3 gen_beam_phases.py bwd      # lstm_bwd
    python3 gen_beam_phases.py wide     # lstm_scan and lstm_bwd at W=512
    python3 gen_beam_phases.py wide-rows [--root DIR]   # rows 4w, 5w alone
    python3 gen_beam_phases.py wide1840 # rows 4x, 5x: W=1840, wide layout
    python3 gen_beam_phases.py decode   # decode_lattice and _batch
    python3 gen_beam_phases.py decode-rows [--root DIR]   # rows 1-2k alone
    python3 gen_beam_phases.py walk     # walk_records_batch
    python3 gen_beam_phases.py tb       # gen_traceback
    python3 gen_beam_phases.py prompt   # generation's prompt steps

Builds ``ocrd_keraslm_torch/csrc/gen_beam.cu`` with ``-DSCAN_PHASES``,
which turns on the ``PHASE`` marks of its unit layout
(``csrc/cluster_common.cuh``: block 0, thread 0, the time from the
previous mark, barriers and waits included), into
``ocrd_keraslm_torch/_build/phases/``, runs ``gen_beam`` on the german
model (K=256, TOPK=10) at rows 6 and 6b of ``PERF.md`` (one stream of
1024 steps, 16 streams of 256 steps) in every unit layout the card takes
for the row's streams (one cluster a stream, and row groups: g clusters
a stream, where all N*g fit at once), and prints each phase's cycles a
step and share (in row groups the exchange through L2 has marks of its
own), beside the launch's time with the marks and without; then it times
every layout the chooser could take at both rows (the sweep the cost
model of ``ops/gen_kernel.py`` is fitted to, its row groups' exchange
term included), each beside the model's time, with the card's name and
power limit.

``gen-rows`` times rows 6 and 6b alone in the layout the wrapper
chooses (CUDA events) and prints the sha256 digests of their records,
which every version must share, with the kernels of the package under
``--root DIR`` (another checkout, such as a ``git archive`` of the
parent commit) or of this checkout: run parent, change, change, parent
in one call to compare two versions.

``scan`` builds ``lstm_scan.cu`` and ``score_scan.cu`` with
``-DSCAN_PHASES``, which turns on the ``PHASE`` marks of the register
layout (``csrc/scan_common.cuh``: block 0, thread 0, the time from the
previous mark), runs each through its wrapper at the rows of
``PERF.md`` (``score_scan`` at B=4, T=4096 on the german model;
``lstm_scan`` at B=4, T=4096 and at the training shape B=128, T=256,
f32 and bf16 U) in the layout the wrapper chooses, and prints cycles
per step and phase, the launch's time with the marks and without, and,
for ``score_scan``, the device time of each of its three kernels
(``torch.profiler``).  Then it times every layout the chooser could
return at those rows (the sweep the cost model of
``ops/scan_layout.py`` was fitted to), and at the shapes of ``WIDTHS``
the chosen layout against the one-block one and the register layout
the cost model rates best, beside the model's time a step.

``host`` prints the host time of one ``lstm_scan`` and one
``score_scan`` call (the wrappers' work before the launch returns).

``bwd`` builds ``lstm_bwd.cu`` with ``-DSCAN_PHASES`` and runs
``lstm_bwd`` at rows 5 and 5b of ``PERF.md`` (the training shape B=128,
T=256, W=128, f32 and bf16 U) in the layout the wrapper chooses: cycles
per step and phase of its chain, the device time of each of its kernels
(the z recompute, the chain, the two of the dU product;
``torch.profiler``), then every layout the chooser could return at those
rows and at the shapes of ``BWD_SHAPES``, against the one-block layout
(the first port's kernel).

``wide`` runs ``lstm_scan`` and ``lstm_bwd`` at W=512 (B=128, T=64,
f32 U: ``chip_smoke.py`` part (d)'s training shape) in the chosen grid
layout and in the one-block layout: cycles per step and phase (the grid
kernels' ``PHASE`` marks and the one-block backward's), the device time
of each kernel of a launch (``torch.profiler``); then it times the grid
layout at B=128 for each staged chunk size of ``GRID_RT_SWEEP`` (the
sources built with ``-DGRID_RT``) and at each batch of ``GRID_B_SWEEP``
beside the cost model's time a step (the sweep ``scan_layout.GRID_STEP``
and ``GRID_PER_ROW`` are fitted to), and prints rows 3w, 4w and 5w of
``PERF.md`` (``chip_smoke.wide_numbers``).

``wide-rows`` times rows 4w and 5w alone beside cuDNN, with the
kernels of the package under ``--root DIR`` (another checkout, such as a
``git archive`` of the parent commit) or of this checkout; run parent,
change, change, parent in one call to compare two versions.

``wide1840`` runs ``lstm_scan`` (with ``c_all``) and ``lstm_bwd`` at
W=1840 (the AWD-LSTM enwik8 model's wide layers: B=128, T=200, f32 U;
rows 4x and 5x of ``PERF.md``) in the wide layout and in the one-block
layout, holds the two layouts' outputs equal bit for bit and each to
the plain version (float64 on the card) within its bounds, prints the
device time of each kernel of a launch (``torch.profiler``), and times
forward and forward+backward of both layouts beside cuDNN's f32 layer
(TF32 off; CUDA events), in one call; then the wide layout at B = 1, 8
and 32 (the cost model's fit, ``scan_layout.WIDE_STEP`` and
``WIDE_PER_CHUNK``) and at W = 1024.

``decode`` builds ``decode_lattice.cu`` and ``decode_lattice_batch.cu``
with ``-DSCAN_PHASES`` (the marks of ``decode_edges_cluster``) and runs
them at rows 1 and 2 of ``PERF.md`` (page 1 of ``chip_smoke.py``'s
seeded 4-page workspace; block 1 of its 32-document batch) at the
processor's default ``beam_width`` 10 (K=16) and at rows 1k and 2k, the
same at ``beam_width`` 32 (K=32), in the largest cluster the layout
takes: cycles per edge and phase of block 0, then each cluster size and
shared-memory plan (rows, sharded) the layout takes and the one-block
layout, for one document and for the batch (the times
``decode_kernel.CL_COST`` and ``CL_COST_SHARD`` are fitted to).

``decode-rows`` times rows 1, 2, 1k, 1bk (bf16 weights) and 2k alone in
the layout the wrapper chooses and in the others the shape takes, and
prints the sha256 digests of ``decode_lattice``'s outputs at K=32, with
the kernels of the package under ``--root DIR`` or of this checkout, as
``wide-rows`` does: run parent, change, change, parent in one call.

``walk`` times ``walk_records_batch`` at row 2w of ``PERF.md`` (block 1
of ``chip_smoke.py``'s 32-document serving batch) against the parent's
design of its kernel (one thread a document walking the records in
device memory, built from the copy in ``WALK_PARENT``), and at ragged
shapes.

``tb`` times ``traceback`` (``csrc/gen_traceback.cu``) at row 7 of
``PERF.md`` (the records of ``generate -n 1000 -v 3``: 3 cursors from
step 999 of 1024, K=256), the 16-prompt batch row and seeded records of
T in {16, 64, 256, 1024, 4096} steps, against the parent's design (one
thread a cursor walking the records in device memory, built from the
copy in ``TB_PARENT``), and every segment length at the first two; both
designs are checked equal to the plain version and to each other.
Kernel times are device times (``chip_smoke.device_ms``: launches
queued behind a sleep kernel).

``prompt`` times generation's prompt steps (``ops/beam_device.py``
``_prefix_state``) as plain PyTorch steps and as replays of the
captured step, in turns (plain, graph, graph, plain), for one stream of
a 36-char prompt (35 steps, the generation cell's longest) and the 16
prompts of row 6b: a call's host time (issue) and wall time (to the
device's end; host clock, the device idle before each call), its device
time (``device_ms``), and from ``torch.profiler`` its launches (the
CUDA API calls that queue work), its device operations and
their summed time; the root rows of the two are checked equal bit for
bit.

Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SCAN_NPHASE = 10  # csrc/cluster_common.cuh: the phase counters
# (mark index, phase) in step order of the register layout (the
# one-block kernels carry no marks)
SCAN_PHASES = {
    'lstm_scan': (
        (1, 'gate products'), (2, 'block sums (shuffles), gate updates'),
        (3, 'h sent to the cluster (st.async), h_all stores, x_proj loads'),
        (4, 'wait for the step\'s h (mbarrier)')),
    'score_scan': (
        (1, 'layer-0 products, block sums (shuffles)'),
        (2, 'layer-0 gate updates, h sent (st.async), xp1 loads'),
        (7, 'wait for every layer\'s h of the step (mbarriers)')),
    # lstm_bwd_kernel, the one-block layout (every block's thread 0 waits
    # at the block barrier after each phase)
    'lstm_bwd_one': (
        (1, 'z recompute (U from L2)'),
        (2, 'gate derivatives, dz and dx_proj stores'),
        (3, 'dh products (U^T from L2)'),
        (4, 'the four quarters added')),
    # the grid layouts (W=512): per step, summed over its chunks
    'lstm_scan_grid': (
        (1, 'wait for the group\'s h of the step before (counter)'),
        (2, 'wait for the staged h rows (TMA)'),
        (3, 'gate products, partial sums stored'),
        (4, 'block sums, gate updates, h_all stores'),
        (5, 'arrival on the group\'s counter')),
    'lstm_bwd_grid': (
        (1, 'wait for the group\'s dz of the step before (counter)'),
        (2, 'wait for the staged dz rows (TMA)'),
        (3, 'dh products, partial sums stored'),
        (4, 'block and quarter sums, gate derivatives, dz stores'),
        (5, 'arrival on the group\'s counter')),
    'lstm_bwd': (
        (1, 'gates from z, the next step\'s loads issued'),
        (2, 'wait for the step\'s dz (mbarrier)'),
        (3, 'dh products, block and quarter sums (shuffles)'),
        (4, 'gate derivatives, dz sent (st.async), dx_proj stores')),
    # gen_beam_units_kernel: per step, summed over its layers and tiles
    'gen_beam': (
        (0, 'wait for the staged tile, barrier, next copies'),
        (1, 'gate products'),
        (2, 'block sums, gate updates of the tile before'),
        (3, 'cluster barrier after each layer'),
        (4, 'own rows\' top-layer h, logits'),
        (5, 'row candidates (a warp a row)'),
        (6, 'cluster barrier, candidates copied (DSMEM)'),
        (7, 'radix select, counts, compaction, records')),
    # the same in row groups: the step's candidates cross the stream's
    # clusters through L2
    'gen_beam_groups': (
        (0, 'wait for the staged tile, barrier, next copies'),
        (1, 'gate products'),
        (2, 'block sums, gate updates of the tile before'),
        (3, 'cluster barrier after each layer'),
        (4, 'own rows\' top-layer h, logits'),
        (5, 'row candidates (a warp a row)'),
        (8, 'candidates to L2, arrival, wait for the stream (counter)'),
        (6, 'every candidate read from L2'),
        (7, 'radix select, counts, compaction, records')),
    # decode_edges_cluster: per edge, summed over its chunks and steps
    'decode': (
        (0, 'edge arrays, top K, beam reorder'),
        (8, 'own rows, rows of the chunks sent (st.async; sharded plan)'),
        (9, 'wait for the chunk\'s rows (mbarrier; sharded plan)'),
        (2, 'layer products, block sums (shuffles)'),
        (1, 'gate updates'),
        (3, 'h sent to every block (st.async)'),
        (4, 'wait for every unit\'s h (mbarrier)'),
        (5, 'logits, logsumexp (rows split over blocks)'),
        (6, 'costs into every block, state write-back'),
        (7, 'cluster barrier of the step'))}


def marked_library(module, source, loader='_library',
                   flags=('-DSCAN_PHASES',), tag='', built=None):
    """``module``'s kernel library built from ``source`` with the phase
    marks on (or with other ``flags``; into ``_build/phases/``, the file
    name ending in ``tag``; ``built``: the path and log of
    :func:`build_variant`'s build of it), with the argument types its
    ``loader`` sets; returns ``(library, its compiler log)``."""
    from ocrd_keraslm_torch.ops import _build
    path, log = built or build_variant(source, flags, tag)
    load = _build.load
    _build.load = lambda src: ctypes.CDLL(path)
    try:
        lib = getattr(module, loader).__wrapped__()
    finally:
        _build.load = load
    if '-DSCAN_PHASES' in flags:
        lib.scan_phase_read.argtypes = [ctypes.c_void_p]
    return lib, log


def build_variant(source, flags, tag):
    """``nvcc`` of ``source`` with ``flags`` into ``_build/phases/`` (the
    file name ending in ``tag``); returns ``(path, compiler log)``."""
    from ocrd_keraslm_torch.ops import _build
    out_dir = os.path.join(_build.BUILD_DIR, 'phases')
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        os.path.basename(source)[:-3] + tag + '.so')
    proc = subprocess.run([_build._nvcc(source)] + _build.NVCC_FLAGS
                          + list(flags) + ['-o', path, source],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit('gen_beam_phases: nvcc failed:\n' + proc.stderr)
    return path, proc.stdout + proc.stderr


def layout_times(fn, kind, B, W, D, reps):
    """[(rb, cl, reg, ms)] of ``fn()`` (a ``score_scan`` or ``lstm_scan``
    call) under every layout the chooser could return (CUDA events, mean
    of ``reps`` warm launches)."""
    from chip_smoke import cuda_ms, scan_layout, scan_layouts
    out = []
    for rb, cl, reg in scan_layouts(kind, B, W, D):
        with scan_layout(rb, cl, reg):
            out.append((rb, cl, reg, cuda_ms(fn, reps)))
    return out


# scan_layouts' third field as printed: the register (r), one-block (1)
# or grid (g) layout
LAYOUT_MARK = {True: 'r', False: '1', 'grid': 'g'}


def print_layout_times(name, shape, times, chosen, card):
    print('%s at %s by layout (streams a block, cluster or group, blocks a '
          'cluster or group, register layout (r), grid layout (g) or '
          'one-block (1): ms a launch, CUDA events): %s; the chooser takes '
          '(%d, %d, %s) [%s]'
          % (name, shape, ', '.join('(%d, %d, %s): %.3f' % (
              rb, cl, LAYOUT_MARK[reg], ms) for rb, cl, reg, ms in times),
             chosen.rb, chosen.cl, 'g' if chosen.grid else 'r' if chosen.reg
             else '1', card))


def scan_rows(rater, dev, rng):
    """[(kernel name, module, what, call, T, kind, B, W, D, layout)] at
    the rows of PERF.md: row 3, 4s, 4t, 4b."""
    from chip_smoke import TRAIN_B, TRAIN_T, TRAIN_W, lstm_train_inputs, \
        score_inputs
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import score_kernel as sk
    score_args = score_inputs(rng, 'german_b4', dev, rater)
    Vp = score_args[-2].shape[1]
    runs = [('score_scan', sk, 'row 3 (B=4, T=4096, D=2, W=128)',
             lambda: sk.score_scan(*score_args), 4096, 'score', 4, 128, 2,
             sk.scan_layout_on(dev, 4, 128, 2, Vp))]
    for row, B, T, bf16 in (('row 4s', 4, 4096, False),
                            ('row 4t', TRAIN_B, TRAIN_T, False),
                            ('row 4b', TRAIN_B, TRAIN_T, True)):
        fwd = lstm_train_inputs(rng, dev, bf16, B=B, T=T, W=TRAIN_W)[0]
        c_all = row != 'row 4s'
        runs.append(('lstm_scan', lc, '%s (B=%d, T=%d, W=%d, %s U, c_all '
                     '%s)' % (row, B, T, TRAIN_W, 'bf16' if bf16 else 'f32',
                              'on' if c_all else 'off'),
                     lambda fwd=fwd, c_all=c_all: lc.lstm_scan(
                         *fwd, want_c_all=c_all), T, 'lstm', B, TRAIN_W, 1,
                     lc.scan_layout_on(dev, B, TRAIN_W, bf16)))
    return runs


# shapes the rows of PERF.md do not take: (kind, B, T, W, D, bf16).  The
# fused scoring path up to W=384, the layered path above it or under a
# bf16 compute_dtype (lstm_scan at W=512, 1024), the register layout at
# W=64 and 256, and batches whose clusters run in waves
WIDTHS = (('score', 4, 512, 384, 2, False), ('lstm', 4, 512, 512, 1, False),
          ('lstm', 4, 512, 512, 1, True), ('lstm', 4, 256, 1024, 1, False),
          ('lstm', 4, 256, 1024, 1, True), ('lstm', 4, 1024, 64, 1, False),
          ('lstm', 128, 256, 64, 1, False), ('lstm', 4, 1024, 256, 1, False),
          ('lstm', 128, 256, 256, 1, False), ('score', 4, 1024, 64, 2, False),
          ('score', 4, 1024, 256, 1, False), ('score', 4, 512, 256, 2, False),
          ('lstm', 256, 256, 128, 1, False), ('lstm', 512, 256, 128, 1, False),
          ('lstm', 1024, 128, 128, 1, False),
          ('lstm', 2048, 64, 128, 1, False), ('score', 8, 1024, 128, 2, False),
          ('score', 33, 512, 128, 2, False), ('score', 64, 256, 128, 2, False),
          ('score', 512, 64, 128, 2, False))


def width_times(dev, rng, card):
    """At each shape of WIDTHS, the chosen layout's ms a launch against
    the one-block layout's (the first port's kernel, unchanged) and the
    register layout the cost model rates best, each beside the model's
    microseconds a step (``scan_layout.step_cost`` times its waves)."""
    import torch
    from chip_smoke import cuda_ms, lstm_train_inputs, scan_layout, \
        scan_layouts, score_inputs
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import scan_layout as sl
    from ocrd_keraslm_torch.ops import score_kernel as sk
    index = torch.cuda.current_device()
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    for kind, B, T, W, D, bf16 in WIDTHS:
        if kind == 'score':
            args = score_inputs(rng, 'd%dw%db%dt%d' % (D, W, B, T), dev)
            Vp = args[-2].shape[1]
            lay = sk.scan_layout_on(dev, B, W, D, Vp)

            def fits(lay, D=D, W=W):
                return sk.clusters_that_fit(index, D, W, lay)

            def call(args=args):
                return sk.score_scan(*args)
        else:
            Vp = 0
            fwd = lstm_train_inputs(rng, dev, bf16, B=B, T=T, W=W)[0]
            lay = lc.scan_layout_on(dev, B, W, bf16)

            def fits(lay, W=W, bf16=bf16):
                return lc.clusters_that_fit(index, W, bf16, lay)

            def call(fwd=fwd):
                return lc.lstm_scan(*fwd, want_c_all=True)

        def model(lay):
            return sl.step_cost(kind, W, D, lay, Vp) * sl.waves(
                B, lay, fits, n_sm)
        ms = cuda_ms(call, 3)
        timed = [('chosen', lay, ms)]
        regs = [sl.reg_layout_for(kind, W, D, rb, cl)
                for rb, cl, reg in scan_layouts(kind, B, W, D) if reg is True]
        regs = [r for r in regs if sl.waves(B, r, fits, n_sm)]
        best = min(regs, key=model) if regs else None
        for what, other in (('one-block', sl.one_block_layout(
                kind, B, W, D, bf16, Vp)), ('best register', best)):
            if other is not None and other != lay:
                with scan_layout(other.rb, other.cl, other.reg):
                    timed.append((what, other, cuda_ms(call, 3)))
        print('%s_scan at B=%d, T=%d, W=%d, D=%d, %s: %s (ms a launch, CUDA '
              'events, mean of 3; the model\'s us a step; measured us a '
              'step) [%s]'
              % (kind, B, T, W, D, 'bf16 U' if bf16 else 'f32', '; '.join(
                  '%s %s %.3f ms, model %.2f us, %.2f us' % (
                      what, tuple(x), t, model(x), 1e3 * t / T)
                  for what, x, t in timed), card))


def scan_main(card) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import cuda_ms, german_rater
    dev = torch.device('cuda')
    rater = german_rater(dev)
    rng = np.random.default_rng(20261103)
    runs = scan_rows(rater, dev, rng)
    libs = {}
    for name, module, what, call, T, kind, B, W, D, lay in runs:
        unmarked_ms = cuda_ms(call, 3)
        if not lay.reg:
            print('%s, %s: the one-block layout %s, %.3f ms (CUDA events); '
                  'no phase marks [%s]' % (name, what, tuple(lay),
                                           unmarked_ms, card))
            continue
        if name not in libs:
            libs[name] = marked_library(module, module.SOURCE)[0]
        plain_lib = module._library
        module._library = lambda lib=libs[name]: lib
        marks = SCAN_PHASES[name]
        try:
            ms, cycles, total = marked_run(libs[name], call, marks)
        finally:
            module._library = plain_lib
        print('%s phases, %s, layout %s: %.3f ms a launch with the marks, '
              '%.3f ms without (CUDA events), %.0f cycles a step in block 0 '
              '[%s]' % (name, what, tuple(lay), ms, unmarked_ms, total / T,
                        card))
        print_marks(marks, cycles, total, ' step', T)
        if name == 'score_scan':
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            per = {}
            for evt in prof.events():
                if 'score_' in evt.name:
                    key = evt.name.split('<')[0].split('(')[0]
                    per[key] = per.get(key, 0.0) + \
                        evt.time_range.elapsed_us() / 1e3
            print('  device ms by kernel (torch.profiler): %s'
                  % ', '.join('%s %.3f' % kv for kv in sorted(per.items())))
    for name, module, what, call, T, kind, B, W, D, lay in runs:
        print_layout_times(name, what, layout_times(call, kind, B, W, D, 3),
                           lay, card)
    width_times(dev, rng, card)
    return 0


def host_main(card) -> int:
    """Host time of one ``lstm_scan`` call at the training shape (f32 U,
    ``c_all`` on) and of one ``score_scan`` call at row 3: the mean over
    200 calls issued back to back (host clock around the calls, the
    device synchronised only before and after)."""
    import time

    import numpy as np
    import torch
    from chip_smoke import TRAIN_B, TRAIN_T, TRAIN_W, german_rater, \
        lstm_train_inputs, score_inputs
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import score_kernel as sk
    dev = torch.device('cuda')
    rng = np.random.default_rng(20261104)
    fwd = lstm_train_inputs(rng, dev, False, B=TRAIN_B, T=TRAIN_T,
                            W=TRAIN_W)[0]
    score_args = score_inputs(rng, 'german_b4', dev, german_rater(dev))
    for name, call, n in (
            ('lstm_scan at the training shape (B=%d, T=%d, W=%d, f32 U, '
             'c_all on)' % (TRAIN_B, TRAIN_T, TRAIN_W),
             lambda: lc.lstm_scan(*fwd, want_c_all=True), 200),
            ('score_scan at row 3 (B=4, T=4096, D=2, W=128)',
             lambda: sk.score_scan(*score_args), 50)):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print('host time of one %s call: %.1f us (mean of %d calls issued '
              'back to back, host clock) [%s]'
              % (name, 1e6 * (t1 - t0) / n, n, card))
    return 0


def marked_run(lib, call, marks):
    """Run ``call()`` (a wrapper launch on ``lib``, the marked library)
    once after a warm-up; returns ``(ms of the marked launch, cycles per
    mark, total cycles of the marks)``."""
    import torch
    call()
    torch.cuda.synchronize()
    lib.scan_phase_reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * SCAN_NPHASE)()
    assert lib.scan_phase_read(ctypes.cast(cycles, ctypes.c_void_p)) == 0
    return start.elapsed_time(end), cycles, sum(cycles[k] for k, _ in marks)


def print_marks(marks, cycles, total, per, T):
    for k, phase in marks:
        print('  %-52s %9.0f cycles a%s %5.1f%%'
              % (phase, cycles[k] / T, per, 100.0 * cycles[k] / max(total,
                                                                   1)))


# shapes beyond rows 5 and 5b for the backward's layout sweep: (B, T, W)
BWD_SHAPES = ((1, 256, 128), (4, 1024, 128), (33, 256, 128),
              (256, 256, 128), (1024, 64, 128), (128, 256, 64),
              (128, 256, 256))


def bwd_main(card) -> int:
    """Phases, kernel split and layout sweep of ``lstm_bwd``."""
    import numpy as np
    import torch
    from chip_smoke import (TRAIN_B, TRAIN_T, TRAIN_W, cuda_ms, kernel_split,
                            lstm_bwd_args, lstm_train_inputs, scan_layout,
                            scan_layouts)
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import scan_layout as sl
    dev = torch.device('cuda')
    rng = np.random.default_rng(20261105)
    lib = marked_library(lc, lc.BWD_SOURCE, '_bwd_library')[0]
    marks = SCAN_PHASES['lstm_bwd']

    def args_at(B, T, W, bf16):
        fwd, cot = lstm_train_inputs(rng, dev, bf16, B=B, T=T, W=W)
        return lstm_bwd_args(fwd, cot,
                             lc.lstm_scan(*fwd, want_c_all=True)[:2])
    for row, bf16 in (('row 5', False), ('row 5b', True)):
        args = args_at(TRAIN_B, TRAIN_T, TRAIN_W, bf16)
        lay = lc.bwd_layout_on(dev, TRAIN_B, TRAIN_W)
        what = '%s (B=%d, T=%d, W=%d, %s U)' % (
            row, TRAIN_B, TRAIN_T, TRAIN_W, 'bf16' if bf16 else 'f32')

        def call(args=args):
            return lc.lstm_bwd(*args)
        unmarked_ms = cuda_ms(call, 3)
        if lay.reg:
            plain_lib = lc._bwd_library
            lc._bwd_library = lambda: lib
            try:
                ms, cycles, total = marked_run(lib, call, marks)
            finally:
                lc._bwd_library = plain_lib
            print('lstm_bwd phases, %s, layout %s: %.3f ms a launch with the '
                  'marks, %.3f ms without (CUDA events), %.0f cycles a step '
                  'of the chain in block 0 [%s]'
                  % (what, tuple(lay), ms, unmarked_ms, total / TRAIN_T,
                     card))
            print_marks(marks, cycles, total, ' step', TRAIN_T)
        print('lstm_bwd device time by kernel, %s: %s [%s]'
              % (what, ', '.join('%s %.3f ms' % kv
                                 for kv in kernel_split(call)), card))
        times = []
        for rb, cl, reg in scan_layouts('bwd', TRAIN_B, TRAIN_W, 1):
            with scan_layout(rb, cl, reg):
                times.append((rb, cl, reg, cuda_ms(call, 3)))
        print_layout_times('lstm_bwd', what, times, lay, card)
    index = torch.cuda.current_device()
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    for B, T, W in BWD_SHAPES:
        args = args_at(B, T, W, False)
        lay = lc.bwd_layout_on(dev, B, W)

        def model(x, W=W, B=B):
            return sl.step_cost('bwd', W, 1, x) * sl.waves(
                B, x, lambda y: lc.bwd_clusters_that_fit(index, W, y), n_sm)
        timed = []
        for rb, cl, reg in scan_layouts('bwd', B, W, 1):
            x = sl.grid_layout_for('bwd', B, W, rb) if reg == 'grid' else \
                sl.reg_layout_for('bwd', W, 1, rb, cl) if reg else \
                sl.one_block_layout('bwd', B, W, 1)
            with scan_layout(rb, cl, reg):
                timed.append((x, cuda_ms(lambda args=args: lc.lstm_bwd(
                    *args), 3)))
        print('lstm_bwd at B=%d, T=%d, W=%d, f32 U, the chooser takes %s: %s '
              '(layout, ms a launch (CUDA events, mean of 3), the model\'s '
              'us a step) [%s]'
              % (B, T, W, tuple(lay)[:3] + (lay.reg,), '; '.join(
                  '%s %.3f ms %.2f us' % (tuple(x)[:3] + (
                      'grid' if x.grid else x.reg,), t,
                                          model(x)) for x, t in timed), card))
    return 0


def wide_marks(name, lay):
    """The phase marks of ``name``'s (``lstm_scan`` or ``lstm_bwd``)
    kernel in ``lay``, or None where it has none."""
    if getattr(lay, 'grid', False):
        return SCAN_PHASES.get(name + '_grid')
    if lay.reg:
        return SCAN_PHASES[name]
    return SCAN_PHASES.get(name + '_one')


def wide_main(card) -> int:
    """Rows 3w, 4w and 5w of PERF.md (W=512): for ``lstm_scan`` and
    ``lstm_bwd`` at part (d)'s training shape (B=128, T=64, f32 U) in the
    chosen layout and the one-block layout, the cycles a step per phase
    where the kernel has marks and the device time of each kernel of a
    launch; then ``chip_smoke.wide_numbers`` (each row's time beside the
    one-block layout's, the plain version's, its bound and cuDNN's)."""
    import torch
    from chip_smoke import (TRAIN_B, WIDE_T, WIDE_W, cuda_ms,
                            describe_scan_layout, kernel_split, scan_layout,
                            wide_bwd_inputs, wide_numbers, wide_texts)
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    dev = torch.device('cuda')
    fwd, bwd = wide_bwd_inputs(dev)
    libs = {}
    for name, module, loader, source, call, lay in (
            ('lstm_scan', lc, '_library', lc.SOURCE,
             lambda: lc.lstm_scan(*fwd, want_c_all=True),
             lc.scan_layout_on(dev, TRAIN_B, WIDE_W, False)),
            ('lstm_bwd', lc, '_bwd_library', lc.BWD_SOURCE,
             lambda: lc.lstm_bwd(*bwd),
             lc.bwd_layout_on(dev, TRAIN_B, WIDE_W))):
        for forced in (False, True):
            with scan_layout(reg=False) if forced else \
                    contextlib.nullcontext():
                x = lay if not forced else (
                    lc.bwd_layout_on(dev, TRAIN_B, WIDE_W) if name ==
                    'lstm_bwd' else lc.scan_layout_on(dev, TRAIN_B, WIDE_W,
                                                      False))
                if forced and x == lay:
                    continue
                what = '%s at W=%d (B=%d, T=%d, f32 U), %s' % (
                    name, WIDE_W, TRAIN_B, WIDE_T, describe_scan_layout(x))
                unmarked_ms = cuda_ms(call, 3)
                marks = wide_marks(name, x)
                if marks:
                    if name not in libs:
                        libs[name] = marked_library(module, source,
                                                    loader)[0]
                    plain_lib = getattr(module, loader)
                    setattr(module, loader, lambda lib=libs[name]: lib)
                    try:
                        ms, cycles, total = marked_run(libs[name], call,
                                                       marks)
                    finally:
                        setattr(module, loader, plain_lib)
                    print('%s phases, %s: %.3f ms a launch with the marks, '
                          '%.3f ms without (CUDA events), %.0f cycles a step '
                          'in block 0 [%s]' % (name, what, ms, unmarked_ms,
                                               total / WIDE_T, card))
                    print_marks(marks, cycles, total, ' step', WIDE_T)
                print('%s device time by kernel, %s: %s [%s]'
                      % (name, what, ', '.join('%s %.3f ms' % kv
                                               for kv in kernel_split(call)),
                         card))
    wide_sweeps(dev, card)
    wide_numbers(dev, card, wide_texts())
    return 0


def wide_rows_main(card) -> int:
    """Rows 4w and 5w alone (``lstm_scan`` with ``c_all`` and ``lstm_bwd``
    at W=512, B=128, T=64, f32 U; CUDA events, mean of 5, after a
    warm-up) and cuDNN's one-layer forward and forward+backward, with
    the kernels of the ``ocrd_keraslm_torch`` package under ``--root
    DIR`` (another checkout, e.g. a ``git archive`` of the parent) where
    given, else this one's; prints the layouts taken and the outputs'
    sha256 digests, which every version must share."""
    import numpy as np
    import torch
    import chip_smoke as cs
    if '--root' in sys.argv:
        root = os.path.abspath(sys.argv[sys.argv.index('--root') + 1])
        sys.path.insert(0, root)
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    dev = torch.device('cuda')
    fwd, bwd = cs.wide_bwd_inputs(dev)
    rng = np.random.default_rng(20261106)
    inp = torch.from_numpy(rng.normal(0, 1, (cs.TRAIN_B, cs.WIDE_T,
                                             cs.WIDE_W)).astype(
        np.float32)).to(dev)
    cudnn_fwd, cudnn_fwd_bwd = cs.cudnn_layer(inp, cs.WIDE_W)
    fmt = []
    for name, call, lay, library in (
            ('lstm_scan (row 4w)', lambda: lc.lstm_scan(*fwd, want_c_all=True),
             lc.scan_layout_on(dev, cs.TRAIN_B, cs.WIDE_W, False), cudnn_fwd),
            ('lstm_bwd (row 5w)', lambda: lc.lstm_bwd(*bwd),
             lc.bwd_layout_on(dev, cs.TRAIN_B, cs.WIDE_W), cudnn_fwd_bwd)):
        ms = cs.cuda_ms(call, 5)
        fmt.append('%s %.3f ms in %s, digest %s; cuDNN %.3f ms'
                   % (name, ms, tuple(lay), cs._digest(call())[:16],
                      cs.cuda_ms(library, 5)))
    print('wide rows of the package at %s: %s [%s]'
          % (os.path.dirname(os.path.dirname(lc.__file__)), '; '.join(fmt),
             card))
    return 0


# rows 4x and 5x of PERF.md: the AWD-LSTM enwik8 model's 1840-wide
# layers at its training shape
AWD_B, AWD_T, AWD_W = 128, 200, 1840


def wide_inputs(dev, B, T, W, seed=20261018):
    """Seeded ``lstm_scan`` arguments (x_proj, h0, c0, U with entries of
    AWD's init scale 1/sqrt(W)) and cotangents (dh_all, dhT, dcT) on
    ``dev``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)
    fwd = (n(B, T, 4 * W), n(B, W, scale=0.5), n(B, W, scale=0.5),
           n(W, 4 * W, scale=W ** -0.5))
    return fwd, (n(T, B, W), n(B, W), n(B, W))


def wide_check(lc, fwd, cot, card, what, ref=True):
    """The wide layout's ``lstm_scan`` and ``lstm_bwd`` against the
    one-block layout's (equal bit for bit) and, with ``ref``, the plain
    versions in float64 (max abs error printed); returns the wide
    outputs."""
    import torch
    import chip_smoke as cs
    outs = {}
    for forced in (False, True):
        with cs.scan_layout(reg=False) if forced else \
                contextlib.nullcontext():
            B, W = fwd[1].shape
            lays = (lc.scan_layout_on(fwd[0].device, B, W, False),
                    lc.bwd_layout_on(fwd[0].device, B, W))
            f = lc.lstm_scan(*fwd, want_c_all=True)
            b = lc.lstm_bwd(*cs.lstm_bwd_args(fwd, cot, f[:2]))
            torch.cuda.synchronize()
            outs[forced] = (lays, f, b)
    (wl, wf, wb), (ol, of, ob) = outs[False], outs[True]
    assert wl[0].wide and wl[1].wide and not ol[0].wide, (wl, ol)
    same = all(torch.equal(x, y) for x, y in zip(
        [t for t in wf if t is not None] + list(wb),
        [t for t in of if t is not None] + list(ob)))
    print('%s: wide layouts %s / %s, one-block %s / %s; wide equals '
          'one-block bit for bit: %s [%s]' % (what, tuple(wl[0]), tuple(wl[1]),
                                             tuple(ol[0]), tuple(ol[1]), same,
                                             card))
    assert same, what
    if not ref:
        return wf, wb
    d = tuple(t.double() for t in fwd)
    rf = lc.lstm_scan_ref(*d, want_c_all=True)
    rb = lc.lstm_bwd_ref(*[t.double() for t in cs.lstm_bwd_args(
        d, tuple(t.double() for t in cot), rf[:2])])
    ef = max(float((x - y).abs().max()) for x, y in zip(
        [wf[0], wf[1], wf[2], wf[3]], [rf[0], rf[1], rf[2], rf[3]]))
    eb = [float((x - y).abs().max()) for x, y in zip(wb, rb)]
    du_rel = eb[1] / float(rb[1].abs().max())
    print('%s: max abs error of the wide layout against float64: forward '
          '%.3g, dxp %.3g, dU %.3g (%.3g of max |dU|), dh0 %.3g, dc0 %.3g '
          '[%s]' % (what, ef, eb[0], eb[1], du_rel, eb[2], eb[3], card))
    return wf, wb


def wide1840_main(card) -> int:
    """Rows 4x and 5x of PERF.md (W=1840, B=128, T=200, f32 U): the wide
    layout and the one-block layout checked (:func:`wide_check`) and
    timed, forward and forward+backward, beside cuDNN (TF32 off); the
    kernels of a launch by device time; the wide layout at other batches
    and W=1024 beside its cost model."""
    import torch
    import chip_smoke as cs
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import scan_layout as sl
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    B, T, W = AWD_B, AWD_T, AWD_W
    for b in (1, 8):
        wide_check(lc, *wide_inputs(dev, b, 16, W), card,
                   'W=%d, B=%d, T=16' % (W, b))
    fwd, cot = wide_inputs(dev, B, T, W)
    wf, _ = wide_check(lc, fwd, cot, card, 'W=%d, B=%d, T=%d' % (W, B, T),
                       ref=False)
    bargs = cs.lstm_bwd_args(fwd, cot, wf[:2])
    times = {}
    for name, forced in (('wide', False), ('one-block', True)):
        with cs.scan_layout(reg=False) if forced else \
                contextlib.nullcontext():
            reps = 3 if forced else 5
            f_ms = cs.cuda_ms(lambda: lc.lstm_scan(*fwd, want_c_all=True),
                              reps)
            b_ms = cs.cuda_ms(lambda: lc.lstm_bwd(*bargs), reps)
            times[name] = (f_ms, b_ms)
            print('%s layout at W=%d, B=%d, T=%d: forward %.3f ms, backward '
                  '%.3f ms, forward+backward %.3f ms (CUDA events, mean of '
                  '%d) [%s]' % (name, W, B, T, f_ms, b_ms, f_ms + b_ms, reps,
                                card))
            split = [', '.join('%s %.3f ms' % kv for kv in cs.kernel_split(
                call)) for call in (
                    lambda: lc.lstm_scan(*fwd, want_c_all=True),
                    lambda: lc.lstm_bwd(*bargs))]
            print('%s layout, device time by kernel: forward %s; backward %s '
                  '[%s]' % (name, split[0], split[1], card))
    inp = torch.randn((B, T, W), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    cudnn_fwd, cudnn_fwd_bwd = cs.cudnn_layer(inp, W)
    c_f, c_fb = cs.cuda_ms(cudnn_fwd, 5), cs.cuda_ms(cudnn_fwd_bwd, 5)
    w, o = times['wide'], times['one-block']
    print('rows 4x/5x at W=%d, B=%d, T=%d: wide forward %.3f ms, '
          'forward+backward %.3f ms; one-block %.3f / %.3f ms (wide %.2fx / '
          '%.2fx faster); cuDNN f32 (TF32 off, one layer of %d inputs) '
          'forward %.3f ms, forward+backward %.3f ms [%s]'
          % (W, B, T, w[0], w[0] + w[1], o[0], o[0] + o[1], o[0] / w[0],
             (o[0] + o[1]) / (w[0] + w[1]), W, c_f, c_fb, card))
    for b, width in ((1, W), (8, W), (32, W), (128, 1024)):
        fwd, cot = wide_inputs(dev, b, 64, width)
        f = lc.lstm_scan(*fwd, want_c_all=True)
        bargs = cs.lstm_bwd_args(fwd, cot, f[:2])
        f_ms = cs.cuda_ms(lambda: lc.lstm_scan(*fwd, want_c_all=True), 3)
        b_ms = cs.cuda_ms(lambda: lc.lstm_bwd(*bargs), 3)
        lay_f = lc.scan_layout_on(dev, b, width, False)
        lay_b = lc.bwd_layout_on(dev, b, width)
        print('wide layout at W=%d, B=%d, T=64: %.2f us a forward step '
              '(model %.2f), %.2f us a backward launch a step (model of '
              'its chain %.2f) [%s]'
              % (width, b, 1e3 * f_ms / 64,
                 sl.step_cost('lstm', width, 1, lay_f), 1e3 * b_ms / 64,
                 sl.step_cost('bwd', width, 1, lay_b), card))
    return 0


# the grid layout's streams a staged chunk timed by wide_sweeps (at most
# 16: one thread a stream and unit; a plan of 10 or fewer fits a block of
# the backward at B=128), the rows whose chains a thread runs at once, and the
# batches of its cost model's fit
GRID_RT_SWEEP = {'lstm': (8, 12, 16), 'bwd': (6, 8, 10)}
GRID_RU_SWEEP = (1, 2)
GRID_B_SWEEP = (4, 32, 128, 512)


def wide_sweeps(dev, card):
    """The grid layout at W=512, T=64, f32 U: at B=128 each staged chunk
    size of GRID_RT_SWEEP (the sources built with ``-DGRID_RT``), then at
    each B of GRID_B_SWEEP its time a step beside the cost model's
    (``scan_layout.step_cost``, the sweep GRID_STEP and GRID_PER_ROW are
    fitted to)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from chip_smoke import (WIDE_T, WIDE_W, cuda_ms, lstm_bwd_args,
                            lstm_train_inputs)
    from ocrd_keraslm_torch.ops import lstm_cell as lc
    from ocrd_keraslm_torch.ops import scan_layout as sl
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(20261107)
    calls = {}
    for B in GRID_B_SWEEP:
        fwd, cot = lstm_train_inputs(rng, dev, False, B=B, T=WIDE_T,
                                     W=WIDE_W)
        bwd = lstm_bwd_args(fwd, cot, lc.lstm_scan(*fwd, want_c_all=True)[:2])
        calls[B] = {'lstm': lambda fwd=fwd: lc.lstm_scan(*fwd,
                                                         want_c_all=True),
                    'bwd': lambda bwd=bwd: lc.lstm_bwd(*bwd)}
    kinds = (('lstm', lc, '_library', lc.SOURCE),
             ('bwd', lc, '_bwd_library', lc.BWD_SOURCE))
    variants = {kind: [('rt %d' % rt, '-DGRID_RT=%d' % rt, rt)
                       for rt in GRID_RT_SWEEP[kind]] + [
        ('ru %d' % ru, '-DGRID_RU=%d' % ru, sl.GRID_RT[kind])
        for ru in GRID_RU_SWEEP] for kind, _, _, _ in kinds}
    # every variant's nvcc at once
    with ThreadPoolExecutor(8) as pool:
        built = {(kind, what): pool.submit(
            build_variant, source, [flag], '_' + what.replace(' ', ''))
            for kind, _, _, source in kinds
            for what, flag, _ in variants[kind]}
        built = {k: f.result() for k, f in built.items()}
    for kind, module, loader, source in kinds:
        times = []
        plain_rt = sl.GRID_RT[kind]
        for what, flag, rt in variants[kind]:
            lib = marked_library(module, source, loader, [flag],
                                 built=built[kind, what])[0]
            plain_lib = getattr(module, loader)
            setattr(module, loader, lambda lib=lib: lib)
            sl.GRID_RT[kind] = rt
            lc._layout.cache_clear()
            lc._bwd_layout.cache_clear()
            try:
                times.append((what, cuda_ms(calls[128][kind], 5)))
            finally:
                setattr(module, loader, plain_lib)
                sl.GRID_RT[kind] = plain_rt
                lc._layout.cache_clear()
                lc._bwd_layout.cache_clear()
        print('grid layout %s at W=%d, B=128, T=%d by streams a staged chunk '
              '(rt) and rows a thread runs at once (ru), each built with '
              'that one value (ms a launch, CUDA events, mean of 5): %s; the '
              'sources\' rt %d [%s]' % (kind, WIDE_W, WIDE_T, ', '.join(
                  '%s: %.3f' % x for x in times), plain_rt, card))
        rows = []
        for B in GRID_B_SWEEP:
            lay = (lc.bwd_layout_on(dev, B, WIDE_W) if kind == 'bwd' else
                   lc.scan_layout_on(dev, B, WIDE_W, False))
            ms = cuda_ms(calls[B][kind], 5)
            rows.append('B=%d %s %.3f ms, %.2f us a step, model %.2f us'
                        % (B, tuple(lay)[:3], ms, 1e3 * ms / WIDE_T,
                           sl.step_cost(kind, WIDE_W, 1, lay) * sl.waves(
                               B, lay, None, n_sm)))
        print('grid layout %s at W=%d, T=%d by batch (layout (rb, cl, rt), '
              'ms a launch (CUDA events, mean of 5), us a step, the cost '
              'model\'s): %s [%s]' % (kind, WIDE_W, WIDE_T, '; '.join(rows),
                                      card))


# (row, beam_width, K) of decode_main and decode_rows_main: the
# processor's default beam and beam 32, whose K=32 the cluster layout
# runs in its sharded plan at the german model's width
DECODE_BEAMS = (('', 10, 16), ('k', 32, 32))


def decode_inputs(rater, work):
    """``decode_lattice``'s arguments for page 1 of ``chip_smoke.py``'s
    seeded 4-page workspace and ``decode_lattice_batch``'s for block 1 of
    its 32-document batch, by K of :data:`DECODE_BEAMS`: {K: (args, kw,
    bargs, bkw, args_bf16)}."""
    import numpy as np
    from chip_smoke import (BATCH_DOCS, build_workspace, first_batch_launch,
                            page_block, workspace_graphs)
    ws = os.path.join(work, 'ws')
    build_workspace(ws, np.random.default_rng(7), 4, 40, rater.vocab)
    ws_b = os.path.join(work, 'ws_batch')
    build_workspace(ws_b, np.random.default_rng(11), BATCH_DOCS, 40,
                    rater.vocab)
    out = {}
    for _, beam, K in DECODE_BEAMS:
        args, kw, _, _ = page_block(rater, ws, K=K)
        bargs, bkw = first_batch_launch(rater, workspace_graphs(ws_b), beam)
        out[K] = (args, kw, bargs, bkw,
                  page_block(rater, ws, bf16=True, K=K)[0])
    return out


def decode_main(card) -> int:
    """Phases and cluster sizes of the two decode kernels at K=16 and
    K=32 (rows 1, 2, 1k and 2k of PERF.md), each plan that fits at 16
    blocks (rows; sharded)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from chip_smoke import cuda_ms, decode_cluster, german_rater
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    dev = torch.device('cuda')
    rater = german_rater(dev)
    D, W = rater.depth, rater.width
    marks = SCAN_PHASES['decode']
    with ThreadPoolExecutor(2) as pool:  # both marked sources at once
        built = dict(zip((dk.SOURCE, dk.BATCH_SOURCE), pool.map(
            lambda src: build_variant(src, ('-DSCAN_PHASES',), ''),
            (dk.SOURCE, dk.BATCH_SOURCE))))
    with tempfile.TemporaryDirectory(prefix='phases_') as work:
        inputs = decode_inputs(rater, work)
    for tag, beam, K in DECODE_BEAMS:
        args, kw, bargs, bkw, _ = inputs[K]
        E, A, L = args[4].shape
        N = bkw['n_docs']
        bL = bargs[4].shape[2]
        Vp, vr = args[0].shape[0], kw['v_real']
        rows = (('row 1' + tag, 'decode_lattice', False, 1, L, kw['n_real'],
                 lambda: dk.decode_lattice(*args, **kw)),
                ('row 2' + tag, 'decode_lattice_batch', True, N, bL,
                 bkw['n_real'],
                 lambda: dk.decode_lattice_batch(*bargs, **bkw)))
        for row, name, batch, n_docs, l_, n_real, call in rows:
            source = dk.BATCH_SOURCE if batch else dk.SOURCE
            loader = '_batch_library' if batch else '_library'
            cl = dk.cluster_blocks(dev, batch, n_docs, K, A, l_, D, W, Vp, vr)
            what = ('%s (%d document(s), E=%d, n_real=%d, L=%d, K=%d, A=%d, '
                    'beam_width %d)' % (row, n_docs, E, n_real, l_, K, A,
                                        beam))
            # the marks in the largest cluster, whatever the chooser takes
            big = max(dk.cluster_sizes(K, A, l_, D, W, Vp, vr), default=1)
            if big > 1:
                shard = dk.cluster_shard(K, A, l_, D, W, Vp, vr, big)
                with decode_cluster(big):
                    unmarked_ms = cuda_ms(call, 1)
                    lib = marked_library(dk, source, loader,
                                         built=built[source])[0]
                    plain_lib = getattr(dk, loader)
                    setattr(dk, loader, lambda lib=lib: lib)
                    try:
                        ms, cycles, total = marked_run(lib, call, marks)
                    finally:
                        setattr(dk, loader, plain_lib)
                print('%s phases, %s, %d blocks a document, the %s plan: '
                      '%.3f ms a launch with the marks, %.3f ms without '
                      '(CUDA events), %.0f cycles an edge in block 0 [%s]'
                      % (name, what, big, 'sharded' if shard else 'rows',
                         ms, unmarked_ms, total / n_real, card))
                print_marks(marks, cycles, total, 'n edge', n_real)
            times = []
            for c in sorted(dk.cluster_sizes(K, A, l_, D, W, Vp, vr),
                            reverse=True):
                for shard in (False, True):
                    if dk.cluster_ok(W, D, c, K, shard) and \
                            dk.cluster_smem_bytes(A, l_, K, D, W, Vp, vr, c,
                                                  shard) <= dk.SMEM_MAX:
                        with decode_cluster(c, shard):
                            times.append(('%d %s' % (c, 'sharded' if shard
                                                     else 'rows'),
                                          cuda_ms(call, 1)))
            with decode_cluster(1):
                times.append(('1', cuda_ms(call, 1)))
            print('%s at %s by blocks a document and plan (1: the one-block '
                  'layout, the first port\'s kernel): %s; the chooser takes '
                  '%d [%s]'
                  % (name, what, ', '.join('%s: %.3f ms' % ct for ct in times),
                     cl, card))
    decode_widths(dev, card)
    return 0


def decode_rows_main(card) -> int:
    """Rows 1k, 1bk and 2k (K=32) and rows 1 and 2 (K=16) of PERF.md
    alone, with the kernels of the ``ocrd_keraslm_torch`` package under
    ``--root DIR`` (another checkout, e.g. a ``git archive`` of the
    parent) where given, else this one's: each in the layout the wrapper
    chooses and in the one-block layout (CUDA events), and the sha256
    digests of ``decode_lattice``'s outputs at K=32
    (``chip_smoke.decode_digests``) in both, which every version must
    share."""
    import tempfile

    import torch
    import chip_smoke as cs
    if '--root' in sys.argv:
        sys.path.insert(0, os.path.abspath(
            sys.argv[sys.argv.index('--root') + 1]))
    from ocrd_keraslm_torch.ops import _build
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    dev = torch.device('cuda')
    pkg = os.path.dirname(os.path.dirname(dk.__file__))
    for src in (dk.SOURCE, dk.BATCH_SOURCE):
        # registers and spills of the german model's 16-block kernels
        # (W=128: NKB 8, D=2), where this call builds the source
        lines = _build.build(src)[1].splitlines()
        for i, line in enumerate(lines):
            if 'Compiling entry' in line and 'ILi8ELi2ELi16E' in line:
                print('ptxas, package %s: %s: %s' % (
                    pkg, line.split("'")[1], '; '.join(
                        x.split(':', 1)[-1].strip()
                        for x in lines[i + 1:i + 3])))
    rater = cs.german_rater(dev)
    D, W = rater.depth, rater.width
    with tempfile.TemporaryDirectory(prefix='rows_') as work:
        inputs = decode_inputs(rater, work)
    wts = rater._decode_weights(None)
    for L in (1, 8):
        cl = dk.cluster_blocks(dev, False, 1, 32, 4, L, D, W, wts['v_pad'],
                               wts['v_real'])
        for c in sorted({cl, 1}, reverse=True):
            with cs.decode_cluster(c):
                digest = cs.decode_digests(rater, dev, K=32)[L]
            print('decode_lattice output digest at K=32, L=%d (sha256 of '
                  'records, stateF, costF and the device walk over '
                  'chip_smoke.decode_digests\'s seeded 1024-edge block), %d '
                  'block(s) a document, package %s: %s [%s]'
                  % (L, c, pkg, digest, card))
    for tag, beam, K in DECODE_BEAMS:
        args, kw, bargs, bkw, args16 = inputs[K]
        E, A, L = args[4].shape
        N, bL = bkw['n_docs'], bargs[4].shape[2]
        Vp, vr = args[0].shape[0], kw['v_real']
        for row, batch, call, bf16 in (
                ('row 1' + tag, False,
                 lambda: dk.decode_lattice(*args, **kw), False),
                ('row 1b' + tag, False,
                 lambda: dk.decode_lattice(*args16, **kw), True),
                ('row 2' + tag, True,
                 lambda: dk.decode_lattice_batch(*bargs, **bkw), False)):
            if bf16 and K == 16:
                continue
            n_docs, l_ = (N, bL) if batch else (1, L)
            cl = dk.cluster_blocks(dev, batch, n_docs, K, A, l_, D, W, Vp,
                                   vr, bf16)
            times = [('chosen %d' % cl, cs.cuda_ms(call, 3))]
            sizes = [c for c in dk.cluster_sizes(K, A, l_, D, W, Vp, vr)
                     if c != cl]
            for c in sorted(set(sizes) | ({1} if cl > 1 else set()),
                            reverse=True):
                with cs.decode_cluster(c):
                    times.append(('%d' % c, cs.cuda_ms(call, 1)))
            print('%s (%s, beam_width %d: K=%d, A=%d, L=%d, %d document(s), '
                  'E=%d, n_real=%d%s), package %s, ms a launch by blocks a '
                  'document (CUDA events; the chosen: mean of 3 warm '
                  'launches): %s [%s]'
                  % (row, 'decode_lattice_batch' if batch else
                     'decode_lattice', beam, K, A, l_, n_docs, E,
                     bkw['n_real'] if batch else kw['n_real'],
                     ', bf16 weights' if bf16 else '', pkg,
                     ', '.join('%s: %.3f' % t for t in times), card))
    return 0


def decode_widths(dev, card):
    """Each cluster size against the one-block layout at W=64, D=2
    (seeded random weights, V=70 of 128): one document of 1024 edges at
    L=8, and 32 documents of 1024 edges at L=1."""
    import numpy as np
    import torch
    from chip_smoke import batch_lattice, cuda_ms, decode_cluster, \
        random_lattice
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    rng = np.random.default_rng(20261106)
    D, W, Vp, v_real, K, A, E = 2, 64, 128, 70, 16, 4, 1024
    emb = np.zeros((Vp, W), np.float32)
    emb[:v_real] = rng.normal(0, 1, (v_real, W))
    weights = [torch.from_numpy(a).to(dev) for a in (
        emb, emb.T.copy(),
        rng.normal(0, 0.3, (D, 2 * W, 4 * W)).astype(np.float32),
        rng.normal(0, 0.1, (D, 1, 4 * W)).astype(np.float32))]
    for N, L in ((1, 8), (32, 1)):
        if N == 1:
            arrays = random_lattice(rng, E, E, A, L, v_real)
        else:
            arrays = batch_lattice(rng, N, [E] * N, E, A, L, v_real)
        ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in arrays]
        state = torch.zeros((N * K, (2 * D + 1) * W), device=dev)
        state[:, :W] = weights[0][1]
        if N == 1:
            cost = torch.full((1, 128), 1e30, device=dev)
            cost[0, 0] = 0.0

            def call():
                return dk.decode_lattice(
                    *weights, *ins[:4], state, cost, lm_weight=0.5,
                    v_real=v_real, alt_steps=ins[4], n_real=E)
        else:
            cost = torch.full((N * K, 1), 1e30, device=dev)
            cost[::K] = 0.0

            def call():
                return dk.decode_lattice_batch(
                    *weights, *ins[:4], state, cost, n_docs=N, lm_weight=0.5,
                    v_real=v_real, alt_steps=ins[4], n_real=E)
        times = []
        for c in sorted(dk.cluster_sizes(K, A, L, D, W, Vp, v_real),
                        reverse=True) + [1]:
            with decode_cluster(c):
                times.append((c, cuda_ms(call, 1)))
        print('decode at W=%d, D=%d, %d document(s) of %d edges, L=%d, '
              'K=%d, A=%d, by blocks a document: %s [%s]'
              % (W, D, N, E, L, K, A,
                 ', '.join('%d: %.3f ms' % ct for ct in times), card))


def main() -> int:
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print('gen_beam_phases: no CUDA device', file=sys.stderr)
        return 1
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    modes = {'scan': scan_main, 'host': host_main, 'bwd': bwd_main,
             'decode': decode_main, 'decode-rows': decode_rows_main,
             'walk': walk_main, 'tb': tb_main, 'wide': wide_main,
             'wide-rows': wide_rows_main, 'prompt': prompt_main,
             'wide1840': wide1840_main, 'gen-rows': gen_rows_main}
    if sys.argv[1:2] and sys.argv[1] in modes:
        return modes[sys.argv[1]](card)
    return gen_main(card)


def gen_main(card) -> int:
    """Phases of ``gen_beam``'s unit layout and every layout's time at
    rows 6 and 6b, one cluster a stream and in row groups."""
    import numpy as np
    import torch
    from chip_smoke import (GEN_BATCH, GEN_BATCH_N, GEN_PROMPT, cuda_ms,
                            describe_gen_layout, gen_inputs, gen_layout,
                            gen_layouts_on, gen_prompts, german_rater)
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    dev = torch.device('cuda')
    index = torch.cuda.current_device()
    rater = german_rater(dev)
    lib = marked_library(gk, gk.SOURCE)[0]
    prompts = gen_prompts(rater, np.random.default_rng(21), GEN_BATCH)
    for row, ps, T in (('row 6', [GEN_PROMPT], 1024),
                       ('row 6b', prompts, GEN_BATCH_N)):
        weights, v_real, state0, cost0 = gen_inputs(rater, ps)
        N, K = state0.shape[:2]
        Vp, W = weights[0].shape
        D = weights[2].shape[0]

        def call():
            return gk.gen_beam(*weights, state0, cost0, length=T,
                               v_real=v_real)
        chosen = gk.layout_on(dev, N, K, D, W, Vp, 10, v_real)
        lays = gen_layouts_on(dev, K, D, W, Vp, 10, v_real, N)
        what = '%s (N=%d streams, T=%d steps, K=%d, TOPK=10, D=%d, W=%d)' \
            % (row, N, T, K, D, W)
        times = []
        for lay in lays:
            with gen_layout(lay):
                ms = cuda_ms(call, 3)
                times.append((lay, ms))
                if not lay.units:
                    continue
                marks = SCAN_PHASES['gen_beam_groups' if lay.g > 1
                                    else 'gen_beam']
                plain_lib = gk._library
                gk._library = lambda: lib
                try:
                    mms, cycles, total = marked_run(lib, call, marks)
                finally:
                    gk._library = plain_lib
            print('gen_beam phases, %s, %s: %.3f ms a launch with the '
                  'marks, %.3f ms without (CUDA events), %.0f cycles a step '
                  'in block 0 [%s]' % (what, describe_gen_layout(lay), mms,
                                       ms, total / T, card))
            print_marks(marks, cycles, total, ' step', T)
        for lay, ms in times:
            fits = gk.clusters_that_fit(index, K, D, W, Vp, 10, v_real,
                                        lay)
            waves = 1 if lay.g > 1 else -(-N // fits)
            print('gen_beam at %s, %s: %.3f ms a launch (CUDA events, mean '
                  'of 3), %.2f us a step a wave; %d clusters at once, %d '
                  'wave(s); the model\'s step %.2f us%s [%s]'
                  % (what, describe_gen_layout(lay), ms,
                     1e3 * ms / T / waves, fits, waves,
                     gk.step_cost(lay, K, D, W, v_real),
                     '; the chooser takes it' if lay == chosen else '',
                     card))
    return 0


def gen_rows_main(card) -> int:
    """Rows 6 and 6b of PERF.md alone (``gen_beam`` of one stream x 1024
    steps and of 16 streams x 256 on the german model; CUDA events, mean
    of 5 after a warm-up) in the layout the wrapper chooses, with the
    kernels of the ``ocrd_keraslm_torch`` package under ``--root DIR``
    (another checkout, e.g. a ``git archive`` of the parent) where given,
    else this one's; prints the layout taken and the records' sha256
    digests, which every version must share."""
    import numpy as np
    import torch
    if '--root' in sys.argv:
        sys.path.insert(0, os.path.abspath(
            sys.argv[sys.argv.index('--root') + 1]))
    import chip_smoke as cs
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    dev = torch.device('cuda')
    pkg = os.path.dirname(os.path.dirname(gk.__file__))
    rater = cs.german_rater(dev)
    prompts = cs.gen_prompts(rater, np.random.default_rng(21), cs.GEN_BATCH)
    for row, ps, T in (('row 6', [cs.GEN_PROMPT], 1024),
                       ('row 6b', prompts, cs.GEN_BATCH_N)):
        weights, v_real, state0, cost0 = cs.gen_inputs(rater, ps)
        N, K = state0.shape[:2]
        Vp, W = weights[0].shape

        def call():
            return gk.gen_beam(*weights, state0, cost0, length=T,
                               v_real=v_real)
        ms = cs.cuda_ms(call, 5)
        lay = gk.layout_on(dev, N, K, weights[2].shape[0], W, Vp, 10,
                           v_real)
        print('gen_beam %s (N=%d streams, T=%d steps, K=%d), package %s: '
              '%.3f ms a launch (CUDA events, mean of 5 warm launches), '
              '%.2f us a step; layout %s; records digest %s [%s]'
              % (row, N, T, K, pkg, ms, 1e3 * ms / T, tuple(lay),
                 cs._digest((call(),))[:16], card))
    return 0


# The parent's walk kernel (commit 2399e92, decode_lattice_batch.cu): one
# thread a document, its chain of dependent loads from device memory;
# built here only to time it against the kernel that replaced it.
WALK_PARENT = r"""
extern "C" __global__ void walk_parent_kernel(const float* records,
                                              const int* k_in, int* k_out,
                                              float* walks, int N, int E,
                                              int K) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t NK = (size_t)N * K;
  int k = k_in[n];
  for (int t = E - 1; t >= 0; --t) {
    const float* rec = records + (size_t)t * 3 * NK + (size_t)n * K;
    walks[((size_t)n * E + t) * 2] = rec[NK + k];
    walks[((size_t)n * E + t) * 2 + 1] = rec[2 * NK + k];
    k = (int)rec[k];
  }
  k_out[n] = k;
}
extern "C" int walk_parent_launch(const float* records, const int* k_in,
                                  int* k_out, float* walks, int N, int E,
                                  int K, void* stream) {
  const int threads = 128;
  walk_parent_kernel<<<(N + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(records, k_in, k_out, walks,
                                               N, E, K);
  return (int)cudaGetLastError();
}
"""


def walk_main(card) -> int:
    """``walk_records_batch`` against the parent's walk kernel at row 2w
    (the records of block 1 of the 32-document serving batch) and at
    ragged shapes of random records; both checked equal to the plain
    version."""
    import tempfile

    import numpy as np
    import torch
    from chip_smoke import (BATCH_DOCS, build_workspace, cuda_ms,
                            first_batch_launch, german_rater,
                            workspace_graphs)
    from ocrd_keraslm_torch.ops import _build
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    out_dir = os.path.join(_build.BUILD_DIR, 'phases')
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, 'walk_parent.cu')
    with open(src, 'w', encoding='utf-8') as fh:
        fh.write(WALK_PARENT)
    parent = ctypes.CDLL(_build.build(src)[0])
    P, I = ctypes.c_void_p, ctypes.c_int
    parent.walk_parent_launch.argtypes = [P] * 4 + [I] * 3 + [P]
    dev = torch.device('cuda')
    rater = german_rater(dev)
    with tempfile.TemporaryDirectory(prefix='phases_') as work:
        ws = os.path.join(work, 'ws_batch')
        build_workspace(ws, np.random.default_rng(11), BATCH_DOCS, 40,
                        rater.vocab)
        bargs, bkw = first_batch_launch(rater, workspace_graphs(ws))
    N = bkw['n_docs']
    rec = dk.decode_lattice_batch(*bargs, **bkw)[0]
    K = bargs[8].shape[0] // N
    rng = np.random.default_rng(20261108)
    cases = [('row 2w', rec, N, K)]
    for n_, e_, k_ in ((1, 1024, 16), (31, 1024, 32), (33, 7, 16),
                       (100, 1024, 1), (100, 1, 32)):
        r = np.zeros((e_, 3, n_ * k_), np.float32)
        r[:, 0] = rng.integers(0, k_, (e_, n_ * k_))
        r[:, 1] = rng.integers(0, 4, (e_, n_ * k_))
        r[:, 2] = rng.normal(0, 10, (e_, n_ * k_))
        cases.append(('random', torch.from_numpy(r).to(dev), n_, k_))
    for what, r, n_, k_ in cases:
        E = r.shape[0]
        k_in = torch.from_numpy(rng.integers(0, k_, n_).astype(np.int32)) \
            .to(dev)
        k_out = torch.empty((n_,), dtype=torch.int32, device=dev)
        walks = torch.empty((n_, E, 2), device=dev)

        def old():
            assert parent.walk_parent_launch(
                r.data_ptr(), k_in.data_ptr(), k_out.data_ptr(),
                walks.data_ptr(), n_, E, k_,
                torch.cuda.current_stream().cuda_stream) == 0
            return k_out, walks

        def new():
            return dk.walk_records_batch(r, k_in, n_docs=n_, beam=k_)
        want = dk.walk_records_batch_ref(r.cpu(), k_in.cpu(), n_docs=n_,
                                         beam=k_)
        for fn in (old, new):
            got = fn()
            torch.cuda.synchronize()
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), \
                (what, fn.__name__)
        times = [cuda_ms(fn, 20) for fn in (old, new, new, old)]
        print('walk_records_batch at %s (N=%d documents, E=%d, K=%d): the '
              'parent\'s design %.4f ms, the staged walk %.4f ms, %.4f ms, '
              'the parent\'s %.4f ms (CUDA events, mean of 20, in that '
              'order); both equal to the plain version [%s]'
              % ((what, n_, E, k_) + tuple(times) + (card,)))
    return 0


# The parent's traceback kernel (commit 67180f1, gen_traceback.cu): one
# thread a cursor, one block a stream, each step's backpointer loaded
# from device memory; built here only to time it against the kernel that
# replaced it.
TB_PARENT = r"""
extern "C" __global__ void tb_parent_kernel(const float* __restrict__ rec,
                                            const int* __restrict__ best,
                                            int* __restrict__ out, int T,
                                            int K, int VARS, int out_length) {
  const int n = blockIdx.x;
  const float* rn = rec + (size_t)n * T * 3 * K;
  for (int v = threadIdx.x; v < VARS; v += blockDim.x) {
    int* o = out + ((size_t)n * VARS + v) * T;
    for (int t = out_length; t < T; ++t) o[t] = 0;
    int k = best[(size_t)n * VARS + v];
    for (int t = out_length - 1; t >= 0; --t) {
      const float* r = rn + (size_t)t * 3 * K;
      k = min(max(k, 0), K - 1);
      const float ch = r[k];
      k = (int)r[K + k];
      o[t] = (int)ch;
    }
  }
}
extern "C" int tb_parent_launch(const float* rec, const int* best, int* out,
                                int N, int T, int K, int VARS,
                                int out_length, void* stream) {
  const int threads = VARS < 1024 ? (VARS + 31) / 32 * 32 : 1024;
  tb_parent_kernel<<<N, threads, 0, (cudaStream_t)stream>>>(
      rec, best, out, T, K, VARS, out_length);
  return (int)cudaGetLastError();
}
"""


def tb_main(card) -> int:
    """``traceback`` against the parent's kernel at rows 7 and 7b, at
    seeded records of several lengths, and over every segment length at
    rows 7 and 7b; every output checked equal to the plain version."""
    import numpy as np
    import torch
    from chip_smoke import (GEN_BATCH, GEN_BATCH_N, GEN_N, GEN_PROMPT,
                            GEN_VARIANTS, cuda_ms, device_ms, gen_inputs,
                            gen_prompts, german_rater)
    from ocrd_keraslm_torch.ops import _build
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    from ocrd_keraslm_torch.ops.beam_device import LENGTH_BUCKETS
    from ocrd_keraslm_torch.utils.buckets import bucket_unbounded
    out_dir = os.path.join(_build.BUILD_DIR, 'phases')
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, 'tb_parent.cu')
    with open(src, 'w', encoding='utf-8') as fh:
        fh.write(TB_PARENT)
    parent = ctypes.CDLL(_build.build(src)[0])
    P, I = ctypes.c_void_p, ctypes.c_int
    parent.tb_parent_launch.argtypes = [P] * 3 + [I] * 5 + [P]
    print('\n'.join(line for line in _build.build(gk.TB_SOURCE)[1]
                     .splitlines() if 'registers' in line or 'spill' in line
                     or 'Compiling' in line))
    dev = torch.device('cuda')
    rater = german_rater(dev)
    rng = np.random.default_rng(20261017)
    cases = []
    for row, prompts, n in (
            ('row 7', [GEN_PROMPT], GEN_N),
            ('row 7b', gen_prompts(rater, np.random.default_rng(21),
                                   GEN_BATCH), GEN_BATCH_N)):
        weights, v_real, state0, cost0 = gen_inputs(rater, prompts)
        T = bucket_unbounded(n, LENGTH_BUCKETS)
        rec = gk.gen_beam(*weights, state0, cost0, length=T, v_real=v_real)
        vars_ = GEN_VARIANTS if row == 'row 7' else 1
        cases.append((row, rec, vars_, n))
    for T in (16, 64, 256, 1024, 4096):
        rec = np.zeros((1, T, 3, 256), np.float32)
        rec[:, :, 0] = rng.integers(1, 70, (1, T, 256))
        rec[:, :, 1] = rng.integers(0, 256, (1, T, 256))
        cases.append(('seeded records', torch.from_numpy(rec).to(dev),
                      GEN_VARIANTS, T))
    cases.append(('seeded records, 1024 cursors', cases[-2][1], 1024, 1024))
    for what, rec, vars_, out_length in cases:
        N, T, _, K = rec.shape
        best = torch.argsort(rec[:, out_length - 1, 2], dim=1, stable=True)
        best = best[:, :vars_] if vars_ <= K else \
            best.repeat(1, -(-vars_ // K))[:, :vars_]
        best = best.int().contiguous()
        out = torch.empty((N, vars_, T), dtype=torch.int32, device=dev)

        def old():
            assert parent.tb_parent_launch(
                rec.data_ptr(), best.data_ptr(), out.data_ptr(), N, T, K,
                vars_, out_length, torch.cuda.current_stream().cuda_stream
            ) == 0
            return out

        def new():
            return gk.traceback(rec, best, out_length)
        want = gk.traceback_ref(rec.cpu(), best.cpu(), out_length)
        for fn in (old, new):
            got = fn()
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (what, fn.__name__)
        lay = gk.tb_layout(T, K, out_length)
        times = [device_ms(fn, 20) for fn in (old, new, new, old)]
        print('gen_traceback at %s (N=%d streams, T=%d, K=%d, %d cursors, '
              'out_length %d): the parent\'s design %.4f ms, the segmented '
              'walk (segments of %d steps, %d launch(es)) %.4f ms, %.4f ms, '
              'the parent\'s %.4f ms (device time, mean of 20, in that '
              'order); both equal to the plain version [%s]'
              % ((what, N, T, K, vars_, out_length, times[0], lay.L,
                  1 + (lay.G > 1)) + tuple(times[1:]) + (card,)))
        if what.startswith('row'):
            # the walk needs two floats of the records a cursor and step,
            # the cursors' start slots, and writes the (VARS, T) chars
            nbytes = N * vars_ * (out_length * 8 + 4 + T * 4)
            print('gen_traceback at %s: plain version %.3f ms (CUDA events, '
                  'one warm run); bound %.3g ms by bytes (%d bytes at 3.35 '
                  'TB/s), the segmented walk at %.3g%% of it [%s]'
                  % (what, cuda_ms(lambda: gk.traceback_ref(rec, best,
                                                           out_length), 1),
                     1e3 * nbytes / 3.35e12, nbytes,
                     100 * 1e3 * nbytes / 3.35e12 / times[1], card))
        sweep = []
        for L in (L for L in (4, 8, 16, 32, 64) if L <= T):
            def seg(L=L):
                return gk.traceback(rec, best, out_length, segment=L)
            assert torch.equal(seg().cpu(), want), (what, L)
            sweep.append((L, device_ms(seg, 20)))
        print('gen_traceback at %s by steps a segment: %s; the layout rule '
              'takes %d [%s]'
              % (what, ', '.join('%d: %.4f ms' % lt for lt in sweep), lay.L,
                 card))
    return 0


def _call_launches(fn):
    """(launches, device operations, their summed ms) of one ``fn()``
    call, from a ``torch.profiler`` trace opened by 64 waited-for
    kernels (a later trace's first device records can carry a stale
    clock): the CUDA API calls inside the call's range that queue
    work, and the device events they correlate with."""
    import json
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.zeros(1, device='cuda')
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            x.add_(1.0)
            torch.cuda.synchronize()
        with record_function('prompt_call'):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path, encoding='utf-8') as fh:
            events = json.load(fh)['traceEvents']
    mark, = [e for e in events if e.get('name') == 'prompt_call'
             and e.get('cat') == 'user_annotation']
    queued = [e for e in events
              if e.get('cat') in ('cuda_runtime', 'cuda_driver')
              and mark['ts'] <= e['ts'] <= mark['ts'] + mark['dur']
              and any(k in e['name'] for k in ('Launch', 'Memcpy',
                                               'Memset'))]
    corr = {e['args']['correlation'] for e in queued}
    ops = [e for e in events
           if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')
           and e.get('args', {}).get('correlation') in corr]
    return len(queued), len(ops), sum(e['dur'] for e in ops) / 1e3


def prompt_main(card) -> int:
    """Generation's prompt steps, plain against the captured graph."""
    import time

    import numpy as np
    import torch
    from chip_smoke import GEN_BATCH, device_ms, gen_prompts, german_rater
    from ocrd_keraslm_torch.ops import beam_device as bd
    dev = torch.device('cuda')
    rater = german_rater(dev)
    w = rater._decode_weights(None)
    weights = (w['emb'], w['wcat'], w['bias'])
    for what, prompts in (
            ('one stream of 36 chars', [('Die Vernunft ' * 3)[:36]]),
            ('row 6b, %d streams' % GEN_BATCH,
             gen_prompts(rater, np.random.default_rng(21), GEN_BATCH))):
        ids, mask = bd._prefix_arrays([rater.vocab.encode(p)
                                       for p in prompts])
        ways = {'plain': lambda: bd._prefix_eager(*weights, ids, mask),
                'graph': lambda: bd._prefix_graph(*weights, ids, mask)}
        roots = {k: fn() for k, fn in ways.items()}
        torch.cuda.synchronize()
        assert torch.equal(roots['plain'], roots['graph']), what
        for name in ('plain', 'graph', 'graph', 'plain'):
            fn = ways[name]
            issue, wall = [], []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                issue.append(t1 - t0)
                wall.append(time.perf_counter() - t0)
            devs = [device_ms(fn, 1) for _ in range(5)]
            launches, ops, busy = _call_launches(fn)
            print('prompt steps, %s (%d steps, N=%d), %s: host %.3f ms '
                  '(median of 20 issues), wall %.3f ms, device %.3f-%.3f '
                  'ms (5 calls queued behind a sleep), %d launches, %d '
                  'device operations summing %.3f ms (torch.profiler); '
                  'root rows equal bit for bit [%s]'
                  % (what, bd._prompt_steps(mask), ids.shape[0], name,
                     1e3 * float(np.median(issue)),
                     1e3 * float(np.median(wall)), min(devs), max(devs),
                     launches, ops, busy, card))
    return 0


if __name__ == '__main__':
    sys.exit(main())
