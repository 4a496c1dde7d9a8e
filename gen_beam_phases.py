#!/usr/bin/env python3
"""Where a step of the generation beam-step kernel, or of the two LSTM
forward recurrences, goes, on one GPU.

    python3 gen_beam_phases.py          # gen_beam
    python3 gen_beam_phases.py scan     # lstm_scan and score_scan
    python3 gen_beam_phases.py host     # their host time per call

Builds a copy of ``ocrd_keraslm_torch/csrc/gen_beam.cu`` with
``clock64()`` marks after each phase of a step (block 0, thread 0: the
time from the previous mark, barriers and waits included) into
``ocrd_keraslm_torch/_build/phases/``, runs it on the german model
(K=256, TOPK=10) for one stream of 1024 steps and 16 streams of 256
steps, at 16 and at 8 blocks a stream, and prints each phase's cycles a
step and share, beside the launch's time with the marks and that of the
unmarked kernel through its wrapper (CUDA events, mean of 3 after a
warm-up) and the card's name and power limit.  The marks are inserted
at fixed lines of the kernel source; after an edit there the script
stops and names the line it did not find.

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

Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ('load rows', 'gate products', 'gate update', 'logits',
          'row candidates (warp 0)', 'cluster barrier 1', 'candidate copy',
          'bisection', 'counts, scan, compaction', 'records, next state',
          'cluster barrier 2')
MARK = ('if (prof_on) { const unsigned long long tn = clock64(); '
        'g_phase[%d] += tn - tp; tp = tn; }\n')
# (anchor, text before it, text after it): each anchor occurs once
EDITS = (
    ('#define BIGF 3.0e38f\n', '',
     '__device__ unsigned long long g_phase[%d];\n' % len(PHASES)),
    ('__device__ void rows_step(const Params& p, int R, float* xs, '
     'float* zb) {', '__device__ void rows_step(const Params& p, int R, '
     'float* xs, float* zb, bool prof_on, unsigned long long& tp) {', None),
    ('                     G, G, p.bias + d * G, zb);\n    __syncthreads();\n',
     '', '    ' + MARK % 1),
    ('      row[(1 + D + d) * W + u] = hc.y;\n    }\n    __syncthreads();\n',
     '', '    ' + MARK % 2),
    ('p.v_real, nullptr, zb);\n  __syncthreads();\n', '', '  ' + MARK % 3),
    ('  const size_t buf = (size_t)p.N * fringe;\n', '',
     '  const bool prof_on = blockIdx.x == 0 && threadIdx.x == 0;\n'
     '  unsigned long long tp = clock64();\n'),
    ('xs4[i] = in4[i];\n    __syncthreads();\n', '', '    ' + MARK % 0),
    ('rows_step<RB>(p, R, xs, zb);', 'rows_step<RB>(p, R, xs, zb, prof_on, '
     'tp);', None),
    ('    cluster.sync();  // every block\'s candidates are ready\n',
     '    ' + MARK % 4, '    ' + MARK % 5),
    ('      allch[i] = cluster.map_shared_rank(cchar, b)[o];\n    }\n'
     '    __syncthreads();\n', '', '    ' + MARK % 6),
    ('    const unsigned thr = (unsigned)misc[1];\n', '', '    ' + MARK % 7),
    ('    // ---- own slots: record, cost, next state ----\n',
     '    ' + MARK % 8, ''),
    ('    cluster.sync();  // rows and candidates may be overwritten now\n',
     '    ' + MARK % 9, '    ' + MARK % 10),
)
READ = '''
extern "C" int gen_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int gen_phase_reset() {
  unsigned long long zero[%d] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
''' % len(PHASES)


def instrumented_source(src_dir, out_dir):
    """Write the marked copy of gen_beam.cu (and the headers beside it)
    into ``out_dir``; returns its path."""
    with open(os.path.join(src_dir, 'gen_beam.cu'), encoding='utf-8') as fh:
        text = fh.read()
    for anchor, before, after in EDITS:
        if text.count(anchor) != 1:
            sys.exit('gen_beam_phases: the kernel source no longer has '
                     'the line %r once; update EDITS' % anchor.strip())
        text = text.replace(anchor, before + anchor + after
                            if after is not None else before)
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(src_dir):
        if name.endswith('.cuh'):
            shutil.copy(os.path.join(src_dir, name), out_dir)
    path = os.path.join(out_dir, 'gen_beam_phases.cu')
    with open(path, 'w', encoding='utf-8') as fh:
        fh.write(text + READ)
    return path


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
        (7, 'wait for every layer\'s h of the step (mbarriers)'))}


def marked_library(module, source):
    """``module``'s kernel library built from ``source`` with the phase
    marks on (into ``_build/phases/``), with the wrapper's argument
    types; returns ``(library, its compiler log)``."""
    from ocrd_keraslm_torch.ops import _build
    out_dir = os.path.join(_build.BUILD_DIR, 'phases')
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, os.path.basename(source)[:-3] + '.so')
    proc = subprocess.run([_build._nvcc(source)] + _build.NVCC_FLAGS
                          + ['-DSCAN_PHASES', '-o', path, source],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit('gen_beam_phases: nvcc failed:\n' + proc.stderr)
    load = _build.load
    _build.load = lambda src: ctypes.CDLL(path)
    try:
        lib = module._library.__wrapped__()
    finally:
        _build.load = load
    lib.scan_phase_read.argtypes = [ctypes.c_void_p]
    return lib, proc.stdout + proc.stderr


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


def print_layout_times(name, shape, times, chosen, card):
    print('%s at %s by layout (streams a block or cluster, blocks a '
          'cluster, register layout (r) or one-block (1): ms a launch, CUDA '
          'events): %s; the chooser takes (%d, %d, %s) [%s]'
          % (name, shape, ', '.join('(%d, %d, %s): %.3f' % (
              rb, cl, 'r' if reg else '1', ms) for rb, cl, reg, ms in times),
             chosen.rb, chosen.cl, 'r' if chosen.reg else '1', card))


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
                for rb, cl, reg in scan_layouts(kind, B, W, D) if reg]
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
        try:
            call()                               # warm-up
            torch.cuda.synchronize()
            libs[name].scan_phase_reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
        finally:
            module._library = plain_lib
        marks = SCAN_PHASES[name]
        cycles = (ctypes.c_ulonglong * 8)()
        assert libs[name].scan_phase_read(ctypes.cast(cycles,
                                                      ctypes.c_void_p)) == 0
        total = sum(cycles[k] for k, _ in marks)
        print('%s phases, %s, layout %s: %.3f ms a launch with the marks, '
              '%.3f ms without (CUDA events), %.0f cycles a step in block 0 '
              '[%s]' % (name, what, tuple(lay), start.elapsed_time(end),
                        unmarked_ms, total / T, card))
        for k, phase in marks:
            print('  %-46s %8.0f cycles a step %5.1f%%'
                  % (phase, cycles[k] / T, 100.0 * cycles[k] / total))
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


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('gen_beam_phases: no CUDA device', file=sys.stderr)
        return 1
    from chip_smoke import (cluster_size, cuda_ms, gen_inputs, gen_prompts,
                            german_rater)
    from ocrd_keraslm_torch.ops import _build
    from ocrd_keraslm_torch.ops import gen_kernel as gk
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    if sys.argv[1:] == ['scan']:
        return scan_main(card)
    if sys.argv[1:] == ['host']:
        return host_main(card)
    path, log = _build.build(instrumented_source(
        _build.CSRC_DIR, os.path.join(_build.BUILD_DIR, 'phases')))
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gen_beam_launch.argtypes = [P] * 8 + [I] * 9 + [F, P]
    lib.gen_phase_read.argtypes = [P]
    rater = german_rater(torch.device('cuda'))
    prompts = gen_prompts(rater, np.random.default_rng(21), 16)
    weights, v_real, state0, cost0 = gen_inputs(rater, prompts)
    emb, embT, wcat, bias = weights
    D, W, Vp = wcat.shape[0], emb.shape[1], emb.shape[0]
    for N, T in ((1, 1024), (16, 256)):
        st, co = state0[:N].contiguous(), cost0[:N].contiguous()
        K, S = st.shape[1], st.shape[2]
        for blocks in (gk.CLUSTER_WIDE, gk.CLUSTER):
            rec = torch.empty((N, T, 3, K), device='cuda')
            scratch = torch.empty((2, N, K, S), device='cuda')

            def launch():
                status = lib.gen_beam_launch(
                    emb.data_ptr(), embT.data_ptr(), wcat.data_ptr(),
                    bias.data_ptr(), st.data_ptr(), co.data_ptr(),
                    rec.data_ptr(), scratch.data_ptr(), blocks, N, T, K, D,
                    W, Vp, v_real, 10, gk.log_threshold(0.004),
                    torch.cuda.current_stream().cuda_stream)
                assert status == 0, status
            launch()                       # warm-up
            lib.gen_phase_reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * len(PHASES))()
            assert lib.gen_phase_read(ctypes.cast(cycles, P)) == 0
            total = sum(cycles)
            with cluster_size(blocks):
                unmarked_ms = cuda_ms(lambda: gk.gen_beam(
                    *weights, st, co, length=T, v_real=v_real), 3)
            print('gen_beam phases, N=%d streams, T=%d steps, %d blocks a '
                  'stream: %.3f ms a launch with the marks, %.3f ms without '
                  '(CUDA events), %.0f cycles a step in block 0 [%s]'
                  % (N, T, blocks, start.elapsed_time(end), unmarked_ms,
                     total / T, card))
            for name, c in zip(PHASES, cycles):
                print('  %-26s %9.0f cycles a step %5.1f%%'
                      % (name, c / T, 100.0 * c / total))
    return 0


if __name__ == '__main__':
    sys.exit(main())
