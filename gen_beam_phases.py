#!/usr/bin/env python3
"""Where a step of the generation beam-step kernel goes, on one GPU.

    python3 gen_beam_phases.py

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
stops and names the line it did not find.  Without a CUDA device it
exits non-zero.
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
