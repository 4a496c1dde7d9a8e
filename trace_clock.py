#!/usr/bin/env python3
"""Whether a device trace keeps the first device records of a run, on
one GPU.

    python3 trace_clock.py

Two processes run side by side on the card.  One traces with
``torch.profiler`` as it is ("plain"), the other through the port's
``utils/devtrace.start_trace`` ("devtrace"), which opens every trace
with its clock warm-up.  Each traces a run of ``N`` kernels 5 ms apart:
at its start, after ``IDLE`` s idle, at once again, after 100,000 small
kernels and a forced CUPTI flush, after ``IDLE2`` s more idle, and after
3,000 kernels each read back by the host.  For each trace it prints how
many of the run's kernels the Chrome trace kept and, for ``devtrace``,
how many of the warm-up's, with the card's name and power limit.  Run
with ``KINETO_LOG_LEVEL=1`` to see Kineto's record counts in each
process's standard error.  Takes about five minutes.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N = 40          # kernels of a traced run
IDLE = 150      # seconds idle before the second trace
IDLE2 = 90      # seconds idle before the fifth


def flush_cupti():
    """``cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED)`` on the
    CUPTI library the profiler loaded."""
    with open('/proc/self/maps') as fh:
        path = next(line.split()[-1] for line in fh if 'libcupti' in line)
    ctypes.CDLL(path).cuptiActivityFlushAll(ctypes.c_uint32(1))


def small_kernels(n=100000):
    import torch
    x = torch.ones(16, device='cuda')
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()


def read_backs(n=3000):
    import torch
    x = torch.ones(128, device='cuda')
    for _ in range(n):
        x = x * 1.0
        float(x[0])


def traced(mode, what):
    """One traced run of ``N`` kernels; prints the kernels kept."""
    import torch
    from chip_smoke import trace_events
    from ocrd_keraslm_torch.utils import devtrace
    x = torch.ones(1024, device='cuda')
    torch.cuda.synchronize()
    d = tempfile.mkdtemp(prefix='trace_clock_')
    try:
        if mode == 'devtrace':
            stop = devtrace.start_trace(d)
        else:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()

            def stop():
                torch.cuda.synchronize()
                prof.stop()
                prof.export_chrome_trace(os.path.join(d, 'trace.json'))
                return os.path.join(d, 'trace.json')
        for _ in range(N):
            x = x * 1.0001
            time.sleep(0.005)
        _, kernels, _, warmed = trace_events(stop())
    finally:
        shutil.rmtree(d)
    print(json.dumps({'mode': mode, 'trace': what,
                      'kept': sum(1 for e in kernels if 'Mul' in e['name']),
                      'of': N, 'warm-up kept': len(warmed)}), flush=True)


def run(mode):
    t0 = time.time()
    traced(mode, 'first')
    time.sleep(IDLE)
    traced(mode, 'after %d s idle' % IDLE)
    traced(mode, 'at once again')
    small_kernels()
    flush_cupti()
    traced(mode, 'after 100,000 small kernels and a forced CUPTI flush')
    time.sleep(IDLE2)
    traced(mode, 'after %d s more idle' % IDLE2)
    read_backs()
    traced(mode, 'after 3,000 read-backs')
    print(json.dumps({'mode': mode, 'seconds': round(time.time() - t0, 1)}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('trace_clock: no CUDA device; this script runs only on a GPU',
              file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               mode], cwd=HERE)
             for mode in ('plain', 'devtrace')]
    return max(p.wait() for p in procs)


if __name__ == '__main__':
    sys.path.insert(0, HERE)
    if sys.argv[1:2] in (['plain'], ['devtrace']):
        run(sys.argv[1])
        sys.exit(0)
    sys.exit(main())
