"""Device trace of a CLI run (the ``--jax-trace DIR`` option).

Counterpart of the JAX package's ``jax.profiler.start_trace``: a
``torch.profiler`` trace of the host (CPU activities) and, on CUDA, of
the card (kernels, copies and memsets), written as one Chrome trace
JSON (``traceEvents``; Perfetto or ``chrome://tracing`` open it) into
DIR when the command ends.  The option keeps the JAX CLI's name, so
both packages' CLIs take the same arguments.

On CUDA a trace opens with a warm-up of ``WARMUP_KERNELS`` tiny kernels,
each waited for (the host range ``keraslm_clock_warmup``).  In a
process that has traced before, CUPTI stamps the first device records
of some later traces with a stale mapping of the card's clock onto the
host's, so far off that Kineto drops them as outside the trace's window
(``KINETO_LOG_LEVEL=1`` prints them as "Out-of-range" in its record
counts): on an H100 the first 12-20 device records of such a trace,
minutes into the process's life, however long the gaps between them.
Those were the first kernels and copies of the traced run; the
warm-up's kernels now take those stamps instead.
"""
from __future__ import annotations

import os
import socket

WARMUP_KERNELS = 64


def _warmup() -> None:
    import torch
    x = torch.zeros(1, device='cuda')
    with torch.profiler.record_function('keraslm_clock_warmup'):
        for _ in range(WARMUP_KERNELS):
            x.add_(1.0)
            torch.cuda.synchronize()


def start_trace(directory: str):
    """Start tracing; returns the function that stops the trace and
    writes ``DIR/<host>_<pid>.pt.trace.json`` (and returns its path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(directory, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    if cuda:
        _warmup()

    def stop() -> str:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(directory, '%s_%d.pt.trace.json'
                            % (socket.gethostname(), os.getpid()))
        prof.export_chrome_trace(path)
        return path
    return stop
