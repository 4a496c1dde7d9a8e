"""Device trace of a CLI run (the ``--jax-trace DIR`` option).

Counterpart of the JAX package's ``jax.profiler.start_trace``: a
``torch.profiler`` trace of the host (CPU activities) and, on CUDA, of
the card (kernels, copies and memsets), written as one Chrome trace
JSON (``traceEvents``; Perfetto or ``chrome://tracing`` open it) into
DIR when the command ends.  The option keeps the JAX CLI's name, so
both packages' CLIs take the same arguments.
"""
from __future__ import annotations

import os
import socket


def start_trace(directory: str):
    """Start tracing; returns the function that stops the trace and
    writes ``DIR/<host>_<pid>.pt.trace.json`` (and returns its path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(directory, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()

    def stop() -> str:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(directory, '%s_%d.pt.trace.json'
                            % (socket.gethostname(), os.getpid()))
        prof.export_chrome_trace(path)
        return path
    return stop
