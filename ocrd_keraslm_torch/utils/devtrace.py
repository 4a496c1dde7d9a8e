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

The trace records every thread of the process where the installed
torch has ``profile_all_threads`` (else the thread that started it).

**Spans.**  :func:`span` marks the port's layer boundaries as host
ranges named ``keraslm.<name>``, in the same trace as the kernels and
on its host clock, onto which CUPTI maps the card's events.  They
record only while a ``torch.profiler`` trace runs (this module's, or
any other); otherwise a span costs one flag check.  A span's ``unit``
(``page=<id>``, ``step=<n>``, ``epoch=<n>``, ``request=<n>``) shows as
the range's ``unit`` argument in a trace that records shapes
(``record_shapes=True``) of the thread that started it; torch 2.13
drops it from traces of every thread, such as this one.  The spans,
each on the thread that waits unless said:

* the page loop (``wrapper/rate.py``): ``rate.workspace`` (a whole
  ``process_workspace``, the METS save included), ``rate.load_wait``
  (waiting for a page's prefetched load, or loading it inline; page),
  ``rate.load`` (``_load_page``, in the prefetch thread), ``rate.launch``
  (a page group's fill and launch, or one page's begin; its first
  page), ``rate.finish`` (a page's fetch, walk, write-back and write;
  page), ``rate.mets_save`` (a METS save);
* the fetch (``ops/beam_device._fetch``): ``fetch``, the host waiting
  for a result's copy from the card (decode and generation);
* the trainer (``training.py``, ``data.py``): ``data.wait`` (waiting
  for the next batch), ``data.batch`` (building one, in the prefetch
  thread), ``train.step`` (issuing one step; step), ``train.validate``
  (the validation pass; epoch), ``train.checkpoint`` (the best-only
  weights and the train-state snapshot; epoch);
* generation: ``gen.request`` (``Rater.generate``; the process's
  request number), ``gen.prompt`` (the prompt's steps), ``gen.strings``
  (building the strings after the fetch).
"""
from __future__ import annotations

import contextlib
import os
import socket

import torch
import torch.autograd.profiler as _autograd_profiler

WARMUP_KERNELS = 64
PREFIX = 'keraslm.'
# the one context manager every span returns while nothing traces
_OFF = contextlib.nullcontext()
# a C++ range, ``at::RecordFunction`` at function scope: ~2 us a span
# while tracing where ``torch.profiler.record_function`` takes ~13 us,
# no twin of the range on the card's timeline, and its unit kept as a
# keyword input
_RANGE = torch._C._profiler._RecordFunctionFast


def span(name: str, unit=None):
    """A host range ``keraslm.<name>`` over a ``with`` block while a
    torch profiler records (the process-wide flag, read from any
    thread), else the shared no-op context manager.  ``unit`` (a
    string) ties the span to its page, step or request."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if unit:
        return _RANGE(PREFIX + name, [], {'unit': unit})
    return _RANGE(PREFIX + name)


def _all_threads():
    """Kineto's setting to record every thread, or None where the
    installed torch lacks it."""
    config = getattr(torch._C._profiler, '_ExperimentalConfig', None)
    try:
        return config(profile_all_threads=True)
    except TypeError:
        return None


def _warmup() -> None:
    x = torch.zeros(1, device='cuda')
    with torch.profiler.record_function('keraslm_clock_warmup'):
        for _ in range(WARMUP_KERNELS):
            x.add_(1.0)
            torch.cuda.synchronize()


def start_trace(directory: str):
    """Start tracing; returns the function that stops the trace and
    writes ``DIR/<host>_<pid>.pt.trace.json`` (and returns its path)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(directory, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   experimental_config=_all_threads())
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
