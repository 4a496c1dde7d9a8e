"""The program's spans in a traced window, for the per-layer metrics
that read them.

The port marks its layer boundaries as host ranges named
``keraslm.<name>`` (``ocrd_keraslm_torch/utils/devtrace.py`` ``span``)
while a profiler records; :class:`portbench.trace.Trace` keeps the
window's host ranges in ``host`` as (start ns, end ns, name).  A
program without spans gives none, and its readers return None."""
from __future__ import annotations

from typing import List, Tuple

PREFIX = 'keraslm.'


def ranges(trace, name: str, clip: bool = True) -> List[Tuple[int, int]]:
    """(start, end) ns of the spans ``keraslm.<name>`` that reach into
    the window, in start order, each cut to it unless ``clip`` is
    false."""
    full = PREFIX + name
    out = [(s, e) for s, e, n in trace.host
           if n == full and e > trace.t0 and s < trace.t1]
    if clip:
        out = [(max(s, trace.t0), min(e, trace.t1)) for s, e in out]
    return sorted(out)


def seconds(spans) -> float:
    return sum(e - s for s, e in spans) * 1e-9


def inside(spans, outer) -> list:
    """The spans that lie within one of the ``outer`` spans."""
    return [(s, e) for s, e in spans
            if any(os <= s and e <= oe for os, oe in outer)]


def busy_seconds(trace, outer: str, waits) -> float:
    """Seconds of the ``outer`` spans less those of the ``waits`` spans
    inside them, all within the window."""
    out = ranges(trace, outer)
    held = [r for name in waits for r in ranges(trace, name)]
    return seconds(out) - seconds(inside(held, out))
