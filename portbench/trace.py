"""The benchmark's own device trace of the measured window.

``torch.profiler`` traces the host's operations and the card's kernels,
copies and sets over the window (the ``portbench.window`` host range).
A trace opens with 64 tiny kernels, each waited for: in a process that
has traced before, CUPTI can stamp the first device records of a trace
with a stale mapping of the card's clock, and Kineto then drops them as
outside the trace; those stamps fall on the warm-up instead (copied
from ``ocrd_keraslm_torch/utils/devtrace.py`` at commit 4cfb97a, so
that a later change there cannot move this yardstick).
"""
from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

WARMUP_KERNELS = 64
WINDOW = 'portbench.window'
# the port's hand-written kernels (``ocrd_keraslm_torch/csrc``) by name
PORT_KERNELS = (r'\b(decode_lattice\w*|score_\w*kernel|lstm_scan\w*|'
                r'lstm_bwd\w*|lstm_du_\w+|gen_beam\w*|gen_traceback\w*|'
                r'walk_records_batch_kernel)\b')
COPIES = r'^(Memcpy|Memset)'
HOST_RANGES = {WINDOW, 'portbench.clock_warmup'}


class Tracer:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        x = torch.zeros(1, device='cuda')
        with torch.profiler.record_function('portbench.clock_warmup'):
            for _ in range(WARMUP_KERNELS):
                x.add_(1.0)
                torch.cuda.synchronize()

    @contextmanager
    def window(self):
        with self.torch.profiler.record_function(WINDOW):
            yield
            self.torch.cuda.synchronize()

    def stop(self) -> 'Trace':
        self.torch.cuda.synchronize()
        self.prof.stop()
        return Trace(_events(self.prof))


def _events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every traced event."""
    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            # a host range is mirrored on the device's timeline as a user
            # annotation: it is no device work
            dev = 'CUDA' in str(e.device_type()) and not (
                e.is_user_annotation() if hasattr(e, 'is_user_annotation')
                else e.name() in HOST_RANGES)
            start = int(e.start_ns())
            out.append((e.name(), dev, start, start + int(e.duration_ns())))
        return out
    for e in prof.events():
        dev = 'CUDA' in str(e.device_type) and e.name not in HOST_RANGES
        out.append((e.name, dev, int(e.time_range.start * 1000),
                    int(e.time_range.end * 1000)))
    return out


class Trace:
    """What the window's trace holds: device time by name, busy and
    idle time, and what the host ran in the idle gaps."""

    def __init__(self, events):
        win = [e for e in events if not e[1] and e[0] == WINDOW]
        events = [e for e in events if not (e[1] and (
            e[0] in HOST_RANGES or e[0].startswith('rater.')))]
        if not win:
            raise RuntimeError('the trace holds no %s range' % WINDOW)
        self.t0, self.t1 = win[-1][2], win[-1][3]
        self.window_s = (self.t1 - self.t0) * 1e-9
        self.device = sorted(
            (max(s, self.t0), min(e, self.t1), n) for n, d, s, e in events
            if d and e > self.t0 and s < self.t1)
        self.host = [(s, e, n) for n, d, s, e in events
                     if not d and n != WINDOW and e > self.t0
                     and s < self.t1]
        busy, gaps, cur_s, cur_e = 0, [], None, None
        last = self.t0
        for s, e, _ in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                gaps.append((last, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            last = max(last, cur_e)
        if cur_e is not None:
            busy += cur_e - cur_s
        gaps.append((last, self.t1))
        self.busy_s = busy * 1e-9
        self.gaps = [(s, e) for s, e in gaps if e > s]

    def device_seconds(self, pattern: str) -> float:
        """Device seconds of the events whose name matches ``pattern``
        (a regular expression, searched)."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, n in self.device if rx.search(n)) * 1e-9

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for s, e, n in self.device:
            key = n.split('(')[0].split('<')[0].strip() or n
            by[key] = by.get(key, 0) + (e - s)
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest idle gaps, each named by the innermost host range
        or operation running at its middle (else the last one before)."""
        out = []
        for s, e in sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (s + e) // 2
            inside: Optional[tuple] = None
            before: Optional[tuple] = None
            for hs, he, n in self.host:
                if hs <= mid <= he:
                    if inside is None or he - hs < inside[1] - inside[0]:
                        inside = (hs, he, n)
                elif he < mid and (before is None or he > before[1]):
                    before = (hs, he, n)
            if inside is not None:
                name = inside[2]
            elif before is not None:
                name = 'after ' + before[2]
            else:
                name = 'host'
            out.append([name, (e - s) * 1e-9])
        return out
