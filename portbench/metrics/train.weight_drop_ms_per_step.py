"""train.weight_drop_ms_per_step: device ms a training step spends in the
kernels that the weight drop launches (the draws of the masks on the
card and the masked copies of the recurrent matrices), over the window's
training steps.

A kernel counts when the operation that launched it (the profiler's
linked correlation id) ran inside a ``keraslm.train.weight_drop`` span,
on the span's thread; its time is clipped to the window.  The product
of the gradient through the mask runs in the backward, outside the span,
and is not counted.  The reader needs the kind's profiler
(``job.tracer``); without it, spans or linked kernels it reads nothing.
"""
from bisect import bisect_right

from portbench import spans


def read(job):
    steps = getattr(job, 'train_steps', 0)
    tracer = getattr(job, 'tracer', None)
    if job.trace is None or tracer is None or not steps:
        return None
    try:
        events = list(tracer.prof.profiler.kineto_results.events())
        name = spans.PREFIX + 'train.weight_drop'
        drops = {}
        for e in events:
            if e.name() == name:
                s = e.start_ns()
                drops.setdefault(e.start_thread_id(), []).append(
                    (s, s + e.duration_ns()))
        if not drops:
            return None
        starts = {t: sorted(r) for t, r in drops.items()}
        heads = {t: [s for s, _ in r] for t, r in starts.items()}
        ops = set()
        kernels = []
        for e in events:
            if 'CUDA' in str(e.device_type()):
                if not e.is_user_annotation():
                    kernels.append(e)
                continue
            t = e.start_thread_id()
            if t not in heads or not e.correlation_id():
                continue
            s = e.start_ns()
            i = bisect_right(heads[t], s) - 1
            if i >= 0 and s + e.duration_ns() <= starts[t][i][1]:
                ops.add(e.correlation_id())
        t0, t1 = job.trace.t0, job.trace.t1
        ns, linked = 0, 0
        for e in kernels:
            if e.linked_correlation_id() in ops:
                linked += 1
                s = e.start_ns()
                ns += max(0, min(s + e.duration_ns(), t1) - max(s, t0))
    except AttributeError:  # a profiler without these fields
        return None
    if not linked:
        return None
    return 1e-6 * ns / steps
