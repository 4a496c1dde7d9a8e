"""roofline.lstm_bwd: share of its roofline that ``lstm_bwd`` (the backward: the z recompute, the chain in every layout, the dU products)
reaches over the window: the least time the window's work needs on the
card (roofline.py, counted from the benchmark's own inputs) over the
kernels' device time in the trace."""


def read(job):
    bound = getattr(job, 'bound_s', {}).get('lstm_bwd')
    if job.trace is None or not bound:
        return None
    t = job.trace.device_seconds(r'\b(lstm_bwd\w*|lstm_du_\w+)\b')
    if t <= 0:
        return None
    return 100.0 * bound / t
