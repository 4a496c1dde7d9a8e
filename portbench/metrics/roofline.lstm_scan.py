"""roofline.lstm_scan: share of its roofline that ``lstm_scan`` (the forward scan: register, grid and one-block kernels)
reaches over the window: the least time the window's work needs on the
card (roofline.py, counted from the benchmark's own inputs) over the
kernels' device time in the trace."""


def read(job):
    bound = getattr(job, 'bound_s', {}).get('lstm_scan')
    if job.trace is None or not bound:
        return None
    t = job.trace.device_seconds(r'\blstm_scan_(reg_|grid_)?kernel\b')
    if t <= 0:
        return None
    return 100.0 * bound / t
