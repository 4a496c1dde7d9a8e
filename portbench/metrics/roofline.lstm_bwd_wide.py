"""roofline.lstm_bwd_wide: share of its roofline that ``lstm_bwd`` in the
wide layout (the layers of widths over 512: the z recompute, the chain,
the dU products and the weight pack, all named ``lstm_bwd_wide*``)
reaches over the window: the least time those layers' backward needs on
the card (roofline.py, counted from the benchmark's own shapes) over the
kernels' device time in the trace."""


def read(job):
    bound = getattr(job, 'bound_s', {}).get('lstm_bwd_wide')
    if job.trace is None or not bound:
        return None
    t = job.trace.device_seconds(r'\blstm_bwd_wide\w*')
    if t <= 0:
        return None
    return 100.0 * bound / t
