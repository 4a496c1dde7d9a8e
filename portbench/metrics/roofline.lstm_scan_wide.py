"""roofline.lstm_scan_wide: share of its roofline that ``lstm_scan`` in
the wide layout (the layers of widths over 512: ``lstm_scan_wide_kernel``
and its weight pack) reaches over the window: the least time those
layers' forward scans need on the card (roofline.py, counted from the
benchmark's own shapes) over the kernels' device time in the trace."""


def read(job):
    bound = getattr(job, 'bound_s', {}).get('lstm_scan_wide')
    if job.trace is None or not bound:
        return None
    t = job.trace.device_seconds(r'\blstm_scan_wide\w*')
    if t <= 0:
        return None
    return 100.0 * bound / t
