"""roofline.gen_beam: share of its roofline that ``gen_beam`` (the generation beam search)
reaches over the window: the least time the window's work needs on the
card (roofline.py, counted from the benchmark's own inputs) over the
kernels' device time in the trace."""


def read(job):
    bound = getattr(job, 'bound_s', {}).get('gen_beam')
    if job.trace is None or not bound:
        return None
    t = job.trace.device_seconds(r'\bgen_beam_(units_)?kernel\b')
    if t <= 0:
        return None
    return 100.0 * bound / t
