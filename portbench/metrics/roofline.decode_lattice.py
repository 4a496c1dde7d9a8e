"""roofline.decode_lattice: share of its roofline that ``decode_lattice`` (single-document decode: the cluster, sharded and one-block kernels)
reaches over the window: the least time the window's work needs on the
card (roofline.py, counted from the benchmark's own inputs) over the
kernels' device time in the trace."""


def read(job):
    bound = getattr(job, 'bound_s', {}).get('decode_lattice')
    if job.trace is None or not bound:
        return None
    t = job.trace.device_seconds(r'\bdecode_lattice_(cluster_|sharded_)?kernel\b')
    if t <= 0:
        return None
    return 100.0 * bound / t
