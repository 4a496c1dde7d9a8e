"""gen.host_ms_per_request: ms a generation request spends outside the
device time of ``gen_beam`` and ``gen_traceback`` (the prompt's steps
in plain PyTorch, launches, the fetch and the strings), from the trace."""


def read(job):
    n = len(getattr(job, "requests", ()))
    if job.trace is None or not n:
        return None
    dev = job.trace.device_seconds(r"\bgen_(beam|traceback)\w*")
    if dev <= 0:
        return None
    return 1e3 * (job.window_s - dev) / n
