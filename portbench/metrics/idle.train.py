"""idle.train: the share of the traced window in which no kernel, copy or
set ran on the card."""


def read(job):
    if job.trace is None or job.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - job.trace.busy_s / job.trace.window_s)
