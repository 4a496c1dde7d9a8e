"""gen.busy_ms_per_request: host ms a generation request works rather
than waits: the ``keraslm.gen.request`` spans less the ``keraslm.fetch``
spans inside them (the wait for the card's result), over the requests;
the inside counterpart of ``gen.host_ms_per_request``."""
from portbench import spans


def read(job):
    n = len(getattr(job, 'requests', ()))
    if job.trace is None or not n or \
            not spans.ranges(job.trace, 'gen.request'):
        return None
    return 1e3 * spans.busy_seconds(job.trace, 'gen.request',
                                    ('fetch',)) / n
