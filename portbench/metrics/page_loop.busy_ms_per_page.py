"""page_loop.busy_ms_per_page: host ms a page that the processor's page
loop works rather than waits: the ``keraslm.rate.workspace`` spans less
the ``keraslm.fetch`` (results from the card) and
``keraslm.rate.load_wait`` (a page's load) spans inside them, over the
pages written; the inside counterpart of ``page_loop.host_ms_per_page``."""
from portbench import spans


def read(job):
    pages = getattr(job, 'pages', 0)
    if job.trace is None or not pages or \
            not spans.ranges(job.trace, 'rate.workspace'):
        return None
    return 1e3 * spans.busy_seconds(
        job.trace, 'rate.workspace', ('fetch', 'rate.load_wait')) / pages
