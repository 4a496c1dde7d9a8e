"""page_loop.wait_ms_per_page: host ms a page that the page loop waits
for the card's results (the ``keraslm.fetch`` spans), over the pages
written."""
from portbench import spans


def read(job):
    pages = getattr(job, 'pages', 0)
    if job.trace is None or not pages:
        return None
    fetches = spans.ranges(job.trace, 'fetch')
    if not fetches:
        return None
    return 1e3 * spans.seconds(fetches) / pages
