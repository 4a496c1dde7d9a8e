"""page_loop.host_ms_per_page: host ms a page of the processor's page loop
(METS and PAGE I/O, lattice prep, launches, write-back): the window's wall
time outside the rater's ``rate_best_device_finish*`` calls, which wait
for the device's results and walk them, over the pages written."""


def read(job):
    wait = getattr(job, "finish_wait_s", None)
    if wait is None or not getattr(job, "pages", 0):
        return None
    return 1e3 * (job.window_s - wait) / job.pages
