"""decode.launches_per_page: ``decode_lattice`` launches (the port's launch
counter ``ops.decode_kernel.decode_lattice.launches``) over the pages
written in the window."""


def read(job):
    if getattr(job, "launches", None) is None or not getattr(job, "pages", 0):
        return None
    return job.launches / job.pages
