"""gen.prompt_ms_per_request: host ms a generation request spends on its
prompt's steps in plain PyTorch (the ``keraslm.gen.prompt`` spans), over
the requests."""
from portbench import spans


def read(job):
    n = len(getattr(job, 'requests', ()))
    if job.trace is None or not n:
        return None
    prompts = spans.ranges(job.trace, 'gen.prompt')
    if not prompts:
        return None
    return 1e3 * spans.seconds(prompts) / n
