"""train.host_ms_per_step: host ms that issuing one training step takes
(the ``keraslm.train.step`` spans: the host's launches of the forward,
backward and update, and its waits where the card's queue is full),
over the training steps."""
from portbench import spans


def read(job):
    steps = getattr(job, 'train_steps', 0)
    if job.trace is None or not steps:
        return None
    issued = spans.ranges(job.trace, 'train.step')
    if not issued:
        return None
    return 1e3 * spans.seconds(issued) / steps
