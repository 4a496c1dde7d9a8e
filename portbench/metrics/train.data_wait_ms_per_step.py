"""train.data_wait_ms_per_step: host ms a training step that the trainer
waits for its next batch from the data thread (the ``keraslm.data.wait``
spans, the validation pass's included), over the training steps."""
from portbench import spans


def read(job):
    steps = getattr(job, 'train_steps', 0)
    if job.trace is None or not steps:
        return None
    waits = spans.ranges(job.trace, 'data.wait')
    if not waits:
        return None
    return 1e3 * spans.seconds(waits) / steps
