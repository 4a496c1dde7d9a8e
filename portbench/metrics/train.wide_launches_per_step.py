"""train.wide_launches_per_step: launches of the LSTM kernels in the wide
layout (the port's counters ``ops.lstm_cell.lstm_scan.wide`` and
``lstm_bwd.wide``, read around each training step of the window) over
the window's training steps."""


def read(job):
    steps = getattr(job, 'train_steps', 0)
    if getattr(job, 'wide_launches', None) is None or not steps:
        return None
    return job.wide_launches / steps
