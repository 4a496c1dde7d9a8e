"""train.other_kernels_ms: device ms a training step in kernels that are
not the port's own (PyTorch's products, elementwise and optimizer
kernels; copies and sets left out), by the trace's kernel names."""
from portbench.trace import COPIES, PORT_KERNELS


def read(job):
    steps = getattr(job, "train_steps", 0)
    if job.trace is None or not steps:
        return None
    total = job.trace.device_seconds(".") - job.trace.device_seconds(COPIES)
    own = job.trace.device_seconds(PORT_KERNELS)
    return 1e3 * (total - own) / steps
