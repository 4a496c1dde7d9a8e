"""mfu.train: the window's model FLOPs (counted from the benchmark's inputs:
every row's stack step and logits that the work needs) over its wall time,
as a share of the card's f32 peak (67 TFLOP/s; all of this path is f32)."""
from portbench.roofline import PEAK_F32_FLOPS


def read(job):
    flops = getattr(job, 'model_flops', None)
    if not flops:
        return None
    return 100.0 * flops / job.window_s / PEAK_F32_FLOPS
