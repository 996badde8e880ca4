"""Device ms of one batch-1 UNet evaluation of the sampler: the device
time of the program's ``unet`` spans over the traced iterations, over
the evaluations the benchmark counts there (``portbench/spans.py``)."""
from portbench import spans


def read(ctx):
    got = spans.window_device_ms(ctx, {"unet"})
    evals = spans.unet_evals(ctx)
    if got is None or not evals:
        return None
    return got[0] / evals
