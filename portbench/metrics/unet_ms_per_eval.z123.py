"""Device ms of one batch-1 Zero123 UNet evaluation of the sampler: the
device time of the program's ``unet`` spans over the traced iterations,
over the evaluations the benchmark counts there (each trace unit's
``unet_evals``, ``drivers/distill_z123.py::iteration_work``)."""
from portbench import spans


def read(ctx):
    got = spans.window_device_ms(ctx, {"unet"})
    tr = ctx.get("trace")
    evals = sum(u.get("unet_evals", 0) for u in tr.units) if tr else 0
    if got is None or not evals:
        return None
    return got[0] / evals
