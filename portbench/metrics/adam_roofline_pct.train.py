"""The train step's Adam against its roofline, in percent: the least
seconds of the traced steps' updates (``portbench/adam.py``: 7 x 4 bytes
a trained parameter at the chip's bandwidth) over the device seconds of
the program's ``adam`` spans."""
from portbench import adam, spans
from portbench.flops import PEAK_BYTES


def read(ctx):
    got = spans.window_device_ms(ctx, {"adam"})
    if got is None or got[0] <= 0:
        return None
    least_s = got[1] * adam.step_bytes(ctx["config"]) / PEAK_BYTES
    return 100.0 * least_s / (got[0] * 1e-3)
