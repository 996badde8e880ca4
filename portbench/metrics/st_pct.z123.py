"""The spatial transformers' share of the Zero123 UNet's device time:
the device ms of the program's ``st`` spans over those of its ``unet``
spans, over the traced iterations, in percent."""
from portbench import spans


def read(ctx):
    st = spans.window_device_ms(ctx, {"st"})
    unet = spans.window_device_ms(ctx, {"unet"})
    if st is None or unet is None or unet[0] <= 0:
        return None
    return 100.0 * st[0] / unet[0]
