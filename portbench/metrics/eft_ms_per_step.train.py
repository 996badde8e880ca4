"""Device ms of a train step's EFT: its forward (``eft``) and its
backward (``eft_bwd``, split off the step's backward where the UNet
hands the EFT's features their gradient)."""
from portbench import spans


def read(ctx):
    return spans.per_unit_device_ms(ctx, {"eft", "eft_bwd"})
