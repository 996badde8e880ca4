"""Device ms of an iteration's renders: the forward renders (``render``)
and the field loss's backward (``render_bwd``: the MLP's and K1's
backward and, under remat, the renders' recomputed forward)."""
from portbench import spans


def read(ctx):
    return spans.per_unit_device_ms(ctx, {"render", "render_bwd"})
