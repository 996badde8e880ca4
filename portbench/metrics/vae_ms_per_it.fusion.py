"""Device ms of a fusion iteration's VAE encode and decode (the
program's ``vae_encode`` and ``vae_decode`` spans), an iteration."""
from portbench import spans


def read(ctx):
    return spans.per_unit_device_ms(ctx, {"vae_encode", "vae_decode"})
