"""Seconds the program spends capturing its CUDA graphs in set-up (the
set-up spans ``capture/<key>``, summed)."""
from portbench import spans


def read(ctx):
    return spans.setup_seconds(ctx,
                               lambda name: name.startswith("capture/"))
