"""Seconds of Phase A, the EFT feature cache (the program's set-up span
``phase_a``)."""
from portbench import spans


def read(ctx):
    return spans.setup_seconds(ctx, lambda name: name == "phase_a")
