"""The Zero123 fusion iteration's share of the chip's f32 peak: the
traced iterations' model operations (the renders' field MLP forward and
backward, the VAE encode and decode, and the guided sampler's UNet
evaluations at ``portbench/flops_z123.py``'s count each) over the
window's seconds at 67 TFLOP/s, in percent."""
from portbench.readers import mfu_pct as read  # noqa: F401
