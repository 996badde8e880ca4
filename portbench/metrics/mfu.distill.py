"""The whole distillation iteration's share of the chip's peak: model
operations of the traced iterations (``portbench/flops.py``: the renders'
field MLP forward and backward, and in a fusion iteration the VAE encode
and decode and the sampler's UNet evaluations) over the window, in
percent."""
from portbench.readers import mfu_pct as read  # noqa: F401
