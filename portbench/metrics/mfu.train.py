"""The whole train step's share of the chip's peak: model operations of
the traced steps (the UNet forward and backward at the diffusion batch,
the EFT at the step's context size, the VAE encode) over the window, in
percent."""
from portbench.readers import mfu_pct as read  # noqa: F401
