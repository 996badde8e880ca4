"""K1's share of its roofline: the least seconds of the grid encodes the
traced iterations need, forward and backward (bytes at the chip's
bandwidth, ``portbench/flops.py::k1_launch_bytes``), over the device
seconds of K1's kernels in the window, in percent."""
from portbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k1_s", "grid_encode_fwd_kernel",
                        "grid_encode_bwd_kernel")
