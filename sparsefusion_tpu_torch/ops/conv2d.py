"""2-D convolution forward in plain PyTorch.

The plain version of the hand-written kernel K4
(``kernels/conv2d.py`` + ``csrc/conv2d_splitk.cu``), which the UNet's
``nn/layers.py::Conv2d`` calls: the CPU path, the path of every call the
kernel does not take (a gradient, bf16, groups), and the reference the
kernel is held against.  The JAX package's convolutions are XLA's
``lax.conv_general_dilated``; this is ``F.conv2d``, in f32 for the
kernel's f32 calls.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor = None, stride=1, padding=0,
                 dilation=1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` on NCHW ``x`` and (C_out, C_in / groups, kh, kw)
    ``weight``, with zero padding."""
    return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
