"""TF32 on the card: one switch for the process's f32 matmuls and
convolutions.

The JAX package sets no matmul precision, so its parity tests on the CPU
compare against full f32.  On an NVIDIA card a float32 matmul runs in
full f32 by default while a float32 cuDNN convolution runs in TF32 (about
three decimal digits).  Importing the port changes neither; its entry
points (``cli/demo.py``, ``cli/train.py``, ``chip_smoke.py``) call
:func:`set_tf32` themselves, with ``False`` so that the card's f32 results
stay comparable with the reference's.
"""
from __future__ import annotations

import torch


def set_tf32(enabled: bool) -> None:
    """Let f32 matmuls (cuBLAS) and convolutions (cuDNN) run in TF32 on
    the tensor cores, or keep them in full f32."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
