"""The fp8 control of a cell whose sampler's UNet runs in bf16: the
reference's UNet with each convolution and linear weight, and each of
their inputs, rounded through ``torch.float8_e4m3fn``, each tensor
scaled so that its largest magnitude maps to 448; everything else
computes in f32 (``control.py``'s scope ``fp8_unet``)."""
from __future__ import annotations

import torch
from torch import nn

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8_e4m3fn, scaled per tensor so that its
    largest magnitude maps to 448, back in ``t``'s dtype."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return ((t.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(t.dtype)


def _round_input(module, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


def fp8_unet(unet: nn.Module) -> nn.Module:
    """Round every convolution and linear weight of ``unet`` in place,
    and every input of those layers when they are called."""
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(fp8_round(m.weight))
                m.register_forward_pre_hook(_round_input)
    return unet
