"""Operations of the Zero123 prior: one UNet evaluation and the CLIP
tower's embedding of one image, counted as :mod:`portbench.flops` counts
(``FlopCounterMode`` over the reference's modules on the meta device, two
operations per multiply-add).

A cross-attention over one context token is, for every query, that
token's value through ``to_out``: the reference's full softmax computes
the queries' projection, the scores, the product with V and ``to_out``
for every query, and none of it is the model's work.  The count takes
each single-token ``attn2``'s operations out and puts back its value
projection and one ``to_out``, which is what the program computes.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.flops import _key
from portbench.reference.zero123 import (
    CLIPConfig,
    UNetConfig,
    UNetModel,
    VisionTransformer,
)


@functools.lru_cache(maxsize=None)
def _unet(key: tuple, batch: int, hw: int) -> int:
    cfg = UNetConfig(**dict(key))
    with torch.device("meta"), torch.no_grad():
        unet = UNetModel(cfg)
        counter = FlopCounterMode(display=False)
        with counter:
            unet(torch.zeros(batch, cfg.in_channels, hw, hw),
                 torch.zeros(batch), torch.zeros(batch, 1, cfg.context_dim))
    by_module = counter.get_flop_counts()
    total = counter.get_total_flops()
    for name, m in unet.named_modules():
        if name.endswith("attn2"):
            counted = sum(by_module.get(f"UNetModel.{name}", {}).values())
            inner, dim = m.to_out[0].in_features, m.to_out[0].out_features
            needed = 2 * batch * (cfg.context_dim * inner + inner * dim)
            total += needed - counted
    return total


def unet_fwd(zero123: dict, batch: int = 1, hw: int = 32) -> int:
    """One Zero123 UNet forward at ``batch`` on ``hw`` x ``hw`` latents
    with one context token."""
    return _unet(_key(zero123), batch, hw)


@functools.lru_cache(maxsize=None)
def _clip(key: tuple, batch: int) -> int:
    cfg = CLIPConfig(**dict(key))
    with torch.device("meta"), torch.no_grad():
        tower = VisionTransformer(cfg)
        counter = FlopCounterMode(display=False)
        with counter:
            tower(torch.zeros(batch, 3, cfg.image_size, cfg.image_size))
    return counter.get_total_flops()


def clip_fwd(clip: dict, batch: int = 1) -> int:
    """The CLIP tower's embedding of ``batch`` images."""
    return _clip(_key(clip), batch)
