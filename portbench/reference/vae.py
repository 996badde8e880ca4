"""Stable-Diffusion KL autoencoder (the frozen first stage), NCHW.

Frozen copy of the port's ``nn/vae.py`` (the JAX ``sparsefusion_tpu/nn/vae.py``'s counterpart): 256 x 256 RGB in [-1, 1]
to 32 x 32 x 4 latents and back (ch 128, ch_mult (1, 2, 4, 4), two
ResNet blocks a level, attention only in the middle).  Module names are
those of the ldm ``AutoencoderKL`` state dict (after the reference's
``first_stage_model.`` / ``model.`` renames), so an SD checkpoint loads
with ``load_state_dict``.  The single-head mid attention over h*w tokens
is a plain matmul, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn



@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Same fields and defaults as the JAX ``VAEConfig``."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).flatten(2)
        k = self.k(hn).flatten(2)
        v = self.v(hn).flatten(2)
        attn = torch.bmm(q.transpose(1, 2), k) * (c ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.bmm(v, attn.transpose(1, 2)).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Pad (0, 1, 0, 1), then a 3x3 stride-2 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Level(nn.Module):
    """One resolution level (the ldm layout's ``down.i`` / ``up.i``)."""

    def __init__(self, blocks, resample=None, name=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, name, resample)


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = cfg.ch
        n = len(cfg.ch_mult)
        for i, mult in enumerate(cfg.ch_mult):
            cout = cfg.ch * mult
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(cin, cout))
                cin = cout
            self.down.append(_Level(
                blocks, Downsample(cout) if i != n - 1 else None,
                "downsample"))
        self.mid = _Mid(cin)
        self.norm_out = _norm(cin)
        z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(cin, z_out, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        cin = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, cin, 3, padding=1)
        self.mid = _Mid(cin)
        levels = []
        for i in reversed(range(len(cfg.ch_mult))):
            cout = cfg.ch * cfg.ch_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(cin, cout))
                cin = cout
            levels.insert(0, _Level(blocks, Upsample(cout) if i != 0
                                    else None, "upsample"))
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(cin)
        self.conv_out = nn.Conv2d(cin, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """``encode`` -> (mean, logvar); ``encode_mode``; ``decode``."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.z_channels,
                                    2 * config.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(config.embed_dim,
                                         config.z_channels, 1)

    def encode(self, x):
        """(B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, 4, H/8, W/8)."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode_mode(self, x):
        """The deterministic latent the pipeline uses (the mean)."""
        return self.encode(x)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
