"""Zero-1-to-3 (Liu et al., ICCV 2023, arXiv:2303.11328) as a fusion
prior: the SD-v1 spatial-transformer UNet of ldm's ``openaimodel``, the
CLIP ViT-L/14 image tower and ``cc_projection``, and the relative pose of
zero123's ``get_T``.

No counterpart in the JAX package.  Parameter names follow the published
checkpoints (``zero123/configs/sd-objaverse-finetune-c_concat-256.yaml``:
``model.diffusion_model.*`` without its prefix, ``cc_projection.*``; the
CLIP tower is OpenAI's ``visual.*``), so that those state dicts load with
``load_state_dict``.  Everything is NCHW and f32; the convolutions are
``nn/layers.py::Conv2d``, which runs kernel K4 on a card without a
gradient, the spatial transformers' linears are :class:`Linear`, which
runs kernel K5 there, and everything else is plain PyTorch.

* :class:`Zero123UNet`: ResBlocks (GroupNorm 32, SiLU, the time embedding
  added), SpatialTransformers (GroupNorm, 1x1 ``proj_in``, LayerNorm, then
  self-attention, cross-attention and a GEGLU feed-forward, 1x1
  ``proj_out``), nearest-neighbour upsampling and ldm's sinusoidal
  timestep embedding in its [cos, sin] order.  Each transformer is the
  span recorder's span ``st`` and adds its tokens to the open span's
  counter ``st_tokens`` (the ``unet`` span of ``models.py``); each
  self-attention's scores, softmax and product with V are the span
  ``attn1``.  A cross-attention over one context token is
  ``to_out(to_v(context))`` for every query, because a softmax over one
  key is exactly 1, and is computed so.
* :class:`CLIPImageEncoder`: the ViT (patch 14, class token, pre- and
  post-LayerNorm, QuickGELU) and its projection; :func:`clip_preprocess`
  is ``FrozenCLIPImageEmbedder.preprocess`` (bicubic resize to 224 with
  aligned corners and no antialias, CLIP's mean and std).
* :func:`relative_pose`: zero123's ``get_T`` on camera centres given in
  a Y-up frame about the scene centre (zero123's frame is Z-up:
  (x, y, z) here is (x, -z, y) there).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sparsefusion_tpu_torch.kernels import linear as k5
from sparsefusion_tpu_torch.nn.layers import Conv2d
from sparsefusion_tpu_torch.utils import spans

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class Zero123Config:
    """ldm ``UNetModel``'s arguments (``legacy`` False, no scale-shift
    norm, heads of ``channels // num_heads``) and the conditioning's
    widths: the pose's 4 numbers join the CLIP embedding in
    ``cc_projection``."""

    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    clip_embed_dim: int = 768
    pose_dim: int = 4


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """The ViT image tower of CLIP (ViT-L/14 by default)."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    output_dim: int = 768


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """ldm's sinusoidal embedding of (B,) timesteps: [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _group_norm(channels: int, eps: float = 1e-5) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=eps)


# the nn.Dropout(0.0) placeholders keep the checkpoints' module indices
# (``out_layers.3``, ``to_out.0``, ``ff.net.2``)


class ResBlock(nn.Module):
    def __init__(self, channels: int, emb_channels: int, out_channels: int):
        super().__init__()
        self.in_layers = nn.Sequential(_group_norm(channels), nn.SiLU(),
                                       Conv2d(channels, out_channels, 3,
                                              padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(_group_norm(out_channels), nn.SiLU(),
                                        nn.Dropout(0.0),
                                        Conv2d(out_channels, out_channels, 3,
                                               padding=1))
        self.skip_connection = nn.Identity() if out_channels == channels \
            else Conv2d(channels, out_channels, 1)

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class Linear(nn.Linear):
    """``nn.Linear``, its parameters and their names, whose forward is
    ``kernels/linear.py::linear``: kernel K5 on a card without a gradient
    (at 8 rows of the input or more), ``F.linear`` elsewhere."""

    def forward(self, x):
        return k5.linear(x, self.weight, self.bias)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.reshape(b, n, heads, -1).transpose(1, 2)


class CrossAttention(nn.Module):
    """ldm's ``CrossAttention``: self-attention without ``context``, and
    over ``context``'s tokens with it."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.scale = heads, dim_head ** -0.5
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim),
                                    nn.Dropout(0.0))

    def forward(self, x, context=None):
        if context is not None and context.shape[1] == 1:
            # a softmax over one key is 1: every query gets that key's value
            return self.to_out(self.to_v(context)).expand_as(x)
        ctx = x if context is None else context
        q = _heads(self.to_q(x), self.heads)
        k = _heads(self.to_k(ctx), self.heads)
        v = _heads(self.to_v(ctx), self.heads)
        with spans.span("attn1" if context is None else "attn2"):
            sim = torch.matmul(q, k.transpose(-1, -2)) * self.scale
            out = torch.matmul(sim.softmax(dim=-1), v)
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim)
                                              for _ in range(3))

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = _group_norm(channels, eps=1e-6)
        self.proj_in = Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim)
            for _ in range(depth))
        self.proj_out = Conv2d(inner, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        spans.count("st_tokens", b * h * w)
        with spans.span("st"):
            t = self.proj_in(self.norm(x))
            t = t.flatten(2).transpose(1, 2)
            for block in self.transformer_blocks:
                t = block(t, context)
            t = t.transpose(1, 2).reshape(b, -1, h, w)
            return self.proj_out(t) + x


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Sequential(nn.ModuleList):
    """ldm's ``TimestepEmbedSequential``: the time embedding to the
    ResBlocks, the context to the transformers."""

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class Zero123UNet(nn.Module):
    """ldm's ``openaimodel.UNetModel`` with spatial transformers:
    (x (B, in_channels, h, w), timesteps (B,), context (B, L,
    context_dim)) -> (B, out_channels, h, w)."""

    def __init__(self, config: Zero123Config = Zero123Config()):
        super().__init__()
        self.config = cfg = config
        ch = mc = cfg.model_channels
        emb = mc * 4
        self.time_embed = nn.Sequential(nn.Linear(mc, emb), nn.SiLU(),
                                        nn.Linear(emb, emb))

        def transformer(c):
            return SpatialTransformer(c, cfg.num_heads, c // cfg.num_heads,
                                      cfg.transformer_depth, cfg.context_dim)

        self.input_blocks = nn.ModuleList([_Sequential(
            [Conv2d(cfg.in_channels, mc, 3, padding=1)])])
        chans, ds = [mc], 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, emb, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch))
                self.input_blocks.append(_Sequential(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(_Sequential([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = _Sequential([ResBlock(ch, emb, ch),
                                         transformer(ch),
                                         ResBlock(ch, emb, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), emb, mc * mult)]
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(_Sequential(layers))
        self.out = nn.Sequential(_group_norm(ch), nn.SiLU(),
                                 Conv2d(mc, cfg.out_channels, 3, padding=1))

    def forward(self, x, timesteps, context):
        emb = self.time_embed(timestep_embedding(
            timesteps, self.config.model_channels))
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h)


class _ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width)
        self.attn = _MultiheadAttention(width)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, width * 4))
        self.mlp.add_module("gelu", _QuickGELU())
        self.mlp.add_module("c_proj", nn.Linear(width * 4, width))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x), self.heads)
        return x + self.mlp(self.ln_2(x))


class _QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class _MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (batch first, no mask)."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, heads: int):
        q, k, v = (_heads(t, heads) for t in F.linear(
            x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        sim = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        out = torch.matmul(sim.softmax(dim=-1), v)
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, -1))


class CLIPImageEncoder(nn.Module):
    """CLIP's ``VisionTransformer``: preprocessed images (B, 3, 224, 224)
    -> projected embeddings (B, output_dim)."""

    def __init__(self, config: CLIPConfig = CLIPConfig()):
        super().__init__()
        self.config = cfg = config
        w = cfg.width
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.conv1 = Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size,
                            bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(n, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.Sequential(*(
            _ResidualAttentionBlock(w, cfg.heads) for _ in range(cfg.layers)))
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.output_dim))

    def forward(self, x):
        x = self.conv1(x).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer.resblocks(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj


def clip_preprocess(images_01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[0, 1] RGB (B, H, W, 3) -> CLIP's input (B, 3, size, size): zero123
    resizes its [-1, 1] input bicubically with aligned corners, maps it
    back to [0, 1] and normalises by CLIP's mean and std."""
    x = images_01.permute(0, 3, 1, 2) * 2.0 - 1.0
    x = F.interpolate(x, size=(size, size), mode="bicubic",
                      align_corners=True)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def spherical(centres: torch.Tensor) -> tuple:
    """(polar angle from up, azimuth, radius) of (N, 3) points in a Y-up
    frame: zero123's ``cartesian_to_spherical`` of the Z-up (x, -z, y)."""
    x, y, z = centres.unbind(-1)
    xz = x * x + z * z
    return (torch.atan2(torch.sqrt(xz), y), torch.atan2(-z, x),
            torch.sqrt(xz + y * y))


def relative_pose(target: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """zero123's ``get_T``: the pose (N, 4) [d polar, sin d azimuth, cos d
    azimuth, d radius] of the (N, 3) target camera centres from the (N, 3)
    conditioning ones, both about the scene centre (the origin)."""
    t_pol, t_az, t_r = spherical(target)
    c_pol, c_az, c_r = spherical(cond)
    d_az = torch.remainder(t_az - c_az, 2 * math.pi)
    return torch.stack([t_pol - c_pol, torch.sin(d_az), torch.cos(d_az),
                        t_r - c_r], dim=-1)


def nearest_views(targets: torch.Tensor, views: torch.Tensor) -> torch.Tensor:
    """For each of the (N, 3) target centres, the index of the (V, 3) view
    centre at the least angle about the origin."""
    cos = F.normalize(targets, dim=-1) @ F.normalize(views, dim=-1).T
    return cos.argmax(dim=-1)
