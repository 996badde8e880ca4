"""The SparseFusion view-conditioned UNet (imagen-style), NCHW.

Frozen copy of the port's ``nn/unet.py`` (the JAX ``sparsefusion_tpu/nn/unet.py``'s counterpart) for the configuration
SparseFusion instantiates: dim 256, dim_mults (1, 2, 4, 4), two ResNet
blocks a level, attention at the last level and the middle, no text
path, pixel-shuffle upsamplers, a CrossEmbed stem on [cond, x].  The
256-channel EFT feature image is concatenated to the latent at the stem;
the only context tokens are the two learned time tokens.  The network is
called with the log-SNR as its time signal.

Module names are those of the reference's ``unets.0.*`` state dict, so a
VLDM checkpoint loads with ``load_state_dict``; :func:`load_jax_params`
fills the modules from the JAX package's parameter tree.  The network
computes in f32 or bf16 (``EfficientUNet(dtype=...)``), as the JAX module
with ``dtype=jnp.bfloat16``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    Attention,
    Conv2d,
    CrossEmbedLayer,
    Fn,
    LayerNormF32,
    LearnedSinusoidalPosEmb,
    Linear,
    ParallelConvs,
    PixelShuffleUpsample,
    ResnetBlock,
    TransformerBlock,
    downsample,
    set_compute_dtype,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Same fields and defaults as the JAX ``UNetConfig``."""

    dim: int = 256
    dim_mults: Tuple[int, ...] = (1, 2, 4, 4)
    num_resnet_blocks: Tuple[int, ...] = (2, 2, 2, 2)
    layer_attns: Tuple[bool, ...] = (False, False, False, True)
    layer_attns_depth: int = 1
    layer_cross_attns: Tuple[bool, ...] = (False, False, False, False)
    channels: int = 4
    channels_out: int = 4
    cond_images_channels: int = 256
    attn_heads: int = 8
    attn_dim_head: int = 64
    ff_mult: float = 2.0
    learned_sinu_pos_emb_dim: int = 16
    num_time_tokens: int = 2
    resnet_groups: int = 8
    init_cross_embed_kernel_sizes: Tuple[int, ...] = (3, 7, 15)
    attend_at_middle: bool = True
    scale_skip_connection: bool = True
    final_resnet_block: bool = True
    final_conv_kernel_size: int = 3

    @property
    def cond_dim(self) -> int:
        return self.dim

    @property
    def time_cond_dim(self) -> int:
        return self.dim * 4


def sparsefusion_unet_config() -> UNetConfig:
    """The paper's UNet hyperparameters (the reference's
    ``utils/load_model.py:60-69``): the defaults of :class:`UNetConfig`."""
    return UNetConfig()


class EfficientUNet(nn.Module):
    """Latent UNet: x (B, C, h, w), log_snr (B,), cond (B, Cc, h', w').

    ``dtype`` is the compute dtype (the JAX module's ``dtype``): the
    input, the time MLPs, every conv and matmul and the activations
    between them run in it; ``norm_cond``, the GroupNorms and the
    attention's context norm run in f32; the output is f32.  The
    parameters are whatever the module holds (f32 masters, or a cast
    copy: ``models.py``)."""

    def __init__(self, config: UNetConfig = UNetConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        tcd, cd = cfg.time_cond_dim, cfg.cond_dim
        self.init_conv = CrossEmbedLayer(
            cfg.channels + cfg.cond_images_channels, cfg.dim,
            cfg.init_cross_embed_kernel_sizes, stride=1)
        self.to_time_hiddens = nn.Sequential(
            LearnedSinusoidalPosEmb(cfg.learned_sinu_pos_emb_dim),
            Linear(cfg.learned_sinu_pos_emb_dim + 1, tcd), nn.SiLU())
        self.to_time_tokens = nn.Sequential(
            Linear(tcd, cd * cfg.num_time_tokens))
        self.to_time_cond = nn.Sequential(Linear(tcd, tcd))
        self.norm_cond = LayerNormF32(cd)

        dims = [cfg.dim] + [cfg.dim * m for m in cfg.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n_levels = len(in_out)
        res = dict(time_cond_dim=tcd, groups=cfg.resnet_groups)
        attn = dict(depth=cfg.layer_attns_depth, heads=cfg.attn_heads,
                    dim_head=cfg.attn_dim_head, ff_mult=cfg.ff_mult,
                    context_dim=cd)

        self.downs = nn.ModuleList()
        for i, (dim_in, dim_out) in enumerate(in_out):
            is_last = i == n_levels - 1
            self.downs.append(nn.ModuleList([
                None,  # the reference's pre-downsample slot, unused
                ResnetBlock(dim_in, dim_in, cond_dim=(
                    cd if cfg.layer_cross_attns[i] else None), **res),
                nn.ModuleList([ResnetBlock(dim_in, dim_in, use_gca=True,
                                           **res)
                               for _ in range(cfg.num_resnet_blocks[i])]),
                (TransformerBlock(dim_in, **attn) if cfg.layer_attns[i]
                 else nn.Identity()),
                (ParallelConvs(dim_in, dim_out) if is_last
                 else downsample(dim_in, dim_out)),
            ]))

        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, cond_dim=cd, **res)
        self.mid_attn = (Fn(Fn(Attention(mid, cfg.attn_dim_head,
                                         cfg.attn_heads)))
                         if cfg.attend_at_middle else None)
        self.mid_block2 = ResnetBlock(mid, mid, cond_dim=cd, **res)

        self.ups = nn.ModuleList()
        rev_nrb = list(reversed(cfg.num_resnet_blocks))
        rev_attns = list(reversed(cfg.layer_attns))
        rev_cross = list(reversed(cfg.layer_cross_attns))
        for i, (dim_in, dim_out) in enumerate(reversed(in_out)):
            is_last = i == n_levels - 1
            # every skip of a level has that level's input width
            self.ups.append(nn.ModuleList([
                ResnetBlock(dim_out + dim_in, dim_out, cond_dim=(
                    cd if rev_cross[i] else None), **res),
                nn.ModuleList([ResnetBlock(dim_out + dim_in, dim_out,
                                           use_gca=True, **res)
                               for _ in range(rev_nrb[i])]),
                (TransformerBlock(dim_out, **attn) if rev_attns[i]
                 else nn.Identity()),
                (nn.Identity() if is_last
                 else PixelShuffleUpsample(dim_out, dim_in)),
            ]))

        self.final_res_block = (
            ResnetBlock(cfg.dim, cfg.dim, use_gca=True, **res)
            if cfg.final_resnet_block else None)
        k = cfg.final_conv_kernel_size
        self.final_conv = Conv2d(cfg.dim, cfg.channels_out, k,
                                 padding=k // 2)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor, log_snr: torch.Tensor,
                cond_images: Optional[torch.Tensor] = None,
                cond_keep_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.config
        b = x.shape[0]
        dt = self.dtype
        x = x.to(dt)
        if cfg.cond_images_channels > 0:
            if cond_images is None or \
                    cond_images.shape[1] != cfg.cond_images_channels:
                raise ValueError(f"cond_images must have "
                                 f"{cfg.cond_images_channels} channels")
            if cond_images.shape[-2:] != x.shape[-2:]:
                cond_images = F.interpolate(cond_images, size=x.shape[-2:],
                                            mode="nearest")
            cond_images = cond_images.to(dt)
            if cond_keep_mask is not None:
                cond_images = cond_images * cond_keep_mask.to(
                    dt)[:, None, None, None]
            x = torch.cat([cond_images, x], dim=1)
        x = self.init_conv(x)

        time_hiddens = self.to_time_hiddens(log_snr.float())
        time_tokens = self.to_time_tokens(time_hiddens).reshape(
            b, cfg.num_time_tokens, cfg.cond_dim)
        t = self.to_time_cond(time_hiddens)
        c = self.norm_cond(time_tokens).to(dt)

        hiddens: List[torch.Tensor] = []
        for _, init_block, res_blocks, attn, ds in self.downs:
            x = init_block(x, t, c)
            for block in res_blocks:
                x = block(x, t)
                hiddens.append(x)
            if isinstance(attn, TransformerBlock):
                x = attn(x, c)
            hiddens.append(x)
            x = ds(x)

        x = self.mid_block1(x, t, c)
        if self.mid_attn is not None:
            bb, cc, hh, ww = x.shape
            tokens = x.flatten(2).transpose(1, 2)
            tokens = self.mid_attn.fn.fn(tokens) + tokens
            x = tokens.transpose(1, 2).reshape(bb, cc, hh, ww)
        x = self.mid_block2(x, t, c)

        skip_scale = 2 ** -0.5 if cfg.scale_skip_connection else 1.0
        for init_block, res_blocks, attn, us in self.ups:
            x = torch.cat([x, hiddens.pop() * skip_scale], dim=1)
            x = init_block(x, t, c)
            for block in res_blocks:
                x = torch.cat([x, hiddens.pop() * skip_scale], dim=1)
                x = block(x, t)
            if isinstance(attn, TransformerBlock):
                x = attn(x, c)
            x = us(x)

        if self.final_res_block is not None:
            x = self.final_res_block(x, t)
        return self.final_conv(x).float()


# ---- the JAX package's parameter tree ------------------------------------

def _attention_pairs(t: str, j: str, context: bool):
    pairs = [(t, j), (f"{t}.norm", f"{j}/norm"), (f"{t}.to_q", f"{j}/to_q"),
             (f"{t}.to_kv", f"{j}/to_kv"), (f"{t}.to_out.0", f"{j}/to_out"),
             (f"{t}.to_out.1", f"{j}/out_norm")]
    if context:
        pairs += [(f"{t}.to_context.0", f"{j}/context_norm"),
                  (f"{t}.to_context.1", f"{j}/to_context")]
    return pairs


def _resblock_pairs(t: str, j: str):
    pairs = [(f"{t}.time_mlp.1", f"{j}/time_mlp"),
             (f"{t}.gca.to_k", f"{j}/gca/to_k"),
             (f"{t}.gca.net.0", f"{j}/gca/net_in"),
             (f"{t}.gca.net.2", f"{j}/gca/net_out"),
             (f"{t}.res_conv", f"{j}/res_conv")]
    for blk in ("block1", "block2"):
        pairs += [(f"{t}.{blk}.groupnorm", f"{j}/{blk}/groupnorm"),
                  (f"{t}.{blk}.project", f"{j}/{blk}/project")]
    return pairs + _attention_pairs(f"{t}.cross_attn.fn", f"{j}/cross_attn",
                                    context=False)


def _transformer_pairs(t: str, j: str, depth: int):
    pairs = []
    for i in range(depth):
        ff, jff = f"{t}.layers.{i}.1", f"{j}/ff_{i}"
        pairs += _attention_pairs(f"{t}.layers.{i}.0.fn", f"{j}/attn_{i}",
                                  context=True)
        pairs += [(f"{ff}.0", f"{jff}/norm_in"), (f"{ff}.1", f"{jff}/in"),
                  (f"{ff}.3", f"{jff}/norm_mid"), (f"{ff}.4", f"{jff}/out")]
    return pairs
