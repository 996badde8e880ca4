"""The reference's Zero-1-to-3 (Liu et al., ICCV 2023, arXiv:2303.11328)
fusion prior: ldm's spatial-transformer UNet, OpenAI CLIP's ViT image
tower, ``cc_projection``, zero123's conditioning and relative pose, ldm's
schedule, and the distillation steps of
:mod:`portbench.reference.sparsefusion` with this prior in the fusion
step.

Plain PyTorch in f32 (TF32 off), written after the published code and not
after the port: ``ldm/modules/diffusionmodules/openaimodel.py``
(``UNetModel``, ``ResBlock``, ``Downsample``, ``Upsample``,
``timestep_embedding``), ``ldm/modules/attention.py``
(``SpatialTransformer``, ``BasicTransformerBlock``, ``CrossAttention``,
``GEGLU``), CLIP's ``model.py`` (``VisionTransformer``,
``ResidualAttentionBlock``, ``QuickGELU``), zero123's ``ddpm.py``
(``cc_projection``, the hybrid conditioning: the view's latent mode
concatenated unscaled, the token as the cross-attention context),
``modules.py::FrozenCLIPImageEmbedder.preprocess``, its demo's
unconditional branch (a zero token and a zero latent) and its data's
``get_T`` and ``cartesian_to_spherical``.  The parameter names are the
checkpoints', which the program shares, so :mod:`portbench.weights`
draws both the same weights.

Departures from the published code, each also in the configuration's
``assumed``:

* the sampler is the port's PLMS-50 from a partial noise level at
  continuous times, so the schedule's ``alphas_cumprod`` is read at the
  continuous index t * 999, interpolated linearly, and the UNet's
  timestep is that index (ldm's DDIM runs at integer steps);
* x0 is clipped to +-10 in the sampler, as the port's fusion step clips
  it (ldm's samplers do not clip latents);
* guidance runs the conditional and the unconditional branch as two
  batch-1 evaluations (ldm batches them);
* the relative pose takes the scene's world frame as Y up about the
  origin: zero123's Z-up (x, y, z) is (x, -z, y) here; each cached camera
  is conditioned on the input view nearest it by the angle of their
  centres about the origin;
* the CLIP resize is ``F.interpolate`` bicubic with aligned corners,
  which kornia's ``resize`` calls without antialias.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.cameras import (
    camera_centers,
    concat_cameras,
    get_camera_slice,
    get_relative_cameras,
)
from portbench.reference.ddpm import DDPM, DDPMConfig
from portbench.reference.eft import EFTConfig, EpipolarFeatureTransformer
from portbench.reference.imageutil import normalize
from portbench.reference.ngp import NGPConfig, NGPField
from portbench.reference.paths import get_interpolated_path
from portbench.reference.plms import plms_sample
from portbench.reference.schedule import GaussianDiffusion
from portbench.reference.sparsefusion import (
    DistillSteps,
    Models,
    adam_moments,
    feature_cache_entries,
    n_cached_cameras,
    tf32_within,
)
from portbench.reference.vae import AutoencoderKL, VAEConfig

LINEAR_START, LINEAR_END = 0.00085, 0.012
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


# ---- ldm's UNet ----------------------------------------------------------

def timestep_embedding(timesteps, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(0, half, dtype=torch.float32)
                      / half).to(device=timesteps.device)
    args = timesteps[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm32(nn.GroupNorm):
    def forward(self, x):
        return super().forward(x.float()).type(x.dtype)


def normalization(channels):
    return GroupNorm32(32, channels)


class TimestepEmbedSequential(nn.Sequential):
    def forward(self, x, emb, context=None):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class Upsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class ResBlock(nn.Module):
    def __init__(self, channels, emb_channels, out_channels):
        super().__init__()
        self.in_layers = nn.Sequential(
            normalization(channels), nn.SiLU(),
            nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            normalization(out_channels), nn.SiLU(), nn.Dropout(p=0.0),
            nn.Conv2d(out_channels, out_channels, 3, padding=1))
        if out_channels == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = nn.Conv2d(channels, out_channels, 1)

    def forward(self, x, emb):
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb).type(h.dtype)
        while len(emb_out.shape) < len(h.shape):
            emb_out = emb_out[..., None]
        h = self.out_layers(h + emb_out)
        return self.skip_connection(x) + h


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0),
                                 nn.Linear(inner, dim))

    def forward(self, x):
        return self.net(x)


class CrossAttention(nn.Module):
    """The full softmax over the context's keys, one key included."""

    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64):
        super().__init__()
        inner_dim = dim_head * heads
        context_dim = context_dim if context_dim is not None else query_dim
        self.scale = dim_head ** -0.5
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner_dim, bias=False)
        self.to_k = nn.Linear(context_dim, inner_dim, bias=False)
        self.to_v = nn.Linear(context_dim, inner_dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner_dim, query_dim),
                                    nn.Dropout(0.0))

    def forward(self, x, context=None):
        h = self.heads
        q = self.to_q(x)
        context = x if context is None else context
        k = self.to_k(context)
        v = self.to_v(context)

        def split(t):   # b n (h d) -> (b h) n d
            b, n, _ = t.shape
            return t.reshape(b, n, h, -1).permute(0, 2, 1, 3).reshape(
                b * h, n, -1)

        q, k, v = map(split, (q, k, v))
        sim = torch.einsum("bid,bjd->bij", q, k) * self.scale
        attn = sim.softmax(dim=-1)
        out = torch.einsum("bij,bjd->bid", attn, v)
        bh, n, d = out.shape
        out = out.reshape(bh // h, h, n, d).permute(0, 2, 1, 3).reshape(
            bh // h, n, h * d)
        return self.to_out(out)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(query_dim=dim, heads=n_heads,
                                    dim_head=d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(query_dim=dim, context_dim=context_dim,
                                    heads=n_heads, dim_head=d_head)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, in_channels, n_heads, d_head, depth, context_dim):
        super().__init__()
        inner_dim = n_heads * d_head
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6, affine=True)
        self.proj_in = nn.Conv2d(in_channels, inner_dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner_dim, n_heads, d_head, context_dim)
             for _ in range(depth)])
        self.proj_out = nn.Conv2d(inner_dim, in_channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        x_in = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, -1)   # b (h w) c
        for block in self.transformer_blocks:
            x = block(x, context=context)
        x = x.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """``UNetModel``'s arguments in zero123's configuration file."""
    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: tuple = (4, 2, 1)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    clip_embed_dim: int = 768
    pose_dim: int = 4


class UNetModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        time_embed_dim = mc * 4
        self.time_embed = nn.Sequential(
            nn.Linear(mc, time_embed_dim), nn.SiLU(),
            nn.Linear(time_embed_dim, time_embed_dim))
        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(
            nn.Conv2d(cfg.in_channels, mc, 3, padding=1))])
        input_block_chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, time_embed_dim, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(SpatialTransformer(
                        ch, cfg.num_heads, ch // cfg.num_heads,
                        cfg.transformer_depth, cfg.context_dim))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                input_block_chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(
                    TimestepEmbedSequential(Downsample(ch)))
                input_block_chans.append(ch)
                ds *= 2
        self.middle_block = TimestepEmbedSequential(
            ResBlock(ch, time_embed_dim, ch),
            SpatialTransformer(ch, cfg.num_heads, ch // cfg.num_heads,
                               cfg.transformer_depth, cfg.context_dim),
            ResBlock(ch, time_embed_dim, ch))
        self.output_blocks = nn.ModuleList([])
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                ich = input_block_chans.pop()
                layers = [ResBlock(ch + ich, time_embed_dim, mc * mult)]
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    layers.append(SpatialTransformer(
                        ch, cfg.num_heads, ch // cfg.num_heads,
                        cfg.transformer_depth, cfg.context_dim))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        self.out = nn.Sequential(normalization(ch), nn.SiLU(),
                                 nn.Conv2d(mc, cfg.out_channels, 3,
                                           padding=1))

    def forward(self, x, timesteps, context):
        hs = []
        emb = self.time_embed(timestep_embedding(timesteps,
                                                 self.cfg.model_channels))
        h = x
        for module in self.input_blocks:
            h = module(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for module in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            h = module(h, emb, context)
        return self.out(h)


# ---- CLIP's image tower ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    output_dim: int = 768


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d_model, n_head):
        super().__init__()
        self.attn = nn.MultiheadAttention(d_model, n_head)
        self.ln_1 = nn.LayerNorm(d_model)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(d_model, d_model * 4))
        self.mlp.add_module("gelu", QuickGELU())
        self.mlp.add_module("c_proj", nn.Linear(d_model * 4, d_model))
        self.ln_2 = nn.LayerNorm(d_model)

    def forward(self, x):
        # need_weights keeps the product-softmax-product path (no fused
        # attention kernel)
        y = self.ln_1(x)
        x = x + self.attn(y, y, y, need_weights=True)[0]
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width, layers, heads):
        super().__init__()
        self.resblocks = nn.Sequential(*[ResidualAttentionBlock(width, heads)
                                         for _ in range(layers)])

    def forward(self, x):
        return self.resblocks(x)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        width = cfg.width
        self.conv1 = nn.Conv2d(3, width, kernel_size=cfg.patch_size,
                               stride=cfg.patch_size, bias=False)
        scale = width ** -0.5
        self.class_embedding = nn.Parameter(scale * torch.randn(width))
        self.positional_embedding = nn.Parameter(scale * torch.randn(
            (cfg.image_size // cfg.patch_size) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, cfg.layers, cfg.heads)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(scale * torch.randn(width, cfg.output_dim))
        self.image_size = cfg.image_size

    def forward(self, x):
        x = self.conv1(x)
        x = x.reshape(x.shape[0], x.shape[1], -1).permute(0, 2, 1)
        x = torch.cat([self.class_embedding.to(x.dtype) + torch.zeros(
            x.shape[0], 1, x.shape[-1], dtype=x.dtype, device=x.device), x],
            dim=1)
        x = self.ln_pre(x + self.positional_embedding.to(x.dtype))
        x = self.transformer(x.permute(1, 0, 2)).permute(1, 0, 2)
        return self.ln_post(x[:, 0, :]) @ self.proj


def clip_preprocess(x, size):
    """``FrozenCLIPImageEmbedder.preprocess`` of [-1, 1] NCHW images."""
    x = F.interpolate(x, size=(size, size), mode="bicubic",
                      align_corners=True)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


# ---- the pose -------------------------------------------------------------

def cartesian_to_spherical(xyz):
    """zero123's, on Z-up points (N, 3): (polar from +Z, azimuth, radius)."""
    xy = xyz[:, 0] ** 2 + xyz[:, 1] ** 2
    z = np.sqrt(xy + xyz[:, 2] ** 2)
    theta = np.arctan2(np.sqrt(xy), xyz[:, 2])
    azimuth = np.arctan2(xyz[:, 1], xyz[:, 0])
    return np.array([theta, azimuth, z])


def get_T(target_centre, cond_centre):
    """zero123's ``get_T`` on camera centres of the scene's Y-up frame,
    turned into zero123's Z-up one: [d polar, sin d az, cos d az, d r]."""
    def z_up(c):
        c = np.asarray(c, np.float64)
        return np.array([[c[0], -c[2], c[1]]])

    theta_c, az_c, z_c = cartesian_to_spherical(z_up(cond_centre))
    theta_t, az_t, z_t = cartesian_to_spherical(z_up(target_centre))
    d_theta = theta_t - theta_c
    d_azimuth = (az_t - az_c) % (2 * math.pi)
    d_z = z_t - z_c
    return torch.tensor([d_theta.item(), math.sin(d_azimuth.item()),
                         math.cos(d_azimuth.item()), d_z.item()])


# ---- the schedule and the models -----------------------------------------

def alphas_cumprod(n: int) -> np.ndarray:
    betas = torch.linspace(LINEAR_START ** 0.5, LINEAR_END ** 0.5, n,
                           dtype=torch.float64) ** 2
    return np.cumprod(1.0 - betas.numpy(), axis=0)


@dataclasses.dataclass(frozen=True)
class LDMSchedule(GaussianDiffusion):
    """ldm's ``alphas_cumprod`` at the continuous index t (T - 1),
    interpolated linearly (in float64); the UNet's time signal that
    index."""

    def log_snr(self, t):
        table = torch.as_tensor(alphas_cumprod(self.num_timesteps),
                                device=t.device)
        idx = t.double() * (self.num_timesteps - 1)
        lo = torch.clamp(torch.floor(idx), 0, self.num_timesteps - 2)
        w = idx - lo
        lo = lo.long()
        ac = table[lo] * (1 - w) + table[lo + 1] * w
        return torch.log(ac / (1 - ac)).to(t.dtype)

    def get_condition(self, times):
        return None if times is None else times * (self.num_timesteps - 1)


@dataclasses.dataclass(frozen=True)
class LDMDDPM(DDPM):
    @property
    def schedule(self) -> LDMSchedule:
        return LDMSchedule(self.config.noise_schedule, self.config.timesteps)


@dataclasses.dataclass
class Zero123Models(Models):
    """The EFT and VAE of the SparseFusion reference with Zero123's UNet,
    CLIP tower and ``cc_projection``.  ``tf32_unet``: the UNet computes
    with TF32 on (a control)."""
    clip: Optional[VisionTransformer] = None
    cc_projection: Optional[nn.Linear] = None
    tf32_unet: bool = False

    def denoise_fn(self, x, timesteps, cond, keep_mask):
        token, concat = cond
        keep = keep_mask.to(x.dtype)
        token = token * keep[:, None, None]
        concat = concat * keep[:, None, None, None]
        with tf32_within(self.tf32 or self.tf32_unet):
            return self.unet(torch.cat([x, concat], dim=1), timesteps, token)


def meta_modules(sizes: dict):
    """The EFT, VAE, UNet, CLIP tower and ``cc_projection`` of a
    configuration file's sizes (keys ``eft``, ``vae``, ``zero123``,
    ``clip``), on the meta device."""
    ucfg = UNetConfig(**sizes["zero123"])
    with torch.device("meta"):
        return (EpipolarFeatureTransformer(EFTConfig(**sizes["eft"])),
                AutoencoderKL(VAEConfig(**sizes["vae"])),
                UNetModel(ucfg), VisionTransformer(CLIPConfig(**sizes["clip"])),
                nn.Linear(ucfg.clip_embed_dim + ucfg.pose_dim,
                          ucfg.context_dim))


def build_models(sizes: dict, fill, device) -> Zero123Models:
    """The five modules on ``device`` with weights from ``fill(module)``,
    called in the order EFT, VAE, UNet, CLIP, ``cc_projection``."""
    mods = [m.to_empty(device=device).eval() for m in meta_modules(sizes)]
    for m in mods:
        fill(m)
    eft, vae, unet, clip, proj = mods
    return Zero123Models(eft, vae, unet, LDMDDPM(DDPMConfig(**sizes["ddpm"])),
                         clip=clip, cc_projection=proj)


# ---- distillation ----------------------------------------------------------

@torch.no_grad()
def conditioning(models: Zero123Models, scene_cameras, scene_rgb, input_idx,
                 cfg: dict, wanted) -> dict:
    """{cached camera: (token (1, context_dim), concat latent (4, h, w))}:
    the input view nearest the camera, its CLIP embedding with the pose
    through ``cc_projection``, and its VAE latent's mode (unscaled)."""
    aug = get_interpolated_path(scene_cameras, n=cfg["n_aug_cameras"],
                                theta_offset_max=cfg["theta_offset_max"],
                                rng=np.random.RandomState(0))
    centres = camera_centers(concat_cameras([scene_cameras, aug])).cpu()
    centres = centres.double().numpy()
    views = scene_rgb[list(input_idx)].permute(0, 3, 1, 2) * 2.0 - 1.0
    emb = models.clip(clip_preprocess(views, models.clip.image_size))
    latents = models.vae.encode_mode(
        normalize(scene_rgb[list(input_idx)]).permute(0, 3, 1, 2))
    out = {}
    for ci in sorted(set(wanted)):
        c = centres[ci]
        cos = [np.dot(c, centres[v]) / (np.linalg.norm(c)
                                        * np.linalg.norm(centres[v]))
               for v in input_idx]
        k = int(np.argmax(cos))
        pose = get_T(c, centres[input_idx[k]]).to(emb.device, emb.dtype)
        token = models.cc_projection(torch.cat([emb[k], pose])[None])
        out[ci] = (token, latents[k])
    return out


class Zero123Steps(DistillSteps):
    """The reference's steps with Zero123 conditioned on (token, latent)
    in the fusion step."""

    @torch.no_grad()
    def fusion_target(self, img, cond, max_thres, generator):
        models, cfg = self.models, self.cfg
        latents = models.vae_encode(img[None])
        pred_x0, _, _, alpha_cumprod = plms_sample(
            models.ddpm, models.denoise_fn, latents, max_thres,
            cond_images=tuple(c[None] for c in cond),
            cond_scale=cfg["cond_scale"], plms_steps=cfg["plms_steps"],
            generator=generator)
        self.targets.append(pred_x0.detach().clone())
        return models.vae_decode(pred_x0)[0], (1.0 - alpha_cumprod)[0]


def follow_distillation(models: Zero123Models, scene, input_idx, cfg: dict,
                        ngp: dict, generator, n_iterations: int,
                        fusion_from: int, moment_at: int, device) -> dict:
    """:func:`portbench.reference.sparsefusion.follow_distillation` with
    Zero123 in the fusion step: the same draws, field, steps and
    readings."""
    image_size = scene.images.shape[1]
    scene_cameras = scene.cameras(device)
    scene_rgb = torch.as_tensor(scene.images, device=device)
    scene_mask = torch.as_tensor(scene.masks, device=device)
    scene_vox = get_relative_cameras(scene_cameras, [0],
                                     center_at_origin=False)
    input_idx = [int(i) for i in input_idx]
    host_rng = np.random.RandomState(17)
    n_cache = n_cached_cameras(len(scene.images), cfg)
    plan = []
    for _ in range(n_iterations):
        bi = input_idx[host_rng.randint(len(input_idx))]
        ci = int(host_rng.randint(n_cache))
        mt = min(float(host_rng.uniform()), 0.99)
        plan.append((bi, ci, mt))
    wanted = [ci for _, ci, _ in plan]
    cache = feature_cache_entries(models, scene_cameras, scene_rgb,
                                  input_idx, cfg, image_size, wanted)
    cond = conditioning(models, scene_cameras, scene_rgb, input_idx, cfg,
                        wanted)
    field = NGPField(NGPConfig(**ngp), device=device, generator=generator)
    start = {n: p.detach().clone() for n, p in field.named_parameters()}
    steps = Zero123Steps(field, cfg, image_size, models)
    losses, moment = [], None
    for itr, (bi, ci, mt) in enumerate(plan):
        losses.append(steps.input_step(get_camera_slice(scene_vox, [bi]),
                                       scene_rgb[bi], scene_mask[bi],
                                       generator))
        _, eft_img, cam = cache[ci]
        if itr > fusion_from:
            losses.append(steps.fusion_step(cam, cond[ci], mt, generator))
        else:
            losses.append(steps.bootstrap_step(cam, eft_img, generator))
        if itr == moment_at:
            moment = adam_moments(steps.adam, dict(field.named_parameters()))
    return {"losses": losses, "moment": moment, "start": start,
            "targets": steps.targets,
            "end": {n: p.detach().clone()
                    for n, p in field.named_parameters()}}
