"""Model bundles: EFT + SD-VAE + view-conditioned UNet, the SparseFusion
trio; and the same EFT and VAE with Zero-1-to-3's UNet as the fusion
prior (:class:`Zero123Models`, no counterpart in the JAX package).

Counterpart of ``sparsefusion_tpu/models.py``.  Images enter and leave
in the JAX package's NHWC layout (scenes and renders are NHWC); latents
and the EFT's feature images are NCHW, the networks' layout.  The
sampler's UNet evaluations and the VAE's encodes and decodes are the
span recorder's spans ``unet`` (with its batch, ``unet_batch``),
``vae_encode`` and ``vae_decode`` (``utils/spans.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from sparsefusion_tpu_torch.core.cameras import Cameras
from sparsefusion_tpu_torch.diffusion.ddpm import DDPM, DDPMConfig
from sparsefusion_tpu_torch.nn.eft import EFTConfig, EpipolarFeatureTransformer
from sparsefusion_tpu_torch.nn.flax_layout import init_like_flax_
from sparsefusion_tpu_torch.nn.unet import EfficientUNet, UNetConfig
from sparsefusion_tpu_torch.nn.vae import AutoencoderKL, VAEConfig
from sparsefusion_tpu_torch.nn.zero123 import (
    CLIPConfig,
    CLIPImageEncoder,
    Zero123Config,
    Zero123UNet,
    clip_preprocess,
    nearest_views,
    relative_pose,
)
from sparsefusion_tpu_torch.utils import spans
from sparsefusion_tpu_torch.utils.image import normalize, unnormalize

Z_SCALE_FACTOR = 0.18215  # the SD latent scale


def unet_half(unet: EfficientUNet) -> EfficientUNet:
    """A bf16 copy of ``unet``: bf16 weights, cast on their device, bf16
    compute, f32 output; in eval mode, without gradients."""
    with torch.device("meta"):
        half = EfficientUNet(unet.config, dtype=torch.bfloat16)
    device = next(unet.parameters()).device
    half = half.to(torch.bfloat16).to_empty(device=device)
    half.load_state_dict(unet.state_dict())
    return half.eval().requires_grad_(False)


def unet_compute_view(unet: EfficientUNet,
                      dtype: torch.dtype) -> EfficientUNet:
    """``unet``'s network computing in ``dtype`` on ``unet``'s own
    parameters (the same tensors, not copies): gradients through it reach
    ``unet``'s f32 parameters as f32, through the casts."""
    with torch.device("meta"):
        view = EfficientUNet(unet.config, dtype=dtype)
    for name, module in view.named_modules():
        src = unet.get_submodule(name)
        for pname, _ in list(module.named_parameters(recurse=False)):
            setattr(module, pname, getattr(src, pname))
        for bname, _ in list(module.named_buffers(recurse=False)):
            setattr(module, bname, getattr(src, bname))
    return view.train(unet.training)


@dataclasses.dataclass
class SparseFusionModels:
    eft: EpipolarFeatureTransformer
    vae: AutoencoderKL
    unet: EfficientUNet
    ddpm: DDPM
    z_scale_factor: float = Z_SCALE_FACTOR
    # the span recorder's ring of device stamps (``utils/spans.py``)
    span_slots = spans.SLOTS
    # UNet evaluations since construction (each is one forward pass)
    unet_evals: int = 0
    # the sampler's bf16 copy of the UNet and the key it was made under
    _half: Optional[EfficientUNet] = dataclasses.field(default=None,
                                                       repr=False)
    _half_key: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def denoise_fn(self, x, log_snr, cond_images, keep_mask, bf16=False):
        """eps prediction: latents (B, 4, h, w), log_snr (B,), EFT
        features (B, 256, h, w), keep mask (B,) or None.  ``bf16``: through
        :meth:`unet_half` (no gradient), as the JAX package's
        ``unet_apply_fn(bf16=True)`` with ``sampler_unet_params(True)``."""
        self.unet_evals += 1
        unet = self.unet_half() if bf16 else self.unet
        with spans.span("unet", unet_batch=x.shape[0]):
            return unet(x, log_snr, cond_images, keep_mask)

    def unet_half(self) -> EfficientUNet:
        """The sampler's bf16 copy of the UNet, cast once on the device
        and cached.  The cache is keyed on the UNet and its parameters'
        version counters, which every in-place write bumps (a checkpoint
        or reference-weight load, an optimizer step), so a load makes a
        new copy."""
        key = (id(self.unet),) + tuple(p._version
                                       for p in self.unet.parameters())
        if self._half is None or self._half_key != key:
            self._half = None   # free the old copy before the new one
            self._half = unet_half(self.unet)
            self._half_key = key
        return self._half

    def vae_encode(self, images_01: torch.Tensor) -> torch.Tensor:
        """[0, 1] RGB (B, H, W, 3) -> scaled latents (B, 4, H/8, W/8)."""
        with spans.span("vae_encode"):
            x = normalize(images_01)
            return self.vae.encode_mode(x.permute(0, 3, 1, 2)) \
                * self.z_scale_factor

    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> [0, 1] RGB (B, 8h, 8w, 3)."""
        with spans.span("vae_decode"):
            x = self.vae.decode(z / self.z_scale_factor)
            return unnormalize(x).permute(0, 2, 3, 1)

    def prior_conditioning(self, features, cameras: Cameras,
                           scene_rgb: torch.Tensor, input_idx):
        """The sampler's conditioning of each cached camera (Phase A): the
        EFT's feature images ``features`` themselves."""
        return features

    def eft_encode(self, images: torch.Tensor) -> torch.Tensor:
        """Context images (NC, H, W, 3) -> (NC, 512, H/2, W/2) latents."""
        return self.eft.encode(images.permute(0, 3, 1, 2))

    def eft_ray_fn(self, input_cameras: Cameras, input_images: torch.Tensor,
                   encoder_latent: torch.Tensor) -> Callable:
        """Bind the context views (images NHWC): returns
        (origins, dirs, lengths) -> (rgb, feat)."""
        images = input_images.permute(0, 3, 1, 2).contiguous()

        def fn(origins, directions, lengths):
            return self.eft(origins, directions, lengths, input_cameras,
                            images, encoder_latent)

        return fn


def build_models(generator: torch.Generator,
                 device=None,
                 timesteps: int = 500,
                 unet_config: Optional[UNetConfig] = None,
                 vae_config: Optional[VAEConfig] = None,
                 eft_config: Optional[EFTConfig] = None,
                 ddpm_config: Optional[DDPMConfig] = None
                 ) -> SparseFusionModels:
    """The trio with fresh Flax-default weights drawn from ``generator``
    (on ``device``, which must be the generator's), in eval mode.  The
    defaults are the reference's configurations; checkpoints load
    separately (``train/checkpoints.py``)."""
    device = torch.device(device if device is not None
                          else generator.device)
    with torch.device("meta"):
        eft = EpipolarFeatureTransformer(eft_config or EFTConfig())
        vae = AutoencoderKL(vae_config or VAEConfig())
        unet = EfficientUNet(unet_config or UNetConfig())
    eft, vae, unet = (m.to_empty(device=device).eval()
                      for m in (eft, vae, unet))
    init_like_flax_(eft, generator)
    init_like_flax_(vae, generator)
    unet.init_weights_(generator)
    return SparseFusionModels(
        eft=eft, vae=vae, unet=unet,
        ddpm=DDPM(ddpm_config or DDPMConfig(timesteps=timesteps)))


@dataclasses.dataclass
class Zero123Models(SparseFusionModels):
    """The EFT (Phase A's images, the bootstrap's targets) and the SD VAE
    with Zero-1-to-3's UNet as the fusion prior, conditioned on a pair:
    the ``cc_projection`` token of the nearest input view's CLIP
    embedding and its relative pose (B, 1, context_dim), and that view's
    latent mode, unscaled as zero123 feeds it (B, 4, h, w).  A dropped
    conditioning is zero in both, as zero123's unconditional branch.
    Its sampler runs in f32 only."""

    clip: Optional[CLIPImageEncoder] = None
    cc_projection: Optional[torch.nn.Linear] = None
    # 16 transformers and their self-attentions stamp 64 times an
    # evaluation, ~4,900 stamps a fusion iteration: a ring of 1M stamps
    # holds the ~200 iterations between two reads
    span_slots = 1 << 20

    def denoise_fn(self, x, timesteps, cond, keep_mask, bf16=False):
        """eps of latents (B, 4, h, w) at ldm timesteps (B,) under the
        conditioning pair ``cond`` with keep mask (B,) or None."""
        unet = self.unet_half() if bf16 else self.unet
        self.unet_evals += 1
        token, concat = cond
        if keep_mask is not None:
            keep = keep_mask.to(x.dtype)
            token = token * keep[:, None, None]
            concat = concat * keep[:, None, None, None]
        with spans.span("unet", unet_batch=x.shape[0]):
            return unet(torch.cat([x, concat], dim=1), timesteps, token)

    def unet_half(self):
        raise NotImplementedError("the Zero123 sampler runs in f32")

    def prior_conditioning(self, features, cameras: Cameras,
                           scene_rgb: torch.Tensor, input_idx):
        """Each cached camera's pair (token (M, 1, context_dim), concat
        latent (M, 4, h, w)) from the input view nearest it by the angle
        of the camera centres about the scene centre (``cameras``: the
        M cached cameras, input views among them, in the scene's frame);
        the CLIP tower runs once an input view.  The set-up span
        ``z123_cond``."""
        from sparsefusion_tpu_torch.core.cameras import camera_centers

        with spans.setup_span("z123_cond"):
            views = scene_rgb[list(input_idx)]
            emb = self.clip(clip_preprocess(views,
                                            self.clip.config.image_size))
            latents = self.vae.encode_mode(
                normalize(views).permute(0, 3, 1, 2))
            centres = camera_centers(cameras)
            near = nearest_views(centres, centres[list(input_idx)])
            pose = relative_pose(centres, centres[list(input_idx)][near])
            token = self.cc_projection(torch.cat([emb[near], pose], -1))
            return token[:, None], latents[near]


def build_zero123_models(generator: torch.Generator, device=None,
                         unet_config: Optional[Zero123Config] = None,
                         clip_config: Optional[CLIPConfig] = None,
                         vae_config: Optional[VAEConfig] = None,
                         eft_config: Optional[EFTConfig] = None,
                         ddpm_config: Optional[DDPMConfig] = None
                         ) -> Zero123Models:
    """The Zero123 bundle with fresh weights drawn from ``generator`` (the
    EFT and VAE as :func:`build_models` draws them; the UNet, CLIP tower
    and ``cc_projection`` lecun-normal, norms 1 and biases 0), in eval
    mode.  The schedule defaults to ldm's 1000 steps."""
    device = torch.device(device if device is not None
                          else generator.device)
    unet_config = unet_config or Zero123Config()
    with torch.device("meta"):
        eft = EpipolarFeatureTransformer(eft_config or EFTConfig())
        vae = AutoencoderKL(vae_config or VAEConfig())
        unet = Zero123UNet(unet_config)
        clip = CLIPImageEncoder(clip_config or CLIPConfig())
        proj = torch.nn.Linear(
            unet_config.clip_embed_dim + unet_config.pose_dim,
            unet_config.context_dim)
    eft, vae, unet, clip, proj = (m.to_empty(device=device).eval()
                                  for m in (eft, vae, unet, clip, proj))
    init_like_flax_(eft, generator)
    init_like_flax_(vae, generator)
    for m in (unet, clip, proj):
        _lecun_(m, generator)
    return Zero123Models(
        eft=eft, vae=vae, unet=unet, clip=clip, cc_projection=proj,
        ddpm=DDPM(ddpm_config or DDPMConfig(timesteps=1000,
                                            noise_schedule="ldm_linear")))


@torch.no_grad()
def _lecun_(module: torch.nn.Module, generator: torch.Generator) -> None:
    for name, p in module.named_parameters():
        owner = module.get_submodule(name.rpartition(".")[0])
        if isinstance(owner, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            fan_in = p[0].numel() if p.ndim > 1 else p.numel()
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) / np.sqrt(fan_in))


def narrow_zero123_configs():
    """A narrow Zero123 UNet and CLIP tower with the narrow VAE, for runs
    on the CPU."""
    return dict(
        unet_config=Zero123Config(model_channels=32, channel_mult=(1, 2),
                                  attention_resolutions=(1, 2), num_heads=2,
                                  context_dim=32, clip_embed_dim=16),
        clip_config=CLIPConfig(image_size=28, patch_size=14, width=32,
                               layers=2, heads=2, output_dim=16),
        vae_config=narrow_model_configs()["vae_config"],
        ddpm_config=DDPMConfig(channels=4, image_size=8, timesteps=1000,
                               noise_schedule="ldm_linear"))


def narrow_model_configs():
    """Narrow UNet / VAE configs (the JAX package's tiny end-to-end test
    models) for runs on the CPU; the EFT stays at full width, which is
    cheap at the CPU's small image sizes."""
    return dict(
        unet_config=UNetConfig(
            dim=32, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
            layer_attns=(False, True), layer_cross_attns=(False, False),
            cond_images_channels=256, attn_heads=2, attn_dim_head=8),
        vae_config=VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1),
        ddpm_config=DDPMConfig(channels=4, image_size=8, timesteps=100))


def count_params(tree) -> int:
    """Parameter count of a module, or of a tree (dicts, lists, tuples)
    of tensors or arrays, such as ``export_jax_params``'s."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(t) for t in tree)
    return int(np.prod(tree.shape))
