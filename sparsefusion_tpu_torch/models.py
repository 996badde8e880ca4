"""Model bundle: EFT + SD-VAE + view-conditioned UNet, the SparseFusion
trio.

Counterpart of ``sparsefusion_tpu/models.py``.  Images enter and leave
in the JAX package's NHWC layout (scenes and renders are NHWC); latents
and the EFT's feature images are NCHW, the networks' layout.
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
        x = normalize(images_01)
        return self.vae.encode_mode(x.permute(0, 3, 1, 2)) \
            * self.z_scale_factor

    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> [0, 1] RGB (B, 8h, 8w, 3)."""
        x = self.vae.decode(z / self.z_scale_factor)
        return unnormalize(x).permute(0, 2, 3, 1)

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
