"""Training visualization: context / target / EFT render / sample grids.

Counterpart of ``sparsefusion_tpu/train/visualize.py``: a side-by-side
grid of the context views, the query's ground truth, the EFT's light-field
render of the query (upsampled to the image size) and an ancestral
diffusion sample conditioned on the EFT's features, decoded by the VAE.
The grid is returned; it is written as a jpg where ``imageio`` imports.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from sparsefusion_tpu_torch.core.cameras import Cameras
from sparsefusion_tpu_torch.ops.image import resize_bilinear
from sparsefusion_tpu_torch.render.lightfield import render_light_field
from sparsefusion_tpu_torch.utils.image import to_uint8


@torch.no_grad()
def save_visualization(models, query_cam: Cameras, query_rgb: torch.Tensor,
                       context_cams: Cameras, context_rgb: torch.Tensor,
                       min_depth: float, max_depth: float, out_path: str,
                       generator: Optional[torch.Generator] = None,
                       latent_hw: int = 32,
                       sample_timesteps: Optional[int] = 64,
                       noises: Optional[Sequence[torch.Tensor]] = None
                       ) -> np.ndarray:
    """[contexts | ground truth | EFT render | sample] as an (H, W * (NC +
    3), 3) array in [0, 1].  Images are NHWC (query (H, W, 3), contexts
    (NC, H, W, 3)); the sample runs ``sample_timesteps`` ancestral steps
    with its normal draws from ``generator`` or ``noises``."""
    image_size = int(query_rgb.shape[0])
    latent = models.eft_encode(context_rgb)
    rgb, feat = render_light_field(
        models.eft_ray_fn(context_cams, context_rgb, latent), query_cam,
        latent_hw, latent_hw, min_depth, max_depth, n_batches=16)
    eft_img = resize_bilinear(rgb, (image_size, image_size))[0]

    ddpm = models.ddpm
    if sample_timesteps is not None:
        ddpm = dataclasses.replace(ddpm, config=dataclasses.replace(
            ddpm.config, timesteps=sample_timesteps))
    z = ddpm.p_sample_loop(
        models.denoise_fn,
        (1, ddpm.config.channels, latent_hw, latent_hw),
        cond_images=feat.permute(0, 3, 1, 2), generator=generator,
        noises=noises, device=query_rgb.device)
    sample = models.vae_decode(z)[0]

    cols = list(context_rgb) + [query_rgb, eft_img, sample]
    grid = np.hstack([c.float().cpu().numpy() for c in cols])
    try:
        import imageio
    except ImportError:
        print(f"imageio not installed: {out_path} not written")
        return grid
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    imageio.imwrite(out_path, to_uint8(grid))
    return grid
