"""The sampler's side of the view-conditioned latent DDPM.

Counterpart of the sampling parts of ``sparsefusion_tpu/diffusion/ddpm.py``
(the training loss comes with the training slice).  Everything takes an
explicit ``denoise_fn(x, log_snr, cond_images, keep_mask) -> eps`` on
NCHW latents.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from sparsefusion_tpu_torch.diffusion.schedule import (
    GaussianDiffusion,
    right_pad_dims_to,
)

DenoiseFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    """Same fields and defaults as the JAX ``DDPMConfig``."""

    channels: int = 4
    image_size: int = 32
    timesteps: int = 500
    noise_schedule: str = "cosine"
    cond_drop_prob: float = 0.1
    pred_objective: str = "noise"
    loss_type: str = "l2"
    clip_output: bool = True
    clip_value: float = 10.0
    dynamic_thresholding: bool = False
    dynamic_thresholding_percentile: float = 0.68
    p2_loss_weight_gamma: float = 0.5
    p2_loss_weight_k: float = 1.0


def clip_x_start(x_start: torch.Tensor, cfg: DDPMConfig) -> torch.Tensor:
    """Static or dynamic thresholding of the predicted x0."""
    if not cfg.clip_output:
        return x_start
    if cfg.dynamic_thresholding:
        s = torch.quantile(x_start.reshape(x_start.shape[0], -1).abs(),
                           cfg.dynamic_thresholding_percentile, dim=-1)
        s = right_pad_dims_to(x_start, torch.clamp(s, min=1.0))
        return torch.maximum(torch.minimum(x_start, s), -s) / s
    return torch.clamp(x_start, -cfg.clip_value, cfg.clip_value)


@dataclasses.dataclass(frozen=True)
class DDPM:
    """Bundles schedule and config; methods are pure."""

    config: DDPMConfig = DDPMConfig()

    @property
    def schedule(self) -> GaussianDiffusion:
        return GaussianDiffusion(self.config.noise_schedule,
                                 self.config.timesteps)

    def forward_with_cond_scale(self, denoise_fn: DenoiseFn, x, log_snr,
                                cond_images, cond_scale: float):
        """Classifier-free guidance: one UNet evaluation at scale 1, two
        otherwise (conditioned and with the conditioning dropped)."""
        b = x.shape[0]
        keep = torch.ones((b,), dtype=torch.bool, device=x.device)
        logits = denoise_fn(x, log_snr, cond_images, keep)
        if cond_scale == 1.0:
            return logits
        null_logits = denoise_fn(x, log_snr, cond_images,
                                 torch.zeros_like(keep))
        return null_logits + (logits - null_logits) * cond_scale
