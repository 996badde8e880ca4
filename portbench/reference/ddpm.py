"""The view-conditioned latent DDPM: training loss and ancestral sampling.

Frozen copy of the port's ``diffusion/ddpm.py`` (the JAX ``sparsefusion_tpu/diffusion/ddpm.py``'s counterpart).  Everything takes
an explicit ``denoise_fn(x, log_snr, cond_images, keep_mask) -> eps`` on
NCHW latents.  Random draws come from a ``torch.Generator`` or are passed
in (``noise``, ``keep_mask``, ``noises``), so tests can hand both packages
the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from portbench.reference.schedule import (
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


def _loss(pred, target, loss_type: str):
    if loss_type == "l2":
        return (pred - target) ** 2
    if loss_type == "l1":
        return (pred - target).abs()
    if loss_type == "huber":
        d = pred - target
        return torch.where(d.abs() < 1.0, 0.5 * d * d, d.abs() - 0.5)
    raise NotImplementedError(loss_type)


def _normal(shape, generator: Optional[torch.Generator], like: torch.Tensor):
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=like.dtype)


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

    def p_losses(self, denoise_fn: DenoiseFn, x_start: torch.Tensor,
                 times: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 cond_images: Optional[torch.Tensor] = None,
                 loss_mask: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 keep_mask: Optional[torch.Tensor] = None,
                 drawn: Optional[dict] = None) -> torch.Tensor:
        """Masked eps-prediction loss, mean per sample, p2-weighted by
        ``(k + exp(log_snr)) ** -gamma``, then the batch mean.  ``noise``
        (like ``x_start``) and the conditioning ``keep_mask`` (B,) bool
        are drawn from ``generator`` (in that order) where not given;
        ``drawn``, where given, receives the two as ``noise`` and
        ``keep``."""
        cfg = self.config
        sched = self.schedule
        b = x_start.shape[0]
        if noise is None:
            noise = _normal(x_start.shape, generator, x_start)
        x_noisy, log_snr = sched.q_sample(x_start, times, noise)
        if keep_mask is None:
            keep_mask = torch.rand(b, generator=generator,
                                   device=x_start.device) \
                < 1.0 - cfg.cond_drop_prob
        if drawn is not None:
            drawn.update(noise=noise, keep=keep_mask)
        pred = denoise_fn(x_noisy, sched.get_condition(times), cond_images,
                          keep_mask)

        target = noise if cfg.pred_objective == "noise" else x_start
        if loss_mask is not None:
            pred = pred * loss_mask
            target = target * loss_mask
        losses = _loss(pred, target, cfg.loss_type).reshape(b, -1).mean(-1)
        if cfg.p2_loss_weight_gamma > 0:
            losses = losses * (cfg.p2_loss_weight_k + torch.exp(log_snr)) \
                ** -cfg.p2_loss_weight_gamma
        return losses.mean()

    def p_mean_variance(self, denoise_fn: DenoiseFn, x, t, t_next,
                        cond_images, cond_scale: float = 1.0):
        """Posterior (mean, variance, log variance) of one ancestral step
        from t to t_next, through the clipped x0 prediction."""
        sched = self.schedule
        pred = self.forward_with_cond_scale(
            denoise_fn, x, sched.get_condition(t), cond_images, cond_scale)
        if self.config.pred_objective == "noise":
            x_start = sched.predict_start_from_noise(x, t, pred)
        else:
            x_start = pred
        x_start = clip_x_start(x_start, self.config)
        return sched.q_posterior(x_start, x, t, t_next)

    def p_sample(self, denoise_fn: DenoiseFn, x, t, t_next, cond_images,
                 cond_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
        """One ancestral step; no noise is added where t_next == 0."""
        mean, _, log_var = self.p_mean_variance(
            denoise_fn, x, t, t_next, cond_images, cond_scale)
        if noise is None:
            noise = _normal(x.shape, generator, x)
        nonzero = right_pad_dims_to(x, 1.0 - (t_next == 0).to(x.dtype))
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    def p_sample_loop(self, denoise_fn: DenoiseFn, shape: Tuple[int, ...],
                      cond_images: Optional[torch.Tensor] = None,
                      cond_scale: float = 1.0,
                      generator: Optional[torch.Generator] = None,
                      noises: Optional[Sequence[torch.Tensor]] = None,
                      device=None) -> torch.Tensor:
        """Full ancestral sampling from pure noise over the schedule's
        ``timesteps`` steps.  ``noises``: the initial noise, then one per
        step (``timesteps + 1`` tensors of ``shape``); drawn from
        ``generator`` where not given."""
        sched = self.schedule
        if device is None:
            device = (noises[0].device if noises is not None
                      else generator.device if generator is not None
                      else "cpu")

        def draw(i):
            if noises is not None:
                return noises[i].to(device)
            return torch.randn(shape, generator=generator, device=device)

        img = draw(0)
        for i, (t, t_next) in enumerate(
                sched.get_sampling_timesteps(shape[0], device)):
            img = self.p_sample(denoise_fn, img, t, t_next, cond_images,
                                cond_scale, noise=draw(i + 1))
        if self.config.clip_output:
            img = torch.clamp(img, -self.config.clip_value,
                              self.config.clip_value)
        return img

    def sample(self, denoise_fn: DenoiseFn,
               cond_images: Optional[torch.Tensor] = None,
               batch_size: int = 1, cond_scale: float = 1.0,
               generator: Optional[torch.Generator] = None,
               noises: Optional[Sequence[torch.Tensor]] = None,
               device=None) -> torch.Tensor:
        """The full ancestral chain conditioned on an EFT feature image:
        latents (B, channels, image_size, image_size)."""
        if cond_images is not None:
            batch_size = cond_images.shape[0]
            device = cond_images.device
        shape = (batch_size, self.config.channels, self.config.image_size,
                 self.config.image_size)
        return self.p_sample_loop(denoise_fn, shape, cond_images, cond_scale,
                                  generator, noises, device)
