"""Continuous-time Gaussian diffusion schedules.

Counterpart of ``sparsefusion_tpu/diffusion/schedule.py``: time t in
[0, 1] maps to a log-SNR; alpha = sqrt(sigmoid(log_snr)), sigma =
sqrt(sigmoid(-log_snr)).  Everything runs in f32 on the device of its
inputs.

``ldm_linear`` is latent diffusion's discrete schedule (Zero-1-to-3's):
``alphas_cumprod`` of betas ``linspace(sqrt(0.00085), sqrt(0.012), T)**2``,
read at the continuous index t (T - 1) and interpolated linearly, and
the UNet's time signal is that index (ldm's timestep), not the log-SNR.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch


def _log(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return torch.log(torch.clamp(t, min=eps))


def beta_linear_log_snr(t: torch.Tensor) -> torch.Tensor:
    """log SNR of the linear-beta schedule: -log(expm1(1e-4 + 10 t^2))."""
    return -torch.log(torch.expm1(1e-4 + 10.0 * (t ** 2)))


def alpha_cosine_log_snr(t: torch.Tensor, s: float = 0.008) -> torch.Tensor:
    """log SNR of the cosine schedule (eps 1e-5, as the reference)."""
    return -_log(
        torch.cos((t + s) / (1 + s) * math.pi * 0.5) ** -2 - 1.0, eps=1e-5)


LDM_LINEAR_START, LDM_LINEAR_END = 0.00085, 0.012


@functools.lru_cache(maxsize=None)
def ldm_alphas_cumprod(steps: int, device: torch.device) -> torch.Tensor:
    """ldm's ``alphas_cumprod`` (steps,), made in float64, kept in f32."""
    betas = torch.linspace(LDM_LINEAR_START ** 0.5, LDM_LINEAR_END ** 0.5,
                           steps, dtype=torch.float64) ** 2
    return torch.cumprod(1.0 - betas, 0).to(device, torch.float32)


def ldm_linear_log_snr(t: torch.Tensor, steps: int) -> torch.Tensor:
    """log SNR of ldm's schedule at the continuous index t (steps - 1)."""
    table = ldm_alphas_cumprod(steps, t.device)
    idx = t.float() * (steps - 1)
    lo = torch.clamp(torch.floor(idx), 0, steps - 2)
    frac = idx - lo
    lo = lo.long()
    ac = table[lo] * (1.0 - frac) + table[lo + 1] * frac
    return torch.log(ac) - torch.log1p(-ac)


def log_snr_to_alpha_sigma(log_snr: torch.Tensor):
    return (torch.sqrt(torch.sigmoid(log_snr)),
            torch.sqrt(torch.sigmoid(-log_snr)))


def right_pad_dims_to(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Reshape (B,) t to broadcast against x's trailing dims."""
    pad = x.ndim - t.ndim
    if pad <= 0:
        return t
    return t.reshape(*t.shape, *((1,) * pad))


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """A continuous-time schedule (static config; methods are pure)."""

    noise_schedule: str = "cosine"
    num_timesteps: int = 1000

    def log_snr(self, t: torch.Tensor) -> torch.Tensor:
        if self.noise_schedule == "linear":
            return beta_linear_log_snr(t)
        if self.noise_schedule == "cosine":
            return alpha_cosine_log_snr(t)
        if self.noise_schedule == "ldm_linear":
            return ldm_linear_log_snr(t, self.num_timesteps)
        raise ValueError(f"invalid noise schedule {self.noise_schedule}")

    def get_condition(self, times: Optional[torch.Tensor]):
        """The UNet's time signal: the log-SNR itself; ldm's timestep
        t (T - 1) for ``ldm_linear``."""
        if times is None:
            return None
        if self.noise_schedule == "ldm_linear":
            return times * (self.num_timesteps - 1)
        return self.log_snr(times)

    def sample_random_times(self, batch: int, generator: torch.Generator,
                            max_thres: float = 0.999) -> torch.Tensor:
        """(batch,) times uniform on [0, max_thres), on the generator's
        device."""
        return torch.rand(batch, generator=generator,
                          device=generator.device) * max_thres

    def sample_random_times_bounded(self, batch: int,
                                    generator: torch.Generator,
                                    min_thres: float = 0.0,
                                    max_thres: float = 0.999
                                    ) -> torch.Tensor:
        """(batch,) times uniform on [min_thres, max_thres)."""
        u = torch.rand(batch, generator=generator, device=generator.device)
        return min_thres + u * (max_thres - min_thres)

    def get_sampling_timesteps(self, batch: int, device=None
                               ) -> torch.Tensor:
        """(steps, 2, batch) consecutive (t, t_next) pairs from 1 to 0."""
        times = torch.linspace(1.0, 0.0, self.num_timesteps + 1,
                               device=device)
        pairs = torch.stack([times[:-1], times[1:]], dim=1)  # (steps, 2)
        return pairs[:, :, None].expand(self.num_timesteps, 2, batch)

    def q_sample(self, x_start: torch.Tensor, t, noise: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Noise x_start to time t (a float or (B,)).  Returns
        (x_t, log_snr (B,))."""
        t = torch.as_tensor(t, dtype=x_start.dtype, device=x_start.device)
        if t.ndim == 0:
            t = t.expand(x_start.shape[0])
        log_snr = self.log_snr(t)
        alpha, sigma = log_snr_to_alpha_sigma(
            right_pad_dims_to(x_start, log_snr))
        return alpha * x_start + sigma * noise, log_snr

    def q_posterior(self, x_start: torch.Tensor, x_t: torch.Tensor,
                    t: torch.Tensor, t_next: Optional[torch.Tensor] = None):
        """Posterior q(x_{t_next} | x_t, x_0): (mean, var, log_var_clipped)."""
        if t_next is None:
            t_next = torch.clamp(t - 1.0 / self.num_timesteps, min=0.0)
        log_snr = right_pad_dims_to(x_t, self.log_snr(t))
        log_snr_next = right_pad_dims_to(x_t, self.log_snr(t_next))
        alpha, _ = log_snr_to_alpha_sigma(log_snr)
        alpha_next, sigma_next = log_snr_to_alpha_sigma(log_snr_next)
        c = -torch.expm1(log_snr - log_snr_next)
        posterior_mean = alpha_next * (x_t * (1 - c) / alpha + c * x_start)
        posterior_variance = (sigma_next ** 2) * c
        return posterior_mean, posterior_variance, _log(
            posterior_variance, eps=1e-20)

    def predict_start_from_noise(self, x_t: torch.Tensor, t: torch.Tensor,
                                 noise: torch.Tensor) -> torch.Tensor:
        log_snr = right_pad_dims_to(x_t, self.log_snr(t))
        alpha, sigma = log_snr_to_alpha_sigma(log_snr)
        return (x_t - sigma * noise) / torch.clamp(alpha, min=1e-8)
