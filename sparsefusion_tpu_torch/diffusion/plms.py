"""PLMS / PNDM sampler for the fusion step's partial denoise, as one
plain loop.

Counterpart of ``sparsefusion_tpu/diffusion/plms.py``
(``host_schedule``, ``plms_sample`` and the ``PLMSSampler`` wrapper;
its scan, host and fused forms were dispatch devices of XLA and have no
counterpart here):

* step 0 is a pseudo improved-Euler step (two UNet evaluations),
* steps 1 / 2 use 2nd / 3rd-order Adams-Bashforth, later steps AB4,
* each step adds posterior noise, times zero where t_next == 0,
* ``max_thres >= 0.99`` starts from the clean input over the whole
  schedule; otherwise the input is q-sampled to ``max_thres``.

Latents are NCHW.  Every random draw is a standard normal of the
latents' shape, taken in this order: the initial noise, the two
posterior noises of step 0, then one per later step.  They come from
``noises`` when it is given (the tests pass the JAX package's draws)
and from ``generator`` otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from sparsefusion_tpu_torch.diffusion.ddpm import DDPM, clip_x_start
from sparsefusion_tpu_torch.diffusion.schedule import right_pad_dims_to


def host_schedule(max_thres: float, plms_steps: int):
    """``(full_start, n_steps, times_all)``: n_steps = min(int(max_thres *
    plms_steps * 2), plms_steps) (all of them from max_thres >= 0.99),
    and times_all the plms_steps + 1 times from the start down to 0."""
    max_thres = float(max_thres)
    full_start = max_thres >= 0.99
    n_steps = plms_steps if full_start else min(
        int(max_thres * plms_steps * 2), plms_steps)
    denom = float(max(n_steps, 1))
    start_t = 1.0 if full_start else max_thres
    times_all = [start_t * max(denom - i, 0.0) / denom
                 for i in range(plms_steps + 1)]
    return full_start, n_steps, times_all


class _Draws:
    def __init__(self, noises: Optional[Sequence[torch.Tensor]],
                 generator: Optional[torch.Generator]):
        self.noises = None if noises is None else list(noises)
        self.generator = generator
        self.used = 0

    def __call__(self, like: torch.Tensor) -> torch.Tensor:
        if self.noises is None:
            out = torch.randn(like.shape, generator=self.generator,
                              dtype=like.dtype, device=like.device)
        else:
            out = self.noises[self.used].to(like.device, like.dtype)
            if out.shape != like.shape:
                raise ValueError(f"noise {self.used} has shape "
                                 f"{tuple(out.shape)}, not "
                                 f"{tuple(like.shape)}")
        self.used += 1
        return out


def _x_prev_from_eps(ddpm: DDPM, x, t: float, t_next: float, eps, noise):
    """x_start from eps -> clip -> q_posterior -> noisy step."""
    sched = ddpm.schedule
    b = x.shape[0]
    tt = torch.full((b,), t, dtype=x.dtype, device=x.device)
    tn = torch.full((b,), t_next, dtype=x.dtype, device=x.device)
    x_start = clip_x_start(sched.predict_start_from_noise(x, tt, eps),
                           ddpm.config)
    mean, _, log_var = sched.q_posterior(x_start, x, tt, tn)
    nonzero = right_pad_dims_to(x, 1.0 - (tn == 0).to(x.dtype))
    return mean + nonzero * torch.exp(0.5 * log_var) * noise


def _adams_bashforth(e_t, hist):
    """hist[0] is the most recent earlier epsilon."""
    if len(hist) == 1:
        return (3 * e_t - hist[0]) / 2
    if len(hist) == 2:
        return (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
    return (55 * e_t - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24


@torch.no_grad()
def plms_sample(
    ddpm: DDPM,
    denoise_fn: Callable,
    image: torch.Tensor,
    max_thres: float,
    cond_images: Optional[torch.Tensor] = None,
    cond_scale: float = 1.0,
    plms_steps: int = 50,
    generator: Optional[torch.Generator] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
):
    """Partial-noise PLMS from the clean latents ``image`` (B, C, h, w).

    Returns ``(img, x_noisy, init_noise, alpha_cumprod (B,))``.
    """
    cfg = ddpm.config
    sched = ddpm.schedule
    batch = image.shape[0]
    full_start, n_steps, times = host_schedule(max_thres, plms_steps)
    draw = _Draws(noises, generator)

    init_noise = draw(image)
    x_noisy, log_snr = sched.q_sample(image, float(max_thres), init_noise)
    img = image if full_start else x_noisy

    def eval_eps(x, t):
        t_b = torch.full((batch,), t, dtype=x.dtype, device=x.device)
        return ddpm.forward_with_cond_scale(
            denoise_fn, x, sched.get_condition(t_b), cond_images, cond_scale)

    hist = []
    if n_steps > 0:
        t, t_next = times[0], times[1]
        noise1, noise2 = draw(img), draw(img)
        e_t = eval_eps(img, t)
        x_prev1 = _x_prev_from_eps(ddpm, img, t, t_next, e_t, noise1)
        e_t_next = eval_eps(x_prev1, t_next)
        img = _x_prev_from_eps(ddpm, img, t, t_next, (e_t + e_t_next) / 2,
                               noise2)
        hist = [e_t]
    for i in range(1, n_steps):
        t, t_next = times[i], times[i + 1]
        e_t = eval_eps(img, t)
        img = _x_prev_from_eps(ddpm, img, t, t_next,
                               _adams_bashforth(e_t, hist), draw(img))
        hist = [e_t] + hist[:2]

    if cfg.clip_output:
        img = torch.clamp(img, -cfg.clip_value, cfg.clip_value)
    return img, x_noisy, init_noise, torch.sigmoid(log_snr)


@dataclasses.dataclass(frozen=True)
class PLMSSampler:
    """:func:`plms_sample` with its DDPM and step count bound, as the
    reference's ``external/plms.py:13`` call sites use it."""

    ddpm: DDPM
    plms_steps: int = 50

    def sample(self, denoise_fn, image, max_thres, cond_images=None,
               cond_scale: float = 1.0, return_noise: bool = False,
               generator: Optional[torch.Generator] = None,
               noises: Optional[Sequence[torch.Tensor]] = None):
        out = plms_sample(self.ddpm, denoise_fn, image, max_thres,
                          cond_images, cond_scale, self.plms_steps,
                          generator=generator, noises=noises)
        return out if return_noise else out[0]
