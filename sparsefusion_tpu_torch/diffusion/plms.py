"""PLMS / PNDM sampler for the fusion step's partial denoise.

Counterpart of ``sparsefusion_tpu/diffusion/plms.py`` (``host_schedule``,
``plms_sample``, ``plms_sample_host`` with ``scan_tail`` and the
``PLMSSampler`` wrapper):

* step 0 is a pseudo improved-Euler step (two UNet evaluations),
* steps 1 / 2 use 2nd / 3rd-order Adams-Bashforth, later steps AB4,
* each step adds posterior noise, times zero where t_next == 0,
* ``max_thres >= 0.99`` starts from the clean input over the whole
  schedule; otherwise the input is q-sampled to ``max_thres``.

The sampler is three parts that take their times as tensors, so that a
CUDA graph holding one of them reads new times at every replay
(``distill/fused.py``): :func:`plms_prologue` (the q-sample to the noise
level), :func:`plms_step0` and :func:`plms_tail_step` (one UNet
evaluation and the Adams-Bashforth combine of the order its history
gives), with the times from :func:`plms_schedule`.  :func:`plms_sample`
runs them in a plain loop: it is the counterpart of both the JAX scan
sampler and ``plms_sample_host`` (whose jitted step 0 and masked scan
tail are the fused loop's step-0 and tail graphs here).

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


def plms_schedule(max_thres: torch.Tensor, plms_steps: int):
    """:func:`host_schedule` on the device: ``max_thres`` a float64 0-d
    tensor -> (full_start, a bool 0-d tensor; the plms_steps + 1 times,
    float32).  The times are computed in float64 as the host computes
    them and then rounded, so they equal ``host_schedule``'s, rounded to
    float32, bit for bit."""
    full_start = max_thres >= 0.99
    n_steps = torch.where(
        full_start, float(plms_steps),
        torch.clamp(torch.floor(max_thres * plms_steps * 2),
                    max=float(plms_steps)))
    denom = torch.clamp(n_steps, min=1.0)
    start_t = torch.where(full_start, 1.0, max_thres)
    i = torch.arange(plms_steps + 1, dtype=torch.float64,
                     device=max_thres.device)
    times = start_t * torch.clamp(denom - i, min=0.0) / denom
    return full_start, times.to(torch.float32)


def eps_fn(ddpm: DDPM, denoise_fn: Callable,
           cond_images: Optional[torch.Tensor], cond_scale: float):
    """The classifier-free-guided epsilon of latents x at a 0-d time t."""
    sched = ddpm.schedule

    def eval_eps(x, t):
        return ddpm.forward_with_cond_scale(
            denoise_fn, x, sched.get_condition(t.expand(x.shape[0])),
            cond_images, cond_scale)

    return eval_eps


def cond_map(fn: Callable, cond):
    """``fn`` on the sampler's conditioning: a tensor, or each tensor of a
    tuple (Zero123's token and concat latent)."""
    return tuple(map(fn, cond)) if isinstance(cond, tuple) else fn(cond)


def _x_prev_from_eps(ddpm: DDPM, x, t, t_next, eps, noise):
    """x_start from eps -> clip -> q_posterior -> noisy step (t, t_next
    0-d tensors of x's type)."""
    sched = ddpm.schedule
    b = x.shape[0]
    tt, tn = t.expand(b), t_next.expand(b)
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


def plms_prologue(ddpm: DDPM, image: torch.Tensor, max_thres: torch.Tensor,
                  full_start: torch.Tensor, noise: torch.Tensor):
    """The q-sample of the clean latents to ``max_thres`` (a 0-d tensor):
    (the sampler's start, the clean latents where ``full_start``, else
    x_noisy; x_noisy; log_snr (B,))."""
    x_noisy, log_snr = ddpm.schedule.q_sample(
        image, max_thres.to(image.dtype), noise)
    return torch.where(full_start, image, x_noisy), x_noisy, log_snr


def plms_step0(ddpm: DDPM, eval_eps: Callable, x, t, t_next, noise1,
               noise2):
    """The pseudo improved-Euler step: (x at t_next, eps at t)."""
    e_t = eval_eps(x, t)
    x_prev1 = _x_prev_from_eps(ddpm, x, t, t_next, e_t, noise1)
    e_t_next = eval_eps(x_prev1, t_next)
    return _x_prev_from_eps(ddpm, x, t, t_next, (e_t + e_t_next) / 2,
                            noise2), e_t


def plms_tail_step(ddpm: DDPM, eval_eps: Callable, x, t, t_next, hist,
                   noise):
    """One later step, of the Adams-Bashforth order ``len(hist) + 1``
    (hist: the 1-3 most recent earlier epsilons, newest first): (x at
    t_next, eps at t)."""
    e_t = eval_eps(x, t)
    return _x_prev_from_eps(ddpm, x, t, t_next, _adams_bashforth(e_t, hist),
                            noise), e_t


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
    _, n_steps, _ = host_schedule(max_thres, plms_steps)
    draw = _Draws(noises, generator)
    mt = torch.full((), float(max_thres), dtype=torch.float64,
                    device=image.device)
    full_start, times = plms_schedule(mt, plms_steps)
    eval_eps = eps_fn(ddpm, denoise_fn, cond_images, cond_scale)

    init_noise = draw(image)
    img, x_noisy, log_snr = plms_prologue(ddpm, image, mt, full_start,
                                          init_noise)
    hist = []
    if n_steps > 0:
        noise1, noise2 = draw(img), draw(img)
        img, e_t = plms_step0(ddpm, eval_eps, img, times[0], times[1],
                              noise1, noise2)
        hist = [e_t]
    for i in range(1, n_steps):
        img, e_t = plms_tail_step(ddpm, eval_eps, img, times[i],
                                  times[i + 1], hist, draw(img))
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
