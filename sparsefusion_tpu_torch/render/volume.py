"""NGP volume renderer: stratified + importance sampling, fixed shapes.

Counterpart of ``sparsefusion_tpu/render/volume.py``:

* slab-test near/far against the [-bound, bound]^3 box, min_near
  clamping, misses -> (1e10, 1e10),
* num_steps stratified z values (optionally jittered), a field eval,
  importance re-sampling of upsample_steps more by inverse CDF on the
  detached weights, a merge sort of both sets and one alpha composite;
  or, with ``march_steps > 0``, a single pass of march_steps samples.

Random draws: jax.random streams cannot be replayed in torch, so every
function that draws takes its draws as optional tensors and otherwise
draws them from its ``torch.Generator``: ``jitter`` (N, num_steps or
march_steps) uniforms for the stratified offsets and ``u`` (N,
upsample_steps) uniforms for the inverse CDF.

Rays may carry leading axes: (S, N, 3) rays of S scenes (the port of the
JAX scene-batched loop's ``vmap`` over the renderer) go to the field as
(S, P, 3) points, one field evaluation for all S scenes, with draws (S,
N, ...); the chunked renderer cuts its chunks along N.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.utils.checkpoint


@dataclasses.dataclass(frozen=True)
class VolumeRendererConfig:
    num_steps: int = 64
    upsample_steps: int = 64
    bound: float = 4.0
    min_near: float = 0.1
    density_thresh: float = 10.0
    max_ray_batch: int = 4096
    march_steps: int = 0


_MISS = 1e10


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       bound: float, min_near: float = 0.1):
    """Slab intersection with the cube [-bound, bound]^3 -> (near, far),
    each of the rays' leading shape."""
    inv_d = 1.0 / rays_d
    t0 = (-bound - rays_o) * inv_d
    t1 = (bound - rays_o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    near = torch.where(miss, torch.full_like(near, _MISS), near)
    far = torch.where(miss, torch.full_like(far, _MISS), far)
    return near, far


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool, u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling: bins (N, T) edges, weights (N, T-1) ->
    (N, n_samples) new z values.  ``u`` (N, n_samples) are the uniforms
    when not ``det``; drawn from ``generator`` when not given."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    shape = (*cdf.shape[:-1], n_samples)
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           device=cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    bins_lo = torch.gather(bins, -1, below)
    bins_hi = torch.gather(bins, -1, above)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bins_lo + t * (bins_hi - bins_lo)


def _composite(sigmas: torch.Tensor, z_vals: torch.Tensor,
               sample_dist: torch.Tensor):
    """Alpha compositing. Returns (weights, weights_sum)."""
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, sample_dist.expand_as(deltas[..., :1])],
                       dim=-1)
    alphas = 1.0 - torch.exp(-deltas * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                         1.0 - alphas + 1e-15], dim=-1)
    weights = alphas * torch.cumprod(shifted, dim=-1)[..., :-1]
    return weights, weights.sum(dim=-1)


def _draw(shape, draws: Optional[torch.Tensor], generator, device):
    if draws is not None:
        if tuple(draws.shape) != tuple(shape):
            raise ValueError(f"draws {tuple(draws.shape)} != {tuple(shape)}")
        return draws.to(device)
    return torch.rand(shape, generator=generator, device=device)


def render_rays(field_fn: Callable, rays_o: torch.Tensor,
                rays_d: torch.Tensor, cfg: VolumeRendererConfig,
                perturb: bool = False, det_importance: bool = False,
                bg_color: float = 0.0,
                near_far_fn: Optional[Callable] = None,
                bg_fn: Optional[Callable] = None,
                generator: Optional[torch.Generator] = None,
                jitter: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None):
    """Render a flat batch of rays, or S scenes' batches.

    Args:
        field_fn: (P, 3) -> (sigma (P,), albedo (P, 3)); for S scenes
            (S, P, 3) -> ((S, P), (S, P, 3)).
        rays_o, rays_d: (N, 3) world rays, or (S, N, 3).
        jitter: (N, steps) stratified uniforms, used if ``perturb``
            ((S, N, steps) for S scenes, and so ``u``).
        u: (N, upsample_steps) importance uniforms, used if not
            ``det_importance``.
        generator: draws whichever of ``jitter`` / ``u`` is needed and
            not given.

    Returns:
        dict(image (N,3), depth (N,), weights_sum (N,), mask (N,)), each
        with the rays' leading scene axis.
    """
    n = rays_o.shape[:-1]                  # (N,) or (S, N)
    dev = rays_o.device
    nears, fars = near_far_from_aabb(rays_o, rays_d, cfg.bound, cfg.min_near)
    if near_far_fn is not None:
        nears, fars = near_far_fn(rays_o, rays_d, nears, fars)
    nears_c = nears[..., None]
    fars_c = fars[..., None]

    def pts(zv):
        """The field's (P, 3) points, (S, P, 3) for S scenes."""
        p = rays_o[..., None, :] + rays_d[..., None, :] * zv[..., None]
        return torch.clamp(p, -cfg.bound, cfg.bound).reshape(*n[:-1], -1, 3)

    steps = cfg.march_steps if cfg.march_steps > 0 else cfg.num_steps
    sample_dist = (fars_c - nears_c) / steps
    z = torch.linspace(0.0, 1.0, steps, device=dev)
    z_vals = nears_c + (fars_c - nears_c) * z
    if perturb:
        z_vals = z_vals + (_draw((*n, steps), jitter, generator, dev) - 0.5) \
            * sample_dist

    sigma1, rgb1 = field_fn(pts(z_vals))
    sigma1 = sigma1.reshape(*n, steps)
    rgb1 = rgb1.reshape(*n, steps, 3)

    if cfg.march_steps == 0 and cfg.upsample_steps > 0:
        # importance sampling on the detached first-pass weights
        w_det, _ = _composite(sigma1.detach(), z_vals, sample_dist)
        deltas = z_vals[..., 1:] - z_vals[..., :-1]
        z_mid = z_vals[..., :-1] + 0.5 * deltas
        uu = None if det_importance else _draw(
            (*n, cfg.upsample_steps), u, generator, dev)
        new_z = sample_pdf(z_mid, w_det[..., 1:-1], cfg.upsample_steps,
                           det=det_importance, u=uu).detach()

        sigma2, rgb2 = field_fn(pts(new_z))
        sigma2 = sigma2.reshape(*n, cfg.upsample_steps)
        rgb2 = rgb2.reshape(*n, cfg.upsample_steps, 3)

        z_all = torch.cat([z_vals, new_z], dim=-1)
        z_vals, order = torch.sort(z_all, dim=-1, stable=True)
        sigmas = torch.gather(torch.cat([sigma1, sigma2], dim=-1), -1, order)
        # composite in sorted order, then bring the weights back to the
        # unsorted sample order instead of gathering the (N, T, 3) rgb
        weights, weights_sum = _composite(sigmas, z_vals, sample_dist)
        inv_order = torch.argsort(order, dim=-1)
        w_unsorted = torch.gather(weights, -1, inv_order)
        rgbs = torch.cat([rgb1, rgb2], dim=-2)
        image = (w_unsorted[..., None] * rgbs).sum(dim=-2)
    else:
        weights, weights_sum = _composite(sigma1, z_vals, sample_dist)
        image = (weights[..., None] * rgb1).sum(dim=-2)

    ori_z = torch.clamp((z_vals - nears_c) / (fars_c - nears_c), 0.0, 1.0)
    depth = (weights * ori_z).sum(dim=-1)
    if bg_fn is not None:
        bg_color = bg_fn(rays_d)
    image = image + (1.0 - weights_sum)[..., None] * bg_color

    return {
        "image": image,
        "depth": depth,
        "weights_sum": weights_sum,
        "mask": nears < fars,
    }


def render_rays_chunked(field_fn: Callable, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, cfg: VolumeRendererConfig,
                        perturb: bool = False, det_importance: bool = True,
                        bg_color: float = 0.0, remat: bool = False,
                        near_far_fn: Optional[Callable] = None,
                        bg_fn: Optional[Callable] = None,
                        generator: Optional[torch.Generator] = None,
                        jitter: Optional[torch.Tensor] = None,
                        u: Optional[torch.Tensor] = None):
    """Render in ``max_ray_batch`` chunks (of each scene's rays, for (S,
    N, 3) rays: a chunk is one field evaluation over all S scenes).

    All draws for all rays are made up front (or taken from ``jitter`` /
    ``u``, each (N, ...) or (S, N, ...)), so a chunk gets the same numbers
    whether it is run once or, with ``remat=True``, recomputed by
    ``torch.utils.checkpoint`` in the backward pass, which then keeps one
    chunk's field-eval activations alive at a time instead of all.
    """
    lead = rays_o.shape[:-2]               # () or (S,)
    n = rays_o.shape[-2]
    dev = rays_o.device
    chunk = min(cfg.max_ray_batch, n)
    if n % chunk:
        raise ValueError(f"{n} rays are not a multiple of the chunk {chunk}")
    steps = cfg.march_steps if cfg.march_steps > 0 else cfg.num_steps
    if perturb:
        jitter = _draw((*lead, n, steps), jitter, generator, dev)
    else:
        jitter = None
    if cfg.march_steps == 0 and cfg.upsample_steps > 0 and not det_importance:
        u = _draw((*lead, n, cfg.upsample_steps), u, generator, dev)
    else:
        u = None

    def body(o, d, jit, uu):
        return render_rays(field_fn, o, d, cfg, perturb, det_importance,
                           bg_color, near_far_fn, bg_fn, jitter=jit, u=uu)

    outs = []
    for s in range(0, n, chunk):
        sl = (..., slice(s, s + chunk), slice(None))
        args = (rays_o[sl], rays_d[sl],
                None if jitter is None else jitter[sl],
                None if u is None else u[sl])
        if remat and torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(
                body, *args, use_reentrant=False))
        else:
            outs.append(body(*args))
    return {k: torch.cat([o[k] for o in outs], dim=len(lead))
            for k in outs[0]}
