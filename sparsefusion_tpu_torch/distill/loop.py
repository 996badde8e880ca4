"""Per-scene diffusion distillation: EFT cache -> NGP optimization -> eval.

Counterpart of ``sparsefusion_tpu/distill/loop.py``:

* Phase A — feature cache: the EFT renders a 256-d feature image and an
  RGB image for each of the scene's cameras and ``n_aug_cameras`` orbit
  cameras, at ``image_size / eft_scale``.
* Phase B — ``max_itr`` iterations of two optimizer steps each: an
  input-view photometric step (render at H/2, huber color + silhouette +
  opacity loss), then a bootstrap step against a cached EFT image
  (iterations up to ``start_fusion_step``) or a fusion step: render ->
  VAE encode -> partial-noise PLMS through the UNet -> VAE decode ->
  (1 - alpha) weighted L1 against the render.  The sampler runs without
  gradient, as in the reference.
* Phase C — eval: full-resolution renders of every scene camera,
  PSNR/SSIM, an orbit of ``n_aug_cameras`` renders, outputs saved.

With ``use_occupancy`` (the TPU preset, :func:`tpu_distill_config`) every
render's [near, far] is tightened to the occupied span of an occupancy
grid (``render/occupancy.py``), all-occupied until ``occupancy_start``
and then updated every ``occupancy_update_every`` iterations, before the
iteration's steps.  With ``occ_march_steps`` the renders switch at
``occupancy_start`` to a single pass of that many samples, and back to
two-phase sampling from ``polish_start``; Phase C renders in the mode of
the last iteration.  With ``fusion_rays`` below ``render_hw^2`` the
fusion step renders the full image without gradient for the sampler and
takes its gradient on ``fusion_rays`` random rays against the bilinearly
downsampled target.  Without it the fusion step renders once and feeds
a detached copy to the VAE; the JAX package renders twice with one key,
which gives the same image, loss and gradients.  ``sampler_bf16`` runs
the sampler's UNet in bf16 on a bf16 copy of its weights
(``models.py::SparseFusionModels.unet_half``); the sampler's own
arithmetic, the VAE and the EFT stay f32, as in the JAX package.  With an
``lpips_fn`` (``nn/lpips.py::build_lpips_fn``) and ``lambda_percep > 0``
the fusion loss adds ``lambda_percep`` times the LPIPS distance of the
render to its target, its gradient through the render, and the fusion
step renders the full grid (``fusion_rays`` is then not used, as in the
JAX package); Phase C adds an ``lpips`` column.  The steps also run S
scenes at once on an ``NGPFieldStack`` (``distill/batched.py``).

Every iteration runs as the JAX loop's fused programs
(``distill/fused.py``): an input step, a bootstrap iteration, or a
fusion iteration's front, PLMS step 0, PLMS tail steps and back, built
from this module's step pieces.  The JAX package's dispatch option
``fused_steps`` says only whether they are captured: on a CUDA device
each is captured once into a CUDA graph and replayed, unless it is
False (``--no_fused``), which runs the same programs uncaptured, as
every run is on the CPU.  The sampler in them is the counterpart of
``plms_sample_host`` with ``scan_tail``, which ``plms_host_loop`` and
``plms_scan_tail`` select in the JAX package; the port's sampler
(``diffusion/plms.py::plms_sample``) is that loop too, so those two
options change nothing here.  ``loss_fetch_every`` sets how often the
losses, kept on the device, are read: in one copy every that many
iterations, at ``eval_every`` and at the end.

The span recorder (``utils/spans.py``) times the loop: Phase A is the
set-up span ``phase_a``; each iteration is the unit
``distill/iteration``, which holds the occupancy update
(``occupancy_update``), the programs (``graph/<key>`` as graphs), the
loss reads (``loss_read``, where the recorder reads its device stamps)
and, inside the steps, the renders (``render``), the backward of the
field's loss (``render_bwd``: the MLP's and K1's backward and, under
``remat``, the renders' recomputed forward), the field's Adam
(``ngp_adam``) and the models' ``unet``, ``vae_encode`` and
``vae_decode``.  The result's ``spans`` are the recorder's spans of the
call (units only while recording: :func:`spans.enable` or a profiler).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sparsefusion_tpu_torch.core.cameras import (
    Cameras,
    camera_centers,
    concat_cameras,
    get_camera_slice,
    get_relative_cameras,
)
from sparsefusion_tpu_torch.core.paths import get_interpolated_path
from sparsefusion_tpu_torch.core.rays import grid_ray_bundle
from sparsefusion_tpu_torch.data.contract import SceneData
from sparsefusion_tpu_torch.diffusion.plms import cond_map, plms_sample
from sparsefusion_tpu_torch.distill.fused import FusedIterations
from sparsefusion_tpu_torch.nn.ngp import (
    NGPConfig,
    NGPField,
    NGPFieldStack,
    export_jax_params,
)
from sparsefusion_tpu_torch.ops.image import resize_bilinear, resize_nearest
from sparsefusion_tpu_torch.render.lightfield import render_light_field
from sparsefusion_tpu_torch.render.occupancy import (
    OccupancyGrid,
    cascade_count,
    occupancy_near_far,
)
from sparsefusion_tpu_torch.render.volume import (
    VolumeRendererConfig,
    render_rays_chunked,
)
from sparsefusion_tpu_torch.utils import spans
from sparsefusion_tpu_torch.utils.graphs import TensorStepLR
from sparsefusion_tpu_torch.utils.image import huber, to_uint8
from sparsefusion_tpu_torch.utils.metrics import psnr, ssim

# the occupancy grid's cells a side (OccupancyGrid's default, which the
# JAX loop uses)
OCC_GRID_SIZE = 128


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Same fields and defaults as the JAX ``DistillConfig``."""

    max_itr: int = 3000
    start_fusion_step: int = 1000
    lambda_color: float = 1.0
    lambda_sil: float = 1.0
    lambda_opacity: float = 1e-3
    lambda_entropy: float = 0.0
    lambda_percep: float = 0.1
    lr: float = 5e-4
    # the reference's StepLR(3000) ticks once per iteration over two
    # optimizer updates per iteration; the schedule here ticks once per
    # optimizer update, hence 6000
    lr_decay_step: int = 6000
    lr_decay_gamma: float = 0.2
    hw_scale: int = 2
    eft_scale: int = 8
    eft_n_pts: int = 20
    n_aug_cameras: int = 50
    theta_offset_max: float = 0.17
    bound: float = 4.0
    min_near: float = 0.1
    num_steps: int = 64
    upsample_steps: int = 64
    max_ray_batch: int = 4096
    plms_steps: int = 50
    cond_scale: float = 1.0
    plms_host_loop: Optional[bool] = None
    plms_scan_tail: Optional[bool] = None
    sampler_bf16: bool = False
    eval_every: int = 0
    ngp: NGPConfig = NGPConfig()
    use_occupancy: bool = False
    occupancy_start: int = 500
    occupancy_update_every: int = 16
    occupancy_probe: int = 64
    occ_march_steps: Optional[int] = None
    polish_start: Optional[int] = None
    # read the losses from the device every this many iterations
    loss_fetch_every: int = 20
    density_thresh: float = 10.0
    # input steps on a uniform random subset of the render_hw^2 rays
    # (with replacement); None = the full grid
    input_rays: Optional[int] = None
    fusion_rays: Optional[int] = None
    # recompute each render chunk in the backward pass instead of keeping
    # every chunk's activations (torch.utils.checkpoint)
    remat: bool = True
    # the fused programs of distill/fused.py captured as CUDA graphs on a
    # CUDA device (None or True); False: run uncaptured
    fused_steps: Optional[bool] = None

    def __post_init__(self):
        for name in ("input_rays", "fusion_rays"):
            v = getattr(self, name)
            if v and v > self.max_ray_batch \
                    and v % self.max_ray_batch != 0:
                raise ValueError(
                    f"{name}={v} exceeds max_ray_batch="
                    f"{self.max_ray_batch} but is not a multiple of it; "
                    "the chunked renderer needs equal chunks — use a "
                    f"multiple of {self.max_ray_batch} or raise "
                    "max_ray_batch")


def tpu_distill_config(**overrides) -> DistillConfig:
    """The JAX package's TPU preset, under the same name and with the same
    fields: 8 x C4 tables read in bf16, occupancy-guided 32+32 two-phase
    sampling until ``occupancy_start``, then single-pass 32-sample
    marching inside the occupied span, one 16,384-ray chunk, stored render
    activations instead of recomputing them (``remat=False``), 4096-ray
    input and bootstrap steps, and fusion gradient steps on 4096 rays.
    Its speed on the card against ``DistillConfig()`` is in PERF.md."""
    base = dict(
        ngp=NGPConfig(num_levels=8, level_dim=4, table_dtype="bfloat16"),
        use_occupancy=True,
        num_steps=32,
        upsample_steps=32,
        occ_march_steps=32,
        max_ray_batch=16384,
        input_rays=4096,
        fusion_rays=4096,
        remat=False,
        plms_scan_tail=True,
        sampler_bf16=False,
    )
    base.update(overrides)
    return DistillConfig(**base)


class NGPOptimizer:
    """Adam with 10x lr on the grid table and a staircase decay that ticks
    once per optimizer update (the JAX package's optax chain).

    On a CUDA field the update can be captured in a CUDA graph
    (``distill/fused.py``): Adam runs with ``capturable=True`` on 0-d
    learning-rate tensors, which :class:`TensorStepLR` ticks on the
    device.  On the CPU the rates are floats under ``StepLR``."""

    def __init__(self, field: NGPField, cfg: DistillConfig):
        mlp = [p for n, p in field.named_parameters() if n != "grid"]
        rates = (cfg.lr * 10, cfg.lr)
        self.capturable = field.grid.is_cuda
        if self.capturable:
            self.schedule = TensorStepLR(rates, cfg.lr_decay_step,
                                         cfg.lr_decay_gamma,
                                         field.grid.device)
            rates = self.schedule.lrs
        self.adam = torch.optim.Adam(
            [{"params": [field.grid], "lr": rates[0]},
             {"params": mlp, "lr": rates[1]}],
            betas=(0.9, 0.999), eps=1e-8, capturable=self.capturable)
        if not self.capturable:
            self.schedule = torch.optim.lr_scheduler.StepLR(
                self.adam, step_size=cfg.lr_decay_step,
                gamma=cfg.lr_decay_gamma)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        with spans.span("ngp_adam"):
            self.adam.step()
            self.schedule.step()


def make_ngp_optimizer(cfg: DistillConfig, field: NGPField) -> NGPOptimizer:
    return NGPOptimizer(field, cfg)


def _scene_axis(field) -> tuple:
    """(S,) for an :class:`NGPFieldStack` of S scenes, () for a field."""
    return (field.n_scenes,) if isinstance(field, NGPFieldStack) else ()


def _render_cam(field: NGPField, cam: Cameras, hw: int,
                vcfg: VolumeRendererConfig, perturb: bool,
                generator: Optional[torch.Generator] = None,
                ray_idx: Optional[torch.Tensor] = None, remat: bool = True,
                jitter: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None, near_far_fn=None):
    """Render a camera; with ``ray_idx`` (K,) only those grid rays.
    ``jitter`` / ``u`` are the renderer's draws for the rays rendered;
    ``near_far_fn`` tightens each ray's [near, far].  An
    :class:`NGPFieldStack` renders S cameras, one a scene, in one pass:
    everything gains a leading S axis (``ray_idx`` (S, K))."""
    lead = _scene_axis(field)
    bundle = grid_ray_bundle(cam, hw, hw, 2, 1.0, 2.0)
    o = _at_rays(bundle.origins.reshape(*lead, -1, 3), ray_idx)
    d = _at_rays(bundle.directions.reshape(*lead, -1, 3), ray_idx)
    bg_fn = field.background if field.config.bg_radius > 0 else None
    out = render_rays_chunked(field, o, d, vcfg, perturb=perturb,
                              det_importance=False, bg_color=0.0,
                              remat=remat, bg_fn=bg_fn, generator=generator,
                              jitter=jitter, u=u, near_far_fn=near_far_fn)
    if ray_idx is not None:
        return out["image"], out["weights_sum"][..., None]
    return (out["image"].reshape(*lead, hw, hw, 3),
            out["weights_sum"].reshape(*lead, hw, hw, 1))


def _at_rays(img_hw: torch.Tensor, ray_idx: Optional[torch.Tensor]):
    """The rows ``ray_idx`` (K,) of an image's pixels, (K, C); with a
    scene axis, (S, K) of (S, H, W, C) -> (S, K, C)."""
    if ray_idx is None:
        return img_hw
    flat = img_hw.reshape(*ray_idx.shape[:-1], -1, img_hw.shape[-1])
    return torch.gather(flat, -2, ray_idx.long()[..., None].expand(
        *ray_idx.shape, flat.shape[-1]))


class SceneSteps:
    """The per-scene step functions of the loop.

    ``field`` is one scene's :class:`NGPField`, or the
    :class:`NGPFieldStack` of S scenes the batched loop optimises in
    lockstep.  With a stack every step takes S cameras (one a scene),
    targets, features and draws with a leading S axis, and one
    ``max_thres`` for all S; each loss is then (S,), every scene's own,
    and the optimizer steps on their sum, which gives each scene its own
    gradient, as ``jax.vmap`` does (a mean would scale them by 1 / S).

    ``draws`` is an optional dict with the random numbers a step would
    otherwise take from its generator: ``ray_idx`` (input_rays,) when the
    step renders a ray subset, ``jitter`` (K, steps) and ``u`` (K,
    upsample_steps) for the K rays rendered, and for the fusion step
    ``plms_noise``, the sampler's normal draws in the order
    ``diffusion/plms.py`` takes them; the subsampled fusion step's
    gradient render takes ``fusion_ray_idx`` (fusion_rays,),
    ``fusion_jitter`` and ``fusion_u``.  ``bitfield`` is the occupancy
    grid's (``render/occupancy.py``); with ``cfg.use_occupancy`` every
    render tightens its rays' [near, far] to the occupied span.
    ``models`` (the EFT/VAE/UNet bundle) is needed by the fusion step
    only.  ``lpips_fn`` ((B, H, W, 3) images in [0, 1], twice -> (B,)),
    with ``cfg.lambda_percep > 0``, adds the perceptual term to the
    fusion loss and turns the subsampled fusion step off, as in the JAX
    package.
    """

    def __init__(self, field: NGPField, cfg: DistillConfig,
                 optimizer: NGPOptimizer, render_hw: int, image_size: int,
                 models=None, lpips_fn=None):
        self.field = field
        self.cfg = cfg
        self.optimizer = optimizer
        self.render_hw = render_hw
        self.image_size = image_size
        self.models = models
        self.lpips_fn = lpips_fn
        self.scene_axis = _scene_axis(field)
        self.occ_cascade = cascade_count(cfg.bound)
        self.use_percep = lpips_fn is not None and cfg.lambda_percep > 0
        self.subsample_fusion = bool(cfg.fusion_rays) \
            and not self.use_percep \
            and cfg.fusion_rays < render_hw * render_hw

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over all but the scene axis: a scalar, or (S,)."""
        if not self.scene_axis:
            return x.mean()
        return x.reshape(*self.scene_axis, -1).mean(-1)

    def _opacity(self, sil: torch.Tensor) -> torch.Tensor:
        return self._mean(torch.sqrt(sil ** 2 + 0.01))

    def _batch(self, img: torch.Tensor) -> torch.Tensor:
        """An image (H, W, C) as a batch of one; S scenes' (S, H, W, C)
        as they are."""
        return img if self.scene_axis else img[None]

    def _unbatch(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.scene_axis else x[0]

    def _resize(self, resize, img: torch.Tensor, size) -> torch.Tensor:
        return self._unbatch(resize(self._batch(img), size))

    def make_nff(self, bitfield: Optional[torch.Tensor]):
        """The renderer's near/far hook for ``bitfield``, or None."""
        cfg = self.cfg
        if not cfg.use_occupancy or bitfield is None:
            return None
        return lambda o, d, n, f: occupancy_near_far(
            bitfield, o, d, n, f, cfg.bound, OCC_GRID_SIZE,
            self.occ_cascade, cfg.occupancy_probe)[:2]

    def _ray_subset(self, generator, draws, n_rays, key="ray_idx"):
        hw = self.render_hw
        if not n_rays or n_rays >= hw * hw:
            return None
        if key in draws:
            return draws[key].to(self.field.grid.device)
        return torch.randint(0, hw * hw, (*self.scene_axis, n_rays),
                             generator=generator,
                             device=self.field.grid.device)

    def input_losses(self, vc: VolumeRendererConfig, cam: Cameras,
                     gt_rgb: torch.Tensor, gt_mask: Optional[torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None,
                     bitfield: Optional[torch.Tensor] = None):
        cfg, hw = self.cfg, self.render_hw
        draws = draws or {}
        ray_idx = self._ray_subset(generator, draws, cfg.input_rays)
        img, sil = self._render(vc, cam, generator, draws, ray_idx, bitfield)
        gt_rgb_ds = self._resize(resize_nearest, gt_rgb, (hw, hw))
        loss = cfg.lambda_color * self._mean(huber(
            img, _at_rays(gt_rgb_ds, ray_idx)).abs())
        if gt_mask is not None:
            gt_mask_ds = self._resize(resize_nearest, gt_mask, (hw, hw))
            loss = loss + cfg.lambda_sil * self._mean(huber(
                sil, _at_rays(gt_mask_ds, ray_idx)).abs())
        if cfg.lambda_opacity > 0:
            loss = loss + cfg.lambda_opacity * self._opacity(sil)
        return loss

    def _render(self, vc, cam, generator, draws, ray_idx=None, bitfield=None):
        with spans.span("render"):
            return _render_cam(self.field, cam, self.render_hw, vc,
                               perturb=True, generator=generator,
                               ray_idx=ray_idx, remat=self.cfg.remat,
                               jitter=draws.get("jitter"), u=draws.get("u"),
                               near_far_fn=self.make_nff(bitfield))

    def update(self, losses_fn, *args, **kwargs) -> torch.Tensor:
        """Loss, gradient and Adam update, in place on the field's
        parameters (the gradient of the sum of S scenes' losses).
        Returns the (detached) loss."""
        self.optimizer.zero_grad()
        return self.apply_update(losses_fn(*args, **kwargs))

    def apply_update(self, loss: torch.Tensor,
                     retain_graph: bool = False) -> torch.Tensor:
        """The gradient of ``loss`` (summed) and the Adam update, after a
        ``optimizer.zero_grad()`` before the loss's forward pass; returns
        the detached loss."""
        with spans.span("render_bwd"):
            loss.sum().backward(retain_graph=retain_graph)
        self.optimizer.step()
        return loss.detach()

    def input_step(self, vc: VolumeRendererConfig, cam: Cameras,
                   gt_rgb: torch.Tensor, gt_mask: Optional[torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   bitfield: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.update(self.input_losses, vc, cam, gt_rgb, gt_mask,
                            generator, draws, bitfield)

    def render_up(self, vc, cam, generator=None, draws=None, bitfield=None):
        """Full-grid render at render_hw, bilinearly upsampled to
        image_size: image (H, W, 3) and silhouette (H, W, 1)."""
        img, sil = self._render(vc, cam, generator, draws or {},
                                bitfield=bitfield)
        size = (self.image_size, self.image_size)
        return (self._resize(resize_bilinear, img, size),
                self._resize(resize_bilinear, sil, size))

    def bootstrap_losses(self, vc, cam, eft_img, generator=None, draws=None,
                         bitfield=None):
        """Photometric loss against a cached EFT image, with its
        thresholded mean as the silhouette target."""
        cfg, hw = self.cfg, self.render_hw
        draws = draws or {}
        if cfg.input_rays:
            # ray subset: compare at render_hw with the downsampled target
            ray_idx = self._ray_subset(generator, draws, cfg.input_rays)
            img, sil = self._render(vc, cam, generator, draws, ray_idx,
                                    bitfield)
            eft_ds = self._resize(resize_bilinear, eft_img, (hw, hw))
            target = _at_rays(eft_ds, ray_idx)
        else:
            img, sil = self.render_up(vc, cam, generator, draws, bitfield)
            target = eft_img
        noisy_mask = (target.mean(dim=-1, keepdim=True) > 0.1).float()
        return (cfg.lambda_color * self._mean(huber(img, target).abs())
                + cfg.lambda_sil * self._mean(huber(sil, noisy_mask).abs())
                + cfg.lambda_opacity * self._opacity(sil))

    def bootstrap_step(self, vc, cam, eft_img, generator=None, draws=None,
                       bitfield=None):
        return self.update(self.bootstrap_losses, vc, cam, eft_img,
                            generator, draws, bitfield)

    @torch.no_grad()
    def fusion_target(self, img: torch.Tensor, features: torch.Tensor,
                      max_thres: float, generator=None, plms_noise=None):
        """The diffusion target of a render (H, W, 3): VAE encode,
        partial-noise PLMS conditioned on ``features`` (256, h, w), or a
        tuple of the prior's conditioning tensors, VAE decode.  Returns
        (target image (H, W, 3), fusion weight = 1 - alpha_cumprod at
        max_thres).  S scenes' renders and features
        go through one encode, one PLMS chain at batch S (one step count:
        ``max_thres`` is shared) and one decode; the weight is then (S,)."""
        models, cfg = self.models, self.cfg
        latents = models.vae_encode(self._batch(img))
        pred_x0, _, _, alpha_cumprod = plms_sample(
            models.ddpm, functools.partial(models.denoise_fn,
                                           bf16=cfg.sampler_bf16),
            latents, max_thres,
            cond_images=cond_map(self._batch, features),
            cond_scale=cfg.cond_scale,
            plms_steps=cfg.plms_steps, generator=generator,
            noises=plms_noise)
        return (self._unbatch(models.vae_decode(pred_x0)),
                self._unbatch(1.0 - alpha_cumprod))

    def fusion_losses(self, vc, cam, features, max_thres, generator=None,
                      draws=None, bitfield=None):
        """The fusion step's loss.  Without ray subsampling: render once
        with gradient and feed the detached copy to :meth:`fusion_target`
        (the reference samples without gradient).  With it: the full
        render without gradient feeds the sampler, and
        :meth:`fusion_subset_losses` takes the gradient on a ray subset.
        With the perceptual term, ``lambda_percep`` times the LPIPS
        distance of the render to the target joins the loss."""
        draws = draws or {}
        if self.subsample_fusion:
            with torch.no_grad():
                img, _ = self.render_up(vc, cam, generator, draws, bitfield)
            pred_img, weight = self.fusion_target(
                img, features, max_thres, generator, draws.get("plms_noise"))
            return self.fusion_subset_losses(vc, cam, pred_img, weight,
                                             generator, draws, bitfield)
        img, sil = self.render_up(vc, cam, generator, draws, bitfield)
        pred_img, weight = self.fusion_target(
            img.detach(), features, max_thres, generator,
            draws.get("plms_noise"))
        return self.fusion_full_losses(img, sil, pred_img, weight)

    def fusion_full_losses(self, img, sil, pred_img, weight):
        """The full-grid fusion loss of a render (image and silhouette)
        against its target ``pred_img`` at ``weight``."""
        loss = weight * self._mean((img - pred_img).abs())
        if self.use_percep:
            loss = loss + self.cfg.lambda_percep * self._mean(self.lpips_fn(
                self._batch(img), self._batch(pred_img)))
        return loss + self.cfg.lambda_opacity * self._opacity(sil)

    def fusion_subset_losses(self, vc, cam, pred_img, weight, generator=None,
                             draws=None, bitfield=None):
        """The subsampled fusion gradient step's loss: ``fusion_rays``
        random rays of the render_hw grid (with replacement) against the
        target ``pred_img`` (H, W, 3) bilinearly resized to render_hw, at
        those rays.  Draws: ``fusion_ray_idx``, ``fusion_jitter``,
        ``fusion_u``."""
        cfg, hw = self.cfg, self.render_hw
        draws = draws or {}
        ray_idx = self._ray_subset(generator, draws, cfg.fusion_rays,
                                   "fusion_ray_idx")
        img, sil = self._render(vc, cam, generator,
                                {"jitter": draws.get("fusion_jitter"),
                                 "u": draws.get("fusion_u")},
                                ray_idx, bitfield)
        pred_ds = self._resize(resize_bilinear, pred_img, (hw, hw))
        return (weight * self._mean((img - _at_rays(pred_ds, ray_idx)).abs())
                + cfg.lambda_opacity * self._opacity(sil))

    def fusion_step(self, vc, cam, features, max_thres, generator=None,
                    draws=None, bitfield=None):
        return self.update(self.fusion_losses, vc, cam, features,
                            max_thres, generator, draws, bitfield)


def make_scene_step_fns(field: NGPField, cfg: DistillConfig,
                        optimizer: NGPOptimizer, render_hw: int,
                        image_size: int, lpips_fn=None,
                        models=None) -> SceneSteps:
    """The per-scene steps (input, bootstrap and, with ``models``, fusion;
    with ``lpips_fn``, the fusion loss's perceptual term)."""
    return SceneSteps(field, cfg, optimizer, render_hw, image_size, models,
                      lpips_fn)


def render_schedule(cfg: DistillConfig, vcfg: VolumeRendererConfig):
    """``active_vcfg(itr)`` of the JAX loop: the render config of
    iteration ``itr`` (``max_itr`` for Phase C).  Single-pass marching
    with ``occ_march_steps`` samples from ``occupancy_start`` on, when
    occupancy is used; two-phase sampling before that and from
    ``polish_start`` on."""
    march_on = bool(cfg.use_occupancy and cfg.occ_march_steps)
    vcfg_march = dataclasses.replace(
        vcfg, march_steps=int(cfg.occ_march_steps)) if march_on else vcfg

    def active_vcfg(itr: int) -> VolumeRendererConfig:
        if march_on and cfg.polish_start is not None \
                and itr >= cfg.polish_start:
            return vcfg
        return vcfg_march if (march_on and itr >= cfg.occupancy_start) \
            else vcfg

    return active_vcfg


def occupancy_update_due(cfg: DistillConfig, itr: int) -> bool:
    """Whether the occupancy grid is updated before iteration ``itr``."""
    return (cfg.use_occupancy and itr >= cfg.occupancy_start
            and (itr - cfg.occupancy_start) % cfg.occupancy_update_every == 0)


@torch.no_grad()
def _render_views(field, cams: Cameras, hw: int, vcfg, generator,
                  near_far_fn=None):
    imgs, sils = [], []
    for i in range(len(cams)):
        img, sil = _render_cam(field, get_camera_slice(cams, [i]), hw, vcfg,
                               perturb=True, generator=generator,
                               near_far_fn=near_far_fn)
        imgs.append(img.cpu().numpy())
        sils.append(sil.cpu().numpy())
    return np.stack(imgs), np.stack(sils)


def _scene_depth_range(cams: Cameras):
    dist = float(torch.linalg.norm(camera_centers(cams), dim=1).mean())
    return dist - 5.0, dist + 5.0


@torch.no_grad()
def build_feature_cache(models, scene_cameras: Cameras,
                        scene_rgb: torch.Tensor, input_idx, cfg: DistillConfig,
                        image_size: int) -> Dict[str, Any]:
    """Phase A: EFT feature (256, h, w) and RGB (H, W, 3) images for the
    scene's cameras and ``n_aug_cameras`` jittered orbit cameras, each in
    a frame centred on itself, with the input views as context.  The
    context images go through the ResNet trunk once.  The features are
    then the models' ``prior_conditioning`` of each camera: the EFT
    features for the VLDM, (token, concat latent) for Zero123."""
    eft_hw = image_size // cfg.eft_scale
    aug = get_interpolated_path(scene_cameras, n=cfg.n_aug_cameras,
                                theta_offset_max=cfg.theta_offset_max,
                                rng=np.random.RandomState(0))
    aug_all = concat_cameras([scene_cameras, aug])
    aug_rel = get_relative_cameras(aug_all, [0], center_at_origin=True)
    aug_vox = get_relative_cameras(aug_all, [0], center_at_origin=False)
    min_depth, max_depth = _scene_depth_range(scene_cameras)
    ctx_rgb = scene_rgb[input_idx]
    latent = models.eft_encode(ctx_rgb)
    feats, imgs = [], []
    for ci in range(len(aug_rel)):
        rel = get_relative_cameras(aug_rel, [ci], center_at_origin=True)
        ray_fn = models.eft_ray_fn(get_camera_slice(rel, input_idx),
                                   ctx_rgb, latent)
        rgb, feat = render_light_field(
            ray_fn, get_camera_slice(rel, [ci]), eft_hw, eft_hw, min_depth,
            max_depth, n_pts_per_ray=cfg.eft_n_pts, n_batches=16)
        imgs.append(resize_bilinear(rgb, (image_size, image_size),
                                    align_corners=False)[0])
        feats.append(feat[0].permute(2, 0, 1))
    # the sampler's conditioning: the EFT's (M, 256, h, w) features, or
    # the models' own of each cached camera (a tuple of (M, ...) tensors)
    features = models.prior_conditioning(torch.stack(feats), aug_all,
                                         scene_rgb, input_idx)
    return {"features": features,
            "eft_images": torch.stack(imgs),      # (M, H, W, 3)
            "cameras_vox": [get_camera_slice(aug_vox, [ci])
                            for ci in range(len(aug_vox))]}


def distillation_loop(
    models,
    scene: SceneData,
    input_idx,
    cfg: DistillConfig,
    generator: torch.Generator,
    save_dir: Optional[str] = None,
    use_diffusion: bool = True,
    verbose: bool = True,
    lpips_fn=None,
    iteration_hook: Optional[Callable[[int], None]] = None,
) -> Dict[str, Any]:
    """Optimize an NGP for one scene on the device of ``generator``, which
    makes every random draw; returns params, metrics, renders, the losses,
    the recorder's spans of the call (``spans``), the iterations by
    render mode, the subsampled fusion steps, the fused programs'
    captures and replays and, with ``cfg.use_occupancy``, the occupancy
    grid's updates.  ``models`` (the bundle of
    ``models.build_models``) is needed with ``use_diffusion`` only;
    ``lpips_fn`` adds the fusion loss's perceptual term and the Phase C
    ``lpips`` column.  ``iteration_hook`` is called with each iteration's
    index at its end, after its loss read if one is due and outside its
    unit span (a measurement's hook: a profiler window, a counter)."""
    if use_diffusion and models is None:
        raise ValueError("the diffusion arm needs the EFT/VAE/UNet models")
    device = generator.device
    first_span = spans.mark()
    spans.use_device(device, spans.SLOTS if models is None
                     else models.span_slots)
    image_size = scene.images.shape[1]
    render_hw = image_size // cfg.hw_scale

    scene_cameras = scene.cameras(device)
    scene_rgb = torch.as_tensor(scene.images, device=device)
    scene_mask = (torch.as_tensor(scene.masks, device=device)
                  if scene.masks is not None else None)
    scene_vox = get_relative_cameras(scene_cameras, [0],
                                     center_at_origin=False)
    vcfg = VolumeRendererConfig(
        num_steps=cfg.num_steps, upsample_steps=cfg.upsample_steps,
        bound=cfg.bound, min_near=cfg.min_near,
        max_ray_batch=cfg.max_ray_batch)
    active_vcfg = render_schedule(cfg, vcfg)
    input_idx = [int(i) for i in input_idx]

    # ---- Phase A: EFT feature cache -----------------------------------
    feature_cache = None
    if use_diffusion:
        with spans.setup_span("phase_a") as phase_a:
            feature_cache = build_feature_cache(models, scene_cameras,
                                                scene_rgb, input_idx, cfg,
                                                image_size)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if verbose:
            print(f"cached {len(feature_cache['cameras_vox'])} features in "
                  f"{(phase_a.t1 - phase_a.t0) * 1e-9:.1f}s")
    n_cache = 0 if feature_cache is None else len(
        feature_cache["cameras_vox"])

    # ---- Phase B: NGP optimization ------------------------------------
    field = NGPField(cfg.ngp, device=device, generator=generator)
    optimizer = make_ngp_optimizer(cfg, field)
    steps = make_scene_step_fns(field, cfg, optimizer, render_hw, image_size,
                                lpips_fn=lpips_fn, models=models)
    unet_evals0 = models.unet_evals if models is not None else 0

    occ_grid, bitfield = None, None
    occupancy = None
    if cfg.use_occupancy:
        occ_grid = OccupancyGrid(bound=cfg.bound, grid_size=OCC_GRID_SIZE,
                                 density_thresh=cfg.density_thresh,
                                 device=device)
        # one buffer for the loop: each grid update is copied into it,
        # so the fused programs' graphs read the new bitfield
        bitfield = occ_grid.full_bitfield()
        occupancy = {"update_itrs": [], "occupied_share": []}

    def occ_density_fn(pts):
        return field(pts)[0]

    # the programs gather the cached cameras from one (M,) Cameras
    cache = None if feature_cache is None else dict(
        feature_cache,
        cameras_vox=concat_cameras(feature_cache["cameras_vox"]))
    programs = FusedIterations(steps, generator, scene_vox, scene_rgb,
                               scene_mask, cache, bitfield)

    host_rng = np.random.RandomState(17)
    # the losses stay on the device and are read in one copy every
    # loss_fetch_every iterations, at eval_every and at the end
    loss_log = torch.zeros((2 if use_diffusion else 1, cfg.max_itr),
                           device=device)
    losses, fusion_losses = [], []
    fetch_every = max(1, int(cfg.loss_fetch_every))

    def drain(itr):
        with spans.span("loss_read"):
            read = loss_log[:, len(losses):itr + 1].tolist()
            spans.sync_point()
        losses.extend(read[0])
        if use_diffusion:
            fusion_losses.extend(read[1])

    render_modes = {"two_phase": 0, "march": 0}
    fusion_subset_steps = 0
    t_start = time.perf_counter()
    for itr in range(cfg.max_itr):
        with spans.unit("distill/iteration", itr):
            vc = active_vcfg(itr)
            render_modes["march" if vc.march_steps else "two_phase"] += 1
            # occupancy maintenance before the iteration's steps, eagerly,
            # as in the JAX loop
            if occupancy_update_due(cfg, itr):
                with spans.span("occupancy_update"):
                    occ_grid.update(occ_density_fn, generator)  # reads
                    bitfield.copy_(occ_grid.bitfield)
                occupancy["update_itrs"].append(itr)
                occupancy["occupied_share"].append(
                    _occupied_share(bitfield))
            # host draws in the JAX package's order: input view, then the
            # cached camera and the noise level
            bi = input_idx[host_rng.randint(len(input_idx))]
            ci = mt = None
            if use_diffusion:
                ci = int(host_rng.randint(n_cache))
                mt = min(float(host_rng.uniform()), 0.99)
            fusion = use_diffusion and itr > cfg.start_fusion_step
            fusion_subset_steps += int(fusion and steps.subsample_fusion)
            loss, floss = programs.iteration(itr, vc, bi, ci, mt, fusion)
            loss_log[0, itr].copy_(loss)
            if floss is not None:
                loss_log[1, itr].copy_(floss)
            if (itr + 1) % fetch_every == 0 or itr == cfg.max_itr - 1:
                drain(itr)
            if verbose and itr % 200 == 0 and losses:
                print(f"itr {itr:5d} loss {losses[-1]:.4f} "
                      f"({(itr + 1) / (time.perf_counter() - t_start):.2f}"
                      " it/s)")
            if (cfg.eval_every > 0 and save_dir is not None
                    and itr % cfg.eval_every == 0 and itr > 0):
                drain(itr)
                _save_intermediate(save_dir, scene.sequence_name, losses,
                                   fusion_losses)
        if iteration_hook is not None:
            iteration_hook(itr)

    # ---- Phase C: eval ------------------------------------------------
    # in the render mode of the last iteration, inside the occupied span
    result = evaluate_scene(field, scene, scene_vox, cfg,
                            active_vcfg(cfg.max_itr), generator,
                            steps.make_nff(bitfield), lpips_fn, verbose)
    result.update({
        "losses": losses,
        "fusion_losses": fusion_losses,
        # the UNet evaluations of this scene
        "unet_evals": (models.unet_evals - unet_evals0
                       if models is not None else 0),
        # the recorder's spans of this call: set-up (phase_a, the graphs'
        # warmup/<key> and capture/<key>) always, the iterations' while
        # recording (utils/spans.py)
        "spans": spans.snapshot(first_span),
        # the fused programs' graphs (false when uncaptured), warm-ups,
        # captures (key, iteration) and replays (distill/fused.py)
        "fused": programs.stats(),
        # with cfg.use_occupancy: the iterations before which the grid was
        # updated (each an ``occupancy_update`` span) and the occupied
        # share of the bitfield after it
        "occupancy": occupancy,
        # iterations by render mode (single-pass march or two-phase), and
        # the fusion steps that took their gradient on a ray subset
        "render_modes": render_modes,
        "fusion_subset_steps": fusion_subset_steps,
    })
    if save_dir is not None:
        _save_outputs(result, scene, feature_cache, save_dir, verbose)
    return result


def evaluate_scene(field: NGPField, scene: SceneData, scene_vox: Cameras,
                   cfg: DistillConfig, vcfg_eval: VolumeRendererConfig,
                   generator: torch.Generator, near_far_fn=None,
                   lpips_fn=None, verbose: bool = True) -> Dict[str, Any]:
    """Phase C of one scene: full-resolution renders of every scene camera
    against its image (PSNR, SSIM and, with ``lpips_fn``, LPIPS in one
    batched call over all views), and an orbit of ``n_aug_cameras``
    renders.  Returns the result entries ``ngp_params``, ``renders``,
    ``silhouettes``, ``circle_renders`` and ``metrics``."""
    image_size = scene.images.shape[1]
    renders, sils = _render_views(field, scene_vox, image_size, vcfg_eval,
                                  generator, near_far_fn)
    metrics = {"psnr": [], "ssim": []}
    if lpips_fn is not None:
        dev = field.grid.device
        with torch.no_grad():
            metrics["lpips"] = lpips_fn(
                torch.as_tensor(renders, device=dev),
                torch.as_tensor(scene.images, device=dev)).tolist()
    for ci in range(len(scene_vox)):
        metrics["psnr"].append(psnr(renders[ci], scene.images[ci]))
        metrics["ssim"].append(ssim(renders[ci], scene.images[ci]))
    summary = {k: float(np.mean(v)) for k, v in metrics.items()}
    if verbose:
        print("warning: this metric is used for debugging only and not the "
              "final metric")
        extra = (f" lpips: {summary['lpips']:.3f}"
                 if "lpips" in summary else "")
        print(f"scene {scene.sequence_name} psnr: {summary['psnr']:.2f} "
              f"ssim: {summary['ssim']:.3f}{extra}")

    circle_cams = get_interpolated_path(scene_vox, n=cfg.n_aug_cameras)
    c_imgs, c_sils = _render_views(field, circle_cams, image_size,
                                   vcfg_eval, generator, near_far_fn)
    circle_renders = [np.hstack([c_imgs[i], np.repeat(c_sils[i], 3, -1)])
                      for i in range(len(circle_cams))]
    return {"ngp_params": export_jax_params(field), "renders": renders,
            "silhouettes": sils, "circle_renders": np.stack(circle_renders),
            "metrics": summary}


def _occupied_share(bitfield: torch.Tensor) -> float:
    """The share of the grid's cells that the bitfield marks occupied."""
    bits = (bitfield.to(torch.int32)[:, None]
            >> torch.arange(8, device=bitfield.device)) & 1
    return float(bits.sum()) / (8 * bitfield.numel())


def _save_intermediate(save_dir: str, seq: str, losses,
                       fusion_losses) -> None:
    os.makedirs(f"{save_dir}/log", exist_ok=True)
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.plot(losses, linewidth=1, label="volumetric")
    plt.legend(loc="upper right")
    plt.savefig(f"{save_dir}/log/{seq}_loss.jpg")
    plt.close()
    if fusion_losses:
        plt.plot(fusion_losses, linewidth=1)
        plt.savefig(f"{save_dir}/log/{seq}_fusionloss.jpg")
        plt.close()


def _flatten_dict(d, prefix=()):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten_dict(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _save_outputs(result, scene: SceneData, feature_cache, save_dir: str,
                  verbose: bool) -> None:
    """Metrics json and NGP params always; the gif and jpeg renders only
    where ``imageio`` can be imported (output tree of the JAX package;
    with the diffusion arm, the gif rows show the EFT image too)."""
    seq = scene.sequence_name or "scene"
    for sub in ("render_gifs", f"render_imgs/{seq}", "metrics", "log"):
        os.makedirs(f"{save_dir}/{sub}", exist_ok=True)

    with open(f"{save_dir}/metrics/{seq}.txt", "w") as fp:
        fp.write("warning: this metric is used for debugging only and not "
                 "the final metric\n")
        fp.write(json.dumps(result["metrics"], indent=2))
    np.savez(f"{save_dir}/{seq}_ngp.npz",
             **{"/".join(map(str, k)): v for k, v in
                _flatten_dict(result["ngp_params"]).items()})

    try:
        import imageio
    except ImportError:
        if verbose:
            print("imageio not installed: gif/jpeg renders not written")
        return
    gif_path = f"{save_dir}/render_gifs/{seq}.gif"
    with imageio.get_writer(gif_path, mode="I", duration=0.2) as writer:
        for i in range(len(result["renders"])):
            row = [scene.images[i], result["renders"][i],
                   np.repeat(result["silhouettes"][i], 3, axis=-1)]
            if feature_cache is not None:
                row.insert(1, feature_cache["eft_images"][i].cpu().numpy())
            writer.append_data(to_uint8(np.hstack(row)))
            imageio.imwrite(
                f"{save_dir}/render_imgs/{seq}/{i:03d}.jpg",
                to_uint8(np.hstack([scene.images[i], result["renders"][i]])))
    with imageio.get_writer(f"{save_dir}/render_gifs/{seq}_circle.gif",
                            mode="I", duration=0.2) as writer:
        for frame in result["circle_renders"]:
            writer.append_data(to_uint8(frame))
    if verbose:
        print("saved", gif_path)
