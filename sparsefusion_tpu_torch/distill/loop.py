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

The fusion step renders once and feeds a detached copy to the VAE; the
JAX package renders twice with one key, which gives the same image, loss
and gradients.  ``sampler_bf16`` runs the sampler's UNet in bf16 on a
bf16 copy of its weights (``models.py::SparseFusionModels.unet_half``);
the sampler's own arithmetic, the VAE and the EFT stay f32, as in the JAX
package.  Occupancy-guided sampling, LPIPS and the TPU preset's
subsampled fusion step (``fusion_rays``) are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.  Options that only shaped the JAX package's
dispatch (``fused_steps``, ``plms_host_loop``, ``plms_scan_tail``,
``loss_fetch_every``) are accepted and ignored: the port runs eagerly
and reads the losses every iteration.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Any, Dict, Optional

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
from sparsefusion_tpu_torch.diffusion.plms import plms_sample
from sparsefusion_tpu_torch.nn.ngp import (
    NGPConfig,
    NGPField,
    export_jax_params,
)
from sparsefusion_tpu_torch.ops.image import resize_bilinear, resize_nearest
from sparsefusion_tpu_torch.render.lightfield import render_light_field
from sparsefusion_tpu_torch.render.volume import (
    VolumeRendererConfig,
    render_rays_chunked,
)
from sparsefusion_tpu_torch.utils.image import huber, to_uint8
from sparsefusion_tpu_torch.utils.metrics import psnr, ssim

NOT_PORTED_OCCUPANCY = (
    "occupancy-guided sampling (render/occupancy.py, use_occupancy, "
    "--preset tpu) is not ported yet: ROADMAP.md section 1, head of the "
    "queue")
NOT_PORTED_LPIPS = "LPIPS is not ported yet: ROADMAP.md section 1, item 10"
NOT_PORTED_FUSION_RAYS = (
    "the subsampled fusion step (fusion_rays, part of the TPU preset) is "
    "not ported yet: ROADMAP.md section 1, head of the queue")


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
    loss_fetch_every: int = 20
    density_thresh: float = 10.0
    # input steps on a uniform random subset of the render_hw^2 rays
    # (with replacement); None = the full grid
    input_rays: Optional[int] = None
    fusion_rays: Optional[int] = None
    # recompute each render chunk in the backward pass instead of keeping
    # every chunk's activations (torch.utils.checkpoint)
    remat: bool = True
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
    """The JAX package's TPU preset, under the same name: 8 x C4 bf16
    tables, occupancy-guided 32+32 sampling then 32-step marching, one
    16k-ray chunk, 4096-ray input steps.  It needs occupancy, which the
    port does not have yet, so the loop refuses it for now."""
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
    once per optimizer update (the JAX package's optax chain)."""

    def __init__(self, field: NGPField, cfg: DistillConfig):
        mlp = [p for n, p in field.named_parameters() if n != "grid"]
        self.adam = torch.optim.Adam(
            [{"params": [field.grid], "lr": cfg.lr * 10},
             {"params": mlp, "lr": cfg.lr}],
            betas=(0.9, 0.999), eps=1e-8)
        self.schedule = torch.optim.lr_scheduler.StepLR(
            self.adam, step_size=cfg.lr_decay_step,
            gamma=cfg.lr_decay_gamma)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.adam.step()
        self.schedule.step()


def make_ngp_optimizer(cfg: DistillConfig, field: NGPField) -> NGPOptimizer:
    return NGPOptimizer(field, cfg)


def _render_cam(field: NGPField, cam: Cameras, hw: int,
                vcfg: VolumeRendererConfig, perturb: bool,
                generator: Optional[torch.Generator] = None,
                ray_idx: Optional[torch.Tensor] = None, remat: bool = True,
                jitter: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None):
    """Render a camera; with ``ray_idx`` (K,) only those grid rays.
    ``jitter`` / ``u`` are the renderer's draws for the rays rendered."""
    bundle = grid_ray_bundle(cam, hw, hw, 2, 1.0, 2.0)
    o = bundle.origins.reshape(-1, 3)
    d = bundle.directions.reshape(-1, 3)
    if ray_idx is not None:
        o = o[ray_idx]
        d = d[ray_idx]
    bg_fn = field.background if field.config.bg_radius > 0 else None
    out = render_rays_chunked(field, o, d, vcfg, perturb=perturb,
                              det_importance=False, bg_color=0.0,
                              remat=remat, bg_fn=bg_fn, generator=generator,
                              jitter=jitter, u=u)
    if ray_idx is not None:
        return out["image"], out["weights_sum"][:, None]
    return out["image"].reshape(hw, hw, 3), out["weights_sum"].reshape(
        hw, hw, 1)


def _at_rays(img_hw: torch.Tensor, ray_idx: Optional[torch.Tensor]):
    if ray_idx is None:
        return img_hw
    return img_hw.reshape(-1, img_hw.shape[-1])[ray_idx]


def _opacity(sil: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sil ** 2 + 0.01).mean()


class SceneSteps:
    """The per-scene step functions of the loop.

    ``draws`` is an optional dict with the random numbers a step would
    otherwise take from its generator: ``ray_idx`` (input_rays,) when the
    step renders a ray subset, ``jitter`` (K, num_steps) and ``u``
    (K, upsample_steps) for the K rays rendered, and for the fusion step
    ``plms_noise``, the sampler's normal draws in the order
    ``diffusion/plms.py`` takes them.  ``models`` (the EFT/VAE/UNet
    bundle) is needed by the fusion step only.
    """

    def __init__(self, field: NGPField, cfg: DistillConfig,
                 optimizer: NGPOptimizer, render_hw: int, image_size: int,
                 models=None):
        self.field = field
        self.cfg = cfg
        self.optimizer = optimizer
        self.render_hw = render_hw
        self.image_size = image_size
        self.models = models

    def _ray_subset(self, generator, draws):
        cfg, hw = self.cfg, self.render_hw
        if not cfg.input_rays or cfg.input_rays >= hw * hw:
            return None
        if "ray_idx" in draws:
            return draws["ray_idx"].to(self.field.grid.device)
        return torch.randint(0, hw * hw, (cfg.input_rays,),
                             generator=generator,
                             device=self.field.grid.device)

    def input_losses(self, vc: VolumeRendererConfig, cam: Cameras,
                     gt_rgb: torch.Tensor, gt_mask: Optional[torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None):
        cfg, hw = self.cfg, self.render_hw
        draws = draws or {}
        ray_idx = self._ray_subset(generator, draws)
        img, sil = self._render(vc, cam, generator, draws, ray_idx)
        gt_rgb_ds = resize_nearest(gt_rgb[None], (hw, hw))[0]
        loss = cfg.lambda_color * huber(
            img, _at_rays(gt_rgb_ds, ray_idx)).abs().mean()
        if gt_mask is not None:
            gt_mask_ds = resize_nearest(gt_mask[None], (hw, hw))[0]
            loss = loss + cfg.lambda_sil * huber(
                sil, _at_rays(gt_mask_ds, ray_idx)).abs().mean()
        if cfg.lambda_opacity > 0:
            loss = loss + cfg.lambda_opacity * _opacity(sil)
        return loss

    def _render(self, vc, cam, generator, draws, ray_idx=None):
        return _render_cam(self.field, cam, self.render_hw, vc, perturb=True,
                           generator=generator, ray_idx=ray_idx,
                           remat=self.cfg.remat, jitter=draws.get("jitter"),
                           u=draws.get("u"))

    def _update(self, losses_fn, *args) -> torch.Tensor:
        """Loss, gradient and Adam update, in place on the field's
        parameters.  Returns the (detached) loss."""
        self.optimizer.zero_grad()
        loss = losses_fn(*args)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def input_step(self, vc: VolumeRendererConfig, cam: Cameras,
                   gt_rgb: torch.Tensor, gt_mask: Optional[torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> torch.Tensor:
        return self._update(self.input_losses, vc, cam, gt_rgb, gt_mask,
                            generator, draws)

    def render_up(self, vc, cam, generator=None, draws=None):
        """Full-grid render at render_hw, bilinearly upsampled to
        image_size: image (H, W, 3) and silhouette (H, W, 1)."""
        img, sil = self._render(vc, cam, generator, draws or {})
        size = (self.image_size, self.image_size)
        return (resize_bilinear(img[None], size)[0],
                resize_bilinear(sil[None], size)[0])

    def bootstrap_losses(self, vc, cam, eft_img, generator=None, draws=None):
        """Photometric loss against a cached EFT image, with its
        thresholded mean as the silhouette target."""
        cfg, hw = self.cfg, self.render_hw
        draws = draws or {}
        if cfg.input_rays:
            # ray subset: compare at render_hw with the downsampled target
            ray_idx = self._ray_subset(generator, draws)
            img, sil = self._render(vc, cam, generator, draws, ray_idx)
            eft_ds = resize_bilinear(eft_img[None], (hw, hw))[0]
            target = _at_rays(eft_ds, ray_idx)
        else:
            img, sil = self.render_up(vc, cam, generator, draws)
            target = eft_img
        noisy_mask = (target.mean(dim=-1, keepdim=True) > 0.1).float()
        return (cfg.lambda_color * huber(img, target).abs().mean()
                + cfg.lambda_sil * huber(sil, noisy_mask).abs().mean()
                + cfg.lambda_opacity * _opacity(sil))

    def bootstrap_step(self, vc, cam, eft_img, generator=None, draws=None):
        return self._update(self.bootstrap_losses, vc, cam, eft_img,
                            generator, draws)

    @torch.no_grad()
    def fusion_target(self, img: torch.Tensor, features: torch.Tensor,
                      max_thres: float, generator=None, plms_noise=None):
        """The diffusion target of a render (H, W, 3): VAE encode,
        partial-noise PLMS conditioned on ``features`` (256, h, w), VAE
        decode.  Returns (target image (H, W, 3), fusion weight =
        1 - alpha_cumprod at max_thres)."""
        models, cfg = self.models, self.cfg
        latents = models.vae_encode(img[None])
        pred_x0, _, _, alpha_cumprod = plms_sample(
            models.ddpm, functools.partial(models.denoise_fn,
                                           bf16=cfg.sampler_bf16),
            latents, max_thres,
            cond_images=features[None], cond_scale=cfg.cond_scale,
            plms_steps=cfg.plms_steps, generator=generator,
            noises=plms_noise)
        return models.vae_decode(pred_x0)[0], 1.0 - alpha_cumprod[0]

    def fusion_losses(self, vc, cam, features, max_thres, generator=None,
                      draws=None):
        """Render once with gradient; the detached copy goes through
        :meth:`fusion_target` (the reference samples without gradient)."""
        draws = draws or {}
        img, sil = self.render_up(vc, cam, generator, draws)
        pred_img, weight = self.fusion_target(
            img.detach(), features, max_thres, generator,
            draws.get("plms_noise"))
        return (weight * (img - pred_img).abs().mean()
                + self.cfg.lambda_opacity * _opacity(sil))

    def fusion_step(self, vc, cam, features, max_thres, generator=None,
                    draws=None):
        return self._update(self.fusion_losses, vc, cam, features,
                            max_thres, generator, draws)


def make_scene_step_fns(field: NGPField, cfg: DistillConfig,
                        optimizer: NGPOptimizer, render_hw: int,
                        image_size: int, lpips_fn=None,
                        models=None) -> SceneSteps:
    """The per-scene steps (input, bootstrap and, with ``models``, fusion)."""
    if lpips_fn is not None:
        raise NotImplementedError(NOT_PORTED_LPIPS)
    return SceneSteps(field, cfg, optimizer, render_hw, image_size, models)


@torch.no_grad()
def _render_views(field, cams: Cameras, hw: int, vcfg, generator):
    imgs, sils = [], []
    for i in range(len(cams)):
        img, sil = _render_cam(field, get_camera_slice(cams, [i]), hw, vcfg,
                               perturb=True, generator=generator)
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
    context images go through the ResNet trunk once."""
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
    return {"features": torch.stack(feats),       # (M, 256, h, w)
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
) -> Dict[str, Any]:
    """Optimize an NGP for one scene on the device of ``generator``, which
    makes every random draw; returns params, metrics, renders, the losses
    and the per-iteration host clock.  ``models`` (the bundle of
    ``models.build_models``) is needed with ``use_diffusion`` only."""
    if cfg.use_occupancy:
        raise NotImplementedError(NOT_PORTED_OCCUPANCY)
    if lpips_fn is not None:
        raise NotImplementedError(NOT_PORTED_LPIPS)
    if use_diffusion and cfg.fusion_rays:
        raise NotImplementedError(NOT_PORTED_FUSION_RAYS)
    if use_diffusion and models is None:
        raise ValueError("the diffusion arm needs the EFT/VAE/UNet models")
    device = generator.device
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
    input_idx = [int(i) for i in input_idx]

    # ---- Phase A: EFT feature cache -----------------------------------
    feature_cache = None
    cache_seconds = 0.0
    if use_diffusion:
        t0 = time.time()
        feature_cache = build_feature_cache(models, scene_cameras, scene_rgb,
                                            input_idx, cfg, image_size)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        cache_seconds = time.time() - t0
        if verbose:
            print(f"cached {len(feature_cache['cameras_vox'])} features in "
                  f"{cache_seconds:.1f}s")
    n_cache = 0 if feature_cache is None else len(
        feature_cache["cameras_vox"])

    # ---- Phase B: NGP optimization ------------------------------------
    field = NGPField(cfg.ngp, device=device, generator=generator)
    optimizer = make_ngp_optimizer(cfg, field)
    steps = make_scene_step_fns(field, cfg, optimizer, render_hw, image_size,
                                models=models)
    unet_evals0 = models.unet_evals if models is not None else 0

    host_rng = np.random.RandomState(17)
    losses, fusion_losses = [], []
    iter_times = []
    t0 = time.time()
    for itr in range(cfg.max_itr):
        # host draws in the JAX package's order: input view, then the
        # cached camera and the noise level
        bi = input_idx[host_rng.randint(len(input_idx))]
        cam = get_camera_slice(scene_vox, [bi])
        gt_mask = scene_mask[bi] if scene_mask is not None else None
        if use_diffusion:
            ci = int(host_rng.randint(n_cache))
            mt = min(float(host_rng.uniform()), 0.99)
            cam_f = feature_cache["cameras_vox"][ci]
        loss = steps.input_step(vcfg, cam, scene_rgb[bi], gt_mask, generator)
        losses.append(float(loss))
        if use_diffusion:
            if itr > cfg.start_fusion_step:
                floss = steps.fusion_step(vcfg, cam_f,
                                          feature_cache["features"][ci], mt,
                                          generator)
            else:
                floss = steps.bootstrap_step(
                    vcfg, cam_f, feature_cache["eft_images"][ci], generator)
            fusion_losses.append(float(floss))
        iter_times.append(time.time())
        if verbose and itr % 200 == 0:
            print(f"itr {itr:5d} loss {losses[-1]:.4f} "
                  f"({(itr + 1) / (time.time() - t0):.2f} it/s)")
        if (cfg.eval_every > 0 and save_dir is not None
                and itr % cfg.eval_every == 0 and itr > 0):
            _save_intermediate(save_dir, scene.sequence_name, losses,
                               fusion_losses)

    # ---- Phase C: eval ------------------------------------------------
    renders, sils = _render_views(field, scene_vox, image_size, vcfg,
                                  generator)
    metrics = {"psnr": [], "ssim": []}
    for ci in range(len(scene_vox)):
        metrics["psnr"].append(psnr(renders[ci], scene.images[ci]))
        metrics["ssim"].append(ssim(renders[ci], scene.images[ci]))
    summary = {k: float(np.mean(v)) for k, v in metrics.items()}
    if verbose:
        print("warning: this metric is used for debugging only and not the "
              "final metric")
        print(f"scene {scene.sequence_name} psnr: {summary['psnr']:.2f} "
              f"ssim: {summary['ssim']:.3f}")

    circle_cams = get_interpolated_path(scene_vox, n=cfg.n_aug_cameras)
    c_imgs, c_sils = _render_views(field, circle_cams, image_size, vcfg,
                                   generator)
    circle_renders = [np.hstack([c_imgs[i], np.repeat(c_sils[i], 3, -1)])
                      for i in range(len(circle_cams))]

    result = {
        "ngp_params": export_jax_params(field),
        "renders": renders,
        "silhouettes": sils,
        "circle_renders": np.stack(circle_renders),
        "metrics": summary,
        "losses": losses,
        "fusion_losses": fusion_losses,
        # seconds of Phase A, and the UNet evaluations of this scene
        "cache_seconds": cache_seconds,
        "unet_evals": (models.unet_evals - unet_evals0
                       if models is not None else 0),
        # host wall clock at the end of each iteration; the loss read
        # synchronizes every iteration, so the differences are step times
        "iter_times": iter_times,
    }
    if save_dir is not None:
        _save_outputs(result, scene, feature_cache, save_dir, verbose)
    return result


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
