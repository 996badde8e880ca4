"""Per-scene NGP distillation: optimization and eval (NGP-only path).

Counterpart of the NGP-only parts of ``sparsefusion_tpu/distill/loop.py``:

* Phase B — ``max_itr`` input-view photometric steps: render the NGP at
  H/2 through the chunked volume renderer, huber color + silhouette +
  opacity loss, Adam update.
* Phase C — eval: full-resolution renders of every scene camera,
  PSNR/SSIM, an orbit of ``n_aug_cameras`` renders, outputs saved.

The diffusion arm (Phase A feature cache, the EFT bootstrap and the
diffusion fusion steps) and occupancy-guided sampling are not ported
yet and raise ``NotImplementedError`` naming their ROADMAP item.
Options that only shaped the JAX package's dispatch (``fused_steps``,
``plms_host_loop``, ``plms_scan_tail``, ``loss_fetch_every``) are
accepted and ignored: the port runs eagerly and reads the loss every
iteration.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from sparsefusion_tpu_torch.core.cameras import (
    Cameras,
    get_camera_slice,
    get_relative_cameras,
)
from sparsefusion_tpu_torch.core.paths import get_interpolated_path
from sparsefusion_tpu_torch.core.rays import grid_ray_bundle
from sparsefusion_tpu_torch.data.contract import SceneData
from sparsefusion_tpu_torch.nn.ngp import (
    NGPConfig,
    NGPField,
    export_jax_params,
)
from sparsefusion_tpu_torch.ops.image import resize_nearest
from sparsefusion_tpu_torch.render.volume import (
    VolumeRendererConfig,
    render_rays_chunked,
)
from sparsefusion_tpu_torch.utils.image import huber, to_uint8
from sparsefusion_tpu_torch.utils.metrics import psnr, ssim

NOT_PORTED_DIFFUSION = (
    "the diffusion arm (EFT cache, bootstrap and fusion steps, VAE, PLMS) "
    "is not ported yet: ROADMAP.md section 1, slice 2 (items 6-9)")
NOT_PORTED_OCCUPANCY = (
    "occupancy-guided sampling (render/occupancy.py, use_occupancy, "
    "--preset tpu) is not ported yet: ROADMAP.md section 1, head of the "
    "queue")
NOT_PORTED_LPIPS = "LPIPS is not ported yet: ROADMAP.md section 1, item 10"


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


class SceneSteps:
    """The per-scene step functions of the NGP-only loop.

    ``draws`` is an optional dict with the random numbers a step would
    otherwise take from its generator: ``ray_idx`` (input_rays,) when the
    step renders a ray subset, ``jitter`` (K, num_steps) and ``u``
    (K, upsample_steps) for the K rays rendered.
    """

    def __init__(self, field: NGPField, cfg: DistillConfig,
                 optimizer: NGPOptimizer, render_hw: int, image_size: int):
        self.field = field
        self.cfg = cfg
        self.optimizer = optimizer
        self.render_hw = render_hw
        self.image_size = image_size

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
        img, sil = _render_cam(self.field, cam, hw, vc, perturb=True,
                               generator=generator, ray_idx=ray_idx,
                               remat=cfg.remat, jitter=draws.get("jitter"),
                               u=draws.get("u"))

        def at_rays(img_hw):
            if ray_idx is None:
                return img_hw
            return img_hw.reshape(-1, img_hw.shape[-1])[ray_idx]

        gt_rgb_ds = resize_nearest(gt_rgb[None], (hw, hw))[0]
        loss = cfg.lambda_color * huber(img, at_rays(gt_rgb_ds)).abs().mean()
        if gt_mask is not None:
            gt_mask_ds = resize_nearest(gt_mask[None], (hw, hw))[0]
            loss = loss + cfg.lambda_sil * huber(
                sil, at_rays(gt_mask_ds)).abs().mean()
        if cfg.lambda_opacity > 0:
            loss = loss + cfg.lambda_opacity * torch.sqrt(
                sil ** 2 + 0.01).mean()
        return loss

    def input_step(self, vc: VolumeRendererConfig, cam: Cameras,
                   gt_rgb: torch.Tensor, gt_mask: Optional[torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> torch.Tensor:
        """Render, loss, gradient and Adam update, in place on the field's
        parameters.  Returns the (detached) loss."""
        self.optimizer.zero_grad()
        loss = self.input_losses(vc, cam, gt_rgb, gt_mask, generator, draws)
        loss.backward()
        self.optimizer.step()
        return loss.detach()


def make_scene_step_fns(field: NGPField, cfg: DistillConfig,
                        optimizer: NGPOptimizer, render_hw: int,
                        image_size: int, lpips_fn=None) -> SceneSteps:
    """The per-scene steps; only ``input_step`` exists in the port so far
    (the bootstrap and fusion steps belong to the diffusion arm)."""
    if lpips_fn is not None:
        raise NotImplementedError(NOT_PORTED_LPIPS)
    return SceneSteps(field, cfg, optimizer, render_hw, image_size)


@torch.no_grad()
def _render_views(field, cams: Cameras, hw: int, vcfg, generator):
    imgs, sils = [], []
    for i in range(len(cams)):
        img, sil = _render_cam(field, get_camera_slice(cams, [i]), hw, vcfg,
                               perturb=True, generator=generator)
        imgs.append(img.cpu().numpy())
        sils.append(sil.cpu().numpy())
    return np.stack(imgs), np.stack(sils)


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
    makes every random draw; returns params, metrics and renders.
    ``models`` is None on the NGP-only path."""
    if use_diffusion or models is not None:
        raise NotImplementedError(NOT_PORTED_DIFFUSION)
    if cfg.use_occupancy:
        raise NotImplementedError(NOT_PORTED_OCCUPANCY)
    if lpips_fn is not None:
        raise NotImplementedError(NOT_PORTED_LPIPS)
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

    # ---- Phase B: NGP optimization ------------------------------------
    field = NGPField(cfg.ngp, device=device, generator=generator)
    optimizer = make_ngp_optimizer(cfg, field)
    steps = make_scene_step_fns(field, cfg, optimizer, render_hw, image_size)

    host_rng = np.random.RandomState(17)
    losses = []
    iter_times = []
    t0 = time.time()
    for itr in range(cfg.max_itr):
        bi = input_idx[host_rng.randint(len(input_idx))]
        cam = get_camera_slice(scene_vox, [bi])
        gt_mask = scene_mask[bi] if scene_mask is not None else None
        loss = steps.input_step(vcfg, cam, scene_rgb[bi], gt_mask, generator)
        losses.append(float(loss))
        iter_times.append(time.time())
        if verbose and itr % 200 == 0:
            print(f"itr {itr:5d} loss {losses[-1]:.4f} "
                  f"({(itr + 1) / (time.time() - t0):.2f} it/s)")
        if (cfg.eval_every > 0 and save_dir is not None
                and itr % cfg.eval_every == 0 and itr > 0):
            _save_intermediate(save_dir, scene.sequence_name, losses)

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
        # host wall clock at the end of each iteration; the loss read
        # synchronizes every iteration, so the differences are step times
        "iter_times": iter_times,
    }
    if save_dir is not None:
        _save_outputs(result, scene, save_dir, verbose)
    return result


def _save_intermediate(save_dir: str, seq: str, losses) -> None:
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


def _flatten_dict(d, prefix=()):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten_dict(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _save_outputs(result, scene: SceneData, save_dir: str,
                  verbose: bool) -> None:
    """Metrics json and NGP params always; the gif and jpeg renders only
    where ``imageio`` can be imported (output tree of the JAX package)."""
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
