"""The reference's SparseFusion steps: the model bundle, the distillation
loop's steps and its Phase A cache entry, and the train step.

Plain copies of the port's ``models.py``, ``distill/loop.py`` (the eager
``SceneSteps`` of one scene, without occupancy, ray subsets or LPIPS)
and ``train/trainer.py`` (``TrainStep`` of one process).  Each step draws
its random numbers from a ``torch.Generator`` in the order the port's
steps draw them, so a generator in the same state gives the same draws.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference.cameras import (
    Cameras,
    camera_centers,
    concat_cameras,
    get_camera_slice,
    get_relative_cameras,
)
from portbench.reference.ddpm import DDPM, DDPMConfig
from portbench.reference.eft import EFTConfig, EpipolarFeatureTransformer
from portbench.reference.imageops import (
    grid_sample_bilinear,
    resize_bilinear,
    resize_nearest,
)
from portbench.reference.imageutil import huber, normalize, unnormalize
from portbench.reference.lightfield import render_light_field
from portbench.reference.ngp import NGPConfig, NGPField
from portbench.reference.paths import get_interpolated_path
from portbench.reference.plms import plms_sample
from portbench.reference.rays import grid_ray_bundle
from portbench.reference.unet import EfficientUNet, UNetConfig
from portbench.reference.vae import AutoencoderKL, VAEConfig
from portbench.reference.volume import (
    VolumeRendererConfig,
    render_rays_chunked,
)

Z_SCALE_FACTOR = 0.18215


def set_tf32(enabled: bool) -> None:
    """TF32 in matmuls and cuDNN convolutions on or off."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


@contextlib.contextmanager
def tf32_within(enabled: bool):
    """TF32 on inside the block where ``enabled``; the flags restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if enabled:
        set_tf32(True)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@dataclasses.dataclass
class Models:
    eft: EpipolarFeatureTransformer
    vae: AutoencoderKL
    unet: EfficientUNet
    ddpm: DDPM
    tf32: bool = False   # a control: the UNet's and VAE's forwards in TF32

    def denoise_fn(self, x, log_snr, cond_images, keep_mask):
        with tf32_within(self.tf32):
            return self.unet(x, log_snr, cond_images, keep_mask)

    def vae_encode(self, images_01: torch.Tensor) -> torch.Tensor:
        """[0, 1] RGB (B, H, W, 3) -> scaled latents (B, 4, H/8, W/8)."""
        x = normalize(images_01)
        with tf32_within(self.tf32):
            z = self.vae.encode_mode(x.permute(0, 3, 1, 2))
        return z * Z_SCALE_FACTOR

    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        with tf32_within(self.tf32):
            x = self.vae.decode(z / Z_SCALE_FACTOR)
        return unnormalize(x).permute(0, 2, 3, 1)


def meta_modules(sizes: dict):
    """The EFT, VAE and UNet of a configuration file's sizes, on the meta
    device (no memory, no draws)."""
    with torch.device("meta"):
        return (EpipolarFeatureTransformer(EFTConfig(**sizes["eft"])),
                AutoencoderKL(VAEConfig(**sizes["vae"])),
                EfficientUNet(UNetConfig(**sizes["unet"])))


def build_models(sizes: dict, fill, device) -> Models:
    """The trio on ``device`` with weights from ``fill(module)`` (the
    benchmark's seeded weights), in eval mode."""
    mods = [m.to_empty(device=device).eval() for m in meta_modules(sizes)]
    for m in mods:
        fill(m)
    return Models(*mods, DDPM(DDPMConfig(**sizes["ddpm"])))


# ---- distillation ------------------------------------------------------

def renderer_config(cfg: dict) -> VolumeRendererConfig:
    return VolumeRendererConfig(
        num_steps=cfg["num_steps"], upsample_steps=cfg["upsample_steps"],
        bound=cfg["bound"], min_near=cfg["min_near"],
        max_ray_batch=cfg["max_ray_batch"])


def render_cam(field: NGPField, cam: Cameras, hw: int,
               vcfg: VolumeRendererConfig, generator, remat: bool):
    bundle = grid_ray_bundle(cam, hw, hw, 2, 1.0, 2.0)
    out = render_rays_chunked(field, bundle.origins.reshape(-1, 3),
                              bundle.directions.reshape(-1, 3), vcfg,
                              perturb=True, det_importance=False,
                              bg_color=0.0, remat=remat,
                              bg_fn=(field.background
                                     if field.config.bg_radius > 0 else None),
                              generator=generator)
    return (out["image"].reshape(hw, hw, 3),
            out["weights_sum"].reshape(hw, hw, 1))


class DistillSteps:
    """One scene's input, bootstrap and fusion steps with their Adam
    update (10x the rate on the grid), as the port's eager steps."""

    def __init__(self, field: NGPField, cfg: dict, image_size: int,
                 models: Optional[Models]):
        self.field, self.cfg, self.models = field, cfg, models
        self.image_size = image_size
        self.targets = []   # each fusion step's sampler output (latents)
        self.render_hw = image_size // cfg["hw_scale"]
        self.vcfg = renderer_config(cfg)
        mlp = [p for n, p in field.named_parameters() if n != "grid"]
        self.adam = torch.optim.Adam(
            [{"params": [field.grid], "lr": cfg["lr"] * 10},
             {"params": mlp, "lr": cfg["lr"]}], betas=(0.9, 0.999), eps=1e-8)

    def _render(self, cam, generator):
        return render_cam(self.field, cam, self.render_hw, self.vcfg,
                          generator, self.cfg["remat"])

    def _opacity(self, sil):
        return torch.sqrt(sil ** 2 + 0.01).mean()

    def _update(self, loss_fn, *args) -> float:
        self.adam.zero_grad(set_to_none=True)
        loss = loss_fn(*args)
        loss.backward()
        self.adam.step()
        return float(loss.detach())

    def _render_up(self, cam, generator):
        img, sil = self._render(cam, generator)
        size = (self.image_size, self.image_size)
        return (resize_bilinear(img[None], size)[0],
                resize_bilinear(sil[None], size)[0])

    def input_losses(self, cam, gt_rgb, gt_mask, generator):
        cfg, hw = self.cfg, self.render_hw
        img, sil = self._render(cam, generator)
        gt = resize_nearest(gt_rgb[None], (hw, hw))[0]
        loss = cfg["lambda_color"] * huber(img, gt).abs().mean()
        if gt_mask is not None:
            mask = resize_nearest(gt_mask[None], (hw, hw))[0]
            loss = loss + cfg["lambda_sil"] * huber(sil, mask).abs().mean()
        if cfg["lambda_opacity"] > 0:
            loss = loss + cfg["lambda_opacity"] * self._opacity(sil)
        return loss

    def bootstrap_losses(self, cam, eft_img, generator):
        cfg = self.cfg
        img, sil = self._render_up(cam, generator)
        noisy_mask = (eft_img.mean(dim=-1, keepdim=True) > 0.1).float()
        return (cfg["lambda_color"] * huber(img, eft_img).abs().mean()
                + cfg["lambda_sil"] * huber(sil, noisy_mask).abs().mean()
                + cfg["lambda_opacity"] * self._opacity(sil))

    @torch.no_grad()
    def fusion_target(self, img, features, max_thres, generator):
        models, cfg = self.models, self.cfg
        latents = models.vae_encode(img[None])
        pred_x0, _, _, alpha_cumprod = plms_sample(
            models.ddpm, models.denoise_fn, latents, max_thres,
            cond_images=features[None], cond_scale=cfg["cond_scale"],
            plms_steps=cfg["plms_steps"], generator=generator)
        self.targets.append(pred_x0.detach().clone())
        return models.vae_decode(pred_x0)[0], (1.0 - alpha_cumprod)[0]

    def fusion_losses(self, cam, features, max_thres, generator):
        img, sil = self._render_up(cam, generator)
        pred, weight = self.fusion_target(img.detach(), features, max_thres,
                                          generator)
        return (weight * (img - pred).abs().mean()
                + self.cfg["lambda_opacity"] * self._opacity(sil))

    def input_step(self, *args) -> float:
        return self._update(self.input_losses, *args)

    def bootstrap_step(self, *args) -> float:
        return self._update(self.bootstrap_losses, *args)

    def fusion_step(self, *args) -> float:
        return self._update(self.fusion_losses, *args)


@torch.no_grad()
def feature_cache_entries(models: Models, scene_cameras: Cameras,
                          scene_rgb: torch.Tensor, input_idx, cfg: dict,
                          image_size: int, wanted) -> Dict[int, tuple]:
    """Phase A for the cached cameras ``wanted`` only: {index: (features
    (256, h, w), EFT image (H, W, 3), camera in the voxel frame)}."""
    eft_hw = image_size // cfg["eft_scale"]
    aug = get_interpolated_path(scene_cameras, n=cfg["n_aug_cameras"],
                                theta_offset_max=cfg["theta_offset_max"],
                                rng=np.random.RandomState(0))
    aug_all = concat_cameras([scene_cameras, aug])
    aug_rel = get_relative_cameras(aug_all, [0], center_at_origin=True)
    aug_vox = get_relative_cameras(aug_all, [0], center_at_origin=False)
    dist = float(torch.linalg.norm(camera_centers(scene_cameras),
                                   dim=1).mean())
    ctx_rgb = scene_rgb[input_idx]
    ctx_nchw = ctx_rgb.permute(0, 3, 1, 2).contiguous()
    latent = models.eft.encode(ctx_nchw)
    out = {}
    for ci in sorted(set(wanted)):
        rel = get_relative_cameras(aug_rel, [ci], center_at_origin=True)
        ctx_cams = get_camera_slice(rel, input_idx)

        def ray_fn(o, d, lengths, ctx_cams=ctx_cams):
            return models.eft(o, d, lengths, ctx_cams, ctx_nchw, latent)

        rgb, feat = render_light_field(
            ray_fn, get_camera_slice(rel, [ci]), eft_hw, eft_hw, dist - 5.0,
            dist + 5.0, n_pts_per_ray=cfg["eft_n_pts"], n_batches=16)
        out[ci] = (feat[0].permute(2, 0, 1),
                   resize_bilinear(rgb, (image_size, image_size),
                                   align_corners=False)[0],
                   get_camera_slice(aug_vox, [ci]))
    return out


def n_cached_cameras(n_views: int, cfg: dict) -> int:
    return n_views + cfg["n_aug_cameras"]


def follow_distillation(models: Optional[Models], scene, input_idx,
                        cfg: dict, ngp: dict, generator, n_iterations: int,
                        fusion_from: int, moment_at: int, device) -> dict:
    """The first ``n_iterations`` of the distillation loop on one scene
    (the port's ``distillation_loop``: the field drawn from ``generator``,
    then each iteration's host draws from ``RandomState(17)``, an input
    step, and a bootstrap step or, after ``fusion_from``, a fusion step).
    Returns the losses of every step, each leaf's first moment after
    iteration ``moment_at``, the field's parameters before and after,
    and each fusion step's sampler output."""
    image_size = scene.images.shape[1]
    scene_cameras = scene.cameras(device)
    scene_rgb = torch.as_tensor(scene.images, device=device)
    scene_mask = torch.as_tensor(scene.masks, device=device)
    scene_vox = get_relative_cameras(scene_cameras, [0],
                                     center_at_origin=False)
    input_idx = [int(i) for i in input_idx]
    host_rng = np.random.RandomState(17)
    n_cache = n_cached_cameras(len(scene.images), cfg)
    plan = []
    for _ in range(n_iterations):
        bi = input_idx[host_rng.randint(len(input_idx))]
        ci = int(host_rng.randint(n_cache))
        mt = min(float(host_rng.uniform()), 0.99)
        plan.append((bi, ci, mt))
    cache = feature_cache_entries(models, scene_cameras, scene_rgb,
                                  input_idx, cfg, image_size,
                                  [ci for _, ci, _ in plan])
    field = NGPField(NGPConfig(**ngp), device=device, generator=generator)
    start = {n: p.detach().clone() for n, p in field.named_parameters()}
    steps = DistillSteps(field, cfg, image_size, models)
    losses, moment = [], None
    for itr, (bi, ci, mt) in enumerate(plan):
        losses.append(steps.input_step(get_camera_slice(scene_vox, [bi]),
                                       scene_rgb[bi], scene_mask[bi],
                                       generator))
        features, eft_img, cam = cache[ci]
        if itr > fusion_from:
            losses.append(steps.fusion_step(cam, features, mt, generator))
        else:
            losses.append(steps.bootstrap_step(cam, eft_img, generator))
        if itr == moment_at:
            moment = adam_moments(steps.adam, dict(field.named_parameters()))
    return {"losses": losses, "moment": moment, "start": start,
            "targets": steps.targets,
            "end": {n: p.detach().clone()
                    for n, p in field.named_parameters()}}


def adam_moments(adam: torch.optim.Optimizer, named: dict) -> dict:
    """{leaf: Adam's first moment} (the gradient as the optimizer got it,
    times 1 - beta1 after one update)."""
    return {n: adam.state[p]["exp_avg"].detach().clone()
            for n, p in named.items() if p in adam.state}


# ---- training ----------------------------------------------------------

def depth_range(cameras: Cameras):
    centers = -torch.einsum("ni,nij->nj", cameras.T, cameras.R)
    dist = torch.linalg.norm(centers, dim=-1).mean()
    return dist - 5.0, dist + 5.0


class TrainStep:
    """The port's train step of one process and one scene a step: the EFT
    renders the query view from the context views, the frozen VAE encodes
    the query, the masked p2 eps loss runs through the UNet at the
    diffusion batch, a huber colour loss holds the EFT's rgb, and Adam
    updates the UNet and the EFT unless a gradient is not finite."""

    def __init__(self, models: Models, cfg: dict):
        self.models, self.cfg = models, cfg
        self.groups = [list(models.unet.parameters())]
        if cfg["train_eft"]:
            self.groups.append(list(models.eft.parameters()))
        self.adams = [torch.optim.Adam(g, lr=lr, betas=(0.9, 0.999), eps=1e-8)
                      for g, lr in zip(self.groups, (cfg["lr"], cfg["eft_lr"]))]

    def losses(self, batch: dict, generator):
        cfg, models = self.cfg, self.models
        hw, dbs, n_pts = cfg["latent_size"], cfg["diffusion_batch_size"], \
            cfg["eft_n_pts"]
        q_rgb, q_valid = batch["query_rgb"], batch["query_valid"]
        min_d, max_d = depth_range(batch["context_cams"])
        with torch.set_grad_enabled(cfg["train_eft"]):
            bundle = grid_ray_bundle(batch["query_cam"], hw, hw, n_pts,
                                     min_d, max_d)
            ctx = batch["context_rgb"].permute(0, 3, 1, 2).contiguous()
            rgb, feat = models.eft(bundle.origins.reshape(-1, 3),
                                   bundle.directions.reshape(-1, 3),
                                   bundle.lengths.reshape(-1, n_pts),
                                   batch["context_cams"], ctx,
                                   models.eft.encode(ctx))
        rgb = rgb.reshape(hw, hw, 3)
        feat = feat.reshape(hw, hw, -1)
        with torch.no_grad():
            z = models.vae_encode(q_rgb[None])
        z_b = z.expand(dbs, *z.shape[1:])
        feat_b = feat.permute(2, 0, 1)[None].expand(dbs, -1, -1, -1)
        mask = resize_bilinear(q_valid[None], (hw, hw))[0]
        mask = (mask > cfg["valid_thresh"]).float()
        loss_mask = mask.permute(2, 0, 1)[None].expand(dbs, -1, -1, -1)
        times = models.ddpm.schedule.sample_random_times(dbs, generator)
        d_loss = models.ddpm.p_losses(
            models.denoise_fn, z_b, times, generator, cond_images=feat_b,
            loss_mask=loss_mask, drawn={"times": times})
        color = torch.zeros((), device=d_loss.device)
        if cfg["train_eft"]:
            gt = grid_sample_bilinear(
                q_rgb[None], -bundle.xys.reshape(1, -1, 2)).reshape(hw, hw, 3)
            color = (huber(rgb, gt) * mask).abs().mean()
        return d_loss + color

    def step(self, batch: dict, generator) -> float:
        for adam in self.adams:
            adam.zero_grad(set_to_none=True)
        loss = self.losses(batch, generator)
        loss.backward()
        for group, adam in zip(self.groups, self.adams):
            grads = [p.grad for p in group if p.grad is not None]
            if all(bool(torch.isfinite(g).all()) for g in grads):
                adam.step()
        return float(loss.detach())

    def named(self) -> dict:
        out = {f"unet.{n}": p for n, p in self.models.unet.named_parameters()}
        if self.cfg["train_eft"]:
            out.update({f"eft.{n}": p
                        for n, p in self.models.eft.named_parameters()})
        return out

    def moments(self) -> dict:
        named = self.named()
        out = {}
        for adam in self.adams:
            out.update(adam_moments(adam, {
                n: p for n, p in named.items() if p in adam.state}))
        return out


def train_batch(scene, query: int, context, device) -> dict:
    """One scene's step input: the query and context images and cameras
    relative to the query's rotation (the port's ``prepare_scene_batch``
    of one scene, without the batch axis)."""
    rel = get_relative_cameras(scene.cameras(device), [query],
                               center_at_origin=False)
    t = functools.partial(torch.as_tensor, dtype=torch.float32,
                          device=device)
    return {"query_rgb": t(scene.images[query]),
            "query_valid": t(scene.valid_region[query]),
            "query_cam": get_camera_slice(rel, [query]),
            "context_rgb": t(scene.images[list(context)]),
            "context_cams": get_camera_slice(rel, list(context))}


def follow_training(models: Models, cfg: dict, scenes, plan, generator,
                    device) -> dict:
    """The first ``len(plan)`` train steps, ``plan`` being (scene, query,
    context) a step.  Returns each step's loss, each trained leaf's first
    moment after step one, and the leaves before and after."""
    step = TrainStep(models, cfg)
    named = step.named()
    start = {n: p.detach().clone() for n, p in named.items()}
    losses, moment = [], None
    for k, (s, q, ctx) in enumerate(plan):
        losses.append(step.step(train_batch(scenes[s], q, ctx, device),
                                generator))
        if k == 0:
            moment = step.moments()
    return {"losses": losses, "moment": moment, "start": start,
            "end": {n: p.detach().clone() for n, p in named.items()}}
