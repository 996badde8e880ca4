"""Training of the view-conditioned latent diffusion model and the EFT.

Counterpart of ``sparsefusion_tpu/train/trainer.py``.  One train step,
for each scene of its batch:

* the EFT encodes the context views and renders the query view's rgb and
  256-d features on a ``latent_size`` ray grid of ``eft_n_pts`` depths;
* the frozen VAE encodes the query image to latents (no gradient);
* latents and features are broadcast to the diffusion batch;
* the masked eps loss with p2 weighting runs through the UNet, with the
  conditioning dropped per sample (``DDPM.p_losses``), masked to where the
  query image's valid region, resized to the latents, exceeds
  ``valid_thresh``;
* with ``train_eft``, a huber colour loss holds the EFT's rgb against the
  query image at the rays' pixels.

The losses are averaged over the scenes; the UNet (and EFT) take an Adam
step behind the non-finite guard (:class:`GuardedAdam`).
:meth:`TrainStep.program` is the same step as one program with no host
read, as the JAX step is one jitted program: the depth range computed on
the device from the context cameras, the guard's flag handed to the
fused Adam on the device; ``train/fused.py`` captures it into CUDA
graphs.  Calling the :class:`TrainStep` runs the eager step, whose guard
reads its flag on the host.  With
``compute_dtype="bfloat16"`` the UNet computes in bf16 on its f32 master
parameters (``models.py::unet_compute_view``); the EFT, the VAE, the
loss, the gradients and Adam stay f32, as in the JAX step.

The JAX step vmaps its scenes over a device mesh; here each process takes
its scenes in a loop (one backward per scene, the gradients summed), and
across processes the UNet (and a trained EFT) run inside
``DistributedDataParallel``, whose gradient average over processes that
hold one scene each is the JAX step's mean over all scenes.

The EFT's modules stay in eval mode: its trunk's batch norm normalises
with the running statistics while its parameters train, as the JAX step's
``encode(train=False)`` does.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from sparsefusion_tpu_torch.core.cameras import (
    Cameras,
    get_camera_slice,
    get_relative_cameras,
)
from sparsefusion_tpu_torch.core.rays import grid_ray_bundle
from sparsefusion_tpu_torch.models import unet_compute_view
from sparsefusion_tpu_torch.ops.image import grid_sample_bilinear, resize_bilinear
from sparsefusion_tpu_torch.utils.graphs import TensorStepLR
from sparsefusion_tpu_torch.utils.image import huber

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Same fields and defaults as the JAX ``TrainConfig``."""

    lr: float = 5e-5
    lr_decay_step: int = 50000
    lr_decay_gamma: float = 0.5
    diffusion_batch_size: int = 12
    context_size: int = 3
    train_eft: bool = True
    eft_lr: float = 5e-5
    latent_size: int = 32
    eft_n_pts: int = 20
    valid_thresh: float = 0.6
    # the UNet's compute dtype, "float32" or "bfloat16": in bf16 the UNet
    # runs its convolutions, matmuls and attention in bf16 on the f32
    # master parameters; the gradients, Adam's state and the loss stay f32
    compute_dtype: str = "float32"
    # skip (never apply) an update whose gradients hold a NaN or inf
    guard_nonfinite: bool = True


class GuardedAdam:
    """Adam with optax's defaults (betas 0.9 / 0.999, eps 1e-8) and the
    staircase decay ``lr * gamma ** (updates // decay_step)``, behind the
    non-finite guard.

    A step whose gradients hold a NaN or inf applies nothing: no Adam step,
    no schedule step (optax keeps the schedule's count inside the state the
    JAX guard freezes), the optimizer state untouched.  The step is counted
    in :attr:`notfinite`; unlike ``optax.apply_if_finite`` the guard never
    gives up.

    The Adam is PyTorch's fused one on a 0-d learning-rate tensor that a
    :class:`TensorStepLR` ticks, and the count of skipped steps is a
    device tensor, so that the whole update can run inside a CUDA graph:
    :meth:`step` takes the guard's verdict from the host,
    :meth:`step_on_device` its flag on the device (the fused Adam leaves
    parameters, moments and step count unchanged where its ``found_inf``
    is 1, and the staircase and the count advance by the flag).
    """

    def __init__(self, params, lr: float, cfg: TrainConfig):
        self.params = list(params)
        device = self.params[0].device
        self.schedule = TensorStepLR([lr], cfg.lr_decay_step,
                                     cfg.lr_decay_gamma, device)
        self.adam = torch.optim.Adam(
            [{"params": self.params, "lr": self.schedule.lrs[0]}],
            betas=(0.9, 0.999), eps=1e-8, fused=True, capturable=True)
        self.guard = cfg.guard_nonfinite
        self.skipped = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def notfinite(self) -> int:
        """Updates skipped by the guard (a host read)."""
        return int(self.skipped)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def nonfinite_flag(self) -> torch.Tensor:
        """(1,) float on the parameters' device: 1 where any gradient holds
        a NaN or inf.  One multi-tensor pass over all gradients (the AMP
        grad scaler's check, at scale 1: the gradients are unchanged)."""
        device = self.params[0].device
        found = torch.zeros(1, device=device)
        grads = [p.grad for p in self.params if p.grad is not None]
        if grads:
            torch._amp_foreach_non_finite_check_and_unscale_(
                grads, found, torch.ones(1, device=device))
        return found

    def step(self, finite: bool) -> bool:
        """Apply the update unless the guard holds it; True if applied."""
        if self.guard and not finite:
            self.skipped += 1
            return False
        self.adam.step()
        self.schedule.step()
        return True

    def step_on_device(self, flag: Optional[torch.Tensor]) -> None:
        """The guarded update with no host read: ``flag`` is
        :meth:`nonfinite_flag`'s (None: apply).  Nothing multiplies by the
        flag, so a NaN gradient reaches no parameter and no moment."""
        if flag is None:
            self.adam.step()
            self.schedule.step()
            return
        self.adam.found_inf = flag.reshape(())
        try:
            self.adam.step()
        finally:
            self.adam.found_inf = None
        self.schedule.step(flag)
        self.skipped += flag.reshape(()).to(torch.int64)

    def state_dict(self) -> Dict:
        return {"adam": self.adam.state_dict(),
                "schedule": self.schedule.state_dict(),
                "notfinite": self.notfinite}

    def load_state_dict(self, state: Dict) -> None:
        """Copy a state in: the Adam's moments and steps, the staircase's
        count and the guard's count (the learning rate stays the
        schedule's tensor)."""
        self.adam.load_state_dict(state["adam"])
        for group in self.adam.param_groups:
            group["lr"] = self.schedule.lrs[0]
        self.schedule.load_state_dict(state["schedule"])
        self.skipped.fill_(int(state["notfinite"]))


def make_optimizers(cfg: TrainConfig, models
                    ) -> Tuple[GuardedAdam, Optional[GuardedAdam]]:
    """The UNet's optimizer and, with ``train_eft``, the EFT's."""
    unet_opt = GuardedAdam(models.unet.parameters(), cfg.lr, cfg)
    eft_opt = (GuardedAdam(models.eft.parameters(), cfg.eft_lr, cfg)
               if cfg.train_eft else None)
    return unet_opt, eft_opt


def notfinite_count(opt: Optional[GuardedAdam]) -> int:
    """Updates skipped by the non-finite guard (0 without an optimizer)."""
    return 0 if opt is None else opt.notfinite


def scene_depth_range(cameras: Cameras
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Near and far as 0-d tensors on the cameras' device: the mean norm
    of ``-T R`` (the JAX package's and the reference's expression) minus
    and plus 5, computed on the device as the JAX step computes it inside
    its program."""
    centers = -torch.einsum("ni,nij->nj", cameras.T, cameras.R)
    dist = torch.linalg.norm(centers, dim=-1).mean()
    return dist - 5.0, dist + 5.0


def scene_depth_range_from_cam(cameras: Cameras) -> Tuple[float, float]:
    """:func:`scene_depth_range` as host floats."""
    near, far = scene_depth_range(cameras)
    return float(near), float(far)


def prepare_scene_batch(scenes, query_idx: Sequence[int],
                        context_idx: Sequence[Sequence[int]],
                        device=None) -> Dict:
    """Stack per-scene (query, context) selections into a batch on
    ``device``: query and context images (NHWC), the query's valid
    region, and per scene the query and context cameras relative to the
    query's rotation (``center_at_origin=False``) and the context's depth
    range (computed on the host, for the eager step; the program computes
    it on the device)."""
    q_rgb, q_valid, q_cam, c_rgb, c_cams, ranges = [], [], [], [], [], []
    for scene, qi, ci in zip(scenes, query_idx, context_idx):
        rel = get_relative_cameras(scene.cameras(), [qi],
                                   center_at_origin=False)
        ctx = get_camera_slice(rel, list(ci))
        ranges.append(scene_depth_range_from_cam(ctx))
        q_cam.append(get_camera_slice(rel, [qi]).to(device))
        c_cams.append(ctx.to(device))
        q_rgb.append(scene.images[qi])
        q_valid.append(scene.valid_region[qi])
        c_rgb.append(scene.images[list(ci)])

    def stack(xs):
        return torch.as_tensor(np.stack(xs), dtype=torch.float32,
                               device=device)

    return {"query_rgb": stack(q_rgb),      # (B, H, W, 3)
            "query_valid": stack(q_valid),  # (B, H, W, 1)
            "query_cam": q_cam,             # B cameras of 1
            "context_rgb": stack(c_rgb),    # (B, NC, H, W, 3)
            "context_cams": c_cams,         # B cameras of NC
            "depth_range": ranges}          # B (near, far)


class _EFTQuery(nn.Module):
    """The EFT's encode and ray query as one forward, so that a
    ``DistributedDataParallel`` wrapper sees every parameter it uses."""

    def __init__(self, eft: nn.Module):
        super().__init__()
        self.eft = eft

    def forward(self, context_nchw, origins, directions, lengths, cameras):
        latent = self.eft.encode(context_nchw)
        return self.eft(origins, directions, lengths, cameras, context_nchw,
                        latent)


class TrainStep:
    """``step(batch, generator=None, draws=None) -> (loss, d_loss,
    color_loss)``: the means over the batch's scenes, detached.

    ``draws``, where given, holds one dict per scene with the step's random
    numbers: ``times`` (dbs,), ``noise`` (dbs, 4, h, w) and ``keep``
    (dbs,) bool; otherwise they come from ``generator`` (times, noise, keep
    mask, scene by scene).  :attr:`draws` holds the last step's, a dict
    per scene.  With ``torch.distributed`` initialised over more than one
    process the UNet (and a trained EFT) run inside
    ``DistributedDataParallel``.  :meth:`program` is the step with no
    host read.
    """

    def __init__(self, models, cfg: TrainConfig, unet_opt: GuardedAdam,
                 eft_opt: Optional[GuardedAdam] = None):
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        if cfg.train_eft and eft_opt is None:
            raise ValueError("train_eft needs the EFT's optimizer")
        self.models = models
        self.cfg = cfg
        self.opts = [unet_opt] + ([eft_opt] if cfg.train_eft else [])
        self.draws: List[Dict] = []
        # in bf16, the UNet's network in bf16 over its own f32 parameters
        dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.unet = (models.unet if dtype == torch.float32
                     else unet_compute_view(models.unet, dtype))
        self.eft_query = _EFTQuery(models.eft)
        self.ddp_modules = []
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            from torch.nn.parallel import DistributedDataParallel as DDP

            self.unet = DDP(self.unet)
            self.ddp_modules.append(self.unet)
            if cfg.train_eft:
                self.eft_query = DDP(self.eft_query)
                self.ddp_modules.append(self.eft_query)

    def _denoise(self, x, log_snr, cond_images, keep_mask):
        # the UNet's output is f32 in either dtype: the eps loss is f32
        self.models.unet_evals += 1
        return self.unet(x, log_snr, cond_images, keep_mask)

    def scene_losses(self, batch: Dict, i: int,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict] = None):
        """(loss, d_loss, color_loss) of scene ``i`` of ``batch``; the
        depth range is the batch's ``depth_range`` (host floats) where it
        has one, else computed on the device from the context cameras."""
        cfg, models = self.cfg, self.models
        draws = draws or {}
        hw, dbs = cfg.latent_size, cfg.diffusion_batch_size
        q_rgb = batch["query_rgb"][i]
        q_valid = batch["query_valid"][i]
        if "depth_range" in batch:
            min_d, max_d = batch["depth_range"][i]
        else:
            min_d, max_d = scene_depth_range(batch["context_cams"][i])

        with record_function("train/eft"), \
                torch.set_grad_enabled(cfg.train_eft):
            bundle = grid_ray_bundle(batch["query_cam"][i], hw, hw,
                                     cfg.eft_n_pts, min_d, max_d)
            rgb, feat = self.eft_query(
                batch["context_rgb"][i].permute(0, 3, 1, 2).contiguous(),
                bundle.origins.reshape(-1, 3),
                bundle.directions.reshape(-1, 3),
                bundle.lengths.reshape(-1, cfg.eft_n_pts),
                batch["context_cams"][i])
        rgb = rgb.reshape(hw, hw, 3)
        feat = feat.reshape(hw, hw, -1)

        with record_function("train/vae_encode"), torch.no_grad():
            z = models.vae_encode(q_rgb[None])            # (1, 4, h, w)
        z_b = z.expand(dbs, *z.shape[1:])
        feat_b = feat.permute(2, 0, 1)[None].expand(dbs, -1, -1, -1)
        mask = resize_bilinear(q_valid[None], (hw, hw))[0]
        mask = (mask > cfg.valid_thresh).float()            # (h, w, 1)
        loss_mask = mask.permute(2, 0, 1)[None].expand(dbs, -1, -1, -1)

        times = draws.get("times")
        if times is None:
            times = models.ddpm.schedule.sample_random_times(dbs, generator)
        drawn = {"times": times}
        self.draws.append(drawn)
        with record_function("train/unet_loss"):
            d_loss = models.ddpm.p_losses(
                self._denoise, z_b, times, generator, cond_images=feat_b,
                loss_mask=loss_mask, noise=draws.get("noise"),
                keep_mask=draws.get("keep"), drawn=drawn)

        color_loss = torch.zeros((), device=d_loss.device)
        if cfg.train_eft:
            xys = bundle.xys.reshape(1, -1, 2)
            gt = grid_sample_bilinear(q_rgb[None], -xys).reshape(hw, hw, 3)
            color_loss = (huber(rgb, gt) * mask).abs().mean()
        return d_loss + color_loss, d_loss, color_loss

    def losses_and_gradients(self, batch: Dict,
                             generator: Optional[torch.Generator] = None,
                             draws: Optional[List[Dict]] = None
                             ) -> torch.Tensor:
        """The trained models' gradients of the batch's mean loss (in
        ``.grad``) and the (3,) means (loss, d_loss, color_loss),
        detached."""
        n = batch["query_rgb"].shape[0]
        for opt in self.opts:
            opt.zero_grad()
        self.draws = []
        sums = torch.zeros(3, device=batch["query_rgb"].device)
        for i in range(n):
            losses = self.scene_losses(batch, i, generator,
                                       draws[i] if draws else None)
            # one backward per scene; under DDP the gradients are averaged
            # over processes with the last scene's
            with contextlib.ExitStack() as stack:
                if i < n - 1:
                    for module in self.ddp_modules:
                        stack.enter_context(module.no_sync())
                (losses[0] / n).backward()
            sums += torch.stack([x.detach() for x in losses])
        return sums / n

    def __call__(self, batch: Dict, generator: Optional[torch.Generator] = None,
                 draws: Optional[List[Dict]] = None):
        means = self.losses_and_gradients(batch, generator, draws)
        with record_function("train/guard"):
            if any(opt.guard for opt in self.opts):
                # one device reduction per optimizer, one host read
                finite = (torch.cat([opt.nonfinite_flag() for opt in self.opts])
                          == 0).tolist()
            else:
                finite = [True] * len(self.opts)
        with record_function("train/adam"):
            for opt, ok in zip(self.opts, finite):
                opt.step(ok)
        loss, d_loss, color_loss = means
        return loss, d_loss, color_loss

    def program(self, batch: Dict, generator: Optional[torch.Generator] = None,
                draws: Optional[List[Dict]] = None) -> torch.Tensor:
        """The step with no host read, as the JAX step's one program: the
        (3,) means (loss, d_loss, color_loss) on the device.  The depth
        range comes from the context cameras on the device where
        ``batch`` has no host ``depth_range``, the draws from
        ``generator`` in the eager step's order, and each optimizer takes
        its guarded update on the device (:meth:`GuardedAdam.step_on_device`).
        ``train/fused.py`` captures it into CUDA graphs."""
        means = self.losses_and_gradients(batch, generator, draws)
        with record_function("train/guard"):
            flags = [opt.nonfinite_flag() if opt.guard else None
                     for opt in self.opts]
        with record_function("train/adam"):
            for opt, flag in zip(self.opts, flags):
                opt.step_on_device(flag)
        return means


def make_train_step(models, cfg: TrainConfig, unet_opt: GuardedAdam,
                    eft_opt: Optional[GuardedAdam] = None) -> TrainStep:
    """The train step over the bundle's UNet and EFT (updated in place)."""
    return TrainStep(models, cfg, unet_opt, eft_opt)
