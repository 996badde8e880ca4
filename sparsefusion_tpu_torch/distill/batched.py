"""Scene-batched diffusion distillation: S scenes on one device, in lockstep.

Counterpart of ``sparsefusion_tpu/distill/batched.py``.  The JAX package
vmaps its per-scene step functions over a leading scene axis, so S NGPs
are optimised in one program an iteration.  On the card the same move
pays for the same reason: the loop is launch-bound, and a Python loop
over scenes would multiply the launches by S.  Here the scene axis is
written out: the S fields' parameters are one :class:`NGPFieldStack`, and
every operation of an iteration is one launch for all S scenes — the
grid encode forward and backward (one K1 launch each over S tables),
each MLP layer (one batched matmul), the renderer over (S, R, 3) rays,
the occupancy grids' update, and one VAE encode, one PLMS chain at UNet
batch S and one VAE decode for the fusion targets.  The step bodies are
the sequential loop's (``loop.SceneSteps``), written over the scene
axis, so the two paths cannot drift.

Schedule semantics match the sequential loop (iteration count, fusion /
bootstrap switch, occupancy cadence, marching and the polish tail);
randomness differs only in bookkeeping, as in the JAX package: scene s
draws its camera indices from its own ``RandomState(17 + 1013 s)``, and
the fusion ``max_thres`` is drawn from one ``RandomState(29)`` once an
iteration and shared by all S scenes, which keeps one PLMS step count for
the batch (each scene's marginal stays Uniform[0, 1)).  The loss of a
step is the sum of the scenes' own losses, so each scene's gradient is
its own, as under ``vmap``, and one Adam over the stacked parameters is S
independent ones (Adam is elementwise and its step count is shared).

All scenes must share the image size, the frame count and the context
size; callers bucket ragged scene lists (``cli/demo.py``).  The JAX
loop's ``mesh`` (scenes sharded over the local chips) has no counterpart:
the port's demo shards scenes over processes, one card each.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from sparsefusion_tpu_torch.core.cameras import (
    concat_cameras,
    get_camera_slice,
    get_relative_cameras,
)
from sparsefusion_tpu_torch.data.contract import SceneData
from sparsefusion_tpu_torch.distill.loop import (
    OCC_GRID_SIZE,
    DistillConfig,
    _occupied_share,
    _save_outputs,
    build_feature_cache,
    evaluate_scene,
    make_ngp_optimizer,
    make_scene_step_fns,
    occupancy_update_due,
    render_schedule,
)
from sparsefusion_tpu_torch.nn.ngp import NGPField, NGPFieldStack
from sparsefusion_tpu_torch.render.occupancy import OccupancyGrid
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig


def _check_stackable(scenes: Sequence[SceneData], input_idx_list) -> None:
    image_size = scenes[0].images.shape[1]
    n_frames = len(scenes[0])
    for s in scenes:
        if s.images.shape[1] != image_size or len(s) != n_frames:
            raise ValueError(
                "batched distillation needs equal image sizes and frame "
                f"counts; got {[(len(x), x.images.shape[1]) for x in scenes]}"
                " — bucket scenes by (n_frames, image_size) first")
    if len({len(idx) for idx in input_idx_list}) != 1:
        raise ValueError("batched distillation needs equal context sizes")


def batched_distillation_loop(
    models,
    scenes: Sequence[SceneData],
    input_idx_list: Sequence[Sequence[int]],
    cfg: DistillConfig,
    generator: torch.Generator,
    save_dir: Optional[str] = None,
    use_diffusion: bool = True,
    verbose: bool = True,
    lpips_fn=None,
) -> List[Dict[str, Any]]:
    """Optimise S NGPs (one a scene) in lockstep on the device of
    ``generator``, which makes every device draw; returns per-scene result
    dicts with the keys of :func:`loop.distillation_loop` (the iteration
    clock, render modes, fusion subset steps, UNet evaluations and
    occupancy updates are the batch's, shared by its scenes)."""
    S = len(scenes)
    if S == 0:
        return []
    _check_stackable(scenes, input_idx_list)
    if use_diffusion and models is None:
        raise ValueError("the diffusion arm needs the EFT/VAE/UNet models")
    device = generator.device
    image_size = scenes[0].images.shape[1]
    render_hw = image_size // cfg.hw_scale
    input_idx_list = [[int(i) for i in idx] for idx in input_idx_list]

    scene_vox = [get_relative_cameras(s.cameras(device), [0],
                                      center_at_origin=False)
                 for s in scenes]
    rgb = torch.stack([torch.as_tensor(s.images, device=device)
                       for s in scenes])                   # (S, N, H, W, 3)
    mask = None
    if all(s.masks is not None for s in scenes):
        mask = torch.stack([torch.as_tensor(s.masks, device=device)
                            for s in scenes])
    vcfg = VolumeRendererConfig(
        num_steps=cfg.num_steps, upsample_steps=cfg.upsample_steps,
        bound=cfg.bound, min_near=cfg.min_near,
        max_ray_batch=cfg.max_ray_batch)
    active_vcfg = render_schedule(cfg, vcfg)

    # ---- Phase A: every scene's EFT feature cache ----------------------
    caches, cache_seconds, n_cache = None, 0.0, 0
    if use_diffusion:
        t0 = time.time()
        caches = [build_feature_cache(models, s.cameras(device), rgb[i],
                                      input_idx_list[i], cfg, image_size)
                  for i, s in enumerate(scenes)]
        features = torch.stack([c["features"] for c in caches])
        eft_images = torch.stack([c["eft_images"] for c in caches])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        cache_seconds = time.time() - t0
        n_cache = len(caches[0]["cameras_vox"])
        if verbose:
            print(f"cached {S}x{n_cache} features in {cache_seconds:.1f}s")

    # ---- Phase B: S NGPs in lockstep -----------------------------------
    stack = NGPFieldStack([NGPField(cfg.ngp, device=device,
                                    generator=generator) for _ in range(S)])
    optimizer = make_ngp_optimizer(cfg, stack)
    steps = make_scene_step_fns(stack, cfg, optimizer, render_hw, image_size,
                                lpips_fn=lpips_fn, models=models)
    unet_evals0 = models.unet_evals if models is not None else 0

    occ_grid, bitfield, occupancy = None, None, None
    if cfg.use_occupancy:
        occ_grid = OccupancyGrid(bound=cfg.bound, grid_size=OCC_GRID_SIZE,
                                 density_thresh=cfg.density_thresh,
                                 device=device, n_scenes=S)
        bitfield = occ_grid.full_bitfield()
        occupancy = {"update_itrs": [], "update_seconds": [],
                     "occupied_share": [[] for _ in range(S)]}

    host_rngs = [np.random.RandomState(17 + 1013 * s) for s in range(S)]
    mt_rng = np.random.RandomState(29)
    scene_idx = torch.arange(S, device=device)
    losses = [[] for _ in range(S)]
    fusion_losses = [[] for _ in range(S)]
    iter_times = []
    render_modes = {"two_phase": 0, "march": 0}
    fusion_subset_steps = 0

    def pick(cams, idx):
        """One camera a scene: ``cams[s]``'s camera ``idx[s]``."""
        return concat_cameras([get_camera_slice(c, [i])
                               for c, i in zip(cams, idx)])

    t0 = time.time()
    for itr in range(cfg.max_itr):
        vc = active_vcfg(itr)
        render_modes["march" if vc.march_steps else "two_phase"] += 1
        if occupancy_update_due(cfg, itr):
            t_occ = time.time()
            occ_grid.update(lambda pts: stack(pts)[0], generator)
            bitfield = occ_grid.bitfield
            occupancy["update_itrs"].append(itr)
            occupancy["update_seconds"].append(time.time() - t_occ)
            for s in range(S):
                occupancy["occupied_share"][s].append(
                    _occupied_share(bitfield[s]))
        # host draws in the JAX batched loop's order: every scene's input
        # view, then every scene's cached camera; max_thres once, shared
        bi = [idx[r.randint(len(idx))]
              for idx, r in zip(input_idx_list, host_rngs)]
        bi_t = torch.as_tensor(bi, device=device)
        loss = steps.input_step(
            vc, pick(scene_vox, bi), rgb[scene_idx, bi_t],
            None if mask is None else mask[scene_idx, bi_t], generator,
            bitfield=bitfield)
        for s, v in enumerate(loss.tolist()):
            losses[s].append(v)
        if use_diffusion:
            ci = [int(r.randint(n_cache)) for r in host_rngs]
            ci_t = torch.as_tensor(ci, device=device)
            cam_f = concat_cameras([c["cameras_vox"][i]
                                    for c, i in zip(caches, ci)])
            if itr > cfg.start_fusion_step:
                mt = min(float(mt_rng.uniform()), 0.99)
                fusion_subset_steps += int(steps.subsample_fusion)
                floss = steps.fusion_step(vc, cam_f,
                                          features[scene_idx, ci_t], mt,
                                          generator, bitfield=bitfield)
            else:
                floss = steps.bootstrap_step(
                    vc, cam_f, eft_images[scene_idx, ci_t], generator,
                    bitfield=bitfield)
            for s, v in enumerate(floss.tolist()):
                fusion_losses[s].append(v)
        iter_times.append(time.time())
        if verbose and itr % 200 == 0:
            print(f"itr {itr:5d} loss "
                  f"{np.mean([l[-1] for l in losses]):.4f} "
                  f"({S * (itr + 1) / (time.time() - t0):.2f} scene-it/s)")

    # ---- Phase C: every scene's eval, as the sequential loop's ----------
    vcfg_eval = active_vcfg(cfg.max_itr)
    results = []
    for s, scene in enumerate(scenes):
        result = evaluate_scene(
            stack.field_at(s), scene, scene_vox[s], cfg, vcfg_eval,
            generator,
            steps.make_nff(None if bitfield is None else bitfield[s]),
            lpips_fn, verbose)
        scene_occupancy = None if occupancy is None else dict(
            occupancy, occupied_share=occupancy["occupied_share"][s])
        result.update({
            "losses": losses[s],
            "fusion_losses": fusion_losses[s],
            "cache_seconds": cache_seconds,
            # UNet evaluations of the batch, each at batch S
            "unet_evals": (models.unet_evals - unet_evals0
                           if models is not None else 0),
            "iter_times": iter_times,
            "occupancy": scene_occupancy,
            "render_modes": render_modes,
            "fusion_subset_steps": fusion_subset_steps,
        })
        if save_dir is not None:
            cache = None if caches is None else {
                "eft_images": eft_images[s]}
            _save_outputs(result, scene, cache, save_dir, verbose)
        results.append(result)
    return results
