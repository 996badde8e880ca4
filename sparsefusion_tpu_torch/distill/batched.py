"""Scene-batched diffusion distillation: S scenes on one device, in lockstep.

Counterpart of ``sparsefusion_tpu/distill/batched.py``.  The JAX package
vmaps its per-scene step functions over a leading scene axis and runs
each step of an iteration as one jitted program over all S scenes
(``_build_input``, ``_build_bootstrap``, ``_build_render``,
``_build_fusion_grad``; the fusion target one VAE encode, one PLMS chain
at UNet batch S and one VAE decode).  Here the scene axis is written
out: the S fields' parameters are one :class:`NGPFieldStack`, and every
operation of an iteration is one launch for all S scenes — the grid
encode forward and backward (one K1 launch each over S tables), each MLP
layer (one batched matmul), the renderer over (S, R, 3) rays, the
occupancy grids' update, and the sampler at UNet batch S.  The step
bodies are the sequential loop's (``loop.SceneSteps``), written over the
scene axis, so the two paths cannot drift.

Each iteration runs as the programs of ``distill/fused.py`` over the
scene axis, as in the sequential loop: on a CUDA device each is captured
once into a CUDA graph and replayed, with no host read between loss
reads, unless ``fused_steps`` is False (``--no_fused``), which runs them
uncaptured, as on the CPU.  They gather each iteration's cameras,
targets and features on the device from (S,) index tensors
(``core/cameras.py::pick_per_scene``, the JAX loop's ``_pick_cam``).
The occupancy grids' update runs eagerly between iterations and is
copied into the one bitfield buffer that the graphs read.

Schedule semantics match the sequential loop (iteration count, fusion /
bootstrap switch, occupancy cadence, marching and the polish tail);
randomness differs only in bookkeeping, as in the JAX package: scene s
draws its camera indices from its own ``RandomState(17 + 1013 s)``, and
the fusion ``max_thres`` is drawn from one ``RandomState(29)`` once an
iteration and shared by all S scenes, which keeps one PLMS step count for
the batch (each scene's marginal stays Uniform[0, 1)).  The loss of a
step is the sum of the scenes' own losses, so each scene's gradient is
its own, as under ``vmap``, and one Adam over the stacked parameters is S
independent ones (Adam is elementwise and its step count is shared; on a
CUDA device it is capturable and its staircase ticks on the device).

The losses are read as the sequential loop reads them: kept on the
device and fetched in one copy every ``loss_fetch_every`` iterations and
at the end (each a ``loss_read`` span).  The span recorder times the
batch as it times the sequential loop (``utils/spans.py``): Phase A of
all S scenes is one ``phase_a`` span, each iteration one
``distill/iteration`` unit.

All scenes must share the image size, the frame count and the context
size; callers bucket ragged scene lists (``cli/demo.py``).  The JAX
loop's ``mesh`` (scenes sharded over the local chips) has no counterpart:
the port's demo shards scenes over processes, one card each.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sparsefusion_tpu_torch.core.cameras import (
    concat_cameras,
    get_relative_cameras,
    stack_cameras,
)
from sparsefusion_tpu_torch.data.contract import SceneData
from sparsefusion_tpu_torch.distill.fused import FusedIterations
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
from sparsefusion_tpu_torch.utils import spans


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
    iteration_hook: Optional[Callable[[int], None]] = None,
) -> List[Dict[str, Any]]:
    """Optimise S NGPs (one a scene) in lockstep on the device of
    ``generator``, which makes every device draw; returns per-scene result
    dicts with the keys of :func:`loop.distillation_loop` (the spans,
    render modes, fusion subset steps, UNet evaluations and occupancy
    updates are the batch's, shared by its scenes)."""
    S = len(scenes)
    if S == 0:
        return []
    _check_stackable(scenes, input_idx_list)
    if use_diffusion and models is None:
        raise ValueError("the diffusion arm needs the EFT/VAE/UNet models")
    device = generator.device
    first_span = spans.mark()
    spans.use_device(device)
    image_size = scenes[0].images.shape[1]
    render_hw = image_size // cfg.hw_scale
    input_idx_list = [[int(i) for i in idx] for idx in input_idx_list]

    scene_vox = [get_relative_cameras(s.cameras(device), [0],
                                      center_at_origin=False)
                 for s in scenes]
    cams_vox = stack_cameras(scene_vox)                    # (S, N)
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
    cache, n_cache = None, 0
    if use_diffusion:
        with spans.setup_span("phase_a") as phase_a:
            caches = [build_feature_cache(models, s.cameras(device), rgb[i],
                                          input_idx_list[i], cfg,
                                          image_size)
                      for i, s in enumerate(scenes)]
            cache = {
                "cameras_vox": stack_cameras(
                    [concat_cameras(c["cameras_vox"])
                     for c in caches]),                        # (S, M)
                "features": torch.stack([c["features"] for c in caches]),
                "eft_images": torch.stack([c["eft_images"]
                                           for c in caches])}
            n_cache = len(caches[0]["cameras_vox"])
            del caches
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if verbose:
            print(f"cached {S}x{n_cache} features in "
                  f"{(phase_a.t1 - phase_a.t0) * 1e-9:.1f}s")

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
        # one buffer for the loop: each grid update is copied into it,
        # so the graphs read the new bitfields
        bitfield = occ_grid.full_bitfield()
        occupancy = {"update_itrs": [],
                     "occupied_share": [[] for _ in range(S)]}

    programs = FusedIterations(steps, generator, cams_vox, rgb, mask, cache,
                               bitfield)

    host_rngs = [np.random.RandomState(17 + 1013 * s) for s in range(S)]
    mt_rng = np.random.RandomState(29)
    losses = [[] for _ in range(S)]
    fusion_losses = [[] for _ in range(S)]
    # the losses stay on the device and are read in one copy every
    # loss_fetch_every iterations and at the end, as in the JAX loop
    loss_log = torch.zeros((2 if use_diffusion else 1, cfg.max_itr, S),
                           device=device)
    fetch_every = max(1, int(cfg.loss_fetch_every))
    fetched = 0

    def drain(itr):
        nonlocal fetched
        with spans.span("loss_read"):
            read = loss_log[:, fetched:itr + 1].tolist()
            spans.sync_point()
        for log, rows in zip((losses, fusion_losses), read):
            for row in rows:
                for s, v in enumerate(row):
                    log[s].append(v)
        fetched = itr + 1
    render_modes = {"two_phase": 0, "march": 0}
    fusion_subset_steps = 0

    t_start = time.perf_counter()
    for itr in range(cfg.max_itr):
        with spans.unit("distill/iteration", itr):
            vc = active_vcfg(itr)
            render_modes["march" if vc.march_steps else "two_phase"] += 1
            # occupancy maintenance of all S grids before the iteration's
            # steps, eagerly, as in the sequential loop
            if occupancy_update_due(cfg, itr):
                with spans.span("occupancy_update"):
                    occ_grid.update(lambda pts: stack(pts)[0], generator)
                    bitfield.copy_(occ_grid.bitfield)
                occupancy["update_itrs"].append(itr)
                for s in range(S):
                    occupancy["occupied_share"][s].append(
                        _occupied_share(bitfield[s]))
            # host draws in the JAX batched loop's order: every scene's
            # input view, then every scene's cached camera; max_thres
            # once, shared
            bi = [idx[r.randint(len(idx))]
                  for idx, r in zip(input_idx_list, host_rngs)]
            ci = mt = None
            if use_diffusion:
                ci = [int(r.randint(n_cache)) for r in host_rngs]
            fusion = use_diffusion and itr > cfg.start_fusion_step
            if fusion:
                mt = min(float(mt_rng.uniform()), 0.99)
                fusion_subset_steps += int(steps.subsample_fusion)
            loss, floss = programs.iteration(itr, vc, bi, ci, mt, fusion)
            loss_log[0, itr].copy_(loss)
            if floss is not None:
                loss_log[1, itr].copy_(floss)
            if (itr + 1) % fetch_every == 0 or itr == cfg.max_itr - 1:
                drain(itr)
            if verbose and itr % 200 == 0 and losses[0]:
                rate = S * (itr + 1) / (time.perf_counter() - t_start)
                print(f"itr {itr:5d} loss "
                      f"{np.mean([l[-1] for l in losses]):.4f} "
                      f"({rate:.2f} scene-it/s)")
        if iteration_hook is not None:
            iteration_hook(itr)

    # ---- Phase C: every scene's eval, as the sequential loop's ----------
    batch_spans = spans.snapshot(first_span)
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
            # UNet evaluations of the batch, each at batch S
            "unet_evals": (models.unet_evals - unet_evals0
                           if models is not None else 0),
            # the recorder's spans of the batch (distill/loop.py's)
            "spans": batch_spans,
            # the programs' graphs, warm-ups, captures and replays (the
            # batch's)
            "fused": programs.stats(),
            "occupancy": scene_occupancy,
            "render_modes": render_modes,
            "fusion_subset_steps": fusion_subset_steps,
        })
        if save_dir is not None:
            _save_outputs(result, scene, None if cache is None else {
                "eft_images": cache["eft_images"][s]}, save_dir, verbose)
        results.append(result)
    return results
