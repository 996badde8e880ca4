#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only] [--csrc DIR]

f32 matmuls and convolutions run in full f32 throughout (``set_tf32(False)``
first), except in the TF32 train profile of step 7.

1. Prints the card (``nvidia-smi`` name and power limit).
2. Builds the port's CUDA kernels from ``sparsefusion_tpu_torch/csrc``
   (``--csrc DIR``: from another directory of sources with the same C
   entry points) and prints ptxas's registers, shared memory and spills
   per kernel and their SASS opcode counts (HMMA, HGMMA, RED, ATOM, LDG);
   both of K2's instances (f32 and bf16) must issue HMMA, and the bf16
   instance's wgmma body HGMMA, with no spills.
3. Kernel phase: the fused grid-encode kernel (K1), forward and table
   gradient, against its plain PyTorch version on the same inputs, at
   ``NGPConfig()`` width (16 levels x C2, f32) on 2,097,152 uniform
   points, on one launch of the main path (4096 rays x 64 samples in the
   renderer's order, ``ops/grid_encode.py::ray_ordered_points``), on as
   many uniform points, and on 65,536 copies of one point; at 8 x C4 with
   a bf16 table, and on a small hash grid.  Beside the forward's time on
   the two chunks: the 32-byte table sectors one launch reads (counted
   with the plain version's index math), per launch and per warp and
   level, and the sectors per second achieved.  The imagen attention kernel
   (K2), f32 and bf16 instances, each against its plain version in its
   type, at the UNet's shapes (1, 8, 16, 64) with 17 and 19 keys, at the
   train step's (12, 8, 16, 64) with 17 and 19 keys and at (2, 8, 1024,
   64) with 1027 keys (in bf16 also (2, 2, 2048, 16) and (2, 2, 2048,
   32) with 1027 keys, and (2, 8, 1024, 64) with 129, 513 and 2051: those
   run the bf16 instance's wgmma body, the UNet's shapes its mma_sync
   body, and each launch's body is checked by its counter),
   beside one ``scaled_dot_product_attention`` call in the same type as
   its yardstick (the port never calls it) and the plain backward's time;
   K2's bound is the largest of its bytes, its operations and its
   exponentials (rows x keys at 16 a clock on every SM at the maximum SM
   clock ``nvidia-smi`` prints); head dims 8 and 16 (bf16 also 32, and 64
   over 3 batches of 111 rows) at ragged shapes; head dim 48 through the
   dispatcher in both types (the plain version, no launch).  The row
   gather (K3) through the JAX micro-benchmark's counterpart,
   ``tools/gather_micro.py`` (its lines printed; K3's launches counted
   over it): (R, 128) bf16 tables for R in
   {8192, 16384, 32768} at N = 131,072 and 2,097,152 rows, bit-equal to
   its plain version and timed against one ``index_select``, with the
   bytes bound and the 32-byte sectors per second; one f32 case; indices
   outside [0, R) must give rows of zeros.  Times are device times by
   ``torch.profiler``, with CUDA-event times beside them; each kernel's
   bound is computed from the bytes and operations of its inputs.  Then
   the NGP-only demo's input step at full width under
   ``torch.profiler``: device time per step by kernel, K1's launches per
   step and its time per launch on the renderer's own points.
   ``--kernels-only`` stops here.
4. The TPU preset's input step (``tpu_distill_config()``) profiled as in
   step 3, in its two render modes: two-phase through the all-occupied
   bitfield, and the single-pass march inside the bitfield of one grid
   update.  Card against CPU: one input step on a small input, then one
   bootstrap step and one fusion step (narrow UNet and VAE, 2-step
   PLMS) from the same weights and draws; then with the bf16 sampler
   (``DistillConfig(sampler_bf16=True)``) the sampler's target of one
   image and one fusion step; then the occupancy grid's update (jitter
   passed in) and near/far tightening at the loop's 128^3 grid, and the
   TPU preset's marching input step and subsampled fusion step inside
   that bitfield.
5. The NGP-only demo at full width (``DistillConfig()``, ``NGPConfig()``,
   256 px, 100 iterations) through ``sparsefusion_tpu_torch.cli.demo.main``;
   then the TPU preset's (``--preset tpu``: 8 x C4 bf16 table, occupancy
   grid from iteration 500, single-pass 32-sample marching after it) for
   600 iterations: it/s before and after the switch, grid-update
   seconds, occupied share, K1's bf16 launches.
6. Main path: the full-width diffusion demo (``UNetConfig()``,
   ``VAEConfig()``, ``EFTConfig()``, 256 px, 40 iterations, fusion after
   iteration 20), through ``cli.demo.main`` and again through
   ``distillation_loop`` with ``DistillConfig(sampler_bf16=True)`` (30
   iterations) and with ``tpu_distill_config(occupancy_start=10,
   occupancy_update_every=8)`` (marching from iteration 10, fusion
   gradient steps on 4096 rays).  Each
   demo runs with the kernels' launch counts reset just before and read
   just after; K2 must launch three times per UNet evaluation (every
   attention layer of ``UNetConfig()`` has head dim 64, which K2 has an
   instance for; a head dim without one takes the plain version), in
   bf16 for the bf16 sampler.  Then one batch-1 UNet evaluation, as the
   sampler makes it, under ``torch.profiler`` in f32, TF32 and bf16:
   device and host ms, kernels per evaluation, by kernel class.
7. Training.  One train step of the tiny models (``--preset tiny``: K2
   at head dim 8) on the card against the CPU from the same weights,
   batch and draws, in f32 and with the UNet in bf16: loss, every
   gradient, the parameters after the guarded Adam step; then a NaN
   batch, which must leave the parameters bit-identical and count one
   skipped update.  Then the full-width training main path through
   ``sparsefusion_tpu_torch.cli.train.main`` (256 px, diffusion batch
   12, 2-5 context views), in f32 and with ``--bf16``: 20 steps with a
   checkpoint at 10 and at the end, then ``--resume`` for 2 more;
   steps/s over steps 2-20 (host clock, each step ends in a loss read),
   peak memory, K2 launches == 3 x UNet forwards in each run.  Then 3
   train steps under ``torch.profiler`` in each of f32, TF32
   (``set_tf32(True)``) and bf16 (``--bf16``): device ms per step by
   kernel class (convolutions, matmuls, K2) and by range (EFT, VAE
   encode, UNet loss, backward, K2's plain backward, guard, Adam),
   beside the step's bound at its precision (operations counted by
   ``sparsefusion_tpu_torch.tools.flops``); before each, one step on
   fixed draws whose loss and gradients are held against the f32 one.
   Then one full-width visualization grid (64-step ancestral sample),
   called directly.
8. Prints the kernels' JSON line (K2's bf16 instance an entry of its
   own; K3's launches are the micro's), then ``{"ok": true, "device":
   ...}`` as the last line.

Every check asserts or raises; the script exits non-zero without a
result when there is no CUDA device or the port is not importable.
"""
import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sparsefusion_tpu_torch.tools.flops import BF16_OPS_PER_S, F32_OPS_PER_S
from sparsefusion_tpu_torch.tools.profiling import (
    device_ms,
    event_ms,
    named_ms,
    profile_window,
)

N_POINTS = 16384 * 128          # rays x samples of one 128^2 input step
RAY_CHUNK = (4096, 64)          # rays x samples of one launch on the main path
TIMING_ITERS = 10
PROFILE_ITERS = 10
PROFILE_STEPS = 5
PROFILE_TRAIN_STEPS = 3
# NVIDIA H100 SXM data sheet: memory rate (the peaks of f32 outside the
# tensor cores and of bf16 on them are the flops tool's)
HBM_BYTES_PER_S = 3.35e12


_T0 = time.perf_counter()


def _mark(phase):
    """Seconds since the script started, printed after each phase: where
    the run's own time goes."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {phase} done", flush=True)


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _device_lines():
    print(_smi("name,power.limit"))
    print(f"torch device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"max SM clock {_sm_clock_hz() / 1e6:.0f} MHz, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")


_SM_CLOCK_HZ = []


def _sm_clock_hz():
    """The card's maximum SM clock, as ``nvidia-smi`` prints it in this
    run (read once)."""
    if not _SM_CLOCK_HZ:
        _SM_CLOCK_HZ.append(float(_smi("clocks.max.sm").split()[0]) * 1e6)
    return _SM_CLOCK_HZ[0]


# MUFU ex2: 16 results per SM per clock on compute capability 9.0
# (NVIDIA's table of arithmetic instruction throughput)
EX2_PER_SM_CLOCK = 16


def _bound(n_bytes, ops=0, ops_per_s=F32_OPS_PER_S, exps=0):
    """The least time the card could take: the largest of each input byte
    read once and each output byte written once at the memory rate, the
    operations at the peak of their type (f32 unless given), and ``exps``
    exponentials at the SFUs' rate on every SM at the maximum SM clock.
    Returns (ms, which of "bytes", "operations", "exponentials" set it)."""
    floors = {"bytes": n_bytes / HBM_BYTES_PER_S,
              "operations": ops / ops_per_s}
    if exps:
        floors["exponentials"] = exps / (
            EX2_PER_SM_CLOCK * _sm_clock_hz()
            * torch.cuda.get_device_properties(0).multi_processor_count)
    bound_by = max(floors, key=floors.get)
    return floors[bound_by] * 1e3, bound_by


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


SECTOR_BYTES = 32


def _table_sectors(x01, enc, table):
    """The 32-byte sectors of the table that one forward launch reads,
    counted with the plain version's index math on the points in the box:
    the distinct sectors of the whole launch, and the sum over every 32
    consecutive points (one warp of the kernel) and level of the distinct
    sectors their 8 corners touch."""
    from sparsefusion_tpu_torch.ops.grid_encode import grid_corner_rows

    row_bytes = enc.level_dim * table.element_size()
    sectors = grid_corner_rows(x01, enc).long() * row_bytes // SECTOR_BYTES
    inside = ((x01 >= 0) & (x01 <= 1)).all(-1)
    sectors = torch.where(inside[:, None, None], sectors,
                          torch.full_like(sectors, -1))
    n, levels, corners = sectors.shape
    distinct = torch.unique(sectors[inside]).numel()
    pad = -n % 32
    if pad:
        sectors = torch.cat([sectors, sectors.new_full(
            (pad, levels, corners), -1)])
    per_warp = sectors.view(-1, 32, levels, corners).transpose(1, 2) \
        .reshape(-1, 32 * corners).sort(dim=-1).values
    runs = (per_warp[:, 1:] != per_warp[:, :-1]).sum(-1) + 1
    warp = (runs - (per_warp[:, 0] < 0).long()).sum().item()
    return distinct, warp


def _kernel_case(name, enc, table_dtype, x01, gen, timed, sectors=False):
    from sparsefusion_tpu_torch.kernels.grid_encode import (
        grid_encode_cuda,
        grid_encode_cuda_backward,
    )
    from sparsefusion_tpu_torch.ops.grid_encode import grid_encode_plain

    dev = "cuda"
    n_points = x01.shape[0]
    master = torch.randn(enc.total_params, enc.level_dim, device=dev,
                         generator=gen) * 0.1
    grad_out = torch.randn(n_points, enc.output_dim, device=dev,
                           generator=gen)
    bf16 = table_dtype == "bfloat16"
    table = master.to(torch.bfloat16) if bf16 else master

    out_k = grid_encode_cuda(x01, table, enc)
    gt_k = grid_encode_cuda_backward(x01, grad_out, enc, bf16)
    torch.cuda.synchronize()
    master_p = master.clone().requires_grad_()
    out_p = grid_encode_plain(x01, master_p, enc, table_dtype)
    if (x01 == x01[:1]).all():
        # copies of one point: the plain version on that point with the
        # output gradients summed in f64 is the same gradient, without
        # the drift of the plain scatter's sequential f32 sum over N terms
        (gt_p,) = torch.autograd.grad(
            grid_encode_plain(x01[:1], master_p, enc, table_dtype),
            master_p, grad_out.double().sum(0, keepdim=True).float())
    else:
        (gt_p,) = torch.autograd.grad(out_p, master_p, grad_out,
                                      retain_graph=True)
    torch.cuda.synchronize()

    fwd_err = (out_k - out_p).abs().max().item()
    bwd_err = (gt_k - gt_p).abs().max().item()
    g_scale = gt_p.abs().max().item()
    # forward: identical f32 math, only the corner-sum order may differ;
    # backward: f32 atomics add in another order than the plain scatter,
    # so the error scales with the largest accumulated gradient
    fwd_tol = 1e-5
    bwd_tol = 1e-5 * max(1.0, g_scale)
    print(f"kernel {name}: N={n_points} L={enc.num_levels} "
          f"C={enc.level_dim} table={table_dtype or 'float32'} "
          f"fwd max_abs_err={fwd_err:.3e} (tol {fwd_tol:.1e}) "
          f"bwd max_abs_err={bwd_err:.3e} (tol {bwd_tol:.1e}, "
          f"max |grad| {g_scale:.3e})")
    assert torch.isfinite(out_k).all() and torch.isfinite(gt_k).all()
    assert fwd_err <= fwd_tol, f"{name}: forward disagrees"
    assert bwd_err <= bwd_tol, f"{name}: table gradient disagrees"

    times = None
    if timed:
        with torch.no_grad():
            fwd = device_ms(lambda: grid_encode_cuda(x01, table, enc),
                            PROFILE_ITERS)
            bwd = device_ms(lambda: grid_encode_cuda_backward(
                x01, grad_out, enc, bf16), PROFILE_ITERS)
            fwd_plain = device_ms(lambda: grid_encode_plain(
                x01, master, enc, table_dtype), PROFILE_ITERS)
            times = {
                "fwd_ms": named_ms(fwd, "grid_encode_fwd_kernel"),
                "fwd_event_ms": event_ms(
                    lambda: grid_encode_cuda(x01, table, enc), TIMING_ITERS),
                "fwd_plain_ms": sum(fwd_plain.values()),
                "bwd_ms": named_ms(bwd, "grid_encode_bwd_kernel"),
                "bwd_event_ms": event_ms(lambda: grid_encode_cuda_backward(
                    x01, grad_out, enc, bf16), TIMING_ITERS),
            }
        times["bwd_plain_ms"] = sum(device_ms(lambda: torch.autograd.grad(
            out_p, master_p, grad_out, retain_graph=True),
            PROFILE_ITERS).values())
        # bytes: points, table (read) or its f32 gradient (written), and
        # the (N, L*C) f32 encodings (written) or their gradient (read)
        times["fwd_bound_ms"], _ = _bound(_nbytes(x01, table, out_k))
        times["bwd_bound_ms"], _ = _bound(_nbytes(x01, grad_out, gt_k))
        if sectors:
            distinct, warp = _table_sectors(x01, enc, table)
            sec_s = 1e3 / times["fwd_ms"]
            times.update({
                "fwd_table_sectors": distinct,
                "fwd_table_sectors_per_s": distinct * sec_s,
                "fwd_warp_sectors": warp,
                "fwd_warp_sectors_per_s": warp * sec_s,
                "fwd_warp_sector_bytes_per_s": warp * SECTOR_BYTES * sec_s})
        print(f"kernel {name} device ms per call (torch.profiler, mean of "
              f"{PROFILE_ITERS}; *_event_ms: CUDA events over "
              f"{TIMING_ITERS} back-to-back calls): " + json.dumps(times))
    del out_p
    torch.cuda.synchronize()
    return fwd_err, bwd_err, times


def kernel_phase():
    from sparsefusion_tpu_torch.nn.ngp import NGPConfig
    from sparsefusion_tpu_torch.ops.grid_encode import (
        make_grid_encoding,
        ray_ordered_points,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)

    def uniform(n):
        # a few points leave the unit box, as clipped render points can
        return torch.rand(n, 3, device="cuda", generator=gen) * 1.02 - 0.01

    ngp = NGPConfig().encoding()
    n_rays, n_samples = RAY_CHUNK
    cases = [
        ("ngp_16xC2_f32", ngp, None, uniform(N_POINTS), True),
        ("ngp_8xC4_bf16", NGPConfig(num_levels=8, level_dim=4).encoding(),
         "bfloat16", uniform(N_POINTS), True),
        ("hash_8xC2_f32", make_grid_encoding(
            num_levels=8, level_dim=2, base_resolution=16,
            log2_hashmap_size=14, gridtype="hash"), None, uniform(1 << 18),
         False),
        # one launch of the main path: a chunk of rays, samples fastest;
        # with the table sectors each launch reads
        ("ngp_16xC2_f32_rays", ngp, None,
         ray_ordered_points(n_rays, n_samples, gen, "cuda"), "sectors"),
        ("ngp_16xC2_f32_uniform_chunk", ngp, None,
         uniform(n_rays * n_samples), "sectors"),
        # worst case: every update of a level lands on the same 8 rows
        ("ngp_16xC2_f32_one_point", ngp, None,
         torch.full((65536, 3), 0.4321, device="cuda"), True),
    ]
    errs = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for name, enc, td, x01, timed in cases:
        f, b, t = _kernel_case(name, enc, td, x01, gen, bool(timed),
                               sectors=timed == "sectors")
        errs["fwd"] = max(errs["fwd"], f)
        errs["bwd"] = max(errs["bwd"], b)
        if t is not None:
            times[name] = t
    return errs, times


def small_input_step_check():
    """One full-width input step on a 16^2 render of a small scene, on the
    card and on the CPU from the same weights and draws."""
    from sparsefusion_tpu_torch.core.cameras import (
        get_camera_slice,
        get_relative_cameras,
    )
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.distill.loop import (
        DistillConfig,
        make_ngp_optimizer,
        make_scene_step_fns,
    )
    from sparsefusion_tpu_torch.nn.ngp import NGPField
    from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig

    cfg = DistillConfig(max_ray_batch=256)
    scene = make_synthetic_scene(n_views=2, image_size=32, seed=0)
    vcfg = VolumeRendererConfig(max_ray_batch=256)
    rng = np.random.RandomState(0)
    draws = {"jitter": torch.as_tensor(rng.rand(256, 64), dtype=torch.float32),
             "u": torch.as_tensor(rng.rand(256, 64), dtype=torch.float32)}
    init = NGPField(cfg.ngp, generator=torch.Generator().manual_seed(0))
    losses, grads = [], []
    for dev in ("cpu", "cuda"):
        field = NGPField(cfg.ngp, device=dev)
        field.load_state_dict(init.state_dict())
        steps = make_scene_step_fns(field, cfg, make_ngp_optimizer(cfg, field),
                                    16, 32)
        cam = get_camera_slice(get_relative_cameras(
            scene.cameras(dev), [0], center_at_origin=False), [0])
        loss = steps.input_losses(
            vcfg, cam, torch.as_tensor(scene.images[0], device=dev),
            torch.as_tensor(scene.masks[0], device=dev),
            draws={k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in field.named_parameters()})
    print(f"input step cpu vs cuda: loss {losses[0]:.7f} vs {losses[1]:.7f}")
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    for name, g_cpu in grads[0].items():
        rel = ((g_cpu - grads[1][name]).norm() / g_cpu.norm()).item()
        print(f"  grad {name}: relative (Frobenius) err {rel:.3e}")
        # sums in another order (atomics on the card), and exp differing
        # by an ulp between the CPU and CUDA, which alpha = 1 - exp(-x)
        # magnifies for near-empty samples and the inverse CDF of the
        # importance samples magnifies again; the JAX package and the
        # port's CPU path differ by up to 1.7e-2 the same way
        assert rel <= 5e-2, f"gradient of {name} disagrees"


def input_step_profile(preset="reference"):
    """The NGP-only demo's input step at full width (a 256 px synthetic
    scene, 128^2 renders): 5 warm steps, then PROFILE_STEPS steps under
    torch.profiler.  Reports device time per step by kernel, the kernels'
    launches per step, and the host clock per step (each step ends in a
    loss read).  ``preset`` "reference": ``DistillConfig()``,
    ``NGPConfig()``; "tpu": ``tpu_distill_config()`` (4096 of the 16,384
    rays, 8 x C4 bf16 table) in both of its render modes: 32+32 two-phase
    through the all-occupied bitfield, as before ``occupancy_start``, and
    the 32-sample march inside the bitfield of one grid update of the
    (untrained) field.  Returns {mode: stats}."""
    from sparsefusion_tpu_torch.core.cameras import (
        get_camera_slice,
        get_relative_cameras,
    )
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.distill.loop import (
        DistillConfig,
        make_ngp_optimizer,
        make_scene_step_fns,
        render_schedule,
        tpu_distill_config,
    )
    from sparsefusion_tpu_torch.kernels import grid_encode
    from sparsefusion_tpu_torch.nn.ngp import NGPField
    from sparsefusion_tpu_torch.render.occupancy import OccupancyGrid
    from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig

    cfg = tpu_distill_config() if preset == "tpu" else DistillConfig()
    size = 256
    scene = make_synthetic_scene(n_views=2, image_size=size, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    vcfg = VolumeRendererConfig(
        num_steps=cfg.num_steps, upsample_steps=cfg.upsample_steps,
        bound=cfg.bound, min_near=cfg.min_near,
        max_ray_batch=cfg.max_ray_batch)
    field = NGPField(cfg.ngp, device="cuda", generator=gen)
    steps = make_scene_step_fns(field, cfg, make_ngp_optimizer(cfg, field),
                                size // cfg.hw_scale, size)
    cams = get_relative_cameras(scene.cameras("cuda"), [0],
                                center_at_origin=False)
    rgb = torch.as_tensor(scene.images, device="cuda")
    mask = torch.as_tensor(scene.masks, device="cuda")
    modes = {preset: (vcfg, None)}
    if preset == "tpu":
        grid = OccupancyGrid(bound=cfg.bound,
                             density_thresh=cfg.density_thresh, device="cuda")
        schedule = render_schedule(cfg, vcfg)
        modes = {"tpu_two_phase": (schedule(0), grid.full_bitfield()),
                 "tpu_march": (schedule(cfg.occupancy_start), grid.update(
                     lambda p: field(p)[0], gen).bitfield)}
    out = {}
    for label, (vc, bitfield) in modes.items():
        def step(i):
            v = i % 2
            return float(steps.input_step(vc, get_camera_slice(cams, [v]),
                                          rgb[v], mask[v], gen,
                                          bitfield=bitfield))

        for i in range(5):
            step(i)
        torch.cuda.synchronize()

        def run():
            for i in range(PROFILE_STEPS):
                step(i)

        per_step, _, host_ms = profile_window(
            run, PROFILE_STEPS, reset=grid_encode.reset_launches)
        launches = {"grid_encode_fwd": grid_encode.grid_encode_cuda.launches
                    / PROFILE_STEPS,
                    "grid_encode_bwd": grid_encode.grid_encode_cuda_backward
                    .launches / PROFILE_STEPS}
        device_ms = sum(per_step.values())
        k1 = {"fwd_ms": named_ms(per_step, "grid_encode_fwd_kernel"),
              "bwd_ms": named_ms(per_step, "grid_encode_bwd_kernel")}
        stats = {"device_ms_per_step": device_ms, "host_ms_per_step": host_ms,
                 "launches_per_step": launches,
                 "k1_fwd_ms_per_step": k1["fwd_ms"],
                 "k1_bwd_ms_per_step": k1["bwd_ms"],
                 "k1_fwd_ms_per_launch": k1["fwd_ms"]
                 / launches["grid_encode_fwd"],
                 "k1_bwd_ms_per_launch": k1["bwd_ms"]
                 / launches["grid_encode_bwd"]}
        if bitfield is not None:
            stats["occupied_share"] = float(np.unpackbits(
                bitfield.cpu().numpy()).mean())
        print(f"input step profile ({label}, mean of "
              f"{PROFILE_STEPS} steps): " + json.dumps(stats))
        for name, ms in sorted(per_step.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:8.3f} ms/step ({100 * ms / device_ms:5.1f}%) "
                  f"{name[:110]}")
        assert launches["grid_encode_fwd"] > 0 \
            and launches["grid_encode_bwd"] > 0
        out[label] = stats
    return out


ATTN_SHAPES = [(1, 8, 16, 64, 17), (1, 8, 16, 64, 19),
               (12, 8, 16, 64, 17), (12, 8, 16, 64, 19),
               (2, 8, 1024, 64, 1027)]
# bf16 also times the long shapes at head dims 16 and 32 and, at the long
# shape's rows, 129, 513 and 2051 keys (2, 5 and 17 of the wgmma body's
# 128-key tiles: its fixed time and its time a tile)
ATTN_BF16_LONG_SHAPES = [(2, 2, 2048, 16, 1027), (2, 2, 2048, 32, 1027),
                         (2, 8, 1024, 64, 129), (2, 8, 1024, 64, 513),
                         (2, 8, 1024, 64, 2051)]
# head dims 8 and 16 (the tiny UNet's 8), and in bf16 also 32: ragged rows
# and keys around the 64- and 128-key tiles; bf16 also H*N = 111 rows of 3
# batches over 257 keys (the wgmma body's 128-row CTAs straddle batches)
ATTN_SMALL_D_SHAPES = [(1, 1, 5, 8, 1), (12, 2, 16, 8, 17),
                       (3, 4, 37, 8, 257), (12, 2, 16, 16, 129),
                       (2, 2, 2048, 16, 1027)]
ATTN_BF16_SMALL_SHAPES = [(1, 1, 5, 32, 1), (3, 4, 37, 32, 257),
                          (3, 3, 37, 64, 257)]
# f32: the kernel's 3xTF32 products and online softmax sum in another
# order than the plain softmax.  bf16: |err| <= atol + rtol |plain|; the
# kernel rounds the unnormalised P and the plain version the normalised
# one, and each rounds its output once: one output ulp (2^-7 relative)
# plus P's rounding over the keys (tests/test_torch_kernels_cuda.py)
ATTN_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 2 ** -7)}
# K2's kernels by instance; bf16 has two bodies (kernels/attention.py::
# bf16_plan picks one per call)
K2_KERNELS = {
    torch.float32: {"f32": "imagen_attention_fwd_kernel"},
    torch.bfloat16: {"mma_sync": "imagen_attention_bf16_fwd_kernel",
                     "wgmma": "imagen_attention_bf16_wgmma_fwd_kernel"}}


def _sdpa_yardstick(q, k, v, want):
    """library_ms: the faster of one scaled_dot_product_attention call
    with the kv head broadcast by enable_gqa and one with k/v expanded
    over the heads, by device time.  Returns (ms, variant, backend, err
    against the plain version)."""
    import torch.nn.functional as F

    b, h = q.shape[:2]
    ke = k[:, None].expand(b, h, *k.shape[1:])
    ve = v[:, None].expand(b, h, *v.shape[1:])
    variants = {
        "enable_gqa": lambda: F.scaled_dot_product_attention(
            q, k[:, None], v[:, None], scale=1.0, enable_gqa=True),
        "expand": lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                         scale=1.0),
    }
    best = None
    for variant, fn in variants.items():
        try:
            err = (fn() - want).abs().max().item()
        except (TypeError, RuntimeError) as e:  # enable_gqa: torch >= 2.5
            print(f"  sdpa {variant}: not available ({e})")
            continue
        by_name = device_ms(fn, PROFILE_ITERS)
        ms = sum(by_name.values())
        names = " ".join(by_name).lower()
        backend = next((name for key, name in (
            ("flash", "flash"), ("fmha", "efficient"),
            ("efficient", "efficient"), ("cudnn", "cudnn"))
            if key in names), "math")
        print(f"  sdpa {variant}: {ms:.4f} ms device, backend {backend}, "
              f"max_abs_err {err:.3e}; kernels {sorted(by_name)}")
        if best is None or ms < best[0]:
            best = (ms, variant, backend, err)
    if best is None:
        raise RuntimeError("no scaled_dot_product_attention variant ran")
    return best


def _attn_inputs(b, h, n, d, j, gen, dtype):
    q = torch.randn(b, h, n, d, device="cuda", generator=gen) * d ** -0.5
    k = torch.randn(b, j, d, device="cuda", generator=gen)
    v = torch.randn(b, j, d, device="cuda", generator=gen)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _attn_err(got, want, dtype):
    """(max |got - want|, whether it is within the dtype's tolerance)."""
    atol, rtol = ATTN_TOL[dtype]
    err = (got.float() - want.float()).abs()
    return err.max().item(), bool((err <= atol + rtol * want.float().abs())
                                  .all())


def attention_phase(dtype=torch.float32):
    """K2's instance for ``dtype`` against its plain version in that type;
    returns the largest error, per shape the body that ran (bf16: by the
    plan and by its counter), the kernel's device time, its event time,
    the plain version's and the library's device times, the plain
    backward's, and the bound; and the launches of each body over the
    phase.  Then D = 48 through the dispatcher: the plain version, no
    launch."""
    from sparsefusion_tpu_torch.kernels import attention
    from sparsefusion_tpu_torch.kernels.attention import imagen_attention_cuda
    from sparsefusion_tpu_torch.ops.attention import (
        imagen_attention_backward_plain,
        imagen_attention_plain,
    )

    bf16 = dtype == torch.bfloat16
    kernels = K2_KERNELS[dtype]
    names = tuple(kernels.values())
    ops_per_s = BF16_OPS_PER_S if bf16 else F32_OPS_PER_S
    atol, rtol = ATTN_TOL[dtype]
    tol = f"tol {atol:.0e} + {rtol:.2e} |plain|"
    gen = torch.Generator(device="cuda").manual_seed(1)
    err_max, times = 0.0, {}
    by_body = dict.fromkeys(kernels, 0)

    def checked_launch(q, k, v, b, h, n, d, j):
        """One launch, counted by body; bf16: the counter must name the
        body the plan chose."""
        attention.reset_launches()
        out = imagen_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        if not bf16:
            by_body["f32"] += 1
            return out, "f32"
        body = attention.bf16_plan(b, h * n, j, d).body
        wgmma = imagen_attention_cuda.launches_bf16_wgmma
        assert wgmma == (body == "wgmma"), (body, wgmma)
        by_body[body] += 1
        return out, body

    timed = ATTN_SHAPES + (ATTN_BF16_LONG_SHAPES if bf16 else [])
    for b, h, n, d, j in timed:
        q, k, v = _attn_inputs(b, h, n, d, j, gen, dtype)
        g = torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
        out_k, body = checked_launch(q, k, v, b, h, n, d, j)
        out_p = imagen_attention_plain(q, k, v)
        err, ok = _attn_err(out_k, out_p, dtype)
        name = f"q{(b, h, n, d)}_J{j}".replace(" ", "")
        print(f"kernel {kernels[body]} {name}:")
        lib_ms, variant, backend, lib_err = _sdpa_yardstick(q, k, v, out_p)
        bound_ms, bound_by = _bound(_nbytes(q, k, v, out_k),
                                    4 * b * h * n * j * d, ops_per_s,
                                    exps=b * h * n * j)
        times[name] = {
            "body": body,
            "ms": named_ms(device_ms(lambda: imagen_attention_cuda(q, k, v),
                                     PROFILE_ITERS), names),
            "event_ms": event_ms(lambda: imagen_attention_cuda(q, k, v),
                                 TIMING_ITERS),
            "plain_ms": sum(device_ms(lambda: imagen_attention_plain(q, k, v),
                                      PROFILE_ITERS).values()),
            "plain_event_ms": event_ms(
                lambda: imagen_attention_plain(q, k, v), TIMING_ITERS),
            # the autograd backward of the kernel's Function: plain math
            "plain_backward_ms": sum(device_ms(
                lambda: imagen_attention_backward_plain(q, k, v, g),
                PROFILE_ITERS).values()),
            "library_ms": lib_ms, "library_variant": variant,
            "library_backend": backend, "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}
        print(f"  {json.dumps(times[name])} ({tol})")
        assert torch.isfinite(out_k.float()).all()
        assert ok, f"K2 {dtype} disagrees at {name}"
        err_max = max(err_max, err)
    small = ATTN_SMALL_D_SHAPES + (ATTN_BF16_SMALL_SHAPES if bf16 else [])
    for b, h, n, d, j in small:
        if bf16 and (b, h, n, d, j) in ATTN_BF16_LONG_SHAPES:
            continue   # timed above
        q, k, v = _attn_inputs(b, h, n, d, j, gen, dtype)
        out_k, body = checked_launch(q, k, v, b, h, n, d, j)
        err, ok = _attn_err(out_k, imagen_attention_plain(q, k, v), dtype)
        print(f"kernel {kernels[body]} q{(b, h, n, d)}_J{j}: max_abs_err "
              f"{err:.3e} ({tol})")
        assert torch.isfinite(out_k.float()).all()
        assert ok, f"K2 {dtype} disagrees at D = {d}"
        err_max = max(err_max, err)
    # a head dim without an instance: the dispatcher takes the plain
    # version (the reference runs any head dim); the kernel refuses it
    q, k, v = _attn_inputs(2, 4, 16, 48, 19, gen, dtype)
    attention.reset_launches()
    routed = attention.imagen_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.imagen_attention_cuda.launches == 0
    assert torch.equal(routed, imagen_attention_plain(q, k, v))
    try:
        imagen_attention_cuda(q, k, v)
    except ValueError:
        pass
    else:
        raise AssertionError("K2 took an unsupported head dim")
    print(f"K2 {dtype} at D = 48: the dispatcher ran the plain version, "
          f"no launch; the kernel refused it.  Checked launches by body: "
          f"{by_body}")
    return err_max, times, by_body


GATHER_POINTS = (131072, 2097152)   # the JAX micro's default N, and 16x


def row_gather_phase():
    """K3, the row gather of the JAX micro-benchmark: its entry point
    (``tools/gather_micro.py``: R in {8192, 16384, 32768}, bf16, the
    kernel bit-equal to its plain version and timed against one
    ``index_select``) at N = 131,072 and 2,097,152, with K3's launch count
    reset just before and read just after (the micro is K3's path); then,
    not counted, one f32 case (the micro's dtype parameter) and rows whose
    index lies outside [0, R), which must come back as zeros."""
    from sparsefusion_tpu_torch.kernels import row_gather as k3
    from sparsefusion_tpu_torch.ops.row_gather import row_gather_plain
    from sparsefusion_tpu_torch.tools import gather_micro

    torch.cuda.synchronize()
    k3.reset_launches()
    micro = {n: gather_micro.main([str(n)]) for n in GATHER_POINTS}
    torch.cuda.synchronize()
    launches = k3.row_gather_cuda.launches
    f32 = gather_micro.run(GATHER_POINTS[0], "cuda", torch.float32, (8192,))
    table, idx = gather_micro.make_inputs(8192, 4099, "cuda")
    bad = torch.arange(0, idx.numel(), 97, device="cuda")
    idx[bad] = torch.tensor([-1, 8192, 2 ** 31 - 1, -2 ** 31],
                            dtype=torch.int32, device="cuda").repeat(
        (bad.numel() + 3) // 4)[:bad.numel()]
    got = k3.row_gather_cuda(table, idx)
    torch.cuda.synchronize()
    good = torch.ones_like(idx, dtype=torch.bool)
    good[bad] = False
    assert torch.equal(got[bad], torch.zeros_like(got[bad])), \
        "K3 wrote a row for an index outside the table"
    assert torch.equal(got[good], row_gather_plain(table, idx[good]))
    print(f"K3: {bad.numel()} of {idx.numel()} indices outside [0, 8192) "
          "gave rows of zeros, the rest the table's rows")
    cases = [r for n in GATHER_POINTS for r in micro[n].values()] \
        + list(f32.values())
    assert all(r["correct"] for r in cases), "K3 disagrees with index_select"
    err = max(r["max_abs_err"] for r in cases)
    print(f"K3: launches on the micro's path {launches}; f32 (R=8192): "
          + json.dumps(f32[8192]))
    return launches, micro, f32, err


def _small_models(rng):
    """The narrow UNet (64-wide attention heads) and VAE of the steps
    checks, on the CPU, final conv randomised from ``rng``."""
    from sparsefusion_tpu_torch.models import build_models
    from sparsefusion_tpu_torch.nn.unet import UNetConfig
    from sparsefusion_tpu_torch.nn.vae import VAEConfig

    models = build_models(
        torch.Generator().manual_seed(0), "cpu",
        unet_config=UNetConfig(dim=64, dim_mults=(1, 2),
                               num_resnet_blocks=(1, 1),
                               layer_attns=(False, True), attn_heads=2,
                               attn_dim_head=64),
        vae_config=VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1))
    with torch.no_grad():   # a zero final conv would hide the UNet
        fc = models.unet.final_conv
        fc.weight.copy_(torch.as_tensor(
            rng.randn(*fc.weight.shape) * 0.05, dtype=torch.float32))
        fc.bias.copy_(torch.as_tensor(rng.randn(*fc.bias.shape) * 0.05,
                                      dtype=torch.float32))
    return models


def occupancy_card_check():
    """The occupancy pieces on the card against the CPU on the same inputs
    at the loop's grid (128^3, 3 cascades, bound 4):
    ``tools/card_checks.py::occupancy_card_vs_cpu``, which the card tests
    also run.  Returns the CPU's bitfield."""
    from sparsefusion_tpu_torch.tools.card_checks import occupancy_card_vs_cpu

    stats, bitfield = occupancy_card_vs_cpu("cuda")
    print("occupancy cpu vs cuda: " + json.dumps(stats))
    return bitfield


def small_occupancy_steps_check(bitfield):
    """The TPU preset's steps (8 x C4 bf16 table, single-pass 32-sample
    march inside ``bitfield``'s span): one input step on 128 of 256 rays
    and one subsampled fusion step (no-grad full render, narrow UNet and
    VAE, 2-step PLMS, gradient on 128 rays) on the card and on the CPU
    from the same weights and draws, at the steps checks' tolerances
    (loss 1e-5 / 1e-4 relative, gradients 5e-2 relative Frobenius)."""
    import copy

    from sparsefusion_tpu_torch.core.cameras import (
        get_camera_slice,
        get_relative_cameras,
    )
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.distill.loop import (
        make_ngp_optimizer,
        make_scene_step_fns,
        tpu_distill_config,
    )
    from sparsefusion_tpu_torch.nn.ngp import NGPField
    from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig

    cfg = tpu_distill_config(max_ray_batch=256, input_rays=128,
                             fusion_rays=128, plms_steps=2)
    vcfg = VolumeRendererConfig(num_steps=32, upsample_steps=32,
                                max_ray_batch=256, march_steps=32)
    scene = make_synthetic_scene(n_views=2, image_size=32, seed=0)
    rng = np.random.RandomState(1)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    draws_in = {"ray_idx": torch.as_tensor(rng.randint(0, 256, 128)),
                "jitter": f32(rng.rand(128, 32))}
    draws_f = {"jitter": f32(rng.rand(256, 32)),
               "fusion_ray_idx": torch.as_tensor(rng.randint(0, 256, 128)),
               "fusion_jitter": f32(rng.rand(128, 32))}
    plms_noise = [f32(rng.randn(1, 4, 4, 4)) for _ in range(4)]
    features = f32(rng.randn(256, 4, 4))
    mt = 0.6
    models_cpu = _small_models(rng)
    init = NGPField(cfg.ngp, generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        models = copy.deepcopy(models_cpu)
        for m in (models.eft, models.vae, models.unet):
            m.to(dev)
        field = NGPField(cfg.ngp, device=dev)
        field.load_state_dict(init.state_dict())
        steps = make_scene_step_fns(field, cfg, make_ngp_optimizer(cfg, field),
                                    16, 32, models=models)
        assert steps.subsample_fusion
        cams = get_relative_cameras(scene.cameras(dev), [0],
                                    center_at_origin=False)
        bits = bitfield.to(dev)
        res = {}
        for name, fn, args, draws in (
                ("march input", steps.input_losses,
                 (get_camera_slice(cams, [0]),
                  torch.as_tensor(scene.images[0], device=dev),
                  torch.as_tensor(scene.masks[0], device=dev)), draws_in),
                ("subsampled fusion", steps.fusion_losses,
                 (get_camera_slice(cams, [1]), features.to(dev), mt),
                 dict(draws_f, plms_noise=plms_noise))):
            field.zero_grad()
            loss = fn(vcfg, *args, draws={
                k: ([t.to(dev) for t in v] if isinstance(v, list)
                    else v.to(dev)) for k, v in draws.items()},
                bitfield=bits)
            loss.backward()
            res[name] = (loss.item(), {n: p.grad.cpu().clone()
                                       for n, p in field.named_parameters()})
        out[dev] = res
    stats = {}
    for name, loss_tol in (("march input", 1e-5), ("subsampled fusion", 1e-4)):
        (l_c, g_c), (l_g, g_g) = out["cpu"][name], out["cuda"][name]
        stats[f"{name} loss_rel"] = abs(l_c - l_g) / abs(l_c)
        stats[f"{name} grad_rel_max"] = max(
            ((g_c[n] - g_g[n]).norm() / g_c[n].norm()).item() for n in g_c)
        print(f"{name} step (TPU preset) cpu vs cuda: loss {l_c:.7f} vs "
              f"{l_g:.7f}; worst gradient {stats[f'{name} grad_rel_max']:.3e}")
        assert stats[f"{name} loss_rel"] <= loss_tol, name
        assert stats[f"{name} grad_rel_max"] <= 5e-2, name
        assert all(torch.isfinite(g).all() for g in g_g.values())
    return stats


def small_diffusion_steps_check(sampler_bf16=False):
    """One bootstrap step and one fusion step (narrow UNet and VAE with
    64-wide attention heads, randomised final conv, 2-step PLMS) on the
    card and on the CPU from the same weights and draws.  With
    ``sampler_bf16``: the sampler's target of one image and one fusion
    step, the UNet in bf16 on both sides (K2's bf16 instance on the
    card)."""
    import copy

    from sparsefusion_tpu_torch.kernels import attention
    from sparsefusion_tpu_torch.core.cameras import (
        get_camera_slice,
        get_relative_cameras,
    )
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.distill.loop import (
        DistillConfig,
        make_ngp_optimizer,
        make_scene_step_fns,
    )
    from sparsefusion_tpu_torch.nn.ngp import NGPField
    from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig

    cfg = DistillConfig(max_ray_batch=256, plms_steps=2,
                        sampler_bf16=sampler_bf16)
    scene = make_synthetic_scene(n_views=2, image_size=32, seed=0)
    vcfg = VolumeRendererConfig(max_ray_batch=256)
    rng = np.random.RandomState(0)
    render = {"jitter": torch.as_tensor(rng.rand(256, 64),
                                        dtype=torch.float32),
              "u": torch.as_tensor(rng.rand(256, 64), dtype=torch.float32)}
    # mt 0.6 -> 2 PLMS steps: the initial noise, 2 for step 0, 1 after
    mt = 0.6
    plms_noise = [torch.as_tensor(rng.randn(1, 4, 4, 4), dtype=torch.float32)
                  for _ in range(4)]
    features = torch.as_tensor(rng.randn(256, 4, 4), dtype=torch.float32)
    eft_img = torch.as_tensor(rng.rand(32, 32, 3), dtype=torch.float32)

    models_cpu = _small_models(rng)
    init = NGPField(cfg.ngp, generator=torch.Generator().manual_seed(0))
    out = []
    for dev in ("cpu", "cuda"):
        models = copy.deepcopy(models_cpu)
        for m in (models.eft, models.vae, models.unet):
            m.to(dev)
        field = NGPField(cfg.ngp, device=dev)
        field.load_state_dict(init.state_dict())
        steps = make_scene_step_fns(field, cfg, make_ngp_optimizer(cfg, field),
                                    16, 32, models=models)
        cam = get_camera_slice(get_relative_cameras(
            scene.cameras(dev), [0], center_at_origin=False), [1])
        draws = {k: v.to(dev) for k, v in render.items()}
        attention.reset_launches()
        res = {}
        phases = [("fusion", steps.fusion_losses, (features.to(dev), mt))]
        if sampler_bf16:
            res["target"] = steps.fusion_target(
                eft_img.to(dev), features.to(dev), mt,
                plms_noise=plms_noise)[0].cpu()
        else:
            phases.insert(0, ("bootstrap", steps.bootstrap_losses,
                              (eft_img.to(dev),)))
        for name, losses_fn, extra in phases:
            field.zero_grad()
            loss = losses_fn(vcfg, cam, *extra,
                             draws=dict(draws, plms_noise=plms_noise))
            loss.backward()
            res[name] = (loss.item(), {n: p.grad.cpu().clone()
                                       for n, p in field.named_parameters()})
        out.append((res, models.unet_evals,
                    attention.imagen_attention_cuda.launches_bf16))
    (cpu, evals_cpu, _), (gpu, evals_gpu, k2_bf16) = out
    evals = 6 if sampler_bf16 else 3
    assert evals_cpu == evals_gpu == evals, (evals_cpu, evals_gpu)
    assert k2_bf16 == (3 * evals if sampler_bf16 else 0), k2_bf16
    stats = {}
    if sampler_bf16:
        # the UNet in bf16 on both sides, rounding in other places
        # (cuDNN's bf16 convolutions against the CPU's): the target image
        # in [0, 1] to 5e-2, the loss to 1e-2 relative.  The gradients
        # are the f32 render's backward against that target; an L1's sign
        # flips where the render lies between the two targets, so they
        # are printed, not held to f32's 5e-2.
        stats["target_max_abs_err"] = (cpu["target"] - gpu["target"]).abs() \
            .max().item()
        print("bf16 sampler target cpu vs cuda: max abs err "
              f"{stats['target_max_abs_err']:.3e} (tol 5e-2)")
        assert stats["target_max_abs_err"] <= 5e-2
    for name, _, _ in phases:
        l_cpu, g_cpu = cpu[name]
        l_gpu, g_gpu = gpu[name]
        print(f"{name} step{' (bf16 sampler)' if sampler_bf16 else ''} cpu "
              f"vs cuda: loss {l_cpu:.7f} vs {l_gpu:.7f}")
        stats[f"{name}_loss_rel"] = abs(l_cpu - l_gpu) / abs(l_cpu)
        # f32: the renderer's draws are shared, its sums are not ordered
        # alike (see the input step)
        assert stats[f"{name}_loss_rel"] <= (1e-2 if sampler_bf16
                                             else 1e-4), name
        for pname, gc in g_cpu.items():
            rel = ((gc - g_gpu[pname]).norm() / gc.norm()).item()
            print(f"  grad {pname}: relative (Frobenius) err {rel:.3e}")
            assert torch.isfinite(g_gpu[pname]).all()
            assert sampler_bf16 or rel <= 5e-2, \
                f"{name}: gradient of {pname} disagrees"
    return stats


def unet_eval_profile(n_evals=PROFILE_ITERS):
    """One batch-1 evaluation of the full-width UNet as the sampler makes
    it (a 32 x 32 latent, 256 feature channels, no grad) in f32, in TF32
    (``set_tf32(True)``) and through the bf16 copy (``sampler_bf16``):
    device ms and kernels per evaluation, by kernel class, and the host
    ms per evaluation (``n_evals`` back to back, then a synchronise)."""
    from sparsefusion_tpu_torch.models import build_models
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    gen = torch.Generator(device="cuda").manual_seed(0)
    models = build_models(gen, "cuda")
    with torch.no_grad():   # a zero final conv would hide the UNet
        models.unet.final_conv.weight.normal_(0.0, 0.05, generator=gen)
    x = torch.randn(1, 4, 32, 32, device="cuda", generator=gen)
    log_snr = torch.full((1,), 0.5, device="cuda")
    cond = torch.randn(1, 256, 32, 32, device="cuda", generator=gen)
    out, stats = {}, {}
    for label, bf16, tf32 in (("float32", False, False),
                              ("tf32", False, True),
                              ("bfloat16", True, False)):
        set_tf32(tf32)

        def run(n):
            for _ in range(n):
                out[label] = models.denoise_fn(x, log_snr, cond, None,
                                               bf16=bf16)

        with torch.no_grad():
            run(3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(n_evals)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / n_evals
            per_eval, prof, _ = profile_window(lambda: run(n_evals),
                                                n_evals)
        launches = sum(e.count for e in prof.key_averages()
                       if e.key in per_eval) / n_evals
        by_class = {}
        for name, ms in per_eval.items():
            by_class[_kernel_class(name)] = by_class.get(
                _kernel_class(name), 0.0) + ms
        device_ms = sum(per_eval.values())
        stats[label] = {"device_ms": device_ms, "host_ms": host_ms,
                        "kernels_per_eval": launches,
                        "by_kernel_class": by_class}
        print(f"UNet evaluation ({label}, batch 1): "
              + json.dumps(stats[label]))
        for name, ms in sorted(per_eval.items(), key=lambda kv: -kv[1])[:6]:
            print(f"  {ms:8.3f} ms ({100 * ms / device_ms:5.1f}%) "
                  f"{name[:110]}")
    set_tf32(False)
    ref = out["float32"]
    for label in ("tf32", "bfloat16"):
        rel = ((out[label] - ref).norm() / ref.norm()).item()
        stats[label]["rel_err_vs_f32"] = rel
        print(f"UNet evaluation ({label}) against f32: relative "
              f"(Frobenius) err {rel:.3e}")
        assert torch.isfinite(out[label]).all() and rel <= 0.1, label
    del models
    torch.cuda.empty_cache()
    return stats


DEMO_ARGV = ["-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
             "--image_size", "256", "--max_itr", "40", "--start_fusion",
             "20", "--device", "cuda"]


# the TPU preset's diffusion run: occupancy from iteration 10, marching
# and the subsampled fusion step both live within 40 iterations
TPU_DIFFUSION_KW = dict(occupancy_start=10, occupancy_update_every=8)


def _loop_demo(argv, variant):
    """The demo's scene loop through ``distillation_loop`` with the CLI's
    models, scene, views and generator, and ``DistillConfig(sampler_bf16=
    True)`` (``variant`` "bf16_sampler"; the JAX demo CLI has no flag for
    it) or ``tpu_distill_config(**TPU_DIFFUSION_KW)`` ("tpu")."""
    from sparsefusion_tpu_torch.cli.demo import (
        build_trio,
        load_dataset,
        parse_args,
        select_input_views,
    )
    from sparsefusion_tpu_torch.distill.loop import (
        DistillConfig,
        distillation_loop,
        tpu_distill_config,
    )

    args = parse_args(argv)
    exp_dir = args.exp_dir
    for sub in ("log", "metrics", "render_imgs", "render_gifs"):
        os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)
    device = torch.device("cuda")
    models = build_trio(args, device)
    scene = load_dataset(args, device)[0]
    input_idx = select_input_views(args.val_seed, 0, len(scene),
                                   args.context_views)
    scene.sequence_name = f"any_000_c{len(input_idx)}"
    if variant == "tpu":
        cfg = tpu_distill_config(max_itr=args.max_itr,
                                 start_fusion_step=args.start_fusion,
                                 **TPU_DIFFUSION_KW)
    else:
        cfg = DistillConfig(max_itr=args.max_itr,
                            start_fusion_step=args.start_fusion,
                            sampler_bf16=True)
    generator = torch.Generator(device=device).manual_seed(args.val_seed)
    return [distillation_loop(models, scene, input_idx, cfg, generator,
                              save_dir=exp_dir)]


def diffusion_main_path(variant="f32", max_itr=40):
    """The full-width diffusion demo, ``max_itr`` iterations, fusion after
    20: through ``cli/demo.py::main`` (``variant`` "f32"), or through
    ``distillation_loop`` with the bf16 sampler ("bf16_sampler") or the
    TPU preset ("tpu": occupancy from iteration 10, single-pass marching,
    4096-ray input and fusion gradient steps)."""
    from sparsefusion_tpu_torch.cli.demo import main as demo_main

    sampler_bf16 = variant == "bf16_sampler"
    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        argv = DEMO_ARGV + ["--max_itr", str(max_itr), "--exp_dir", exp_dir]
        if variant == "f32":
            results = demo_main(argv)
        else:
            results = _loop_demo(argv, variant)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        written = {p: os.path.exists(os.path.join(exp_dir, p)) for p in (
            "metrics/any_000_c2.txt", "any_000_c2_ngp.npz",
            "render_gifs/any_000_c2.gif")}

    r = results[0]
    t = np.asarray(r["iter_times"])
    n_fusion = max_itr - 21                 # iterations 21..max_itr - 1
    boot_its = 20 / (t[20] - t[0])          # iterations 1..20
    fusion_s = t[max_itr - 1] - t[20]
    stats = {"phase_a_s": r["cache_seconds"], "bootstrap_it_per_s": boot_its,
             "fusion_it_per_s": n_fusion / fusion_s,
             "unet_evals": r["unet_evals"],
             "unet_evals_per_s": r["unet_evals"] / fusion_s,
             "peak_gib": peak / 2 ** 30, "wall_s": wall,
             "psnr": r["metrics"]["psnr"], "ssim": r["metrics"]["ssim"]}
    occ, modes = r["occupancy"], r["render_modes"]
    if variant == "tpu":
        stats.update({"render_modes": modes,
                      "fusion_subset_steps": r["fusion_subset_steps"],
                      "grid_update_itrs": occ["update_itrs"],
                      "grid_update_s": occ["update_seconds"],
                      "occupied_share": occ["occupied_share"]})
    label = "diffusion main path" + {"f32": "", "bf16_sampler":
                                     " (bf16 sampler)",
                                     "tpu": " (TPU preset)"}[variant]
    print(f"{label}: " + json.dumps(stats))
    print(f"{label}: launches {json.dumps(launches)}; "
          f"files {json.dumps(written)}")
    losses = np.asarray(r["losses"])
    fl = np.asarray(r["fusion_losses"])
    assert len(losses) == max_itr and np.isfinite(losses).all()
    assert len(fl) == max_itr and np.isfinite(fl).all()
    assert written["metrics/any_000_c2.txt"] and written["any_000_c2_ngp.npz"]
    assert r["renders"].shape == (10, 256, 256, 3)
    assert np.isfinite(r["renders"]).all()
    assert launches["grid_encode_fwd"] > 0 and launches["grid_encode_bwd"] > 0
    assert r["unet_evals"] > 0
    # three attention layers a forward, all at a kernel head dim (64)
    assert launches["imagen_attention"] == 3 * r["unet_evals"], launches
    assert launches["imagen_attention_bf16"] == (
        launches["imagen_attention"] if sampler_bf16 else 0), launches
    if variant == "tpu":
        # marching from the first grid update on (the preset sets no
        # polish tail), and the fusion gradient steps on ray subsets
        # (iterations 21..max_itr - 1)
        start = TPU_DIFFUSION_KW["occupancy_start"]
        assert occ["update_itrs"] == list(range(
            start, max_itr, TPU_DIFFUSION_KW["occupancy_update_every"])), occ
        assert modes == {"two_phase": start, "march": max_itr - start}, modes
        assert r["fusion_subset_steps"] == n_fusion, r["fusion_subset_steps"]
        assert launches["grid_encode_fwd_bf16"] == \
            launches["grid_encode_fwd"], launches
    else:
        assert occ is None and modes["march"] == 0, modes
        assert r["fusion_subset_steps"] == 0
    return launches, stats


def tpu_ngp_main_path():
    """The TPU preset's NGP-only demo at full width through the CLI
    (``--preset tpu --no_diffusion``, 256 px, 600 iterations: occupancy
    from iteration 500, so 7 grid updates and 100 marching iterations).
    K1's 8 x C4 bf16 instance must carry every forward launch."""
    from sparsefusion_tpu_torch.cli.demo import main as demo_main

    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        results = demo_main([
            "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
            "--image_size", "256", "--max_itr", "600", "--no_diffusion",
            "--preset", "tpu", "--device", "cuda", "--exp_dir", exp_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        files_ok = os.path.exists(os.path.join(exp_dir, "metrics",
                                               "any_000_c2.txt"))

    r = results[0]
    losses = np.asarray(r["losses"])
    t = np.asarray(r["iter_times"])
    occ = r["occupancy"]
    start = occ["update_itrs"][0] if occ["update_itrs"] else len(t)
    # grid updates inside the marching window (iterations start+1 ..)
    upd_after = sum(s for i, s in zip(occ["update_itrs"],
                                      occ["update_seconds"]) if i > start)
    stats = {
        "it_per_s_two_phase": (start - 1) / (t[start - 1] - t[0]),
        "it_per_s_march": (len(t) - 1 - start) / (t[-1] - t[start]),
        "it_per_s_march_without_grid_updates":
            (len(t) - 1 - start) / (t[-1] - t[start] - upd_after),
        "grid_update_itrs": occ["update_itrs"],
        "grid_update_s": occ["update_seconds"],
        "occupied_share": occ["occupied_share"],
        "render_modes": r["render_modes"], "peak_gib": peak / 2 ** 30,
        "wall_s": wall, "psnr": r["metrics"]["psnr"],
        "ssim": r["metrics"]["ssim"],
        "loss_first10": float(losses[:10].mean()),
        "loss_last10": float(losses[-10:].mean())}
    print("TPU preset NGP-only main path: " + json.dumps(stats))
    print(f"TPU preset NGP-only main path: launches {json.dumps(launches)}")
    assert len(losses) == 600 and np.isfinite(losses).all()
    assert stats["psnr"] >= 15.0, f"eval psnr {stats['psnr']} < 15"
    assert len(occ["update_itrs"]) >= 1 and occ["update_itrs"][0] == 500
    assert 0.0 < occ["occupied_share"][0] < 1.0, occ["occupied_share"]
    # marching from the first grid update (iteration 500) on
    assert r["render_modes"] == {"two_phase": 500, "march": 100}, \
        r["render_modes"]
    assert launches["grid_encode_fwd_bf16"] > 0
    assert launches["grid_encode_fwd_bf16"] == launches["grid_encode_fwd"]
    assert launches["grid_encode_bwd"] > 0
    assert files_ok and np.isfinite(r["renders"]).all()
    return launches, stats


def main_path():
    from sparsefusion_tpu_torch.cli.demo import main as demo_main
    from sparsefusion_tpu_torch.kernels.grid_encode import (
        grid_encode_cuda,
        grid_encode_cuda_backward,
        reset_launches,
    )

    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        results = demo_main([
            "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
            "--image_size", "256", "--max_itr", "100", "--no_diffusion",
            "--device", "cuda", "--exp_dir", exp_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"grid_encode_fwd": grid_encode_cuda.launches,
                    "grid_encode_bwd": grid_encode_cuda_backward.launches}
        peak = torch.cuda.max_memory_allocated()
        metrics_file = os.path.join(exp_dir, "metrics", "any_000_c2.txt")
        npz_file = os.path.join(exp_dir, "any_000_c2_ngp.npz")
        files_ok = os.path.exists(metrics_file) and os.path.exists(npz_file)
        npz = dict(np.load(npz_file)) if files_ok else {}

    r = results[0]
    losses = np.asarray(r["losses"])
    it = np.asarray(r["iter_times"])
    its = (len(it) - 1) / (it[-1] - it[0])
    psnr = r["metrics"]["psnr"]
    print(f"main path: {len(losses)} iterations, {its:.3f} it/s "
          f"(iterations 2-100), wall {wall:.2f} s incl. scene synthesis "
          f"and eval; peak memory {peak / 2 ** 30:.3f} GiB; launches "
          f"{json.dumps(launches)}")
    print(f"main path: loss first10 {losses[:10].mean():.5f} last10 "
          f"{losses[-10:].mean():.5f}; eval psnr {psnr:.3f} "
          f"ssim {r['metrics']['ssim']:.4f}")
    assert all(v > 0 for v in launches.values()), launches
    assert len(losses) == 100 and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean(), "loss did not fall"
    assert psnr >= 15.0, f"eval psnr {psnr} < 15"
    assert files_ok, "metrics file or params npz missing"
    assert npz["grid"].shape == (929336, 2) and all(
        np.isfinite(v).all() for v in npz.values())
    assert r["renders"].shape == (10, 256, 256, 3)
    assert np.isfinite(r["renders"]).all()
    return launches, {"it_per_s": its, "peak_gib": peak / 2 ** 30,
                      "wall_s": wall, "psnr": psnr}


TRAIN_TINY = ["-c", "any", "-d", "synthetic", "--preset", "tiny",
              "--image_size", "64", "--context_size", "2",
              "--diffusion_batch_size", "2"]


def _train_batch_and_draws(cfg, device):
    """A 64 px synthetic scene's batch (query 0, context 1-2) and fixed
    draws."""
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.train.trainer import prepare_scene_batch

    scene = make_synthetic_scene(n_views=4, image_size=64, seed=0)
    rng = np.random.RandomState(0)
    hw, dbs = cfg.latent_size, cfg.diffusion_batch_size
    draws = [{"times": torch.tensor(rng.uniform(0, 0.999, dbs),
                                    dtype=torch.float32, device=device),
              "noise": torch.tensor(rng.randn(dbs, 4, hw, hw),
                                    dtype=torch.float32, device=device),
              "keep": torch.tensor(rng.rand(dbs) < 0.9, device=device)}]
    return prepare_scene_batch([scene], [0], [[1, 2]], device), draws


# card against CPU, per compute dtype: loss (relative), gradients
# (relative Frobenius: f32 per parameter, bf16 over each model), Adam
# updates (relative Frobenius where |g| >= 1e-7).  bf16 rounds in other
# places on the two devices (cuDNN's bf16 convolutions against the CPU's),
# and a first Adam step is about lr * sign(g), which that rounding flips
# for small gradients
TRAIN_TOL = {"float32": {"loss": 1e-5, "grad": 1e-3, "update": 1e-3},
             "bfloat16": {"loss": 1e-2, "grad": 5e-2, "update": 0.5}}


def small_train_step_check(compute_dtype="float32"):
    """One train step of the tiny models (``--preset tiny``: UNet heads of
    8, K2 at D = 8; full-width EFT; 64 px, diffusion batch 2) on the card
    and on the CPU from the same weights, batch and draws, the UNet in
    ``compute_dtype`` on both: the losses, every gradient and the
    parameters after the guarded Adam step.  Then a NaN batch on the card:
    parameters bit-identical, one skipped update."""
    import copy

    from sparsefusion_tpu_torch.cli.train import build_trio, parse_args
    from sparsefusion_tpu_torch.kernels import attention
    from sparsefusion_tpu_torch.train.trainer import (
        TrainConfig,
        make_optimizers,
        make_train_step,
    )

    models_cpu = build_trio(parse_args(TRAIN_TINY), torch.device("cpu"))
    with torch.no_grad():   # a zero final conv would hide the UNet
        models_cpu.unet.final_conv.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    cfg = TrainConfig(latent_size=8, context_size=2, diffusion_batch_size=2,
                      compute_dtype=compute_dtype)
    tol = TRAIN_TOL[compute_dtype]
    bf16 = compute_dtype == "bfloat16"
    out = {}
    for dev in ("cpu", "cuda"):
        models = copy.deepcopy(models_cpu)
        for m in (models.eft, models.vae, models.unet):
            m.to(dev)
        unet_opt, eft_opt = make_optimizers(cfg, models)
        step = make_train_step(models, cfg, unet_opt, eft_opt)
        batch, draws = _train_batch_and_draws(cfg, dev)
        attention.reset_launches()
        before = {f"{name}.{n}": p.detach().cpu().clone()
                  for name, m in (("unet", models.unet), ("eft", models.eft))
                  for n, p in m.named_parameters()}
        losses = [float(x) for x in step(batch, draws=draws)]
        params = {f"{name}.{n}": p for name, m in (("unet", models.unet),
                                                  ("eft", models.eft))
                  for n, p in m.named_parameters()}
        out[dev] = {"losses": losses, "before": before,
                    "grads": {k: p.grad.cpu() for k, p in params.items()},
                    "after": {k: p.detach().cpu() for k, p in params.items()},
                    "k2": attention.imagen_attention_cuda.launches,
                    "k2_bf16": attention.imagen_attention_cuda.launches_bf16}
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in params.values())
        if dev == "cuda":
            bad = dict(batch, query_rgb=batch["query_rgb"].clone())
            bad["query_rgb"][..., 0] = float("nan")
            kept = {k: p.detach().clone() for k, p in params.items()}
            loss = float(step(bad, draws=draws)[0])
            assert not math.isfinite(loss)
            assert unet_opt.notfinite == eft_opt.notfinite == 1
            assert all(torch.equal(p, kept[k]) for k, p in params.items()), \
                "a NaN batch moved the parameters"
            print(f"train step ({compute_dtype}) on a NaN batch: no "
                  "parameter moved, guard counts 1 / 1")
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu["k2"] == 0 and gpu["k2"] == 3, (cpu["k2"], gpu["k2"])
    assert gpu["k2_bf16"] == (3 if bf16 else 0), gpu["k2_bf16"]
    print(f"tiny train step ({compute_dtype}) cpu vs cuda: losses "
          f"{cpu['losses']} vs {gpu['losses']}")
    for a, b in zip(cpu["losses"], gpu["losses"]):
        assert abs(a - b) <= tol["loss"] * abs(a), (a, b)
    # f32 on both sides; the card's sums run in another order (cuDNN,
    # K2's 3xTF32).  A gradient that is zero but for rounding (a key bias
    # under a softmax) is held against 1e-4 of its model's gradient norm.
    worst = {"loss": max(abs(a - b) / abs(a) for a, b in
                         zip(cpu["losses"], gpu["losses"]) if a)}
    for model in ("unet", "eft"):
        names = [n for n in cpu["grads"] if n.startswith(model + ".")]
        g_norm = math.sqrt(sum(cpu["grads"][n].norm().item() ** 2
                               for n in names))
        worst[f"{model}_grad"] = 0.0
        for name in names:
            gc = cpu["grads"][name]
            err = (gc - gpu["grads"][name]).norm().item()
            rel = err / max(gc.norm().item(), 1e-4 * g_norm)
            worst[f"{model}_grad"] = max(worst[f"{model}_grad"], rel)
            assert bf16 or rel <= tol["grad"], \
                f"gradient of {name} disagrees: {rel:.3e}"
        g_c = torch.cat([cpu["grads"][n].ravel() for n in names])
        g_g = torch.cat([gpu["grads"][n].ravel() for n in names])
        worst[f"{model}_grad_model"] = ((g_c - g_g).norm()
                                        / g_c.norm()).item()
        assert worst[f"{model}_grad_model"] <= tol["grad"], model
        # the Adam step from those gradients, over the whole model.  A
        # first step moves an element by lr * g / (|g| + eps): about lr *
        # sign(g) where |g| >= 10 eps, which a gradient's rounding cannot
        # change; below that (gradients zero but for rounding) only the
        # bound |update| <= lr holds on each side.
        g_c = torch.cat([cpu["grads"][n].ravel() for n in names])
        up_c = torch.cat([(cpu["after"][n] - cpu["before"][n]).ravel()
                          for n in names])
        up_g = torch.cat([(gpu["after"][n] - gpu["before"][n]).ravel()
                          for n in names])
        big = g_c.abs() >= 1e-7
        rel = ((up_c - up_g)[big].norm() / up_c[big].norm()).item()
        worst[f"{model}_update"] = rel
        worst[f"{model}_elements_below_1e-7"] = int((~big).sum())
        assert rel <= tol["update"], \
            f"{model}: Adam updates disagree: {rel:.3e}"
        assert (up_c - up_g).abs().max().item() <= 2 * cfg.lr * (1 + 1e-3)
    print(f"tiny train step ({compute_dtype}) cpu vs cuda: worst relative "
          "(Frobenius) errors " + json.dumps(worst) + " over "
          f"{len(cpu['grads'])} parameters (tolerances {json.dumps(tol)})")
    return worst


def _reset_counts():
    from sparsefusion_tpu_torch.kernels import attention, grid_encode

    torch.cuda.synchronize()
    grid_encode.reset_launches()
    attention.reset_launches()


def _read_counts():
    """Launches since the last reset; ``imagen_attention`` counts both of
    K2's instances, ``imagen_attention_bf16`` the bf16 one,
    ``imagen_attention_bf16_wgmma`` the bf16 one's wgmma body;
    ``grid_encode_fwd_bf16`` K1 forward's launches on a bf16 table."""
    from sparsefusion_tpu_torch.kernels import attention, grid_encode

    torch.cuda.synchronize()
    return {"grid_encode_fwd": grid_encode.grid_encode_cuda.launches,
            "grid_encode_fwd_bf16":
                grid_encode.grid_encode_cuda.launches_bf16,
            "grid_encode_bwd": grid_encode.grid_encode_cuda_backward.launches,
            "imagen_attention": attention.imagen_attention_cuda.launches,
            "imagen_attention_bf16":
                attention.imagen_attention_cuda.launches_bf16,
            "imagen_attention_bf16_wgmma":
                attention.imagen_attention_cuda.launches_bf16_wgmma}


def train_main_path(counts, bf16=False):
    """Full-width training through the CLI (``--bf16``: the UNet in bf16):
    20 steps (checkpoints at 10 and at the end), then --resume for 2 more
    steps.  ``counts``: the step counts of
    ``sparsefusion_tpu_torch.tools.flops`` for the bound of the drawn
    context sizes at the step's precision."""
    from sparsefusion_tpu_torch.cli.train import main as train_main
    from sparsefusion_tpu_torch.tools.flops import step_bound_s

    argv = ["-d", "synthetic", "-c", "any", "--image_size", "256",
            "--save_itr", "10", "--vis_itr", "0", "--device", "cuda"]
    argv += ["--bf16"] if bf16 else []
    precision = "bfloat16" if bf16 else "float32"
    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir:
        argv += ["--exp_dir", exp_dir]
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        first = train_main(argv + ["--steps", "20"])
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        ckpt = os.path.join(exp_dir, "sf", "any", "ckpt_latest")
        ckpt_gib = os.path.getsize(ckpt) / 2 ** 30
        _reset_counts()
        resumed = train_main(argv + ["--steps", "22", "--resume", ckpt])
        launches_resumed = _read_counts()

    t = np.asarray(first["step_times"])
    sizes = first["context_sizes"][1:]
    bound_s = sum(step_bound_s(counts, nc, precision) for nc in sizes)
    saves = sum(first["checkpoint_seconds"])   # the one at step 10
    stats = {"steps_per_s": 19 / (t[19] - t[0]),       # steps 2..20
             "steps_per_s_without_checkpoint": 19 / (t[19] - t[0] - saves),
             "checkpoint_s": first["checkpoint_seconds"],
             "step_ms_median": float(np.median(np.diff(t)) * 1e3),
             "bound_steps_per_s": len(sizes) / bound_s,
             "step_ms_min": float(np.diff(t).min() * 1e3),
             "step_ms_max": float(np.diff(t).max() * 1e3),
             "context_sizes": first["context_sizes"],
             "peak_gib": peak / 2 ** 30, "wall_s": wall,
             "checkpoint_gib": ckpt_gib, "unet_forwards": first["unet_evals"],
             "loss_first5": float(np.mean(first["losses"][:5])),
             "loss_last5": float(np.mean(first["losses"][-5:])),
             "resumed_at": resumed["start_step"],
             "resumed_losses": resumed["losses"]}
    label = f"train main path ({precision})"
    print(f"{label}: " + json.dumps(stats))
    print(f"{label}: launches {json.dumps(launches)}; resumed run "
          f"{json.dumps(launches_resumed)}")
    assert len(first["losses"]) == 20 and np.isfinite(first["losses"]).all()
    assert first["notfinite"] == {"unet": 0, "eft": 0}
    assert first["params_without_grad"] == 0
    assert resumed["start_step"] == 20 and len(resumed["losses"]) == 2
    assert np.isfinite(resumed["losses"]).all()
    for run, counted in ((first, launches), (resumed, launches_resumed)):
        assert run["unet_evals"] > 0
        # three attention layers a forward, at a kernel head dim (64)
        assert counted["imagen_attention"] == 3 * run["unet_evals"], counted
        assert counted["imagen_attention_bf16"] == (
            counted["imagen_attention"] if bf16 else 0), counted
    both = {k: launches[k] + launches_resumed[k] for k in launches}
    return both, stats


def _kernel_class(name):
    low = name.lower()
    if "imagen_attention" in low:
        return "k2_forward"
    if any(key in low for key in ("conv", "implicit", "fprop", "dgrad",
                                  "wgrad", "cudnn", "winograd")):
        return "convolution"
    if any(key in low for key in ("gemm", "cutlass", "matmul")):
        return "matmul"
    return "other"


# record_function ranges of train/trainer.py on the host's thread
TRAIN_RANGES = {
    "eft_forward": "train/eft", "vae_encode": "train/vae_encode",
    "unet_forward_and_loss": "train/unet_loss", "guard": "train/guard",
    "adam": "train/adam"}


def _first_step(step, models, batch, n_context):
    """The loss and each model's flat gradient of one step from the
    profile's weights on fixed draws."""
    rng = np.random.RandomState(0)
    dbs, hw = step.cfg.diffusion_batch_size, step.cfg.latent_size
    draws = [{"times": torch.tensor(rng.uniform(0, 0.999, dbs),
                                    dtype=torch.float32, device="cuda"),
              "noise": torch.tensor(rng.randn(dbs, 4, hw, hw),
                                    dtype=torch.float32, device="cuda"),
              "keep": torch.tensor(rng.rand(dbs) < 0.9, device="cuda")}]
    loss = float(step(batch, draws=draws)[0])
    grads = {name: torch.cat([p.grad.ravel() for p in m.parameters()])
             for name, m in (("unet", models.unet), ("eft", models.eft))}
    return loss, grads


def train_step_profile(counts, precision="float32", reference=None,
                       n_context=3):
    """3 full-width train steps (after 2 warm ones) under torch.profiler:
    device ms per step by kernel class and by range, host ms per step, at
    ``precision``: ``float32``, ``tf32`` (``set_tf32(True)`` for this
    profile) or ``bfloat16`` (``--bf16``).  Before them, one step from
    the same weights (final conv randomised: a zero one would give the
    UNet no gradient) on fixed draws, whose loss and gradients are held
    against ``reference``, the f32 card step's ``(loss, grads)``.
    Returns (stats, the visualization's stats or None, this first step's
    (loss, grads))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sparsefusion_tpu_torch.cli.train import build_trio, parse_args
    from sparsefusion_tpu_torch.core.cameras import get_relative_cameras
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.tools.flops import step_bound_s
    from sparsefusion_tpu_torch.train.trainer import (
        TrainConfig,
        make_optimizers,
        make_train_step,
        prepare_scene_batch,
    )
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    set_tf32(precision == "tf32")
    models = build_trio(parse_args(["-c", "any"]), torch.device("cuda"))
    with torch.no_grad():
        models.unet.final_conv.weight.normal_(
            0.0, 0.05, generator=torch.Generator(device="cuda").manual_seed(3))
    cfg = TrainConfig(compute_dtype="bfloat16" if precision == "bfloat16"
                      else "float32")
    unet_opt, eft_opt = make_optimizers(cfg, models)
    step = make_train_step(models, cfg, unet_opt, eft_opt)
    scene = make_synthetic_scene(n_views=10, image_size=256, seed=0)
    batch = prepare_scene_batch([scene], [0], [list(range(1, 1 + n_context))],
                                "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(n):
        for _ in range(n):
            float(step(batch, gen)[0])

    first = _first_step(step, models, batch, n_context)
    gap = {}
    if reference is not None:
        gap["loss_rel"] = abs(first[0] - reference[0]) / abs(reference[0])
        for name, g in first[1].items():
            want = reference[1][name]
            gap[f"{name}_grad_rel"] = ((g - want).norm()
                                       / want.norm()).item()
        print(f"first train step ({precision}) against the f32 card step: "
              + json.dumps(gap))
        assert math.isfinite(first[0])
    run(2)
    torch.cuda.synchronize()
    evals0 = []

    def reset():
        _reset_counts()
        evals0[:] = [models.unet_evals]

    # kernels alone first (the device timeline by kernel name), then the
    # same steps with the host ops, whose device time falls into ranges
    per_step, _, host_ms = profile_window(
        lambda: run(PROFILE_TRAIN_STEPS), PROFILE_TRAIN_STEPS, reset=reset)
    launches = _read_counts()
    unet_forwards = models.unet_evals - evals0[0]
    device_ms = sum(per_step.values())
    by_class = {}
    for name, ms in per_step.items():
        by_class[_kernel_class(name)] = by_class.get(_kernel_class(name),
                                                     0.0) + ms
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(PROFILE_TRAIN_STEPS)
    by_range = dict.fromkeys(
        list(TRAIN_RANGES) + ["backward", "k2_plain_backward"], 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        ms = max(getattr(e, a, 0) or 0 for a in (
            "device_time_total", "cuda_time_total")) / 1e3
        # the backward runs on the autograd engine's thread, one
        # evaluate_function range per node
        if e.name.startswith("autograd::engine::evaluate_function:"):
            by_range["backward"] += ms
            if "ImagenAttentionFunctionBackward" in e.name:
                by_range["k2_plain_backward"] += ms
        for key, label in TRAIN_RANGES.items():
            if e.name == label:
                by_range[key] += ms
    by_range = {k: v / PROFILE_TRAIN_STEPS for k, v in by_range.items()}
    bound_ms = max(counts["adam_bytes"] / HBM_BYTES_PER_S,
                   step_bound_s(counts, n_context, precision)) * 1e3
    bound_by = ("bytes" if counts["adam_bytes"] / HBM_BYTES_PER_S * 1e3
                >= bound_ms else "operations")
    stats = {"precision": precision, "first_step_vs_f32": gap,
             "context_views": n_context, "device_ms_per_step": device_ms,
             "host_ms_per_step": host_ms,
             "device_idle_share": max(0.0, 1 - device_ms / host_ms),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_share": bound_ms / device_ms,
             "by_kernel_class": by_class, "by_range": by_range,
             "k2_launches_per_step": launches["imagen_attention"]
             / PROFILE_TRAIN_STEPS,
             "k2_bf16_launches_per_step": launches["imagen_attention_bf16"]
             / PROFILE_TRAIN_STEPS,
             "unet_forwards_per_step": unet_forwards / PROFILE_TRAIN_STEPS}
    print(f"train step profile ({precision}, mean of {PROFILE_TRAIN_STEPS} "
          f"steps, {n_context} context views): " + json.dumps(stats))
    for name, ms in sorted(per_step.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.3f} ms/step ({100 * ms / device_ms:5.1f}%) "
              f"{name[:110]}")
    assert stats["k2_launches_per_step"] == 3 * stats["unet_forwards_per_step"]
    assert stats["k2_bf16_launches_per_step"] == (
        stats["k2_launches_per_step"] if precision == "bfloat16" else 0)
    assert by_class.get("k2_forward", 0) > 0

    vis = None
    if precision == "float32":
        # the full-width visualization grid, called directly
        rel = get_relative_cameras(scene.cameras(), [0])
        vis = visualization_check(models, rel, scene)
    set_tf32(False)
    del models, step, unet_opt, eft_opt
    torch.cuda.empty_cache()
    return stats, vis, first


def visualization_check(models, rel, scene):
    """One [contexts | ground truth | EFT render | 64-step sample] grid at
    full width, from ``train/visualize.py`` (not the CLI's try/except)."""
    from sparsefusion_tpu_torch.core.cameras import get_camera_slice
    from sparsefusion_tpu_torch.train.trainer import scene_depth_range_from_cam
    from sparsefusion_tpu_torch.train.visualize import save_visualization

    near, far = scene_depth_range_from_cam(rel)
    evals0 = models.unet_evals
    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as out_dir:
        t0 = time.perf_counter()
        grid = save_visualization(
            models, get_camera_slice(rel, [0]).to("cuda"),
            torch.as_tensor(scene.images[0], device="cuda"),
            get_camera_slice(rel, [1, 2]).to("cuda"),
            torch.as_tensor(scene.images[[1, 2]], device="cuda"), near, far,
            os.path.join(out_dir, "vis.jpg"),
            generator=torch.Generator(device="cuda").manual_seed(0))
        seconds = time.perf_counter() - t0
    stats = {"grid_shape": list(grid.shape), "seconds": seconds,
             "unet_forwards": models.unet_evals - evals0}
    print("visualization: " + json.dumps(stats))
    assert grid.shape == (256, 5 * 256, 3) and np.isfinite(grid).all()
    assert stats["unet_forwards"] == 64
    return stats


def _k2_entry(name, source, attn_err, attn_times, by_path, profile,
              by_body=None, phase_by_body=None):
    """One of K2's instances in the kernels line; the bf16 one with its
    launches by body on the main paths and in the kernel phase."""
    # K2 at the UNet's down_3/up_0 shape (19 keys): the demo's batch of 1
    # and the train step's diffusion batch of 12
    ta = attn_times["q(1,8,16,64)_J19"]
    tt = attn_times["q(12,8,16,64)_J19"]
    tl = attn_times["q(2,8,1024,64)_J1027"]
    bodies = {} if by_body is None else {
        "launches_by_body": by_body,
        "kernel_phase_launches_by_body": phase_by_body}
    return {**bodies,
        "name": name, "route": "cuda", "source": source,
        "replaces": "sparsefusion_tpu/kernels/attention.py:70",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": attn_err, "ms": ta["ms"],
        "event_ms": ta["event_ms"], "plain_ms": ta["plain_ms"],
        "bound_ms": ta["bound_ms"], "bound_by": ta["bound_by"],
        "library_ms": ta["library_ms"],
        "library_backend": ta["library_backend"],
        "train_shape": {key: tt[key] for key in (
            "ms", "plain_ms", "library_ms", "library_backend", "bound_ms",
            "bound_by", "plain_backward_ms")},
        "long_shape": {key: tl[key] for key in (
            "body", "ms", "library_ms", "library_backend", "bound_ms",
            "bound_by", "plain_ms")},
        "train_step_ms_per_step": profile["by_kernel_class"]["k2_forward"],
        "train_step_plain_backward_ms_per_step": profile["by_range"][
            "k2_plain_backward"],
        "shapes": {shape: {key: t[key] for key in (
            "body", "ms", "plain_ms", "library_ms", "library_backend",
            "bound_ms", "bound_by", "plain_backward_ms", "max_abs_err")}
            for shape, t in attn_times.items()}}


def _k3_entry(launches, micro, f32, err, k1_warp_sectors_per_s):
    """K3 in the kernels line: the 2,097,152-row case at R = 8192, bf16
    (its output, 16x the JAX micro's default, is ten times the L2) first,
    every case under ``cases``."""
    head = micro[GATHER_POINTS[1]][8192]
    keys = ("rows", "ms", "event_ms", "index_select_ms", "bound_ms",
            "bound_share", "sectors_per_s", "max_abs_err")
    cases = {f"N{n}_R{r}": {key: c[key] for key in keys}
             for n, by_r in micro.items() for r, c in by_r.items()}
    cases["N131072_R8192_f32"] = {key: f32[8192][key] for key in keys}
    return {
        "name": "row_gather", "route": "cuda",
        "source": "sparsefusion_tpu_torch/csrc/row_gather.cu",
        "replaces": "benchmarks/pallas_gather_micro.py:44",
        "launches": launches, "launches_by_path": {"gather_micro": launches},
        "max_abs_err": err, "ms": head["ms"], "event_ms": head["event_ms"],
        "plain_ms": head["index_select_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["index_select_ms"],
        "sectors_per_s": head["sectors_per_s"],
        "k1_fwd_warp_sectors_per_s_ray_points": k1_warp_sectors_per_s,
        "cases": cases}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel phase (steps 1-3)")
    parser.add_argument("--csrc", default=None,
                        help="build the kernels from this directory of "
                             "sources instead of the package's csrc/ (the "
                             "C entry points must match), e.g. to time "
                             "another commit's kernels in the same call")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sparsefusion_tpu_torch.kernels import _build
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    set_tf32(False)
    if args.csrc is not None:
        _build.CSRC = pathlib.Path(args.csrc).resolve()
    _device_lines()
    build_s = _build.timed_build()
    print(f"build: {build_s:.2f} s ({_build.library_path().name} from "
          f"{_build.CSRC})")
    print("ptxas -v:\n" + _build.resource_report())
    sass = _build.sass_counts()
    print("sass opcode counts: " + json.dumps(sass))
    # K2 bf16's wgmma body: warpgroup products (HGMMA) at every head dim,
    # and nothing spilled
    spills = _build.spill_bytes()
    wgmma_fns = [f for f in sass
                 if K2_KERNELS[torch.bfloat16]["wgmma"] in f]
    assert len(wgmma_fns) == 3, wgmma_fns
    for f in wgmma_fns:
        assert sass[f]["HGMMA"] > 0, f"{f} issues no HGMMA"
        assert spills.get(f) == 0, f"{f} spills {spills.get(f)} bytes"

    _mark("build")
    errs, times = kernel_phase()
    _mark("K1 kernel phase")
    attn_err, attn_times, _ = attention_phase(torch.float32)
    bf16_err, bf16_times, bf16_phase_bodies = attention_phase(torch.bfloat16)
    _mark("K2 kernel phase")
    k3_launches, k3_micro, k3_f32, k3_err = row_gather_phase()
    _mark("K3 kernel phase")
    step_stats = input_step_profile()["reference"]
    _mark("input step profile")
    if args.kernels_only:
        print(json.dumps({"kernel_times": times, "attention": attn_times,
                          "attention_bf16": bf16_times,
                          "row_gather": {str(n): m for n, m in
                                         k3_micro.items()},
                          "input_step": step_stats}))
        return 0
    for instance in ("imagen_attention_fwd", "imagen_attention_bf16_fwd"):
        assert any(c["HMMA"] > 0 for f, c in sass.items()
                   if instance in f), f"K2's {instance} issues no HMMA"
    input_step_profile("tpu")
    _mark("TPU preset input step profile")
    small_input_step_check()
    small_diffusion_steps_check()
    small_diffusion_steps_check(sampler_bf16=True)
    _mark("steps card vs CPU")
    small_occupancy_steps_check(occupancy_card_check())
    _mark("occupancy card vs CPU")
    ngp_launches, _ = main_path()
    tpu_ngp_launches, _ = tpu_ngp_main_path()
    _mark("NGP-only demos")
    launches, _ = diffusion_main_path()
    # 30 iterations: 9 fusion iterations where the others run 19, which
    # keeps the whole run within the time it took before the TPU preset's
    # paths were added
    bf16_launches, _ = diffusion_main_path("bf16_sampler", max_itr=30)
    tpu_launches, _ = diffusion_main_path("tpu")
    _mark("diffusion demos")
    unet_eval_profile()
    _mark("UNet evaluation profile")
    small_train_step_check()
    small_train_step_check("bfloat16")
    _mark("train steps card vs CPU")
    from sparsefusion_tpu_torch.tools.flops import train_step_counts

    counts = train_step_counts()
    train_launches, _ = train_main_path(counts)
    bf16_train_launches, _ = train_main_path(counts, bf16=True)
    _mark("train main paths")
    profiles = {}
    reference = None
    for precision in ("float32", "tf32", "bfloat16"):
        profiles[precision], _, first = train_step_profile(
            counts, precision, reference)
        if reference is None:
            reference = first
    del reference
    _mark("train step profiles")
    print("train step profiles: " + json.dumps({
        p: {key: s[key] for key in ("device_ms_per_step", "host_ms_per_step",
                                    "bound_ms", "bound_share",
                                    "first_step_vs_f32")}
        for p, s in profiles.items()}))
    paths = {"ngp_demo": {"grid_encode_fwd": ngp_launches["grid_encode_fwd"],
                          "grid_encode_bwd": ngp_launches["grid_encode_bwd"]},
             "diffusion_demo": launches, "train": train_launches,
             "diffusion_demo_bf16_sampler": bf16_launches,
             "train_bf16": bf16_train_launches,
             "tpu_preset_ngp_demo": tpu_ngp_launches,
             "tpu_preset_diffusion_demo": tpu_launches}

    def by_path(name, bf16=None):
        out = {}
        for path, counted in paths.items():
            n = counted.get(name, 0)
            if bf16 is not None:
                n_bf16 = counted.get("imagen_attention_bf16", 0)
                n = n_bf16 if bf16 else n - n_bf16
            out[path] = n
        return out

    wgmma_paths = by_path("imagen_attention_bf16_wgmma")
    bf16_paths = by_path("imagen_attention", bf16=True)
    bf16_bodies = {"mma_sync": sum(bf16_paths.values())
                   - sum(wgmma_paths.values()),
                   "wgmma": sum(wgmma_paths.values())}
    t = times["ngp_16xC2_f32"]
    tr = times["ngp_16xC2_f32_rays"]
    tu = times["ngp_16xC2_f32_uniform_chunk"]
    src = "sparsefusion_tpu_torch/csrc/grid_encode.cu"
    k2_src = "sparsefusion_tpu_torch/csrc/imagen_attention.cu"
    fwd_paths, bwd_paths = (by_path("grid_encode_fwd"),
                            by_path("grid_encode_bwd"))
    kernels = [
        {"name": "grid_encode_fwd", "route": "cuda", "source": src,
         "replaces": "sparsefusion_tpu/kernels/grid_gather.py:79",
         "launches": sum(fwd_paths.values()),
         "launches_by_path": fwd_paths,
         "max_abs_err": errs["fwd"], "ms": t["fwd_ms"],
         "event_ms": t["fwd_event_ms"], "plain_ms": t["fwd_plain_ms"],
         "bound_ms": t["fwd_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "fwd_ms_ray_points": tr["fwd_ms"],
         "bound_ms_ray_points": tr["fwd_bound_ms"],
         "warp_sectors_ray_points": tr["fwd_warp_sectors"],
         "fwd_ms_uniform_chunk": tu["fwd_ms"],
         "warp_sectors_uniform_chunk": tu["fwd_warp_sectors"]},
        {"name": "grid_encode_bwd", "route": "cuda", "source": src,
         "replaces": "sparsefusion_tpu/kernels/grid_gather.py:133",
         "launches": sum(bwd_paths.values()),
         "launches_by_path": bwd_paths,
         "max_abs_err": errs["bwd"], "ms": t["bwd_ms"],
         "event_ms": t["bwd_event_ms"], "plain_ms": t["bwd_plain_ms"],
         "bound_ms": t["bwd_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "bwd_ms_ray_points": tr["bwd_ms"],
         "bound_ms_ray_points": tr["bwd_bound_ms"],
         "bwd_ms_one_point": times["ngp_16xC2_f32_one_point"]["bwd_ms"]},
        _k2_entry("imagen_attention", k2_src, attn_err, attn_times,
                  by_path("imagen_attention", bf16=False),
                  profiles["float32"]),
        _k2_entry("imagen_attention_bf16", k2_src, bf16_err, bf16_times,
                  by_path("imagen_attention", bf16=True),
                  profiles["bfloat16"], bf16_bodies, bf16_phase_bodies),
        _k3_entry(k3_launches, k3_micro, k3_f32, k3_err,
                  tr["fwd_warp_sectors_per_s"]),
    ]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    assert all(k["launches"] > 0 for k in kernels), \
        [(k["name"], k["launches"]) for k in kernels]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
