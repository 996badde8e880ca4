#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only | --k1-only | --train-only]
                          [--csrc DIR]

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
   a bf16 table, and on a small hash grid.  K1's scene axis: four
   full-width tables (16 x C2 f32, and 8 x C4 read in bf16), each scene
   with one main-path launch's points, in one launch of each kernel: the
   forward bit-equal to four single launches, the table gradient within
   the backward's tolerance, timed against the four single launches.
   K1's table gradient on the card test's 65,536 copies of one point,
   200 launches, each within the f32 summation bound of its 65,536 terms
   (the error's spread printed).  Beside the forward's time on
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
   that bitfield; one scene-batched input, bootstrap and fusion step
   (S = 2, ``NGPFieldStack``) card against CPU.  The fused loop (the
   iterations as CUDA graphs, ``distill/fused.py``) against the eager
   loop from one seed at a small size (``DistillConfig()`` with the
   narrow UNet, and the TPU preset NGP-only), for one scene and for a
   batch of two in lockstep (``distill/batched.py``; the batch's graph
   programs first run eagerly under the sync debug mode's "error"),
   losses and fields within ``FUSED_TOL`` (the two-phase batch, whose
   eager spread reaches it, within ``TWO_PHASE_BATCH_TOL``, with a
   control whose graphs never see the iterations' draws and must leave
   it), with the eager loop against itself beside (K1's backward adds
   with atomics) and, with the occupancy grid, the bits each grid
   update sets unlike the eager run's; a replayed graph's
   draws bit-equal to the eager calls' from the same generator state.
5. The NGP-only demo at full width (``DistillConfig()``, ``NGPConfig()``,
   256 px, 100 iterations) through ``sparsefusion_tpu_torch.cli.demo.main``;
   then the TPU preset's (``--preset tpu``: 8 x C4 bf16 table, occupancy
   grid from iteration 500, single-pass 32-sample marching after it) for
   600 iterations: it/s before and after the switch, grid-update
   seconds, occupied share, K1's bf16 launches.  Then both again over
   four scenes with ``--scene_batch 4`` (``distill/batched.py``, each
   iteration as replayed CUDA graphs over the scene axis): scene
   iterations a second beside the single scene's rate, K1's launches in
   Phase B equal to the single-scene run's (each for all four scenes),
   no synchronising call in the profiled windows besides the loss reads,
   peak memory, every scene's PSNR >= 15; each batched demo again as its
   eager twin (``--no_fused``, the same iterations).  The demos run
   fused, as the card's default is; the single-scene NGP-only demo and
   the TPU preset's run again eagerly (``--no_fused``), and each pair
   prints
   it/s between the loop's loss reads (with and without the graphs'
   capture seconds), the host's synchronising calls an iteration (sync
   debug mode), a ``torch.profiler`` window's device and host ms an
   iteration and idle share, the graphs (captures, seconds, replays)
   and peak memory; K1's launches in each iteration equal the eager
   run's.
6. Main path: the full-width diffusion demo (``UNetConfig()``,
   ``VAEConfig()``, ``EFTConfig()``, 256 px, 40 iterations, fusion from
   iteration 20), fused, through ``cli.demo.main`` and again through
   ``distillation_loop`` with ``DistillConfig(sampler_bf16=True)`` (30
   iterations) and with ``tpu_distill_config(occupancy_start=10,
   occupancy_update_every=8)`` (marching from iteration 10, fusion
   gradient steps on 4096 rays); the f32 demo again eagerly for 30
   iterations and the bf16 sampler's for 25, each pair printed as in
   step 5 (the fusion window's device ms per UNet evaluation too).  Each
   demo runs with the kernels' launch counts reset just before and read
   just after (a replayed graph adds the launches it captured); K2 must
   launch three times per UNet evaluation (every
   attention layer of ``UNetConfig()`` has head dim 64, which K2 has an
   instance for; a head dim without one takes the plain version), in
   bf16 for the bf16 sampler.  Then one batch-1 UNet evaluation, as the
   sampler makes it, under ``torch.profiler`` in f32, TF32 and bf16:
   device and host ms, kernels per evaluation, by kernel class.  The
   diffusion demo over four scenes with ``--scene_batch 4`` as graphs
   (K2 three times a UNet evaluation, each at batch 4), and its eager
   twin for 25 iterations, printed as a pair.  LPIPS (seeded stand-in
   torchvision / lpips weights): the card against the CPU at 64 px, the
   device ms of the fusion step's perceptual term (forward and input
   backward at 256 px) beside its operations bound, and the diffusion
   demo with ``--lpips_weights``, 30 iterations (the eval's LPIPS column
   finite).
7. Training.  One train step of the tiny models (``--preset tiny``: K2
   at head dim 8) on the card against the CPU from the same weights,
   batch and draws, in f32 and with the UNet in bf16: loss, every
   gradient, the parameters after the guarded Adam step; then a NaN
   batch, which must leave the parameters bit-identical and count one
   skipped update.  The captured step (``train/fused.py``: a CUDA graph
   per context size) against the eager step on the tiny models, five
   steps at context sizes 2, 3, 2, 3, 2 in f32 and bf16: draws
   bit-equal, losses (free-running, and from the eager run's parameters
   at each step) and parameters within ``GRAPH_TOL``, beside the eager
   step against itself and a control whose updates are lost, which must
   leave the free-running bound; a NaN batch replayed in the graph that
   moves no parameter and counts one skip.
   Then the full-width training main path through
   ``sparsefusion_tpu_torch.cli.train.main`` (256 px, diffusion batch
   12, 2-5 context views), in f32 and with ``--bf16``, as on the card by
   default (a replayed graph a step): 10 steps, a checkpoint,
   ``--resume`` to step 110; and its eager twin (the eager step in the
   CLI's place) for 20 steps.  Each pair printed side by side: steps/s
   between two loss reads (50 and 100; the twin's 0 and 20), syncs a
   step between reads (sync debug mode; 0 for the graphs), a profiler
   window's device and host ms a step and idle share, captures and
   replays, peak memory (allocated, reserved); K2 launches == 3 x UNet
   forwards in each run.  Then 3 train steps under ``torch.profiler`` in
   each of f32, TF32 (``set_tf32(True)``) and bf16 (``--bf16``): device
   ms per step by kernel class (convolutions, matmuls, K2) and by range
   (EFT, VAE encode, UNet loss, backward, K2's plain backward, guard,
   Adam), beside the step's bound at its precision (operations counted
   by ``sparsefusion_tpu_torch.tools.flops``), host ms, idle share and
   syncs a step; the same step replayed as a graph, profiled the same
   way; before each, one step on fixed draws whose loss and gradients
   are held against the f32 one.  Then one full-width visualization grid
   (64-step ancestral sample), called directly.  (``--train-only``: K1's
   summation-bound check and this step alone.)
8. The JAX package's last modules.  Mesh export (``render/mesh.py``)
   from the fields of step 5's two NGP-only demos (16 x C2 f32, and the
   TPU preset's 8 x C4 read in bf16), rebuilt from their returned
   parameters: the 128^3 export and the textured export (``.obj``,
   ``.mtl``, ``.png``) over [-4, 4]^3 at density 10, K1's launches
   counted over them (32 for the grid, plus the bake's; the textured
   export on the first field only: the preset's field has millions of
   faces); the same extraction on the CPU through the plain encode: the
   density grids, face and vertex counts, the symmetric nearest-vertex
   distance and the atlas (the CPU's bake of the card's mesh, over the
   cells of its first 4096 faces) held within stated tolerances; K1 on one 65,536-point grid chunk against its plain
   version and its bytes bound; device ms of the grid and of the export,
   host seconds of the grid, the marching and the writes; the 256^3
   export for its times; the analytic blob field of scene 0 at 128^3,
   every vertex at the iso level within a stated share.  The parity
   sweep (``tools/make_toy_fixture.py`` at 256 px, then
   ``tools/parity_sweep.py``, full-width models): NGP-only at 2 and 3
   views for 100 iterations (PSNR >= 15) and one diffusion row under
   ``--preset tpu`` at 1002 iterations, the fewest that reach a fusion
   step, with the launch counts reset before each row and read after it
   (K2 three times a UNet evaluation).  The Perceiver resampler at the
   JAX package's default width, card against CPU.
9. Prints the kernels' JSON line (K2's bf16 instance, K1's
   scene-batched launches and K1's mesh launches entries of their own;
   K3's launches are the micro's), then ``{"ok": true, "device": ...}``
   as the last line.

Every check asserts or raises; the script exits non-zero without a
result when there is no CUDA device or the port is not importable.
"""
import argparse
import dataclasses
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


# the scene-batched loop's S on the card: four scenes in one launch
SCENES = 4


def scene_kernel_case(name, enc, table_dtype, gen):
    """K1's scene-batched launch: SCENES tables at ``enc``'s full width,
    each scene with one main-path launch's render points (RAY_CHUNK, in
    the renderer's order).  The batched forward must be bit-equal to
    SCENES single-scene launches and the batched table gradient within
    the backward's tolerance of theirs; both are held against the plain
    scene-batched version too.  Times: one batched launch against the
    SCENES single launches it replaces, beside its bytes bound."""
    from sparsefusion_tpu_torch.kernels import grid_encode as k1
    from sparsefusion_tpu_torch.ops.grid_encode import (
        grid_encode_plain,
        ray_ordered_points,
    )

    x = torch.stack([ray_ordered_points(*RAY_CHUNK, gen, "cuda")
                     for _ in range(SCENES)]).contiguous()
    n = x.shape[1]
    master = torch.randn(SCENES, enc.total_params, enc.level_dim,
                         device="cuda", generator=gen) * 0.1
    grad_out = torch.randn(SCENES, n, enc.output_dim, device="cuda",
                           generator=gen)
    bf16 = table_dtype == "bfloat16"
    table = master.to(torch.bfloat16) if bf16 else master
    k1.reset_launches()
    out = k1.grid_encode_cuda(x, table, enc)
    gt = k1.grid_encode_cuda_backward(x, grad_out, enc, bf16)
    torch.cuda.synchronize()
    assert (k1.grid_encode_cuda.launches, k1.grid_encode_cuda.scenes) == (
        1, SCENES)
    assert (k1.grid_encode_cuda_backward.launches,
            k1.grid_encode_cuda_backward.scenes) == (1, SCENES)

    def singles_fwd():
        return [k1.grid_encode_cuda(x[s], table[s], enc)
                for s in range(SCENES)]

    def singles_bwd():
        return [k1.grid_encode_cuda_backward(x[s], grad_out[s], enc, bf16)
                for s in range(SCENES)]

    fwd_equal = all(torch.equal(out[s], o)
                    for s, o in enumerate(singles_fwd()))
    bwd_err = max((gt[s] - g).abs().max().item()
                  for s, g in enumerate(singles_bwd()))
    g_scale = gt.abs().max().item()
    master_p = master.clone().requires_grad_()
    out_p = grid_encode_plain(x, master_p, enc, table_dtype)
    (gt_p,) = torch.autograd.grad(out_p, master_p, grad_out,
                                  retain_graph=True)
    torch.cuda.synchronize()
    fwd_err = (out - out_p).abs().max().item()
    plain_bwd_err = (gt - gt_p).abs().max().item()
    bwd_tol = 1e-5 * max(1.0, g_scale)
    print(f"kernel {name}: S={SCENES} N={n} L={enc.num_levels} "
          f"C={enc.level_dim} table={table_dtype or 'float32'}: forward "
          f"bit-equal to {SCENES} single launches: {fwd_equal}; backward "
          f"max_abs_err vs single launches {bwd_err:.3e}, vs plain "
          f"{plain_bwd_err:.3e} (tol {bwd_tol:.1e}); forward vs plain "
          f"{fwd_err:.3e} (tol 1e-5)")
    assert fwd_equal, f"{name}: batched forward differs from single launches"
    assert bwd_err <= bwd_tol and plain_bwd_err <= bwd_tol, name
    assert fwd_err <= 1e-5, name
    bwd_plain = device_ms(lambda: torch.autograd.grad(
        out_p, master_p, grad_out, retain_graph=True), PROFILE_ITERS)
    del out_p, gt_p, master_p

    with torch.no_grad():
        fwd = device_ms(lambda: k1.grid_encode_cuda(x, table, enc),
                        PROFILE_ITERS)
        fwd1 = device_ms(singles_fwd, PROFILE_ITERS)
        bwd = device_ms(lambda: k1.grid_encode_cuda_backward(
            x, grad_out, enc, bf16), PROFILE_ITERS)
        bwd1 = device_ms(singles_bwd, PROFILE_ITERS)
        plain = device_ms(lambda: grid_encode_plain(x, master, enc,
                                                    table_dtype),
                          PROFILE_ITERS)
    times = {
        "fwd_ms": named_ms(fwd, "grid_encode_fwd_kernel"),
        f"fwd_ms_{SCENES}_single_launches": named_ms(
            fwd1, "grid_encode_fwd_kernel"),
        "fwd_event_ms": event_ms(lambda: k1.grid_encode_cuda(x, table, enc),
                                 TIMING_ITERS),
        "fwd_plain_ms": sum(plain.values()),
        "bwd_ms": named_ms(bwd, "grid_encode_bwd_kernel"),
        f"bwd_ms_{SCENES}_single_launches": named_ms(
            bwd1, "grid_encode_bwd_kernel"),
        "bwd_plain_ms": sum(bwd_plain.values()),
        "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": plain_bwd_err,
    }
    # bytes: points, tables (read) or their f32 gradients (written), and
    # the (S, N, L*C) f32 encodings (written) or their gradient (read)
    times["fwd_bound_ms"], _ = _bound(_nbytes(x, table, out))
    times["bwd_bound_ms"], _ = _bound(_nbytes(x, grad_out, gt))
    print(f"kernel {name} device ms per call (torch.profiler, mean of "
          f"{PROFILE_ITERS}): " + json.dumps(times))
    return times


def scene_kernel_phase():
    """K1's scene axis at the loop's two widths: ``NGPConfig()`` (16 x C2,
    f32 tables) and the TPU preset's 8 x C4 read in bf16."""
    from sparsefusion_tpu_torch.nn.ngp import NGPConfig

    gen = torch.Generator(device="cuda").manual_seed(1)
    times = {
        "ngp_16xC2_f32": scene_kernel_case(
            f"ngp_16xC2_f32_{SCENES}_scenes", NGPConfig().encoding(), None,
            gen),
        "ngp_8xC4_bf16": scene_kernel_case(
            f"ngp_8xC4_bf16_{SCENES}_scenes",
            NGPConfig(num_levels=8, level_dim=4).encoding(), "bfloat16",
            gen)}
    torch.cuda.empty_cache()
    return times


# K1 backward on 65,536 copies of one point (the card test's
# ``identical_points`` case): launches whose error spread is recorded
K1_SPREAD_RUNS = 200


def k1_summation_bound_check(runs=K1_SPREAD_RUNS):
    """K1's table gradient on the card test's inputs (65,536 copies of one
    point, ``CASES["tiled"]``, seed 5), ``runs`` launches, against the
    double-summed gradient: each launch's largest error, and its largest
    share of the f32 summation bound, per element, gamma_n * sum_i
    |w g_i| + 2u |want| (u = 2^-24, n = 65,536 terms summed in any
    order, gamma_n = n u / (1 - n u); the second term the reference's two
    roundings).  Fails if a launch exceeds the bound."""
    from sparsefusion_tpu_torch.kernels import grid_encode as k1
    from sparsefusion_tpu_torch.ops.grid_encode import (
        grid_encode_plain,
        make_grid_encoding,
    )

    enc = make_grid_encoding(num_levels=4, level_dim=2, base_resolution=4,
                             log2_hashmap_size=9, per_level_scale=1.9,
                             gridtype="tiled")
    torch.manual_seed(5)
    x = torch.full((65536, 3), 0.4321, device="cuda")
    table = torch.randn(enc.total_params, enc.level_dim, device="cuda") * 0.5
    g = torch.randn(x.shape[0], enc.output_dim, device="cuda")
    tp = table.clone().requires_grad_()

    def plain(gsum):
        (out,) = torch.autograd.grad(
            grid_encode_plain(x[:1], tp, enc), tp,
            gsum.sum(0, keepdim=True).float())
        return out

    want = plain(g.double())
    absolute = plain(g.double().abs())
    u, n = 2.0 ** -24, x.shape[0]
    bound = n * u / (1 - n * u) * absolute + 2 * u * want.abs()
    errs, shares = [], []
    for _ in range(runs):
        got = k1.grid_encode_cuda_backward(x, g, enc, False)
        err = (got - want).abs()
        errs.append(err.max().item())
        shares.append((err / bound.clamp_min(1e-30)).max().item())
    scale = want.abs().max().item()
    stats = {"runs": runs, "max_abs_err": max(errs),
             "median_abs_err": float(np.median(errs)),
             "min_abs_err": min(errs),
             "max_share_of_bound": max(shares),
             "bound_max": bound.max().item(),
             "old_test_tolerance": 1e-5 * max(1.0, scale),
             "runs_over_old_tolerance": sum(
                 e > 1e-5 * max(1.0, scale) for e in errs)}
    print("K1 backward on 65,536 copies of one point, error spread: "
          + json.dumps(stats))
    assert max(shares) <= 1.0, stats
    return stats


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


def input_step_profile(preset="reference", n_scenes=None):
    """The NGP-only demo's input step at full width (a 256 px synthetic
    scene, 128^2 renders): 5 warm steps, then PROFILE_STEPS steps under
    torch.profiler.  Reports device time per step by kernel, the kernels'
    launches per step, and the host clock per step (each step ends in a
    loss read).  ``preset`` "reference": ``DistillConfig()``,
    ``NGPConfig()``; "tpu": ``tpu_distill_config()`` (4096 of the 16,384
    rays, 8 x C4 bf16 table) in both of its render modes: 32+32 two-phase
    through the all-occupied bitfield, as before ``occupancy_start``, and
    the 32-sample march inside the bitfield of one grid update of the
    (untrained) field.  With ``n_scenes``, the scene-batched input step
    of the batched loop: ``n_scenes`` fields stacked, each rendering the
    view at full width.  Returns {mode: stats}."""
    from sparsefusion_tpu_torch.core.cameras import (
        concat_cameras,
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
    from sparsefusion_tpu_torch.nn.ngp import NGPField, NGPFieldStack
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
    if n_scenes:
        field = NGPFieldStack([field] + [
            NGPField(cfg.ngp, device="cuda", generator=gen)
            for _ in range(n_scenes - 1)])
    steps = make_scene_step_fns(field, cfg, make_ngp_optimizer(cfg, field),
                                size // cfg.hw_scale, size)
    cams = get_relative_cameras(scene.cameras("cuda"), [0],
                                center_at_origin=False)
    rgb = torch.as_tensor(scene.images, device="cuda")
    mask = torch.as_tensor(scene.masks, device="cuda")
    modes = {f"{preset}_{n_scenes}_scenes" if n_scenes else preset:
             (vcfg, None)}
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
            cam, gt, m = get_camera_slice(cams, [v]), rgb[v], mask[v]
            if n_scenes:
                cam = concat_cameras([cam] * n_scenes)
                gt = gt.expand(n_scenes, *gt.shape)
                m = m.expand(n_scenes, *m.shape)
            return steps.input_step(vc, cam, gt, m, gen,
                                    bitfield=bitfield).sum().item()

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


FUSED_TOL = {"loss_rel": 1e-4, "param_rel": 2e-2}
# the two-phase batch of two (two-phase renders, K1's f32 atomics, Adam's
# first steps) spreads on an H100: its graphs from its eager twin by
# 2.6e-5-2.6e-4 in the losses and 0.0066-0.020 in the fields, the eager
# loop from itself by 1.3e-5-2.0e-4 and 0.0046-0.019, at FUSED_TOL's
# edge.  It is held above that spread; the check's control (its graphs
# with the index buffers loaded once: graphs that never see an
# iteration's draws) parts by 3.8 and 0.61 and must leave the bound
TWO_PHASE_BATCH_TOL = {"loss_rel": 1e-3, "param_rel": 0.1}


class _StrictWarmups:
    """Inside it, every graph program's first (eager) run, the one before
    its capture, runs under ``torch.cuda.set_sync_debug_mode("error")``:
    a host read or a pageable copy in a program raises there, before the
    capture would fail on it."""

    def __enter__(self):
        from sparsefusion_tpu_torch.utils.graphs import GraphRunner

        self._cls, self._run = GraphRunner, GraphRunner.run
        run = self._run

        def strict_run(runner, key, program, itr):
            def strict():
                torch.cuda.set_sync_debug_mode("error")
                try:
                    program()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            return run(runner, key, strict, itr)

        GraphRunner.run = strict_run
        return self

    def __exit__(self, *exc):
        self._cls.run = self._run
        return False


class _DrawsLoadedOnce:
    """Inside it, ``FusedIterations`` copies the host draws into its index
    buffers at the first iteration only: graphs that never see an
    iteration's draws (the fused-loop check's control)."""

    def __enter__(self):
        from sparsefusion_tpu_torch.distill.fused import FusedIterations

        self._cls, self._load = FusedIterations, FusedIterations._load_draws
        load = self._load

        def once(programs, bi, ci, mt=None):
            if not getattr(programs, "_draws_loaded", False):
                programs._draws_loaded = True
                load(programs, bi, ci, mt)
            elif mt is not None:        # the noise level still each time
                programs.mt.fill_(float(mt))

        FusedIterations._load_draws = once
        return self

    def __exit__(self, *exc):
        self._cls._load_draws = self._load
        return False


class _BitfieldLog:
    """Inside it, every occupancy grid update's bitfield is kept (a copy
    on the card), in ``bitfields``."""

    def __enter__(self):
        from sparsefusion_tpu_torch.render.occupancy import OccupancyGrid

        self._cls, self._update = OccupancyGrid, OccupancyGrid.update
        self.bitfields = []
        update, kept = self._update, self.bitfields

        def logged(grid, *args, **kw):
            out = update(grid, *args, **kw)
            kept.append(grid.bitfield.clone())
            return out

        OccupancyGrid.update = logged
        return self

    def __exit__(self, *exc):
        self._cls.update = self._update
        return False


def _bits_apart(a, b):
    """Occupancy bits that differ between two runs' grid updates, one
    count an update."""
    return [int(np.unpackbits(torch.bitwise_xor(x, y).cpu().numpy()).sum())
            for x, y in zip(a, b)]


def fused_loop_card_check():
    """The fused loop (CUDA graphs) against the eager loop on the card,
    from one seed, at a small size: ``DistillConfig()`` at 32 px (3
    bootstrap and 7 fusion iterations, 4 PLMS steps, the narrow UNet with
    64-wide heads) and the TPU preset NGP-only (occupancy from iteration
    2, marching, 128-ray input steps), each for one scene
    (``distillation_loop``) and for a batch of two (``distill/batched.py``
    over a scene axis, the preset's with the diffusion arm too; its
    graphs' warm-ups under the sync debug mode's "error",
    ``_StrictWarmups``).  Their losses and final fields (every scene's)
    agree within ``FUSED_TOL``, not bit for bit: K1's backward adds with
    f32 atomics, in another order in every run, and the two-phase
    renderer and Adam's first steps magnify the differences; the eager
    loop against itself gives the spread printed beside.  The two-phase
    batch of two, whose eager spread reaches ``FUSED_TOL``, is held to
    ``TWO_PHASE_BATCH_TOL`` above it, and its control (graphs that never
    see the iterations' draws, ``_DrawsLoadedOnce``) must leave that
    bound.  With the occupancy grid, the bits that each grid update sets
    differently from the eager run are printed.  Then
    the draws: a replayed graph of the renderer's, the ray subset's and
    the sampler's draws gives the numbers the eager calls give from the
    same generator state, bit for bit, at every replay."""
    import contextlib
    import copy

    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.distill import batched, loop
    from sparsefusion_tpu_torch.distill.fused import GraphRunner
    from sparsefusion_tpu_torch.render import volume

    dev = torch.device("cuda")
    models_cpu = _small_models(np.random.RandomState(0))
    scenes = [make_synthetic_scene(n_views=3, image_size=32, seed=s)
              for s in (0, 1)]
    small = dict(max_itr=10, start_fusion_step=2, n_aug_cameras=2,
                 plms_steps=4, max_ray_batch=256)
    reference = loop.DistillConfig(**small)
    preset = loop.tpu_distill_config(
        occupancy_start=2, occupancy_update_every=3, input_rays=128,
        fusion_rays=128, **small)
    # per case: the diffusion arm, the config, the scenes in lockstep and
    # the tolerance.  The preset's single-pass march keeps K1's atomics
    # at ~1e-8, so its batch holds the batched programs, the fusion ones
    # included, to FUSED_TOL.
    cases = {"reference": (True, reference, 1, FUSED_TOL),
             "tpu_preset": (False, preset, 1, FUSED_TOL),
             "reference_batched": (True, reference, 2, TWO_PHASE_BATCH_TOL),
             "tpu_preset_batched": (False, preset, 2, FUSED_TOL),
             "tpu_preset_diffusion_batched": (True, preset, 2, FUSED_TOL)}

    def run_loop(models, use_diffusion, cfg, n_scenes, gen):
        if n_scenes == 1:
            return [loop.distillation_loop(
                models, scenes[0], [0, 1], cfg, gen,
                use_diffusion=use_diffusion, verbose=False)]
        strict = _StrictWarmups() if cfg.fused_steps is None else \
            contextlib.nullcontext()
        with strict:
            return batched.batched_distillation_loop(
                models, scenes[:n_scenes], [[0, 1], [1, 2]], cfg, gen,
                use_diffusion=use_diffusion, verbose=False)

    def diff(a_runs, b_runs):
        loss, par = 0.0, 0.0
        for a, b in zip(a_runs, b_runs):
            la, lb = np.asarray(a["losses"] + a["fusion_losses"]), \
                np.asarray(b["losses"] + b["fusion_losses"])
            loss = max(loss, float(np.max(np.abs(la - lb) / np.abs(lb))))
            par = max([par] + [
                float(np.linalg.norm(np.asarray(x) - np.asarray(y))
                      / np.linalg.norm(np.asarray(y)))
                for x, y in zip(_leaves(a["ngp_params"]),
                                _leaves(b["ngp_params"]))])
        return {"loss_rel": loss, "param_rel": par}

    out = {}
    for name, (use_diffusion, cfg, n_scenes, tol) in cases.items():
        runs, bits = {}, {}
        kinds = [("fused", None), ("eager", False), ("eager_again", False)]
        if tol is TWO_PHASE_BATCH_TOL:
            kinds.append(("control", None))
        for run, fused in kinds:
            models = copy.deepcopy(models_cpu)
            for m in (models.eft, models.vae, models.unet):
                m.to(dev)
            control = _DrawsLoadedOnce() if run == "control" else \
                contextlib.nullcontext()
            with control, _BitfieldLog() as log:
                rs = run_loop(models, use_diffusion,
                              dataclasses.replace(cfg, fused_steps=fused),
                              n_scenes,
                              torch.Generator(device=dev).manual_seed(3))
            assert len(rs) == n_scenes
            for r in rs:
                assert (r["fused"] is not None) == (fused is None), \
                    r["fused"]
            runs[run], bits[run] = rs, log.bitfields

        f = runs["fused"]
        out[name] = {"scenes": n_scenes,
                     "fused_vs_eager": diff(f, runs["eager"]),
                     "eager_vs_eager": diff(runs["eager_again"],
                                            runs["eager"]),
                     "graphs": _graph_stats(f[0]),
                     "unet_evals": [rs[0]["unet_evals"]
                                    for rs in runs.values()],
                     "tolerance": tol}
        if "control" in runs:
            out[name]["control_vs_eager"] = diff(runs["control"],
                                                 runs["eager"])
        if bits["eager"]:
            out[name]["bits_apart_by_update"] = {
                run: _bits_apart(bits[run], bits["eager"])
                for run in ("fused", "eager_again")}
        print(f"fused loop vs eager loop on the card ({name}): "
              + json.dumps(out[name]))
        assert all(np.isfinite(r["losses"]).all() for rs in runs.values()
                   for r in rs)
        assert len(set(out[name]["unet_evals"])) == 1, out[name]
        for key, bound in tol.items():
            assert out[name]["fused_vs_eager"][key] <= bound, (
                name, key, _divergence(f, runs["eager"]))
        if "control" in runs:
            assert any(out[name]["control_vs_eager"][key] > bound
                       for key, bound in tol.items()), out[name]

    # a replayed graph draws what the eager calls draw
    shapes = [(4096, 64), (4096, 64)]
    gens = [torch.Generator(device=dev).manual_seed(11) for _ in range(2)]
    bufs = [torch.zeros(sh, device=dev) for sh in shapes] + [
        torch.zeros(128, dtype=torch.int64, device=dev),
        torch.zeros((1, 4, 32, 32), device=dev)]

    def draw(g):
        vals = [volume._draw(sh, None, g, dev) for sh in shapes]
        vals.append(torch.randint(0, 16384, (128,), generator=g, device=dev))
        vals.append(torch.randn((1, 4, 32, 32), generator=g, device=dev))
        return vals

    def program():
        for buf, v in zip(bufs, draw(gens[0])):
            buf.copy_(v)

    runner = GraphRunner(dev, gens[0], [])
    for i in range(4):              # eager, capture + replay, replays
        runner.run(("draws",), program, i)
        want = draw(gens[1])
        assert all(torch.equal(b, w) for b, w in zip(bufs, want)), i
    assert runner.warmups == 1 and len(runner.captures) == 1 \
        and runner.replays == 3, (runner.warmups, runner.replays)
    print("replayed draws equal the eager draws at 3 replays (bit for bit)")
    return out


def _divergence(a_runs, b_runs):
    """Where two runs of a loop part, for a failed comparison's message:
    each scene's loss differences by iteration (input steps, then the
    second steps) and its parameters' differences by leaf (relative)."""
    out = []
    for a, b in zip(a_runs, b_runs):
        la, lb = np.asarray(a["losses"] + a["fusion_losses"]), \
            np.asarray(b["losses"] + b["fusion_losses"])
        out.append({
            "loss_rel": (np.abs(la - lb) / np.abs(lb)).tolist(),
            "param_rel": [float(np.linalg.norm(np.asarray(x) - np.asarray(y))
                                / np.linalg.norm(np.asarray(y)))
                          for x, y in zip(_leaves(a["ngp_params"]),
                                          _leaves(b["ngp_params"]))]})
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


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


# the loss reads of the loop (``loss_fetch_every`` 20): iterations
# 19, 39, ...; "-1" is the loop's start
FETCH = 20


def _loss_reads(r):
    """{iteration: host seconds at the end of its loss read} of a loop's
    result, from its spans (``main`` records every unit), with -1 the
    start of its first iteration."""
    sp = r["spans"]
    at = {s["unit"]: s["t1"] * 1e-9 for s in sp if s["name"] == "loss_read"}
    at[-1] = min(s["t0"] for s in sp if s["kind"] == "unit") * 1e-9
    return at


def _span_s(r, match, units=lambda i: True):
    """Host seconds of the result's spans whose name ``match`` accepts,
    in the units ``units`` accepts, summed."""
    return sum((s["t1"] - s["t0"]) * 1e-9 for s in r["spans"]
               if match(s["name"]) and units(s["unit"]))


def _is_capture(name):
    return name.startswith("capture/")


def _rates(r, bounds, overhead=None):
    """it/s of a loop's result between its loss reads: for each name,
    iterations a + 1 .. b of ``bounds``' (a, b), the host seconds from the
    read at a (a = -1: the loop's start) to the read at b, less the
    measurement's own seconds in them (``overhead``: {iteration:
    seconds}), and the same without the CUDA-graph captures made in that
    span (``capture/<key>`` spans)."""
    at = _loss_reads(r)
    out = {}
    for name, (a, b) in bounds.items():
        sec = at[b] - at[a] - sum(s for i, s in (overhead or {}).items()
                                  if a < i <= b)
        cap = _span_s(r, _is_capture, lambda i: i is not None and a < i <= b)
        out[name] = {"iterations": b - a, "s": sec, "it_per_s": (b - a) / sec,
                     "capture_s": cap,
                     "it_per_s_without_captures": (b - a) / (sec - cap)}
    return out


def _grid_update_s(r):
    """Host seconds of each occupancy grid update (its span)."""
    return [(s["t1"] - s["t0"]) * 1e-9 for s in r["spans"]
            if s["name"] == "occupancy_update"]


def _train_reads(r):
    """(steps done, host seconds) at the end of each of the train CLI's
    loss reads, from its spans: the ``train/step`` units finished
    before the read."""
    sp = r["spans"]
    ends = sorted(s["t1"] for s in sp if s["kind"] == "unit")
    reads = sorted((s for s in sp if s["name"] == "loss_read"),
                   key=lambda s: s["t0"])
    return [(sum(e <= s["t0"] for e in ends), s["t1"] * 1e-9)
            for s in reads]


def _graph_stats(r):
    """The fused programs' graphs of a loop's result: captures, their
    seconds, replays, eager warm-ups (None for the eager loop)."""
    f = r["fused"]
    if f is None:
        return None
    assert f["graphs"], f
    return {"captures": len(f["captures"]),
            "capture_s": _span_s(r, _is_capture),
            "replays": f["replays"], "warmups": f["warmups"],
            "keys": sorted({c["key"] for c in f["captures"]})}


class _LoopProbe:
    """Phase B of the demo runs inside it, measured through the iteration
    hook of ``distillation_loop`` and ``batched_distillation_loop`` (the
    CLI's calls included):
    the host's synchronising CUDA calls (``torch.cuda``'s sync debug mode,
    each warning counted) and the K1 launches up to each iteration's end;
    and for each of ``windows``' (a, b), a ``torch.profiler`` window over
    iterations a + 1 .. b, from a synchronise at the end of a to one at
    the end of b: the device's busy ms (its kernels' and copies' time)
    and the idle share 1 - busy / host ms.  The hook's own synchronises
    run with the debug mode off."""

    def __init__(self, windows):
        self.windows = windows
        self.syncs_at, self.k1_at, self.k2_at, self.window = {}, {}, {}, {}
        self.hook_s = {}     # the profiler's own seconds at each iteration
        self._n, self._prof = 0, None

    def __enter__(self):
        import warnings

        from sparsefusion_tpu_torch.distill import batched, loop

        self._patched = [(loop, "distillation_loop", loop.distillation_loop),
                         (batched, "batched_distillation_loop",
                          batched.batched_distillation_loop)]

        def hooked(fn):
            def run(*args, **kw):
                kw.setdefault("iteration_hook", self.hook)
                return fn(*args, **kw)
            return run

        for owner, name, fn in self._patched:
            setattr(owner, name, hooked(fn))
        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        for owner, name, fn in self._patched:
            setattr(owner, name, fn)
        if self._prof is not None:
            self._prof.stop()
        return False

    def hook(self, itr):
        from torch.profiler import ProfilerActivity, profile

        from sparsefusion_tpu_torch.kernels import attention, grid_encode

        torch.cuda.set_sync_debug_mode(0)
        self._n += sum("synchroniz" in str(w.message) for w in self._log)
        del self._log[:]
        self.syncs_at[itr] = self._n
        self.k1_at[itr] = (grid_encode.grid_encode_cuda.launches,
                           grid_encode.grid_encode_cuda_backward.launches)
        self.k2_at[itr] = attention.imagen_attention_cuda.launches
        # the profiler's start and its reading are the measurement's own
        # time, not the loop's (the synchronises only wait for the loop)
        overhead = 0.0
        for name, (a, b) in self.windows.items():
            if itr == a:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                self._prof = profile(activities=[ProfilerActivity.CUDA])
                self._prof.start()
                time.sleep(0.005)
                overhead += time.perf_counter() - t0
                torch.cuda.synchronize()
                self._t = time.perf_counter()
            elif itr == b:
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - self._t) * 1e3
                t0 = time.perf_counter()
                self._prof.stop()
                busy, kernels = 0.0, 0
                for e in self._prof.key_averages():
                    us = getattr(e, "self_device_time_total", 0) or 0
                    if us > 0:
                        busy += us / 1e3
                        kernels += e.count
                self._prof = None
                overhead += time.perf_counter() - t0
                n = b - a
                # K2 launches three times a UNet evaluation
                evals = (self.k2_at[b] - self.k2_at[a]) / 3
                self.window[name] = {
                    "iterations": n, "host_ms_per_itr": host_ms / n,
                    "device_ms_per_itr": busy / n,
                    "kernels_per_itr": kernels / n,
                    "idle_share": (1 - busy / host_ms) if busy > 0
                    else None,
                    "unet_evals": evals,
                    "device_ms_per_unet_eval": busy / evals if evals
                    else None}
        self.hook_s[itr] = overhead
        torch.cuda.set_sync_debug_mode("warn")

    def syncs_per_itr(self, a, b):
        """Synchronising calls an iteration over iterations a + 1 .. b."""
        return (self.syncs_at[b] - self.syncs_at[a]) / (b - a)

    def k1_deltas(self):
        """{iteration: (K1 forward, backward) launches in it}."""
        itrs = sorted(self.k1_at)
        return {i: tuple(x - y for x, y in zip(self.k1_at[i],
                                               self.k1_at[p]))
                for p, i in zip(itrs, itrs[1:])}


def _probe_stats(r, probe, bounds, peak):
    """The fused-or-eager loop's measurements of one run: it/s between
    loss reads, syncs an iteration and the profiled windows, graphs,
    peak memory (allocated, reserved; GiB)."""
    return {"fused": r["fused"] is not None,
            "rates": _rates(r, bounds, probe.hook_s),
            "syncs_per_itr": {name: probe.syncs_per_itr(a, b)
                              for name, (a, b) in probe.windows.items()},
            "windows": probe.window, "graphs": _graph_stats(r),
            "peak_gib": peak,
            # the profiler's own seconds, left out of the rates
            "probe_s": sum(probe.hook_s.values())}


def _peak():
    return [torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.cuda.max_memory_reserved() / 2 ** 30]


def _compare_pair(label, fused, eager):
    """One line per demo pair, and K1's launches an iteration equal in the
    iterations both ran."""
    fd, ed = fused.pop("k1_deltas"), eager.pop("k1_deltas")
    common = sorted(set(fd) & set(ed))
    assert common and all(fd[i] == ed[i] for i in common), [
        (i, fd[i], ed[i]) for i in common if fd[i] != ed[i]]
    print(f"fused vs eager, {label}: " + json.dumps(
        {"fused": fused, "eager": eager,
         "k1_launches_equal_over_itrs": [common[0], common[-1]]}))


DEMO_ARGV = ["-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
             "--image_size", "256", "--max_itr", "40", "--start_fusion",
             "19", "--device", "cuda"]


# the TPU preset's diffusion run: occupancy from iteration 10, marching
# and the subsampled fusion step both live within 40 iterations
TPU_DIFFUSION_KW = dict(occupancy_start=10, occupancy_update_every=8)


_TRIOS = {}


def _shared_trio(args, device):
    """``cli/demo.py::build_trio``, built once for all the smoke's
    diffusion demos: without checkpoints every demo's weights are seed
    0's, so they share one bundle (each run reads its UNet evaluations as
    a difference)."""
    from sparsefusion_tpu_torch.cli import demo

    key = (args.eft_ckpt, args.vae_ckpt, args.vldm_ckpt, args.resnet18,
           str(device))
    if key not in _TRIOS:
        t0 = time.perf_counter()
        _TRIOS[key] = _BUILD_TRIO(args, device)
        print(f"the EFT / VAE / UNet trio built in "
              f"{time.perf_counter() - t0:.1f} s (kept for every demo)")
    return _TRIOS[key]


def _loop_demo(argv, variant, fused=True):
    """The demo's scene loop through ``distillation_loop`` with the CLI's
    models, scene, views and generator, and ``DistillConfig(sampler_bf16=
    True)`` (``variant`` "bf16_sampler"; the JAX demo CLI has no flag for
    it) or ``tpu_distill_config(**TPU_DIFFUSION_KW)`` ("tpu"); without
    ``fused``, ``fused_steps=False``."""
    from sparsefusion_tpu_torch.cli.demo import (
        load_dataset,
        parse_args,
        select_input_views,
    )
    from sparsefusion_tpu_torch.distill import loop

    args = parse_args(argv)
    exp_dir = args.exp_dir
    for sub in ("log", "metrics", "render_imgs", "render_gifs"):
        os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)
    device = torch.device("cuda")
    models = _shared_trio(args, device)
    scene = load_dataset(args, device)[0]
    input_idx = select_input_views(args.val_seed, 0, len(scene),
                                   args.context_views)
    scene.sequence_name = f"any_000_c{len(input_idx)}"
    kw = dict(max_itr=args.max_itr, start_fusion_step=args.start_fusion,
              fused_steps=None if fused else False)
    if variant == "tpu":
        cfg = loop.tpu_distill_config(**kw, **TPU_DIFFUSION_KW)
    else:
        cfg = loop.DistillConfig(sampler_bf16=True, **kw)
    generator = torch.Generator(device=device).manual_seed(args.val_seed)
    return [loop.distillation_loop(models, scene, input_idx, cfg, generator,
                                   save_dir=exp_dir)]


def _diffusion_windows(max_itr):
    """Profiled windows of a diffusion demo (fusion from iteration 20):
    bootstrap iterations 10-17, and two fusion iterations before the
    last (the profiler's reading of ~50,000 kernels an iteration takes
    seconds: with three, the windows' readings took 170 s of a 996 s
    smoke on an H100)."""
    return {"bootstrap": (9, 17),
            "fusion": (max(20, max_itr - 4), max_itr - 2)}


def diffusion_main_path(variant="f32", max_itr=40, lpips_spec=None,
                        fused=True):
    """The full-width diffusion demo, ``max_itr`` iterations, fusion from
    iteration 20: through ``cli/demo.py::main`` (``variant`` "f32", and
    "lpips" with ``--lpips_weights lpips_spec``: the perceptual term and
    the eval's column), or through ``distillation_loop`` with the bf16
    sampler ("bf16_sampler") or the TPU preset ("tpu": occupancy from
    iteration 10, single-pass marching, 4096-ray input and fusion
    gradient steps).  ``fused``: the card's default, the iterations as
    CUDA graphs; else the eager loop (``--no_fused``)."""
    from sparsefusion_tpu_torch.cli.demo import main as demo_main

    sampler_bf16 = variant == "bf16_sampler"
    windows = _diffusion_windows(max_itr)
    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir, \
            _PhaseB() as phase_b, _LoopProbe(windows) as probe:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        argv = DEMO_ARGV + ["--max_itr", str(max_itr), "--exp_dir", exp_dir]
        if variant == "f32":
            results = demo_main(argv + ([] if fused else ["--no_fused"]))
        elif variant == "lpips":
            results = demo_main(argv + ["--lpips_weights", lpips_spec])
        else:
            results = _loop_demo(argv, variant, fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak = _peak()
        written = {p: os.path.exists(os.path.join(exp_dir, p)) for p in (
            "metrics/any_000_c2.txt", "any_000_c2_ngp.npz",
            "render_gifs/any_000_c2.gif")}

    r = results[0]
    n_fusion = max_itr - 20                 # iterations 20..max_itr - 1
    last = max_itr - 1
    loop_stats = _probe_stats(r, probe, {"bootstrap": (-1, FETCH - 1),
                                         "fusion": (FETCH - 1, last)}, peak)
    rates = loop_stats["rates"]
    fusion_s = rates["fusion"]["s"]
    stats = {"phase_a_s": _span_s(r, lambda n: n == "phase_a"),
             "it_per_s": max_itr / (rates["bootstrap"]["s"] + fusion_s),
             "bootstrap_it_per_s": rates["bootstrap"]["it_per_s"],
             "fusion_it_per_s": rates["fusion"]["it_per_s"],
             "unet_evals": r["unet_evals"],
             "unet_evals_per_s": r["unet_evals"] / fusion_s,
             "peak_gib": peak[0], "wall_s": wall,
             "psnr": r["metrics"]["psnr"], "ssim": r["metrics"]["ssim"],
             "phase_b_launches": phase_b.k1(), "loop": loop_stats}
    if variant == "lpips":
        stats["lpips"] = r["metrics"]["lpips"]
    occ, modes = r["occupancy"], r["render_modes"]
    if variant == "tpu":
        stats.update({"render_modes": modes,
                      "fusion_subset_steps": r["fusion_subset_steps"],
                      "grid_update_itrs": occ["update_itrs"],
                      "grid_update_s": _grid_update_s(r),
                      "occupied_share": occ["occupied_share"]})
    label = "diffusion main path" + {"f32": "", "bf16_sampler":
                                     " (bf16 sampler)",
                                     "tpu": " (TPU preset)",
                                     "lpips": " (LPIPS)"}[variant] \
        + ("" if fused else " (eager)")
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
    # three attention layers a forward, all at a kernel head dim (64);
    # with graphs, both counts add each replay's captured launches
    assert launches["imagen_attention"] == 3 * r["unet_evals"], launches
    assert launches["imagen_attention_bf16"] == (
        launches["imagen_attention"] if sampler_bf16 else 0), launches
    # the card runs fused by default; --no_fused is the eager loop
    assert (r["fused"] is not None) == fused, r["fused"]
    if fused:
        graphs = loop_stats["graphs"]
        assert graphs["captures"] > 0 and graphs["replays"] > 0, graphs
    if variant == "tpu":
        # marching from the first grid update on (the preset sets no
        # polish tail), and the fusion gradient steps on ray subsets
        # (iterations 20..max_itr - 1)
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
    if variant == "lpips":
        assert math.isfinite(r["metrics"]["lpips"]), r["metrics"]
    loop_stats["k1_deltas"] = probe.k1_deltas()
    return launches, stats


def tpu_ngp_main_path(fused=True, max_itr=600):
    """The TPU preset's NGP-only demo at full width through the CLI
    (``--preset tpu --no_diffusion``, 256 px, ``max_itr`` iterations:
    occupancy from iteration 500, so with 600 7 grid updates and 100
    marching iterations; ``fused`` as in :func:`diffusion_main_path`).
    K1's 8 x C4 bf16 instance must carry every forward launch."""
    from sparsefusion_tpu_torch.cli.demo import main as demo_main

    windows = {"two_phase": (299, 319), "march": (581, 595)}
    windows = {k: v for k, v in windows.items() if v[1] < max_itr}
    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir, \
            _PhaseB() as phase_b, _LoopProbe(windows) as probe:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        results = demo_main([
            "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
            "--image_size", "256", "--max_itr", str(max_itr),
            "--no_diffusion", "--preset", "tpu", "--device", "cuda",
            "--exp_dir", exp_dir] + ([] if fused else ["--no_fused"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak = _peak()
        files_ok = os.path.exists(os.path.join(exp_dir, "metrics",
                                               "any_000_c2.txt"))

    r = results[0]
    losses = np.asarray(r["losses"])
    occ = r["occupancy"]
    start = 500
    last = max_itr - 1
    loop_stats = _probe_stats(r, probe, {"two_phase": (FETCH - 1, start - 1),
                                         "march": (start - 1, last)}, peak)
    rates = loop_stats["rates"]
    # grid updates inside the marching span (iterations start+1 ..)
    upd_after = _span_s(r, lambda n: n == "occupancy_update",
                        lambda i: i > start)
    stats = {
        "it_per_s": (last - FETCH + 1) / (rates["two_phase"]["s"]
                                          + rates["march"]["s"]),
        "it_per_s_two_phase": rates["two_phase"]["it_per_s"],
        "it_per_s_march": rates["march"]["it_per_s"],
        "it_per_s_march_without_grid_updates":
            rates["march"]["iterations"] / (rates["march"]["s"] - upd_after),
        "grid_update_itrs": occ["update_itrs"],
        "grid_update_s": _grid_update_s(r),
        "occupied_share": occ["occupied_share"],
        "render_modes": r["render_modes"], "peak_gib": peak[0],
        "wall_s": wall, "psnr": r["metrics"]["psnr"],
        "ssim": r["metrics"]["ssim"],
        "loss_first10": float(losses[:10].mean()),
        "loss_last10": float(losses[-10:].mean()),
        "phase_b_launches": phase_b.k1(), "loop": loop_stats}
    label = "TPU preset NGP-only main path" + ("" if fused else " (eager)")
    print(f"{label}: " + json.dumps(stats))
    print(f"{label}: launches {json.dumps(launches)}")
    assert len(losses) == max_itr and np.isfinite(losses).all()
    assert stats["psnr"] >= 15.0, f"eval psnr {stats['psnr']} < 15"
    assert len(occ["update_itrs"]) >= 1 and occ["update_itrs"][0] == start
    assert 0.0 < occ["occupied_share"][0] < 1.0, occ["occupied_share"]
    # marching from the first grid update (iteration 500) on
    assert r["render_modes"] == {"two_phase": start,
                                 "march": max_itr - start}, r["render_modes"]
    assert launches["grid_encode_fwd_bf16"] > 0
    assert launches["grid_encode_fwd_bf16"] == launches["grid_encode_fwd"]
    assert launches["grid_encode_bwd"] > 0
    assert files_ok and np.isfinite(r["renders"]).all()
    assert (r["fused"] is not None) == fused, r["fused"]
    loop_stats["k1_deltas"] = probe.k1_deltas()
    return launches, stats, r["ngp_params"]


def main_path(fused=True):
    """The NGP-only demo at full width through the CLI, 100 iterations
    (``fused`` as in :func:`diffusion_main_path`)."""
    from sparsefusion_tpu_torch.cli.demo import main as demo_main
    from sparsefusion_tpu_torch.kernels.grid_encode import (
        grid_encode_cuda,
        grid_encode_cuda_backward,
        reset_launches,
    )

    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir, \
            _PhaseB() as phase_b, _LoopProbe({"steady": (59, 79)}) as probe:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        results = demo_main([
            "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
            "--image_size", "256", "--max_itr", "100", "--no_diffusion",
            "--device", "cuda", "--exp_dir", exp_dir]
            + ([] if fused else ["--no_fused"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"grid_encode_fwd": grid_encode_cuda.launches,
                    "grid_encode_bwd": grid_encode_cuda_backward.launches}
        peak = _peak()
        metrics_file = os.path.join(exp_dir, "metrics", "any_000_c2.txt")
        npz_file = os.path.join(exp_dir, "any_000_c2_ngp.npz")
        files_ok = os.path.exists(metrics_file) and os.path.exists(npz_file)
        npz = dict(np.load(npz_file)) if files_ok else {}

    r = results[0]
    losses = np.asarray(r["losses"])
    loop_stats = _probe_stats(r, probe, {"steady": (FETCH - 1, 99)}, peak)
    its = loop_stats["rates"]["steady"]["it_per_s"]
    psnr = r["metrics"]["psnr"]
    label = "main path" + ("" if fused else " (eager)")
    print(f"{label}: {len(losses)} iterations, {its:.3f} it/s "
          f"(iterations 20-100), wall {wall:.2f} s incl. scene synthesis "
          f"and eval; peak memory {peak[0]:.3f} GiB; launches "
          f"{json.dumps(launches)}")
    print(f"{label}: loss first10 {losses[:10].mean():.5f} last10 "
          f"{losses[-10:].mean():.5f}; eval psnr {psnr:.3f} "
          f"ssim {r['metrics']['ssim']:.4f}; loop {json.dumps(loop_stats)}")
    assert all(v > 0 for v in launches.values()), launches
    assert len(losses) == 100 and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean(), "loss did not fall"
    assert psnr >= 15.0, f"eval psnr {psnr} < 15"
    assert files_ok, "metrics file or params npz missing"
    assert npz["grid"].shape == (929336, 2) and all(
        np.isfinite(v).all() for v in npz.values())
    assert r["renders"].shape == (10, 256, 256, 3)
    assert np.isfinite(r["renders"]).all()
    assert (r["fused"] is not None) == fused, r["fused"]
    loop_stats["k1_deltas"] = probe.k1_deltas()
    return launches, {"it_per_s": its, "peak_gib": peak[0],
                      "wall_s": wall, "psnr": psnr,
                      "phase_b_launches": phase_b.k1(),
                      "loop": loop_stats}, r["ngp_params"]


class _PhaseB:
    """Instrumentation of one demo run: the kernels' launch counts when the
    first scene's eval (Phase C) starts, which are Phase B's and Phase A's
    (Phase A launches no K1), and the batch of every UNet evaluation."""

    def __enter__(self):
        from sparsefusion_tpu_torch.distill import batched, loop
        from sparsefusion_tpu_torch.models import SparseFusionModels

        self.counts, self.unet_batches = None, []
        self._patched = [(loop, "evaluate_scene", loop.evaluate_scene),
                         (batched, "evaluate_scene", batched.evaluate_scene),
                         (SparseFusionModels, "denoise_fn",
                          SparseFusionModels.denoise_fn)]
        evaluate, denoise = loop.evaluate_scene, SparseFusionModels.denoise_fn

        def evaluate_scene(*args, **kw):
            if self.counts is None:
                self.counts = _read_counts()
            return evaluate(*args, **kw)

        def denoise_fn(models, x, *args, **kw):
            self.unet_batches.append(x.shape[0])
            return denoise(models, x, *args, **kw)

        loop.evaluate_scene = batched.evaluate_scene = evaluate_scene
        SparseFusionModels.denoise_fn = denoise_fn
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._patched:
            setattr(owner, name, fn)
        return False

    def k1(self):
        return {k: v for k, v in self.counts.items()
                if k.startswith("grid_encode")}


def _lpips_state_dicts(seed=0):
    """Seeded stand-ins for a torchvision ``vgg16`` state dict (He-normal
    convolutions, small biases) and an lpips ``lin`` one (non-negative
    heads): no LPIPS weights ship with the repository, so only agreement
    and cost are measured, not what the distances mean."""
    from sparsefusion_tpu_torch.nn.lpips import LPIPS

    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in LPIPS().state_dict().items()}
    vgg, lin = {}, {}
    for name, shape in shapes.items():
        if not name.startswith("vgg."):
            lin[name] = torch.randn(shape, generator=g).abs() * 0.1
        elif name.endswith("weight"):
            fan_in = math.prod(shape[1:])
            vgg[name[len("vgg."):]] = torch.randn(
                shape, generator=g) * math.sqrt(2.0 / fan_in)
        else:
            vgg[name[len("vgg."):]] = torch.randn(shape, generator=g) * 0.01
    return vgg, lin


def _vgg_ops(h, w):
    """Operations of one VGG16 feature pass (LPIPS's five stages) on an
    h x w image: 2 per multiply-add of every 3x3 convolution."""
    from sparsefusion_tpu_torch.nn.lpips import VGG16Features

    with torch.device("meta"):
        layers = VGG16Features().features
    ops = 0
    for layer in layers:
        if isinstance(layer, torch.nn.Conv2d):
            ops += 2 * h * w * layer.in_channels * layer.out_channels * 9
        elif isinstance(layer, torch.nn.MaxPool2d):
            h, w = h // 2, w // 2
    return ops


def lpips_card_check(vgg, lin):
    """LPIPS on the card against the CPU at 64 px (batch 2, TF32 off):
    the distances and their gradient in ``img0`` to 1e-4 relative (the
    gradient against its largest entry): cuDNN's f32 convolutions sum in
    another order than the CPU's."""
    from sparsefusion_tpu_torch.nn.lpips import LPIPS

    rng = np.random.RandomState(4)
    a = torch.tensor(rng.rand(2, 64, 64, 3), dtype=torch.float32)
    b = torch.tensor(rng.rand(2, 64, 64, 3), dtype=torch.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        model = LPIPS().load_torch_weights(vgg, lin).to(dev)
        x = a.to(dev).requires_grad_()
        d = model.requires_grad_(False)(x, b.to(dev), normalize=True)
        (g,) = torch.autograd.grad(d.sum(), x)
        out[dev] = (d.detach().cpu(), g.cpu())
    (d_c, g_c), (d_g, g_g) = out["cpu"], out["cuda"]
    stats = {"value_rel": ((d_c - d_g).abs() / d_c.abs()).max().item(),
             "grad_rel": ((g_c - g_g).abs().max()
                          / g_c.abs().max()).item(),
             "values": d_c.tolist()}
    print("LPIPS cpu vs cuda (64 px): " + json.dumps(stats))
    assert stats["value_rel"] <= 1e-4 and stats["grad_rel"] <= 1e-4, stats
    return stats


def lpips_fusion_term_profile(spec, size=256):
    """The perceptual term of one fusion step at full width: LPIPS of the
    (1, 256, 256, 3) render against its target, and the render's
    gradient (the weights are frozen), in a ``record_function`` range,
    PROFILE_ITERS times: device ms beside its operations bound (three
    VGG16 passes: two forward, one backward to the input) at the f32
    rate."""
    from sparsefusion_tpu_torch.nn.lpips import build_lpips_fn

    lpips_fn = build_lpips_fn(spec, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand(1, size, size, 3, device="cuda", generator=gen)
    pred = torch.rand(1, size, size, 3, device="cuda", generator=gen)
    img.requires_grad_()

    def run(n=PROFILE_ITERS):
        for _ in range(n):
            with torch.profiler.record_function("lpips_fusion_term"):
                torch.autograd.grad(lpips_fn(img, pred).sum(), img)

    run(2)
    per_call, _, host_ms = profile_window(run, PROFILE_ITERS)
    ops = 3 * _vgg_ops(size, size)
    bound, bound_by = _bound(_nbytes(img, pred), ops)
    stats = {"device_ms": sum(per_call.values()), "host_ms": host_ms,
             "gflop": ops / 1e9, "bound_ms": bound, "bound_by": bound_by}
    stats["bound_share"] = bound / stats["device_ms"]
    print("LPIPS fusion term (forward + input backward, 256 px): "
          + json.dumps(stats))
    for name, ms in sorted(per_call.items(), key=lambda kv: -kv[1])[:4]:
        print(f"  {ms:8.3f} ms {name[:110]}")
    return stats


def small_batched_steps_check():
    """One scene-batched input, bootstrap and fusion step (S = 2 scenes on
    an ``NGPFieldStack`` at full width; narrow UNet and VAE, 2-step PLMS
    at batch 2) on the card and on the CPU from the same weights and
    draws, at the single-scene checks' tolerances: losses 1e-5 (input) /
    1e-4 relative, gradients 5e-2 relative (Frobenius) per parameter and
    scene."""
    import copy

    from sparsefusion_tpu_torch.core.cameras import (
        concat_cameras,
        get_camera_slice,
        get_relative_cameras,
    )
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.distill.loop import (
        DistillConfig,
        make_ngp_optimizer,
        make_scene_step_fns,
    )
    from sparsefusion_tpu_torch.nn.ngp import NGPField, NGPFieldStack
    from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig

    cfg = DistillConfig(max_ray_batch=256, plms_steps=2)
    vcfg = VolumeRendererConfig(max_ray_batch=256)
    scenes = [make_synthetic_scene(n_views=2, image_size=32, seed=s)
              for s in (0, 1)]
    rng = np.random.RandomState(6)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32)

    draws = {"jitter": f32(rng.rand(2, 256, 64)),
             "u": f32(rng.rand(2, 256, 64)),
             "plms_noise": [f32(rng.randn(2, 4, 4, 4)) for _ in range(4)]}
    features = f32(rng.randn(2, 256, 4, 4))
    eft = f32(rng.rand(2, 32, 32, 3))
    rgb = f32(np.stack([sc.images[0] for sc in scenes]))
    mask = f32(np.stack([sc.masks[0] for sc in scenes]))
    models_cpu = _small_models(rng)
    g = torch.Generator().manual_seed(0)
    inits = [NGPField(cfg.ngp, generator=g).state_dict() for _ in range(2)]
    out = {}
    for dev in ("cpu", "cuda"):
        models = copy.deepcopy(models_cpu)
        for m in (models.eft, models.vae, models.unet):
            m.to(dev)
        fields = []
        for init in inits:
            fields.append(NGPField(cfg.ngp, device=dev))
            fields[-1].load_state_dict(init)
        stack = NGPFieldStack(fields)
        steps = make_scene_step_fns(stack, cfg,
                                    make_ngp_optimizer(cfg, stack), 16, 32,
                                    models=models)
        cams = concat_cameras([get_camera_slice(get_relative_cameras(
            sc.cameras(dev), [0], center_at_origin=False), [v])
            for sc, v in zip(scenes, (0, 1))])
        d = {k: ([t.to(dev) for t in v] if isinstance(v, list)
                 else v.to(dev)) for k, v in draws.items()}
        res = {}
        for name, fn, args in (
                ("input", steps.input_losses, (rgb.to(dev), mask.to(dev))),
                ("bootstrap", steps.bootstrap_losses, (eft.to(dev),)),
                ("fusion", steps.fusion_losses, (features.to(dev), 0.6))):
            stack.zero_grad()
            loss = fn(vcfg, cams, *args, draws=d)
            loss.sum().backward()
            res[name] = (loss.detach().cpu(), {
                n: p.grad.cpu().clone() for n, p in stack.named_parameters()})
        out[dev] = res
    stats = {}
    for name, tol in (("input", 1e-5), ("bootstrap", 1e-4),
                      ("fusion", 1e-4)):
        (l_c, g_c), (l_g, g_g) = out["cpu"][name], out["cuda"][name]
        stats[f"{name}_loss_rel"] = ((l_c - l_g).abs() / l_c.abs()).max() \
            .item()
        stats[f"{name}_grad_rel_max"] = max(
            ((g_c[n][s] - g_g[n][s]).norm() / g_c[n][s].norm()).item()
            for n in g_c for s in range(2))
        print(f"batched {name} step (S = 2) cpu vs cuda: losses "
              f"{l_c.tolist()} vs {l_g.tolist()}; worst gradient "
              f"{stats[f'{name}_grad_rel_max']:.3e}")
        assert stats[f"{name}_loss_rel"] <= tol, name
        assert stats[f"{name}_grad_rel_max"] <= 5e-2, name
        assert all(torch.isfinite(v).all() for v in g_g.values())
    return stats


BATCH_ARGV = ["-d", "synthetic", "-c", "any",
              "-i", ",".join(str(i) for i in range(SCENES)), "-v", "2",
              "--image_size", "256", "--scene_batch", str(SCENES),
              "--device", "cuda"]
# per kind: the arguments, and the single-scene run it is held against
BATCH_RUNS = {
    "ngp": ["--no_diffusion"],
    "diffusion": ["--start_fusion", "19"],
    "tpu": ["--no_diffusion", "--preset", "tpu"],
}
# per kind: the graph run's iterations and its eager twin's
BATCH_ITRS = {"ngp": (100, 100), "diffusion": (40, 25), "tpu": (600, 600)}


def _batch_bounds(kind, max_itr):
    """Loss reads bounding the rates of a batched run of ``max_itr``
    iterations (iterations 20.. of the NGP-only runs, as the single runs';
    the diffusion run's bootstrap and fusion spans, fusion from 20), and
    its profiled windows."""
    last = max_itr - 1
    if kind == "diffusion":
        return ({"all": (-1, last), "bootstrap": (-1, FETCH - 1),
                 "fusion": (FETCH - 1, last)}, _diffusion_windows(max_itr))
    if kind == "tpu":
        return ({"all": (FETCH - 1, last), "two_phase": (FETCH - 1, 499),
                 "march": (499, last)},
                {k: v for k, v in {"two_phase": (299, 319),
                                   "march": (581, 595)}.items()
                 if v[1] < max_itr})
    return {"all": (FETCH - 1, last)}, {"steady": (59, 79)}


def batched_main_path(kind, single, fused=True):
    """SCENES synthetic scenes through the CLI with ``--scene_batch
    SCENES``: one bucket, so one lockstep group (``distill/batched.py``).
    ``kind`` "ngp" (``DistillConfig()``, 100 iterations), "diffusion" (40,
    fusion from 20) or "tpu" (``--preset tpu --no_diffusion``, 600: the
    batched occupancy grids and marching).  ``fused``: the card's
    default, each iteration as replayed CUDA graphs over the scene axis;
    else the eager batched loop (``--no_fused``; the diffusion twin runs
    25 iterations).  ``single`` is the stats of the same configuration's
    single-scene run (graphs) in this smoke: K1 must launch as often in
    the batched Phase B as there, each launch for all SCENES scenes; K2
    three times a UNet evaluation, each at batch SCENES.  The run is
    measured as the single demos are (``_LoopProbe``): scene-it/s between
    loss reads with and without the captures' seconds, a profiler
    window's device and host ms and idle share, syncs an iteration,
    captures and replays, peak memory allocated and reserved."""
    import gc

    from sparsefusion_tpu_torch.cli.demo import main as demo_main

    max_itr = BATCH_ITRS[kind][0 if fused else 1]
    bounds, windows = _batch_bounds(kind, max_itr)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir, \
            _PhaseB() as phase_b, _LoopProbe(windows) as probe:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        results = demo_main(BATCH_ARGV + BATCH_RUNS[kind] + [
            "--max_itr", str(max_itr), "--exp_dir", exp_dir]
            + ([] if fused else ["--no_fused"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak = _peak()
        written = all(os.path.exists(os.path.join(
            exp_dir, "metrics", f"any_{i:03d}_c2.txt")) for i in range(SCENES))

    assert len(results) == SCENES
    r = results[0]
    assert sum(s["kind"] == "unit" for s in r["spans"]) == max_itr
    k1 = phase_b.k1()
    loop_stats = _probe_stats(r, probe, bounds, peak)
    rates = loop_stats["rates"]
    stats = {"scene_it_per_s": SCENES * rates["all"]["it_per_s"],
             "scene_it_per_s_without_captures":
                 SCENES * rates["all"]["it_per_s_without_captures"],
             "it_per_s": rates["all"]["it_per_s"],
             "single_scene_it_per_s": single["it_per_s"],
             "k1_fwd_launches_per_itr": k1["grid_encode_fwd"] / max_itr,
             "k1_bwd_launches_per_itr": k1["grid_encode_bwd"] / max_itr,
             "single_k1_fwd_launches_per_itr":
                 single["phase_b_launches"]["grid_encode_fwd"]
                 / BATCH_ITRS[kind][0],
             "peak_gib": peak, "wall_s": wall,
             "psnr": [x["metrics"]["psnr"] for x in results],
             "ssim": [x["metrics"]["ssim"] for x in results],
             "phase_b_launches": k1, "loop": loop_stats,
             # the windows' synchronising calls less their loss reads
             "syncs_besides_reads": {
                 name: probe.syncs_at[b] - probe.syncs_at[a]
                 - sum(a < i <= b for i in _loss_reads(r) if i >= 0)
                 for name, (a, b) in windows.items()}}
    if kind == "diffusion":
        stats.update({
            "scene_fusion_it_per_s": SCENES * rates["fusion"]["it_per_s"],
            "scene_fusion_it_per_s_without_captures":
                SCENES * rates["fusion"]["it_per_s_without_captures"],
            "single_scene_fusion_it_per_s": single["fusion_it_per_s"],
            "scene_bootstrap_it_per_s":
                SCENES * rates["bootstrap"]["it_per_s"],
            "single_scene_bootstrap_it_per_s": single["bootstrap_it_per_s"],
            "unet_evals": r["unet_evals"],
            "phase_a_s": _span_s(r, lambda n: n == "phase_a"),
            "unet_batches": sorted(set(phase_b.unet_batches))})
    if kind == "tpu":
        stats["render_modes"] = r["render_modes"]
        stats["occupied_share"] = [x["occupancy"]["occupied_share"]
                                   for x in results]
    label = f"scene batch ({kind}, S = {SCENES})" + ("" if fused
                                                     else " (eager)")
    print(f"{label}: " + json.dumps(stats))
    print(f"{label}: launches {json.dumps(launches)}")
    assert written
    for x in results:
        assert len(x["losses"]) == max_itr and np.isfinite(x["losses"]).all()
        assert x["renders"].shape == (10, 256, 256, 3)
        assert np.isfinite(x["renders"]).all()
    # the card runs graphs by default; --no_fused is the eager loop
    assert (r["fused"] is not None) == fused, r["fused"]
    if fused:
        graphs = loop_stats["graphs"]
        assert graphs["captures"] > 0 and graphs["replays"] > 0, graphs
        # no host read between the loss reads
        assert all(n <= 0 for n in stats["syncs_besides_reads"].values()), \
            stats["syncs_besides_reads"]
    # one launch a kernel and operation for all SCENES scenes: as many as
    # the single-scene run's Phase B, each encoding SCENES scenes
    for name in ("grid_encode_fwd", "grid_encode_bwd"):
        if max_itr == BATCH_ITRS[kind][0]:
            assert k1[name] == single["phase_b_launches"][name] > 0, (
                name, k1, single["phase_b_launches"])
        assert k1[f"{name}_scenes"] == SCENES * k1[name] > 0, k1
    if kind == "diffusion":
        assert launches["imagen_attention"] == 3 * r["unet_evals"] > 0
        assert stats["unet_batches"] == [SCENES], stats["unet_batches"]
        assert len(x["fusion_losses"]) == max_itr
    else:
        assert all(p >= 15.0 for p in stats["psnr"]), stats["psnr"]
    if kind == "tpu":
        assert r["render_modes"] == {"two_phase": 500,
                                     "march": max_itr - 500}
        assert launches["grid_encode_fwd_bf16"] == launches["grid_encode_fwd"]
    loop_stats["k1_deltas"] = probe.k1_deltas()
    return launches, k1, stats


def batched_pair(kind, single):
    """A batched demo as graphs and its eager twin, in one line: the two
    runs' measurements and K1's launches equal in each iteration both
    ran.  Returns the graph run's launches, its Phase B K1 counts and both
    runs' stats."""
    launches, k1, stats = batched_main_path(kind, single)
    _, _, eager = batched_main_path(kind, single, fused=False)
    _compare_pair(f"scene batch ({kind}, S = {SCENES})", stats["loop"],
                  eager["loop"])
    return launches, k1, {"graphs": stats, "eager": eager}


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
    ``grid_encode_fwd_bf16`` K1 forward's launches on a bf16 table;
    ``grid_encode_{fwd,bwd}_scenes`` the scenes K1's launches encoded (a
    scene-batched launch counts once in the launches and S times here)."""
    from sparsefusion_tpu_torch.kernels import attention, grid_encode

    torch.cuda.synchronize()
    return {"grid_encode_fwd": grid_encode.grid_encode_cuda.launches,
            "grid_encode_fwd_bf16":
                grid_encode.grid_encode_cuda.launches_bf16,
            "grid_encode_fwd_scenes": grid_encode.grid_encode_cuda.scenes,
            "grid_encode_bwd": grid_encode.grid_encode_cuda_backward.launches,
            "grid_encode_bwd_scenes":
                grid_encode.grid_encode_cuda_backward.scenes,
            "imagen_attention": attention.imagen_attention_cuda.launches,
            "imagen_attention_bf16":
                attention.imagen_attention_cuda.launches_bf16,
            "imagen_attention_bf16_wgmma":
                attention.imagen_attention_cuda.launches_bf16_wgmma}


# the captured step against the eager one on the card: the first step's
# loss (equal parameters and draws), every step's loss from common
# parameters (a run as graphs whose parameters are set to the eager
# run's before each step), every step's loss free-running, and each
# model's parameters after the steps (relative Frobenius).  The
# parameters part in their last bits after the first update (the EFT's
# backward adds with atomics, and Adam moves a gradient that is zero but
# for rounding by lr * sign(g)), so the free-running losses drift.  On
# an H100 the f32 graphs' free-running losses read up to 3.2e-5 from
# eager's and eager against itself up to 2.7e-5 (at the fifth step); the
# check's control, the eager run with its updates lost (learning rate
# 0), parts by 0.13-0.76 from the second step on.  The free-running
# bound sits between: 1e-3 in f32; in bf16 (graphs up to 4.9e-3, eager
# against itself up to 3.5e-3, the control 0.13-0.75) TRAIN_TOL's bf16
# loss tolerance, 1e-2
GRAPH_TOL = {"float32": {"first_loss": 1e-5, "loss": 1e-5,
                         "free_running_loss": 1e-3, "param": 1e-4},
             "bfloat16": {"first_loss": 1e-5, "loss": 1e-2,
                          "free_running_loss": 1e-2, "param": 1e-3}}
GRAPH_CONTEXTS = ([1, 2], [1, 2, 3], [2, 4], [2, 3, 4], [1, 3])


def small_graph_step_check(compute_dtype="float32"):
    """The captured train step (``train/fused.py``) against the eager step
    on the card: the tiny models (``--preset tiny``: K2 at head dim 8),
    64 px, diffusion batch 2, five steps at context sizes 2, 3, 2, 3, 2
    (two graphs, three replays), each run from a generator of one seed
    and on the depth range computed on the device: draws bit-equal, the
    first step's loss, every free-running step's loss and each model's
    parameters after the five steps within ``GRAPH_TOL``; every step's
    loss within it too from a run, as graphs, whose parameters are set
    to the eager run's before each step.  Beside them, the eager run
    against itself (the spread the free-running bound sits above,
    printed) and the control, the eager run with its updates lost
    (learning rate 0), whose later losses must leave the free-running
    bound.  Then a NaN batch replayed in the graph: parameters
    bit-identical, one skipped update counted by each optimizer.  K2
    launches 3 x UNet forwards in the graph run, counted per replay."""
    from sparsefusion_tpu_torch.cli.train import build_trio, parse_args
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.train.fused import FusedTrainStep
    from sparsefusion_tpu_torch.train.trainer import (
        TrainConfig,
        make_optimizers,
        make_train_step,
        prepare_scene_batch,
    )

    scene = make_synthetic_scene(n_views=5, image_size=64, seed=0)
    cfg = TrainConfig(latent_size=8, context_size=3, diffusion_batch_size=2,
                      compute_dtype=compute_dtype)
    tol = GRAPH_TOL[compute_dtype]

    def batch(ctx, device):
        b = prepare_scene_batch([scene], [0], [ctx], device)
        del b["depth_range"]
        return b

    runs = {}
    before = []      # the eager run's parameters before each step
    for kind in ("eager", "eager_again", "update_lost", "graph",
                 "graph_synced"):
        models = build_trio(parse_args(TRAIN_TINY), torch.device("cuda"))
        with torch.no_grad():   # a zero final conv would hide the UNet
            models.unet.final_conv.weight.normal_(
                0.0, 0.1,
                generator=torch.Generator(device="cuda").manual_seed(1))
        unet_opt, eft_opt = make_optimizers(cfg, models)
        if kind == "update_lost":
            for opt in (unet_opt, eft_opt):
                opt.schedule.table.zero_()
                opt.schedule.load_state_dict({"last_epoch": 0})
        step = make_train_step(models, cfg, unet_opt, eft_opt)
        gen = torch.Generator(device="cuda").manual_seed(11)
        fused = FusedTrainStep(step, gen) if kind.startswith("graph") \
            else None
        _reset_counts()
        evals0 = models.unet_evals
        losses, draws = [], []
        named = [(f"{name}.{n}", p)
                 for name, m in (("unet", models.unet), ("eft", models.eft))
                 for n, p in m.named_parameters()]
        for i, ctx in enumerate(GRAPH_CONTEXTS):
            with torch.no_grad():
                if kind == "eager":
                    before.append({n: p.detach().clone() for n, p in named})
                elif kind == "graph_synced":
                    for n, p in named:
                        p.copy_(before[i][n])
            if fused is not None:
                out = fused(batch(ctx, None))
            else:
                out = torch.stack(step(batch(ctx, "cuda"), gen))
            losses.append(out.tolist())
            draws.append({k: v.clone() for k, v in step.draws[0].items()})
        counts = _read_counts()
        evals = models.unet_evals - evals0
        params = {f"{name}.{n}": p.detach().clone()
                  for name, m in (("unet", models.unet), ("eft", models.eft))
                  for n, p in m.named_parameters()}
        runs[kind] = {"losses": losses, "draws": draws, "params": params}
        assert evals == len(GRAPH_CONTEXTS), evals
        assert counts["imagen_attention"] == 3 * evals, counts
        assert counts["imagen_attention_bf16"] == (
            counts["imagen_attention"] if compute_dtype == "bfloat16"
            else 0), counts
        if kind == "graph":
            stats = fused.stats()
            assert stats["warmups"] == 2 and stats["replays"] == 3, stats
            assert sorted(c["key"] for c in stats["captures"]) == [2, 3]
            bad = batch(GRAPH_CONTEXTS[0], None)
            bad["query_rgb"][..., 0] = float("nan")
            out = fused(bad)
            assert not math.isfinite(out[0].item())
            assert fused.stats()["replays"] == 4
            assert all(torch.equal(p.detach(), params[f"{name}.{n}"])
                       for name, m in (("unet", models.unet),
                                       ("eft", models.eft))
                       for n, p in m.named_parameters()), \
                "a NaN batch in the graph moved the parameters"
            assert unet_opt.notfinite == eft_opt.notfinite == 1
            runs[kind]["captures"] = stats["captures"]
        del models, step, fused, unet_opt, eft_opt
        torch.cuda.empty_cache()
    eager, graph = runs["eager"], runs["graph"]
    for kind, run in runs.items():
        for a, b in zip(eager["draws"], run["draws"]):
            assert all(torch.equal(a[k], b[k]) for k in a), \
                f"draws differ ({kind})"

    def loss_rel(run):
        return [abs(a[0] - b[0]) / abs(a[0])
                for a, b in zip(eager["losses"], run["losses"])]

    synced, free = loss_rel(runs["graph_synced"]), loss_rel(graph)
    lost = loss_rel(runs["update_lost"])
    worst = {"first_loss": free[0], "loss": max(synced),
             "loss_by_step": synced, "free_running_loss": max(free),
             "free_running_loss_by_step": free,
             "eager_vs_eager_loss_by_step": loss_rel(runs["eager_again"]),
             "update_lost_loss_by_step": lost}
    for model in ("unet", "eft"):
        names = [n for n in eager["params"] if n.startswith(model + ".")]
        pe = torch.cat([eager["params"][n].ravel() for n in names])
        pg = torch.cat([graph["params"][n].ravel() for n in names])
        worst[f"{model}_param"] = ((pe - pg).norm() / pe.norm()).item()
    print(f"tiny train step ({compute_dtype}), graph vs eager over "
          f"{len(GRAPH_CONTEXTS)} steps: draws bit-equal, worst relative "
          f"errors {json.dumps(worst)} (tolerances {json.dumps(tol)}); "
          "a NaN batch replayed: no parameter moved, guard counts 1 / 1")
    assert worst["first_loss"] <= tol["first_loss"], worst
    assert worst["loss"] <= tol["loss"], worst
    assert worst["free_running_loss"] <= tol["free_running_loss"], worst
    assert worst["unet_param"] <= tol["param"], worst
    assert worst["eft_param"] <= tol["param"], worst
    # the control: the bound tells a step that lost its update
    assert max(lost[1:]) > tol["free_running_loss"], worst
    return worst


class _EagerTrainStep:
    """The eager step in the train CLI's place of the captured one (the
    smoke's comparison): the host batch copied to the card, the depth
    range as host floats, the guard read on the host."""

    def __init__(self, step, generator):
        self.step, self.generator = step, generator

    def __call__(self, batch):
        dev = self.generator.device
        moved = {k: ([c.to(dev) for c in v] if k.endswith(("cam", "cams"))
                     else v if k == "depth_range" else v.to(dev))
                 for k, v in batch.items()}
        return torch.stack(self.step(moved, self.generator))

    def stats(self):
        return None


class _StepProbe(_LoopProbe):
    """:class:`_LoopProbe` over the train CLI's steps, through its
    ``step_hook``: syncs, launches and profiler windows by step index."""

    def __enter__(self):
        import warnings

        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        if self._prof is not None:
            self._prof.stop()
        return False


# the graph run's steps after the resume at step 10: reads at 50 and 100
GRAPH_TRAIN_STEPS = 110
EAGER_TRAIN_STEPS = 20
# profiler windows and sync counts by step index: (a, b) covers steps
# a + 1 .. b, between the loss reads (every 50 steps and at the end)
TRAIN_WINDOWS = {"graph": {"steps": (69, 79)}, "eager": {"steps": (5, 10)}}
TRAIN_SYNC_SPANS = {"graph": (51, 99), "eager": (1, 19)}


def train_main_path(counts, bf16=False, graphs=True):
    """Full-width training through the CLI (``--bf16``: the UNet in bf16).
    As on the card by default, each step a replayed CUDA graph
    (``graphs``): 10 steps, a checkpoint, ``--resume`` to step 110, which
    is measured (loss reads at steps 50 and 100); or the eager step in the
    CLI's place (``_EagerTrainStep``): 20 steps, measured (reads at step
    0 and at the end).  Steps/s between two reads (less the probe's own
    seconds), syncs a step between reads (sync debug mode), a profiler
    window's device and host ms a step and idle share, the graphs'
    captures and replays, peak memory of the measured run.  ``counts``:
    the step counts of ``sparsefusion_tpu_torch.tools.flops`` for the
    bound of the drawn context sizes at the step's precision."""
    import gc

    from sparsefusion_tpu_torch.cli.train import main as train_main
    from sparsefusion_tpu_torch.tools.flops import step_bound_s
    from sparsefusion_tpu_torch.train import fused as train_fused

    kind = "graph" if graphs else "eager"
    argv = ["-d", "synthetic", "-c", "any", "--image_size", "256",
            "--vis_itr", "0", "--device", "cuda", "--save_itr", "1000"]
    argv += ["--bf16"] if bf16 else []
    precision = "bfloat16" if bf16 else "float32"
    probe = _StepProbe(TRAIN_WINDOWS[kind])

    def run(args, measured):
        # the last run's graphs and blocks freed, so the peak is this run's
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        if measured:
            with probe:
                r = train_main(args, step_hook=probe.hook)
        else:
            r = train_main(args)
        return r, _read_counts(), _peak()

    original = train_fused.FusedTrainStep
    if not graphs:
        train_fused.FusedTrainStep = _EagerTrainStep
    runs = []
    try:
        with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir:
            argv += ["--exp_dir", exp_dir]
            ckpt = os.path.join(exp_dir, "sf", "any", "ckpt_latest")
            if graphs:
                runs.append(run(argv + ["--steps", "10"], False))
                ckpt_gib = os.path.getsize(ckpt) / 2 ** 30
                runs.append(run(argv + ["--steps", str(GRAPH_TRAIN_STEPS),
                                        "--resume", ckpt], True))
            else:
                runs.append(run(argv + ["--steps", str(EAGER_TRAIN_STEPS)],
                                True))
                ckpt_gib = os.path.getsize(ckpt) / 2 ** 30
    finally:
        train_fused.FusedTrainStep = original

    # steps/s between two loss reads, less the probe's own seconds there:
    # the graph run's at steps 50 and 100, the eager run's at step 0 and
    # at its end
    r, _, peak = runs[-1]
    (n_a, t_a), (n_b, t_b) = _train_reads(r)[:2]
    start = r["start_step"]
    probe_s = sum(sec for i, sec in probe.hook_s.items()
                  if start + n_a <= i < start + n_b)
    cap_s = _span_s(r, _is_capture,
                    lambda i: i is not None and n_a <= i < n_b)
    sizes = r["context_sizes"][n_a:n_b]
    bound_s = sum(step_bound_s(counts, nc, precision) for nc in sizes)
    sa, sb = TRAIN_SYNC_SPANS[kind]
    window = probe.window["steps"]
    stats = {"steps_per_s": (n_b - n_a) / (t_b - t_a - probe_s),
             "steps_between_reads": [start + n_a, start + n_b],
             "probe_s_between_reads": probe_s,
             "capture_s_between_reads": cap_s,
             "bound_steps_per_s": len(sizes) / bound_s,
             "syncs_per_step_between_reads": probe.syncs_per_itr(sa, sb),
             "device_ms_per_step": window["device_ms_per_itr"],
             "host_ms_per_step": window["host_ms_per_itr"],
             "idle_share": window["idle_share"],
             "kernels_per_step": window["kernels_per_itr"],
             "graphs": [_graph_stats(x) for x, _, _ in runs] if graphs
             else None,
             "peak_gib_allocated_reserved": peak,
             "checkpoint_gib": ckpt_gib,
             "context_sizes": sum((x["context_sizes"] for x, _, _ in runs),
                                  []),
             "unet_forwards": sum(x["unet_evals"] for x, _, _ in runs),
             "loss_first5": float(np.mean(runs[0][0]["losses"][:5])),
             "loss_last5": float(np.mean(r["losses"][-5:])),
             "resumed_at": r["start_step"]}
    label = f"train main path ({precision}, {kind})"
    print(f"{label}: " + json.dumps(stats))
    print(f"{label}: launches " + "; ".join(json.dumps(c) for _, c, _ in runs))
    lengths = [10, GRAPH_TRAIN_STEPS - 10] if graphs else [EAGER_TRAIN_STEPS]
    assert [len(x["losses"]) for x, _, _ in runs] == lengths
    assert r["start_step"] == (10 if graphs else 0)
    for x, counted, _ in runs:
        assert np.isfinite(x["losses"]).all()
        assert x["notfinite"] == {"unet": 0, "eft": 0}
        assert x["params_without_grad"] == 0
        assert (x["fused"] is not None) == graphs
        if graphs:
            # every context size drawn twice was captured, the rest replayed
            seen = {c: x["context_sizes"].count(c)
                    for c in set(x["context_sizes"])}
            keys = sorted(c["key"] for c in x["fused"]["captures"])
            assert keys == sorted(c for c, n in seen.items() if n > 1), keys
            assert x["fused"]["replays"] == sum(n - 1 for n in seen.values()
                                                if n > 1)
        assert x["unet_evals"] == len(x["losses"])
        # three attention layers a forward, at a kernel head dim (64)
        assert counted["imagen_attention"] == 3 * x["unet_evals"], counted
        assert counted["imagen_attention_bf16"] == (
            counted["imagen_attention"] if bf16 else 0), counted
    if graphs:
        assert stats["syncs_per_step_between_reads"] == 0, stats
    both = {k: sum(c[k] for _, c, _ in runs) for k in runs[0][1]}
    return both, stats


def compare_train_paths(precision, graph, eager):
    """The graph and eager train main paths of one precision, side by
    side."""
    keys = ("steps_per_s", "steps_between_reads", "probe_s_between_reads",
            "capture_s_between_reads", "bound_steps_per_s",
            "syncs_per_step_between_reads", "device_ms_per_step",
            "host_ms_per_step", "idle_share", "kernels_per_step",
            "peak_gib_allocated_reserved", "graphs")
    print(f"graph vs eager, train main path ({precision}): " + json.dumps(
        {"graph": {k: graph[k] for k in keys},
         "eager": {k: eager[k] for k in keys}}))


def train_phase():
    """Step 7: the tiny train step card against CPU and graph against
    eager, the full-width main paths (graphs, then the eager twin, per
    precision), the profiles.  Returns (launches by path, profiles)."""
    from sparsefusion_tpu_torch.tools.flops import train_step_counts

    small_train_step_check()
    small_train_step_check("bfloat16")
    small_graph_step_check()
    small_graph_step_check("bfloat16")
    _mark("train steps card vs CPU, graph vs eager")
    counts = train_step_counts()
    launches = {}
    for bf16 in (False, True):
        path = "train_bf16" if bf16 else "train"
        launches[path], graph = train_main_path(counts, bf16)
        launches[f"{path}_eager"], eager = train_main_path(
            counts, bf16, graphs=False)
        compare_train_paths("bfloat16" if bf16 else "float32", graph, eager)
    _mark("train main paths, graphs and eager")
    profiles = {}
    reference = None
    for precision in ("float32", "tf32", "bfloat16"):
        profiles[precision], _, first = train_step_profile(
            counts, precision, reference)
        if reference is None:
            reference = first
    del reference
    _mark("train step profiles")
    return launches, profiles


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


def _syncs_per_call(run, n_calls):
    """The host's synchronising CUDA calls a call over ``run()``, which
    makes ``n_calls`` calls (sync debug mode, each warning counted)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in log) / n_calls


def _graph_step_profile(step, models, scene, n_context, gen):
    """The profile's step as one replayed CUDA graph
    (``train/fused.py::FusedTrainStep``, the CLI's step on the card):
    after its eager run and its capture, ``PROFILE_TRAIN_STEPS`` replays
    under torch.profiler (device ms a step by kernel class, host ms, idle
    share), their syncs in sync debug mode, K2's launches a replay."""
    from sparsefusion_tpu_torch.train.fused import FusedTrainStep
    from sparsefusion_tpu_torch.train.trainer import prepare_scene_batch

    fused = FusedTrainStep(step, gen)
    host = prepare_scene_batch([scene], [0], [list(range(1, 1 + n_context))])

    def run(n):
        for _ in range(n):
            fused(host)

    run(2)
    torch.cuda.synchronize()
    evals0 = []

    def reset():
        _reset_counts()
        evals0[:] = [models.unet_evals]

    per_step, _, host_ms = profile_window(
        lambda: run(PROFILE_TRAIN_STEPS), PROFILE_TRAIN_STEPS, reset=reset)
    launches = _read_counts()
    evals = models.unet_evals - evals0[0]
    device_ms = sum(per_step.values())
    by_class = {}
    for name, ms in per_step.items():
        by_class[_kernel_class(name)] = by_class.get(_kernel_class(name),
                                                     0.0) + ms
    stats = {"device_ms_per_step": device_ms, "host_ms_per_step": host_ms,
             "device_idle_share": max(0.0, 1 - device_ms / host_ms),
             "syncs_per_step": _syncs_per_call(
                 lambda: run(PROFILE_TRAIN_STEPS), PROFILE_TRAIN_STEPS),
             "by_kernel_class": by_class,
             "k2_launches_per_step": launches["imagen_attention"]
             / PROFILE_TRAIN_STEPS,
             "unet_forwards_per_step": evals / PROFILE_TRAIN_STEPS,
             "graphs": fused.stats()}
    del fused
    return stats


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
    eager_syncs = _syncs_per_call(lambda: run(PROFILE_TRAIN_STEPS),
                                  PROFILE_TRAIN_STEPS)
    graph = _graph_step_profile(step, models, scene, n_context, gen)
    bound_ms = max(counts["adam_bytes"] / HBM_BYTES_PER_S,
                   step_bound_s(counts, n_context, precision)) * 1e3
    bound_by = ("bytes" if counts["adam_bytes"] / HBM_BYTES_PER_S * 1e3
                >= bound_ms else "operations")
    stats = {"precision": precision, "first_step_vs_f32": gap,
             "context_views": n_context, "device_ms_per_step": device_ms,
             "host_ms_per_step": host_ms,
             "device_idle_share": max(0.0, 1 - device_ms / host_ms),
             "syncs_per_step": eager_syncs, "graph": graph,
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
    assert graph["k2_launches_per_step"] == 3 * graph["unet_forwards_per_step"]
    assert graph["syncs_per_step"] == 0, graph
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


# ---- the JAX package's last modules: mesh export, the sweep, Perceiver ----

MESH_BOUND = 4.0
MESH_RES = 128
MESH_CHUNK = 65536
# card against CPU on one field's export: the density grids (K1 and the
# MLP against the plain encode: float32 sums in another order, relative
# ~1e-5 of sigma = exp(h)); face and vertex counts; the symmetric
# nearest-vertex distance in grid spacings, its 99.99th percentile and
# its maximum; the baked atlas of the card's mesh against the CPU bake of
# the same mesh.  A vertex moves by the grid's difference over the
# difference of its edge's two values, so where a surface crosses an
# edge nearly flat a 1e-6 difference moves it far: the maximum over the
# preset field's 2M vertices is a tail statistic (8.7e-5 to 5.9e-4
# spacings in the first runs), held at 1e-2; the 99.99th percentile at
# 1e-3
MESH_GRID_RTOL = 1e-4
MESH_COUNT_TOL = 1e-3
MESH_DIST_TOL = 1e-3
MESH_DIST_MAX_TOL = 1e-2
MESH_ATLAS_TOL = 1e-4
MESH_ATLAS_FACES = 4096
# K1 takes ~20 us on a grid chunk: a profiler window of PROFILE_ITERS
# launches (0.2 ms) could end before the tracer recorded any of them
MESH_CHUNK_ITERS = 100
# the analytic blob field: a vertex's field value against the iso level,
# as a share of it (linear interpolation along an edge of 8 / 127 inside
# gaussians of radius 0.45; 3.2% measured on the CPU)
BLOB_ISO_TOL = 0.05


def _field(ngp_config, params, device):
    from sparsefusion_tpu_torch.nn.ngp import NGPField, load_jax_params

    field = NGPField(ngp_config, device=device)
    load_jax_params(field, params)
    return field.eval().requires_grad_(False)


def _nearest(a, b):
    """The distance from each row of ``a`` to its nearest row of ``b``, in
    float64 (a k-d tree on the host)."""
    from scipy.spatial import cKDTree

    return cKDTree(b.double().cpu().numpy()).query(
        a.double().cpu().numpy())[0]


def _atlas_cells(tex, n_cells, block=8):
    """The first ``n_cells`` (block, block) chart cells of an atlas, in
    the bake's cell order (row-major over the atlas)."""
    per_row = tex.shape[0] // block
    cells = tex.reshape(per_row, block, per_row, block, 3)
    return cells.permute(0, 2, 1, 3, 4).reshape(-1, block, block, 3)[:n_cells]


def _host_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_export_check(name, ngp_config, params, exp_dir, textured):
    """``render/mesh.py`` on the card from a distilled field: the 128^3
    export (K1's launches counted over it, its device ms profiled), and
    with ``textured`` the textured export; held against the same
    extraction on the CPU through the plain encode; K1 on one 65,536-point
    grid chunk against its plain version and its bound; host seconds of
    the grid, the marching and the writes."""
    from sparsefusion_tpu_torch.kernels.grid_encode import grid_encode_cuda
    from sparsefusion_tpu_torch.ops.grid_encode import grid_encode_plain
    from sparsefusion_tpu_torch.render import mesh

    card, cpu = (_field(ngp_config, params, d) for d in ("cuda", "cpu"))

    def sigma(field):
        return lambda x: field.density(x)["sigma"]

    def albedo(field):
        return lambda x: field.density(x)["albedo"]

    kw = dict(bound=MESH_BOUND, resolution=MESH_RES, chunk=MESH_CHUNK)
    n_launches = MESH_RES ** 3 // MESH_CHUNK
    # the main path: the export, counted and profiled
    out = {}

    def export():
        out["mesh"] = mesh.export_mesh(sigma(card), f"{exp_dir}/{name}.obj",
                                       density_thresh=10.0, device="cuda",
                                       **kw)

    export_dev, _, export_ms = profile_window(export, 1, reset=_reset_counts)
    grid_launches = _read_counts()["grid_encode_fwd"]
    v, f = out["mesh"]
    textured_launches, tex = 0, None
    if textured:
        _reset_counts()
        (tv, tf, tex), textured_s = _host_s(
            lambda: mesh.export_mesh_textured(
                sigma(card), albedo(card), f"{exp_dir}/{name}_tex.obj",
                density_thresh=10.0, device="cuda", **kw))
        textured_launches = _read_counts()["grid_encode_fwd"]
    print(f"mesh export ({name}): {len(f)} faces, {len(v)} vertices; "
          f"export {export_ms / 1e3:.2f} s", flush=True)

    # the same extraction on the CPU, through the plain encode: the
    # export's two steps, the density grid and the marching
    xs = mesh.grid_axis(MESH_BOUND, MESH_RES)
    spacing = float(xs[1] - xs[0])
    origin = np.full(3, -MESH_BOUND)
    spacings = np.full(3, xs[1] - xs[0], np.float64)
    t0 = time.perf_counter()
    grid_cpu = mesh.density_grid(sigma(cpu), device="cpu", **kw)
    v_cpu, f_cpu = mesh.marching_tetrahedra(grid_cpu, 10.0, origin, spacings)
    cpu_s = time.perf_counter() - t0
    grid_card, grid_s = _host_s(lambda: mesh.density_grid(
        sigma(card), device="cuda", **kw))
    _, march_s = _host_s(lambda: mesh.marching_tetrahedra(
        grid_card, 10.0, origin, spacings))
    grid_rel = ((grid_card.cpu() - grid_cpu).abs()
                / grid_cpu.abs().clamp(min=1e-6)).max().item()
    dists = np.concatenate([_nearest(v, v_cpu), _nearest(v_cpu, v)]) \
        if len(v) else np.zeros(1)
    dist, dist_p9999 = float(dists.max()), float(np.quantile(dists, 0.9999))
    counts = {"faces": (len(f), len(f_cpu)), "vertices": (len(v), len(v_cpu))}
    count_rel = max(abs(a - b) / max(b, 1) for a, b in counts.values())
    stats = {"layout": name, "faces": counts["faces"],
             "vertices": counts["vertices"], "count_rel": count_rel,
             "grid_max_rel": grid_rel, "nearest_vertex_max": dist,
             "nearest_vertex_max_spacings": dist / spacing,
             "nearest_vertex_p9999_spacings": dist_p9999 / spacing,
             "k1_launches_grid": grid_launches,
             "export_device_ms": sum(export_dev.values()),
             "export_host_s": export_ms / 1e3, "grid_host_s": grid_s,
             "march_host_s": march_s,
             "writes_host_s": export_ms / 1e3 - grid_s - march_s,
             "cpu_grid_and_march_s": cpu_s}
    if textured:
        # the atlas: the CPU bake of the card's mesh against the card's
        # bake, over the cells of its first MESH_ATLAS_FACES faces (a
        # cell's texels depend on its own two faces only)
        n_faces = min(len(tf), MESH_ATLAS_FACES)
        tex_cpu, _ = mesh.bake_texture(tv.cpu(), tf[:n_faces].cpu(),
                                       albedo(cpu), chunk=MESH_CHUNK)
        n_cells = (n_faces + 1) // 2
        stats.update({
            "k1_launches_textured": textured_launches,
            "textured_host_s": textured_s, "atlas_size": tex.shape[0],
            "atlas_max_abs": (_atlas_cells(tex.cpu(), n_cells)
                              - _atlas_cells(tex_cpu, n_cells)
                              ).abs().max().item(),
            "files": {ext: os.path.exists(f"{exp_dir}/{name}_tex{ext}")
                      for ext in (".obj", ".mtl", ".png")}})

    # K1 on the middle grid chunk (x around 0: through the object)
    grid = torch.stack(torch.meshgrid(*[torch.from_numpy(xs).cuda()] * 3,
                                      indexing="ij"), -1).reshape(-1, 3)
    x01 = ((grid[16 * MESH_CHUNK:17 * MESH_CHUNK] + MESH_BOUND)
           / (2 * MESH_BOUND)).contiguous()
    bf16 = ngp_config.table_dtype == "bfloat16"
    table = card.grid.to(torch.bfloat16) if bf16 else card.grid
    enc = card.enc
    k1_out = grid_encode_cuda(x01, table, enc)
    plain = grid_encode_plain(x01, card.grid, enc, ngp_config.table_dtype)
    grid_dev = device_ms(lambda: mesh.density_grid(
        sigma(card), device="cuda", **kw), 3)
    stats.update({
        "k1_max_abs_err_chunk": (k1_out - plain).abs().max().item(),
        "k1_ms_per_launch": named_ms(device_ms(
            lambda: grid_encode_cuda(x01, table, enc), MESH_CHUNK_ITERS),
            "grid_encode_fwd_kernel"),
        "k1_plain_ms": sum(device_ms(lambda: grid_encode_plain(
            x01, card.grid, enc, ngp_config.table_dtype),
            PROFILE_ITERS).values()),
        "k1_grid_ms_per_launch": named_ms(
            grid_dev, "grid_encode_fwd_kernel") / n_launches,
        "grid_device_ms": sum(grid_dev.values())})
    stats["k1_bound_ms"], stats["k1_bound_by"] = _bound(
        _nbytes(x01, table, k1_out))
    print(f"mesh export ({name}, {MESH_RES}^3): " + json.dumps(stats))
    assert len(f) > 0, f"{name}: no faces at density_thresh 10"
    assert grid_launches == n_launches, grid_launches
    assert stats["k1_max_abs_err_chunk"] <= 1e-5, stats
    assert grid_rel <= MESH_GRID_RTOL, grid_rel
    assert count_rel <= MESH_COUNT_TOL, counts
    assert dist_p9999 <= MESH_DIST_TOL * spacing, dist_p9999 / spacing
    assert dist <= MESH_DIST_MAX_TOL * spacing, dist / spacing
    if textured:
        assert textured_launches > n_launches, textured_launches
        assert all(stats["files"].values()), stats["files"]
        assert stats["atlas_max_abs"] <= MESH_ATLAS_TOL, stats
    return stats


def mesh_timing_256(ngp_config, params, exp_dir):
    """The 256^3 export of one field, for its times only (256 launches)."""
    from sparsefusion_tpu_torch.render import mesh

    card = _field(ngp_config, params, "cuda")

    def sigma(x):
        return card.density(x)["sigma"]

    _reset_counts()
    (v, f), export_s = _host_s(lambda: mesh.export_mesh(
        sigma, f"{exp_dir}/mesh256.obj", resolution=256, device="cuda"))
    launches = _read_counts()["grid_encode_fwd"]
    grid, grid_s = _host_s(lambda: mesh.density_grid(sigma, resolution=256,
                                                     device="cuda"))
    _, march_s = _host_s(lambda: mesh.marching_tetrahedra(
        grid, 10.0, np.full(3, -4.0), np.full(3, 8.0 / 255)))
    grid_dev = device_ms(lambda: mesh.density_grid(
        sigma, resolution=256, device="cuda"), 1)
    stats = {"faces": len(f), "vertices": len(v), "k1_launches": launches,
             "k1_grid_ms_per_launch": named_ms(
                 grid_dev, "grid_encode_fwd_kernel") / 256,
             "grid_device_ms": sum(grid_dev.values()),
             "export_host_s": export_s, "grid_host_s": grid_s,
             "march_host_s": march_s,
             "writes_host_s": export_s - grid_s - march_s}
    print("mesh export (256^3): " + json.dumps(stats))
    assert launches == 256 and len(f) > 0, (launches, len(f))
    return launches


def blob_mesh_check(exp_dir):
    """The extractor on an analytic field: ``data/synthetic.py``'s blobs of
    scene 0 at 128^3 on the card; every vertex's field value within
    BLOB_ISO_TOL of the iso level."""
    from sparsefusion_tpu_torch.data.synthetic import blob_field
    from sparsefusion_tpu_torch.render import mesh

    rng = np.random.RandomState(0)   # make_synthetic_scene(seed=0)'s blobs
    centers = rng.uniform(-0.7, 0.7, (4, 3)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (4, 3)).astype(np.float32)
    field = blob_field(centers, colors, device="cuda")
    v, f = mesh.export_mesh(lambda x: field(x)[0], f"{exp_dir}/blob.obj",
                            device="cuda")
    dev = (field(v)[0] - 10.0).abs() / 10.0
    print(f"blob mesh (128^3): {len(v)} vertices, {len(f)} faces, field "
          f"at the vertices within {dev.max().item():.4f} of the iso level "
          f"(mean {dev.mean().item():.4f}; tolerance {BLOB_ISO_TOL})")
    assert len(f) > 1000 and dev.max().item() <= BLOB_ISO_TOL


def mesh_phase(fields):
    """``fields``: {layout name: (NGPConfig, distilled params)}.  Returns
    K1's launches on the mesh paths (the main exports, and 256^3)."""
    launches = {}
    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_mesh_") as d:
        # the textured export on the first field's mesh; the second's
        # (the TPU preset's 600-iteration field) has millions of faces,
        # whose bake and text take minutes
        stats = {name: mesh_export_check(name, cfg, params, d, i == 0)
                 for i, (name, (cfg, params)) in enumerate(fields.items())}
        for name, s in stats.items():
            launches[f"mesh_{name}"] = (s["k1_launches_grid"]
                                        + s.get("k1_launches_textured", 0))
        cfg, params = next(iter(fields.values()))
        launches["mesh_256"] = mesh_timing_256(cfg, params, d)
        blob_mesh_check(d)
    return launches, stats


class _PerRow:
    """Launch counts and UNet evaluations of each ``distillation_loop``
    call (each row of the parity sweep): the counts reset just before
    the call and read just after."""

    def __enter__(self):
        from sparsefusion_tpu_torch.distill import loop

        self.rows, self._loop = [], loop
        self._fn = fn = loop.distillation_loop

        def counted(*args, **kw):
            _reset_counts()
            out = fn(*args, **kw)
            self.rows.append({"launches": _read_counts(),
                              "unet_evals": out["unet_evals"]})
            return out

        loop.distillation_loop = counted
        return self

    def __exit__(self, *exc):
        self._loop.distillation_loop = self._fn
        return False


SWEEP_DIFFUSION_ITR = 1002   # the first fusion step is iteration 1001


def sweep_phase():
    """The parity sweep's counterpart on the card: a 256 px fixture (one
    category, one scene) by ``tools/make_toy_fixture.py``, then
    ``tools/parity_sweep.py`` with full-width models: NGP-only at 2 and 3
    views, 100 iterations; and one diffusion row (2 views) at the
    smallest ``--max_itr`` that reaches the fusion step, under ``--preset
    tpu``.  K1 launches on every row, K2 three times a UNet evaluation;
    every PSNR finite, the NGP-only rows' >= 15."""
    from sparsefusion_tpu_torch.tools import make_toy_fixture, parity_sweep

    out = {}
    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_sweep_") as d:
        make_toy_fixture.main(["--root", f"{d}/fixture", "--categories",
                               "hydrant", "--scenes", "1", "--views", "10",
                               "--size", "256"])
        base = ["--root", f"{d}/fixture", "--categories", "hydrant",
                "--scenes", "0"]
        for kind, argv in (
                ("ngp", ["--views", "2", "3", "--max_itr", "100",
                         "--no_diffusion"]),
                ("diffusion", ["--views", "2", "--max_itr",
                               str(SWEEP_DIFFUSION_ITR), "--preset", "tpu"])):
            t0 = time.perf_counter()
            with _PerRow() as per_row:
                rows = parity_sweep.main(base + argv + ["--out",
                                                        f"{d}/{kind}"])
            wall = time.perf_counter() - t0
            with open(f"{d}/{kind}/parity_sweep.md") as fp:
                table = fp.read()
            print(f"parity sweep ({kind}, {wall:.1f} s):\n{table}", end="")
            for row, counted in zip(rows, per_row.rows):
                c = counted["launches"]
                print(f"parity sweep row {json.dumps(row)}: launches "
                      f"{json.dumps(c)}, UNet evaluations "
                      f"{counted['unet_evals']}")
                assert math.isfinite(row["psnr"]), row
                assert c["grid_encode_fwd"] > 0 and c["grid_encode_bwd"] > 0
                assert c["imagen_attention"] == 3 * counted["unet_evals"], c
                if kind == "ngp":
                    assert row["psnr"] >= 15.0, row
                    assert counted["unet_evals"] == 0
                else:
                    assert counted["unet_evals"] > 0
            assert os.path.exists(f"{d}/{kind}/parity_sweep.json")
            assert len(rows) == len(per_row.rows) == (
                2 if kind == "ngp" else 1)
            out[kind] = {"rows": rows, "launches": [
                r["launches"] for r in per_row.rows], "wall_s": wall}
    return out


PERCEIVER_TOL = 1e-4   # card against CPU, f32 (TF32 off), outputs O(1)


def perceiver_check():
    """``nn/layers.py::PerceiverResampler`` at the JAX package's default
    width (dim 512, depth 2, 8 heads x 64, 64 + 4 latents) over 256
    tokens, batch 2: the card against the CPU from the same weights."""
    from sparsefusion_tpu_torch.nn.flax_layout import init_like_flax_
    from sparsefusion_tpu_torch.nn.layers import PerceiverResampler

    cpu = PerceiverResampler(512)
    init_like_flax_(cpu, torch.Generator().manual_seed(0))
    card = PerceiverResampler(512).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 256, 512, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = cpu(x)
        got = card(x.cuda())
        ms = sum(device_ms(lambda: card(x.cuda()), PROFILE_ITERS).values())
    err = (got.cpu() - want).abs().max().item()
    print(f"Perceiver resampler (dim 512, 68 latents over 256 tokens): "
          f"{tuple(got.shape)}, card vs CPU max abs err {err:.3e} "
          f"(tolerance {PERCEIVER_TOL}; max |out| "
          f"{want.abs().max().item():.2f}), {ms:.4f} device ms")
    assert got.shape == (2, 68, 512) and torch.isfinite(got).all()
    assert err <= PERCEIVER_TOL, err


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
    parser.add_argument("--k1-only", action="store_true",
                        help="stop after K1's single-scene kernel phase and "
                             "the input step's profile (with --csrc, an "
                             "older grid_encode.cu given today's C entries)")
    parser.add_argument("--csrc", default=None,
                        help="build the kernels from this directory of "
                             "sources instead of the package's csrc/ (the "
                             "C entry points must match), e.g. to time "
                             "another commit's kernels in the same call")
    parser.add_argument("--train-only", action="store_true",
                        help="after the build, run K1's summation-bound "
                             "check and the training phases (step 7) only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sparsefusion_tpu_torch.cli import demo
    from sparsefusion_tpu_torch.kernels import _build
    from sparsefusion_tpu_torch.utils import spans
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    global _BUILD_TRIO
    _BUILD_TRIO, demo.build_trio = demo.build_trio, _shared_trio
    set_tf32(False)
    # every iteration and step is a recorded unit: the rates below are
    # read from the loops' loss-read spans
    spans.enable()
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
    if args.train_only:
        k1_summation_bound_check()
        train_phase()
        return 0
    errs, times = kernel_phase()
    if args.k1_only:
        step_stats = input_step_profile()["reference"]
        print(json.dumps({"kernel_times": times, "max_abs_err": errs,
                          "input_step": step_stats}))
        return 0
    scene_times = scene_kernel_phase()
    k1_spread = k1_summation_bound_check()
    _mark("K1 kernel phase")
    attn_err, attn_times, _ = attention_phase(torch.float32)
    bf16_err, bf16_times, bf16_phase_bodies = attention_phase(torch.bfloat16)
    _mark("K2 kernel phase")
    k3_launches, k3_micro, k3_f32, k3_err = row_gather_phase()
    _mark("K3 kernel phase")
    step_stats = input_step_profile()["reference"]
    step_stats_scenes = input_step_profile(n_scenes=SCENES)
    _mark("input step profile")
    if args.kernels_only:
        print(json.dumps({"kernel_times": times,
                          "scene_kernel_times": scene_times,
                          "attention": attn_times,
                          "attention_bf16": bf16_times,
                          "row_gather": {str(n): m for n, m in
                                         k3_micro.items()},
                          "input_step": step_stats,
                          "input_step_scenes": step_stats_scenes}))
        return 0
    for instance in ("imagen_attention_fwd", "imagen_attention_bf16_fwd"):
        assert any(c["HMMA"] > 0 for f, c in sass.items()
                   if instance in f), f"K2's {instance} issues no HMMA"
    input_step_profile("tpu")
    _mark("TPU preset input step profile")
    small_input_step_check()
    small_diffusion_steps_check()
    small_diffusion_steps_check(sampler_bf16=True)
    small_batched_steps_check()
    _mark("steps card vs CPU")
    fused_check = fused_loop_card_check()
    _mark("fused loop vs eager loop")
    small_occupancy_steps_check(occupancy_card_check())
    _mark("occupancy card vs CPU")
    ngp_launches, ngp_stats, ngp_params = main_path()
    _, ngp_eager, _ = main_path(fused=False)
    _compare_pair("NGP-only demo", ngp_stats["loop"], ngp_eager["loop"])
    tpu_ngp_launches, tpu_ngp_stats, tpu_ngp_params = tpu_ngp_main_path()
    _, tpu_ngp_eager, _ = tpu_ngp_main_path(fused=False)
    _compare_pair("TPU preset NGP-only demo", tpu_ngp_stats["loop"],
                  tpu_ngp_eager["loop"])
    _mark("NGP-only demos, fused and eager")
    # per kind: the whole run's launches, and K1's in Phase B (every one
    # of them scene-batched)
    batch_launches, batch_k1 = {}, {}
    batch_launches["ngp"], batch_k1["ngp"], _ = batched_pair("ngp",
                                                             ngp_stats)
    batch_launches["tpu"], batch_k1["tpu"], _ = batched_pair("tpu",
                                                             tpu_ngp_stats)
    _mark("scene-batched NGP-only demos, graphs and eager")
    launches, diffusion_stats = diffusion_main_path()
    # the eager twins at less depth: 10 and 5 fusion iterations
    _, diffusion_eager = diffusion_main_path(max_itr=30, fused=False)
    _compare_pair("f32 diffusion demo", diffusion_stats["loop"],
                  diffusion_eager["loop"])
    # 30 iterations: 10 fusion iterations where the others run 20, which
    # keeps the whole run within the time it took before the TPU preset's
    # paths were added
    bf16_launches, bf16_stats = diffusion_main_path("bf16_sampler",
                                                    max_itr=30)
    _, bf16_eager = diffusion_main_path("bf16_sampler", max_itr=25,
                                        fused=False)
    _compare_pair("bf16 sampler diffusion demo", bf16_stats["loop"],
                  bf16_eager["loop"])
    tpu_launches, _ = diffusion_main_path("tpu")
    _mark("diffusion demos, fused and eager")
    batch_launches["diffusion"], batch_k1["diffusion"], _ = \
        batched_pair("diffusion", diffusion_stats)
    _mark("scene-batched diffusion demo, graphs and eager")
    vgg, lin = _lpips_state_dicts()
    lpips_card_check(vgg, lin)
    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_lpips_") as d:
        spec = f"{d}/vgg16.pth,{d}/lpips_vgg.pth"
        torch.save(vgg, f"{d}/vgg16.pth")
        torch.save(lin, f"{d}/lpips_vgg.pth")
        lpips_term = lpips_fusion_term_profile(spec)
        # 30 iterations, as the bf16 sampler's run: it keeps the smoke's
        # time with the mesh export, sweep and Perceiver phase added
        lpips_launches, lpips_stats = diffusion_main_path(
            "lpips", max_itr=30, lpips_spec=spec)
    print("LPIPS demo against the f32 demo: fusion it/s "
          f"{lpips_stats['fusion_it_per_s']:.4f} vs "
          f"{diffusion_stats['fusion_it_per_s']:.4f}; LPIPS term "
          f"{lpips_term['device_ms']:.3f} device ms a fusion step")
    _mark("LPIPS demo")
    unet_eval_profile()
    _mark("UNet evaluation profile")
    train_launches, profiles = train_phase()
    from sparsefusion_tpu_torch.distill.loop import (
        DistillConfig,
        tpu_distill_config,
    )

    mesh_launches, mesh_stats = mesh_phase({
        "ngp_16xC2_f32": (DistillConfig().ngp, ngp_params),
        "tpu_8xC4_bf16": (tpu_distill_config().ngp, tpu_ngp_params)})
    _mark("mesh export")
    sweep = sweep_phase()
    _mark("parity sweep")
    perceiver_check()
    _mark("Perceiver resampler")
    print("train step profiles: " + json.dumps({
        p: {**{key: s[key] for key in (
            "device_ms_per_step", "host_ms_per_step", "device_idle_share",
            "bound_ms", "bound_share", "first_step_vs_f32")},
            "graph": {key: s["graph"][key] for key in (
                "device_ms_per_step", "host_ms_per_step",
                "device_idle_share", "syncs_per_step")}}
        for p, s in profiles.items()}))
    paths = {"ngp_demo": {"grid_encode_fwd": ngp_launches["grid_encode_fwd"],
                          "grid_encode_bwd": ngp_launches["grid_encode_bwd"]},
             "diffusion_demo": launches, **train_launches,
             "lpips_diffusion_demo": lpips_launches,
             **{f"scene_batch_{kind}": counts
                for kind, counts in batch_launches.items()},
             "diffusion_demo_bf16_sampler": bf16_launches,
             "tpu_preset_ngp_demo": tpu_ngp_launches,
             "tpu_preset_diffusion_demo": tpu_launches,
             **{f"parity_sweep_{kind}": {
                 k: sum(c[k] for c in out["launches"])
                 for k in out["launches"][0]}
                for kind, out in sweep.items()}}

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
         "bwd_ms_one_point": times["ngp_16xC2_f32_one_point"]["bwd_ms"],
         "identical_points_spread": k1_spread},
        _k2_entry("imagen_attention", k2_src, attn_err, attn_times,
                  by_path("imagen_attention", bf16=False),
                  profiles["float32"]),
        _k2_entry("imagen_attention_bf16", k2_src, bf16_err, bf16_times,
                  by_path("imagen_attention", bf16=True),
                  profiles["bfloat16"], bf16_bodies, bf16_phase_bodies),
        _k3_entry(k3_launches, k3_micro, k3_f32, k3_err,
                  tr["fwd_warp_sectors_per_s"]),
    ]
    st = scene_times["ngp_16xC2_f32"]
    for direction, replaces in (("fwd", "grid_gather.py:79"),
                                ("bwd", "grid_gather.py:133")):
        batched = {f"scene_batch_{kind}": c[f"grid_encode_{direction}"]
                   for kind, c in batch_k1.items()}
        kernels.append({
            "name": f"grid_encode_{direction}_scenes", "route": "cuda",
            "source": src, "replaces": f"sparsefusion_tpu/kernels/{replaces}",
            "scenes": SCENES, "launches": sum(batched.values()),
            "launches_by_path": batched,
            "max_abs_err": max(t[f"{direction}_max_abs_err"]
                               for t in scene_times.values()),
            "ms": st[f"{direction}_ms"],
            f"ms_{SCENES}_single_launches":
                st[f"{direction}_ms_{SCENES}_single_launches"],
            "plain_ms": st[f"{direction}_plain_ms"],
            "bound_ms": st[f"{direction}_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "bf16_8xC4": {key: scene_times["ngp_8xC4_bf16"][
                f"{direction}_{key}"] for key in (
                    "ms", f"ms_{SCENES}_single_launches", "bound_ms")}})
    ms = mesh_stats["ngp_16xC2_f32"]
    mb = mesh_stats["tpu_8xC4_bf16"]
    kernels.append({
        "name": "grid_encode_fwd_mesh", "route": "cuda", "source": src,
        "replaces": "sparsefusion_tpu/kernels/grid_gather.py:79",
        "launches": sum(mesh_launches.values()),
        "launches_by_path": mesh_launches,
        "max_abs_err": max(s_["k1_max_abs_err_chunk"]
                           for s_ in mesh_stats.values()),
        "ms": ms["k1_ms_per_launch"], "plain_ms": ms["k1_plain_ms"],
        "bound_ms": ms["k1_bound_ms"], "bound_by": ms["k1_bound_by"],
        "library_ms": None, "points": MESH_CHUNK,
        "grid_ms_per_launch": ms["k1_grid_ms_per_launch"],
        "bf16_8xC4": {key: mb[f"k1_{key}"] for key in (
            "ms_per_launch", "plain_ms", "bound_ms", "grid_ms_per_launch")}})
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
