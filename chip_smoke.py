#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only] [--csrc DIR]

1. Prints the card (``nvidia-smi`` name and power limit).
2. Builds the port's CUDA kernels from ``sparsefusion_tpu_torch/csrc``
   (``--csrc DIR``: from another directory of sources with the same C
   entry points) and prints ptxas's registers, shared memory and spills
   per kernel and their SASS opcode counts (HMMA, RED, ATOM, LDG); K2
   must issue HMMA.
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
   (K2) against its plain version at the UNet's shapes (1, 8, 16, 64)
   with 17 and 19 keys and at (2, 8, 1024, 64) with 1027 keys, beside
   one ``scaled_dot_product_attention`` call as its yardstick (the port
   never calls it).  Times are device times by ``torch.profiler``, with
   CUDA-event times beside them; each kernel's bound is computed from the
   bytes and operations of its inputs.  Then the NGP-only demo's input
   step at full width under ``torch.profiler``: device time per step by
   kernel, K1's launches per step and its time per launch on the
   renderer's own points.  ``--kernels-only`` stops here.
4. Card against CPU: one input step on a small input, then one
   bootstrap step and one fusion step (narrow UNet and VAE, 2-step
   PLMS) from the same weights and draws.
5. The NGP-only demo at full width (``DistillConfig()``, ``NGPConfig()``,
   256 px, 100 iterations) through ``sparsefusion_tpu_torch.cli.demo.main``.
6. Main path: the full-width diffusion demo (``UNetConfig()``,
   ``VAEConfig()``, ``EFTConfig()``, 256 px, 40 iterations, fusion after
   iteration 20).  Each demo runs with the kernels' launch counts reset
   just before and read just after; K2 must launch three times per UNet
   evaluation.
7. Prints the kernels' JSON line, then ``{"ok": true, "device": ...}``
   as the last line.

TF32 stays off throughout (the package turns it off at import).

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

N_POINTS = 16384 * 128          # rays x samples of one 128^2 input step
RAY_CHUNK = (4096, 64)          # rays x samples of one launch on the main path
TIMING_ITERS = 10
PROFILE_ITERS = 10
PROFILE_STEPS = 5
# NVIDIA H100 SXM data sheet: memory rate and the f32 peak outside the
# tensor cores (TF32 on the tensor cores: 495e12)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _device_lines():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})")


def _time_ms(fn):
    """Mean milliseconds of fn() over TIMING_ITERS back-to-back runs, by
    CUDA events: at a few microseconds a launch this is the host's
    enqueue rate, not the device's time."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMING_ITERS


def _kernel_ms(prof, n_calls):
    """{kernel name: device ms per call} from a finished torch.profiler
    run over n_calls calls: each kernel's mean duration times its
    launches per call, so a record the profiler drops does not count as
    a call without the kernel."""
    by_name = {}
    for e in prof.key_averages():
        us = max(getattr(e, a, 0) or 0 for a in (
            "self_device_time_total", "device_time_total",
            "self_cuda_time_total", "cuda_time_total"))
        if us > 0 and e.count > 0:
            if e.count % n_calls:
                print(f"  (profiler: {e.count} records of {e.key[:60]} "
                      f"over {n_calls} calls)")
            per_call = max(1, round(e.count / n_calls))
            by_name[e.key] = by_name.get(e.key, 0.0) \
                + us / 1e3 / e.count * per_call
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device time")
    return by_name


def _device_ms(fn):
    """Device time of one fn() call by torch.profiler, over PROFILE_ITERS
    calls after 2 warm ones: {kernel name: ms per call}, summed over the
    call's launches of that kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_ITERS):
            fn()
        torch.cuda.synchronize()
    return _kernel_ms(prof, PROFILE_ITERS)


def _named_ms(by_name, kernel):
    ms = [t for name, t in by_name.items() if kernel in name]
    if not ms:
        raise RuntimeError(f"{kernel} not among the profiled kernels "
                           f"{sorted(by_name)}")
    return sum(ms)


def _bound(n_bytes, f32_ops=0):
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the operations
    at the f32 peak, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
            fwd = _device_ms(lambda: grid_encode_cuda(x01, table, enc))
            bwd = _device_ms(lambda: grid_encode_cuda_backward(
                x01, grad_out, enc, bf16))
            fwd_plain = _device_ms(lambda: grid_encode_plain(
                x01, master, enc, table_dtype))
            times = {
                "fwd_ms": _named_ms(fwd, "grid_encode_fwd_kernel"),
                "fwd_event_ms": _time_ms(
                    lambda: grid_encode_cuda(x01, table, enc)),
                "fwd_plain_ms": sum(fwd_plain.values()),
                "bwd_ms": _named_ms(bwd, "grid_encode_bwd_kernel"),
                "bwd_event_ms": _time_ms(lambda: grid_encode_cuda_backward(
                    x01, grad_out, enc, bf16)),
            }
        times["bwd_plain_ms"] = sum(_device_ms(lambda: torch.autograd.grad(
            out_p, master_p, grad_out, retain_graph=True)).values())
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


def input_step_profile():
    """The NGP-only demo's input step at full width (``DistillConfig()``,
    ``NGPConfig()``, a 256 px synthetic scene, 128^2 renders): 5 warm
    steps, then PROFILE_STEPS steps under torch.profiler.  Reports device
    time per step by kernel, the kernels' launches per step, and the host
    clock per step (each step ends in a loss read)."""
    from torch.profiler import ProfilerActivity, profile

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
    from sparsefusion_tpu_torch.kernels import grid_encode
    from sparsefusion_tpu_torch.nn.ngp import NGPField
    from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig

    cfg = DistillConfig()
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

    def step(i):
        v = i % 2
        return float(steps.input_step(vcfg, get_camera_slice(cams, [v]),
                                      rgb[v], mask[v], gen))

    for i in range(5):
        step(i)
    torch.cuda.synchronize()
    grid_encode.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            step(i)
        host_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    launches = {"grid_encode_fwd": grid_encode.grid_encode_cuda.launches
                / PROFILE_STEPS,
                "grid_encode_bwd": grid_encode.grid_encode_cuda_backward
                .launches / PROFILE_STEPS}
    per_step = _kernel_ms(prof, PROFILE_STEPS)
    device_ms = sum(per_step.values())
    k1 = {"fwd_ms": _named_ms(per_step, "grid_encode_fwd_kernel"),
          "bwd_ms": _named_ms(per_step, "grid_encode_bwd_kernel")}
    stats = {"device_ms_per_step": device_ms, "host_ms_per_step": host_ms,
             "launches_per_step": launches,
             "k1_fwd_ms_per_step": k1["fwd_ms"],
             "k1_bwd_ms_per_step": k1["bwd_ms"],
             "k1_fwd_ms_per_launch": k1["fwd_ms"]
             / launches["grid_encode_fwd"],
             "k1_bwd_ms_per_launch": k1["bwd_ms"]
             / launches["grid_encode_bwd"]}
    print("input step profile (mean of "
          f"{PROFILE_STEPS} steps): " + json.dumps(stats))
    for name, ms in sorted(per_step.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.3f} ms/step ({100 * ms / device_ms:5.1f}%) "
              f"{name[:110]}")
    assert launches["grid_encode_fwd"] > 0 and launches["grid_encode_bwd"] > 0
    return stats


ATTN_SHAPES = [(1, 8, 16, 64, 17), (1, 8, 16, 64, 19),
               (2, 8, 1024, 64, 1027)]
ATTN_TOL = 1e-5


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
        by_name = _device_ms(fn)
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


def attention_phase():
    """K2 against its plain version; returns the largest error and, per
    shape, the kernel's device time, its event time, the plain version's
    and the library's device times, and the bound."""
    from sparsefusion_tpu_torch.kernels.attention import imagen_attention_cuda
    from sparsefusion_tpu_torch.ops.attention import imagen_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    err_max, times = 0.0, {}
    for b, h, n, d, j in ATTN_SHAPES:
        q = torch.randn(b, h, n, d, device="cuda", generator=gen) * d ** -0.5
        k = torch.randn(b, j, d, device="cuda", generator=gen)
        v = torch.randn(b, j, d, device="cuda", generator=gen)
        out_k = imagen_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        out_p = imagen_attention_plain(q, k, v)
        err = (out_k - out_p).abs().max().item()
        name = f"q{(b, h, n, d)}_J{j}".replace(" ", "")
        print(f"kernel imagen_attention {name}:")
        lib_ms, variant, backend, lib_err = _sdpa_yardstick(q, k, v, out_p)
        bound_ms, bound_by = _bound(_nbytes(q, k, v, out_k),
                                    4 * b * h * n * j * d)
        times[name] = {
            "ms": _named_ms(_device_ms(lambda: imagen_attention_cuda(q, k, v)),
                            "imagen_attention_fwd_kernel"),
            "event_ms": _time_ms(lambda: imagen_attention_cuda(q, k, v)),
            "plain_ms": sum(_device_ms(
                lambda: imagen_attention_plain(q, k, v)).values()),
            "plain_event_ms": _time_ms(
                lambda: imagen_attention_plain(q, k, v)),
            "library_ms": lib_ms, "library_variant": variant,
            "library_backend": backend, "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}
        # f32 on both sides; the kernel's 3xTF32 products and online
        # softmax sum in another order than the plain softmax
        print(f"  {json.dumps(times[name])} (tol {ATTN_TOL:.0e})")
        assert torch.isfinite(out_k).all()
        assert err <= ATTN_TOL, f"K2 disagrees at {name}"
        err_max = max(err_max, err)
    try:
        imagen_attention_cuda(q[..., :48].contiguous(), k[..., :48]
                              .contiguous(), v[..., :48].contiguous())
    except ValueError:
        pass
    else:
        raise AssertionError("K2 took an unsupported head dim")
    return err_max, times


def small_diffusion_steps_check():
    """One bootstrap step and one fusion step (narrow UNet and VAE with
    64-wide attention heads, randomised final conv, 2-step PLMS) on the
    card and on the CPU from the same weights and draws."""
    import copy

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
    from sparsefusion_tpu_torch.models import build_models
    from sparsefusion_tpu_torch.nn.ngp import NGPField
    from sparsefusion_tpu_torch.nn.unet import UNetConfig
    from sparsefusion_tpu_torch.nn.vae import VAEConfig
    from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig

    cfg = DistillConfig(max_ray_batch=256, plms_steps=2)
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

    models_cpu = build_models(
        torch.Generator().manual_seed(0), "cpu",
        unet_config=UNetConfig(dim=64, dim_mults=(1, 2),
                               num_resnet_blocks=(1, 1),
                               layer_attns=(False, True), attn_heads=2,
                               attn_dim_head=64),
        vae_config=VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1))
    with torch.no_grad():   # a zero final conv would hide the UNet
        fc = models_cpu.unet.final_conv
        fc.weight.copy_(torch.as_tensor(
            rng.randn(*fc.weight.shape) * 0.05, dtype=torch.float32))
        fc.bias.copy_(torch.as_tensor(rng.randn(*fc.bias.shape) * 0.05,
                                      dtype=torch.float32))
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
        res = {}
        for name, losses_fn, extra in (
                ("bootstrap", steps.bootstrap_losses, (eft_img.to(dev),)),
                ("fusion", steps.fusion_losses, (features.to(dev), mt))):
            field.zero_grad()
            loss = losses_fn(vcfg, cam, *extra,
                             draws=dict(draws, plms_noise=plms_noise))
            loss.backward()
            res[name] = (loss.item(), {n: p.grad.cpu().clone()
                                       for n, p in field.named_parameters()})
        out.append((res, models.unet_evals))
    (cpu, evals_cpu), (gpu, evals_gpu) = out
    assert evals_cpu == evals_gpu == 3, (evals_cpu, evals_gpu)
    for name in ("bootstrap", "fusion"):
        l_cpu, g_cpu = cpu[name]
        l_gpu, g_gpu = gpu[name]
        print(f"{name} step cpu vs cuda: loss {l_cpu:.7f} vs {l_gpu:.7f}")
        # f32 on both sides; the renderer's draws are shared, its sums
        # are not ordered alike (see the input step)
        assert abs(l_cpu - l_gpu) <= 1e-4 * abs(l_cpu), name
        for pname, gc in g_cpu.items():
            rel = ((gc - g_gpu[pname]).norm() / gc.norm()).item()
            print(f"  grad {pname}: relative (Frobenius) err {rel:.3e}")
            assert rel <= 5e-2, f"{name}: gradient of {pname} disagrees"


def diffusion_main_path():
    """The full-width diffusion demo, 40 iterations, fusion after 20."""
    from sparsefusion_tpu_torch.cli.demo import main as demo_main
    from sparsefusion_tpu_torch.kernels import attention, grid_encode

    with tempfile.TemporaryDirectory(prefix="sf_chip_smoke_") as exp_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grid_encode.reset_launches()
        attention.reset_launches()
        t0 = time.perf_counter()
        results = demo_main([
            "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
            "--image_size", "256", "--max_itr", "40", "--start_fusion", "20",
            "--device", "cuda", "--exp_dir", exp_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {
            "grid_encode_fwd": grid_encode.grid_encode_cuda.launches,
            "grid_encode_bwd": grid_encode.grid_encode_cuda_backward.launches,
            "imagen_attention": attention.imagen_attention_cuda.launches}
        peak = torch.cuda.max_memory_allocated()
        written = {p: os.path.exists(os.path.join(exp_dir, p)) for p in (
            "metrics/any_000_c2.txt", "any_000_c2_ngp.npz",
            "render_gifs/any_000_c2.gif")}

    r = results[0]
    t = np.asarray(r["iter_times"])
    boot_its = 20 / (t[20] - t[0])          # iterations 1..20
    fusion_s = t[39] - t[20]                # iterations 21..39
    stats = {"phase_a_s": r["cache_seconds"], "bootstrap_it_per_s": boot_its,
             "fusion_it_per_s": 19 / fusion_s,
             "unet_evals": r["unet_evals"],
             "unet_evals_per_s": r["unet_evals"] / fusion_s,
             "peak_gib": peak / 2 ** 30, "wall_s": wall,
             "psnr": r["metrics"]["psnr"], "ssim": r["metrics"]["ssim"]}
    print("diffusion main path: " + json.dumps(stats))
    print(f"diffusion main path: launches {json.dumps(launches)}; "
          f"files {json.dumps(written)}")
    losses = np.asarray(r["losses"])
    fl = np.asarray(r["fusion_losses"])
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert len(fl) == 40 and np.isfinite(fl).all()
    assert written["metrics/any_000_c2.txt"] and written["any_000_c2_ngp.npz"]
    assert r["renders"].shape == (10, 256, 256, 3)
    assert np.isfinite(r["renders"]).all()
    assert launches["grid_encode_fwd"] > 0 and launches["grid_encode_bwd"] > 0
    assert r["unet_evals"] > 0
    assert launches["imagen_attention"] == 3 * r["unet_evals"], launches
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

    if args.csrc is not None:
        _build.CSRC = pathlib.Path(args.csrc).resolve()
    _device_lines()
    build_s = _build.timed_build()
    print(f"build: {build_s:.2f} s ({_build.library_path().name} from "
          f"{_build.CSRC})")
    print("ptxas -v:\n" + _build.resource_report())
    sass = _build.sass_counts()
    print("sass opcode counts: " + json.dumps(sass))

    errs, times = kernel_phase()
    attn_err, attn_times = attention_phase()
    step_stats = input_step_profile()
    if args.kernels_only:
        print(json.dumps({"kernel_times": times, "attention": attn_times,
                          "input_step": step_stats}))
        return 0
    assert any(c["HMMA"] > 0 for f, c in sass.items()
               if "imagen_attention" in f), "K2 issues no HMMA"
    small_input_step_check()
    small_diffusion_steps_check()
    main_path()
    launches, _ = diffusion_main_path()

    t = times["ngp_16xC2_f32"]
    tr = times["ngp_16xC2_f32_rays"]
    tu = times["ngp_16xC2_f32_uniform_chunk"]
    # K2 at the UNet's down_3/up_0 shape (19 keys)
    ta = attn_times["q(1,8,16,64)_J19"]
    src = "sparsefusion_tpu_torch/csrc/grid_encode.cu"
    kernels = [
        {"name": "grid_encode_fwd", "route": "cuda", "source": src,
         "replaces": "sparsefusion_tpu/kernels/grid_gather.py:79",
         "launches": launches["grid_encode_fwd"],
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
         "launches": launches["grid_encode_bwd"],
         "max_abs_err": errs["bwd"], "ms": t["bwd_ms"],
         "event_ms": t["bwd_event_ms"], "plain_ms": t["bwd_plain_ms"],
         "bound_ms": t["bwd_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "bwd_ms_ray_points": tr["bwd_ms"],
         "bound_ms_ray_points": tr["bwd_bound_ms"],
         "bwd_ms_one_point": times["ngp_16xC2_f32_one_point"]["bwd_ms"]},
        {"name": "imagen_attention", "route": "cuda",
         "source": "sparsefusion_tpu_torch/csrc/imagen_attention.cu",
         "replaces": "sparsefusion_tpu/kernels/attention.py:70",
         "launches": launches["imagen_attention"],
         "max_abs_err": attn_err, "ms": ta["ms"],
         "event_ms": ta["event_ms"], "plain_ms": ta["plain_ms"],
         "bound_ms": ta["bound_ms"], "bound_by": ta["bound_by"],
         "library_ms": ta["library_ms"],
         "library_backend": ta["library_backend"],
         "shapes": {name: {key: s[key] for key in (
             "ms", "plain_ms", "library_ms", "bound_ms")}
             for name, s in attn_times.items()}},
    ]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
