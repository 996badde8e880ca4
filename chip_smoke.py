#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit).
2. Builds the port's CUDA kernels from ``sparsefusion_tpu_torch/csrc``.
3. Kernel phase: the fused grid-encode kernel, forward and table
   gradient, against its plain PyTorch version on the same inputs, at
   ``NGPConfig()`` width (16 levels x C2, f32, 2,097,152 points), at
   8 x C4 with a bf16 table, and on a small hash grid; times both with
   CUDA events.
4. Main path: the NGP-only demo at full width (``DistillConfig()``,
   ``NGPConfig()``, 256 px, 100 iterations) through
   ``sparsefusion_tpu_torch.cli.demo.main``, with the kernels' launch
   counts reset just before and read just after.  Before it, one input
   step on a small input is held against the same step on the CPU.
5. Prints the kernels' JSON line, then ``{"ok": true, "device": ...}``
   as the last line.

Every check asserts or raises; the script exits non-zero without a
result when there is no CUDA device or the port is not importable.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_POINTS = 16384 * 128          # rays x samples of one 128^2 input step
TIMING_ITERS = 10


def _device_lines():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})")


def _time_ms(fn):
    """Mean milliseconds of fn() over TIMING_ITERS runs, by CUDA events."""
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


def _kernel_case(name, enc, table_dtype, n_points, gen, timed):
    from sparsefusion_tpu_torch.kernels.grid_encode import (
        grid_encode_cuda,
        grid_encode_cuda_backward,
    )
    from sparsefusion_tpu_torch.ops.grid_encode import grid_encode_plain

    dev = "cuda"
    # a few points leave the unit box, as clipped render points can
    x01 = torch.rand(n_points, 3, device=dev, generator=gen) * 1.02 - 0.01
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
            times = {
                "fwd_ms": _time_ms(lambda: grid_encode_cuda(x01, table, enc)),
                "fwd_plain_ms": _time_ms(
                    lambda: grid_encode_plain(x01, master, enc,
                                              table_dtype)),
                "bwd_ms": _time_ms(lambda: grid_encode_cuda_backward(
                    x01, grad_out, enc, bf16)),
            }
        times["bwd_plain_ms"] = _time_ms(lambda: torch.autograd.grad(
            out_p, master_p, grad_out, retain_graph=True))
        print(f"kernel {name} times (ms, mean of {TIMING_ITERS}): "
              + json.dumps(times))
    del out_p
    torch.cuda.synchronize()
    return fwd_err, bwd_err, times


def kernel_phase():
    from sparsefusion_tpu_torch.nn.ngp import NGPConfig
    from sparsefusion_tpu_torch.ops.grid_encode import make_grid_encoding

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("ngp_16xC2_f32", NGPConfig().encoding(), None, N_POINTS, True),
        ("ngp_8xC4_bf16", NGPConfig(num_levels=8, level_dim=4).encoding(),
         "bfloat16", N_POINTS, True),
        ("hash_8xC2_f32", make_grid_encoding(
            num_levels=8, level_dim=2, base_resolution=16,
            log2_hashmap_size=14, gridtype="hash"), None, 1 << 18, False),
    ]
    errs = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for name, enc, td, n, timed in cases:
        f, b, t = _kernel_case(name, enc, td, n, gen, timed)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sparsefusion_tpu_torch.kernels import _build

    _device_lines()
    build_s = _build.timed_build()
    print(f"build: {build_s:.2f} s ({_build.library_path().name})")

    errs, times = kernel_phase()
    small_input_step_check()
    launches, _ = main_path()

    t = times["ngp_16xC2_f32"]
    src = "sparsefusion_tpu_torch/csrc/grid_encode.cu"
    kernels = [
        {"name": "grid_encode_fwd", "route": "cuda", "source": src,
         "replaces": "sparsefusion_tpu/kernels/grid_gather.py:79",
         "launches": launches["grid_encode_fwd"],
         "max_abs_err": errs["fwd"], "ms": t["fwd_ms"],
         "plain_ms": t["fwd_plain_ms"]},
        {"name": "grid_encode_bwd", "route": "cuda", "source": src,
         "replaces": "sparsefusion_tpu/kernels/grid_gather.py:133",
         "launches": launches["grid_encode_bwd"],
         "max_abs_err": errs["bwd"], "ms": t["bwd_ms"],
         "plain_ms": t["bwd_plain_ms"]},
    ]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
