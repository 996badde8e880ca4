#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit).
2. Builds the port's CUDA kernels from ``sparsefusion_tpu_torch/csrc``.
3. Kernel phase: the fused grid-encode kernel (K1), forward and table
   gradient, against its plain PyTorch version on the same inputs, at
   ``NGPConfig()`` width (16 levels x C2, f32, 2,097,152 points), at
   8 x C4 with a bf16 table, and on a small hash grid; the imagen
   attention kernel (K2) against its plain version at the UNet's shapes
   (1, 8, 16, 64) with 17 and 19 keys and at (2, 8, 1024, 64) with 1027
   keys; times both with CUDA events.
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


ATTN_SHAPES = [(1, 8, 16, 64, 17), (1, 8, 16, 64, 19),
               (2, 8, 1024, 64, 1027)]
ATTN_TOL = 1e-5


def attention_phase():
    """K2 against its plain version; returns the largest error and the
    times (kernel, plain) per shape."""
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
        times[name] = {
            "ms": _time_ms(lambda: imagen_attention_cuda(q, k, v)),
            "plain_ms": _time_ms(lambda: imagen_attention_plain(q, k, v))}
        # f32 on both sides; the kernel's online softmax sums in another
        # order than the plain softmax
        print(f"kernel imagen_attention {name}: max_abs_err {err:.3e} "
              f"(tol {ATTN_TOL:.0e}); ms {times[name]['ms']:.4f} vs plain "
              f"{times[name]['plain_ms']:.4f}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sparsefusion_tpu_torch.kernels import _build

    _device_lines()
    build_s = _build.timed_build()
    print(f"build: {build_s:.2f} s ({_build.library_path().name})")

    errs, times = kernel_phase()
    attn_err, attn_times = attention_phase()
    small_input_step_check()
    small_diffusion_steps_check()
    main_path()
    launches, _ = diffusion_main_path()

    t = times["ngp_16xC2_f32"]
    # K2 at the UNet's down_3/up_0 shape (19 keys)
    ta = attn_times["q(1,8,16,64)_J19"]
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
        {"name": "imagen_attention", "route": "cuda",
         "source": "sparsefusion_tpu_torch/csrc/imagen_attention.cu",
         "replaces": "sparsefusion_tpu/kernels/attention.py:70",
         "launches": launches["imagen_attention"],
         "max_abs_err": attn_err, "ms": ta["ms"],
         "plain_ms": ta["plain_ms"]},
    ]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
