"""The distillation cells' run: one scene through the port's
``distill/loop.py::distillation_loop``, as ``cli/demo.py`` calls it.

Set-up: the scene and its input views from the seed, the models through
``models.build_models`` with the benchmark's seeded weights, and the
loop's first ``setup_iterations`` iterations, which build the Phase A
cache and warm up (and, as graphs, capture) every program the traffic's
iterations replay.  The reference follows those first iterations.  The
window opens with a synchronise at the end of the last of them and
closes with another after ``spec.window_units`` iterations, a count the
traffic fixes for ``--seconds`` whatever the clock says, so that every
run of a cell, of any version of the program, times the same iterations
and the same noise levels; the run then leaves the loop by an exception
of its own.  Every iteration enqueued in between counts.

The loop's own state (its field, optimizer and device loss log) is read
from the frame that calls ``iteration_hook``, the loop's measurement
hook; where the traffic's limits name ``target_gap``, so is the
sampler's output of each followed fusion iteration (the final PLMS
latent in the fused programs' buffer, clipped as the fusion step clips
it).  The noise levels, cached cameras and input views of each
iteration are the benchmark's own copy of the loop's ``RandomState(17)``
draws.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import sys
import time

import numpy as np
import torch

from portbench import common, flops, scenes, spec
from portbench.fp8 import fp8_unet
from portbench.trace import TraceWindow


class _WindowClosed(Exception):
    pass


def _plan(n: int, input_idx, n_cache: int):
    """The loop's host draws, in its order: (input view, cached camera,
    noise level) an iteration."""
    rng = np.random.RandomState(17)
    out = []
    for _ in range(n):
        bi = input_idx[rng.randint(len(input_idx))]
        ci = int(rng.randint(n_cache))
        mt = min(float(rng.uniform()), 0.99)
        out.append((bi, ci, mt))
    return out


@functools.lru_cache(maxsize=None)
def _counts(config_json: str) -> tuple:
    """(render operations, render K1 seconds, VAE encode + decode
    operations, one batch-1 UNet evaluation's operations)."""
    from portbench.reference.ngp import NGPConfig

    config = json.loads(config_json)
    d, size = config["distill"], config["image_size"]
    enc = NGPConfig(**config["ngp"]).encoding()
    r_ops, r_k1 = flops.render_work(d, config["ngp"], enc, size)
    vae = flops.vae_encode(config["vae"], size) \
        + flops.vae_decode(config["vae"], size)
    unet = flops.unet_fwd(spec.program_sizes(config)["unet"], 1, size // 8)
    return r_ops, r_k1, vae, unet


def iteration_work(config: dict, mt: float, fusion: bool) -> dict:
    """Model operations and K1's least seconds of one iteration: an input
    step's render, and a bootstrap step's, or a fusion step's render, VAE
    encode, sampler and VAE decode."""
    r_ops, r_k1, vae, unet = _counts(json.dumps(config, sort_keys=True))
    ops = 2 * r_ops
    if fusion:
        ops += vae + flops.plms_evals(
            mt, config["distill"]["plms_steps"]) * unet
    return {"ops": ops, "k1_s": 2 * r_k1}


def sampler_output(programs, ddpm: dict) -> torch.Tensor:
    """The fused programs' final PLMS latent of the iteration just run,
    clipped as the fusion step clips it, in f64 on the host."""
    if programs is None:
        raise RuntimeError("the sampler's output is read from the fused "
                           "programs: run with DistillConfig.fused_steps")
    x = programs.buffers["x"]
    if ddpm["clip_output"]:
        x = x.clamp(-ddpm["clip_value"], ddpm["clip_value"])
    return x.detach().to("cpu", torch.float64, copy=True)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float):
    from sparsefusion_tpu_torch.distill.loop import (
        DistillConfig,
        distillation_loop,
    )
    from sparsefusion_tpu_torch.nn.ngp import NGPConfig
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    config, traffic = cell.config, cell.traffic
    set_tf32(False)
    n_views, size = config["n_views"], config["image_size"]
    scene = scenes.blob_scene(spec.sub_seed(seed, spec.SEED_SCENE), n_views,
                              size, device)
    input_idx = scenes.input_views(spec.sub_seed(seed, spec.SEED_SCENE, 1),
                                   n_views, config["input_views"])
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks = {"inputs": time.perf_counter()}
    models = common.build_port_models(config, seed, device)
    common.sync(device)
    marks["models"] = time.perf_counter()
    d = dict(config["distill"], max_itr=traffic["max_itr"],
             start_fusion_step=traffic["start_fusion_step"])
    d["ngp"] = NGPConfig(**config["ngp"])
    cfg = DistillConfig(**d)
    n_cache = n_views + cfg.n_aug_cameras
    plan = _plan(cfg.max_itr, input_idx, n_cache)
    n_setup = traffic["setup_iterations"]
    follow = traffic["follow_iterations"]
    moment_at = traffic["moment_iteration"]
    if not moment_at < follow <= n_setup:
        raise ValueError("the followed iterations must lie in set-up")
    n_window = spec.window_units(traffic, seconds, trace)
    if n_setup + n_window > cfg.max_itr:
        raise ValueError("the traffic's max_itr is shorter than the window")
    tw = TraceWindow(traffic["trace_skip"], traffic["trace_warm"],
                     traffic["trace_units"])
    if trace:
        # the operation counts run on the host: count before the window
        iteration_work(config, 0.99, True)
    st = {"losses": None, "moment": None, "end": None, "targets": []}
    targets = "target_gap" in traffic["limits"]

    def hook(itr: int) -> None:
        loc = sys._getframe(1).f_locals
        if itr == 0:
            common.sync(device)
            marks["first_iteration"] = time.perf_counter()
        if targets and cfg.start_fusion_step < itr < follow:
            st["targets"].append(sampler_output(loc["programs"],
                                                config["ddpm"]))
        if itr == moment_at:
            adam = loc["optimizer"].adam
            st["moment"] = {n: float(adam.state[p]["exp_avg"].double().norm())
                            for n, p in loc["field"].named_parameters()
                            if p in adam.state}
        if itr == follow - 1:
            log = loc["loss_log"]
            st["losses"] = log[:, :follow].t().reshape(-1).tolist()
            st["end"] = {n: p.detach().to("cpu", copy=True)
                         for n, p in loc["field"].named_parameters()}
        if itr == n_setup - 1:
            common.sync(device)
            st["w0"], st["t_w0"] = itr + 1, time.perf_counter()
            return
        if itr < n_setup:
            return
        if trace:
            tw.step(iteration_work(config, plan[itr][2],
                                   itr > cfg.start_fusion_step))
        if itr == n_setup + n_window - 1:
            common.sync(device)
            st["t_end"], st["last"] = time.perf_counter(), itr
            st["log"] = loc["loss_log"]
            raise _WindowClosed

    generator = torch.Generator(device=device).manual_seed(
        spec.sub_seed(seed, spec.SEED_LOOP))
    marks["loop"] = time.perf_counter()
    try:
        distillation_loop(models, common.port_scene(scene), input_idx, cfg,
                          generator, save_dir=None, use_diffusion=True,
                          verbose=False, iteration_hook=hook)
        raise RuntimeError("the loop ended before the window closed")
    except _WindowClosed:
        pass
    w0, last = st["w0"], st["last"]
    n = last - w0 + 1
    window = st["log"][:, w0:last + 1].tolist()
    failed = sum(not all(map(math.isfinite, col)) for col in zip(*window))
    peak = torch.cuda.max_memory_reserved() if device.type == "cuda" else 0
    metrics = {"distill_it_per_s": n / (st["t_end"] - st["t_w0"]),
               "setup_s": st["t_w0"] - t0, "peak_gib": peak / 2 ** 30}
    marks["window"] = st["t_w0"]
    program = {"losses": st["losses"], "moment": st["moment"],
               "targets": st["targets"], "attempted": n, "failed": failed}
    end = st["end"]
    trace_out = tw.trace
    del models, st, generator, tw

    def reference() -> dict:
        return follow_reference(config, cfg, scene, input_idx, seed,
                                follow, moment_at, device, end)

    return {"metrics": metrics, "trace": trace_out, "program": program,
            "reference": reference, "setup_marks": common.marks(marks, t0)}


def follow_reference(config, cfg, scene, input_idx, seed, follow,
                     moment_at, device, program_end=None,
                     tf32: str = "") -> dict:
    """The reference over the loop's first ``follow`` iterations, in f32
    (``tf32``: the control, with TF32 on in everything, "all", or in the
    UNet and VAE alone, "diffusion"; or "fp8_unet", the UNet's
    convolutions and linears on fp8-rounded weights and inputs,
    ``portbench/fp8.py``); the first moment after iteration
    ``moment_at``; with ``program_end``, also the program's change of
    each leaf from the reference's start."""
    from portbench.reference import sparsefusion as ref

    ref.set_tf32(tf32 == "all")
    try:
        models = common.reference_models(config, seed, device,
                                         tf32 == "diffusion")
        if tf32 == "fp8_unet":
            fp8_unet(models.unet)
        generator = torch.Generator(device=device).manual_seed(
            spec.sub_seed(seed, spec.SEED_LOOP))
        d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
             if f.name != "ngp"}
        out = ref.follow_distillation(models, scene, input_idx, d,
                                      config["ngp"], generator, follow,
                                      cfg.start_fusion_step, moment_at,
                                      device)
    finally:
        ref.set_tf32(False)
    return common.readings(out, program_end)
