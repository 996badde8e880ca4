"""The Zero123 distillation cell's run: ``drivers/distill.py``'s, with the
port's Zero123 bundle (``models.py::build_zero123_models``) as the fusion
prior, its work counted by :mod:`portbench.flops_z123`, and the
reference's Zero123 steps (:mod:`portbench.reference.zero123`) followed.

The scene, input views, draws, window, hook and readings are
``drivers/distill.py``'s: this module takes its helpers and repeats its
``run`` around the three things that differ.  The configuration's model
keys are ``eft``, ``vae``, ``zero123``, ``clip`` and ``ddpm``; the
weights are drawn in that order (EFT, VAE, UNet, CLIP tower,
``cc_projection``) from the run's seed, the EFT's and VAE's as in the
SparseFusion cells.  Each trace unit also records its UNet evaluations
(``unet_evals``: the PLMS chain's, twice under guidance).

    python3 -m portbench.drivers.distill_z123 --workload <name> --seeds 1 2
        [--scopes unet all] [--faults half_batch unchanged]

prints the check's numbers of the control reference (TF32 on in the
UNet, "unet", or everywhere, "all") against the f32 one for each seed,
and, with ``--faults``, of a run of the cell with each fault of
``portbench/faults.py`` planted: the readings the cell's limits were set
from (``PERF.md``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import sys
import time

import torch

from portbench import common, flops, flops_z123, scenes, spec, weights
from portbench.drivers.distill import _plan, _WindowClosed, sampler_output
from portbench.trace import TraceWindow

MODEL_KEYS = ("eft", "vae", "zero123", "clip", "ddpm")


def sizes(config: dict) -> dict:
    """The configuration's model sizes as keyword arguments, lists made
    tuples."""
    return {k: {n: tuple(v) if isinstance(v, list) else v
                for n, v in config[k].items()} for k in MODEL_KEYS}


def build_port_models(config: dict, seed: int, device):
    """The program's Zero123 bundle with the benchmark's weights."""
    from sparsefusion_tpu_torch.diffusion.ddpm import DDPMConfig
    from sparsefusion_tpu_torch.models import build_zero123_models
    from sparsefusion_tpu_torch.nn.eft import EFTConfig
    from sparsefusion_tpu_torch.nn.vae import VAEConfig
    from sparsefusion_tpu_torch.nn.zero123 import CLIPConfig, Zero123Config

    s = sizes(config)
    gen = torch.Generator(device=device).manual_seed(0)
    models = build_zero123_models(
        gen, device, unet_config=Zero123Config(**s["zero123"]),
        clip_config=CLIPConfig(**s["clip"]), vae_config=VAEConfig(**s["vae"]),
        eft_config=EFTConfig(**s["eft"]), ddpm_config=DDPMConfig(**s["ddpm"]))
    for k, m in enumerate((models.eft, models.vae, models.unet, models.clip,
                           models.cc_projection)):
        weights.fill(m, spec.sub_seed(seed, spec.SEED_WEIGHTS, k))
    return models


@functools.lru_cache(maxsize=None)
def _counts(config_json: str) -> tuple:
    """(render operations, render K1 seconds, VAE encode + decode
    operations, one batch-1 Zero123 evaluation's operations)."""
    from portbench.reference.ngp import NGPConfig

    config = json.loads(config_json)
    d, size = config["distill"], config["image_size"]
    enc = NGPConfig(**config["ngp"]).encoding()
    r_ops, r_k1 = flops.render_work(d, config["ngp"], enc, size)
    vae = flops.vae_encode(config["vae"], size) \
        + flops.vae_decode(config["vae"], size)
    unet = flops_z123.unet_fwd(config["zero123"], 1, size // 8)
    return r_ops, r_k1, vae, unet


def iteration_work(config: dict, mt: float, fusion: bool) -> dict:
    """An iteration's model operations, K1's least seconds and UNet
    evaluations: an input step's render, and a bootstrap step's, or a
    fusion step's render, VAE encode, guided sampler and VAE decode."""
    r_ops, r_k1, vae, unet = _counts(json.dumps(config, sort_keys=True))
    d = config["distill"]
    evals = 0
    if fusion:
        evals = flops.plms_evals(mt, d["plms_steps"]) \
            * (1 if d["cond_scale"] == 1.0 else 2)
    ops = 2 * r_ops + (vae + evals * unet if fusion else 0)
    return {"ops": ops, "k1_s": 2 * r_k1, "unet_evals": evals}


def _setup(cell, seed: int, device):
    """The scene, input views and loop config of a run of the cell."""
    from sparsefusion_tpu_torch.distill.loop import DistillConfig
    from sparsefusion_tpu_torch.nn.ngp import NGPConfig

    config, traffic = cell.config, cell.traffic
    n_views, size = config["n_views"], config["image_size"]
    scene = scenes.blob_scene(spec.sub_seed(seed, spec.SEED_SCENE), n_views,
                              size, device)
    input_idx = scenes.input_views(spec.sub_seed(seed, spec.SEED_SCENE, 1),
                                   n_views, config["input_views"])
    d = dict(config["distill"], max_itr=traffic["max_itr"],
             start_fusion_step=traffic["start_fusion_step"])
    d["ngp"] = NGPConfig(**config["ngp"])
    return scene, input_idx, DistillConfig(**d)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float):
    # the Zero123 modules first: a program without them fails at once
    from sparsefusion_tpu_torch.distill.loop import distillation_loop
    from sparsefusion_tpu_torch.models import build_zero123_models  # noqa
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    config, traffic = cell.config, cell.traffic
    set_tf32(False)
    scene, input_idx, cfg = _setup(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks = {"inputs": time.perf_counter()}
    models = build_port_models(config, seed, device)
    common.sync(device)
    marks["models"] = time.perf_counter()
    n_cache = config["n_views"] + cfg.n_aug_cameras
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
    """The Zero123 reference over the loop's first ``follow`` iterations in
    f32 (``tf32``: the control, TF32 on in the UNet alone, "unet", or in
    everything, "all"), read as ``drivers/distill.py``'s."""
    from portbench.reference import sparsefusion as ref_sf
    from portbench.reference import zero123 as ref

    ref_sf.set_tf32(tf32 == "all")
    try:
        fills = iter(spec.sub_seed(seed, spec.SEED_WEIGHTS, k)
                     for k in range(5))
        models = ref.build_models(sizes(config),
                                  lambda m: weights.fill(m, next(fills)),
                                  device)
        models.tf32_unet = tf32 == "unet"
        generator = torch.Generator(device=device).manual_seed(
            spec.sub_seed(seed, spec.SEED_LOOP))
        d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
             if f.name != "ngp"}
        out = ref.follow_distillation(models, scene, input_idx, d,
                                      config["ngp"], generator, follow,
                                      cfg.start_fusion_step, moment_at,
                                      device)
    finally:
        ref_sf.set_tf32(False)
    return common.readings(out, program_end)


def control_readings(workload: str, seed: int, device="cuda",
                     scopes=("unet",), root=None, bench_dir=None) -> dict:
    """{scope: {number: value}} of the control reference (TF32 on in
    ``scope``) against the f32 one, on the cell's inputs of ``seed``."""
    from portbench.run import compare

    cell = spec.find_cell(workload, root or spec.ROOT,
                          bench_dir or spec.HERE)
    device = torch.device(device)
    scene, input_idx, cfg = _setup(cell, seed, device)
    traffic = cell.traffic

    def follow_with(tf32):
        return follow_reference(cell.config, cfg, scene, input_idx, seed,
                                traffic["follow_iterations"],
                                traffic["moment_iteration"], device,
                                tf32=tf32)

    ref = follow_with("")
    return {scope: {k: c["value"] for k, c in
                    compare(follow_with(scope), ref,
                            traffic["limits"]).items()}
            for scope in scopes}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="distill-fusion-z123")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--scopes", nargs="*", default=["unet"],
                   choices=["unet", "all"])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    for seed in args.seeds:
        if args.scopes:
            for scope, r in control_readings(args.workload, seed,
                                             scopes=args.scopes).items():
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "control": f"tf32_{scope}",
                                  "readings": r}), flush=True)
    if args.faults:
        from portbench import faults
        from portbench.run import run_cell

        for name in args.faults:
            for seed in args.seeds:
                r = run_cell(args.workload, seed, args.seconds, False,
                             around_program=faults.planted(name))
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "fault": name, "correct": r["correct"],
                                  "readings": {k: c["value"] for k, c in
                                               r["checks"].items()}}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
