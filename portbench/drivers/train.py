"""The training cells' run: the objects ``cli/train.py::main``
builds, ``train/fused.py::FusedTrainStep`` over
``train/trainer.py::TrainStep``, with its ``LossRing`` read every
``read_every`` steps.

Set-up: the traffic's scenes from the seed, the models through
``models.build_models`` with the benchmark's seeded weights, the
optimizers and the step, and the first ``setup_steps`` steps: each
context size twice in a row (its eager first run, then its capture and
first replay), in the traffic's order.  The reference follows
the first ``follow_steps`` of them: all of set-up, so that every
context size's eager step and graph are compared.  The window opens with
a synchronise after set-up and closes with another after
``spec.window_units`` steps, whole blocks of the context sizes, a count
the traffic fixes for ``--seconds`` whatever the clock says; every step
enqueued in between counts.

Each step's scene, query view, context size and context views come from
the traffic's generator: the context sizes in blocks that each hold
every size once, in an order drawn from the seed, so every seed gives a
window the same mix of sizes.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import common, flops, scenes, spec
from portbench.trace import TraceWindow


def plan_steps(traffic: dict, seed: int, n_steps: int, n_views: int):
    """(scene, query, context views) a step: set-up's pairs of each
    size in the traffic's order (a fixed order, so that the graphs'
    memory pools, and the peak, are the same for every seed), then
    blocks of every size once, in orders drawn from the seed.  Drawn step
    by step, so that a shorter plan is the start of a longer one."""
    rng = np.random.RandomState(spec.sub_seed(seed, spec.SEED_TRAFFIC))
    sizes = list(traffic["context_sizes"])
    seq = [s for s in sizes for _ in range(2)]
    out = []
    while len(out) < n_steps:
        if len(out) == len(seq):
            seq += [sizes[i] for i in rng.permutation(len(sizes))]
        cs = seq[len(out)]
        s = int(rng.randint(traffic["scenes"]))
        q = int(rng.randint(n_views))
        pool = [v for v in rng.permutation(n_views).tolist() if v != q]
        out.append((s, q, pool[:cs]))
    return out


def step_work(config: dict, n_context: int) -> dict:
    """Model operations of one step with ``n_context`` views: the UNet's
    forward and backward at the diffusion batch, the EFT's at the step's
    context size, the VAE encode."""
    t = config["train"]
    sizes = spec.program_sizes(config)
    hw = t["latent_size"]
    return {"ops": flops.unet_fwd_bwd(sizes["unet"],
                                      t["diffusion_batch_size"], hw)
            + flops.eft_fwd_bwd(config["eft"], config["image_size"],
                                n_context, hw * hw, t["eft_n_pts"])
            + flops.vae_encode(config["vae"], config["image_size"])}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float):
    from sparsefusion_tpu_torch.train.fused import FusedTrainStep, LossRing
    from sparsefusion_tpu_torch.train.trainer import (
        TrainConfig,
        make_optimizers,
        make_train_step,
        prepare_scene_batch,
    )
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    config, traffic = cell.config, cell.traffic
    set_tf32(False)
    n_views, size = config["n_views"], config["image_size"]
    data = [scenes.blob_scene(spec.sub_seed(seed, spec.SEED_SCENE, k),
                              n_views, size, device)
            for k in range(traffic["scenes"])]
    port = [common.port_scene(s) for s in data]
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks = {"inputs": time.perf_counter()}
    models = common.build_port_models(config, seed, device)
    common.sync(device)
    marks["models"] = time.perf_counter()
    cfg = TrainConfig(**config["train"])
    unet_opt, eft_opt = make_optimizers(cfg, models)
    opts = [o for o in (unet_opt, eft_opt) if o is not None]
    step_fn = make_train_step(models, cfg, unet_opt, eft_opt)
    generator = torch.Generator(device=device).manual_seed(
        spec.sub_seed(seed, spec.SEED_LOOP))
    fused = FusedTrainStep(step_fn, generator)
    ring = LossRing(3, device)
    n_setup = traffic["setup_steps"]
    follow = traffic["follow_steps"]
    if follow > n_setup:
        raise ValueError("the followed steps must lie in set-up")
    n_window = spec.window_units(traffic, seconds, trace,
                                 len(traffic["context_sizes"]))
    plan = plan_steps(traffic, seed, n_setup + n_window, n_views)
    named = {f"unet.{n}": p for n, p in models.unet.named_parameters()}
    if cfg.train_eft:
        named.update({f"eft.{n}": p
                      for n, p in models.eft.named_parameters()})

    def one(k: int) -> torch.Tensor:
        s, q, ctx = plan[k]
        losses = fused(prepare_scene_batch([port[s]], [q], [ctx]))
        ring.push(losses)
        return losses

    prog_losses, moment, end = [], None, None
    for k in range(n_setup):
        losses = one(k)
        if k < follow:
            prog_losses.append(float(losses[0]))
        if k == 0:
            marks["first_step"] = time.perf_counter()
            moment = {}
            for opt in opts:
                for p in opt.params:
                    if p in opt.adam.state:
                        n = next(n for n, q in named.items() if q is p)
                        moment[n] = float(
                            opt.adam.state[p]["exp_avg"].double().norm())
        if k == follow - 1:
            end = {n: p.detach().to("cpu", copy=True)
                   for n, p in named.items()}
    ring.read()
    skipped0 = sum(int(o.skipped) for o in opts)
    common.sync(device)
    t_w0 = time.perf_counter()
    tw = TraceWindow(traffic["trace_skip"], traffic["trace_warm"],
                     traffic["trace_units"])
    if trace:
        # the operation counts run on the host: count before the window
        for cs in traffic["context_sizes"]:
            step_work(config, cs)
        common.sync(device)
        t_w0 = time.perf_counter()
    window_losses = []
    for k in range(n_setup, n_setup + n_window):
        one(k)
        if trace:
            tw.step(step_work(config, len(plan[k][2])))
        if (k + 1 - n_setup) % traffic["read_every"] == 0:
            window_losses += ring.read()
    common.sync(device)
    t_end = time.perf_counter()
    if ring.n:
        window_losses += ring.read()
    n = n_window
    skipped = sum(int(o.skipped) for o in opts) - skipped0
    failed = sum(not all(map(math.isfinite, row)) for row in window_losses)
    peak = torch.cuda.max_memory_reserved() if device.type == "cuda" else 0
    metrics = {"train_steps_per_s": n / (t_end - t_w0),
               "setup_s": t_w0 - t0, "peak_gib": peak / 2 ** 30}
    marks["window"] = t_w0
    program = {"losses": prog_losses, "moment": moment, "attempted": n,
               "failed": max(failed, skipped)}
    trace_out = tw.trace
    del models, fused, step_fn, unet_opt, eft_opt, opts, named, ring, tw

    def reference() -> dict:
        return follow_reference(config, data, plan[:follow], seed, device,
                                end)

    return {"metrics": metrics, "trace": trace_out, "program": program,
            "reference": reference, "setup_marks": common.marks(marks, t0)}


def follow_reference(config, data, plan, seed, device, program_end=None,
                     tf32: str = "") -> dict:
    """The reference over the steps of ``plan``, in f32 (``tf32``: the
    control, TF32 on in everything, "all", or in the UNet and VAE
    forwards alone, "diffusion")."""
    from portbench.reference import sparsefusion as ref

    ref.set_tf32(tf32 == "all")
    try:
        models = common.reference_models(config, seed, device,
                                         tf32 == "diffusion")
        generator = torch.Generator(device=device).manual_seed(
            spec.sub_seed(seed, spec.SEED_LOOP))
        out = ref.follow_training(models, config["train"], data, plan,
                                  generator, device)
    finally:
        ref.set_tf32(False)
    return common.readings(out, program_end)
