"""Training entry point.

Counterpart of ``sparsefusion_tpu/cli/train.py``, with the same flags
plus ``--device`` (default ``cuda``):

    python -m sparsefusion_tpu_torch.cli.train -c hydrant -d synthetic

Each step takes one scene in each process (one process per device; with
``SF_COORDINATOR`` / ``SF_NUM_PROCESSES`` / ``SF_PROCESS_ID`` set, several
processes train data-parallel through ``torch.distributed``).  The host
draws scenes, queries and contexts from ``np.random.RandomState(rank)`` as
the JAX CLI does; the step's own draws come from a ``torch.Generator``
seeded ``1234 + rank``.  Rank 0 logs every 50 steps, writes a
visualization grid every ``--vis_itr`` steps and the checkpoint
``ckpt_latest`` every ``--save_itr`` steps and at the end; ``--resume``
continues from one, random states included.  On a CUDA device each step
is one captured program, replayed (``train/fused.py``: a CUDA graph for
each context size), as the JAX CLI's step is one jitted program; it
stays the eager step on the CPU, under ``--debug_nans`` (anomaly mode
cannot be captured) and under DDP over more than one process.  The
losses stay on the device and are read, with the guard's count, every
50 steps, at each checkpoint and at the end, as the JAX CLI reads
them.  ``--bf16`` runs the UNet in
bf16 on f32 master parameters (``TrainConfig.compute_dtype``); the
visualization samples with the f32 UNet, as the JAX CLI's.  f32 matmuls
and convolutions run in full f32 (TF32 off, ``utils/precision.py``).
With ``--device cuda`` and no CUDA device the CLI raises; it never
continues on the CPU.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--category", type=str, required=True)
    p.add_argument("-r", "--root", type=str, default="data/co3d")
    p.add_argument("-d", "--dataset_name", type=str, default="co3d",
                   choices=["co3d", "co3d_toy", "synthetic"])
    p.add_argument("-e", "--exp_name", type=str, default="sf")
    p.add_argument("-b", "--backend", type=str, default="xla",
                   help="kept for reference-CLI compatibility")
    p.add_argument("--steps", type=int, default=50000)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--context_size", type=int, default=0,
                   help="fixed context size; 0 (default) draws 2-5 per step "
                        "like the reference")
    p.add_argument("--diffusion_batch_size", type=int, default=12)
    p.add_argument("--train_eft", action="store_true", default=True)
    p.add_argument("--no_train_eft", dest="train_eft", action="store_false")
    p.add_argument("--vae", type=str, default="-DNE")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--save_itr", type=int, default=1000)
    p.add_argument("--vis_itr", type=int, default=100)
    p.add_argument("--exp_dir", type=str, default="output/train/")
    p.add_argument("--preset", type=str, default="sf",
                   choices=["sf", "tiny"],
                   help="'tiny' swaps in small model configs (smoke tests)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 UNet activations in the train step "
                        "(params, optimizer state and loss stay f32)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: raise at the "
                        "backward op that produced a NaN")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the training runs on (cuda or cpu)")
    args = p.parse_args(argv)
    args.vae_ckpt = None if args.vae == "-DNE" else args.vae
    return args


def build_trio(args, device: torch.device):
    """The EFT / VAE / UNet bundle from seed 0: full width, or the JAX
    CLI's tiny configurations with ``--preset tiny``."""
    from sparsefusion_tpu_torch.diffusion.ddpm import DDPMConfig
    from sparsefusion_tpu_torch.models import build_models
    from sparsefusion_tpu_torch.nn.unet import UNetConfig
    from sparsefusion_tpu_torch.nn.vae import VAEConfig

    configs = {}
    if args.preset == "tiny":
        configs = dict(
            unet_config=UNetConfig(
                dim=32, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
                layer_attns=(False, True), layer_cross_attns=(False, False),
                cond_images_channels=256, attn_heads=2, attn_dim_head=8),
            vae_config=VAEConfig(ch=32, ch_mult=(1, 1, 2, 2),
                                 num_res_blocks=1),
            ddpm_config=DDPMConfig(channels=4,
                                   image_size=args.image_size // 8,
                                   timesteps=100))
    generator = torch.Generator(device=device).manual_seed(0)
    return build_models(generator, device, **configs)


def _rng_states(host, generator, world: int):
    """Every process's (host, torch) random states, gathered to all."""
    state = {"host": host.get_state(), "torch": generator.get_state()}
    if world == 1:
        return [state]
    states = [None] * world
    torch.distributed.all_gather_object(states, state)
    return states


def _visualize(models, scene, query: int, ctx, cfg, path: str, step: int,
               device) -> None:
    from sparsefusion_tpu_torch.core.cameras import (
        get_camera_slice,
        get_relative_cameras,
    )
    from sparsefusion_tpu_torch.train.trainer import (
        scene_depth_range_from_cam,
    )
    from sparsefusion_tpu_torch.train.visualize import save_visualization

    rel = get_relative_cameras(scene.cameras(), [query])
    near, far = scene_depth_range_from_cam(rel)
    save_visualization(
        models, get_camera_slice(rel, [query]).to(device),
        torch.as_tensor(scene.images[query], device=device),
        get_camera_slice(rel, ctx).to(device),
        torch.as_tensor(scene.images[ctx], device=device), near, far, path,
        generator=torch.Generator(device=device).manual_seed(step),
        latent_hw=cfg.latent_size)


def main(argv=None, step_hook=None):
    """Train; returns a results dict: per-step losses (``losses``,
    ``d_losses``, ``color_losses``) and context sizes
    (``context_sizes``), the host clock at the start of the loop
    (``loop_start``) and at each loss read (``sync_times``: (steps done
    in this run, seconds)), the seconds of each checkpoint written during
    the run (``checkpoint_seconds``), ``start_step``, ``unet_evals``
    (UNet forwards of this process), the guard's ``notfinite`` counts,
    ``params_without_grad`` (UNet and EFT parameters the last step gave
    no gradient) and ``fused`` (the graphs' warm-ups, captures and
    replays; None for the eager step).  ``step_hook``, where given, is
    called with each step's index once it is dispatched."""
    args = parse_args(argv)
    from sparsefusion_tpu_torch.cli.demo import load_dataset, resolve_device
    from sparsefusion_tpu_torch.models import count_params
    from sparsefusion_tpu_torch.parallel.mesh import (
        maybe_init_distributed,
        process_device,
        rank_and_world,
    )
    from sparsefusion_tpu_torch.train.checkpoints import (
        maybe_import_reference_weights,
        restore_checkpoint,
        save_checkpoint,
    )
    from sparsefusion_tpu_torch.train.fused import FusedTrainStep, LossRing
    from sparsefusion_tpu_torch.train.trainer import (
        TrainConfig,
        make_optimizers,
        make_train_step,
        notfinite_count,
        prepare_scene_batch,
    )
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    set_tf32(False)
    device = resolve_device(args.device)
    maybe_init_distributed(device.type)
    rank, world = rank_and_world()
    device = process_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    exp_dir = os.path.join(args.exp_dir, args.exp_name, args.category)
    os.makedirs(exp_dir, exist_ok=True)
    ckpt_path = os.path.join(exp_dir, "ckpt_latest")

    models = build_trio(args, device)
    models = maybe_import_reference_weights(models, None, args.vae_ckpt,
                                            None, verbose=rank == 0)
    n_unet = count_params(models.unet)
    print(f"UNet has {n_unet * 1e-6:.2f} M params")
    dataset = load_dataset(args, device)

    context_sizes = ([args.context_size] if args.context_size > 0
                     else [2, 3, 4, 5])
    cfg = TrainConfig(lr=args.lr, context_size=max(context_sizes),
                      diffusion_batch_size=args.diffusion_batch_size,
                      train_eft=args.train_eft,
                      latent_size=args.image_size // 8,
                      compute_dtype="bfloat16" if args.bf16
                      else "float32")
    unet_opt, eft_opt = make_optimizers(cfg, models)
    host = np.random.RandomState(rank)
    generator = torch.Generator(device=device).manual_seed(1234 + rank)
    start_step = 0
    if args.resume:
        ckpt = restore_checkpoint(args.resume)
        start_step = int(ckpt["step"])
        models.unet.load_state_dict(ckpt["unet"])
        models.eft.load_state_dict(ckpt["eft"])
        unet_opt.load_state_dict(ckpt["unet_opt"])
        if eft_opt is not None and ckpt["eft_opt"] is not None:
            eft_opt.load_state_dict(ckpt["eft_opt"])
        if rank < len(ckpt["rng"]):
            host.set_state(ckpt["rng"][rank]["host"])
            generator.set_state(ckpt["rng"][rank]["torch"])
        print(f"resumed from {args.resume} at step {start_step}")
    step_fn = make_train_step(models, cfg, unet_opt, eft_opt)
    fused = None
    if device.type == "cuda" and not args.debug_nans:
        if world == 1:
            fused = FusedTrainStep(step_fn, generator)
        elif rank == 0:
            print(f"DDP over {world} processes: the eager train step (no "
                  "CUDA graphs over NCCL)")

    def checkpoint(n_steps: int) -> None:
        rng = _rng_states(host, generator, world)
        if rank == 0:
            save_checkpoint(ckpt_path, {
                "step": n_steps, "unet": models.unet.state_dict(),
                "eft": models.eft.state_dict(),
                "unet_opt": unet_opt.state_dict(),
                "eft_opt": None if eft_opt is None else eft_opt.state_dict(),
                "rng": rng})

    results = {"start_step": start_step, "losses": [], "d_losses": [],
               "color_losses": [], "context_sizes": [], "sync_times": [],
               "checkpoint_seconds": []}
    ring = LossRing(3, device)

    def read_losses(n_done: int) -> list:
        """The losses of the steps since the last read, in one transfer;
        returns the last step's."""
        rows = ring.read()
        results["sync_times"].append((n_done, time.perf_counter()))
        for key, column in zip(("losses", "d_losses", "color_losses"),
                               zip(*rows)):
            results[key].extend(column)
        return rows[-1]

    n_skipped = notfinite_count(unet_opt)
    results["loop_start"] = time.perf_counter()
    for step in range(start_step, args.steps):
        scene_ids = host.randint(len(dataset), size=1)
        scenes = [dataset[int(s)] for s in scene_ids]
        query = [int(host.randint(len(s))) for s in scenes]
        cs = context_sizes[host.randint(len(context_sizes))]
        ctx = []
        for s in scenes:
            pool = list(range(len(s)))
            host.shuffle(pool)
            ctx.append(pool[:cs])
        if fused is not None:
            ring.push(fused(prepare_scene_batch(scenes, query, ctx)))
        else:
            batch = prepare_scene_batch(scenes, query, ctx, device)
            ring.push(torch.stack(step_fn(batch, generator)))
        results["context_sizes"].append(cs)
        if step_hook is not None:
            step_hook(step)

        if step % 50 == 0:
            losses = read_losses(step - start_step + 1)
            if rank == 0:
                sps = (step - start_step + 1) / (time.perf_counter()
                                                 - results["loop_start"])
                print(f"step {step} loss {losses[0]:.4f} ({sps:.2f} "
                      "steps/s)")
                skipped = notfinite_count(unet_opt)
                if skipped > n_skipped:
                    print(f"WARNING: {skipped - n_skipped} update(s) "
                          f"skipped on non-finite grads (total {skipped}); "
                          f"last batch scenes {list(map(int, scene_ids))}")
                    n_skipped = skipped

        if args.vis_itr > 0 and step % args.vis_itr == 0 and step > 0 \
                and rank == 0:
            try:
                _visualize(models, scenes[0], query[0], ctx[0], cfg,
                           os.path.join(exp_dir, f"vis_{step:06d}.jpg"),
                           step, device)
                print("visualizing", args.exp_name, args.category)
            except Exception as e:  # vis must never kill training
                print("vis failed:", repr(e))
        if step % args.save_itr == 0 and step > 0:
            if ring.n:
                read_losses(step - start_step + 1)
            t_save = time.perf_counter()
            checkpoint(step + 1)
            results["checkpoint_seconds"].append(
                time.perf_counter() - t_save)
            if rank == 0:
                print("saving model at step", step)

    if ring.n:
        read_losses(args.steps - start_step)
    checkpoint(max(args.steps, start_step))
    results.update(
        unet_evals=models.unet_evals,
        notfinite={"unet": notfinite_count(unet_opt),
                   "eft": notfinite_count(eft_opt)},
        params_without_grad=sum(
            p.grad is None for opt in (unet_opt, eft_opt) if opt is not None
            for p in opt.params),
        fused=None if fused is None else fused.stats())
    return results


if __name__ == "__main__":
    main()
