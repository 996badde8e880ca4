"""Demo / evaluation entry point.

Counterpart of ``sparsefusion_tpu/cli/demo.py``, with the same argparse
surface plus ``--device`` (default ``cuda``):

    python -m sparsefusion_tpu_torch.cli.demo -d synthetic -c any -i 0 \
        -v 2 --no_diffusion

The diffusion arm runs by default: the EFT / VAE / UNet trio starts from
random weights drawn from seed 0, or loads the reference checkpoints
given with ``-e`` / ``-a`` / ``-l`` (and ``--resnet18`` for the EFT trunk
when no EFT checkpoint is given).  ``--no_diffusion`` runs the NGP-only
path.  On ``--device cpu`` the UNet and VAE are the narrow test models
(``models.narrow_model_configs``): the CPU path is for tests and
rehearsals, and the full-width UNet needs latents of 8 x 8 or more.
``--preset tpu`` runs the JAX package's TPU preset
(``distill/loop.py::tpu_distill_config``: 8 x C4 bf16 tables, occupancy
grid, single-pass marching, 4096-ray input and fusion gradient steps);
``--preset auto`` picks it, as the JAX demo does, only on a TPU backend,
so here always ``reference`` (``DistillConfig()``).  ``--lpips_weights``
(a converted ``.npz``, or a ``vgg16.pth,lpips_vgg.pth`` pair of torch
state dicts: ``nn/lpips.py::build_lpips_fn``) adds the fusion loss's
perceptual term and the eval's LPIPS column; missing files print a
warning and the run goes on without them.  ``--scene_batch N`` buckets
the scenes by (frame count, image size, context size), chunks each
bucket to N, and distills each chunk of two or more in lockstep
(``distill/batched.py``), a chunk of one sequentially; the JAX demo's
rule that sets ``scene_batch`` to the local chip count does not apply
(one card a process).  On a CUDA device each iteration runs as CUDA
graphs of the JAX loops' programs (``distill/fused.py``), one scene's or
a scene batch's; ``--no_fused`` runs them eagerly
(``DistillConfig.fused_steps=False``), as the JAX demo's flag does.
``-g`` / ``-p`` are accepted and change nothing.  With ``--device cuda``
and no CUDA device the demo raises; it never continues on the CPU.
``--spans`` records every iteration in the span recorder
(``utils/spans.py``), prints, at each loss read, a line of the set-up
spans and one of the iterations' host ms and each layer's device ms an
iteration, and writes every span to ``<exp_dir>/spans_<process>.json``.

Several processes (``SF_COORDINATOR`` / ``SF_NUM_PROCESSES`` /
``SF_PROCESS_ID``, or ``SF_DISTRIBUTED=1``: ``parallel/mesh.py``) split
``-i``'s scenes among themselves as the JAX demo does
(``shard_scene_list``): each process distills its own share.  f32
matmuls and convolutions run in full f32 (TF32 off,
``utils/precision.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--category", type=str, required=True)
    p.add_argument("-r", "--root", type=str, default="data/co3d_toy")
    p.add_argument("-d", "--dataset_name", type=str, default="co3d_toy",
                   choices=["co3d_toy", "co3d", "synthetic"])
    p.add_argument("-e", "--eft", type=str, default="-DNE")
    p.add_argument("-l", "--vldm", type=str, default="-DNE")
    p.add_argument("-a", "--vae", type=str, default="-DNE")
    p.add_argument("-i", "--idx", type=str, default="-DNE")
    p.add_argument("-v", "--input_views", type=int, default=2)
    p.add_argument("-g", "--gpus", type=int, default=1,
                   help="kept for reference-CLI compatibility")
    p.add_argument("-p", "--port", type=int, default=1)
    p.add_argument("--exp_dir", type=str, default="output/demo/")
    p.add_argument("--max_itr", type=int, default=3000)
    p.add_argument("--start_fusion", type=int, default=1000,
                   help="iteration after which the diffusion fusion loss "
                        "replaces the EFT bootstrap")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--no_diffusion", action="store_true")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="LPIPS weights: a converted .npz or "
                        "'vgg16.pth,lpips_vgg.pth'")
    p.add_argument("--resnet18", type=str, default=None,
                   help="torchvision resnet18 state dict for the EFT trunk")
    p.add_argument("--preset", type=str, default="auto",
                   choices=["auto", "reference", "tpu"],
                   help="'reference' = the torch-ngp recipe, DistillConfig(); "
                        "'tpu' = the TPU preset, tpu_distill_config() "
                        "(occupancy grid, single-pass marching); 'auto' = "
                        "'tpu' on a TPU backend only, so 'reference'")
    p.add_argument("--no_fused", action="store_true",
                   help="disable the fused per-iteration programs, CUDA "
                        "graphs on the card (DistillConfig.fused_steps; "
                        "default auto: on for CUDA, off on the CPU), in "
                        "the sequential loop and in scene batches")
    p.add_argument("--scene_batch", type=int, default=1,
                   help="scenes distilled in lockstep on one device")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the demo runs on (cuda or cpu)")
    p.add_argument("--spans", action="store_true",
                   help="record every iteration's spans, print each "
                        "layer's device ms and the host ms an iteration at "
                        "each loss read, and write the spans to "
                        "<exp_dir>/spans_<process>.json")
    args = p.parse_args(argv)

    # reference default parameter block
    args.timesteps = 500
    args.val_seed = 0
    args.context_views = args.input_views
    args.val_list = [0]
    if args.idx != "-DNE":
        try:
            args.val_list = [int(s) for s in args.idx.split(",")]
        except ValueError:
            print("ERROR: -i --idx arg invalid, please use form 1,2,3")
            sys.exit(1)

    args.eft_ckpt = None if args.eft == "-DNE" else args.eft
    args.vae_ckpt = None if args.vae == "-DNE" else args.vae
    args.vldm_ckpt = None if args.vldm == "-DNE" else args.vldm
    return args


def select_input_views(val_seed: int, val_idx: int, n_frames: int,
                       n_views: int):
    """Seeded view selection (the reference's torch.randperm seeding)."""
    g = torch.Generator()
    g.manual_seed(val_seed + val_idx)
    return torch.randperm(n_frames, generator=g)[:n_views].tolist()


def load_dataset(args, device):
    """The scenes of ``-d``: the synthetic blobs (as many as ``val_list``
    needs, 4 without one, as the train CLI), the co3d_toy pickle, or the
    CO3Dv2 release's ``fewview_dev`` subset at stage ``test`` (the JAX
    package's choice, which its train CLI shares)."""
    if args.dataset_name == "synthetic":
        from sparsefusion_tpu_torch.data.synthetic import SyntheticDataset

        n_scenes = max(getattr(args, "val_list", [3])) + 1
        return SyntheticDataset(n_scenes=n_scenes, n_views=10,
                                image_size=args.image_size, device=device)
    if args.dataset_name == "co3d_toy":
        from sparsefusion_tpu_torch.data.co3d_toy import CO3DToyDataset

        return CO3DToyDataset(args.root, args.category)
    from sparsefusion_tpu_torch.data.co3d import CO3Dv2Dataset

    return CO3Dv2Dataset(args.root, args.category, subset="fewview_dev",
                         stage="test", image_size=args.image_size)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} but no CUDA device is "
                           f"available; pass --device cpu to run the "
                           f"plain PyTorch path")
    return device


def build_trio(args, device: torch.device):
    """The EFT / VAE / UNet bundle, random from seed 0 or loaded from the
    given checkpoints."""
    from sparsefusion_tpu_torch.models import (
        build_models,
        narrow_model_configs,
    )
    from sparsefusion_tpu_torch.train.checkpoints import (
        import_resnet18_trunk,
        maybe_import_reference_weights,
    )

    configs = {}
    if device.type == "cpu":
        if any(p and os.path.exists(p) for p in
               (args.eft_ckpt, args.vae_ckpt, args.vldm_ckpt)):
            raise ValueError("reference checkpoints are full width; the "
                             "CPU demo runs the narrow test UNet and VAE")
        configs = narrow_model_configs()
        print("device cpu: narrow test UNet and VAE")
    generator = torch.Generator(device=device).manual_seed(0)
    models = build_models(generator, device, timesteps=args.timesteps,
                          **configs)
    models = maybe_import_reference_weights(
        models, args.eft_ckpt, args.vae_ckpt, args.vldm_ckpt)
    if args.eft_ckpt is None:
        # the reference EFT starts from an ImageNet trunk
        models = import_resnet18_trunk(models, args.resnet18)
    return models


def main(argv=None):
    """Run the demo; returns the per-scene results of the loop."""
    args = parse_args(argv)
    from sparsefusion_tpu_torch.cli.check_args import check_args
    from sparsefusion_tpu_torch.distill.batched import (
        batched_distillation_loop,
    )
    from sparsefusion_tpu_torch.distill.loop import (
        DistillConfig,
        distillation_loop,
        tpu_distill_config,
    )
    from sparsefusion_tpu_torch.nn.lpips import build_lpips_fn

    from sparsefusion_tpu_torch.parallel.mesh import (
        maybe_init_distributed,
        process_device,
        rank_and_world,
        shard_scene_list,
    )
    from sparsefusion_tpu_torch.utils import spans
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    check_args(args)
    set_tf32(False)
    device = resolve_device(args.device)

    maybe_init_distributed(device.type)
    rank, world = rank_and_world()
    device = process_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    val_list = shard_scene_list(args.val_list, world, rank)
    print(f"process {rank}: assigned idx {val_list}")

    os.makedirs(args.exp_dir, exist_ok=True)
    for sub in ("log", "metrics", "render_imgs", "render_gifs"):
        os.makedirs(os.path.join(args.exp_dir, sub), exist_ok=True)

    models = None if args.no_diffusion else build_trio(args, device)
    lpips_fn = build_lpips_fn(args.lpips_weights, device)
    dataset = load_dataset(args, device)
    # the JAX demo's 'auto' picks the TPU preset on a TPU backend only
    preset = "reference" if args.preset == "auto" else args.preset
    make_cfg = tpu_distill_config if preset == "tpu" else DistillConfig
    cfg = make_cfg(max_itr=args.max_itr, start_fusion_step=args.start_fusion)
    if args.no_fused:
        cfg = dataclasses.replace(cfg, fused_steps=False)

    entries = []
    for val_idx in val_list:
        scene = dataset[val_idx]
        input_idx = select_input_views(args.val_seed, val_idx, len(scene),
                                       args.context_views)
        print("val_idx", val_idx, input_idx)
        scene.sequence_name = \
            f"{args.category}_{val_idx:03d}_c{len(input_idx)}"
        entries.append((val_idx, scene, input_idx))

    first_span = spans.mark()
    if args.spans:
        spans.enable(report=print)
    results = []
    for group in scene_groups(entries, args.scene_batch):
        generator = torch.Generator(device=device)
        generator.manual_seed(args.val_seed + group[0][0])
        kw = dict(save_dir=args.exp_dir, use_diffusion=not args.no_diffusion,
                  lpips_fn=lpips_fn)
        if len(group) == 1:
            _, scene, input_idx = group[0]
            results.append(distillation_loop(models, scene, input_idx, cfg,
                                             generator, **kw))
        else:
            print(f"scene batch: {[g[0] for g in group]}")
            results.extend(batched_distillation_loop(
                models, [g[1] for g in group], [g[2] for g in group], cfg,
                generator, **kw))
    if args.spans:
        spans.disable()
        os.makedirs(args.exp_dir, exist_ok=True)
        spans.dump(os.path.join(args.exp_dir, f"spans_{rank}.json"),
                   first_span)
    return results


def scene_groups(entries, scene_batch: int):
    """(val_idx, scene, input_idx) entries in groups: with ``scene_batch``
    above 1, bucketed by (frame count, image size, context size), the
    batched loop's stacking contract, and each bucket chunked to
    ``scene_batch``; otherwise one a group."""
    if scene_batch <= 1:
        return [[e] for e in entries]
    buckets = {}
    for e in entries:
        key = (len(e[1]), e[1].images.shape[1], len(e[2]))
        buckets.setdefault(key, []).append(e)
    return [bucket[i:i + scene_batch] for bucket in buckets.values()
            for i in range(0, len(bucket), scene_batch)]


if __name__ == "__main__":
    main()
