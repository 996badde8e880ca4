"""Demo / evaluation entry point.

Counterpart of ``sparsefusion_tpu/cli/demo.py``, with the same argparse
surface plus ``--device`` (default ``cuda``):

    python -m sparsefusion_tpu_torch.cli.demo -d synthetic -c any -i 0 \
        -v 2 --no_diffusion

The port runs the NGP-only path (``--no_diffusion``).  The diffusion
arm, LPIPS, ``-d co3d``, ``--preset tpu`` and ``--scene_batch > 1`` raise
``NotImplementedError`` naming their ROADMAP item; ``--no_fused`` and
``-g`` / ``-p`` are accepted and change nothing.  With ``--device cuda``
and no CUDA device the demo raises; it never continues on the CPU.
"""
from __future__ import annotations

import argparse
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
                   help="LPIPS weights (not ported yet)")
    p.add_argument("--resnet18", type=str, default=None,
                   help="torchvision resnet18 state dict for the EFT trunk "
                        "(diffusion arm, not ported yet)")
    p.add_argument("--preset", type=str, default="auto",
                   choices=["auto", "reference", "tpu"],
                   help="'reference' = the torch-ngp recipe, DistillConfig(); "
                        "'tpu' = the TPU preset (needs occupancy, not "
                        "ported yet); 'auto' = reference")
    p.add_argument("--no_fused", action="store_true",
                   help="accepted for compatibility; the port has no "
                        "fused dispatch programs")
    p.add_argument("--scene_batch", type=int, default=1,
                   help="scenes distilled in lockstep (only 1 is ported)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the demo runs on (cuda or cpu)")
    args = p.parse_args(argv)

    # reference default parameter block (the diffusion entries come with
    # the diffusion arm)
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
    if args.dataset_name == "synthetic":
        from sparsefusion_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(n_scenes=max(args.val_list) + 1, n_views=10,
                                image_size=args.image_size, device=device)
    if args.dataset_name == "co3d_toy":
        from sparsefusion_tpu_torch.data.co3d_toy import CO3DToyDataset

        return CO3DToyDataset(args.root, args.category)
    raise NotImplementedError("the CO3Dv2 reader (data/co3d.py) is not "
                              "ported yet: ROADMAP.md section 1, item 11")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} but no CUDA device is "
                           f"available; pass --device cpu to run the "
                           f"plain PyTorch path")
    return device


def main(argv=None):
    """Run the demo; returns the per-scene results of the loop."""
    args = parse_args(argv)
    from sparsefusion_tpu_torch.cli.check_args import check_args
    from sparsefusion_tpu_torch.distill.loop import (
        NOT_PORTED_DIFFUSION,
        NOT_PORTED_LPIPS,
        NOT_PORTED_OCCUPANCY,
        DistillConfig,
        distillation_loop,
    )

    check_args(args)
    device = resolve_device(args.device)
    if not args.no_diffusion:
        raise NotImplementedError(NOT_PORTED_DIFFUSION
                                  + "; run with --no_diffusion")
    if args.lpips_weights is not None:
        raise NotImplementedError(NOT_PORTED_LPIPS)
    if args.preset == "tpu":
        raise NotImplementedError(NOT_PORTED_OCCUPANCY)
    if args.scene_batch > 1:
        raise NotImplementedError(
            "scene batches (distill/batched.py) are not ported yet: "
            "ROADMAP.md section 1, item 13")

    os.makedirs(args.exp_dir, exist_ok=True)
    for sub in ("log", "metrics", "render_imgs", "render_gifs"):
        os.makedirs(os.path.join(args.exp_dir, sub), exist_ok=True)

    dataset = load_dataset(args, device)
    cfg = DistillConfig(max_itr=args.max_itr,
                        start_fusion_step=args.start_fusion)

    results = []
    for val_idx in args.val_list:
        scene = dataset[val_idx]
        input_idx = select_input_views(args.val_seed, val_idx, len(scene),
                                       args.context_views)
        print("val_idx", val_idx, input_idx)
        scene.sequence_name = \
            f"{args.category}_{val_idx:03d}_c{len(input_idx)}"
        generator = torch.Generator(device=device)
        generator.manual_seed(args.val_seed + val_idx)
        results.append(distillation_loop(
            None, scene, input_idx, cfg, generator, save_dir=args.exp_dir,
            use_diffusion=False))
    return results


if __name__ == "__main__":
    main()
