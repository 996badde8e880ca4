"""Parity sweep: per-scene PSNR/SSIM/LPIPS over (category, n_views) configs.

Counterpart of ``tools/parity_sweep.py``, with the same flags plus
``--device`` (default ``cuda``; it raises without a CUDA device, and
``--device cpu`` runs the plain PyTorch path).  Each (category, scene,
views) row distills one scene through ``distill/loop.py::
distillation_loop`` from a generator seeded with the scene index, and
prints a ``RESULT`` line; the rows land in ``{out}/parity_sweep.json``
and as a markdown table in ``{out}/parity_sweep.md``.  The data are
``co3d_toy`` pickles: the real ones, or the synthetic fixture of
``tools/make_toy_fixture.py``.

    python -m sparsefusion_tpu_torch.tools.parity_sweep \
        --root /tmp/toy_fixture --categories hydrant --views 2 3 6 \
        --scenes 0 --max_itr 3000 --out output/parity

The models are full width, random from seed 0 or loaded from the given
checkpoints.  ``--preset auto`` picks ``reference`` (``DistillConfig()``),
as the port's demo does: the JAX sweep's ``auto`` picks the TPU preset on
a TPU backend only.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="data/co3d_toy")
    p.add_argument("--categories", nargs="+",
                   default=["teddybear", "laptop", "toybus"])
    p.add_argument("--views", nargs="+", type=int, default=[2, 3, 6])
    p.add_argument("--scenes", nargs="+", type=int, default=[0],
                   help="scene indices within each category")
    p.add_argument("--max_itr", type=int, default=3000)
    p.add_argument("--no_diffusion", action="store_true")
    p.add_argument("--preset", default="auto",
                   choices=["auto", "reference", "tpu"])
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--resnet18", default=None)
    p.add_argument("--eft", default=None)
    p.add_argument("--vae", default=None)
    p.add_argument("--vldm", default=None)
    p.add_argument("--out", default="output/parity")
    p.add_argument("--device", default="cuda",
                   help="torch device the sweep runs on (cuda or cpu)")
    args = p.parse_args(argv)

    import torch

    from sparsefusion_tpu_torch import models as models_mod
    from sparsefusion_tpu_torch.cli.demo import (
        resolve_device,
        select_input_views,
    )
    from sparsefusion_tpu_torch.data.co3d_toy import CO3DToyDataset
    from sparsefusion_tpu_torch.distill.loop import (
        DistillConfig,
        distillation_loop,
        tpu_distill_config,
    )
    from sparsefusion_tpu_torch.nn.lpips import build_lpips_fn
    from sparsefusion_tpu_torch.train.checkpoints import (
        import_resnet18_trunk,
        maybe_import_reference_weights,
    )
    from sparsefusion_tpu_torch.utils.precision import set_tf32

    set_tf32(False)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    preset = "reference" if args.preset == "auto" else args.preset

    models = models_mod.build_models(
        torch.Generator(device=device).manual_seed(0), device)
    models = maybe_import_reference_weights(
        models, args.eft, args.vae, args.vldm)
    if args.eft is None:
        models = import_resnet18_trunk(models, args.resnet18)
    lpips_fn = build_lpips_fn(args.lpips_weights, device)

    rows = []
    for cat in args.categories:
        try:
            dataset = CO3DToyDataset(args.root, cat)
        except FileNotFoundError as e:
            print(f"SKIP {cat}: {e}")
            continue
        for scene_idx in args.scenes:
            if scene_idx >= len(dataset):
                print(f"SKIP {cat}[{scene_idx}]: only {len(dataset)} scenes")
                continue
            for v in args.views:
                scene = dataset[scene_idx]
                input_idx = select_input_views(0, scene_idx, len(scene), v)
                scene.sequence_name = f"{cat}_{scene_idx:03d}_v{v}"
                make_cfg = (tpu_distill_config if preset == "tpu"
                            else DistillConfig)
                cfg = make_cfg(max_itr=args.max_itr)
                generator = torch.Generator(device=device)
                generator.manual_seed(scene_idx)
                res = distillation_loop(
                    models, scene, input_idx, cfg, generator,
                    save_dir=args.out, use_diffusion=not args.no_diffusion,
                    lpips_fn=lpips_fn)
                row = {"category": cat, "scene": scene_idx, "views": v,
                       **res["metrics"]}
                rows.append(row)
                print("RESULT", json.dumps(row))

    with open(os.path.join(args.out, "parity_sweep.json"), "w") as fp:
        json.dump(rows, fp, indent=2)

    cols = ["category", "scene", "views", "psnr", "ssim"]
    if rows and "lpips" in rows[0]:
        cols.append("lpips")
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "---|" * len(cols)]
    for r in rows:
        lines.append("| " + " | ".join(
            f"{r[c]:.3f}" if isinstance(r[c], float) else str(r[c])
            for c in cols) + " |")
    table = "\n".join(lines)
    with open(os.path.join(args.out, "parity_sweep.md"), "w") as fp:
        fp.write(table + "\n")
    print(table)
    return rows


if __name__ == "__main__":
    main()
