"""The check's control: the reference put in the program's place and
computed one precision below the configuration's (f32 with TF32 off ->
TF32 on; a bf16 sampler's UNet -> fp8), held to the same numbers as a
run.

    python3 -m portbench.control --workload <name> --seeds 1 2 3
        [--scopes all diffusion fp8_unet]

For each seed, the cell's inputs are made as a run makes them, the
reference follows the program's first steps in f32 and, as the
control, with TF32 on in everything ("all") or in the UNet and VAE alone
("diffusion"), or, for a distillation cell, with the UNet's
convolutions and linears on fp8-rounded weights and inputs
("fp8_unet", ``portbench/fp8.py``); the numbers the check compares are
printed, one JSON line a seed and scope, control against f32.  The
benchmark's own runs do not run it; ``PERF.md`` gives the readings each
limit was set from.  With
``--faults <name> ...``, a run of the cell follows for each fault of
``portbench/faults.py`` named, planted in the program (``--seconds`` of
window), and its numbers are printed too.
"""
from __future__ import annotations

import argparse
import json
import sys


def control_readings(workload: str, seed: int, device="cuda",
                     root=None, bench_dir=None, scopes=("all",)) -> dict:
    """{scope: {number: value}} of the control reference against the f32
    one: TF32 on in ``scope`` ("all", "diffusion"), or the UNet on fp8
    ("fp8_unet", distillation cells)."""
    import torch

    from portbench import scenes, spec
    from portbench.run import compare

    root = root or spec.ROOT
    bench_dir = bench_dir or spec.HERE
    cell = spec.find_cell(workload, root, bench_dir)
    config, traffic = cell.config, cell.traffic
    device = torch.device(device)
    n_views, size = config["n_views"], config["image_size"]
    if "fp8_unet" in scopes and config["kind"] != "distill":
        raise ValueError("the fp8 control rounds a distillation cell's "
                         "sampler UNet")
    if config["kind"] == "distill":
        from portbench.drivers.distill import follow_reference
        from sparsefusion_tpu_torch.distill.loop import DistillConfig
        from sparsefusion_tpu_torch.nn.ngp import NGPConfig

        scene = scenes.blob_scene(spec.sub_seed(seed, spec.SEED_SCENE),
                                  n_views, size, device)
        idx = scenes.input_views(spec.sub_seed(seed, spec.SEED_SCENE, 1),
                                 n_views, config["input_views"])
        cfg = DistillConfig(**dict(
            config["distill"], max_itr=traffic["max_itr"],
            start_fusion_step=traffic["start_fusion_step"],
            ngp=NGPConfig(**config["ngp"])))

        def follow(tf32):
            return follow_reference(config, cfg, scene, idx, seed,
                                    traffic["follow_iterations"],
                                    traffic["moment_iteration"], device,
                                    tf32=tf32)
    else:
        from portbench.drivers.train import follow_reference, plan_steps

        data = [scenes.blob_scene(spec.sub_seed(seed, spec.SEED_SCENE, k),
                                  n_views, size, device)
                for k in range(traffic["scenes"])]
        plan = plan_steps(traffic, seed, traffic["follow_steps"], n_views)

        def follow(tf32):
            return follow_reference(config, data, plan, seed, device,
                                    tf32=tf32)
    ref = follow("")
    out = {}
    for scope in scopes:
        checks = compare(follow(scope), ref, traffic["limits"])
        out[scope] = {k: c["value"] for k, c in checks.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="*", default=[],
                   help="faults of portbench/faults.py to plant")
    p.add_argument("--scopes", nargs="+", default=["all"],
                   choices=["all", "diffusion", "fp8_unet"],
                   help="where the control turns TF32 on, or fp8_unet")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    for seed in args.seeds:
        readings = control_readings(args.workload, seed,
                                    scopes=args.scopes)
        for scope, r in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": scope if scope == "fp8_unet"
                              else f"tf32_{scope}", "readings": r}),
                  flush=True)
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
