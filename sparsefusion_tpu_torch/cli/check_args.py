"""Argument/asset validation before any device work starts.

Counterpart of ``sparsefusion_tpu/cli/check_args.py``: exits with an
actionable message when the requested dataset is missing.
"""
from __future__ import annotations

import os
import sys

CO3D_ALL_CATEGORIES = list(reversed([
    "baseballbat", "banana", "bicycle", "microwave", "tv", "cellphone",
    "toilet", "hairdryer", "couch", "kite", "pizza", "umbrella", "wineglass",
    "laptop", "hotdog", "stopsign", "frisbee", "baseballglove", "cup",
    "parkingmeter", "backpack", "toyplane", "toybus", "handbag", "chair",
    "keyboard", "car", "motorcycle", "carrot", "bottle", "sandwich", "remote",
    "bowl", "skateboard", "toaster", "mouse", "toytrain", "book", "toytruck",
    "orange", "broccoli", "plant", "teddybear", "suitcase", "bench", "ball",
    "cake", "vase", "hydrant", "apple", "donut",
]))

CO3D_ALL_TEN = ["donut", "apple", "hydrant", "vase", "cake", "ball", "bench",
                "suitcase", "teddybear", "plant"]


def check_args(args) -> None:
    if args.dataset_name == "synthetic":
        return

    cats = {"all": CO3D_ALL_CATEGORIES, "all_ten": CO3D_ALL_TEN}.get(
        args.category, [args.category])
    for cat in cats:
        if cat not in CO3D_ALL_CATEGORIES and args.dataset_name == "co3d":
            print(f"ERROR: unknown CO3D category {cat!r}")
            sys.exit(1)

    if args.dataset_name == "co3d_toy":
        path = os.path.join(args.root, args.category,
                            f"{args.category}_toy.pt")
        if not os.path.exists(path):
            print(f"ERROR: toy dataset not found at {path}")
            print("Download it per the reference README, or run with "
                  "-d synthetic")
            sys.exit(1)
    elif args.dataset_name == "co3d":
        path = os.path.join(args.root, args.category,
                            "frame_annotations.jgz")
        if not os.path.exists(path):
            print(f"ERROR: CO3D annotations not found at {path}")
            sys.exit(1)

    for name in ("eft_ckpt", "vae_ckpt", "vldm_ckpt"):
        ckpt = getattr(args, name, None)
        if ckpt is not None and not os.path.exists(ckpt):
            print(f"WARNING: {name} not found at {ckpt}; "
                  f"continuing from scratch")
