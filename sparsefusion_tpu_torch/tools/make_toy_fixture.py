"""Write a deterministic co3d_toy-format fixture from synthetic scenes.

Counterpart of ``tools/make_toy_fixture.py``: the reference distributes
preprocessed pickles ``{root}/{cat}/{cat}_toy.pt`` holding ``{category:
[scene_dict, ...]}`` with torch tensors in its dict contract; this tool
writes the same format from the procedural blob scenes
(``data/synthetic.py``, rendered on ``--device``; scene ``si`` of the
``cat_i``-th category from seed ``1000 * cat_i + si``), so the parity
sweep (``tools/parity_sweep.py``) runs without the CO3D download.

    python -m sparsefusion_tpu_torch.tools.make_toy_fixture \
        --root /tmp/toy_fixture --categories hydrant teddybear \
        --scenes 2 --views 10 --size 256

``--device`` defaults to ``cuda`` and raises without a CUDA device;
``--device cpu`` renders on the CPU.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--categories", nargs="+", default=["hydrant"])
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--views", type=int, default=10)
    p.add_argument("--size", type=int, default=256,
                   help="image size (reference uses 256)")
    p.add_argument("--device", default="cuda",
                   help="torch device the scenes are rendered on")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from sparsefusion_tpu_torch.cli.demo import resolve_device
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene

    device = resolve_device(args.device)
    paths = []
    for cat_i, cat in enumerate(args.categories):
        scenes = []
        for si in range(args.scenes):
            # distinct deterministic seed per (category, scene)
            seed = 1000 * cat_i + si
            scene = make_synthetic_scene(n_views=args.views,
                                         image_size=args.size, seed=seed,
                                         device=device)
            d = scene.to_reference_dict()
            scenes.append({k: torch.from_numpy(np.ascontiguousarray(v).copy())
                           for k, v in d.items()})
        out_dir = os.path.join(args.root, cat)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{cat}_toy.pt")
        torch.save({cat: scenes}, path)
        print(f"wrote {path}: {len(scenes)} scenes x {args.views} views "
              f"@ {args.size}px")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
