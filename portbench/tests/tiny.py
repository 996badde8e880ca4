"""A copy of the benchmark at a size the CPU runs in seconds, for the
tests: the same files under a temporary root, with the configurations'
widths and the traffic's lengths cut down."""
from __future__ import annotations

import json
import pathlib
import shutil

from portbench import spec

TINY_MODELS = {
    "unet": {"dim": 32, "dim_mults": [1, 2], "num_resnet_blocks": [1, 1],
             "layer_attns": [False, True], "layer_cross_attns": [False, False],
             "attn_heads": 2, "attn_dim_head": 8},
    "vae": {"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1},
    "ddpm": {"image_size": 4, "timesteps": 100},
}
TINY_DISTILL = {"num_steps": 8, "upsample_steps": 8, "max_ray_batch": 64,
                "plms_steps": 4, "n_aug_cameras": 4}
TINY_NGP = {"num_levels": 4, "log2_hashmap_size": 10, "hidden_dim": 16}
TINY_TRAIN = {"diffusion_batch_size": 2, "latent_size": 4, "eft_n_pts": 4}


def tiny_checkout(tmp: pathlib.Path) -> pathlib.Path:
    """``tmp`` holding BENCHMARK.json and portbench/ at the tiny size;
    returns ``tmp``."""
    bench = tmp / "portbench"
    shutil.copytree(spec.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for path in (bench / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["image_size"], c["n_views"] = 32, 4
        for k, v in TINY_MODELS.items():
            c[k].update(v)
        if "distill" in c:
            c["distill"].update(TINY_DISTILL)
            c["ngp"].update(TINY_NGP)
        if "train" in c:
            c["train"].update(TINY_TRAIN)
        path.write_text(json.dumps(c))
    for path in (bench / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if "scenes" in t:
            t.update(scenes=2, context_sizes=[2, 3], setup_steps=4,
                     follow_steps=4, read_every=2)
        path.write_text(json.dumps(t))
    return tmp


def run_tiny(tmp: pathlib.Path, workload: str, seed: int,
             seconds: float = 0.5) -> dict:
    from portbench.run import run_cell

    return run_cell(workload, seed, seconds, False, device="cpu", root=tmp,
                    bench_dir=tmp / "portbench")
