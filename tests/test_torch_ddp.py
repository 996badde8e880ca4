"""Data parallelism: two gloo processes on the CPU, one scene each, take
the same train step as one process with both scenes.

The workers start ``torch.distributed`` through the port's
``parallel/mesh.py::maybe_init_distributed`` from ``SF_COORDINATOR`` /
``SF_NUM_PROCESSES`` / ``SF_PROCESS_ID``, and the train step wraps the
UNet and the EFT in ``DistributedDataParallel``, whose gradient average
over the two processes is the mean over both scenes.  Every process
builds the same weights (seed 0) and gets fixed draws per scene.  The
averaged gradients agree with the single process's to 1e-5 relative
(summed in another order), and so do the parameters after one guarded
Adam step, to 1e-5, wherever the gradient is at least 10 Adam eps: a
first Adam step moves an element by lr * g / (|g| + eps), which for a
gradient near zero (two scenes cancelling) turns on its last bits, so
there only the bound |update| <= lr holds on each side.
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch

from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
from sparsefusion_tpu_torch.models import build_models, narrow_model_configs
from sparsefusion_tpu_torch.parallel.mesh import shard_scene_list
from sparsefusion_tpu_torch.train import trainer

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
IMAGE_SIZE, DBS = 32, 2

WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from sparsefusion_tpu_torch.parallel.mesh import (
    maybe_init_distributed, rank_and_world)
from tests.test_torch_ddp import step_on_scenes

assert maybe_init_distributed("cpu", verbose=False)
rank, world = rank_and_world()
assert world == 2, world
loss, state = step_on_scenes([rank])
if rank == 0:
    torch.save({"loss": loss, "state": state}, sys.argv[1])
torch.distributed.destroy_process_group()
print("OK", rank, flush=True)
"""


def step_on_scenes(scene_ids):
    """One train step (EFT trained) over the given scenes, from seed-0
    weights and fixed draws per scene: (loss, the models' state dicts)."""
    models = build_models(torch.Generator().manual_seed(0), "cpu",
                          **narrow_model_configs())
    with torch.no_grad():   # a zero final conv would hide the UNet
        models.unet.final_conv.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    cfg = trainer.TrainConfig(latent_size=IMAGE_SIZE // 8, context_size=2,
                              diffusion_batch_size=DBS)
    unet_opt, eft_opt = trainer.make_optimizers(cfg, models)
    step = trainer.make_train_step(models, cfg, unet_opt, eft_opt)
    scenes = [make_synthetic_scene(n_views=4, image_size=IMAGE_SIZE, seed=s)
              for s in scene_ids]
    batch = trainer.prepare_scene_batch(scenes, [0] * len(scenes),
                                        [[1, 2]] * len(scenes))
    draws = []
    for s in scene_ids:
        rng = np.random.RandomState(100 + s)
        hw = cfg.latent_size
        draws.append({
            "times": torch.tensor(rng.uniform(0, 0.999, DBS),
                                  dtype=torch.float32),
            "noise": torch.tensor(rng.randn(DBS, 4, hw, hw),
                                  dtype=torch.float32),
            "keep": torch.tensor(rng.rand(DBS) < 0.9)})
    loss, _, _ = step(batch, draws=draws)
    return float(loss), {
        name: {"params": {n: p.detach() for n, p in m.named_parameters()},
               "grads": {n: p.grad for n, p in m.named_parameters()}}
        for name, m in (("unet", models.unet), ("eft", models.eft))}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_match_one(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = tmp_path / "rank0.pt"
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, SF_COORDINATOR=f"127.0.0.1:{port}",
                   SF_NUM_PROCESSES="2", SF_PROCESS_ID=str(rank),
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(out)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stdout + stderr
        assert "OK" in stdout

    ddp = torch.load(out, weights_only=False)
    loss, state = step_on_scenes([0, 1])
    # rank 0's loss is its own scene's; the step's gradient is the mean
    assert np.isfinite(ddp["loss"]) and np.isfinite(loss)
    lr = trainer.TrainConfig().lr
    for model in ("unet", "eft"):
        want_g = torch.cat([g.ravel() for g in
                            state[model]["grads"].values()])
        got_g = torch.cat([g.ravel() for g in
                           ddp["state"][model]["grads"].values()])
        rel = float((got_g - want_g).norm() / want_g.norm())
        assert rel <= 1e-5, (model, rel)
        for name, want in state[model]["params"].items():
            diff = (ddp["state"][model]["params"][name] - want).abs()
            settled = state[model]["grads"][name].abs() >= 1e-7
            if settled.any():
                assert float(diff[settled].max()) <= 1e-5, name
            assert float(diff.max()) <= 2 * lr * (1 + 1e-3), name
    # and the parameters moved: one update was applied
    fresh = build_models(torch.Generator().manual_seed(0), "cpu",
                         **narrow_model_configs())
    assert not torch.equal(fresh.eft.state_dict()["t1.pre.0.weight"],
                           state["eft"]["params"]["t1.pre.0.weight"])


def test_shard_scene_list():
    shards = [shard_scene_list(range(10), 4, i) for i in range(4)]
    assert shards[0] == [0, 1, 2] and shards[3] == [8, 9]
    assert sum(shards, []) == list(range(10))
