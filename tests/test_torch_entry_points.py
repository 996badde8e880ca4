"""What the port's entry points set up: TF32, and the demo's scene sharding
over processes.

* Importing the port changes no torch setting; each CLI's ``main`` turns
  TF32 off for f32 matmuls and convolutions (``utils/precision.py``).
* The demo splits ``-i``'s scenes over the processes of
  ``torch.distributed`` as the JAX demo does
  (``shard_scene_list(val_list, process_count, process_index)``).  Two
  gloo processes on the CPU run the demo's ``main`` with the distillation
  loop replaced by a stub that writes each scene's output file: the
  processes take the JAX function's lists, disjoint and together all the
  scenes, and each scene's file is written once.
"""
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from sparsefusion_tpu.parallel.mesh import (
    shard_scene_list as jax_shard_scene_list,
)

REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_KEEPS_TF32 = """
import importlib, pkgutil
import torch
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
import sparsefusion_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
assert torch.backends.cuda.matmul.allow_tf32
assert torch.backends.cudnn.allow_tf32
print("OK")
"""


def test_import_leaves_tf32_alone():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_KEEPS_TF32],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("cli", ["demo", "train"])
def test_cli_main_turns_tf32_off(cli, monkeypatch, tmp_path):
    """Each CLI sets both flags before it looks for its device (here it
    then raises: no CUDA device)."""
    import importlib

    main = importlib.import_module(f"sparsefusion_tpu_torch.cli.{cli}").main
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-c", "any", "-d", "synthetic", "--exp_dir", str(tmp_path),
              "--device", "cuda"])
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
from sparsefusion_tpu_torch.cli import demo
from sparsefusion_tpu_torch.distill import loop


def stub(models, scene, input_idx, cfg, generator, save_dir=None, **kw):
    path = os.path.join(save_dir, "metrics", scene.sequence_name + ".txt")
    with open(path, "a") as fp:
        fp.write(os.environ["SF_PROCESS_ID"] + "\n")
    return {"scene": scene.sequence_name}


loop.distillation_loop = stub
results = demo.main(["-d", "synthetic", "-c", "any", "-i", sys.argv[2],
                     "--image_size", "16", "--no_diffusion",
                     "--device", "cpu", "--exp_dir", sys.argv[1]])
torch.distributed.destroy_process_group()
print("SCENES", " ".join(r["scene"] for r in results), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_demo_shards_scenes_over_processes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    val_list = [0, 1, 2, 3, 4]
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, SF_COORDINATOR=f"127.0.0.1:{port}",
                   SF_NUM_PROCESSES="2", SF_PROCESS_ID=str(rank),
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path / "out"),
             ",".join(map(str, val_list))], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    taken = []
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, stdout + stderr
        line = next(x for x in stdout.splitlines() if x.startswith("SCENES"))
        scenes = line.split()[1:]
        want = jax_shard_scene_list(val_list, 2, rank)
        assert scenes == [f"any_{i:03d}_c2" for i in want], (rank, scenes)
        taken.append(want)
    assert sorted(taken[0] + taken[1]) == val_list
    assert not set(taken[0]) & set(taken[1])
    metrics = tmp_path / "out" / "metrics"
    written = sorted(p.name for p in metrics.iterdir())
    assert written == [f"any_{i:03d}_c2.txt" for i in val_list]
    for rank, scenes in enumerate(taken):
        for i in scenes:
            assert (metrics / f"any_{i:03d}_c2.txt").read_text() \
                == f"{rank}\n"
