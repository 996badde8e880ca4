"""The port's demo CLI on the CPU: the NGP-only slice end to end at full
model width (``DistillConfig()``, ``NGPConfig()``) on a 32 px scene, and
the paths it refuses."""
import json
import os

import numpy as np
import pytest
import torch

from sparsefusion_tpu_torch.cli import demo

torch.set_num_threads(2)


def test_demo_cpu_writes_metrics_and_params(tmp_path):
    results = demo.main([
        "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
        "--image_size", "32", "--max_itr", "3", "--no_diffusion",
        "--device", "cpu", "--exp_dir", str(tmp_path)])
    r = results[0]
    assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
    with open(tmp_path / "metrics" / "any_000_c2.txt") as fp:
        fp.readline()
        metrics = json.loads(fp.read())
    assert set(metrics) == {"psnr", "ssim"}
    assert metrics["psnr"] == pytest.approx(r["metrics"]["psnr"])
    npz = np.load(tmp_path / "any_000_c2_ngp.npz")
    # the JAX package's key layout, so its loaders read the port's output
    assert sorted(npz.files) == sorted(
        ["grid"] + [f"sigma_net_{i}/{k}" for i in range(3)
                    for k in ("kernel", "bias")])
    assert npz["grid"].shape == (929336, 2)
    assert npz["sigma_net_0/kernel"].shape == (32, 64)
    assert r["renders"].shape == (10, 32, 32, 3)
    assert r["circle_renders"].shape == (50, 32, 64, 3)


def test_demo_refuses_cuda_without_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-d", "synthetic", "-c", "any", "--no_diffusion",
            "--exp_dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(argv + ["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(argv)           # cuda is the default device
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("extra", [[], ["--no_diffusion", "--preset", "tpu"],
                                   ["--no_diffusion", "--scene_batch", "2"]])
def test_demo_unported_paths_raise(extra, tmp_path):
    argv = ["-d", "synthetic", "-c", "any", "--device", "cpu",
            "--exp_dir", str(tmp_path)] + extra
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        demo.main(argv)
