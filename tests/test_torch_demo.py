"""The port's demo CLI on the CPU: the NGP-only slice end to end at full
model width (``DistillConfig()``, ``NGPConfig()``, and the TPU preset) on
a 32 px scene, and the paths it refuses."""
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


def test_demo_cpu_runs_the_tpu_preset(tmp_path):
    """``--preset tpu``: tpu_distill_config() at full width (8 x C4 table
    read in bf16, 32+32 samples through the all-occupied bitfield, which
    is a no-op before occupancy_start)."""
    results = demo.main([
        "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
        "--image_size", "32", "--max_itr", "3", "--no_diffusion",
        "--preset", "tpu", "--device", "cpu", "--exp_dir", str(tmp_path)])
    r = results[0]
    assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
    assert r["occupancy"]["update_itrs"] == []     # occupancy_start 500
    with open(tmp_path / "metrics" / "any_000_c2.txt") as fp:
        fp.readline()
        assert set(json.loads(fp.read())) == {"psnr", "ssim"}
    npz = np.load(tmp_path / "any_000_c2_ngp.npz")
    assert npz["grid"].shape == (463672, 4)
    assert npz["sigma_net_0/kernel"].shape == (32, 64)
    assert r["renders"].shape == (10, 32, 32, 3)
    assert np.isfinite(r["renders"]).all()


def test_demo_auto_preset_is_the_reference(monkeypatch, tmp_path):
    """``--preset auto`` picks the TPU preset on a TPU backend only, as
    the JAX demo does: here DistillConfig()."""
    from sparsefusion_tpu_torch.distill import loop

    seen = []
    monkeypatch.setattr(loop, "distillation_loop",
                        lambda models, scene, idx, cfg, gen, **kw:
                        seen.append(cfg) or {})
    demo.main(["-d", "synthetic", "-c", "any", "--no_diffusion",
               "--image_size", "16", "--device", "cpu", "--max_itr", "7",
               "--exp_dir", str(tmp_path)])
    assert seen == [loop.DistillConfig(max_itr=7)]


@pytest.mark.parametrize("extra", [["--lpips_weights", "lpips.npz"],
                                   ["--no_diffusion", "--scene_batch", "2"]])
def test_demo_unported_paths_raise(extra, tmp_path):
    argv = ["-d", "synthetic", "-c", "any", "--device", "cpu",
            "--exp_dir", str(tmp_path)] + extra
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        demo.main(argv)
