"""The port's demo CLI on the CPU: the NGP-only slice end to end at full
model width (``DistillConfig()``, ``NGPConfig()``, and the TPU preset) on
a 32 px scene, LPIPS weights given and missing, scene batches, and the
device it refuses."""
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


def _metrics(path):
    with open(path) as fp:
        fp.readline()
        return json.loads(fp.read())


def test_demo_cpu_writes_the_lpips_metric(tmp_path):
    """``--lpips_weights vgg16.pth,lpips_vgg.pth`` (synthesized state
    dicts): the eval's LPIPS column reaches the metrics file.  The new
    demo tests run the TPU preset at 16 px, the cheapest full-width
    configuration on the CPU."""
    from tests.test_torch_lpips import synthesized_state_dicts

    vgg, lin = synthesized_state_dicts()
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "lpips_vgg.pth")
    out = tmp_path / "out"
    results = demo.main([
        "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
        "--image_size", "16", "--max_itr", "2", "--no_diffusion",
        "--preset", "tpu", "--lpips_weights",
        f"{tmp_path / 'vgg16.pth'},{tmp_path / 'lpips_vgg.pth'}",
        "--device", "cpu", "--exp_dir", str(out)])
    metrics = _metrics(out / "metrics" / "any_000_c2.txt")
    assert set(metrics) == {"psnr", "ssim", "lpips"}
    assert np.isfinite(metrics["lpips"]) and metrics["lpips"] >= 0
    assert metrics["lpips"] == pytest.approx(results[0]["metrics"]["lpips"])


def test_demo_cpu_without_lpips_weights_warns_and_finishes(tmp_path,
                                                           capsys):
    results = demo.main([
        "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
        "--image_size", "16", "--max_itr", "2", "--no_diffusion",
        "--preset", "tpu", "--lpips_weights", str(tmp_path / "missing.npz"),
        "--device", "cpu", "--exp_dir", str(tmp_path)])
    assert "lpips weights not found" in capsys.readouterr().out
    assert set(results[0]["metrics"]) == {"psnr", "ssim"}
    assert set(_metrics(tmp_path / "metrics" / "any_000_c2.txt")) == {
        "psnr", "ssim"}


def test_demo_cpu_scene_batch(tmp_path, capsys):
    """``--scene_batch 2`` over three scenes of one bucket: scenes 0 and 1
    in lockstep, scene 2 through the sequential loop, all three written."""
    results = demo.main([
        "-d", "synthetic", "-c", "any", "-i", "0,1,2", "-v", "2",
        "--image_size", "16", "--max_itr", "2", "--no_diffusion",
        "--preset", "tpu", "--scene_batch", "2", "--device", "cpu",
        "--exp_dir",
        str(tmp_path)])
    assert "scene batch: [0, 1]" in capsys.readouterr().out
    assert len(results) == 3
    # the batch's two scenes share its spans (the recorder's record of
    # the batch's loop)
    assert results[0]["spans"] is results[1]["spans"]
    assert results[2]["spans"] is not results[0]["spans"]
    assert [s["name"] for s in results[0]["spans"]] == \
        [s["name"] for s in results[2]["spans"]]
    for i, r in enumerate(results):
        assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
        assert set(_metrics(tmp_path / "metrics" / f"any_00{i}_c2.txt")) \
            == {"psnr", "ssim"}
        assert (tmp_path / f"any_00{i}_c2_ngp.npz").exists()
