"""The port's train CLI on the CPU: checkpoints, resume, and the device
it refuses (``--bf16``: ``test_torch_train_bf16.py``).

A run of 3 steps (checkpoint at step 2 and at the end) resumed for a 4th
step ends with the same parameters, optimizer state and guard counts as
an uninterrupted 4-step run: the checkpoint carries the random states of
the host draws and of the step's generator, so the resumed step draws
what the uninterrupted one drew.
"""
import numpy as np
import pytest
import torch

from sparsefusion_tpu_torch.cli import train
from sparsefusion_tpu_torch.train.checkpoints import (
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(2)

TINY = ["-c", "any", "-d", "synthetic", "--preset", "tiny",
        "--image_size", "64", "--context_size", "2",
        "--diffusion_batch_size", "2", "--vis_itr", "0", "--device", "cpu"]


def _run(exp_dir, steps, *extra):
    return train.main(TINY + ["--exp_dir", str(exp_dir), "--steps",
                              str(steps), "--save_itr", "2", *extra])


def test_resume_continues_as_an_uninterrupted_run(tmp_path):
    first = _run(tmp_path / "a", 3)
    assert first["start_step"] == 0 and len(first["losses"]) == 3
    assert np.isfinite(first["losses"]).all()
    assert first["unet_evals"] == 3 and first["params_without_grad"] == 0
    assert first["notfinite"] == {"unet": 0, "eft": 0}
    ckpt = tmp_path / "a" / "sf" / "any" / "ckpt_latest"
    assert restore_checkpoint(str(ckpt))["step"] == 3

    resumed = _run(tmp_path / "a", 4, "--resume", str(ckpt))
    assert resumed["start_step"] == 3 and len(resumed["losses"]) == 1
    whole = _run(tmp_path / "b", 4)
    assert resumed["losses"] == whole["losses"][3:]

    got = restore_checkpoint(str(ckpt))
    want = restore_checkpoint(str(tmp_path / "b" / "sf" / "any" /
                                  "ckpt_latest"))
    assert got["step"] == want["step"] == 4
    for model in ("unet", "eft"):
        for name, value in want[model].items():
            assert torch.equal(got[model][name], value), (model, name)
    for opt in ("unet_opt", "eft_opt"):
        assert got[opt]["notfinite"] == want[opt]["notfinite"] == 0
        assert got[opt]["schedule"]["last_epoch"] == 4
        for i, state in want[opt]["adam"]["state"].items():
            for key, value in state.items():
                assert torch.equal(got[opt]["adam"]["state"][i][key],
                                   value), (opt, i, key)


def test_checkpoint_round_trip(tmp_path):
    state = {"step": 7, "w": torch.arange(6.0).reshape(2, 3),
             "rng": [{"host": np.random.RandomState(3).get_state()}]}
    path = tmp_path / "sub" / "ckpt_latest"
    save_checkpoint(str(path), state)
    save_checkpoint(str(path), dict(state, step=8))   # replaced in place
    back = restore_checkpoint(str(path))
    assert back["step"] == 8
    assert torch.equal(back["w"], state["w"])
    host = np.random.RandomState()
    host.set_state(back["rng"][0]["host"])
    assert host.randint(1000) == np.random.RandomState(3).randint(1000)
    assert sorted(p.name for p in path.parent.iterdir()) == ["ckpt_latest"]


def test_refuses_cuda_without_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-c", "any", "-d", "synthetic", "--exp_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)              # cuda is the default device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv + ["--device", "cuda"])
    assert not any(tmp_path.iterdir())
