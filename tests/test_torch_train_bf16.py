"""Training with the UNet in bf16 (``TrainConfig(compute_dtype="bfloat16")``,
``--bf16``) against the JAX package's bf16 step, and the CLI's bf16 run.

The step: the harness of ``test_torch_train_step`` (the same weights,
scene and replayed draws on both sides, the JAX step's gradients kept as
its optimizer state), with both packages' UNets computing in bf16 on f32
master parameters.  They round at different places (XLA may keep f32
between fused bf16 operations; the attention's logits are rounded to bf16
by the JAX einsum and kept f32 by the port), so the tolerances are those
of bf16 rather than f32: losses 1e-2 relative (measured 2.2e-3), the
gradients 5e-2 relative (Frobenius over each model; measured 2.3e-2 on
the UNet, 2.6e-2 on the EFT, whose gradient comes through the bf16
UNet's conditioning input).  Every parameter, gradient and Adam moment
stays f32.

The CLI: ``--preset tiny --bf16`` on the CPU runs, and a run resumed from
its checkpoint ends where an uninterrupted run ends, bit for bit.
"""
import numpy as np
import torch

from tests.test_torch_train_cli import _run
from tests.test_torch_train_step import check_train_step_against_jax
from sparsefusion_tpu_torch.train.checkpoints import restore_checkpoint

torch.set_num_threads(2)


def test_bf16_train_step_matches_jax():
    worst, models, opts = check_train_step_against_jax(
        train_eft=True, n_scenes=1, compute_dtype="bfloat16",
        loss_rel=1e-2, grad_rel=5e-2)
    print("bf16 step, port vs JAX, relative errors:", worst)
    for m in (models.unet, models.eft):
        for p in m.parameters():
            assert p.dtype == torch.float32
            assert p.grad is not None and p.grad.dtype == torch.float32
    for opt in opts:
        for p in opt.params:
            state = opt.adam.state[p]
            assert state["exp_avg"].dtype == torch.float32
            assert state["exp_avg_sq"].dtype == torch.float32


def test_bf16_cli_resume_continues_as_an_uninterrupted_run(tmp_path):
    first = _run(tmp_path / "a", 3, "--bf16")
    assert len(first["losses"]) == 3 and np.isfinite(first["losses"]).all()
    assert first["notfinite"] == {"unet": 0, "eft": 0}
    assert first["params_without_grad"] == 0
    ckpt = tmp_path / "a" / "sf" / "any" / "ckpt_latest"
    resumed = _run(tmp_path / "a", 4, "--bf16", "--resume", str(ckpt))
    assert resumed["start_step"] == 3 and len(resumed["losses"]) == 1
    whole = _run(tmp_path / "b", 4, "--bf16")
    assert resumed["losses"] == whole["losses"][3:]
    # f32 takes the same draws to other losses from the second step on
    # (the first UNet's final conv is zero: eps = 0 in either type)
    f32 = _run(tmp_path / "c", 2)
    assert f32["losses"][0] == whole["losses"][0]
    assert f32["losses"][1] != whole["losses"][1]

    got = restore_checkpoint(str(ckpt))
    want = restore_checkpoint(str(tmp_path / "b" / "sf" / "any" /
                                  "ckpt_latest"))
    for model in ("unet", "eft"):
        for name, value in want[model].items():
            assert value.dtype == torch.float32 or not value.is_floating_point()
            assert torch.equal(got[model][name], value), (model, name)
    for opt in ("unet_opt", "eft_opt"):
        for i, state in want[opt]["adam"]["state"].items():
            for key, value in state.items():
                assert torch.equal(got[opt]["adam"]["state"][i][key],
                                   value), (opt, i, key)
