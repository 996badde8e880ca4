"""The cell whose sampler's UNet runs in bf16 (``distill-fusion-bf16``):
its configuration against ``sf-distill``'s, the sampler's outputs that
its check compares (``target_gap``), the fp8 control that has to fail
it, and its share of the split peak.  Its run and its faults go through
``test_portbench_cells.py`` and ``test_portbench_faults.py``."""
import json
import math

import pytest
import torch

from portbench import spec
from portbench.tests.tiny import run_tiny, tiny_checkout
from portbench.trace import Trace

CELL = "distill-fusion-bf16"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_checkout(tmp_path_factory.mktemp("tiny"))


def test_config_is_sf_distill_with_the_bf16_sampler():
    """Every size as in ``sf-distill``; only the sampler's precision, the
    fused programs it runs on the card by default, and the text that says
    so differ."""
    configs = spec.HERE / "configs"
    base = json.loads((configs / "sf-distill.json").read_text())
    bf16 = json.loads((configs / "sf-distill-bf16.json").read_text())
    assert bf16.pop("sampler_precision") == "bfloat16"
    assert bf16["distill"].pop("sampler_bf16") is True
    assert bf16["distill"].pop("fused_steps") is True
    assert base["distill"].pop("sampler_bf16") is False
    for key in ("name", "deployment"):
        assert bf16.pop(key) != base.pop(key)
    assert bf16 == base
    cell = spec.find_cell(CELL)
    assert cell.config["name"] == "sf-distill-bf16"
    assert [m["name"] for m in cell.end_to_end] == [
        "distill_it_per_s", "peak_gib", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert "mfu.fusion_bf16" in names and "mfu.distill" not in names


def test_check_reads_the_samplers_outputs(tiny):
    """The bf16 sampler's outputs read above the f32 reference; the f32
    cell's own check names no ``target_gap``."""
    r = run_tiny(tiny, CELL, 2 ** 31 + 11)
    assert 0 < r["checks"]["target_gap"]["value"] <= \
        r["checks"]["target_gap"]["limit"]
    assert "target_gap" not in run_tiny(tiny, "distill-fusion", 5)["checks"]


def test_target_gap_needs_every_output():
    from portbench.run import compare

    x = torch.ones(1, 4, 2, 2, dtype=torch.float64)
    ref = {"losses": [1.0], "moment": {"a": 1.0}, "change": {"a": 1.0},
           "targets": [x, x]}
    prog = dict(ref, targets=[x, 1.5 * x])
    limits = dict.fromkeys(("loss_gap", "grad_gap", "change_gap",
                            "target_gap"), 1.0)
    # 0.5 |x| off in one of two outputs of |x|: 0.5 / sqrt(2) together
    assert compare(prog, ref, limits)["target_gap"]["value"] == \
        pytest.approx(0.5 / math.sqrt(2))
    assert compare(dict(ref, targets=[x]), ref, limits)[
        "target_gap"]["value"] == math.inf
    assert "target_gap" not in compare(prog, ref, dict(
        loss_gap=1.0, grad_gap=1.0, change_gap=1.0))


def test_sampler_output_comes_from_the_fused_programs():
    from portbench.drivers.distill import sampler_output

    class Programs:
        buffers = {"x": torch.tensor([[-20.0, 3.0]])}

    ddpm = {"clip_output": True, "clip_value": 10.0}
    out = sampler_output(Programs, ddpm)
    assert out.dtype == torch.float64 and out.tolist() == [[-10.0, 3.0]]
    with pytest.raises(RuntimeError, match="fused_steps"):
        sampler_output(None, ddpm)


def test_fp8_round():
    """e4m3 keeps 3 bits of mantissa: a relative error of 2^-4 at most
    above its least normal; the largest magnitude maps to 448 and back."""
    from portbench.fp8 import fp8_round

    t = torch.tensor([0.3, -1.7, 1e-9, 2.5])
    r = fp8_round(t)
    assert r.dtype == t.dtype and not torch.equal(r, t)
    assert r[3].item() == pytest.approx(2.5) and r[2] == 0.0
    assert torch.allclose(r, t, rtol=2 ** -4, atol=1e-6)
    assert torch.equal(fp8_round(torch.zeros(3)), torch.zeros(3))


def test_fp8_control_is_not_correct(tiny):
    """Unlike TF32, which the CPU does not have, fp8 rounding changes the
    reference's numbers here, and its sampler's outputs fail the check;
    the TF32 scope reads 0."""
    from portbench.control import control_readings

    limits = spec.find_cell(CELL, tiny, tiny / "portbench").traffic["limits"]
    got = control_readings(CELL, 5, "cpu", tiny, tiny / "portbench",
                           scopes=("fp8_unet", "diffusion"))
    assert got["fp8_unet"]["loss_gap"] > 0
    assert got["fp8_unet"]["target_gap"] > limits["target_gap"], got
    assert got["diffusion"] == dict.fromkeys(limits, 0.0)
    with pytest.raises(ValueError, match="distillation"):
        control_readings("train-f32", 5, "cpu", tiny, tiny / "portbench",
                         scopes=("fp8_unet",))


def test_mfu_fusion_bf16_reads_the_split_peak(monkeypatch):
    """Hand-worked: 3 evaluations of 9.89 TFLOP at 989 TFLOP/s are 30 ms,
    the other 2.68 TFLOP of the two iterations at 67 TFLOP/s 40 ms: 70 ms
    of a 350 ms window is 20%."""
    from portbench import spans

    monkeypatch.setattr(spans, "distill_counts", lambda config: {
        "renders": 0.67e12, "vae": 1.34e12, "unet": 9.89e12,
        "k1_points": 0})
    read = spec.metric_reader("mfu.fusion_bf16")
    config = {"precision": "float32", "tf32": False,
              "sampler_precision": "bfloat16"}
    units = [{"ops": 0.67e12 + 1.34e12 + 3 * 9.89e12, "k1_s": 0.0},
             {"ops": 0.67e12, "k1_s": 0.0}]
    tr = Trace(0.35, 0.3, {}, {}, [], units)
    assert read({"trace": tr, "config": config}) == pytest.approx(20.0)
    # a sampler in f32 reads the one peak
    f32 = dict(config, sampler_precision="float32")
    assert read({"trace": tr, "config": f32}) == pytest.approx(
        100 * 32.35e12 / 67e12 / 0.35)
    assert read({"trace": None, "config": config}) is None
    empty = Trace(0.35, 0.3, {}, {}, [], [])
    assert read({"trace": empty, "config": config}) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fp8_control_is_not_correct_on_the_card(card, tiny):
    from portbench.control import control_readings

    limits = spec.find_cell(CELL, tiny, tiny / "portbench").traffic["limits"]
    readings = control_readings(CELL, 5, "cuda", tiny, tiny / "portbench",
                                scopes=("fp8_unet",))["fp8_unet"]
    assert any(readings[k] > limits[k] for k in limits), readings


@pytest.mark.cuda
def test_traced_run_reads_its_metrics(card, tiny):
    from portbench.run import run_cell

    r = run_cell(CELL, 3, 1.0, True, root=tiny, bench_dir=tiny / "portbench")
    assert r["correct"], r["checks"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert 0 < r["metrics"]["mfu.fusion_bf16"]["value"] < 100
    assert "idle_pct.distill" in r["metrics"]
