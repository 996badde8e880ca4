"""The Zero123 cell (``distill-fusion-z123``): its configuration at the
published widths, its run and faults at a size the CPU runs in seconds,
its readers on a recorded span set, and ``flops_z123`` against a count of
the meta model's convolutions and linears."""
import dataclasses
import json

import pytest
import torch

from portbench import faults, flops_z123, spec
from portbench.run import run_cell
from portbench.tests.tiny import (
    TINY_DISTILL,
    TINY_NGP,
    run_tiny,
    tiny_checkout,
)
from portbench.trace import Trace

CELL = "distill-fusion-z123"
CONFIG = "configs/zero123/z123-distill.json"
TINY_Z123 = {
    "zero123": {"model_channels": 32, "channel_mult": [1, 2],
                "attention_resolutions": [1, 2], "num_heads": 2,
                "context_dim": 32, "clip_embed_dim": 16},
    "clip": {"image_size": 28, "width": 32, "layers": 2, "heads": 2,
             "output_dim": 16},
    "vae": {"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1},
    "ddpm": {"image_size": 4},
}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny_checkout(tmp_path_factory.mktemp("tiny"))
    path = root / "portbench" / CONFIG
    c = json.loads(path.read_text())
    c["image_size"], c["n_views"] = 32, 4
    for k, v in TINY_Z123.items():
        c[k].update(v)
    c["distill"].update(TINY_DISTILL)
    c["ngp"].update(TINY_NGP)
    path.write_text(json.dumps(c))
    return root


def test_config_at_the_published_widths():
    """zero123's UNet and CLIP ViT-L/14 as published; the distillation as
    ``sf-distill``'s but the guidance scale and the fused programs stated;
    the EFT, VAE and field as ``sf-distill``'s."""
    c = json.loads((spec.HERE / CONFIG).read_text())
    base = json.loads((spec.HERE / "configs/sf-distill.json").read_text())
    assert c["zero123"] == {
        "in_channels": 8, "out_channels": 4, "model_channels": 320,
        "channel_mult": [1, 2, 4, 4], "num_res_blocks": 2,
        "attention_resolutions": [4, 2, 1], "num_heads": 8,
        "transformer_depth": 1, "context_dim": 768, "clip_embed_dim": 768,
        "pose_dim": 4}
    assert c["clip"] == {"image_size": 224, "patch_size": 14, "width": 1024,
                         "layers": 24, "heads": 16, "output_dim": 768}
    d = dict(c["distill"])
    assert d.pop("cond_scale") == 3.0 and d.pop("fused_steps") is True
    base["distill"].pop("cond_scale")
    assert d == base["distill"]
    for key in ("ngp", "vae", "eft", "image_size", "n_views", "input_views",
                "reduced"):
        assert c[key] == base[key]
    assert c["ddpm"]["noise_schedule"] == "ldm_linear"
    assert c["ddpm"]["timesteps"] == 1000
    cell = spec.find_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == [
        "distill_it_per_s", "peak_gib", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "unet_ms_per_eval.z123", "st_pct.z123", "mfu.fusion_z123"]


def test_cell_runs_correct(tiny):
    r = run_tiny(tiny, CELL, 2 ** 31 + 19)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                "target_gap"}
    assert 0 < r["checks"]["target_gap"]["value"] <= \
        r["checks"]["target_gap"]["limit"]


def test_reference_against_itself(tiny):
    """The control on the CPU (where TF32 does nothing) is the f32
    reference against itself."""
    from portbench.drivers.distill_z123 import control_readings

    limits = spec.find_cell(CELL, tiny, tiny / "portbench").traffic["limits"]
    got = control_readings(CELL, 5, "cpu", ("unet",), tiny,
                           tiny / "portbench")
    assert got == {"unet": dict.fromkeys(limits, 0.0)}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(tiny, fault):
    r = run_cell(CELL, 23, 0.2, False, device="cpu", root=tiny,
                 bench_dir=tiny / "portbench",
                 around_program=faults.planted(fault))
    assert not r["correct"], r["checks"]


def _span(sid, name, d0, d1, unit=7, parent=None, kind="span", counts=None):
    return {"id": sid, "name": name, "kind": kind, "parent": parent,
            "unit": unit, "t0": 0, "t1": 1, "d0": d0, "d1": d1,
            "counts": counts or {}, "profiled": True, "slots": [None, None]}


def test_readers_on_a_recorded_span_set():
    """Two UNet evaluations of 10 ms, each with transformers of 2 and 1.5
    ms, in the one traced unit; the window 1 s."""
    read = {n: spec.metric_reader(n) for n in (
        "unet_ms_per_eval.z123", "st_pct.z123", "mfu.fusion_z123")}
    ms = 1_000_000
    spans = [_span(1, "distill/iteration", 0, 100 * ms, kind="unit")]
    for k, at in enumerate((0, 50)):
        base = 2 + 10 * k
        spans += [_span(base, "unet", at * ms, (at + 10) * ms,
                        counts={"st_tokens": 1360}),
                  _span(base + 1, "st", at * ms, (at + 2) * ms, parent=base),
                  _span(base + 2, "attn1", at * ms, (at + 1) * ms,
                        parent=base + 1),
                  _span(base + 3, "st", (at + 5) * ms, (at + 6.5) * ms,
                        parent=base)]
    units = [{"ops": 6.7e12, "k1_s": 0.0, "unet_evals": 2}]
    ctx = {"trace": Trace(1.0, 0.9, {}, {}, [], units), "spans": spans,
           "config": {"precision": "float32", "tf32": False}}
    assert read["unet_ms_per_eval.z123"](ctx) == pytest.approx(10.0)
    assert read["st_pct.z123"](ctx) == pytest.approx(35.0)
    assert read["mfu.fusion_z123"](ctx) == pytest.approx(10.0)
    # a program without the transformers' spans: nothing read, no raise
    no_st = {**ctx, "spans": [s for s in spans if s["name"] != "st"]}
    assert read["st_pct.z123"](no_st) is None
    empty = {"trace": None, "config": ctx["config"], "spans": None}
    assert all(r(empty) is None for r in read.values())


def test_iteration_work_counts_both_guided_branches():
    from portbench.drivers.distill_z123 import iteration_work

    c = json.loads((spec.HERE / CONFIG).read_text())
    boot = iteration_work(c, 0.5, False)
    fusion = iteration_work(c, 0.5, True)
    assert boot["unet_evals"] == 0
    # 0.5 * 50 * 2 = 50 steps: 51 evaluations, twice under guidance
    assert fusion["unet_evals"] == 102
    unet = flops_z123.unet_fwd(c["zero123"])
    assert fusion["ops"] - boot["ops"] > 102 * unet


def _meta_count(cfg) -> dict:
    """Convolutions and linears of one batch-1 evaluation by forward
    hooks on the meta model, two operations a multiply-add; the
    self-attention products; a single-token cross-attention as its value
    projection and one ``to_out``."""
    from torch import nn

    from portbench.reference.zero123 import (
        CrossAttention,
        UNetConfig,
        UNetModel,
    )

    with torch.device("meta"):
        unet = UNetModel(UNetConfig(**cfg))
    got = {"conv": 0, "linear": 0, "attention": 0}
    skip = set()

    def conv(m, inp, out):
        got["conv"] += 2 * out.numel() * m.in_channels \
            * m.kernel_size[0] * m.kernel_size[1]

    def linear(m, inp, out):
        if id(m) not in skip:
            got["linear"] += 2 * out.numel() * m.in_features

    def attn(m, inp, out):
        tokens, inner = inp[0].shape[1], m.to_q.out_features
        got["attention"] += 2 * 2 * tokens * tokens * inner

    for m in unet.modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(conv)
        elif isinstance(m, nn.Linear):
            m.register_forward_hook(linear)
    for name, m in unet.named_modules():
        if isinstance(m, CrossAttention) and name.endswith("attn1"):
            m.register_forward_hook(attn)
        elif isinstance(m, CrossAttention):
            skip.update({id(m.to_q), id(m.to_k), id(m.to_v),
                         id(m.to_out[0])})
            got["linear"] += 2 * (m.to_v.in_features * m.to_v.out_features
                                  + m.to_out[0].in_features
                                  * m.to_out[0].out_features)
    with torch.no_grad():
        unet(torch.zeros(1, cfg["in_channels"], 32, 32, device="meta"),
             torch.zeros(1, device="meta"),
             torch.zeros(1, 1, cfg["context_dim"], device="meta"))
    return got


def test_flops_against_the_meta_models_layers():
    c = json.loads((spec.HERE / CONFIG).read_text())["zero123"]
    got = _meta_count(c)
    assert flops_z123.unet_fwd(c) == sum(got.values())
    # the published model: ~111.0 GFLOP of convolutions, 7.7 of attention
    assert got["conv"] == pytest.approx(111.0e9, rel=1e-3)
    assert got["attention"] == pytest.approx(7.66e9, rel=1e-3)


def test_relative_pose_matches_the_reference():
    """The port's ``relative_pose`` and the reference's ``get_T`` on one
    pair of camera centres."""
    from portbench.reference.zero123 import get_T
    from sparsefusion_tpu_torch.nn.zero123 import relative_pose

    a, b = [1.0, 0.5, -2.0], [-0.3, 1.2, 2.5]
    port = relative_pose(torch.tensor([a]), torch.tensor([b]))[0]
    assert torch.allclose(port.double(), get_T(a, b).double(), atol=1e-6)


def test_parent_without_the_prior_fails_at_once(monkeypatch):
    """A program without the Zero123 bundle (the parent commit) stops at
    the driver's first import, before any scene or weight is made."""
    from portbench.drivers import distill_z123
    from sparsefusion_tpu_torch import models

    monkeypatch.delattr(models, "build_zero123_models")
    cell = dataclasses.replace(spec.find_cell(CELL), traffic=None)
    with pytest.raises(ImportError):
        distill_z123.run(cell, seed=1, seconds=1.0, trace=False,
                         device=torch.device("cpu"), t0=0.0)
