"""Zero-1-to-3 as the port's fusion prior (``nn/zero123.py``,
``models.py::Zero123Models``, ldm's schedule in ``diffusion/schedule.py``)
held on the CPU in f32 against the benchmark's plain reference
(``portbench/reference/zero123.py``) on seeded weights: the UNet and the
CLIP tower at a tiny width, Phase A's conditioning, and the first
iterations of the distillation loop through the prior, eager and fused;
the published widths on the meta device; the single-key cross-attention;
the relative pose on hand-worked cameras; the schedule at ldm's integer
steps."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from portbench import scenes, weights
from portbench.reference import zero123 as ref
from sparsefusion_tpu_torch.diffusion.schedule import GaussianDiffusion
from sparsefusion_tpu_torch.distill.loop import (
    DistillConfig,
    build_feature_cache,
    distillation_loop,
)
from sparsefusion_tpu_torch.models import (
    build_zero123_models,
    narrow_zero123_configs,
)
from sparsefusion_tpu_torch.nn import zero123 as z
from sparsefusion_tpu_torch.nn.eft import EFTConfig
from sparsefusion_tpu_torch.nn.ngp import NGPConfig
from sparsefusion_tpu_torch.utils import spans

torch.set_num_threads(2)

NARROW = narrow_zero123_configs()
TINY_NGP = dict(num_levels=4, log2_hashmap_size=10, hidden_dim=16)
TINY_DISTILL = dict(num_steps=8, upsample_steps=8, max_ray_batch=64,
                    plms_steps=4, n_aug_cameras=4, cond_scale=3.0,
                    start_fusion_step=0, lambda_percep=0.0)


def _sizes() -> dict:
    return {"eft": dataclasses.asdict(EFTConfig()),
            "vae": dataclasses.asdict(NARROW["vae_config"]),
            "zero123": dataclasses.asdict(NARROW["unet_config"]),
            "clip": dataclasses.asdict(NARROW["clip_config"]),
            "ddpm": dataclasses.asdict(NARROW["ddpm_config"])}


def _pair(seed: int = 11):
    """The port's tiny bundle and the reference's, with the same seeded
    weights (EFT, VAE, UNet, CLIP, ``cc_projection``)."""
    port = build_zero123_models(torch.Generator().manual_seed(0), "cpu",
                                **NARROW)
    for k, m in enumerate((port.eft, port.vae, port.unet, port.clip,
                           port.cc_projection)):
        weights.fill(m, seed + k)
    fills = iter(range(seed, seed + 5))
    reference = ref.build_models(_sizes(),
                                 lambda m: weights.fill(m, next(fills)),
                                 "cpu")
    return port, reference


def _close(a, b, tol=1e-5):
    a, b = a.detach().double(), b.detach().double()
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) / scale < tol, \
        float((a - b).abs().max()) / scale


@pytest.mark.parametrize("keep", [True, False])
def test_unet_against_the_reference(keep):
    """The tiny UNet through the bundles' ``denoise_fn``, conditioned and
    with the conditioning dropped (a zero token and latent)."""
    port, reference = _pair()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 8, 8, generator=g)
    t = torch.tensor([12.5, 871.0])
    cond = (torch.randn(2, 1, 32, generator=g),
            torch.randn(2, 4, 8, 8, generator=g))
    mask = torch.full((2,), keep)
    with torch.no_grad():
        a = port.denoise_fn(x, t, cond, mask)
        b = reference.denoise_fn(x, t, cond, mask)
    _close(a, b)
    if not keep:
        with torch.no_grad():
            zero = port.denoise_fn(x, t, tuple(map(torch.zeros_like, cond)),
                                   None)
        assert torch.equal(a, zero)


def test_clip_tower_against_the_reference():
    port, reference = _pair()
    img = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    size = NARROW["clip_config"].image_size
    with torch.no_grad():
        a = port.clip(z.clip_preprocess(img, size))
        b = reference.clip(ref.clip_preprocess(
            img.permute(0, 3, 1, 2) * 2 - 1, size))
    _close(a, b)


def test_published_widths_on_the_meta_device():
    with torch.device("meta"):
        unet = z.Zero123UNet()
        clip = z.CLIPImageEncoder()
    assert sum(p.numel() for p in unet.parameters()) == 859_532_484
    assert sum(p.numel() for p in clip.parameters()) == 303_966_208
    heads = [(m.transformer_blocks[0].attn1.to_q.out_features,
              m.transformer_blocks[0].attn1.heads)
             for m in unet.modules() if isinstance(m, z.SpatialTransformer)]
    assert len(heads) == 16
    assert sorted({w // h for w, h in heads}) == [40, 80, 160]
    assert {h for _, h in heads} == {8}
    # the checkpoint's names: input 8 channels, the first transformer
    sd = unet.state_dict()
    assert sd["input_blocks.0.0.weight"].shape == (320, 8, 3, 3)
    assert sd["input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight"] \
        .shape == (320, 768)


def test_single_key_cross_attention_is_the_full_softmax():
    torch.manual_seed(0)
    port = z.CrossAttention(24, 3, 8, context_dim=16)
    full = ref.CrossAttention(24, context_dim=16, heads=3, dim_head=8)
    full.load_state_dict(port.state_dict())
    x, ctx = torch.randn(2, 10, 24), torch.randn(2, 1, 16)
    self_port = z.CrossAttention(24, 3, 8)
    self_full = ref.CrossAttention(24, heads=3, dim_head=8)
    self_full.load_state_dict(self_port.state_dict())
    with torch.no_grad():
        _close(port(x, ctx), full(x, ctx), 1e-6)
        # self-attention takes the full path in both
        _close(self_port(x), self_full(x), 1e-6)


@pytest.mark.parametrize("target, cond, want", [
    # on the horizon, a quarter turn apart: azimuth atan2(-z, x)
    ((0.0, 0.0, 2.0), (2.0, 0.0, 0.0), (0.0, -1.0, 0.0, 0.0)),
    # 45 degrees above the horizon against on it, the same azimuth
    ((1.0, 1.0, 0.0), (2.0, 0.0, 0.0),
     (-math.pi / 4, 0.0, 1.0, math.sqrt(2) - 2.0)),
    # below the horizon, nearer, the same azimuth
    ((0.5, -3.0, 0.0), (1.0, 0.0, 0.0),
     (math.atan2(0.5, -3.0) - math.pi / 2, 0.0, 1.0, math.sqrt(9.25) - 1.0)),
])
def test_relative_pose_on_hand_worked_cameras(target, cond, want):
    got = z.relative_pose(torch.tensor([target]), torch.tensor([cond]))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(ref.get_T(target, cond).numpy(), want,
                               atol=1e-6)


def test_schedule_is_ldms_alphas_cumprod():
    sched = GaussianDiffusion("ldm_linear", 1000)
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2
    ac = np.cumprod(1.0 - betas)
    n = np.array([0, 1, 10, 250, 500, 998, 999])
    t = torch.tensor(n / 999.0, dtype=torch.float32)
    np.testing.assert_allclose(torch.sigmoid(sched.log_snr(t)).numpy(),
                               ac[n], rtol=2e-6)
    np.testing.assert_allclose(sched.get_condition(t).numpy(), n, atol=1e-4)
    # between two steps: alphas_cumprod interpolated linearly
    mid = torch.tensor([(250.5) / 999.0])
    assert float(torch.sigmoid(sched.log_snr(mid))) == pytest.approx(
        (ac[250] + ac[251]) / 2, rel=1e-5)


def _scene():
    scene = scenes.blob_scene(5, 4, 32, "cpu")
    from portbench.common import port_scene

    return scene, port_scene(scene), [0, 2]


def test_phase_a_conditioning_against_the_reference():
    """Each cached camera's token and concat latent: the nearest input
    view's CLIP embedding with the pose through ``cc_projection``, and its
    latent mode."""
    port, reference = _pair()
    scene, pscene, idx = _scene()
    cfg = DistillConfig(**TINY_DISTILL, ngp=NGPConfig(**TINY_NGP))
    cams = pscene.cameras("cpu")
    rgb = torch.as_tensor(pscene.images)
    cache = build_feature_cache(port, cams, rgb, idx, cfg, 32)
    token, concat = cache["features"]
    assert token.shape == (8, 1, 32) and concat.shape == (8, 4, 4, 4)
    want = ref.conditioning(reference, scene.cameras("cpu"), rgb, idx,
                            dataclasses.asdict(cfg), range(8))
    for ci in range(8):
        _close(token[ci], want[ci][0])
        _close(concat[ci], want[ci][1])


@pytest.mark.parametrize("fused", [False, True])
def test_fusion_steps_against_the_reference(fused, monkeypatch):
    """Iteration 0 bootstraps, iterations 1 and 2 run the fusion step
    through Zero123 at guidance 3 (the demo's ``--prior zero123``; the
    loop's draws give iteration 1 no sampler step and iteration 2 four,
    ten evaluations): every loss,
    the sampler's output and the field's end state against the
    reference's, with ``fused_steps`` False (the programs uncaptured on
    any device) and True."""
    port, reference = _pair()
    scene, pscene, idx = _scene()
    cfg = DistillConfig(**TINY_DISTILL, ngp=NGPConfig(**TINY_NGP),
                        max_itr=3, fused_steps=fused)
    got = {}

    def hook(itr):
        import sys

        loc = sys._getframe(1).f_locals
        if itr == 2:
            got["losses"] = loc["loss_log"][:, :3].t().reshape(-1).tolist()
            got["field"] = {n: p.detach().clone()
                            for n, p in loc["field"].named_parameters()}

    rings = []
    monkeypatch.setattr(spans, "use_device",
                        lambda device, slots=spans.SLOTS: rings.append(slots))
    distillation_loop(port, pscene, idx, cfg,
                      torch.Generator().manual_seed(7), verbose=False,
                      iteration_hook=hook)
    # 64 stamps an evaluation: the loop asks for the bundle's larger ring
    assert rings[0] == port.span_slots > spans.SLOTS
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name != "ngp"}
    out = ref.follow_distillation(reference, scene, idx, d, TINY_NGP,
                                  torch.Generator().manual_seed(7), 3, 0, 1,
                                  "cpu")
    np.testing.assert_allclose(got["losses"], out["losses"], rtol=1e-4)
    assert port.unet_evals == 10 and len(out["targets"]) == 2
    for n, p in out["end"].items():
        _close(got["field"][n], p, 1e-3)


def test_demo_runs_a_scene_through_zero123(tmp_path):
    """``cli/demo.py --prior zero123`` on the CPU: Phase A with the
    conditioning, a bootstrap and two fusion iterations through the narrow
    Zero123 at guidance 3; ``vldm`` stays the default."""
    from sparsefusion_tpu_torch.cli import demo

    assert demo.parse_args(["-c", "any"]).prior == "vldm"
    argv = ["-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
            "--image_size", "32", "--max_itr", "3", "--start_fusion", "0",
            "--device", "cpu", "--exp_dir", str(tmp_path),
            "--prior", "zero123"]
    r = demo.main(argv)[0]
    assert len(r["fusion_losses"]) == 3
    assert np.isfinite(r["fusion_losses"]).all()
    assert r["unet_evals"] > 0
    with pytest.raises(ValueError, match="one scene at a time"):
        demo.main(argv + ["--scene_batch", "2"])
