"""The loop's two uses of LPIPS against the JAX package's
``distill/loop.py``: the fusion loss's perceptual term, which also turns
the subsampled fusion step off, and the Phase C ``lpips`` column.

The fusion step runs from the same NGP parameters, LPIPS weights (one
synthesized ``vgg16.pth`` / ``lpips_vgg.pth`` pair, read by each side's
``build_lpips_fn``), render draws (replayed from the JAX key) and target.
The target (VAE, PLMS, VAE) is the port's on both sides: it is held
against the JAX sampler in ``test_torch_fusion``.  Tolerances are the
fusion step's there and the renderer's: the loss to 1e-4 relative, each
gradient to 1.7e-2 relative (Frobenius).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.data.synthetic import make_synthetic_scene
from sparsefusion_tpu.distill import loop as jloop
from sparsefusion_tpu.nn.lpips import build_lpips_fn as jax_build_lpips_fn
from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.render.volume import (
    VolumeRendererConfig as JVolumeRendererConfig,
)
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.data.synthetic import (
    make_synthetic_scene as port_synthetic_scene,
)
from sparsefusion_tpu_torch.distill import loop as tloop
from sparsefusion_tpu_torch.models import build_models, narrow_model_configs
from sparsefusion_tpu_torch.nn.lpips import build_lpips_fn
from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPField, load_jax_params
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig
from tests.test_torch_fusion import _replay_chunk_draws
from tests.test_torch_lpips import synthesized_state_dicts

torch.set_num_threads(2)

NGP_KW = dict(num_levels=4, log2_hashmap_size=10)
STEP_KW = dict(num_steps=8, upsample_steps=8, max_ray_batch=128,
               plms_steps=4)
HW, IMAGE_SIZE = 16, 32
MT = 0.3
LOSS_TOL = 1e-4
GRAD_TOL = 1.7e-2


@pytest.fixture(scope="module")
def lpips_spec(tmp_path_factory):
    """A synthesized 'vgg16.pth,lpips_vgg.pth' pair."""
    d = tmp_path_factory.mktemp("lpips")
    vgg, lin = synthesized_state_dicts()
    torch.save(vgg, d / "vgg16.pth")
    torch.save(lin, d / "lpips_vgg.pth")
    return f"{d / 'vgg16.pth'},{d / 'lpips_vgg.pth'}"


def _narrow_models():
    g = torch.Generator().manual_seed(0)
    models = build_models(g, "cpu", **narrow_model_configs())
    with torch.no_grad():   # a zero final conv would hide the UNet
        models.unet.final_conv.weight.normal_(0.0, 0.1, generator=g)
    return models


def test_fusion_step_with_perceptual_term_matches_jax(lpips_spec):
    jcfg = jloop.DistillConfig(ngp=JNGPConfig(**NGP_KW), **STEP_KW)
    tcfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), **STEP_KW)
    scene = make_synthetic_scene(n_views=2, image_size=IMAGE_SIZE, seed=0)
    jlp = jax_build_lpips_fn(lpips_spec)
    tlp = build_lpips_fn(lpips_spec, "cpu")
    jfield = JNGPField(jcfg.ngp)
    params = jax.jit(jfield.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((8, 3)))["params"]
    jsteps = jloop.make_scene_step_fns(jfield, jcfg,
                                       jloop.make_ngp_optimizer(jcfg), HW,
                                       IMAGE_SIZE, lpips_fn=jlp)
    assert jsteps.use_percep

    field = NGPField(tcfg.ngp)
    load_jax_params(field, jax.tree_util.tree_map(np.asarray, dict(params)))
    tsteps = tloop.make_scene_step_fns(
        field, tcfg, tloop.make_ngp_optimizer(tcfg, field), HW, IMAGE_SIZE,
        lpips_fn=tlp, models=_narrow_models())
    assert tsteps.use_percep
    tv = VolumeRendererConfig(num_steps=8, upsample_steps=8,
                              max_ray_batch=128)
    jv = JVolumeRendererConfig(num_steps=8, upsample_steps=8,
                               max_ray_batch=128)
    jc = jax.jit(lambda c: jcam.get_camera_slice(jcam.get_relative_cameras(
        c, [0], center_at_origin=False), [1]))(scene.cameras())
    tc = tcam.get_camera_slice(tcam.get_relative_cameras(
        tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                            scene.image_size), [0], center_at_origin=False),
        [1])

    key = jax.random.PRNGKey(11)
    draws = _replay_chunk_draws(key, HW * HW, 128)
    rng = np.random.RandomState(2)
    draws["plms_noise"] = [torch.tensor(rng.randn(1, 4, 4, 4),
                                        dtype=torch.float32)
                           for _ in range(4)]
    features = torch.tensor(rng.randn(256, 4, 4), dtype=torch.float32)
    with torch.no_grad():
        img, _ = tsteps.render_up(tv, tc, draws=draws)
        pred, weight = tsteps.fusion_target(img, features, MT,
                                            plms_noise=draws["plms_noise"])
    loss_j, g_j = jax.jit(jax.value_and_grad(jsteps.fusion_losses,
                                             argnums=1), static_argnums=0)(
        jv, params, jc, jnp.asarray(pred.numpy()), float(weight), key,
        jnp.zeros((8,), jnp.uint8))
    loss_t = tsteps.fusion_losses(tv, tc, features, MT, draws=draws)
    loss_t.backward()

    # the perceptual term is a real part of the loss
    with torch.no_grad():
        percep = tcfg.lambda_percep * float(tlp(img[None], pred[None]))
    assert percep > 1e-3 * loss_t.item()
    assert float(loss_t) == pytest.approx(float(loss_j), rel=LOSS_TOL)
    want = {"grid": np.asarray(g_j["grid"])}
    for name, layer in g_j.items():
        if name != "grid":
            want[f"{name}.weight"] = np.asarray(layer["kernel"]).T
            want[f"{name}.bias"] = np.asarray(layer["bias"])
    for name, p in field.named_parameters():
        rel = np.linalg.norm(p.grad.numpy() - want[name]) \
            / np.linalg.norm(want[name])
        assert rel <= GRAD_TOL, (name, rel)


def test_tpu_preset_with_lpips_renders_the_full_grid():
    """``use_percep`` turns the subsampled fusion step off, in both
    packages: the TPU preset's fusion steps take their gradient on the
    full render, through the perceptual term at the image size."""
    seen = []

    def fake_lpips(a, b):
        seen.append(tuple(a.shape))
        return (a - b).abs().mean(dim=(1, 2, 3))

    kw = dict(max_itr=3, start_fusion_step=0, n_aug_cameras=2,
              fusion_rays=64, input_rays=64, occupancy_start=10 ** 9,
              num_steps=8, upsample_steps=8, max_ray_batch=128,
              plms_steps=4)
    jcfg = jloop.tpu_distill_config(ngp=JNGPConfig(**NGP_KW), **kw)
    jsteps = jloop.make_scene_step_fns(JNGPField(jcfg.ngp), jcfg,
                                       jloop.make_ngp_optimizer(jcfg), HW,
                                       IMAGE_SIZE, lpips_fn=fake_lpips)
    assert jsteps.use_percep and not jsteps.subsample_fusion

    cfg = tloop.tpu_distill_config(ngp=NGPConfig(**NGP_KW), **kw)
    scene = port_synthetic_scene(n_views=3, image_size=IMAGE_SIZE, seed=0)
    out = tloop.distillation_loop(_narrow_models(), scene, [0, 1], cfg,
                                  torch.Generator().manual_seed(0),
                                  verbose=False, lpips_fn=fake_lpips)
    # iterations 1 and 2 fuse; then Phase C's column over the 3 views
    assert out["fusion_subset_steps"] == 0
    assert seen == [(1, IMAGE_SIZE, IMAGE_SIZE, 3)] * 2 \
        + [(3, IMAGE_SIZE, IMAGE_SIZE, 3)]
    assert np.isfinite(out["fusion_losses"]).all()


def test_loop_reports_lpips(tmp_path, capsys):
    """Phase C's ``lpips`` column: one batched call over all views against
    the scene's images, in the summary, the printed line and the metrics
    file (after ``tests/test_round2_wiring.py``)."""
    scene = port_synthetic_scene(n_views=3, image_size=IMAGE_SIZE, seed=0)
    cfg = tloop.DistillConfig(
        max_itr=2, start_fusion_step=10 ** 9, n_aug_cameras=2,
        num_steps=8, upsample_steps=8, max_ray_batch=512,
        ngp=NGPConfig(**NGP_KW))
    calls = []

    def fake_lpips(a, b):
        calls.append((a.shape, b.shape))
        return (a - b).abs().mean(dim=(1, 2, 3))

    out = tloop.distillation_loop(None, scene, [0, 1], cfg,
                                  torch.Generator().manual_seed(1),
                                  save_dir=str(tmp_path),
                                  use_diffusion=False, lpips_fn=fake_lpips)
    assert calls == [((3, IMAGE_SIZE, IMAGE_SIZE, 3),) * 2]
    want = np.abs(out["renders"] - scene.images).mean(axis=(1, 2, 3))
    assert out["metrics"]["lpips"] == pytest.approx(float(want.mean()),
                                                    rel=1e-6)
    assert f"lpips: {out['metrics']['lpips']:.3f}" in capsys.readouterr().out
    with open(tmp_path / "metrics" / "synthetic_000.txt") as fp:
        fp.readline()
        metrics = json.loads(fp.read())
    assert list(metrics) == ["psnr", "ssim", "lpips"]
    assert np.isfinite(metrics["lpips"])
