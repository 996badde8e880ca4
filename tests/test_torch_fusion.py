"""The diffusion arm of the loop as a whole: the Phase A feature cache,
one bootstrap step and one fusion step of the port against the JAX
package's, and the port's demo with the diffusion arm on the CPU.

The steps run from the same NGP parameters, the same narrow VAE and UNet
(the JAX tiny test models, final conv randomised; the JAX side gets the
port's weights through the JAX package's converters) and the same draws:
the renderer's, replayed from the JAX keys, and the PLMS sampler's
normal draws along the JAX key tree.  The JAX fusion step renders twice
with one key; the port renders once and feeds a detached copy to the
VAE, which gives the same image.  Tolerances follow the input step's
(``test_torch_distill``): losses 1e-4 relative (measured 6.6e-7
bootstrap, 4.2e-6 fusion), parameters after both updates 3e-2 of the
update (measured 1.5e-2 on the grid and the first two MLP weights,
<= 3e-3 elsewhere).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.data.synthetic import make_synthetic_scene
from sparsefusion_tpu.diffusion.ddpm import DDPM as JDDPM
from sparsefusion_tpu.diffusion.ddpm import DDPMConfig as JDDPMConfig
from sparsefusion_tpu.diffusion.plms import plms_sample as jax_plms_sample
from sparsefusion_tpu.distill import loop as jloop
from sparsefusion_tpu.models import SparseFusionModels as JModels
from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.nn.unet import EfficientUNet as JEfficientUNet
from sparsefusion_tpu.nn.unet import UNetConfig as JUNetConfig
from sparsefusion_tpu.nn.vae import AutoencoderKL as JVAE
from sparsefusion_tpu.nn.vae import VAEConfig as JVAEConfig
from sparsefusion_tpu.render.volume import (
    VolumeRendererConfig as JVolumeRendererConfig,
)
from sparsefusion_tpu.train.convert import (
    convert_unet_state_dict,
    convert_vae_state_dict,
)
from sparsefusion_tpu_torch.cli import demo
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.distill import loop as tloop
from sparsefusion_tpu_torch.models import build_models, narrow_model_configs
from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPField, load_jax_params
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig

torch.set_num_threads(2)

NGP_KW = dict(num_levels=4, log2_hashmap_size=10)
STEP_KW = dict(num_steps=8, upsample_steps=8, max_ray_batch=128,
               plms_steps=4)
HW, IMAGE_SIZE = 16, 32


def _replay_chunk_draws(key, n, chunk, num_steps=8, upsample_steps=8):
    """The draws JAX ``render_rays_chunked`` makes from ``key``."""
    jit, us = [], []
    for kk in jax.random.split(key, n // chunk):
        rng, k = jax.random.split(kk)
        jit.append(jax.random.uniform(k, (chunk, num_steps)))
        rng, k = jax.random.split(rng)
        us.append(jax.random.uniform(k, (chunk, upsample_steps)))
    return {"jitter": torch.tensor(np.asarray(jnp.concatenate(jit))),
            "u": torch.tensor(np.asarray(jnp.concatenate(us)))}


def _plms_draws(key, shape, n_steps):
    """The normal draws of the JAX ``plms_sample`` along its key tree."""
    k_init, key = jax.random.split(key)
    draws = [jax.random.normal(k_init, shape)]
    key, sub = jax.random.split(key)
    k1, k2, _ = jax.random.split(sub, 3)
    draws += [jax.random.normal(k1, shape), jax.random.normal(k2, shape)]
    for _ in range(1, n_steps):
        k1, key = jax.random.split(key)
        draws.append(jax.random.normal(k1, shape))
    return [torch.tensor(np.ascontiguousarray(
        np.transpose(np.asarray(d), (0, 3, 1, 2)))) for d in draws]


def _trio():
    """The port's narrow models (final conv randomised) and the JAX VAE and
    UNet with the same weights, through the JAX package's converters."""
    narrow = narrow_model_configs()
    g = torch.Generator().manual_seed(0)
    tmodels = build_models(g, "cpu", **narrow)
    with torch.no_grad():
        tmodels.unet.final_conv.weight.normal_(0.0, 0.1, generator=g)
        tmodels.unet.final_conv.bias.normal_(0.0, 0.1, generator=g)
    ucfg, vcfg = narrow["unet_config"], narrow["vae_config"]
    uparams = convert_unet_state_dict(
        {f"unets.0.{k}": v for k, v in tmodels.unet.state_dict().items()},
        num_levels=len(ucfg.dim_mults),
        num_resnet_blocks=ucfg.num_resnet_blocks,
        layer_attns=ucfg.layer_attns)
    vvars = convert_vae_state_dict(tmodels.vae.state_dict(),
                                   ch_mult=vcfg.ch_mult,
                                   num_res_blocks=vcfg.num_res_blocks)
    jmodels = JModels(
        eft_model=None, eft_vars=None,
        vae_model=JVAE(JVAEConfig(**vars(vcfg))), vae_vars=vvars,
        unet_model=JEfficientUNet(JUNetConfig(**vars(ucfg))),
        unet_params=uparams,
        ddpm=JDDPM(JDDPMConfig(**vars(narrow["ddpm_config"]))))
    return jmodels, tmodels


def test_bootstrap_and_fusion_steps_match_jax():
    jcfg = jloop.DistillConfig(ngp=JNGPConfig(**NGP_KW), **STEP_KW)
    tcfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), **STEP_KW)
    scene = make_synthetic_scene(n_views=2, image_size=IMAGE_SIZE, seed=0)
    rng = np.random.RandomState(3)
    eft_img = rng.rand(IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    features = rng.randn(4, 4, 256).astype(np.float32)   # NHWC (h, w, C)
    mt = 0.3   # -> min(int(0.3 * 4 * 2), 4) = 2 PLMS steps

    jmodels, tmodels = _trio()
    jfield = JNGPField(jcfg.ngp)
    params = jfield.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)))["params"]
    tx = jloop.make_ngp_optimizer(jcfg)
    opt_state = tx.init(params)
    jsteps = jloop.make_scene_step_fns(jfield, jcfg, tx, HW, IMAGE_SIZE)
    jv = JVolumeRendererConfig(num_steps=8, upsample_steps=8,
                               max_ray_batch=128)
    jc = jcam.get_camera_slice(jcam.get_relative_cameras(
        scene.cameras(), [0], center_at_origin=False), [1])
    bitfield = jnp.zeros((8,), jnp.uint8)

    field = NGPField(tcfg.ngp)
    load_jax_params(field, jax.tree_util.tree_map(np.asarray, dict(params)))
    init = {n: p.detach().numpy().copy() for n, p in field.named_parameters()}
    tsteps = tloop.make_scene_step_fns(
        field, tcfg, tloop.make_ngp_optimizer(tcfg, field), HW, IMAGE_SIZE,
        models=tmodels)
    tv = VolumeRendererConfig(num_steps=8, upsample_steps=8,
                              max_ray_batch=128)
    tc = tcam.get_camera_slice(tcam.get_relative_cameras(
        tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                            scene.image_size), [0], center_at_origin=False),
        [1])

    # bootstrap step
    key = jax.random.PRNGKey(10)
    params, opt_state, loss_j = jax.jit(jsteps.bootstrap_step,
                                        static_argnums=0)(
        jv, params, opt_state, jc, jnp.asarray(eft_img), key, bitfield)
    loss_t = tsteps.bootstrap_step(
        tv, tc, torch.tensor(eft_img),
        draws=_replay_chunk_draws(key, HW * HW, 128))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)

    # fusion step: the JAX package's split tree (fusion_step)
    k_r, _, k_s = jax.random.split(jax.random.PRNGKey(11), 3)
    img = jax.jit(jsteps.render_up_img, static_argnums=0)(
        jv, params, jc, k_r, bitfield)
    latents = jax.jit(jmodels.vae_encode)(img[None])
    pred_x0, _, _, alpha_cumprod = jax.jit(lambda k, z, c: jax_plms_sample(
        jmodels.ddpm, jmodels.denoise_fn(), k, z, mt, cond_images=c,
        plms_steps=4))(k_s, latents, jnp.asarray(features)[None])
    pred_img = jax.jit(jmodels.vae_decode)(pred_x0)[0]
    params, opt_state, loss_j = jax.jit(jsteps.fusion_grad_step,
                                        static_argnums=0)(
        jv, params, opt_state, jc, pred_img, 1.0 - alpha_cumprod[0], k_r,
        bitfield)
    draws = _replay_chunk_draws(k_r, HW * HW, 128)
    draws["plms_noise"] = _plms_draws(k_s, latents.shape, 2)
    evals0 = tmodels.unet_evals
    loss_t = tsteps.fusion_step(
        tv, tc, torch.tensor(features).permute(2, 0, 1), mt, draws=draws)
    assert tmodels.unet_evals - evals0 == 3
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)

    got = {n: p.detach().numpy() for n, p in field.named_parameters()}
    want = {"grid": np.asarray(params["grid"])}
    for name, layer in params.items():
        if name != "grid":
            want[f"{name}.weight"] = np.asarray(layer["kernel"]).T
            want[f"{name}.bias"] = np.asarray(layer["bias"])
    for name in want:
        moved = want[name] - init[name]
        rel = np.linalg.norm(got[name] - want[name]) / np.linalg.norm(moved)
        assert rel <= 3e-2, (name, rel)


def test_feature_cache_matches_jax():
    """Phase A: the port's cache against the JAX package's composition
    (``distill/loop.py`` Phase A: orbit cameras, per-camera relative
    frames, the EFT over each camera's rays, the bilinear upsample), with
    the port's EFT weights on both sides.  Tolerances as the EFT's
    (``test_torch_vae_eft``); measured 8.0e-6 on the features, 1.3e-6 on
    the images."""
    from sparsefusion_tpu.core.paths import get_interpolated_path
    from sparsefusion_tpu.nn.eft import EFTConfig as JEFTConfig
    from sparsefusion_tpu.nn.eft import EpipolarFeatureTransformer as JEFT
    from sparsefusion_tpu.ops.image import resize_bilinear
    from sparsefusion_tpu.render.lightfield import render_light_field
    from sparsefusion_tpu.train.convert import convert_eft_state_dict

    cfg = tloop.DistillConfig(n_aug_cameras=2)
    scene = make_synthetic_scene(n_views=4, image_size=IMAGE_SIZE, seed=1)
    ctx = [1, 3]
    _, tmodels = _trio()
    cache = tloop.build_feature_cache(
        tmodels, tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                                     scene.image_size),
        torch.tensor(scene.images), ctx, cfg, IMAGE_SIZE)

    jm = JEFT(JEFTConfig())
    variables = convert_eft_state_dict(tmodels.eft.state_dict())
    cams = scene.cameras()
    aug = get_interpolated_path(cams, n=2, theta_offset_max=0.17,
                                rng=np.random.RandomState(0))
    aug_rel = jcam.get_relative_cameras(jcam.concat_cameras([cams, aug]),
                                        [0], center_at_origin=True)
    min_depth, max_depth = jloop._scene_depth_range(cams)
    ctx_rgb = jnp.asarray(scene.images[ctx])

    @jax.jit
    def cache_all():
        latent = jm.apply(variables, ctx_rgb, method=JEFT.encode)

        def one(ci):
            rel = jcam.get_relative_cameras(aug_rel, ci[None],
                                            center_at_origin=True)
            c_cams = jcam.get_camera_slice(rel, jnp.asarray(ctx))
            rgb, feat = render_light_field(
                lambda o, d, ln: jm.apply(variables, o, d, ln, c_cams,
                                          ctx_rgb, latent),
                jcam.get_camera_slice(rel, ci[None]), 4, 4, min_depth,
                max_depth, n_pts_per_ray=cfg.eft_n_pts, n_batches=16)
            return feat[0], resize_bilinear(rgb, (IMAGE_SIZE, IMAGE_SIZE))[0]

        return jax.lax.map(one, jnp.arange(6))

    feats, imgs = cache_all()
    assert cache["features"].shape == (6, 256, 4, 4)
    assert len(cache["cameras_vox"]) == 6
    np.testing.assert_allclose(cache["features"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(feats), atol=1e-4)
    np.testing.assert_allclose(cache["eft_images"].numpy(), np.asarray(imgs),
                               atol=1e-5)


def test_loop_runs_the_subsampled_fusion_step(monkeypatch):
    """``fusion_rays`` below render_hw^2: each fusion iteration renders the
    full image without gradient for the sampler and takes its gradient
    on that many rays (the step itself is held against JAX's in
    ``test_torch_distill_occupancy``)."""
    from sparsefusion_tpu_torch.data.synthetic import (
        make_synthetic_scene as port_synthetic_scene,
    )

    _, tmodels = _trio()
    scene = port_synthetic_scene(n_views=3, image_size=IMAGE_SIZE, seed=0)
    cfg = tloop.DistillConfig(max_itr=3, start_fusion_step=0,
                              n_aug_cameras=2, fusion_rays=64,
                              ngp=NGPConfig(**NGP_KW), **STEP_KW)
    calls = []
    subset = tloop.SceneSteps.fusion_subset_losses
    monkeypatch.setattr(
        tloop.SceneSteps, "fusion_subset_losses",
        lambda self, *a, **kw: calls.append(self.subsample_fusion)
        or subset(self, *a, **kw))
    out = tloop.distillation_loop(tmodels, scene, [0, 1], cfg,
                                  torch.Generator().manual_seed(0),
                                  verbose=False)
    # iterations 1 and 2 are fusion iterations (itr > start_fusion_step)
    assert calls == [True, True]
    assert out["fusion_subset_steps"] == 2
    assert len(out["fusion_losses"]) == 3
    assert np.isfinite(out["fusion_losses"]).all()
    assert np.isfinite(out["losses"]).all()


def test_demo_cpu_runs_the_diffusion_arm(tmp_path):
    """Four iterations, fusion from the third: the EFT cache, two
    bootstrap steps and a fusion step through the narrow trio; the JAX
    demo's output tree."""
    results = demo.main([
        "-d", "synthetic", "-c", "any", "-i", "0", "-v", "2",
        "--image_size", "32", "--max_itr", "4", "--start_fusion", "2",
        "--device", "cpu", "--exp_dir", str(tmp_path)])
    r = results[0]
    assert len(r["losses"]) == 4 and np.isfinite(r["losses"]).all()
    assert len(r["fusion_losses"]) == 4
    assert np.isfinite(r["fusion_losses"]).all()
    # one fusion iteration (itr 3 > start_fusion 2): its PLMS steps + 1
    assert r["unet_evals"] >= 1
    phase_a = [s for s in r["spans"] if s["name"] == "phase_a"]
    assert len(phase_a) == 1 and phase_a[0]["t1"] > phase_a[0]["t0"]
    with open(tmp_path / "metrics" / "any_000_c2.txt") as fp:
        fp.readline()
        assert set(json.loads(fp.read())) == {"psnr", "ssim"}
    assert (tmp_path / "any_000_c2_ngp.npz").exists()
    for sub in ("log", "render_gifs", "render_imgs"):
        assert (tmp_path / sub).is_dir()
    assert r["renders"].shape == (10, 32, 32, 3)
    assert np.isfinite(r["renders"]).all()
