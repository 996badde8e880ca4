"""The fusion step with the bf16 sampler (``DistillConfig(sampler_bf16=True)``)
against the JAX package's, and the port's distillation loop with it.

The harness of ``test_torch_fusion``: the narrow trio (final conv
randomised), the same NGP parameters, the renderer's draws replayed from
the JAX keys and the PLMS draws along the JAX key tree.  The JAX side
samples through ``unet_apply_fn(bf16=True)`` on ``sampler_unet_params(True)``
(bf16 weights, cast once), the port through ``unet_half``.  The two bf16
UNets round at different places (``test_torch_unet_bf16``: 1.7e-2
relative on one evaluation).  The sampler's target, an image in [0, 1],
agrees to 5e-2 absolute (measured 1.4e-2); the loss, the target's L1
mean against the render, to 2e-3 relative (measured 2.3e-4).  The NGP
parameters after the update agree to 0.3 of the update (Frobenius;
measured 1.4e-1 on the grid, at most 1.7e-2 on the MLP): a first Adam
step moves each element by about lr * sign(g), and the L1 gradient's sign
flips wherever the render lies between the two targets, which the f32
step (1.5e-2) does not see.  The sampler's arithmetic, the VAE and the
renderer stay f32: the f32 fusion step of ``test_torch_fusion`` is the
same code with the f32 UNet.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.data.synthetic import make_synthetic_scene
from sparsefusion_tpu.diffusion.plms import plms_sample as jax_plms_sample
from sparsefusion_tpu.distill import loop as jloop
from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.render.volume import (
    VolumeRendererConfig as JVolumeRendererConfig,
)
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.distill import loop as tloop
from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPField, load_jax_params
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig
from tests.test_torch_fusion import (
    HW,
    IMAGE_SIZE,
    NGP_KW,
    STEP_KW,
    _plms_draws,
    _replay_chunk_draws,
    _trio,
)

torch.set_num_threads(2)
TARGET_ATOL, UPDATE_REL = 5e-2, 0.3


def test_bf16_fusion_step_matches_jax():
    jcfg = jloop.DistillConfig(ngp=JNGPConfig(**NGP_KW), sampler_bf16=True,
                               **STEP_KW)
    tcfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), sampler_bf16=True,
                               **STEP_KW)
    scene = make_synthetic_scene(n_views=2, image_size=IMAGE_SIZE, seed=0)
    rng = np.random.RandomState(3)
    features = rng.randn(4, 4, 256).astype(np.float32)   # NHWC (h, w, C)
    mt = 0.3   # -> 2 PLMS steps

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

    # the JAX fusion step's split tree, the sampler in bf16
    k_r, _, k_s = jax.random.split(jax.random.PRNGKey(11), 3)
    img = jax.jit(jsteps.render_up_img, static_argnums=0)(
        jv, params, jc, k_r, bitfield)
    latents = jax.jit(jmodels.vae_encode)(img[None])
    unet_apply = jmodels.unet_apply_fn(bf16=True)
    half = jmodels.sampler_unet_params(True)
    pred_x0, _, _, alpha_cumprod = jax.jit(lambda p, k, z, c: jax_plms_sample(
        jmodels.ddpm, lambda *a: unet_apply(p, *a), k, z, mt,
        cond_images=c, plms_steps=4))(half, k_s, latents,
                                      jnp.asarray(features)[None])
    pred_img = jax.jit(jmodels.vae_decode)(pred_x0)[0]
    params, opt_state, loss_j = jax.jit(jsteps.fusion_grad_step,
                                        static_argnums=0)(
        jv, params, opt_state, jc, pred_img, 1.0 - alpha_cumprod[0], k_r,
        bitfield)

    draws = _replay_chunk_draws(k_r, HW * HW, 128)
    draws["plms_noise"] = _plms_draws(k_s, latents.shape, 2)
    # the sampler's target from the JAX render, against the JAX target
    target, weight = tsteps.fusion_target(
        torch.tensor(np.asarray(img)), torch.tensor(features).permute(2, 0, 1),
        mt, plms_noise=draws["plms_noise"])
    target_err = np.abs(target.numpy() - np.asarray(pred_img)).max()
    print(f"bf16 fusion target max abs err {target_err:.3e}")
    assert target_err <= TARGET_ATOL
    assert float(weight) == pytest.approx(float(1.0 - alpha_cumprod[0]),
                                          rel=1e-6)
    evals0 = tmodels.unet_evals
    loss_t = tsteps.fusion_step(
        tv, tc, torch.tensor(features).permute(2, 0, 1), mt, draws=draws)
    assert tmodels.unet_evals - evals0 == 3
    assert tmodels._half is not None   # the sampler ran the bf16 copy
    print(f"bf16 fusion loss port {float(loss_t):.7f} JAX "
          f"{float(loss_j):.7f}")
    assert float(loss_t) == pytest.approx(float(loss_j), rel=2e-3)

    got = {n: p.detach().numpy() for n, p in field.named_parameters()}
    want = {"grid": np.asarray(params["grid"])}
    for name, layer in params.items():
        if name != "grid":
            want[f"{name}.weight"] = np.asarray(layer["kernel"]).T
            want[f"{name}.bias"] = np.asarray(layer["bias"])
    for name in want:
        moved = want[name] - init[name]
        rel = np.linalg.norm(got[name] - want[name]) / np.linalg.norm(moved)
        print(f"  {name}: {rel:.3e} of the update")
        assert rel <= UPDATE_REL, (name, rel)


def test_bf16_sampler_loop_runs():
    """``distillation_loop`` with ``sampler_bf16`` on the narrow trio: the
    bootstrap iterations, then three fusion iterations (the loop's host
    draws give them PLMS steps), all finite, through the bf16 copy of the
    UNet."""
    from sparsefusion_tpu_torch.data.synthetic import (
        make_synthetic_scene as port_scene,
    )

    _, tmodels = _trio()
    scene = port_scene(n_views=3, image_size=IMAGE_SIZE, seed=0)
    cfg = tloop.DistillConfig(max_itr=6, start_fusion_step=2,
                              n_aug_cameras=2, sampler_bf16=True,
                              ngp=NGPConfig(**NGP_KW), **STEP_KW)
    out = tloop.distillation_loop(tmodels, scene, [0, 1], cfg,
                                  torch.Generator().manual_seed(0),
                                  verbose=False)
    assert np.isfinite(out["losses"]).all()
    assert np.isfinite(out["fusion_losses"]).all()
    assert out["unet_evals"] >= 1
    assert tmodels._half is not None
    assert all(p.dtype == torch.bfloat16 for p in tmodels._half.parameters())
