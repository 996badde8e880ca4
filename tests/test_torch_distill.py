"""The NGP-only slice as a whole: the port's input step and synthetic
scene against the JAX package (the demo CLI is in ``test_torch_demo``).

The input step runs with the same parameters, scene and draws on both
sides (the jax.random draws of the chunked renderer are replayed here).
Its tolerances follow the renderer's (see ``test_torch_ngp_render``):
the two-phase sampler magnifies f32 rounding differences, and Adam's
first steps map a gradient g to lr * g / (|g| + 1e-8), so an update is
compared relative to the size of the updates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.data.synthetic import (
    make_synthetic_scene as jax_make_synthetic_scene,
)
from sparsefusion_tpu.distill import loop as jloop
from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.render.volume import (
    VolumeRendererConfig as JVolumeRendererConfig,
)
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
from sparsefusion_tpu_torch.distill import loop as tloop
from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPField, load_jax_params
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig
from sparsefusion_tpu_torch.utils import spans

torch.set_num_threads(2)

NGP_KW = dict(num_levels=4, log2_hashmap_size=10)
STEP_KW = dict(num_steps=8, upsample_steps=8, max_ray_batch=128)


def _replay_chunk_draws(key, n, chunk, vcfg):
    """The draws JAX ``render_rays_chunked`` makes from ``key``."""
    jit, us = [], []
    for kk in jax.random.split(key, n // chunk):
        rng, k = jax.random.split(kk)
        jit.append(jax.random.uniform(k, (chunk, vcfg.num_steps)))
        rng, k = jax.random.split(rng)
        us.append(jax.random.uniform(k, (chunk, vcfg.upsample_steps)))
    return {"jitter": torch.tensor(np.asarray(jnp.concatenate(jit))),
            "u": torch.tensor(np.asarray(jnp.concatenate(us)))}


def _flat(field):
    return {n: p.detach().numpy().copy() for n, p in field.named_parameters()}


def _jax_as_port_names(params):
    out = {"grid": np.asarray(params["grid"])}
    for name, layer in params.items():
        if name != "grid":
            out[f"{name}.weight"] = np.asarray(layer["kernel"]).T
            out[f"{name}.bias"] = np.asarray(layer["bias"])
    return out


def test_input_step_matches_jax():
    """Two input steps (render, loss, gradient, Adam) from the same
    parameters and draws give the same losses and parameters."""
    jcfg = jloop.DistillConfig(ngp=JNGPConfig(**NGP_KW), **STEP_KW)
    tcfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), **STEP_KW)
    hw, image_size = 16, 32
    scene = jax_make_synthetic_scene(n_views=2, image_size=image_size,
                                     seed=0)

    model = JNGPField(jcfg.ngp)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)))["params"]
    tx = jloop.make_ngp_optimizer(jcfg)
    opt_state = tx.init(params)
    jsteps = jloop.make_scene_step_fns(model, jcfg, tx, hw, image_size)
    jstep = jax.jit(jsteps.input_step, static_argnums=0)
    jv = JVolumeRendererConfig(num_steps=8, upsample_steps=8,
                               max_ray_batch=128)
    jvox = jcam.get_relative_cameras(scene.cameras(), [0],
                                     center_at_origin=False)

    field = NGPField(tcfg.ngp)
    load_jax_params(field, jax.tree_util.tree_map(np.asarray, dict(params)))
    init = _flat(field)
    tsteps = tloop.make_scene_step_fns(
        field, tcfg, tloop.make_ngp_optimizer(tcfg, field), hw, image_size)
    tv = VolumeRendererConfig(num_steps=8, upsample_steps=8,
                              max_ray_batch=128)
    tvox = tcam.get_relative_cameras(
        tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                            scene.image_size), [0], center_at_origin=False)

    for i, view in enumerate((1, 0)):
        key = jax.random.PRNGKey(100 + i)
        rgb, mask = scene.images[view], scene.masks[view]
        params, opt_state, loss_j = jstep(
            jv, params, opt_state, jcam.get_camera_slice(jvox, [view]),
            jnp.asarray(rgb), jnp.asarray(mask), key,
            jnp.zeros((8,), jnp.uint8))
        loss_t = tsteps.input_step(
            tv, tcam.get_camera_slice(tvox, [view]), torch.tensor(rgb),
            torch.tensor(mask), draws=_replay_chunk_draws(key, hw * hw, 128,
                                                          tv))
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4)

    want = _jax_as_port_names(params)
    got = _flat(field)
    for name in want:
        moved = want[name] - init[name]
        rel = np.linalg.norm(got[name] - want[name]) / np.linalg.norm(moved)
        # measured 9.2e-3 on the grid, <= 1e-3 on the MLP
        assert rel <= 3e-2, (name, rel)
        # and the parameters really moved, by about lr per step
        assert np.abs(moved).max() > 1e-4, name


def test_optimizer_lr_ticks_per_update():
    """Grid at 10x lr, staircase decay once per optimizer update, as the
    JAX package's optax schedule."""
    cfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), lr_decay_step=2)
    field = NGPField(cfg.ngp)
    opt = tloop.make_ngp_optimizer(cfg, field)
    sched = jax.jit(lambda c: jnp.asarray(
        __import__("optax").exponential_decay(
            cfg.lr, cfg.lr_decay_step, cfg.lr_decay_gamma,
            staircase=True)(c)))
    for count in range(5):
        grid_lr, mlp_lr = (g["lr"] for g in opt.adam.param_groups)
        assert mlp_lr == pytest.approx(float(sched(count)), rel=1e-6)
        assert grid_lr == pytest.approx(10 * mlp_lr, rel=1e-6)
        for p in field.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()


def test_synthetic_scene_matches_jax():
    a = make_synthetic_scene(n_views=3, image_size=32, seed=1)
    b = jax_make_synthetic_scene(n_views=3, image_size=32, seed=1)
    assert a.sequence_name == b.sequence_name
    for f in ("R", "T", "f", "c", "image_size", "valid_region"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=1e-5)
    # single-pass render of the blobs; exp differs by an ulp between the
    # two libraries (see test_torch_ngp_render)
    np.testing.assert_allclose(a.images, b.images, atol=1e-4)
    np.testing.assert_allclose(a.masks, b.masks, atol=1e-4)
    assert a.images.max() > 0.2


def test_loop_runs_the_occupancy_preset(monkeypatch):
    """The TPU preset, port only, NGP-only, at a tiny size (a 32^3
    occupancy grid): two-phase sampling, the grid's first update and the
    switch to single-pass marching at occupancy_start, updates every 8
    iterations, the two-phase polish tail, and Phase C inside the occupied
    span (the JAX loop's ``tests/test_distill_occupancy.py`` drives, in
    one run)."""
    monkeypatch.setattr(tloop, "OCC_GRID_SIZE", 32)
    scene = make_synthetic_scene(n_views=3, image_size=32, seed=1)
    cfg = tloop.tpu_distill_config(
        max_itr=30, start_fusion_step=10 ** 9, n_aug_cameras=2,
        num_steps=8, upsample_steps=8, max_ray_batch=256,
        occupancy_start=8, occupancy_update_every=8, occ_march_steps=12,
        polish_start=22,
        ngp=NGPConfig(num_levels=4, level_dim=4, log2_hashmap_size=10,
                      table_dtype="bfloat16"))
    assert cfg.use_occupancy and cfg.fusion_rays == 4096 and not cfg.remat
    spans.enable()
    try:
        out = tloop.distillation_loop(None, scene, [0, 1], cfg,
                                      torch.Generator().manual_seed(0),
                                      use_diffusion=False, verbose=False)
    finally:
        spans.disable()
    assert len(out["losses"]) == 30 and np.isfinite(out["losses"]).all()
    assert max(out["losses"]) < 10.0
    occ = out["occupancy"]
    assert occ["update_itrs"] == [8, 16, 24]
    # marching over iterations 8..21, two-phase before and in the tail
    assert out["render_modes"] == {"two_phase": 16, "march": 14}
    # the density blob at the origin is occupied, the box's corners not
    assert all(0.0 < s < 1.0 for s in occ["occupied_share"])
    # each update is an ``occupancy_update`` span of its iteration
    updates = [s for s in out["spans"] if s["name"] == "occupancy_update"]
    assert [s["unit"] for s in updates] == [8, 16, 24]
    assert all(s["t1"] >= s["t0"] for s in updates)
    assert np.isfinite(out["renders"]).all()
    assert np.isfinite(out["metrics"]["psnr"])
