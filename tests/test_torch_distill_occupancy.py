"""The loop's occupancy parts against the JAX package's
``distill/loop.py``: an input step under a fixed occupancy bitfield, in
two-phase and in single-pass marching mode; the subsampled fusion
gradient step (``fusion_rays``); and the schedule of grid updates and
render modes, iteration by iteration.

The steps run from the same NGP parameters, scene, bitfield and draws:
the ray subsets and the renderer's uniforms are replayed from the JAX
keys.  Tolerances: the loss to 1e-5 relative (measured <= 5e-7), and
every gradient, per parameter, to 1.7e-2 relative (Frobenius), the
two-phase renderer's tolerance (``test_torch_ngp_render``), in both
modes.  The single pass alone agrees to 3e-3 on equal rays, but here
each side builds its rays from the camera, and the two libraries' camera
arithmetic puts the origins up to 7e-7 apart; at the finest level (cells
of 1e-3) that moves trilinear weights by ~1e-3 and, near a cell face, a
sample into the next cell (measured over four keys and both views: the
grid's gradient 1.9e-3-7.5e-3, the first layer's up to 5.6e-3).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.data.contract import SceneData as JSceneData
from sparsefusion_tpu.distill import loop as jloop
from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.render import occupancy as jocc
from sparsefusion_tpu.render.volume import (
    VolumeRendererConfig as JVolumeRendererConfig,
)
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
from sparsefusion_tpu_torch.distill import loop as tloop
from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPField, load_jax_params
from sparsefusion_tpu_torch.render import occupancy as tocc
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig

torch.set_num_threads(2)

NGP_KW = dict(num_levels=4, level_dim=4, log2_hashmap_size=10)
STEP_KW = dict(num_steps=8, upsample_steps=8, max_ray_batch=64,
               use_occupancy=True, occ_march_steps=12, input_rays=128,
               fusion_rays=64)
HW, IMAGE_SIZE = 16, 32
LOSS_TOL = 1e-5
GRAD_TOL = 1.7e-2


def _vcfgs(march):
    kw = dict(num_steps=8, upsample_steps=8, max_ray_batch=64,
              march_steps=march)
    return JVolumeRendererConfig(**kw), VolumeRendererConfig(**kw)


def _replay_chunk_draws(key, n, chunk, vcfg, prefix=""):
    """The draws JAX ``render_rays_chunked`` makes from ``key``."""
    jit, us = [], []
    for kk in jax.random.split(key, n // chunk):
        rng, k = jax.random.split(kk)
        steps = vcfg.march_steps or vcfg.num_steps
        jit.append(jax.random.uniform(k, (chunk, steps)))
        if not vcfg.march_steps:
            rng, k = jax.random.split(rng)
            us.append(jax.random.uniform(k, (chunk, vcfg.upsample_steps)))
    out = {prefix + "jitter": torch.tensor(np.asarray(jnp.concatenate(jit)))}
    if us:
        out[prefix + "u"] = torch.tensor(np.asarray(jnp.concatenate(us)))
    return out


def _ray_subset(key, n_rays):
    """JAX ``_ray_subset``: (ray indices, the render's key)."""
    k_sel, k_render = jax.random.split(key)
    idx = jax.random.randint(k_sel, (n_rays,), 0, HW * HW)
    return torch.tensor(np.asarray(idx)).long(), k_render


@functools.lru_cache(maxsize=None)
def _ball_bitfield(radius=1.0):
    """The occupancy grid the loop builds (128^3, bound 4: 3 cascades),
    occupied where a cell centre lies within ``radius`` of the origin."""
    gs, cascade = tloop.OCC_GRID_SIZE, tocc.cascade_count(4.0)
    xyz = tocc.cell_points(gs)
    grid = torch.stack([
        (torch.linalg.norm(xyz * (min(2 ** c, 4.0) - min(2 ** c, 4.0) / gs),
                           dim=-1) < radius).float() * 20.0
        for c in range(cascade)])
    return tocc.packbits(grid, 10.0).numpy()


def _jax_scene(scene):
    """The port's synthetic scene as the JAX package's SceneData: one
    scene, its arrays shared, for both sides."""
    return JSceneData(images=scene.images, R=scene.R, T=scene.T, f=scene.f,
                      c=scene.c, valid_region=scene.valid_region,
                      image_size=scene.image_size, masks=scene.masks)


@functools.lru_cache(maxsize=None)
def _shared():
    """The scene, the JAX NGP's initial parameters and the JAX cameras.
    The JAX side's init and camera math run under one jit each: eager,
    they compile op by op, which costs more than the steps themselves."""
    scene = make_synthetic_scene(n_views=2, image_size=IMAGE_SIZE, seed=0)
    params = jax.jit(JNGPField(JNGPConfig(**NGP_KW)).init)(
        jax.random.PRNGKey(0), jnp.zeros((8, 3)))["params"]
    jvox = jax.jit(lambda c: jcam.get_relative_cameras(
        c, [0], center_at_origin=False))(_jax_scene(scene).cameras())
    return scene, params, jvox


def _setup(**cfg_kw):
    kw = dict(STEP_KW, **cfg_kw)
    jcfg = jloop.DistillConfig(ngp=JNGPConfig(**NGP_KW), **kw)
    tcfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), **kw)
    scene, params, jvox = _shared()
    jsteps = jloop.make_scene_step_fns(JNGPField(jcfg.ngp), jcfg,
                                       jloop.make_ngp_optimizer(jcfg), HW,
                                       IMAGE_SIZE)
    field = NGPField(tcfg.ngp)
    load_jax_params(field, jax.tree_util.tree_map(np.asarray, dict(params)))
    tsteps = tloop.make_scene_step_fns(
        field, tcfg, tloop.make_ngp_optimizer(tcfg, field), HW, IMAGE_SIZE)
    tvox = tcam.get_relative_cameras(
        tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                            scene.image_size), [0], center_at_origin=False)
    return scene, params, jsteps, field, tsteps, jvox, tvox


def _compare(loss_j, grads_j, loss_t, field):
    assert loss_t.item() == pytest.approx(float(loss_j), rel=LOSS_TOL)
    want = {"grid": np.asarray(grads_j["grid"])}
    for name, layer in grads_j.items():
        if name != "grid":
            want[f"{name}.weight"] = np.asarray(layer["kernel"]).T
            want[f"{name}.bias"] = np.asarray(layer["bias"])
    for name, p in field.named_parameters():
        g = p.grad.numpy()
        rel = np.linalg.norm(g - want[name]) / np.linalg.norm(want[name])
        assert rel <= GRAD_TOL, (name, rel)


@pytest.mark.parametrize("march", [0, 12])
def test_input_step_under_a_bitfield_matches_jax(march):
    scene, params, jsteps, field, tsteps, jvox, tvox = _setup()
    jv, tv = _vcfgs(march)
    bitfield = _ball_bitfield()
    view, key = 1, jax.random.PRNGKey(7)
    rgb, mask = scene.images[view], scene.masks[view]
    loss_j, grads_j = jax.jit(jax.value_and_grad(jsteps.input_losses,
                                                 argnums=1),
                              static_argnums=0)(
        jv, params, jcam.get_camera_slice(jvox, [view]), jnp.asarray(rgb),
        jnp.asarray(mask), key, jnp.asarray(bitfield))
    ray_idx, k_render = _ray_subset(key, STEP_KW["input_rays"])
    draws = dict(_replay_chunk_draws(k_render, STEP_KW["input_rays"], 64, tv),
                 ray_idx=ray_idx)
    cam = tcam.get_camera_slice(tvox, [view])
    loss_t = tsteps.input_losses(tv, cam, torch.tensor(rgb),
                                 torch.tensor(mask), draws=draws,
                                 bitfield=torch.tensor(bitfield))
    loss_t.backward()
    _compare(loss_j, grads_j, loss_t, field)

    # the bitfield tightened the rays: near/far moved on a good share
    from sparsefusion_tpu_torch.core.rays import grid_ray_bundle
    from sparsefusion_tpu_torch.render.volume import near_far_from_aabb

    bundle = grid_ray_bundle(cam, HW, HW, 2, 1.0, 2.0)
    o = bundle.origins.reshape(-1, 3)[ray_idx]
    d = bundle.directions.reshape(-1, 3)[ray_idx]
    near, far = near_far_from_aabb(o, d, 4.0, 0.1)
    n2, f2 = tsteps.make_nff(torch.tensor(bitfield))(o, d, near, far)
    moved = ((n2 > near) | (f2 < far)).float().mean()
    assert 0.25 < float(moved) <= 1.0


def test_subsampled_fusion_grad_step_matches_jax():
    scene, params, jsteps, field, tsteps, jvox, tvox = _setup()
    assert jsteps.subsample_fusion and tsteps.subsample_fusion
    jv, tv = _vcfgs(12)
    bitfield = _ball_bitfield()
    rng = np.random.RandomState(5)
    pred_img = rng.rand(IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    weight = 0.7
    view, k_r = 0, jax.random.PRNGKey(11)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jsteps.fusion_losses,
                                                 argnums=1),
                              static_argnums=0)(
        jv, params, jcam.get_camera_slice(jvox, [view]),
        jnp.asarray(pred_img), jnp.float32(weight), k_r,
        jnp.asarray(bitfield))
    ray_idx, k_render = _ray_subset(k_r, STEP_KW["fusion_rays"])
    draws = dict(_replay_chunk_draws(k_render, STEP_KW["fusion_rays"], 64,
                                     tv, prefix="fusion_"),
                 fusion_ray_idx=ray_idx)
    loss_t = tsteps.fusion_subset_losses(
        tv, tcam.get_camera_slice(tvox, [view]), torch.tensor(pred_img),
        torch.tensor(weight), draws=draws, bitfield=torch.tensor(bitfield))
    loss_t.backward()
    _compare(loss_j, grads_j, loss_t, field)


def _jax_schedule(monkeypatch, cfg, scene):
    """Events of the JAX loop, with its steps, grid update and renders
    replaced by recorders (no jit, so each call records), and the orbit
    of Phase C by the scene's own cameras (the renders are stubs)."""
    events = []

    def make_steps(ngp_model, cfg_, tx, render_hw, image_size,
                   lpips_fn=None):
        def input_step(vc, params, opt_state, *args):
            events.append(("input", vc.march_steps))
            return params, opt_state, jnp.float32(0.0)

        def unused(*args):
            raise AssertionError("the NGP-only loop took a diffusion step")

        return types.SimpleNamespace(
            input_step=input_step, bootstrap_step=unused,
            render_up_img=unused, fusion_grad_step=unused,
            make_nff=lambda bitfield: None)

    def render(ngp_model, params, cam, hw, vcfg, rng, perturb,
               near_far_fn=None, ray_idx=None, remat=True):
        events.append(("eval", vcfg.march_steps))
        return jnp.zeros((hw, hw, 3)), jnp.zeros((hw, hw, 1))

    def update(self, density_fn, rng, decay=0.95):
        events.append(("update",))
        return self

    class Field:     # no parameters to initialise: the steps are recorders
        def __init__(self, config):
            self.config = config

        def init(self, key, x):
            return {"params": {}}

    monkeypatch.setattr(jloop, "NGPField", Field)
    monkeypatch.setattr(jloop, "make_scene_step_fns", make_steps)
    monkeypatch.setattr(jloop, "_render_cam", render)
    monkeypatch.setattr(jloop, "get_interpolated_path",
                        lambda cams, n, **kw: cams)
    monkeypatch.setattr(jocc.OccupancyGrid, "update", update)
    with jax.disable_jit():
        jloop.distillation_loop(None, scene, [0, 1], cfg,
                                jax.random.PRNGKey(0), use_diffusion=False,
                                verbose=False)
    return events


def _port_schedule(monkeypatch, cfg, scene):
    events = []

    def make_steps(field, cfg_, optimizer, render_hw, image_size,
                   lpips_fn=None, models=None):
        def input_step(vc, cam, rgb, mask, generator, bitfield=None):
            assert (bitfield is not None) == cfg.use_occupancy
            events.append(("input", vc.march_steps))
            return torch.zeros(())

        return types.SimpleNamespace(input_step=input_step,
                                     make_nff=lambda bitfield: None)

    def render(field, cam, hw, vcfg, perturb, generator=None, **kw):
        events.append(("eval", vcfg.march_steps))
        return torch.zeros(hw, hw, 3), torch.zeros(hw, hw, 1)

    def update(self, density_fn, generator=None, decay=0.95, jitter=None):
        events.append(("update",))
        return self

    monkeypatch.setattr(tloop, "make_scene_step_fns", make_steps)
    monkeypatch.setattr(tloop, "_render_cam", render)
    monkeypatch.setattr(tocc.OccupancyGrid, "update", update)
    out = tloop.distillation_loop(None, scene, [0, 1], cfg,
                                  torch.Generator(), use_diffusion=False,
                                  verbose=False)
    return events, out


def _split(events):
    steps = [e for e in events if e[0] != "eval"]
    return steps, {e[1] for e in events if e[0] == "eval"}


@pytest.mark.parametrize("sched", [
    dict(occupancy_start=3, occupancy_update_every=4, occ_march_steps=12),
    dict(occupancy_start=2, occupancy_update_every=3, occ_march_steps=12,
         polish_start=9),
    dict(occupancy_start=5, occupancy_update_every=2, occ_march_steps=None),
    dict(use_occupancy=False, occupancy_start=0, occ_march_steps=12,
         polish_start=4),
])
def test_update_and_render_schedule_match_jax(monkeypatch, sched):
    kw = dict(max_itr=12, n_aug_cameras=2, num_steps=8, upsample_steps=8,
              max_ray_batch=64, use_occupancy=True)
    kw.update(sched)
    tscene = make_synthetic_scene(n_views=3, image_size=8, seed=0)
    jscene = _jax_scene(tscene)
    jcfg = jloop.DistillConfig(ngp=JNGPConfig(**NGP_KW), **kw)
    tcfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), **kw)
    want_steps, want_eval = _split(_jax_schedule(monkeypatch, jcfg, jscene))
    got_events, out = _port_schedule(monkeypatch, tcfg, tscene)
    got_steps, got_eval = _split(got_events)
    assert got_steps == want_steps
    assert got_eval == want_eval and len(got_eval) == 1
    assert [e[0] for e in got_steps].count("input") == 12
    # the loop's own count of iterations by render mode
    n_march = sum(1 for e in got_steps if e[0] == "input" and e[1])
    assert out["render_modes"] == {"two_phase": 12 - n_march,
                                   "march": n_march}
    assert out["fusion_subset_steps"] == 0
    if tcfg.use_occupancy:
        n_updates = [e[0] for e in got_steps].count("update")
        assert out["occupancy"]["update_itrs"] == list(range(
            tcfg.occupancy_start, 12, tcfg.occupancy_update_every))
        assert n_updates == len(out["occupancy"]["update_itrs"]) > 0
    else:
        assert out["occupancy"] is None
