"""The scene-batched loop (``distill/batched.py``): its steps over a scene
axis against per-scene steps, in the port and against the JAX package's
vmapped steps, and the loop end to end (the non-mesh tests of
``tests/test_distill_batched.py``).

* Port against port: one batched input, bootstrap and fusion step of S = 2
  scenes on an ``NGPFieldStack`` equals the two scenes' single-scene
  steps from the same parameters and draws: losses and parameters after
  the Adam update to 1e-5 (relative; the parameters relative to the
  update), the f32 sums of a batched matmul and a batch-2 UNet against
  their batch-1 forms.
* Port against JAX: the batched losses and gradients against
  ``jax.vmap`` of the JAX package's ``make_scene_step_fns`` losses, with
  the renderer's draws replayed from the JAX keys, at the single-scene
  tests' tolerances: losses 1e-4 relative, gradients 1.7e-2 relative
  (Frobenius) per parameter and scene, the two-phase renderer's
  tolerance (``test_torch_ngp_render``).  The fusion step's target (VAE,
  PLMS, VAE at batch 2) is the port's on both sides: its batch-1 form is
  held against the JAX sampler in ``test_torch_fusion``, and batch 2
  against batch 1 above.
* The loop: the photometric path learns, the diffusion arm runs end to
  end and writes every scene's outputs, the occupancy grids update and
  the renders march, ragged scenes are refused.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.data.synthetic import make_synthetic_scene
from sparsefusion_tpu.distill import loop as jloop
from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.render.volume import (
    VolumeRendererConfig as JVolumeRendererConfig,
)
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.distill import loop as tloop
from sparsefusion_tpu_torch.distill.batched import batched_distillation_loop
from sparsefusion_tpu_torch.nn.ngp import (
    NGPConfig,
    NGPField,
    NGPFieldStack,
    load_jax_params,
)
from sparsefusion_tpu_torch.render import occupancy as tocc
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig
from sparsefusion_tpu_torch.distill import batched as tbatched
from tests.test_torch_fusion import _replay_chunk_draws, _trio

torch.set_num_threads(2)

NGP_KW = dict(num_levels=4, log2_hashmap_size=10)
STEP_KW = dict(num_steps=8, upsample_steps=8, max_ray_batch=128,
               plms_steps=4)
HW, IMAGE_SIZE = 16, 32
SEEDS = (0, 3)
PORT_TOL = 1e-5
LOSS_TOL = 1e-4
GRAD_TOL = 1.7e-2
MT = 0.3   # -> min(int(0.3 * 4 * 2), 4) = 2 PLMS steps


def _torch_cams(scene):
    return tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                               scene.image_size)


@functools.lru_cache(maxsize=None)
def _shared():
    """Two scenes, two JAX NGP inits, the narrow trio on both sides, and
    each scene's input target, cached EFT-like image and features."""
    scenes = [make_synthetic_scene(n_views=2, image_size=IMAGE_SIZE, seed=s)
              for s in SEEDS]
    init = jax.jit(jax.vmap(JNGPField(JNGPConfig(**NGP_KW)).init,
                            in_axes=(0, None)))
    params = init(jax.random.split(jax.random.PRNGKey(0), 2),
                  jnp.zeros((8, 3)))["params"]
    rng = np.random.RandomState(3)
    eft = rng.rand(2, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    feats = rng.randn(2, 4, 4, 256).astype(np.float32)      # NHWC
    jmodels, tmodels = _trio()
    return scenes, jax.tree_util.tree_map(np.asarray, params), eft, feats, \
        jmodels, tmodels


def _scene_params(params, s):
    return jax.tree_util.tree_map(lambda a: a[s], params)


def _port(cfg, params, models=None, lpips_fn=None):
    """Single-scene fields and steps for each scene, and the stack of the
    same fields with its batched steps."""
    singles = []
    for s in range(2):
        field = NGPField(cfg.ngp)
        load_jax_params(field, _scene_params(params, s))
        singles.append(field)
    stack = NGPFieldStack(singles)
    mk = functools.partial(tloop.make_scene_step_fns, cfg=cfg,
                           render_hw=HW, image_size=IMAGE_SIZE,
                           models=models, lpips_fn=lpips_fn)
    single_steps = [mk(f, optimizer=tloop.make_ngp_optimizer(cfg, f))
                    for f in singles]
    batched = mk(stack, optimizer=tloop.make_ngp_optimizer(cfg, stack))
    return singles, single_steps, stack, batched


def _draws(scene_draws):
    """Per-scene draws stacked on a scene axis."""
    out = {}
    for k in scene_draws[0]:
        if isinstance(scene_draws[0][k], list):
            out[k] = [torch.cat([d[k][i] for d in scene_draws])
                      for i in range(len(scene_draws[0][k]))]
        else:
            out[k] = torch.stack([d[k] for d in scene_draws])
    return out


def _cams(scenes, views):
    return [tcam.get_camera_slice(tcam.get_relative_cameras(
        _torch_cams(sc), [0], center_at_origin=False), [v])
        for sc, v in zip(scenes, views)]


def test_batched_steps_match_per_scene_steps():
    """Port against port: input, bootstrap and fusion steps (S = 2)."""
    cfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), **STEP_KW)
    scenes, params, eft, feats, _, tmodels = _shared()
    singles, single_steps, stack, batched = _port(cfg, params, tmodels)
    init = [{n: p.detach().clone() for n, p in f.named_parameters()}
            for f in singles]
    vc = VolumeRendererConfig(num_steps=8, upsample_steps=8,
                              max_ray_batch=128)
    rng = np.random.RandomState(7)

    def render_draws():
        return {k: torch.tensor(rng.rand(HW * HW, 8), dtype=torch.float32)
                for k in ("jitter", "u")}

    cams = _cams(scenes, (0, 1))
    cam_b = tcam.concat_cameras(cams)
    features = torch.tensor(feats).permute(0, 3, 1, 2)
    phases = [
        ("input", "input_step",
         lambda s: (torch.tensor(scenes[s].images[0]),
                    torch.tensor(scenes[s].masks[0])),
         (torch.tensor(np.stack([sc.images[0] for sc in scenes])),
          torch.tensor(np.stack([sc.masks[0] for sc in scenes])))),
        ("bootstrap", "bootstrap_step",
         lambda s: (torch.tensor(eft[s]),), (torch.tensor(eft),)),
        ("fusion", "fusion_step", lambda s: (features[s], MT),
         (features, MT)),
    ]
    for name, step, single_args, batched_args in phases:
        draws = [render_draws() for _ in range(2)]
        if name == "fusion":
            for d in draws:
                d["plms_noise"] = [torch.tensor(rng.randn(1, 4, 4, 4),
                                                dtype=torch.float32)
                                   for _ in range(4)]
        want = [float(getattr(single_steps[s], step)(
            vc, cams[s], *single_args(s), draws=draws[s]))
            for s in range(2)]
        got = getattr(batched, step)(vc, cam_b, *batched_args,
                                     draws=_draws(draws))
        assert got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), want, rtol=PORT_TOL,
                                   err_msg=name)
    # the parameters after the three updates, every scene its own,
    # relative to how far the updates moved them
    for s, field in enumerate(singles):
        mine = dict(stack.field_at(s).named_parameters())
        for n, p in field.named_parameters():
            moved = (p - init[s][n]).norm()
            rel = ((p - mine[n]).norm() / moved).item()
            assert rel <= PORT_TOL, (s, n, rel)


def _jax_steps(cfg):
    return jloop.make_scene_step_fns(
        JNGPField(cfg.ngp), cfg, jloop.make_ngp_optimizer(cfg), HW,
        IMAGE_SIZE)


def _compare_grads(got_loss, want_loss, stack, jgrads):
    np.testing.assert_allclose(got_loss, np.asarray(want_loss),
                               rtol=LOSS_TOL)
    got = {n: p.grad.numpy() for n, p in stack.named_parameters()}
    want = {"grid": np.asarray(jgrads["grid"])}
    for name, layer in jgrads.items():
        if name != "grid":
            for leaf in ("kernel", "bias"):
                want[f"{name}.{leaf}"] = np.asarray(layer[leaf])
    for name, w in want.items():
        for s in range(2):
            rel = np.linalg.norm(got[name][s] - w[s]) / np.linalg.norm(w[s])
            assert rel <= GRAD_TOL, (name, s, rel)


def test_batched_steps_match_jax_vmapped_steps():
    """Port against JAX: the input, bootstrap and fusion losses of S = 2
    scenes and their gradients against ``jax.vmap`` of the JAX steps'
    losses."""
    jcfg = jloop.DistillConfig(ngp=JNGPConfig(**NGP_KW), **STEP_KW)
    tcfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), **STEP_KW)
    scenes, params, eft, feats, _, tmodels = _shared()
    _, _, stack, batched = _port(tcfg, params, tmodels)
    jsteps = _jax_steps(jcfg)
    jv = JVolumeRendererConfig(num_steps=8, upsample_steps=8,
                               max_ray_batch=128)
    tv = VolumeRendererConfig(num_steps=8, upsample_steps=8,
                              max_ray_batch=128)
    # the camera math under one jit: eager, it compiles op by op
    jcams = jax.jit(lambda cams: jax.tree_util.tree_map(
        lambda *a: jnp.stack(a), *[jcam.get_camera_slice(
            jcam.get_relative_cameras(c, [0], center_at_origin=False), [v])
            for c, v in zip(cams, (0, 1))]))([sc.cameras() for sc in scenes])
    cam_b = tcam.concat_cameras(_cams(scenes, (0, 1)))
    bitfield = jnp.zeros((2, 8), jnp.uint8)
    params_j = jax.tree_util.tree_map(jnp.asarray, params)

    def vgrad(losses_fn, *args):
        fn = jax.jit(jax.vmap(jax.value_and_grad(
            functools.partial(losses_fn, jv), argnums=0)))
        return fn(params_j, *args)

    def replay(keys):
        return _draws([_replay_chunk_draws(k, HW * HW, 128) for k in keys])

    # input step
    keys = jax.random.split(jax.random.PRNGKey(10), 2)
    gt = np.stack([sc.images[0] for sc in scenes])
    mask = np.stack([sc.masks[0] for sc in scenes])
    loss_j, g_j = vgrad(jsteps.input_losses, jcams, jnp.asarray(gt),
                        jnp.asarray(mask), keys, bitfield)
    stack.zero_grad()
    loss_t = batched.input_losses(tv, cam_b, torch.tensor(gt),
                                  torch.tensor(mask), draws=replay(keys))
    loss_t.sum().backward()
    _compare_grads(loss_t.detach().numpy(), loss_j, stack, g_j)

    # bootstrap step
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    loss_j, g_j = vgrad(jsteps.bootstrap_losses, jcams, jnp.asarray(eft),
                        keys, bitfield)
    stack.zero_grad()
    loss_t = batched.bootstrap_losses(tv, cam_b, torch.tensor(eft),
                                      draws=replay(keys))
    loss_t.sum().backward()
    _compare_grads(loss_t.detach().numpy(), loss_j, stack, g_j)

    # fusion step: both sides take the port's batch-2 target of the
    # render (one VAE encode, one PLMS chain, one decode)
    keys = jax.random.split(jax.random.PRNGKey(12), 2)
    draws = replay(keys)
    rng = np.random.RandomState(5)
    draws["plms_noise"] = [torch.tensor(rng.randn(2, 4, 4, 4),
                                        dtype=torch.float32)
                           for _ in range(4)]
    features = torch.tensor(feats).permute(0, 3, 1, 2)
    with torch.no_grad():
        img, _ = batched.render_up(tv, cam_b, draws=draws)
        pred, weight = batched.fusion_target(img, features, MT,
                                             plms_noise=draws["plms_noise"])
    assert pred.shape == (2, IMAGE_SIZE, IMAGE_SIZE, 3)
    assert weight.shape == (2,)
    loss_j, g_j = vgrad(jsteps.fusion_losses, jcams,
                        jnp.asarray(pred.numpy()),
                        jnp.asarray(weight.numpy()), keys, bitfield)
    stack.zero_grad()
    evals0 = tmodels.unet_evals
    loss_t = batched.fusion_losses(tv, cam_b, features, MT, draws=draws)
    loss_t.sum().backward()
    # 2 PLMS steps, 3 UNet evaluations, each at batch 2
    assert tmodels.unet_evals - evals0 == 3
    _compare_grads(loss_t.detach().numpy(), loss_j, stack, g_j)


def _loop_scenes(n, n_views, size):
    from sparsefusion_tpu_torch.data.synthetic import (
        make_synthetic_scene as port_scene,
    )

    return [port_scene(n_views=n_views, image_size=size, seed=s)
            for s in (2, 5, 1)[:n]]


def test_batched_photometric_learns():
    """S = 2 lockstep photometric optimisation fits both scenes."""
    scenes = _loop_scenes(2, 3, 32)
    cfg = tloop.DistillConfig(
        max_itr=60, start_fusion_step=10 ** 9, n_aug_cameras=2,
        num_steps=8, upsample_steps=8, max_ray_batch=256,
        ngp=NGPConfig(num_levels=6, log2_hashmap_size=12))
    outs = batched_distillation_loop(
        None, scenes, [[0, 1, 2], [0, 1, 2]], cfg,
        torch.Generator().manual_seed(1), use_diffusion=False,
        verbose=False)
    assert len(outs) == 2
    for out in outs:
        assert np.mean(out["losses"][-10:]) < np.mean(out["losses"][:10])
        assert out["metrics"]["psnr"] > 14.0, out["metrics"]


def test_batched_end_to_end_with_diffusion(tmp_path):
    """S = 2 full pipeline: EFT caches, bootstrap, fusion with the
    perceptual term (a stand-in ``lpips_fn``), eval with its column,
    every scene's outputs."""
    _, _, _, _, _, tmodels = _shared()
    scenes = _loop_scenes(2, 4, 32)
    for i, sc in enumerate(scenes):
        sc.sequence_name = f"batched_{i}"
    cfg = tloop.DistillConfig(
        max_itr=4, start_fusion_step=2, n_aug_cameras=2,
        ngp=NGPConfig(**NGP_KW), **STEP_KW)
    calls = []

    def fake_lpips(a, b):
        calls.append(a.shape[0])
        return (a - b).abs().mean(dim=(1, 2, 3))

    evals0 = tmodels.unet_evals
    outs = batched_distillation_loop(
        tmodels, scenes, [[0, 1], [2, 3]], cfg,
        torch.Generator().manual_seed(1), save_dir=str(tmp_path),
        verbose=False, lpips_fn=fake_lpips)
    assert len(outs) == 2
    # one fusion iteration (3 > 2): the perceptual term once at batch 2,
    # then each scene's Phase C column over its 4 views
    assert calls == [2, 4, 4]
    for out, scene in zip(outs, scenes):
        assert out["renders"].shape == (4, 32, 32, 3)
        assert np.all(np.isfinite(out["renders"]))
        assert len(out["losses"]) == 4 and len(out["fusion_losses"]) == 4
        assert np.isfinite(out["fusion_losses"]).all()
        assert np.isfinite(out["metrics"]["lpips"])
        assert out["unet_evals"] == tmodels.unet_evals - evals0 > 0
        seq = scene.sequence_name
        assert (tmp_path / "metrics" / f"{seq}.txt").exists()
        assert (tmp_path / f"{seq}_ngp.npz").exists()
    assert outs[0]["losses"] != outs[1]["losses"]


def test_batched_occupancy_march(monkeypatch):
    """S = 2 with the TPU preset at a tiny size (32^3 occupancy grids):
    the grids of both scenes update in one pass on the cadence, and the
    renders march inside each scene's own bitfield."""
    monkeypatch.setattr(tloop, "OCC_GRID_SIZE", 32)
    monkeypatch.setattr(tbatched, "OCC_GRID_SIZE", 32)
    scenes = _loop_scenes(2, 3, 32)
    cfg = tloop.tpu_distill_config(
        max_itr=24, start_fusion_step=10 ** 9, n_aug_cameras=2,
        num_steps=8, upsample_steps=8, max_ray_batch=256,
        occupancy_start=8, occupancy_update_every=8, occ_march_steps=12,
        input_rays=128, ngp=NGPConfig(num_levels=4, level_dim=4,
                                      log2_hashmap_size=10,
                                      table_dtype="bfloat16"))
    outs = batched_distillation_loop(
        None, scenes, [[0, 1], [0, 1]], cfg,
        torch.Generator().manual_seed(0), use_diffusion=False,
        verbose=False)
    for out in outs:
        assert len(out["losses"]) == 24
        assert np.all(np.isfinite(out["losses"]))
        assert np.all(np.isfinite(out["renders"]))
        assert out["render_modes"] == {"two_phase": 8, "march": 16}
        assert out["occupancy"]["update_itrs"] == [8, 16]
        assert len(out["occupancy"]["occupied_share"]) == 2


def test_batched_occupancy_update_matches_per_scene():
    """One update of S = 2 grids equals each scene's own update (the
    density at the jittered cell centres, the EMA, each scene's mean and
    bitfield), and near/far in S bitfields equals each scene's."""
    cfg = NGPConfig(**NGP_KW)
    g = torch.Generator().manual_seed(0)
    fields = [NGPField(cfg, generator=g) for _ in range(2)]
    with torch.no_grad():
        for f in fields:    # densities on both sides of the threshold
            f.sigma_net_2.bias.copy_(torch.tensor([2.3, 0.0, 0.0, 0.0]))
    stack = NGPFieldStack(fields)
    gs, cascade = 16, tocc.cascade_count(4.0)
    jitter = torch.rand((2, cascade, gs ** 3, 3), generator=g)
    grids = torch.rand((2, cascade, gs ** 3), generator=g) * 20.0
    with torch.no_grad():
        got = tocc.density_grid_update(grids, lambda p: stack(p)[0], 4.0,
                                       gs, cascade, 10.0, jitter=jitter)
        for s, f in enumerate(fields):
            want = tocc.density_grid_update(
                grids[s], lambda p: f(p)[0], 4.0, gs, cascade, 10.0,
                jitter=jitter[s])
            torch.testing.assert_close(got[0][s], want[0], rtol=1e-6,
                                       atol=0)
            torch.testing.assert_close(got[2][s], want[2], rtol=1e-6,
                                       atol=0)
            assert torch.equal(got[1][s], want[1])
    o = torch.randn(2, 64, 3) * 3.0
    d = torch.nn.functional.normalize(-o + torch.randn(2, 64, 3) * 0.3,
                                      dim=-1)
    near, far = torch.full((2, 64), 0.1), torch.full((2, 64), 8.0)
    nf = tocc.occupancy_near_far(got[1], o, d, near, far, 4.0, gs, cascade)
    for s in range(2):
        want = tocc.occupancy_near_far(got[1][s], o[s], d[s], near[s],
                                       far[s], 4.0, gs, cascade)
        for a, b in zip(nf, want):
            assert torch.equal(a[s], b)


def test_batched_rejects_ragged_scenes():
    scenes = _loop_scenes(1, 3, 32) + _loop_scenes(1, 4, 32)
    cfg = tloop.DistillConfig(max_itr=1)
    with pytest.raises(ValueError, match="equal image sizes and frame"):
        batched_distillation_loop(None, scenes, [[0, 1], [0, 1]], cfg,
                                  torch.Generator(), use_diffusion=False,
                                  verbose=False)
    with pytest.raises(ValueError, match="equal context sizes"):
        batched_distillation_loop(None, scenes[:1] * 2, [[0, 1], [0]], cfg,
                                  torch.Generator(), use_diffusion=False,
                                  verbose=False)
