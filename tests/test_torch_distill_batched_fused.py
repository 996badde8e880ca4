"""The scene-batched loop's programs (``distill/fused.py`` over a scene
axis, ``distill/batched.py``), on the CPU.

On the CPU the batched programs run uncaptured: the same functions that
a CUDA device captures into graphs.

* The batched loop against the same loop with each iteration composed of
  ``SceneSteps``' step functions over the scene axis (the unfused
  batched loop, written here), S = 2, in the three cases of
  ``test_torch_distill_fused.py::LOOP_CASES``: diffusion, photometric
  only, and occupancy marching with ray subsets.  They must be equal
  exactly: both gather the iteration's cameras and targets on the device
  from the same (S,) indices and make the same draws in the same order.
* Each batched program of one fusion iteration (front, PLMS step 0, the
  tail at Adams-Bashforth orders 1-3, back) against the JAX batched
  loop's counterpart, composed as ``sparsefusion_tpu/distill/
  batched.py:303-392`` composes it: ``jax.vmap`` of
  ``make_scene_step_fns``' steps with the cameras and targets gathered
  from (S,) index vectors, one VAE encode, ``plms_sample_host`` (its
  step-0 and scan-tail programs) at UNet batch S and one VAE decode, with
  the JAX draws passed in.  Tolerances as ``test_fused_programs_match_
  jax``: states 1e-4 of their scale, losses 1e-4 relative, gradients 1e-2
  (Frobenius, relative) per parameter and scene.
* The device camera gather (``core/cameras.py::pick_cameras``) equals
  ``get_camera_slice`` per scene, bit for bit.
* ``--scene_batch 2 --no_fused`` sets ``fused_steps=False``, which
  builds the batch's programs uncaptured.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.data.synthetic import (
    make_synthetic_scene as jax_synthetic_scene,
)
from sparsefusion_tpu.diffusion.plms import (
    _scan_tail_jit,
    _step0_jit,
    host_schedule,
    plms_sample_host,
)
from sparsefusion_tpu.distill import loop as jloop
from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.render.volume import (
    VolumeRendererConfig as JVolumeRendererConfig,
)
from sparsefusion_tpu_torch.cli import demo
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
from sparsefusion_tpu_torch.distill import batched as tbatched
from sparsefusion_tpu_torch.distill import fused as tfused
from sparsefusion_tpu_torch.distill import loop as tloop
from sparsefusion_tpu_torch.distill.fused import FusedIterations
from sparsefusion_tpu_torch.models import build_models, narrow_model_configs
from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPFieldStack
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig
from tests.test_torch_distill_fused import (
    LOOP_CASES,
    UNCAPTURED,
    _nchw,
    _replay_chunk_draws,
    _trio,
)

torch.set_num_threads(2)

NGP_KW = dict(num_levels=4, log2_hashmap_size=10)
HW, IMAGE_SIZE = 16, 32
S = 2


# ---- the batched loop against the unfused batched loop ---------------

def _unfused_iteration(self, itr, vc, bi, ci=None, mt=None, fusion=False):
    """The batched ``FusedIterations.iteration``'s reference: the input
    step on each scene's view ``bi[s]`` and, with the cache, the
    bootstrap or fusion step on its cached camera ``ci[s]``, each one of
    ``SceneSteps``' step functions over the scene axis, the cameras and
    targets gathered on the device from (S,) indices."""
    steps, gen, bitfield = self.steps, self.generator, self.bitfield
    bi = torch.as_tensor(bi)
    loss = steps.input_step(
        vc, tcam.pick_cameras(self.scene_vox, bi),
        tcam.pick_per_scene(self.scene_rgb, bi),
        None if self.scene_mask is None else
        tcam.pick_per_scene(self.scene_mask, bi), gen, bitfield=bitfield)
    if ci is None:
        return loss, None
    ci = torch.as_tensor(ci)
    cam = tcam.pick_cameras(self.cams_f, ci)
    if fusion:
        return loss, steps.fusion_step(
            vc, cam, tcam.pick_per_scene(self.features, ci), mt, gen,
            bitfield=bitfield)
    return loss, steps.bootstrap_step(
        vc, cam, tcam.pick_per_scene(self.eft_images, ci), gen,
        bitfield=bitfield)


def _run_batched(unfused, use_diffusion, **overrides):
    """The batched loop on the tiny models; with ``unfused``, each
    iteration through :func:`_unfused_iteration`."""
    models = build_models(torch.Generator().manual_seed(0), "cpu",
                          **narrow_model_configs())
    scenes = [make_synthetic_scene(n_views=3, image_size=IMAGE_SIZE, seed=s)
              for s in (0, 1)]
    cfg = tloop.DistillConfig(
        max_itr=4, start_fusion_step=1, n_aug_cameras=2, plms_steps=4,
        num_steps=8, upsample_steps=8, max_ray_batch=256,
        ngp=NGPConfig(**NGP_KW), **overrides)
    with pytest.MonkeyPatch.context() as mp:
        if unfused:
            mp.setattr(FusedIterations, "iteration", _unfused_iteration)
        return tbatched.batched_distillation_loop(
            models, scenes, [[0, 1], [1, 2]], cfg,
            torch.Generator().manual_seed(1), use_diffusion=use_diffusion,
            verbose=False)


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_batched_fused_loop_equals_batched_eager_loop(monkeypatch, case):
    """2 bootstrap and 2 fusion iterations of S = 2 scenes (4 input steps
    without the diffusion arm), against the unfused batched loop: every
    scene's losses, parameters and renders, bit for bit."""
    monkeypatch.setattr(tloop, "OCC_GRID_SIZE", 32)
    monkeypatch.setattr(tbatched, "OCC_GRID_SIZE", 32)
    use_diffusion, overrides = LOOP_CASES[case]
    ref = _run_batched(True, use_diffusion, **overrides)
    fus = _run_batched(False, use_diffusion, **overrides)
    assert len(ref) == len(fus) == S
    for r, f in zip(ref, fus):
        assert r["fused"] == f["fused"] == UNCAPTURED
        assert len(f["losses"]) == 4
        assert f["losses"] == r["losses"]
        assert f["fusion_losses"] == r["fusion_losses"]
        assert len(f["fusion_losses"]) == (4 if use_diffusion else 0)
        assert f["unet_evals"] == r["unet_evals"]
        for a, b in zip(jax.tree_util.tree_leaves(r["ngp_params"]),
                        jax.tree_util.tree_leaves(f["ngp_params"])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r["renders"], f["renders"])
    assert fus[0]["losses"] != fus[1]["losses"]
    if use_diffusion:
        assert fus[0]["unet_evals"] > 0
    if case == "occupancy_marching_ray_subsets":
        assert fus[0]["render_modes"] == {"two_phase": 1, "march": 3}
        assert fus[0]["fusion_subset_steps"] == 2
        assert fus[0]["occupancy"]["update_itrs"] == [1, 2, 3]


# ---- the device camera gather -----------------------------------------

def test_device_camera_gather_equals_camera_slices():
    """``pick_cameras`` of the stacked scenes' cameras at (S,) indices
    gives each scene's ``get_camera_slice``, and ``pick_per_scene`` each
    scene's image, bit for bit."""
    scenes = [make_synthetic_scene(n_views=4, image_size=16, seed=s)
              for s in (0, 1, 2)]
    cams = [tcam.get_relative_cameras(sc.cameras(), [0],
                                      center_at_origin=False)
            for sc in scenes]
    stacked = tcam.stack_cameras(cams)
    assert stacked.R.shape == (3, 4, 3, 3)
    rgb = torch.stack([torch.as_tensor(sc.images) for sc in scenes])
    for idx in ([3, 0, 2], [1, 1, 1], [0, 3, 0]):
        idx_t = torch.tensor(idx)
        got = tcam.pick_cameras(stacked, idx_t)
        want = tcam.concat_cameras([tcam.get_camera_slice(c, [i])
                                    for c, i in zip(cams, idx)])
        for name in ("R", "T", "focal_length", "principal_point",
                     "image_size"):
            assert torch.equal(getattr(got, name), getattr(want, name))
        images = tcam.pick_per_scene(rgb, idx_t)
        for s, i in enumerate(idx):
            assert torch.equal(images[s], torch.as_tensor(scenes[s].images[i]))


# ---- --no_fused builds the batch's programs uncaptured ---------------

def test_scene_batch_no_fused_builds_uncaptured_programs(monkeypatch,
                                                         tmp_path):
    """``--scene_batch 2 --no_fused``: ``fused_steps=False``, one set of
    programs for the batch whose ``GraphRunner`` is asked for no graphs,
    every iteration through them; without the flag ``fused_steps`` stays
    None and the runner is asked for graphs (which it captures on a CUDA
    device only)."""
    seen, asked, iterations = [], [], []
    loop = tbatched.batched_distillation_loop
    runner, iteration = tfused.GraphRunner, FusedIterations.iteration

    def batched(models, scenes, input_idx_list, cfg, generator, **kw):
        seen.append(cfg.fused_steps)
        return loop(models, scenes, input_idx_list, cfg, generator, **kw)

    def graph_runner(*args, graphs=True, **kw):
        asked.append(graphs)
        return runner(*args, graphs=graphs, **kw)

    def counted(self, *args, **kw):
        iterations.append(1)
        return iteration(self, *args, **kw)

    def evaluate_scene(field, scene, *args, **kw):     # Phase C stubbed
        return {"ngp_params": {}, "metrics": {"psnr": 0.0}}

    monkeypatch.setattr(tbatched, "batched_distillation_loop", batched)
    monkeypatch.setattr(tfused, "GraphRunner", graph_runner)
    monkeypatch.setattr(FusedIterations, "iteration", counted)
    monkeypatch.setattr(tbatched, "evaluate_scene", evaluate_scene)
    monkeypatch.setattr(tbatched, "_save_outputs", lambda *a, **k: None)
    argv = ["-d", "synthetic", "-c", "any", "-i", "0,1", "--no_diffusion",
            "--image_size", "16", "--max_itr", "2", "--scene_batch", "2",
            "--device", "cpu", "--exp_dir", str(tmp_path)]
    results = demo.main(argv + ["--no_fused"])
    assert len(results) == 2 and seen == [False] and asked == [False]
    assert len(iterations) == 2
    assert all(r["fused"] == UNCAPTURED for r in results)
    demo.main(argv)
    assert seen == [False, None] and asked == [False, True]


# ---- each batched program against the JAX batched loop's --------------

STEP_KW = dict(num_steps=8, upsample_steps=8, max_ray_batch=128,
               plms_steps=4)
BI, CI = (0, 1), (1, 0)     # each scene's input view and cached camera


def _stack_trees(trees):
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *trees)


def _pick_cam(cams_all, idx_vec):
    """The JAX batched loop's ``_pick_cam``: (S, M, ...) cameras and (S,)
    indices -> (S, 1, ...)."""
    s_idx = jnp.arange(idx_vec.shape[0])
    return jax.tree_util.tree_map(lambda a: a[s_idx, idx_vec][:, None],
                                  cams_all)


def _stack_as_jax(stack):
    """The JAX batched loop's parameter tree (a leading S on every leaf)
    holding an ``NGPFieldStack``'s values, copied (see
    ``test_torch_distill_fused.py::_as_jax_params``: the port's in-place
    update would otherwise reach the JAX programs dispatched before it)."""
    out = {}
    for name, p in stack.named_parameters():
        value = jnp.asarray(np.array(p.detach().numpy()))
        if name == "grid":
            out["grid"] = value
        else:
            layer, leaf = name.split(".")
            out.setdefault(layer, {})[leaf] = value
    return out


def test_batched_programs_match_jax():
    """One fusion iteration of S = 2 scenes, program by program, from the
    same NGPs, models and draws (the JAX batched loop's key tree: the
    iteration's keys split S ways, the sampler's ``fold_in``), at
    max_thres 0.6: 4 PLMS steps, so step 0 and the tail at orders 1, 2
    and 3.  After the input step (its (S,) loss held at 1e-4 relative)
    the JAX side takes the port's parameters, so that each later program
    is held alone."""
    jcfg = jloop.DistillConfig(ngp=JNGPConfig(**NGP_KW), **STEP_KW)
    tcfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), **STEP_KW)
    mt, itr = 0.6, 3
    jmodels, tmodels = _trio()
    init = jax.jit(jax.vmap(JNGPField(jcfg.ngp).init, in_axes=(0, None)))
    params = jax.tree_util.tree_map(np.asarray, init(
        jax.random.split(jax.random.PRNGKey(0), S),
        jnp.zeros((8, 3)))["params"])
    jsteps = jloop.make_scene_step_fns(
        JNGPField(jcfg.ngp), jcfg, jloop.make_ngp_optimizer(jcfg), HW,
        IMAGE_SIZE)
    jv = JVolumeRendererConfig(num_steps=8, upsample_steps=8,
                               max_ray_batch=128)
    tv = VolumeRendererConfig(num_steps=8, upsample_steps=8,
                              max_ray_batch=128)

    # two scenes, each with 2 views and a cache of 2 cameras (its views)
    # with random features and EFT images
    scenes = [jax_synthetic_scene(n_views=2, image_size=IMAGE_SIZE, seed=s)
              for s in (0, 3)]
    rng = np.random.RandomState(3)
    feats = rng.randn(S, 2, 4, 4, 256).astype(np.float32)          # NHWC
    eft = rng.rand(S, 2, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    rgb = np.stack([sc.images for sc in scenes])
    masks = np.stack([sc.masks for sc in scenes])
    tvox = tcam.stack_cameras([tcam.get_relative_cameras(
        tcam.Cameras.create(sc.R, sc.T, sc.f, sc.c, sc.image_size), [0],
        center_at_origin=False) for sc in scenes])
    stack = NGPFieldStack.from_jax_params(tcfg.ngp, params)
    steps = tloop.make_scene_step_fns(
        stack, tcfg, tloop.make_ngp_optimizer(tcfg, stack), HW, IMAGE_SIZE,
        models=tmodels)
    cache = {"cameras_vox": tvox,
             "features": torch.tensor(feats).permute(0, 1, 4, 2, 3),
             "eft_images": torch.tensor(eft)}
    prog = FusedIterations(steps, torch.Generator().manual_seed(5), tvox,
                           torch.tensor(rgb), torch.tensor(masks), cache)
    prog.bi.copy_(torch.tensor(BI))
    prog.ci.copy_(torch.tensor(CI))
    prog.mt.fill_(mt)

    # the JAX side's cameras, gathered as the batched loop gathers them
    jvox = jax.jit(lambda cams: _stack_trees([jcam.get_relative_cameras(
        c, [0], center_at_origin=False) for c in cams]))(
        [sc.cameras() for sc in scenes])
    bi_vec, ci_vec = jnp.asarray(BI), jnp.asarray(CI)
    s_idx = jnp.arange(S)
    bitfield = jnp.zeros((S, 8), jnp.uint8)
    feats_b = jnp.asarray(feats)[s_idx, ci_vec]

    def replay(keys):
        draws = [_replay_chunk_draws(k, HW * HW, 128) for k in keys]
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}

    # front: the input step (``_build_input``), the render
    # (``_build_render``), the VAE encode and the sampler's q-sample
    _, k1, k2 = jax.random.split(jax.random.PRNGKey(11), 3)
    keys1, keys2 = jax.random.split(k1, S), jax.random.split(k2, S)
    loss_j = jax.jit(lambda p, cams, keys: jax.vmap(functools.partial(
        jsteps.input_losses, jv))(
        p, _pick_cam(cams, bi_vec), jnp.asarray(rgb)[s_idx, bi_vec],
        jnp.asarray(masks)[s_idx, bi_vec], keys, bitfield))(
        params, jvox, keys1)
    k_s = jax.random.fold_in(k2, itr)
    k_init, k_loop = jax.random.split(k_s)
    lat_shape = (S, 4, 4, 4)
    prog.fusion_front(tv, draws=replay(keys1), fusion_draws=dict(
        replay(keys2),
        init_noise=_nchw(jax.random.normal(k_init, lat_shape))))
    np.testing.assert_allclose(prog.loss.numpy(), np.asarray(loss_j),
                               rtol=1e-4)
    assert prog.loss.shape == (S,)
    # the rest of the iteration from the port's parameters after its
    # input step, so that each program is held alone
    params = _stack_as_jax(stack)
    imgs = jax.jit(lambda p, cams, keys: jax.vmap(functools.partial(
        jsteps.render_up_img, jv))(p, _pick_cam(cams, ci_vec), keys,
                                   bitfield))(params, jvox, keys2)
    latents = jax.jit(jmodels.vae_encode_p)(jmodels.vae_vars, imgs)
    init_noise = jax.random.normal(k_init, latents.shape, latents.dtype)
    x_noisy, log_snr = jmodels.ddpm.schedule.q_sample(latents, mt,
                                                      init_noise)
    weight = 1.0 - jax.nn.sigmoid(log_snr)
    np.testing.assert_allclose(prog.buffers["weight"].numpy(),
                               np.asarray(weight), rtol=1e-6)

    def close(got, want, what):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, (what, err)

    close(prog.buffers["x"], _nchw(x_noisy), "front: x_noisy")

    # PLMS step 0 and the tail: plms_sample_host's programs at batch S
    ddpm, unet = jmodels.ddpm, jmodels.unet_apply_fn(False)
    unet_params = jmodels.sampler_unet_params(False)
    _, n_steps, times = host_schedule(mt, 4)
    assert n_steps == 4
    _, sub = jax.random.split(k_loop)
    n1, n2, _ = (jax.random.normal(k, latents.shape)
                 for k in jax.random.split(sub, 3))
    img1, hist, key_after = _step0_jit(ddpm, unet, 1.0, S,
                                       with_params=True)(
        unet_params, k_loop, x_noisy, float(times[0]), float(times[1]),
        feats_b)
    prog.step0(noises=(_nchw(n1), _nchw(n2)))
    close(prog.buffers["x"], _nchw(img1), "step 0: x")
    close(prog.buffers[("hist", 0)], _nchw(hist[0]), "step 0: eps")
    t_pairs = np.asarray([[times[i], times[i + 1]] for i in range(4)],
                         np.float32)
    tail = _scan_tail_jit(ddpm, unet, 1.0, S, 4, with_params=True)(
        unet_params, key_after, img1, hist, np.int32(1), np.int32(n_steps),
        t_pairs, feats_b)
    k = key_after
    for i in range(1, n_steps):
        k1_, k = jax.random.split(k)
        prog.tail(min(i, 3), noise=_nchw(jax.random.normal(k1_,
                                                           latents.shape)))
    close(prog.buffers["x"], _nchw(tail), "tail: x")
    # the host sampler itself, as ``fusion_sample_b`` calls it, ends where
    # its two programs do
    pred, _, _, alpha = plms_sample_host(
        ddpm, unet, k_s, latents, mt, cond_images=feats_b, cond_scale=1.0,
        plms_steps=4, scan_tail=True, unet_params=unet_params)
    dcfg = ddpm.config
    np.testing.assert_array_equal(np.asarray(pred), np.asarray(
        jnp.clip(tail, -dcfg.clip_value, dcfg.clip_value)
        if dcfg.clip_output else tail))
    np.testing.assert_allclose(1.0 - np.asarray(alpha), np.asarray(weight),
                               rtol=1e-6)

    # back: the VAE decode and the fusion gradient step
    # (``_build_fusion_grad``), its gradient against the update's
    pred_img = jax.jit(jmodels.vae_decode_p)(jmodels.vae_vars, pred)
    floss_j, grads_j = jax.jit(lambda p, cams, keys: jax.vmap(
        jax.value_and_grad(functools.partial(jsteps.fusion_losses, jv)))(
        p, _pick_cam(cams, ci_vec), pred_img, weight, keys, bitfield))(
        params, jvox, keys2)
    grads = {}
    adam_step = steps.optimizer.step

    def step():   # the gradient the back program's update takes
        grads.update({n: p.grad.numpy().copy()
                      for n, p in stack.named_parameters()})
        adam_step()

    steps.optimizer.step = step
    prog.fusion_back(tv)
    assert prog.floss.shape == (S,)
    np.testing.assert_allclose(prog.floss.numpy(), np.asarray(floss_j),
                               rtol=1e-4)
    want = _stack_as_jax_grads(grads_j)
    assert set(want) == set(grads)
    for name, w in want.items():
        assert grads[name].shape == w.shape, name
        for s in range(S):
            rel = np.linalg.norm(grads[name][s] - w[s]) \
                / np.linalg.norm(w[s])
            assert rel <= 1e-2, (name, s, rel)


def _stack_as_jax_grads(grads):
    out = {"grid": np.asarray(grads["grid"])}
    for name, layer in grads.items():
        if name != "grid":
            for leaf in ("kernel", "bias"):
                out[f"{name}.{leaf}"] = np.asarray(layer[leaf])
    return out
