"""The fused loop (``distill/fused.py``: ``DistillConfig.fused_steps``) and
the losses' read cadence (``loss_fetch_every``), on the CPU.

On the CPU the fused programs run eagerly (``fused_steps=True``): the
same functions that a CUDA device captures into graphs.

* The fused loop against the unfused loop, the three cases of the JAX
  package's ``tests/test_distill_fused.py`` on the same tiny models:
  diffusion, photometric only, and occupancy marching with ray subsets.
  They must be equal exactly: the fused programs make the same draws in
  the same order, their sampler computes the times on the device in
  float64 as the host does (``diffusion/plms.py::plms_schedule``) and
  takes one graph per Adams-Bashforth order, so it does the unfused
  sampler's arithmetic, and the back program renders the grid again with
  the front's draws, which gives the same image.
* Each fused program of a fusion iteration against the JAX loop's
  counterpart (``_fusion_front`` / ``_fusion_back``, composed here as
  ``sparsefusion_tpu/distill/loop.py:712-750`` composes them, and
  ``_step0_jit`` / ``_scan_tail_jit``) with the JAX draws passed in, and
  the tensor-time sampler against ``plms_sample_host(scan_tail=True)``.
* ``loss_fetch_every``: the losses equal per-iteration reads, and the
  reads' iterations (the port's ``loss_read`` spans, the JAX loop's
  ``sync_times``) are the JAX loop's, in the sequential loop and the
  scene-batched one.
* The learning rates' staircase on tensors equals ``StepLR``'s, and
  ``--no_fused`` sets ``fused_steps=False``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.data.contract import SceneData as JSceneData
from sparsefusion_tpu.diffusion.ddpm import DDPM as JDDPM
from sparsefusion_tpu.diffusion.ddpm import DDPMConfig as JDDPMConfig
from sparsefusion_tpu.diffusion.plms import (
    _scan_tail_jit,
    _step0_jit,
    host_schedule,
    plms_sample_host,
)
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
from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
from sparsefusion_tpu_torch.diffusion.ddpm import DDPM, DDPMConfig
from sparsefusion_tpu_torch.diffusion.plms import plms_sample
from sparsefusion_tpu_torch.distill import batched as tbatched
from sparsefusion_tpu_torch.distill import loop as tloop
from sparsefusion_tpu_torch.distill.fused import FusedIterations
from sparsefusion_tpu_torch.models import build_models, narrow_model_configs
from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPField, load_jax_params
from sparsefusion_tpu_torch.render.volume import VolumeRendererConfig
from sparsefusion_tpu_torch.utils import spans

torch.set_num_threads(2)

NGP_KW = dict(num_levels=4, log2_hashmap_size=10)
HW, IMAGE_SIZE = 16, 32


# ---- the fused loop against the unfused loop --------------------------

LOOP_CASES = {
    "diffusion": (True, {}),
    "photometric_only": (False, {}),
    # the TPU preset's features: occupancy marching (the grid updated every
    # iteration from the first) and the ray-subset input and fusion steps
    "occupancy_marching_ray_subsets": (True, dict(
        use_occupancy=True, occupancy_start=1, occupancy_update_every=1,
        occ_march_steps=8, input_rays=64, fusion_rays=64, remat=False)),
}


def _run_loop(fused, use_diffusion, **overrides):
    models = build_models(torch.Generator().manual_seed(0), "cpu",
                          **narrow_model_configs())
    scene = make_synthetic_scene(n_views=3, image_size=IMAGE_SIZE, seed=0)
    cfg = tloop.DistillConfig(
        max_itr=4, start_fusion_step=1, n_aug_cameras=2, plms_steps=4,
        num_steps=8, upsample_steps=8, max_ray_batch=256,
        ngp=NGPConfig(**NGP_KW), fused_steps=fused, **overrides)
    out = tloop.distillation_loop(models, scene, [0, 1], cfg,
                                  torch.Generator().manual_seed(1),
                                  use_diffusion=use_diffusion, verbose=False)
    return out


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_fused_loop_equals_unfused_loop(monkeypatch, case):
    """2 bootstrap and 2 fusion iterations (4 input steps without the
    diffusion arm): the same losses, parameters and renders, bit for
    bit."""
    monkeypatch.setattr(tloop, "OCC_GRID_SIZE", 32)
    use_diffusion, overrides = LOOP_CASES[case]
    ref = _run_loop(False, use_diffusion, **overrides)
    fus = _run_loop(True, use_diffusion, **overrides)
    assert ref["fused"] is None
    assert fus["fused"] == {"graphs": False, "warmups": 0, "captures": [],
                            "replays": 0}
    assert len(fus["losses"]) == 4
    assert fus["losses"] == ref["losses"]
    assert fus["fusion_losses"] == ref["fusion_losses"]
    assert len(fus["fusion_losses"]) == (4 if use_diffusion else 0)
    assert fus["unet_evals"] == ref["unet_evals"]
    for a, b in zip(jax.tree_util.tree_leaves(ref["ngp_params"]),
                    jax.tree_util.tree_leaves(fus["ngp_params"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref["renders"], fus["renders"])
    if case == "occupancy_marching_ray_subsets":
        assert fus["render_modes"] == {"two_phase": 1, "march": 3}
        assert fus["fusion_subset_steps"] == 2


def test_fused_loop_runs_every_sampler_order():
    """A fusion iteration of 4 PLMS steps (max_thres 0.6) runs step 0 and
    the tail at all three Adams-Bashforth orders: 2 + 3 UNet
    evaluations (``cond_scale`` 1: one a guided epsilon)."""
    models = build_models(torch.Generator().manual_seed(0), "cpu",
                          **narrow_model_configs())
    prog = _programs(models)
    before = models.unet_evals
    loss, floss = prog.iteration(0, prog.vc, 1, 0, 0.6, fusion=True)
    assert models.unet_evals - before == 5
    assert np.isfinite(float(loss)) and np.isfinite(float(floss))
    assert int(prog.buffers["idx"]) == 4


# ---- each fused program against the JAX loop's ------------------------

STEP_KW = dict(num_steps=8, upsample_steps=8, max_ray_batch=128,
               plms_steps=4)


def _replay_chunk_draws(key, n, chunk):
    """The draws JAX ``render_rays_chunked`` makes from ``key``."""
    jit, us = [], []
    for kk in jax.random.split(key, n // chunk):
        rng, k = jax.random.split(kk)
        jit.append(jax.random.uniform(k, (chunk, 8)))
        rng, k = jax.random.split(rng)
        us.append(jax.random.uniform(k, (chunk, 8)))
    return {"jitter": torch.tensor(np.asarray(jnp.concatenate(jit))),
            "u": torch.tensor(np.asarray(jnp.concatenate(us)))}


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


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


def _programs(tmodels, params=None):
    """The port's fused programs on a 2-view scene, one cached camera
    (view 1) with random features and EFT image; the NGP from the JAX
    ``params`` where given."""
    tcfg = tloop.DistillConfig(ngp=NGPConfig(**NGP_KW), **STEP_KW)
    scene = make_synthetic_scene(n_views=2, image_size=IMAGE_SIZE, seed=0)
    field = NGPField(tcfg.ngp)
    if params is not None:
        load_jax_params(field, jax.tree_util.tree_map(np.asarray,
                                                      dict(params)))
    steps = tloop.make_scene_step_fns(
        field, tcfg, tloop.make_ngp_optimizer(tcfg, field), HW, IMAGE_SIZE,
        models=tmodels)
    vox = tcam.get_relative_cameras(
        tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                            scene.image_size), [0], center_at_origin=False)
    rng = np.random.RandomState(3)
    cache = {"cameras_vox": tcam.get_camera_slice(vox, [1]),
             "features": torch.tensor(rng.randn(1, 256, 4, 4)
                                      .astype(np.float32)),
             "eft_images": torch.tensor(rng.rand(1, IMAGE_SIZE, IMAGE_SIZE, 3)
                                        .astype(np.float32))}
    prog = FusedIterations(steps, torch.Generator().manual_seed(5), vox,
                           torch.tensor(scene.images),
                           torch.tensor(scene.masks), cache)
    prog.vc = VolumeRendererConfig(num_steps=8, upsample_steps=8,
                                   max_ray_batch=128)
    prog.field, prog.scene = field, scene
    return prog


def test_fused_programs_match_jax():
    """One fusion iteration, program by program, from the same NGP, models
    and draws (JAX's key tree: the iteration's split3, fusion_step's
    split3, the q-sample's split, step 0's and the tail's), at max_thres
    0.6: 4 PLMS steps, so step 0 and the tail at orders 1, 2 and 3.
    After the input step (its loss held at the steps' 1e-4 relative,
    ``test_torch_fusion``) the JAX side takes the port's parameters, so
    that each later program is held alone.  Tolerances: the front's
    latents, the sampler's state after step 0 and after the tail 1e-4 of
    their scale (measured 2.0e-5, 1.2e-5 and 7.0e-6; eps 1.7e-6); the
    weight 1e-6; the fusion loss 1e-4 relative and the gradient that the
    back program's update takes 1e-2 (Frobenius, relative; measured
    1.0e-3 on the grid, <= 1.7e-4 elsewhere), against
    ``jax.value_and_grad`` of the JAX fusion loss.  The updates are not
    compared: the two Adams' moments differ since the input step, and
    Adam's second step turns that into sign flips of tiny updates."""
    jcfg = jloop.DistillConfig(ngp=JNGPConfig(**NGP_KW), **STEP_KW)
    mt = 0.6
    jmodels, tmodels = _trio()
    jfield = JNGPField(jcfg.ngp)
    params = jfield.init(jax.random.PRNGKey(0), jnp.zeros((8, 3)))["params"]
    tx = jloop.make_ngp_optimizer(jcfg)
    opt_state = tx.init(params)
    jsteps = jloop.make_scene_step_fns(jfield, jcfg, tx, HW, IMAGE_SIZE)
    jv = JVolumeRendererConfig(num_steps=8, upsample_steps=8,
                               max_ray_batch=128)
    prog = _programs(tmodels, params)
    scene = prog.scene
    jvox = jcam.get_relative_cameras(
        JSceneData(images=scene.images, R=scene.R, T=scene.T, f=scene.f,
                   c=scene.c, valid_region=scene.valid_region,
                   image_size=scene.image_size,
                   masks=scene.masks).cameras(), [0], center_at_origin=False)
    jc_in, jc_f = (jcam.get_camera_slice(jvox, [v]) for v in (0, 1))
    bitfield = jnp.zeros((8,), jnp.uint8)
    feats = jnp.asarray(np.transpose(prog.features.numpy(), (0, 2, 3, 1)))
    ddpm, dn = jmodels.ddpm, jmodels.denoise_fn()

    # front: the JAX _fusion_front's body
    _, k1, k2 = jax.random.split(jax.random.PRNGKey(11), 3)
    params, opt_state, loss_j = jax.jit(jsteps.input_step,
                                        static_argnums=0)(
        jv, params, opt_state, jc_in, jnp.asarray(scene.images[0]),
        jnp.asarray(scene.masks[0]), k1, bitfield)
    prog.bi.fill_(0)
    prog.ci.fill_(0)
    prog.mt.fill_(mt)
    k_r, _, k_s = jax.random.split(k2, 3)
    prog.fusion_front(prog.vc,
                      draws=_replay_chunk_draws(k1, HW * HW, 128),
                      fusion_draws=dict(_replay_chunk_draws(k_r, HW * HW,
                                                            128),
                                        init_noise=_nchw(jax.random.normal(
                                            jax.random.split(k_s)[0],
                                            (1, 4, 4, 4)))))
    assert float(prog.loss) == pytest.approx(float(loss_j), rel=1e-4)
    # the rest of the iteration from the port's parameters after its
    # input step, so that each program is held alone
    params = _as_jax_params(params, prog.field)
    img = jax.jit(jsteps.render_up_img, static_argnums=0)(
        jv, params, jc_f, k_r, bitfield)
    latents = jax.jit(jmodels.vae_encode_p)(jmodels.vae_vars, img[None])
    k_init, k_loop = jax.random.split(k_s)
    init_noise = jax.random.normal(k_init, latents.shape, latents.dtype)
    x_noisy, log_snr = ddpm.schedule.q_sample(latents, mt, init_noise)
    weight = 1.0 - jax.nn.sigmoid(log_snr)[0]
    assert float(prog.buffers["weight"]) == pytest.approx(float(weight),
                                                          rel=1e-6)

    def close(got, want, what):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, (what, err)

    close(prog.buffers["x"], _nchw(x_noisy), "front: x_noisy")

    # PLMS step 0 and the tail: the JAX host sampler's jitted programs
    _, n_steps, times = host_schedule(mt, 4)
    assert n_steps == 4
    key_out, sub = jax.random.split(k_loop)
    n1, n2, _ = (jax.random.normal(k, latents.shape)
                 for k in jax.random.split(sub, 3))
    img1, hist, key_after = _step0_jit(ddpm, dn, 1.0, 1)(
        k_loop, x_noisy, float(times[0]), float(times[1]), feats)
    prog.step0(noises=(_nchw(n1), _nchw(n2)))
    close(prog.buffers["x"], _nchw(img1), "step 0: x")
    close(prog.buffers[("hist", 0)], _nchw(hist[0]), "step 0: eps")

    t_pairs = np.asarray([[times[i], times[i + 1]] for i in range(4)],
                         np.float32)
    tail = _scan_tail_jit(ddpm, dn, 1.0, 1, 4)(
        key_after, img1, hist, np.int32(1), np.int32(n_steps), t_pairs,
        feats)
    k = key_after
    for i in range(1, n_steps):
        k1_, k = jax.random.split(k)
        prog.tail(min(i, 3),
                  noise=_nchw(jax.random.normal(k1_, latents.shape)))
    close(prog.buffers["x"], _nchw(tail), "tail: x")

    # back: the JAX _fusion_back's body
    dcfg = ddpm.config
    pred = jnp.clip(tail, -dcfg.clip_value, dcfg.clip_value) \
        if dcfg.clip_output else tail
    pred_img = jax.jit(jmodels.vae_decode_p)(jmodels.vae_vars, pred)[0]
    floss_j, grads_j = jax.jit(jax.value_and_grad(
        jsteps.fusion_losses, argnums=1), static_argnums=0)(
        jv, params, jc_f, pred_img, weight, k_r, bitfield)
    grads = {}
    adam_step = prog.steps.optimizer.step

    def step():   # the gradient the back program's update takes
        grads.update({n: p.grad.numpy().copy()
                      for n, p in prog.field.named_parameters()})
        adam_step()

    prog.steps.optimizer.step = step
    prog.fusion_back(prog.vc)
    assert float(prog.floss) == pytest.approx(float(floss_j), rel=1e-4)
    for name, want in _as_port_names(grads_j).items():
        rel = np.linalg.norm(grads[name] - want) / np.linalg.norm(want)
        assert rel <= 1e-2, (name, rel)


def _as_port_names(params):
    out = {"grid": np.asarray(params["grid"])}
    for name, layer in params.items():
        if name != "grid":
            out[f"{name}.weight"] = np.asarray(layer["kernel"]).T
            out[f"{name}.bias"] = np.asarray(layer["bias"])
    return out


def _as_jax_params(params, field):
    """The JAX parameter tree ``params`` holding the port field's values,
    copied: ``jnp.asarray`` of a tensor's numpy view shares the tensor's
    memory on the CPU, and JAX dispatches asynchronously, so the port's
    next in-place update could reach a JAX computation launched before
    it (its gradients then moved by up to 0.29, under load)."""
    got = {n: np.array(p.detach().numpy())
           for n, p in field.named_parameters()}

    def leaf(path, _):
        keys = [p.key for p in path]
        if keys == ["grid"]:
            return jnp.asarray(got["grid"])
        name, kind = keys
        return jnp.asarray(got[f"{name}.weight"].T if kind == "kernel"
                           else got[f"{name}.bias"])

    return jax.tree_util.tree_map_with_path(leaf, params)


def _jax_host_draws(rng, shape, n_steps):
    """The normal draws of ``plms_sample_host(scan_tail=True)`` along its
    key tree, NCHW."""
    k_init, key = jax.random.split(rng)
    draws = [jax.random.normal(k_init, shape)]
    if n_steps > 0:
        key, sub = jax.random.split(key)
        k1, k2, _ = jax.random.split(sub, 3)
        draws += [jax.random.normal(k1, shape), jax.random.normal(k2, shape)]
    for _ in range(1, n_steps):
        k1, key = jax.random.split(key)
        draws.append(jax.random.normal(k1, shape))
    return [_nchw(d) for d in draws]


@pytest.mark.parametrize("max_thres", [0.35, 0.995, 0.004])
def test_tensor_time_sampler_matches_jax_host_sampler(max_thres):
    """The port's sampler (tensor times from ``plms_schedule``) against
    ``plms_sample_host(scan_tail=True)`` on a toy denoiser (the JAX
    package's ``tests/test_plms_host.py``), with the JAX draws: within
    1e-5, the JAX test's own tolerance between its sampler forms
    (measured <= 6e-8)."""
    from sparsefusion_tpu.diffusion.plms import host_schedule

    def jden(x, log_snr, cond_images, keep_mask):
        return 0.1 * x + jnp.sin(log_snr).reshape(-1, 1, 1, 1) * 0.05

    def tden(x, log_snr, cond_images, keep_mask):
        return 0.1 * x + torch.sin(log_snr).reshape(-1, 1, 1, 1) * 0.05

    rng = jax.random.PRNGKey(3)
    image = jax.random.normal(jax.random.PRNGKey(7), (2, 4, 4, 4)) * 0.2
    want = plms_sample_host(JDDPM(JDDPMConfig(timesteps=500)), jden, rng,
                            image, max_thres, plms_steps=8, scan_tail=True)
    _, n_steps, _ = host_schedule(max_thres, 8)
    got = plms_sample(DDPM(DDPMConfig(timesteps=500)), tden, _nchw(image),
                      max_thres, plms_steps=8,
                      noises=_jax_host_draws(rng, image.shape, n_steps))
    for name, g, w in zip(("img", "x_noisy", "init_noise"), got, want):
        np.testing.assert_allclose(g.numpy(), _nchw(w).numpy(), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               atol=1e-6)


# ---- loss_fetch_every ---------------------------------------------------

def _recorded(run, *args):
    """``run(*args)`` with every iteration recorded by the span
    recorder."""
    spans.enable()
    try:
        return run(*args)
    finally:
        spans.disable()


def _reads(result):
    """The iterations of a port loop's loss reads (its ``loss_read``
    spans)."""
    return [s["unit"] for s in result["spans"] if s["name"] == "loss_read"]


def test_loss_fetch_every_gives_the_per_iteration_losses():
    """Reading every 3 iterations gives the losses of reading every one;
    the reads at iterations 2, 5 and the last (7)."""
    def run(every):
        scene = make_synthetic_scene(n_views=3, image_size=IMAGE_SIZE,
                                     seed=0)
        cfg = tloop.DistillConfig(
            max_itr=8, n_aug_cameras=2, num_steps=8, upsample_steps=8,
            max_ray_batch=256, ngp=NGPConfig(**NGP_KW),
            loss_fetch_every=every)
        return tloop.distillation_loop(None, scene, [0, 1], cfg,
                                       torch.Generator().manual_seed(1),
                                       use_diffusion=False, verbose=False)

    each, every3 = _recorded(run, 1), _recorded(run, 3)
    assert every3["losses"] == each["losses"] and len(each["losses"]) == 8
    assert _reads(each) == list(range(8))
    assert _reads(every3) == [2, 5, 7]
    assert [s["unit"] for s in every3["spans"] if s["kind"] == "unit"] \
        == list(range(8))


def _stub_jax_loop(monkeypatch, cfg, scene, save_dir):
    """The JAX loop with its steps and renders replaced by stubs whose
    losses count the calls (no jit, so each call counts)."""
    calls = []

    def make_steps(ngp_model, cfg_, tx, render_hw, image_size,
                   lpips_fn=None):
        def step(vc, params, opt_state, *args):
            calls.append(len(calls))
            return params, opt_state, jnp.float32(len(calls))

        def unused(*args):
            raise AssertionError("the NGP-only loop took a diffusion step")

        return types.SimpleNamespace(
            input_step=step, bootstrap_step=unused, render_up_img=unused,
            fusion_grad_step=unused, make_nff=lambda bitfield: None)

    def render(ngp_model, params, cam, hw, vcfg, rng, perturb,
               near_far_fn=None, ray_idx=None, remat=True):
        return jnp.zeros((hw, hw, 3)), jnp.zeros((hw, hw, 1))

    class Field:
        def __init__(self, config):
            self.config = config

        def init(self, key, x):
            return {"params": {}}

    monkeypatch.setattr(jloop, "NGPField", Field)
    monkeypatch.setattr(jloop, "make_scene_step_fns", make_steps)
    monkeypatch.setattr(jloop, "_render_cam", render)
    monkeypatch.setattr(jloop, "get_interpolated_path",
                        lambda cams, n, **kw: cams)
    monkeypatch.setattr(jloop, "_save_outputs", lambda *a, **k: None)
    monkeypatch.setattr(jloop, "_save_intermediate", lambda *a, **k: None)
    with jax.disable_jit():
        return jloop.distillation_loop(
            None, JSceneData(images=scene.images, R=scene.R, T=scene.T,
                             f=scene.f, c=scene.c,
                             valid_region=scene.valid_region,
                             image_size=scene.image_size, masks=scene.masks),
            [0, 1], cfg, jax.random.PRNGKey(0), save_dir=save_dir,
            use_diffusion=False, verbose=False)


def _stub_port_loop(monkeypatch, cfg, scene, save_dir):
    calls = []

    def make_steps(field, cfg_, optimizer, render_hw, image_size,
                   lpips_fn=None, models=None):
        def input_step(vc, cam, rgb, mask, generator, bitfield=None):
            calls.append(len(calls))
            return torch.tensor(float(len(calls)))

        return types.SimpleNamespace(input_step=input_step,
                                     make_nff=lambda bitfield: None)

    def render(field, cam, hw, vcfg, perturb, generator=None, **kw):
        return torch.zeros(hw, hw, 3), torch.zeros(hw, hw, 1)

    monkeypatch.setattr(tloop, "make_scene_step_fns", make_steps)
    monkeypatch.setattr(tloop, "_render_cam", render)
    monkeypatch.setattr(tloop, "_save_outputs", lambda *a, **k: None)
    monkeypatch.setattr(tloop, "_save_intermediate", lambda *a, **k: None)
    return tloop.distillation_loop(None, scene, [0, 1], cfg,
                                   torch.Generator(), save_dir=save_dir,
                                   use_diffusion=False, verbose=False)


@pytest.mark.parametrize("every,eval_every", [(3, 5), (20, 0), (1, 4)])
def test_loss_reads_follow_the_jax_loop(monkeypatch, tmp_path, every,
                                        eval_every):
    """The iterations of the loss reads (the port's ``loss_read`` spans,
    the JAX loop's ``sync_times``: every ``loss_fetch_every``, at
    ``eval_every`` and at the end) and the losses read, against the JAX
    loop's, both with their steps stubbed."""
    kw = dict(max_itr=11, n_aug_cameras=2, num_steps=8, upsample_steps=8,
              max_ray_batch=64, loss_fetch_every=every,
              eval_every=eval_every)
    scene = make_synthetic_scene(n_views=3, image_size=8, seed=0)
    want = _stub_jax_loop(monkeypatch, jloop.DistillConfig(
        ngp=JNGPConfig(**NGP_KW), **kw), scene, str(tmp_path / "jax"))
    got = _recorded(_stub_port_loop, monkeypatch, tloop.DistillConfig(
        ngp=NGPConfig(**NGP_KW), **kw), scene, str(tmp_path / "port"))
    assert _reads(got) == [i for i, _ in want["sync_times"]]
    assert got["losses"] == want["losses"] == [float(i) for i in
                                               range(1, 12)]


def test_batched_loop_reads_losses_every_loss_fetch_every():
    """The scene-batched loop: reading every 3 iterations gives the
    per-iteration reads' losses, at the JAX batched loop's iterations
    (``(itr + 1) % loss_fetch_every == 0`` or the last)."""
    def run(every):
        scenes = [make_synthetic_scene(n_views=3, image_size=16, seed=s)
                  for s in range(2)]
        cfg = tloop.DistillConfig(
            max_itr=5, n_aug_cameras=2, num_steps=8, upsample_steps=8,
            max_ray_batch=64, ngp=NGPConfig(**NGP_KW),
            loss_fetch_every=every)
        return tbatched.batched_distillation_loop(
            None, scenes, [[0, 1], [0, 1]], cfg,
            torch.Generator().manual_seed(1), use_diffusion=False,
            verbose=False)

    each, every3 = _recorded(run, 1), _recorded(run, 3)
    for a, b in zip(each, every3):
        assert a["losses"] == b["losses"] and len(a["losses"]) == 5
    assert _reads(every3[0]) == [2, 4]
    assert _reads(each[0]) == list(range(5))


# ---- the optimizer's staircase and the CLI switch ---------------------

@pytest.mark.parametrize("step_size,gamma", [(3, 0.2), (6000, 0.2),
                                             (1, 0.7), (2, 0.5), (4, 1.0)])
def test_tensor_staircase_equals_steplr(step_size, gamma):
    """``TensorStepLR`` (the rates of the capturable Adam on the card)
    against ``StepLR`` over 300 updates: each rate equal to StepLR's,
    rounded to float32, including the subnormal tail of a fast decay."""
    bases = (5e-3, 5e-4)
    params = [torch.nn.Parameter(torch.zeros(1)) for _ in bases]
    sgd = torch.optim.SGD([{"params": [p], "lr": b}
                           for p, b in zip(params, bases)])
    ref = torch.optim.lr_scheduler.StepLR(sgd, step_size, gamma)
    got = tloop.TensorStepLR(bases, step_size, gamma)
    for _ in range(300 if step_size < 100 else 10):
        for g, lr in zip(sgd.param_groups, got.lrs):
            assert lr.dtype == torch.float32
            assert float(lr) == float(np.float32(g["lr"]))
        sgd.step()
        ref.step()
        got.step()


def test_no_fused_sets_fused_steps_false(monkeypatch, tmp_path):
    seen = []

    def loop(models, scene, input_idx, cfg, generator, **kw):
        seen.append(cfg.fused_steps)
        return {}

    monkeypatch.setattr(tloop, "distillation_loop", loop)
    argv = ["-d", "synthetic", "-c", "any", "-i", "0", "--no_diffusion",
            "--image_size", "16", "--device", "cpu",
            "--exp_dir", str(tmp_path)]
    demo.main(argv + ["--no_fused"])
    demo.main(argv)
    assert seen == [False, None]
    assert demo.parse_args(argv + ["--no_fused"]).no_fused
