"""One train step of the port against the JAX package's ``make_train_step``,
the guarded Adam update against optax's, and the non-finite guard.

Both steps run the same weights (the narrow UNet and VAE of the JAX
package's tiny test models with a randomised final conv, the full-width
EFT; the JAX side gets the port's weights through the JAX package's
converters), the same scenes (one set of numpy arrays) and the same draws:
the test replays the JAX step's key tree (``split(rng, B)``; per scene
``k_t, k_loss = split``; times from ``k_t``; ``k_noise, k_drop =
split(k_loss)``; noise NHWC -> NCHW; keep mask ``bernoulli(k_drop, 0.9)``)
and passes the draws to the port.  The JAX step's optimizers are replaced
by a transformation that returns its gradients as its state, so the
gradients are compared directly: a first Adam step is about lr * sign(g),
which would hide them.  Tolerances: losses 1e-5 relative (f32, another
order of sums); gradients 1e-3 relative (Frobenius over the model; the
backward sums in another order through the EFT's transformers); the Adam
update from equal gradients 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparsefusion_tpu.data.synthetic import make_synthetic_scene
from sparsefusion_tpu.diffusion.ddpm import DDPM as JDDPM
from sparsefusion_tpu.diffusion.ddpm import DDPMConfig as JDDPMConfig
from sparsefusion_tpu.models import SparseFusionModels as JModels
from sparsefusion_tpu.nn.eft import EFTConfig as JEFTConfig
from sparsefusion_tpu.nn.eft import EpipolarFeatureTransformer as JEFT
from sparsefusion_tpu.nn.unet import EfficientUNet as JEfficientUNet
from sparsefusion_tpu.nn.unet import UNetConfig as JUNetConfig
from sparsefusion_tpu.nn.vae import AutoencoderKL as JVAE
from sparsefusion_tpu.nn.vae import VAEConfig as JVAEConfig
from sparsefusion_tpu.train import trainer as jtrainer
from sparsefusion_tpu.train.convert import (
    convert_eft_state_dict,
    convert_unet_state_dict,
    convert_vae_state_dict,
)
from sparsefusion_tpu_torch.data.contract import SceneData
from sparsefusion_tpu_torch.models import build_models, narrow_model_configs
from sparsefusion_tpu_torch.train import trainer

torch.set_num_threads(2)

IMAGE_SIZE, LATENT, DBS = 64, 8, 2


def _port_models():
    narrow = narrow_model_configs()
    g = torch.Generator().manual_seed(0)
    models = build_models(g, "cpu", **narrow)
    with torch.no_grad():   # a zero final conv would hide the UNet
        models.unet.final_conv.weight.normal_(0.0, 0.1, generator=g)
        models.unet.final_conv.bias.normal_(0.0, 0.1, generator=g)
    return models


def _unet_tree(models, sd):
    ucfg = models.unet.config
    return convert_unet_state_dict(
        {f"unets.0.{k}": v for k, v in sd.items()},
        num_levels=len(ucfg.dim_mults),
        num_resnet_blocks=ucfg.num_resnet_blocks,
        layer_attns=ucfg.layer_attns)


def _jax_models(models):
    vcfg = models.vae.config
    narrow = narrow_model_configs()
    return JModels(
        eft_model=JEFT(JEFTConfig()),
        eft_vars=convert_eft_state_dict(models.eft.state_dict()),
        vae_model=JVAE(JVAEConfig(**vars(vcfg))),
        vae_vars=convert_vae_state_dict(models.vae.state_dict(),
                                        ch_mult=vcfg.ch_mult,
                                        num_res_blocks=vcfg.num_res_blocks),
        unet_model=JEfficientUNet(JUNetConfig(**vars(models.unet.config))),
        unet_params=_unet_tree(models, models.unet.state_dict()),
        ddpm=JDDPM(JDDPMConfig(**vars(narrow["ddpm_config"]))))


def _scenes(n):
    """The JAX package's synthetic scenes and the same arrays as the
    port's scene type."""
    jscenes = [make_synthetic_scene(n_views=5, image_size=IMAGE_SIZE,
                                    seed=s) for s in range(n)]
    tscenes = [SceneData(**{f.name: getattr(s, f.name)
                            for f in dataclasses.fields(SceneData)})
               for s in jscenes]
    return jscenes, tscenes


def _grab_gradients():
    """An optax transformation that applies nothing and keeps the
    gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), u))


def _replay_draws(jddpm, key, n_scenes):
    draws = []
    for rng in jax.random.split(key, n_scenes):
        k_t, k_loss = jax.random.split(rng)
        times = jddpm.schedule.sample_random_times(k_t, DBS)
        k_noise, k_drop = jax.random.split(k_loss)
        noise = jax.random.normal(k_noise, (DBS, LATENT, LATENT, 4))
        keep = jax.random.bernoulli(k_drop, 0.9, (DBS,))
        draws.append({
            "times": torch.tensor(np.asarray(times)),
            "noise": torch.tensor(np.ascontiguousarray(
                np.transpose(np.asarray(noise), (0, 3, 1, 2)))),
            "keep": torch.tensor(np.asarray(keep))})
    return draws


def _rel_frobenius(got_tree, want_tree):
    got = np.concatenate([np.ravel(x) for x in
                          jax.tree_util.tree_leaves(got_tree)])
    want = np.concatenate([np.ravel(x) for x in
                           jax.tree_util.tree_leaves(want_tree)])
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _grad_state_dict(module):
    """The module's state dict with each parameter replaced by its
    gradient (buffers as they are), for the JAX converters."""
    sd = dict(module.state_dict())
    for name, p in module.named_parameters():
        sd[name] = p.grad.detach().clone() if p.grad is not None \
            else torch.zeros_like(p)
    return sd


def check_train_step_against_jax(train_eft, n_scenes,
                                 compute_dtype="float32", loss_rel=1e-5,
                                 grad_rel=1e-3, program=False):
    """One step of each package from the same weights, scenes and draws:
    losses (to ``loss_rel``), gradients (to ``grad_rel``, Frobenius over
    each model), and the port's updates applied.  With ``program`` the
    port runs ``TrainStep.program`` (the depth range computed from the
    context cameras, the guard on the device) in place of the eager
    step.  Returns the worst relative errors seen and the port's models
    and optimizers."""
    models = _port_models()
    jmodels = _jax_models(models)
    jscenes, tscenes = _scenes(n_scenes)
    query = [0] * n_scenes
    ctx = [[1, 2]] * n_scenes
    key = jax.random.PRNGKey(5)

    jcfg = jtrainer.TrainConfig(latent_size=LATENT, context_size=2,
                                train_eft=train_eft,
                                diffusion_batch_size=DBS,
                                compute_dtype=compute_dtype)
    grab = _grab_gradients()
    jstep = jtrainer.make_train_step(jmodels, jcfg, grab, grab)
    state = {"unet_params": jmodels.unet_params,
             "eft_params": jmodels.eft_vars["params"],
             "opt_state": grab.init(jmodels.unet_params),
             "eft_opt_state": grab.init(jmodels.eft_vars["params"])
             if train_eft else None}
    # the JAX step donates its state
    state = jax.tree_util.tree_map(jnp.copy, state)
    new_state, aux = jstep(
        state, jtrainer.prepare_scene_batch(jscenes, query, ctx), key)

    cfg = trainer.TrainConfig(latent_size=LATENT, context_size=2,
                              train_eft=train_eft, diffusion_batch_size=DBS,
                              compute_dtype=compute_dtype)
    unet_opt, eft_opt = trainer.make_optimizers(cfg, models)
    step = trainer.make_train_step(models, cfg, unet_opt, eft_opt)
    evals0 = models.unet_evals
    batch = trainer.prepare_scene_batch(tscenes, query, ctx)
    draws = _replay_draws(jmodels.ddpm, key, n_scenes)
    if program:
        del batch["depth_range"]
        loss, d_loss, color_loss = step.program(batch, draws=draws)
    else:
        loss, d_loss, color_loss = step(batch, draws=draws)
    assert models.unet_evals - evals0 == n_scenes

    worst = {"loss": abs(float(loss) / float(aux["loss"]) - 1)}
    assert float(loss) == pytest.approx(float(aux["loss"]), rel=loss_rel)
    assert float(d_loss) == pytest.approx(float(aux["d_loss"]), rel=loss_rel)
    if train_eft:
        assert float(color_loss) == pytest.approx(float(aux["color_loss"]),
                                                  rel=loss_rel)
    else:
        assert float(color_loss) == 0.0

    rel = _rel_frobenius(_unet_tree(models, _grad_state_dict(models.unet)),
                         new_state["opt_state"])
    worst["unet_grad"] = rel
    assert rel <= grad_rel, ("unet", rel)
    if train_eft:
        got = convert_eft_state_dict(_grad_state_dict(models.eft))["params"]
        rel = _rel_frobenius(got, new_state["eft_opt_state"])
        worst["eft_grad"] = rel
        assert rel <= grad_rel, ("eft", rel)
    else:
        assert all(p.grad is None for p in models.eft.parameters())
    # one applied update on each trained model, none skipped
    assert unet_opt.schedule.last_epoch == 1 and unet_opt.notfinite == 0
    return worst, models, (unet_opt, eft_opt)


def test_train_step_matches_jax():
    """The EFT trained, one scene (the frozen EFT and two scenes are in
    ``test_torch_train_step_{frozen_eft,two_scenes}.py``, each file a JAX
    compile of its own step)."""
    check_train_step_against_jax(train_eft=True, n_scenes=1)


def test_guarded_adam_matches_optax():
    """Equal gradients into optax's guarded Adam with its staircase decay
    and into the port's: equal parameters after each of 5 steps, the
    third of which has a NaN gradient that both skip."""
    cfg = trainer.TrainConfig(lr=1e-2, lr_decay_step=2, lr_decay_gamma=0.5)
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": (3,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx, _ = jtrainer.make_optimizers(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    opt = trainer.GuardedAdam(tparams.values(), cfg.lr, cfg)
    for i in range(5):
        grads = {k: rng.randn(*s).astype(np.float32) * 10.0 ** -i
                 for k, s in shapes.items()}
        if i == 2:
            grads["b"][1] = np.nan
        updates, jstate = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        assert opt.step(bool(opt.nonfinite_flag() == 0)) == (i != 2)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0)
    assert opt.notfinite == jtrainer.notfinite_count(jstate) == 1
    assert opt.schedule.last_epoch == 4


def test_nonfinite_guard_skips_update():
    """Seven NaN batches: the parameters stay bit-identical, the Adam
    state empty, the schedule unmoved, the count 7 (the guard never gives
    up); then a clean batch updates."""
    models = _port_models()
    cfg = trainer.TrainConfig(latent_size=LATENT, context_size=2,
                              train_eft=False, diffusion_batch_size=DBS)
    unet_opt, eft_opt = trainer.make_optimizers(cfg, models)
    assert eft_opt is None
    step = trainer.make_train_step(models, cfg, unet_opt)
    _, scenes = _scenes(1)
    good = trainer.prepare_scene_batch(scenes, [0], [[1, 2]])
    bad = dict(good, query_rgb=good["query_rgb"].clone())
    bad["query_rgb"][..., 0] = float("nan")

    before = {k: v.clone() for k, v in models.unet.state_dict().items()}
    g = torch.Generator().manual_seed(0)
    for _ in range(7):
        loss, _, _ = step(bad, g)
        assert not torch.isfinite(loss)
    for k, v in models.unet.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert trainer.notfinite_count(unet_opt) == 7
    assert unet_opt.adam.state_dict()["state"] == {}
    assert unet_opt.schedule.last_epoch == 0

    loss, _, _ = step(good, g)
    assert torch.isfinite(loss)
    assert trainer.notfinite_count(unet_opt) == 7
    assert unet_opt.schedule.last_epoch == 1
    assert any(not torch.equal(v, before[k])
               for k, v in models.unet.state_dict().items())

