"""Port NGP field and volume renderer vs the JAX package.

Weights cross over with ``load_jax_params``; jax.random draws are
replayed here from the same keys the JAX renderer splits and handed to
the port.  Tolerances: 1e-5 (abs and rel) on f32 values of the field,
1e-4 of the largest entry on its gradients (sums in another order); the
renderer's are wider, for the reason given in its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.nn.ngp import trunc_exp as jax_trunc_exp
from sparsefusion_tpu.render import volume as jvol
from sparsefusion_tpu_torch.nn.ngp import (
    NGPConfig,
    NGPField,
    export_jax_params,
    load_jax_params,
    trunc_exp,
)
from sparsefusion_tpu_torch.render import volume as tvol

torch.set_num_threads(2)

SMALL = dict(num_levels=3, log2_hashmap_size=10)


def _jax_field(cfg_kw, seed=0, bg=False):
    kw = dict(SMALL, **cfg_kw)
    if bg:
        kw["bg_radius"] = 1.0
    model = JNGPField(JNGPConfig(**kw))
    method = JNGPField.init_all if bg else None
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((8, 3)),
                        method=method)["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    # a table well away from its 1e-4 init, so the encode matters
    rng = np.random.RandomState(seed)
    params["grid"] = (rng.randn(*params["grid"].shape) * 0.5
                      ).astype(np.float32)
    return model, params


def _port_field(params, cfg_kw=None, bg=False):
    kw = dict(SMALL, **(cfg_kw or {}))
    if bg:
        kw["bg_radius"] = 1.0
    field = NGPField(NGPConfig(**kw))
    load_jax_params(field, params)
    return field


def _rel_close(a, b, tol=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol * max(np.abs(b).max(), 1e-12))


def _rays(n, seed=0):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3)
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 3.0 + 0.3 * rng.randn(n, 3)
    return o.astype(np.float32), d.astype(np.float32)


def test_ngp_field_forward_and_grads_match_jax_pallas_gather():
    model, params = _jax_field({"pallas_gather": True}, bg=True)
    field = _port_field(params, {"pallas_gather": True}, bg=True)
    rng = np.random.RandomState(1)
    x = (rng.rand(200, 3) * 8.0 - 4.0).astype(np.float32)
    gs, ga = rng.randn(200).astype(np.float32), rng.randn(200, 3).astype(
        np.float32)

    def jloss(p):
        s, a = model.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(s * gs) + jnp.sum(a * ga), (s, a)

    (_, (s_j, a_j)), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    s_t, a_t = field(torch.tensor(x))
    ((s_t * torch.tensor(gs)).sum() + (a_t * torch.tensor(ga)).sum()
     ).backward()
    np.testing.assert_allclose(s_t.detach().numpy(), s_j, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(a_t.detach().numpy(), a_j, rtol=1e-5,
                               atol=1e-5)
    _rel_close(field.grid.grad.numpy(), g_j["grid"])
    _rel_close(field.sigma_net_0.weight.grad.numpy().T,
               g_j["sigma_net_0"]["kernel"])
    _rel_close(field.sigma_net_2.bias.grad.numpy(), g_j["sigma_net_2"]["bias"])

    d = rng.randn(50, 3).astype(np.float32)
    bg_j = model.apply({"params": params}, jnp.asarray(d),
                       method=JNGPField.background)
    np.testing.assert_allclose(field.background(torch.tensor(d)).detach(),
                               bg_j, rtol=1e-5, atol=1e-6)

    back = export_jax_params(field)
    np.testing.assert_array_equal(back["sigma_net_1"]["kernel"],
                                  params["sigma_net_1"]["kernel"])
    np.testing.assert_array_equal(back["grid"], params["grid"])


def test_trunc_exp_gradient_clamped_like_jax():
    x = np.linspace(-20, 20, 41).astype(np.float32)
    g_j = jax.grad(lambda v: jnp.sum(jax_trunc_exp(v)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    trunc_exp(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-6)
    assert xt.grad[0] == pytest.approx(np.exp(-15.0), rel=1e-5)
    assert xt.grad[-1] == pytest.approx(np.exp(15.0), rel=1e-5)


def test_near_far_from_aabb_matches_jax():
    o, d = _rays(300, seed=2)
    o[:40] *= 3.0          # some rays start outside the box and miss it
    d[:20] = -d[:20]
    n_j, f_j = jvol.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), 4.0,
                                       0.1)
    n_t, f_t = tvol.near_far_from_aabb(torch.tensor(o), torch.tensor(d), 4.0,
                                       0.1)
    assert (np.asarray(n_j) == 1e10).any()
    np.testing.assert_allclose(n_t.numpy(), n_j, rtol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-6)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_jax(det):
    rng = np.random.RandomState(3)
    bins = np.sort(rng.rand(64, 17) * 5.0, axis=-1).astype(np.float32)
    weights = (rng.rand(64, 16) ** 3).astype(np.float32)
    weights[:4] = 0.0      # degenerate rows: uniform pdf
    key = jax.random.PRNGKey(7)
    z_j = jvol.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24, det,
                          rng=None if det else key)
    u = None if det else torch.tensor(np.asarray(
        jax.random.uniform(key, (64, 24))))
    z_t = tvol.sample_pdf(torch.tensor(bins), torch.tensor(weights), 24, det,
                          u=u)
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-5, atol=1e-5)


def _jax_draws(key, n, vcfg):
    """The draws JAX ``render_rays`` makes from ``key``, in its order."""
    rng, k = jax.random.split(key)
    steps = vcfg.march_steps or vcfg.num_steps
    jitter = jax.random.uniform(k, (n, steps))
    u = None
    if not vcfg.march_steps and vcfg.upsample_steps > 0:
        rng, k = jax.random.split(rng)
        u = torch.tensor(np.asarray(
            jax.random.uniform(k, (n, vcfg.upsample_steps))))
    return torch.tensor(np.asarray(jitter)), u


@pytest.mark.parametrize("march", [0, 12])
def test_render_rays_matches_jax(march):
    """Two-phase (16 + 16) and single-pass march rendering through the
    carried NGP field: outputs and the grid gradient."""
    model, params = _jax_field({})
    field = _port_field(params)
    o, d = _rays(128, seed=4)
    kw = dict(num_steps=16, upsample_steps=16, bound=4.0, min_near=0.1,
              march_steps=march)
    jcfg, tcfg = jvol.VolumeRendererConfig(**kw), \
        tvol.VolumeRendererConfig(**kw)
    key = jax.random.PRNGKey(11)
    g_img = np.random.RandomState(5).randn(128, 3).astype(np.float32)

    def jloss(p):
        out = jvol.render_rays(
            lambda x: model.apply({"params": p}, x), jnp.asarray(o),
            jnp.asarray(d), jcfg, rng=key, perturb=True,
            det_importance=False)
        return jnp.sum(out["image"] * g_img), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    jitter, u = _jax_draws(key, 128, jcfg)
    out_t = tvol.render_rays(field, torch.tensor(o), torch.tensor(d), tcfg,
                             perturb=True, det_importance=False,
                             jitter=jitter, u=u)
    (out_t["image"] * torch.tensor(g_img)).sum().backward()
    # alpha = 1 - exp(-delta * sigma) cancels for near-empty samples, so
    # the one-ulp difference between XLA's and ATen's exp grows by
    # 1 / (delta * sigma); both f32 results sit equally far from a float64
    # render.  The two-phase sampler's inverse CDF, which divides by bin
    # masses down to 1e-5, magnifies that again in the resampled z.
    # Measured over three keys: single pass <= 2e-5 on values and <= 3e-3
    # relative (Frobenius) on gradients; two-phase <= 9e-4 and <= 1.7e-2.
    val_tol, grad_tol = (1e-4, 1e-2) if march else (2e-3, 5e-2)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(out_t[k].detach().numpy(), out_j[k],
                                   rtol=val_tol, atol=val_tol, err_msg=k)
    np.testing.assert_array_equal(out_t["mask"].numpy(), out_j["mask"])
    assert np.asarray(out_j["weights_sum"]).max() > 0.1
    for got, want in ((field.grid.grad, g_j["grid"]),
                      (field.sigma_net_0.weight.grad.T,
                       g_j["sigma_net_0"]["kernel"])):
        want = np.asarray(want)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= grad_tol, rel


def test_render_rays_chunked_remat_same_gradients():
    _, params = _jax_field({})
    o, d = _rays(256, seed=6)
    cfg = tvol.VolumeRendererConfig(num_steps=8, upsample_steps=8,
                                    max_ray_batch=64)
    grads, images = [], []
    for remat in (False, True):
        field = _port_field(params)
        gen = torch.Generator().manual_seed(3)
        out = tvol.render_rays_chunked(field, torch.tensor(o),
                                       torch.tensor(d), cfg, perturb=True,
                                       det_importance=False, remat=remat,
                                       generator=gen)
        (out["image"].sum() + out["weights_sum"].sum()).backward()
        grads.append({n: p.grad.clone() for n, p in field.named_parameters()})
        images.append(out["image"].detach())
    assert torch.equal(images[0], images[1])
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6,
                                   atol=1e-9)
