"""The diffusion side of the port against the JAX package: schedule,
DDPM guidance and clipping, the view-conditioned UNet, and the PLMS
sampler on the same draws.

The UNet is the JAX package's tiny test model (``tests/test_distillation``)
with its zero-initialised final conv replaced by random values on both
sides (a zero conv predicts eps = 0 and would hide the network); the JAX
side gets the port's weights through the JAX package's converter.  The
sampler's normal draws are made with jax.random along the JAX sampler's
key tree and handed to the port.  Tolerances (f32 both sides): schedule
2e-5 relative (measured 8.5e-6, on the log of a posterior variance near
0, where exp and log of the two libraries differ by ulps); one UNet
evaluation 5e-5 absolute on outputs of magnitude ~5 (measured 7.6e-6);
a whole PLMS trajectory 1e-4 absolute (measured 3.5e-5).
"""
import jax
import numpy as np
import pytest
import torch

from sparsefusion_tpu.diffusion import ddpm as jddpm
from sparsefusion_tpu.diffusion import plms as jplms
from sparsefusion_tpu.diffusion.schedule import (
    GaussianDiffusion as JGaussianDiffusion,
)
from sparsefusion_tpu.nn.unet import EfficientUNet as JEfficientUNet
from sparsefusion_tpu.nn.unet import UNetConfig as JUNetConfig
from sparsefusion_tpu.train.convert import convert_unet_state_dict
from sparsefusion_tpu_torch.diffusion import ddpm as tddpm
from sparsefusion_tpu_torch.diffusion import plms as tplms
from sparsefusion_tpu_torch.diffusion.schedule import GaussianDiffusion
from sparsefusion_tpu_torch.nn.unet import EfficientUNet, UNetConfig

torch.set_num_threads(2)

TINY = dict(dim=32, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
            layer_attns=(False, True), layer_cross_attns=(False, False),
            cond_images_channels=16, attn_heads=2, attn_dim_head=8)


def nchw(a):
    return torch.tensor(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def unet_pair():
    """The port's UNet at Flax-default init with a random final conv, and
    the JAX UNet applying the same weights (converted by the JAX
    package's own ``convert_unet_state_dict``)."""
    g = torch.Generator().manual_seed(0)
    tm = EfficientUNet(UNetConfig(**TINY)).init_weights_(g).eval()
    with torch.no_grad():
        tm.final_conv.weight.normal_(0.0, 0.1, generator=g)
        tm.final_conv.bias.normal_(0.0, 0.1, generator=g)
    params = convert_unet_state_dict(
        {f"unets.0.{k}": v for k, v in tm.state_dict().items()},
        num_levels=2, num_resnet_blocks=TINY["num_resnet_blocks"],
        layer_attns=TINY["layer_attns"])
    jm = JEfficientUNet(JUNetConfig(**TINY))

    @jax.jit  # an eager Flax apply dispatches op by op
    def jax_fn(x, log_snr, cond, keep):
        return jm.apply({"params": params}, x, log_snr, cond, keep)

    return jax_fn, tm


@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_schedule_matches_jax(name):
    rng = np.random.RandomState(1)
    t = rng.uniform(0.0, 0.999, 6).astype(np.float32)
    t_next = (t * 0.7).astype(np.float32)
    x0 = rng.randn(6, 4, 3, 3).astype(np.float32)
    xt = rng.randn(6, 4, 3, 3).astype(np.float32)
    eps = rng.randn(6, 4, 3, 3).astype(np.float32)
    js, ts = JGaussianDiffusion(name, 500), GaussianDiffusion(name, 500)
    tt = torch.tensor(t)
    pairs = [(js.log_snr(t), ts.log_snr(tt)),
             (js.get_condition(t), ts.get_condition(tt)),
             (js.q_sample(x0, t, eps)[0],
              ts.q_sample(torch.tensor(x0), tt, torch.tensor(eps))[0]),
             (js.predict_start_from_noise(xt, t, eps),
              ts.predict_start_from_noise(torch.tensor(xt), tt,
                                          torch.tensor(eps)))]
    for want, got in zip(js.q_posterior(x0, xt, t, t_next),
                         ts.q_posterior(torch.tensor(x0), torch.tensor(xt),
                                        tt, torch.tensor(t_next))):
        pairs.append((want, got))
    pairs.append((js.q_posterior(x0, xt, t)[0],
                  ts.q_posterior(torch.tensor(x0), torch.tensor(xt), tt)[0]))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("dynamic", [False, True])
def test_clip_x_start_matches_jax(dynamic):
    x = (np.random.RandomState(2).randn(3, 4, 2, 2) * 8).astype(np.float32)
    jcfg = jddpm.DDPMConfig(dynamic_thresholding=dynamic)
    tcfg = tddpm.DDPMConfig(dynamic_thresholding=dynamic)
    want = np.asarray(jddpm.clip_x_start(x, jcfg))
    got = tddpm.clip_x_start(torch.tensor(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unet_forward_matches_jax(unet_pair):
    jax_fn, tm = unet_pair
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    cond = rng.randn(2, 4, 4, 16).astype(np.float32)  # resized to 8x8
    log_snr = rng.randn(2).astype(np.float32) * 3
    keep = np.array([True, False])
    want = np.asarray(jax_fn(x, log_snr, cond, keep))
    with torch.no_grad():
        got = nhwc(tm(nchw(x), torch.tensor(log_snr), nchw(cond),
                      torch.tensor(keep)))
    assert np.abs(want).max() > 0.5  # the network is not silent
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_cond_scale_guidance_matches_jax(unet_pair):
    jax_fn, tm = unet_pair
    rng = np.random.RandomState(4)
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    cond = rng.randn(1, 8, 8, 16).astype(np.float32)
    log_snr = np.array([1.5], np.float32)
    want = np.asarray(jddpm.DDPM().forward_with_cond_scale(
        jax_fn, x, log_snr, cond, 3.0))
    with torch.no_grad():
        got = nhwc(tddpm.DDPM().forward_with_cond_scale(
            tm, nchw(x), torch.tensor(log_snr), nchw(cond), 3.0))
    np.testing.assert_allclose(got, want, atol=2e-4)


def _jax_plms_draws(key, shape, n_steps):
    """The normal draws of the JAX ``plms_sample`` along its key tree:
    the initial noise, two for step 0, one for each later step."""
    k_init, key = jax.random.split(key)
    draws = [jax.random.normal(k_init, shape)]
    if n_steps > 0:
        key, sub = jax.random.split(key)
        k1, k2, _ = jax.random.split(sub, 3)
        draws += [jax.random.normal(k1, shape), jax.random.normal(k2, shape)]
    for _ in range(1, n_steps):
        k1, key = jax.random.split(key)
        draws.append(jax.random.normal(k1, shape))
    return [nchw(np.asarray(d)) for d in draws]


@pytest.mark.parametrize("max_thres", [0.3, 0.995])
def test_plms_sample_matches_jax(unet_pair, max_thres):
    jax_fn, tm = unet_pair
    plms_steps = 4
    rng = np.random.RandomState(5)
    image = rng.randn(1, 8, 8, 4).astype(np.float32)
    cond = rng.randn(1, 8, 8, 16).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jd = jddpm.DDPM(jddpm.DDPMConfig(timesteps=100))
    want = jax.jit(lambda k, im, c: jplms.plms_sample(
        jd, jax_fn, k, im, max_thres, cond_images=c,
        plms_steps=plms_steps))(key, image, cond)

    full_start, n_steps, _ = tplms.host_schedule(max_thres, plms_steps)
    assert n_steps == (plms_steps if max_thres >= 0.99 else 2)
    noises = _jax_plms_draws(key, image.shape, n_steps)
    evals = []

    def counted(*a):
        evals.append(1)
        return tm(*a)

    got = tplms.plms_sample(
        tddpm.DDPM(tddpm.DDPMConfig(timesteps=100)), counted, nchw(image),
        max_thres, cond_images=nchw(cond), plms_steps=plms_steps,
        noises=noises)
    assert len(evals) == n_steps + 1   # step 0 evaluates twice
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(nhwc(got[1]), np.asarray(want[1]), atol=1e-5)
    np.testing.assert_allclose(nhwc(got[2]), np.asarray(want[2]), atol=0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-6)


def test_host_schedule_matches_jax():
    for mt in (0.0, 0.004, 0.26, 0.5, 0.98, 0.99):
        assert tplms.host_schedule(mt, 50) == jplms.host_schedule(mt, 50)
