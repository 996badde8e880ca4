"""The DDPM's training loss, ancestral sampling and the schedule's time
helpers: the port against the JAX package.

The denoiser is a small closed form written in both frameworks (latents
NHWC in JAX, NCHW in the port), so the test holds the loss and the
sampler, not a network.  The JAX functions draw from their keys; the test
replays those draws (noise, keep mask, the sampler's normals) and passes
them to the port.  Tolerance 1e-5 relative: f32 on both sides, the same
expressions in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.diffusion.ddpm import DDPM as JDDPM
from sparsefusion_tpu.diffusion.ddpm import DDPMConfig as JDDPMConfig
from sparsefusion_tpu.diffusion.schedule import (
    GaussianDiffusion as JGaussianDiffusion,
)
from sparsefusion_tpu_torch.diffusion.ddpm import DDPM, DDPMConfig
from sparsefusion_tpu_torch.diffusion.schedule import GaussianDiffusion

torch.set_num_threads(2)

B, H, W, C, F = 3, 4, 4, 4, 5


def _jax_denoise(x, log_snr, cond, keep):
    """eps from latents (B, H, W, C), log-SNR (B,), features (B, H, W, F)."""
    c = cond.mean(axis=-1, keepdims=True) * keep[:, None, None, None]
    return jnp.tanh(0.7 * x + 0.05 * log_snr[:, None, None, None] + c)


def _torch_denoise(x, log_snr, cond, keep):
    c = cond.mean(dim=1, keepdim=True) * keep.float()[:, None, None, None]
    return torch.tanh(0.7 * x + 0.05 * log_snr[:, None, None, None] + c)


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gamma", [0.5, 0.0])
@pytest.mark.parametrize("loss_type", ["l2", "l1", "huber"])
def test_p_losses_match_jax(loss_type, gamma, masked):
    kw = dict(loss_type=loss_type, p2_loss_weight_gamma=gamma)
    jddpm = JDDPM(JDDPMConfig(**kw))
    tddpm = DDPM(DDPMConfig(**kw))
    rng = np.random.RandomState(0)
    x0 = rng.randn(B, H, W, C).astype(np.float32) * 1.5
    cond = rng.randn(B, H, W, F).astype(np.float32)
    mask = (rng.rand(B, H, W, 1) > 0.4).astype(np.float32) if masked \
        else None
    times = np.array([0.05, 0.5, 0.97], np.float32)
    key = jax.random.PRNGKey(7)

    want = jddpm.p_losses(_jax_denoise, jnp.asarray(x0), jnp.asarray(times),
                          key, cond_images=jnp.asarray(cond),
                          loss_mask=None if mask is None
                          else jnp.asarray(mask))
    k_noise, k_drop = jax.random.split(key)
    noise = jax.random.normal(k_noise, x0.shape)
    keep = jax.random.bernoulli(k_drop, 0.9, (B,))
    got = tddpm.p_losses(
        _torch_denoise, _nchw(x0), torch.tensor(times),
        cond_images=_nchw(cond),
        loss_mask=None if mask is None else _nchw(mask),
        noise=_nchw(noise), keep_mask=torch.tensor(np.asarray(keep)))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_p_losses_draws_from_the_generator():
    """Without draws given, noise and keep mask come from the generator:
    the same seed gives the same loss, another seed another."""
    ddpm = DDPM(DDPMConfig())
    x0 = torch.randn(B, C, H, W, generator=torch.Generator().manual_seed(0))
    cond = torch.randn(B, F, H, W, generator=torch.Generator().manual_seed(1))
    times = torch.tensor([0.1, 0.4, 0.8])

    def loss(seed):
        return float(ddpm.p_losses(_torch_denoise, x0, times,
                                   torch.Generator().manual_seed(seed),
                                   cond_images=cond))

    assert loss(3) == loss(3)
    assert loss(3) != loss(4)


def test_p_sample_loop_matches_jax():
    """Four ancestral steps from pure noise, with the JAX loop's normal
    draws (the initial noise, then one per step)."""
    jddpm = JDDPM(JDDPMConfig(timesteps=4))
    tddpm = DDPM(DDPMConfig(timesteps=4))
    rng = np.random.RandomState(1)
    cond = rng.randn(B, H, W, F).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jddpm.p_sample_loop(_jax_denoise, key, (B, H, W, C),
                               cond_images=jnp.asarray(cond))

    k_init, k_loop = jax.random.split(key)
    noises = [jax.random.normal(k_init, (B, H, W, C))]
    for _ in range(4):
        k_loop, sub = jax.random.split(k_loop)
        noises.append(jax.random.normal(sub, (B, H, W, C)))
    got = tddpm.p_sample_loop(_torch_denoise, (B, C, H, W),
                              cond_images=_nchw(cond),
                              noises=[_nchw(n) for n in noises])
    want = _nchw(want)
    assert torch.isfinite(got).all()
    rel = float((got - want).norm() / want.norm())
    assert rel <= 1e-5, rel
    # sample() is the same loop, its shape taken from the config
    again = tddpm.sample(_torch_denoise, cond_images=_nchw(cond),
                         noises=[_nchw(n) for n in noises])
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_sampling_timesteps_match_jax():
    jsched = JGaussianDiffusion("cosine", 8)
    tsched = GaussianDiffusion("cosine", 8)
    want = np.asarray(jsched.get_sampling_timesteps(3))
    got = tsched.get_sampling_timesteps(3).numpy()
    assert got.shape == want.shape == (8, 2, 3)
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_random_times_are_in_range():
    sched = GaussianDiffusion()
    g = torch.Generator().manual_seed(0)
    t = sched.sample_random_times(4096, g)
    assert t.shape == (4096,)
    assert 0.0 <= float(t.min()) and float(t.max()) < 0.999
    assert abs(float(t.mean()) - 0.4995) < 0.02
    tb = sched.sample_random_times_bounded(4096, g, 0.2, 0.6)
    assert 0.2 <= float(tb.min()) and float(tb.max()) < 0.6
    # one generator state, one draw
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    torch.testing.assert_close(sched.sample_random_times(7, g1, 0.5),
                               0.5 * torch.rand(7, generator=g2))
