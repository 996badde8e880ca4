"""Port Perceiver blocks (``nn/layers.py``: FeedForward, PerceiverAttention,
PerceiverResampler) vs the JAX package's, from the same JAX params at a
small width (dim 32, 2 heads x 16, 8 latents, depth 2).  f32 outputs
agree to 1e-5 (abs and rel)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.nn import layers as jl
from sparsefusion_tpu_torch.nn import layers as tl

torch.set_num_threads(2)

DIM, HEADS, DIM_HEAD = 32, 2, 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _perturb_norms(params, rng):
    """Norm scales and biases away from their 1 / 0 init, so a swapped
    or dropped norm parameter shows."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name in ("scale", "bias", "g"):
            return (node + 0.3 * rng.randn(*node.shape)).astype(np.float32)
        return node
    return walk(params)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mult", [4.0, 2.0])
def test_feed_forward_matches_jax(mult):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, DIM).astype(np.float32)
    jmod = jl.FeedForward(DIM, mult)
    params = _perturb_norms(_np_tree(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]), rng)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tl.FeedForward(DIM, mult)
    tl.load_jax_params(tmod, params)
    _close(tmod(torch.from_numpy(x)), want)


def test_perceiver_attention_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 11, DIM).astype(np.float32)
    lat = rng.randn(2, 8, DIM).astype(np.float32)
    jmod = jl.PerceiverAttention(DIM, DIM_HEAD, HEADS)
    params = _perturb_norms(_np_tree(jmod.init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(lat))["params"]),
        rng)
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(lat))
    tmod = tl.PerceiverAttention(DIM, DIM_HEAD, HEADS)
    tl.load_jax_params(tmod, params)
    got = tmod(torch.from_numpy(x), torch.from_numpy(lat))
    assert got.shape == (2, 8, DIM)
    _close(got, want)


@pytest.mark.parametrize("pooled", [4, 0])
def test_perceiver_resampler_matches_jax(pooled):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 13, DIM).astype(np.float32)
    kw = dict(depth=2, dim_head=DIM_HEAD, heads=HEADS, num_latents=8,
              num_latents_mean_pooled=pooled, max_seq_len=20)
    jmod = jl.PerceiverResampler(DIM, **kw)
    params = _perturb_norms(_np_tree(jmod.init(
        jax.random.PRNGKey(2), jnp.asarray(x))["params"]), rng)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tl.PerceiverResampler(DIM, **kw)
    tl.load_jax_params(tmod, params)
    got = tmod(torch.from_numpy(x))
    assert got.shape == (3, 8 + pooled, DIM)
    _close(got, want)


def test_perceiver_init_like_flax_draws_normal_positions_and_latents():
    from sparsefusion_tpu_torch.nn.flax_layout import init_like_flax_

    mod = tl.PerceiverResampler(DIM, depth=1, dim_head=DIM_HEAD,
                                heads=HEADS, num_latents=8,
                                max_seq_len=256)
    init_like_flax_(mod, torch.Generator().manual_seed(0))
    for p in (mod.pos_emb, mod.latents):
        assert abs(p.std().item() - 1.0) < 0.1
    assert (mod.layers[0][0].norm.weight == 1).all()
    assert (mod.layers[0][1][0].g == 1).all()


def test_jax_module_pairs_rejects_other_modules():
    with pytest.raises(TypeError):
        tl.jax_module_pairs(tl.LayerNorm(4))
