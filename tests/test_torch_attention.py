"""Kernel K2's plain version and the port's attention modules against the
JAX package.

``imagen_attention_plain`` is held against the Pallas kernel in interpret
mode on the CPU and against its jnp reference, at the UNet's 16 tokens
and at 70 tokens (where the TPU would have run the kernel).  The port's
``Attention`` (the caller of K2) and ``CrossAttention`` are held against
the JAX modules with the same parameters.  Tolerance: both sides f32,
1e-5 absolute on O(1) outputs; measured below 1e-6 for the functions and
below 3e-6 for the modules.
"""
import jax
import numpy as np
import pytest
import torch
from torch import nn

from sparsefusion_tpu.kernels.attention import (
    imagen_attention as jax_imagen_attention,
)
from sparsefusion_tpu.kernels.attention import reference_attention
from sparsefusion_tpu.nn import layers as jl
from sparsefusion_tpu_torch.kernels.attention import imagen_attention
from sparsefusion_tpu_torch.nn import layers as tl
from sparsefusion_tpu_torch.nn.flax_layout import load_flax_tree
from sparsefusion_tpu_torch.nn.unet import _attention_pairs
from sparsefusion_tpu_torch.ops.attention import (
    imagen_attention_backward_plain,
    imagen_attention_plain,
)

torch.set_num_threads(2)
TOL = 1e-5


def _qkv(b, h, n, d, j, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, n, d) * d ** -0.5).astype(np.float32)
    k = rng.randn(b, j, d).astype(np.float32)
    v = rng.randn(b, j, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("shape", [(1, 8, 16, 64, 19), (2, 2, 70, 16, 73)])
def test_plain_matches_pallas_kernel_and_reference(shape):
    b, h, n, d, j = shape
    q, k, v = _qkv(*shape)
    block_q = min(512, -(-n // 8) * 8)
    want_kernel = np.asarray(jax_imagen_attention(q, k, v, block_q=block_q,
                                                  interpret=True))
    want_ref = np.asarray(reference_attention(q, k, v))
    got = imagen_attention_plain(*map(torch.tensor, (q, k, v))).numpy()
    assert got.shape == (b, h, n, d)
    np.testing.assert_allclose(got, want_kernel, atol=TOL)
    np.testing.assert_allclose(got, want_ref, atol=TOL)
    # on a CPU tensor the dispatching wrapper is the plain version
    np.testing.assert_array_equal(
        imagen_attention(*map(torch.tensor, (q, k, v))).numpy(), got)


def test_plain_backward_matches_autograd():
    """The kernel's Function differentiates with this plain backward."""
    q, k, v = map(torch.tensor, _qkv(2, 3, 5, 8, 7, seed=1))
    g = torch.randn(2, 3, 5, 8, generator=torch.Generator().manual_seed(0))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    (imagen_attention_plain(qa, ka, va) * g).sum().backward()
    dq, dk, dv = imagen_attention_backward_plain(q, k, v, g)
    for got, want in ((dq, qa.grad), (dk, ka.grad), (dv, va.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


def _port_module(module, jparams, pairs_fn, **kw):
    holder = nn.Module()
    holder.m = module
    load_flax_tree(holder, pairs_fn("m", "m", **kw),
                   {"m": jax.tree_util.tree_map(np.asarray, jparams)})
    return module


@pytest.mark.parametrize("with_context", [False, True])
def test_attention_module_matches_jax(with_context):
    dim, dim_head, heads, n = 32, 16, 4, 16
    rng = np.random.RandomState(2)
    x = rng.randn(2, n, dim).astype(np.float32)
    ctx = rng.randn(2, 2, 24).astype(np.float32) if with_context else None
    jmod = jl.Attention(dim, dim_head, heads,
                        context_dim=24 if with_context else None)
    params = jmod.init(jax.random.PRNGKey(0), x, ctx)["params"]
    want = np.asarray(jmod.apply({"params": params}, x, ctx))

    tmod = _port_module(
        tl.Attention(dim, dim_head, heads,
                     context_dim=24 if with_context else None),
        params, _attention_pairs, context=with_context)
    with torch.no_grad():
        got = tmod(torch.tensor(x),
                   None if ctx is None else torch.tensor(ctx)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_cross_attention_module_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 32).astype(np.float32)
    ctx = rng.randn(2, 2, 24).astype(np.float32)
    jmod = jl.CrossAttention(32, 24, dim_head=8, heads=4)
    params = jmod.init(jax.random.PRNGKey(1), x, ctx)["params"]
    want = np.asarray(jmod.apply({"params": params}, x, ctx))
    tmod = _port_module(tl.CrossAttention(32, 24, dim_head=8, heads=4),
                        params, _attention_pairs, context=False)
    with torch.no_grad():
        got = tmod(torch.tensor(x), torch.tensor(ctx)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_attention_token_order_puts_context_first(monkeypatch):
    """The keys the module hands to K2 are [context, null, self]."""
    torch.manual_seed(0)
    att = tl.Attention(8, dim_head=4, heads=2, context_dim=6)
    seen = {}

    def spy(q, k, v):
        seen["k"] = k
        return imagen_attention_plain(q, k, v)

    monkeypatch.setattr(tl, "imagen_attention", spy)
    x = torch.randn(1, 3, 8)
    ctx = torch.randn(1, 2, 6)
    with torch.no_grad():
        att(x, ctx)
        ck = att.to_context(ctx).chunk(2, dim=-1)[0][0]
    k = seen["k"][0]
    assert k.shape == (2 + 1 + 3, 4)
    torch.testing.assert_close(k[:2], ck)
    torch.testing.assert_close(k[2], att.null_kv[0].detach())
