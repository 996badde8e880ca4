"""Port grid encode vs the JAX package (the CUDA kernel against its plain
version is in ``test_torch_kernels_cuda``).

The same numpy inputs go through JAX ``grid_encode`` (the XLA oracle),
JAX ``blocked_grid_encode(..., pallas_gather=True)`` (the Pallas row
gather K1, in interpret mode on the CPU) and the port's plain
``grid_encode``.  f32 tolerances: atol 1e-5 on values, 1e-4 on table
gradients (sum order).  bf16 tables: 2e-2 relative, because JAX
accumulates its scatter in bf16 and the port in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.ops.grid_encode import grid_encode as jax_grid_encode
from sparsefusion_tpu.ops.grid_encode import (
    make_grid_encoding as jax_make_grid_encoding,
)
from sparsefusion_tpu.ops.grid_encode_blocked import (
    blocked_grid_encode,
    expand_blocked_tables,
    make_blocked_encoding,
)
from sparsefusion_tpu_torch.kernels import grid_encode as kernels
from sparsefusion_tpu_torch.ops.grid_encode import (
    grid_encode,
    grid_encode_bound,
    grid_encode_plain,
    make_grid_encoding,
    ray_ordered_points,
)

torch.set_num_threads(2)

ENC_KW = {
    "tiled": dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=4,
                  log2_hashmap_size=9, per_level_scale=1.9, gridtype="tiled"),
    "hash": dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=8,
                 log2_hashmap_size=10, per_level_scale=2.0, gridtype="hash"),
}


def _inputs(enc, n=96, seed=0):
    rng = np.random.RandomState(seed)
    # a few points leave the unit box: they must encode to zeros
    x = (rng.rand(n, 3) * 1.1 - 0.05).astype(np.float32)
    table = (rng.randn(enc.total_params, enc.level_dim) * 0.5
             ).astype(np.float32)
    g = rng.randn(n, enc.output_dim).astype(np.float32)
    return x, table, g


def _port(x, table, enc, g, table_dtype=None):
    t = torch.tensor(table, requires_grad=True)
    out = grid_encode_plain(torch.tensor(x), t, enc, table_dtype)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def _jax(fn, x, table, g):
    def loss(t):
        out = fn(jnp.asarray(x), t)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(table))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_make_grid_encoding_matches_jax(gridtype):
    a = make_grid_encoding(**ENC_KW[gridtype])
    b = jax_make_grid_encoding(**ENC_KW[gridtype])
    for f in ("offsets", "scales", "resolutions", "strides", "use_hash"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.use_hash.any() == (gridtype == "hash")


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_plain_matches_jax_grid_encode(gridtype):
    enc = make_grid_encoding(**ENC_KW[gridtype])
    jenc = jax_make_grid_encoding(**ENC_KW[gridtype])
    x, table, g = _inputs(enc)
    out_p, grad_p = _port(x, table, enc, g)
    out_j, grad_j = _jax(lambda xx, t: jax_grid_encode(xx, t, jenc),
                         x, table, g)
    oob = ((x < 0) | (x > 1)).any(-1)
    assert oob.any() and not oob.all()
    assert np.all(out_p[oob] == 0)
    np.testing.assert_allclose(out_p, out_j, atol=1e-5)
    np.testing.assert_allclose(grad_p, grad_j, atol=1e-4)


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_plain_matches_jax_on_ray_ordered_points(gridtype):
    """Points as the renderer orders them (ray by ray, sorted samples,
    half packed at a surface, jittered ends clamped onto the box faces):
    many points share each coarse row, so the table gradient sums long
    runs.  Tolerance scales with the largest accumulated gradient (f32
    sums in another order)."""
    enc = make_grid_encoding(**ENC_KW[gridtype])
    jenc = jax_make_grid_encoding(**ENC_KW[gridtype])
    x = ray_ordered_points(64, 32, torch.Generator().manual_seed(4)).numpy()
    rng = np.random.RandomState(4)
    table = (rng.randn(enc.total_params, enc.level_dim) * 0.5
             ).astype(np.float32)
    g = rng.randn(x.shape[0], enc.output_dim).astype(np.float32)
    assert ((x == 0) | (x == 1)).any()     # clamped onto the faces
    out_p, grad_p = _port(x, table, enc, g)
    out_j, grad_j = _jax(lambda xx, t: jax_grid_encode(xx, t, jenc),
                         x, table, g)
    np.testing.assert_allclose(out_p, out_j, atol=1e-5)
    scale = np.abs(grad_j).max()
    assert scale > 5      # long runs of points on one row
    np.testing.assert_allclose(grad_p, grad_j, atol=1e-5 * max(1, scale))


def test_plain_matches_jax_blocked_pallas_gather():
    """Against K1 (``vmem_row_gather``, interpret mode on the CPU)."""
    kw = dict(ENC_KW["tiled"], num_levels=3)
    enc = make_grid_encoding(**kw)
    blk = make_blocked_encoding(jax_make_grid_encoding(**kw))
    x, table, g = _inputs(enc, n=64, seed=1)
    out_p, grad_p = _port(x, table, enc, g)
    out_j, grad_j = _jax(
        lambda xx, t: blocked_grid_encode(
            xx, expand_blocked_tables(t, blk), blk, pallas_gather=True,
            pallas_bin_rows=256), x, table, g)
    np.testing.assert_allclose(out_p, out_j, atol=1e-5)
    np.testing.assert_allclose(grad_p, grad_j, atol=1e-4)


def test_plain_bf16_table_matches_jax_blocked_bf16():
    """table_dtype='bfloat16': weights rounded to bf16 before an f32
    product, as ``grid_encode_blocked.py:269``; the gradient stays f32."""
    kw = dict(ENC_KW["tiled"], num_levels=2, level_dim=4)
    enc = make_grid_encoding(**kw)
    blk = make_blocked_encoding(jax_make_grid_encoding(**kw))
    x, table, g = _inputs(enc, n=64, seed=2)
    out_p, grad_p = _port(x, table, enc, g, "bfloat16")
    out_j, grad_j = _jax(
        lambda xx, t: blocked_grid_encode(
            xx, expand_blocked_tables(t, blk).astype(jnp.bfloat16), blk,
            pallas_gather=True, pallas_bin_rows=256), x, table, g)
    assert grad_p.dtype == np.float32
    scale_o = np.abs(out_j).max()
    scale_g = np.abs(grad_j).max()
    np.testing.assert_allclose(out_p, out_j, atol=2e-2 * scale_o)
    np.testing.assert_allclose(grad_p, grad_j, atol=2e-2 * scale_g)
    # and it is not the f32 result: the bf16 rounding is really applied
    out_f32, _ = _port(x, table, enc, g)
    assert np.abs(out_f32 - out_p).max() > 1e-6


def test_cpu_dispatch_takes_plain_path():
    enc = make_grid_encoding(**ENC_KW["tiled"])
    x, table, _ = _inputs(enc)
    kernels.reset_launches()
    a = grid_encode(torch.tensor(x), torch.tensor(table), enc)
    b = grid_encode_plain(torch.tensor(x), torch.tensor(table), enc)
    assert torch.equal(a, b)
    assert kernels.grid_encode_cuda.launches == 0
    xw = torch.tensor(x).reshape(-1, 3) * 8.0 - 4.0
    c = grid_encode_bound(xw.reshape(4, -1, 3), torch.tensor(table), enc,
                          bound=4.0)
    assert c.shape == (4, x.shape[0] // 4, enc.output_dim)


def test_kernel_wrappers_refuse_what_they_cannot_take():
    enc = make_grid_encoding(**ENC_KW["tiled"])
    x, table, _ = _inputs(enc)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.grid_encode_cuda(torch.tensor(x), torch.tensor(table), enc)
    with pytest.raises(ValueError, match="positions"):
        kernels.grid_encode_fn(torch.tensor(x, requires_grad=True),
                               torch.tensor(table), enc)
    with pytest.raises(ValueError, match="float32"):
        kernels.grid_encode_fn(torch.tensor(x),
                               torch.tensor(table).to(torch.bfloat16), enc)
    with pytest.raises(ValueError, match="3-D"):
        kernels._level_args(make_grid_encoding(input_dim=2, num_levels=2))
