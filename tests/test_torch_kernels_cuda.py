"""The CUDA kernels (grid encode K1, imagen attention K2) against their
plain PyTorch versions, on a CUDA card.  Without one these tests skip: a
CUDA kernel has no CPU mode.

This file imports no jax, so it also runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

from sparsefusion_tpu_torch.kernels import attention
from sparsefusion_tpu_torch.kernels import grid_encode as kernels
from sparsefusion_tpu_torch.ops.attention import imagen_attention_plain
from sparsefusion_tpu_torch.ops.grid_encode import (
    grid_encode,
    grid_encode_plain,
    make_grid_encoding,
)

CASES = {
    "tiled": (dict(num_levels=4, level_dim=2, base_resolution=4,
                   log2_hashmap_size=9, per_level_scale=1.9,
                   gridtype="tiled"), None),
    "hash": (dict(num_levels=4, level_dim=2, base_resolution=8,
                  log2_hashmap_size=10, gridtype="hash"), None),
    "tiled_bf16_c4": (dict(num_levels=4, level_dim=4, base_resolution=4,
                           log2_hashmap_size=9, per_level_scale=1.9,
                           gridtype="tiled"), "bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw, table_dtype = CASES[case]
    enc = make_grid_encoding(**kw)
    rng = np.random.RandomState(3)
    x = torch.tensor((rng.rand(4096, 3) * 1.1 - 0.05).astype(np.float32))
    table = torch.tensor((rng.randn(enc.total_params, enc.level_dim) * 0.5
                          ).astype(np.float32))
    g = torch.tensor(rng.randn(4096, enc.output_dim).astype(np.float32))

    tp = table.clone().requires_grad_()
    out_p = grid_encode_plain(x, tp, enc, table_dtype)
    (out_p * g).sum().backward()

    kernels.reset_launches()
    tk = table.cuda().requires_grad_()
    out_k = grid_encode(x.cuda(), tk, enc, table_dtype)
    (out_k * g.cuda()).sum().backward()
    torch.cuda.synchronize()
    assert kernels.grid_encode_cuda.launches == 1
    assert kernels.grid_encode_cuda_backward.launches == 1
    np.testing.assert_allclose(out_k.detach().cpu().numpy(),
                               out_p.detach().numpy(), atol=1e-5)
    # f32 atomics add in another order than the plain scatter
    np.testing.assert_allclose(tk.grad.cpu().numpy(), tp.grad.numpy(),
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_encode_refuses_position_gradients():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    enc = make_grid_encoding(num_levels=2, gridtype="tiled")
    x = torch.rand(8, 3, device="cuda", requires_grad=True)
    table = torch.zeros(enc.total_params, enc.level_dim, device="cuda")
    with pytest.raises(ValueError, match="positions"):
        grid_encode(x, table, enc)


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys", [17, 19, 1027])
def test_imagen_attention_kernel_matches_plain(n_keys):
    """The UNet's shapes (16 queries, 17 or 19 keys) and the long shape
    the TPU kernel was written for; f32, online softmax in the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    b, n = (2, 1024) if n_keys == 1027 else (1, 16)
    rng = np.random.RandomState(n_keys)
    q = torch.tensor(rng.randn(b, 8, n, 64).astype(np.float32) / 8).cuda()
    k = torch.tensor(rng.randn(b, n_keys, 64).astype(np.float32)).cuda()
    v = torch.tensor(rng.randn(b, n_keys, 64).astype(np.float32)).cuda()
    attention.reset_launches()
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention.imagen_attention(qa, ka, va)
    torch.cuda.synchronize()
    assert attention.imagen_attention_cuda.launches == 1
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    want = imagen_attention_plain(qp, kp, vp)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    g = torch.randn_like(out)
    (out * g).sum().backward()
    (want * g).sum().backward()
    for got, ref in ((qa, qp), (ka, kp), (va, vp)):
        torch.testing.assert_close(got.grad, ref.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_imagen_attention_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(1, 2, 4, 48, device="cuda")
    k = torch.zeros(1, 3, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        attention.imagen_attention_cuda(q, k, k)
    q = torch.zeros(1, 2, 4, 64, device="cuda")
    k = torch.zeros(1, 3, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        attention.imagen_attention_cuda(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="float32"):
        attention.imagen_attention_cuda(q.double(), k.double(), k.double())


# (H, N) pairs with H*N = 5, 16, 128 and 8192 rows of one batch
ATTN_ROWS = [(1, 5), (8, 2), (8, 16), (8, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n_keys", [1, 7, 8, 9, 17, 19, 64, 65, 1027])
@pytest.mark.parametrize("hn", ATTN_ROWS, ids=lambda hn: f"H{hn[0]}N{hn[1]}")
@pytest.mark.parametrize("b", [1, 2])
def test_imagen_attention_kernel_ragged_shapes(b, hn, n_keys, d):
    """Partial m-tiles (rows not a multiple of 16), partial and single
    k/v tiles (J around the 8-key steps and the 32- or 64-key tiles),
    both head dims; the 3xTF32 products keep f32 accuracy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    h, n = hn
    rng = np.random.RandomState(b * 1000 + n_keys + d)
    q = torch.tensor((rng.randn(b, h, n, d) * d ** -0.5).astype(np.float32))
    k = torch.tensor(rng.randn(b, n_keys, d).astype(np.float32))
    v = torch.tensor(rng.randn(b, n_keys, d).astype(np.float32))
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    got = attention.imagen_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, imagen_attention_plain(q, k, v),
                               atol=1e-5, rtol=0)


def _ray_points(n_rays, n_samples, seed):
    from sparsefusion_tpu_torch.ops.grid_encode import ray_ordered_points

    return ray_ordered_points(n_rays, n_samples,
                              torch.Generator(device="cuda").manual_seed(seed),
                              "cuda")


BWD_CASES = {
    # the main path's encoding on one launch's points, ray by ray
    "rays_ngp": (dict(num_levels=16, level_dim=2, base_resolution=16,
                      log2_hashmap_size=16, desired_resolution=8192,
                      gridtype="tiled"), None,
                 lambda: _ray_points(4096, 64, 0)),
    # every lane of every warp on the same 8 rows per level
    "identical_points": (CASES["tiled"][0], None,
                         lambda: torch.full((65536, 3), 0.4321,
                                            device="cuda")),
    "rays_bf16_c4": (CASES["tiled_bf16_c4"][0], "bfloat16",
                     lambda: _ray_points(1024, 64, 1)),
    "rays_hash": (CASES["hash"][0], None, lambda: _ray_points(1024, 64, 2)),
    "rays_c1": (dict(CASES["tiled"][0], level_dim=1), None,
                lambda: _ray_points(256, 64, 3)),
    "rays_c8": (dict(CASES["tiled"][0], level_dim=8), None,
                lambda: _ray_points(256, 64, 4)),
    # a partial last tile: 1000 points is not a multiple of the block
    "uniform_ragged": (CASES["hash"][0], None,
                       lambda: torch.rand(1000, 3, device="cuda") * 1.1
                       - 0.05),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_cuda_table_gradient_on_clustered_points(case):
    """The warp-merged backward against the plain scatter where many
    neighbouring points share rows.  Tolerance: f32 sums in another
    order, so it scales with the largest accumulated gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw, table_dtype = BWD_CASES[case][:2]
    torch.manual_seed(5)
    x = BWD_CASES[case][2]()
    enc = make_grid_encoding(**kw)
    table = torch.randn(enc.total_params, enc.level_dim, device="cuda") * 0.5
    g = torch.randn(x.shape[0], enc.output_dim, device="cuda")

    got = kernels.grid_encode_cuda_backward(x, g, enc,
                                            table_dtype == "bfloat16")
    tp = table.clone().requires_grad_()
    if case == "identical_points":
        # the same gradient by linearity, without the drift of the plain
        # scatter's sequential f32 sum over 65,536 terms
        x, g = x[:1], g.double().sum(0, keepdim=True).float()
    (want,) = torch.autograd.grad(grid_encode_plain(x, tp, enc, table_dtype),
                                  tp, g)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert scale > 0
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, scale), (err, scale)


# a small tiled grid: levels 0-1 take the identity, 2-3 wrap (mask)
FWD_ENC = dict(num_levels=4, base_resolution=4, log2_hashmap_size=9,
               per_level_scale=1.9, gridtype="tiled")


def _forward_check(x, enc, table_dtype, seed):
    """The forward kernel against the plain version on the same table;
    both read bf16 values and round the weights alike, so f32 sums in
    another order are the only difference."""
    rng = np.random.RandomState(seed)
    table = torch.tensor((rng.randn(enc.total_params, enc.level_dim) * 0.5
                          ).astype(np.float32), device="cuda")
    tk = table if table_dtype is None else table.to(torch.bfloat16)
    kernels.reset_launches()
    got = kernels.grid_encode_cuda(x, tk, enc)
    torch.cuda.synchronize()
    assert kernels.grid_encode_cuda.launches == 1
    assert got.shape == (x.shape[0], enc.output_dim) and got.is_contiguous()
    want = grid_encode_plain(x, table, enc, table_dtype)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("level_dim", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 255, 257, 4097])
def test_cuda_forward_ragged_tiles(n, level_dim, table_dtype):
    """Blocks of 256 points with a partial last one (or a lone point);
    every row width in f32 and bf16 (one vector load per row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    enc = make_grid_encoding(level_dim=level_dim, **FWD_ENC)
    rng = np.random.RandomState(n * 10 + level_dim)
    x = torch.tensor((rng.rand(n, 3) * 1.1 - 0.05).astype(np.float32),
                     device="cuda")
    if n == 1:
        x[0] = 0.3
    _forward_check(x, enc, table_dtype, n + level_dim)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("level_dim", [1, 2])
@pytest.mark.parametrize("num_levels", [1, 3, 5])
def test_cuda_forward_rows_off_16_bytes(num_levels, level_dim, table_dtype):
    """L * C not a multiple of 4: the rows of the output are not 16-byte
    aligned, so the kernel stores scalars; a last chunk of fewer levels
    than the 8 / C a chunk holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    enc = make_grid_encoding(level_dim=level_dim,
                             **dict(FWD_ENC, num_levels=num_levels))
    rng = np.random.RandomState(num_levels * 10 + level_dim)
    x = torch.tensor((rng.rand(777, 3) * 1.1 - 0.05).astype(np.float32),
                     device="cuda")
    _forward_check(x, enc, table_dtype, num_levels)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_cuda_forward_ray_ordered_and_outside_the_box(gridtype, table_dtype):
    """The renderer's order (a warp on 32 samples of one ray), with every
    seventh point moved out of the box: those encode to zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if gridtype == "tiled":     # NGPConfig()'s grid, levels 3-15 wrap
        enc = make_grid_encoding(num_levels=16, level_dim=2,
                                 base_resolution=16, log2_hashmap_size=16,
                                 desired_resolution=8192, gridtype="tiled")
    else:
        enc = make_grid_encoding(num_levels=8, level_dim=2,
                                 base_resolution=16, log2_hashmap_size=14,
                                 gridtype="hash")
    x = _ray_points(512, 64, 6)
    x[::7] = x[::7] * 1.3 - 0.15
    outside = ((x < 0) | (x > 1)).any(-1)
    assert outside.any() and not outside.all()
    got = _forward_check(x, enc, table_dtype, 6)
    assert (got[outside] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
def test_cuda_32_levels_of_8(table_dtype):
    """L * C = 256: the backward's staged grad_out tile no longer fits 256
    points in 48 KB of shared memory, so it halves it (to 32 points); the
    forward writes each point's row in 32 chunks of one level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    enc = make_grid_encoding(num_levels=32, level_dim=8, base_resolution=4,
                             log2_hashmap_size=12, per_level_scale=1.2,
                             gridtype="hash")
    rng = np.random.RandomState(8)
    x = torch.tensor((rng.rand(1000, 3) * 1.1 - 0.05).astype(np.float32),
                     device="cuda")
    _forward_check(x, enc, table_dtype, 8)
    g = torch.tensor(rng.randn(1000, enc.output_dim).astype(np.float32),
                     device="cuda")
    got = kernels.grid_encode_cuda_backward(x, g, enc,
                                            table_dtype == "bfloat16")
    tp = torch.zeros(enc.total_params, 8, device="cuda", requires_grad=True)
    (want,) = torch.autograd.grad(grid_encode_plain(x, tp, enc, table_dtype),
                                  tp, g)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("level_dim,dtype", [
    (2, torch.float32), (4, torch.float32), (8, torch.float32),
    (4, torch.bfloat16), (8, torch.bfloat16)])
def test_cuda_forward_refuses_a_misaligned_table(level_dim, dtype):
    """A contiguous view one element into a buffer: the rows' vector loads
    would fault, so the wrapper raises before the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    enc = make_grid_encoding(level_dim=level_dim, **FWD_ENC)
    n = enc.total_params * level_dim
    flat = torch.zeros(n + 8, dtype=dtype, device="cuda")
    table = flat[1:1 + n].view(enc.total_params, level_dim)
    assert table.is_contiguous()
    x = torch.rand(64, 3, device="cuda")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        kernels.grid_encode_cuda(x, table, enc)
    assert kernels.grid_encode_cuda.launches == 0
    kernels.grid_encode_cuda(x, flat[:n].view(enc.total_params, level_dim),
                             enc)


@pytest.mark.cuda
@pytest.mark.parametrize("log2", [9, 12, 16, 19])
@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_cuda_level_plan_matches_its_mirror(gridtype, log2):
    """make_levels' choice of reduction, read back from the built
    library, against kernels/grid_encode.py::level_plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the library builds with nvcc")
    enc = make_grid_encoding(num_levels=16, level_dim=2, base_resolution=16,
                             log2_hashmap_size=log2, gridtype=gridtype,
                             desired_resolution=8192)
    assert kernels.level_plan_cuda(enc) == kernels.level_plan(enc)
