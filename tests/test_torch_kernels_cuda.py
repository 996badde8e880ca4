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
