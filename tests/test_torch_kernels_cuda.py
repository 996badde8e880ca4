"""The CUDA grid-encode kernels against their plain PyTorch version, on a
CUDA card.  Without one these tests skip: a CUDA kernel has no CPU mode.

This file imports no jax, so it also runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

from sparsefusion_tpu_torch.kernels import grid_encode as kernels
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
