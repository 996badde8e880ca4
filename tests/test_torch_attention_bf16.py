"""K2's plain version in bf16 and the dispatcher's routing rule, against
the JAX package.

``imagen_attention_plain`` follows the Pallas kernel's arithmetic
(``sparsefusion_tpu/kernels/attention.py::_attn_kernel``): logits with f32
accumulation, the softmax in f32, P rounded to v's type, P v summed in
f32, the output in q's type.  In bf16 it is held against the Pallas
kernel in interpret mode on the same bf16 inputs.  Tolerance: the two sum
in another order in f32 and their exp differ by ulps, so an output may
round to the neighbouring bf16 value (2^-7 relative at most), and a P
may too (2^-9 of one term); measured: 0.02% of the outputs differ, at
most by 1.95e-3 (one ulp at their size), the other shapes not at all.  In f32
every cast of the plain version is a no-op: its result is bit-identical
to the formula it had before it followed the kernel in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.kernels.attention import (
    imagen_attention as jax_imagen_attention,
)
from sparsefusion_tpu_torch.kernels import attention
from sparsefusion_tpu_torch.ops.attention import imagen_attention_plain

torch.set_num_threads(2)
ATOL, RTOL = 2 ** -9, 2 ** -7


def _qkv(b, h, n, d, j, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, n, d) * d ** -0.5).astype(np.float32)
    k = rng.randn(b, j, d).astype(np.float32)
    v = rng.randn(b, j, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("shape", [(1, 8, 16, 64, 19), (12, 8, 16, 64, 17),
                                   (2, 2, 70, 16, 73), (1, 2, 16, 8, 17)])
def test_plain_bf16_matches_pallas_kernel(shape):
    b, h, n, d, j = shape
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(*shape))
    want = jax_imagen_attention(q, k, v, block_q=min(512, -(-n // 8) * 8),
                                interpret=True)
    assert want.dtype == jnp.bfloat16
    tq, tk, tv = (torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()
                  for a in (q, k, v))
    got = imagen_attention_plain(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, n, d)
    want = torch.tensor(np.asarray(want.astype(jnp.float32)))
    torch.testing.assert_close(got.float(), want, atol=ATOL, rtol=RTOL)
    err = (got.float() - want).abs()
    print(f"{shape}: max {err.max().item():.3e}, beyond 2^-8 relative "
          f"{(err - 2 ** -8 * want.abs()).max().item():.3e}, "
          f"{(err > 0).float().mean().item():.2%} of outputs differ")


@pytest.mark.parametrize("shape", [(1, 8, 16, 64, 19), (2, 2, 70, 16, 73)])
def test_plain_f32_is_bit_identical_to_the_f32_formula(shape):
    q, k, v = map(torch.tensor, _qkv(*shape))
    sim = torch.einsum("bhnd,bjd->bhnj", q, k)
    attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
    before = torch.einsum("bhnj,bjd->bhnd", attn, v)
    assert torch.equal(imagen_attention_plain(q, k, v), before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_48_takes_the_plain_version(dtype):
    """D = 48 (``UNetConfig.attn_dim_head`` is free) runs through the
    dispatcher as the plain version, with gradients, in both types."""
    q, k, v = (torch.tensor(a).to(dtype).requires_grad_()
               for a in _qkv(2, 4, 16, 48, 19, seed=3))
    attention.reset_launches()
    out = attention.imagen_attention(q, k, v)
    assert out.dtype == dtype and out.shape == (2, 4, 16, 48)
    assert torch.equal(out, imagen_attention_plain(q, k, v))
    out.float().sum().backward()
    assert all(t.grad is not None and t.grad.dtype == dtype
               for t in (q, k, v))
    assert attention.imagen_attention_cuda.launches == 0


def test_routing_rule():
    """The kernel takes CUDA tensors of one kernel type at a kernel head
    dim; everything else goes to the plain version (a CPU tensor
    always)."""
    meta = dict(device="meta")
    q = torch.empty(1, 2, 4, 64, **meta)
    k = torch.empty(1, 5, 64, **meta)
    assert not attention.takes_kernel(q, k, k)   # not on a card

    class Cuda:
        is_cuda = True

        def __init__(self, shape, dtype):
            self.shape, self.dtype = shape, dtype

    f32, bf16 = torch.float32, torch.bfloat16
    assert attention.takes_kernel(Cuda((1, 2, 4, 64), f32),
                                  Cuda((1, 5, 64), f32), Cuda((1, 5, 64), f32))
    assert attention.takes_kernel(Cuda((1, 2, 4, 8), bf16),
                                  Cuda((1, 5, 8), bf16), Cuda((1, 5, 8), bf16))
    for d in (48, 128, 4):
        assert not attention.takes_kernel(Cuda((1, 2, 4, d), f32),
                                          Cuda((1, 5, d), f32),
                                          Cuda((1, 5, d), f32))
    assert not attention.takes_kernel(Cuda((1, 2, 4, 64), torch.float16),
                                      Cuda((1, 5, 64), torch.float16),
                                      Cuda((1, 5, 64), torch.float16))
    assert not attention.takes_kernel(Cuda((1, 2, 4, 64), f32),
                                      Cuda((1, 5, 64), bf16),
                                      Cuda((1, 5, 64), bf16))
