"""The numerics of K2's tensor-core design (``csrc/imagen_attention.cu``),
emulated on the CPU.

The kernel runs both products of attention, S = Q K^T and O += P V, as
TF32 ``mma.sync.m16n8k8`` steps with f32 accumulation, each operand split
as x = big + small (big = tf32(x), small = tf32(x - big), rounded as
``cvt.rna.tf32.f32``: nearest, ties away from zero, low 13 mantissa bits
cleared) and each product taken as a_small b_big + a_big b_small + a_big
b_big.  This file repeats that arithmetic in PyTorch in the kernel's
order: k/v tiles of 2048 / D keys, an online softmax over the tiles,
8-wide steps over the contracted axis.  It shows that the split keeps the
kernel within the 1e-5 tolerance it is held to on the card, against a
float64 reference and against the plain version, and that one TF32 pass
(big b_big only) does not.
"""
import numpy as np
import pytest
import torch

from sparsefusion_tpu_torch.ops.attention import imagen_attention_plain

torch.set_num_threads(2)
TOL = 1e-5
# the UNet's down_3/up_0 shape, its 17-key shape at D = 32, and the long
# shape the TPU kernel was written for with N cut from 1024 to 64
SHAPES = [(1, 8, 16, 64, 19), (1, 8, 16, 32, 17), (2, 8, 64, 64, 1027)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mma(acc, a, b, passes):
    """acc += a @ b over one 8-wide step, in ``passes`` TF32 products."""
    a_big, b_big = tf32(a), tf32(b)
    if passes == 3:
        acc = acc + tf32(a - a_big) @ b_big
        acc = acc + a_big @ tf32(b - b_big)
    return acc + a_big @ b_big


def emulated_attention(q, k, v, passes=3):
    """K2's arithmetic on f32 CPU tensors: q (B, H, N, D), k/v (B, J, D)."""
    b, h, n, d = q.shape
    tile = 2048 // d
    out = []
    for bi in range(b):
        qr = q[bi].reshape(h * n, d)
        m = torch.full((h * n, 1), -torch.inf)
        l = torch.zeros(h * n, 1)
        o = torch.zeros(h * n, d)
        for j0 in range(0, k.shape[1], tile):
            kt, vt = k[bi, j0:j0 + tile], v[bi, j0:j0 + tile]
            s = torch.zeros(h * n, kt.shape[0])
            for d0 in range(0, d, 8):
                s = _mma(s, qr[:, d0:d0 + 8], kt[:, d0:d0 + 8].T, passes)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            o = o * corr
            for j in range(0, kt.shape[0], 8):
                o = _mma(o, p[:, j:j + 8], vt[j:j + 8], passes)
            m = m_new
        out.append((o / l).reshape(h, n, d))
    return torch.stack(out)


def _qkv(b, h, n, d, j, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, n, d) * d ** -0.5).astype(np.float32)
    k = rng.randn(b, j, d).astype(np.float32)
    v = rng.randn(b, j, d).astype(np.float32)
    return map(torch.tensor, (q, k, v))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0, 1e-30], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), 3.0,
                         float(tf32(torch.tensor([1e-30]))[0])])
    got = tf32(x)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    # the split is exact to the bits small drops: |x - big - small| is
    # below 2^-22 of |x|
    y = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    big = tf32(y)
    small = tf32(y - big)
    assert ((y - big - small).abs() <= y.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_split_meets_f32_tolerance(shape):
    q, k, v = _qkv(*shape)
    got = emulated_attention(q, k, v, passes=3)
    want64 = imagen_attention_plain(q.double(), k.double(), v.double())
    err64 = (got.double() - want64).abs().max().item()
    err_plain = (got - imagen_attention_plain(q, k, v)).abs().max().item()
    assert err64 <= TOL / 4, err64
    assert err_plain <= TOL, err_plain


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_single_pass_tf32_misses_f32_tolerance(shape):
    q, k, v = _qkv(*shape)
    got = emulated_attention(q, k, v, passes=1)
    want64 = imagen_attention_plain(q.double(), k.double(), v.double())
    assert (got.double() - want64).abs().max().item() > 10 * TOL
