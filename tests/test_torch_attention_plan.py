"""K2's bf16 plan (``kernels/attention.py::bf16_plan``) and the tile order
of its wgmma body, on the CPU.

The plan picks the body and its launch shape; the C entry refuses any
plan that is not its own, so the numbers here are the kernel's.  The
wgmma body streams keys in 128-key tiles with an online softmax: per tile
the logits in f32, the running max, P = exp(s - running max) by exp2 of
s log2(e) - m log2(e), P rounded to bf16 before P V (f32 sums), the
accumulator and the f32 row sum rescaled once per tile, the division at
the end.  :func:`wgmma_body_emulation` repeats that arithmetic in torch,
and is held against the JAX reference (``reference_attention``), the
Pallas kernel in interpret mode and the port's plain version, on bf16
inputs, under the tolerance the card holds the kernel to
(``chip_smoke.py::ATTN_TOL[torch.bfloat16]``: 1e-2 + 2^-7 |want|).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.kernels.attention import (
    imagen_attention as jax_imagen_attention,
)
from sparsefusion_tpu.kernels.attention import reference_attention
from sparsefusion_tpu_torch.kernels import attention
from sparsefusion_tpu_torch.ops.attention import imagen_attention_plain

torch.set_num_threads(2)
BF16_ATOL, BF16_RTOL = 1e-2, 2 ** -7
LOG2E = 1.4426950408889634
SMEM_LIMIT = 232448   # shared bytes one block may use on Hopper (227 KB)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_wgmma_plan_fits_shared_memory(d):
    plan = attention.bf16_plan(2, 8192, 1027, d)
    assert plan.body == "wgmma"
    assert (plan.rows_per_cta, plan.key_tile) == (128, 128)
    # Q's tile, the K and V rings, 9 mbarriers, 1024 bytes of alignment
    assert plan.smem_bytes == (128 * d * 2 + 2 * plan.stages * 128 * d * 2
                               + 8 * (2 * plan.stages + 1) + 1024)
    assert 2 <= plan.stages <= 4
    assert plan.smem_bytes <= SMEM_LIMIT == 227 * 1024


def test_long_shape_is_one_wave_of_the_wgmma_body():
    """(2, 8, 1024, 64) over 1027 keys: 8192 rows a batch in CTAs of 128,
    64 x 2 = 128 CTAs, one wave on the H100's 132 SMs."""
    plan = attention.bf16_plan(2, 8 * 1024, 1027, 64)
    assert plan.body == "wgmma"
    assert plan.grid == (64, 2)
    assert math.prod(plan.grid) == 128 <= attention.H100_SMS


@pytest.mark.parametrize("batch", [1, 12])
@pytest.mark.parametrize("n_keys", [17, 19])
def test_unet_shapes_keep_the_mma_sync_body(batch, n_keys):
    """The UNet's 8 x 16 rows over 17-19 keys fit one tile: the mma_sync body,
    one 16-row warp a CTA (the grid would not cover the SMs with more),
    64-key tiles, no tensor maps to encode."""
    plan = attention.bf16_plan(batch, 8 * 16, n_keys, 64)
    assert plan == attention.AttentionPlan("mma_sync", 16, 64, 2,
                                           2 * 2 * 64 * 72 * 2, (8, batch))


@pytest.mark.parametrize("n_keys", [1, 128, 129, 1027, 4099])
def test_head_dim_8_keeps_the_mma_sync_body(n_keys):
    """D = 8 (the tiny UNet) stays on the mma_sync body at any key count:
    wgmma's k16 depth would need padding."""
    plan = attention.bf16_plan(2, 4096, n_keys, 8)
    assert plan.body == "mma_sync"
    assert (plan.key_tile, plan.smem_bytes) == (128, 2 * 2 * 128 * 24 * 2)


def test_mma_sync_grid_keeps_its_rule():
    """Four warps a CTA, halved while the grid would leave SMs idle."""
    assert attention.bf16_plan(2, 8192, 19, 64).rows_per_cta == 64
    assert attention.bf16_plan(2, 4096, 19, 64).rows_per_cta == 32
    assert attention.bf16_plan(1, 5, 1, 64).rows_per_cta == 16
    assert attention.bf16_plan(2, 8192, 128, 64).body == "mma_sync"
    assert attention.bf16_plan(2, 8192, 129, 64).body == "wgmma"


def wgmma_body_emulation(q, k, v, key_tile=128):
    """The wgmma body's arithmetic on (B, H, N, D) and (B, J, D) bf16
    tensors, in f32 torch: 128-key tiles, online softmax with exp2, P in
    bf16, rescaled once per tile; bf16 out."""
    qf = q.float()
    m = torch.full(q.shape[:3], -math.inf)
    row_sum = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for j0 in range(0, k.shape[1], key_tile):
        s = torch.einsum("bhnd,bjd->bhnj", qf,
                         k[:, j0:j0 + key_tile].float())
        mn = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - mn) * LOG2E)
        p = torch.exp2(s * LOG2E - (mn * LOG2E)[..., None])
        row_sum = row_sum * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bhnj,bjd->bhnd", p.bfloat16().float(),
            v[:, j0:j0 + key_tile].float())
        m = mn
    return (o / row_sum[..., None]).bfloat16()


def _qkv(b, h, n, d, j, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, n, d) * d ** -0.5).astype(np.float32)
    k = rng.randn(b, j, d).astype(np.float32)
    v = rng.randn(b, j, d).astype(np.float32)
    return [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]


def _torch(a):
    return torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n_keys", [129, 257, 1027])
def test_wgmma_tile_order_within_the_card_tolerance(n_keys, d):
    """The emulation against the JAX reference, the Pallas kernel in
    interpret mode and the port's plain version, each under
    1e-2 + 2^-7 |want|; keys past the last full tile (129, 257, 1027)
    leave a ragged last tile."""
    b, h, n = 2, 2, 40
    q, k, v = _qkv(b, h, n, d, n_keys, seed=n_keys + d)
    tq, tk, tv = map(_torch, (q, k, v))
    got = wgmma_body_emulation(tq, tk, tv).float()
    wants = {
        "reference_attention": reference_attention(q, k, v),
        "pallas_interpret": jax_imagen_attention(q, k, v, block_q=40,
                                                 interpret=True),
    }
    wants = {name: _torch(w).float() for name, w in wants.items()}
    wants["plain"] = imagen_attention_plain(tq, tk, tv).float()
    for name, want in wants.items():
        err = (got - want).abs()
        assert bool((err <= BF16_ATOL + BF16_RTOL * want.abs()).all()), \
            (name, err.max().item())
