"""Wrapper for the imagen attention CUDA kernel (K2,
``csrc/imagen_attention.cu``).

Hopper form of ``sparsefusion_tpu/kernels/attention.py::imagen_attention``:
``softmax(q k^T) v`` with one key/value head shared by all query heads,
in f32 (3xTF32 products) or bf16 (bf16 products, f32 logits and softmax,
P rounded to bf16).  The plain version is
``ops/attention.py::imagen_attention_plain``.

The bf16 instance has two bodies, and :func:`bf16_plan` picks one per
call: the ``wgmma`` body (warpgroup products fed by TMA, 128 rows a CTA,
128-key tiles) for head dims 16, 32 and 64 over more keys than one of its
tiles; the ``mma_sync`` body (one warp a 16-row tile) for the rest,
among them the UNet's 17-19 keys, which then encode no tensor maps.  The
plan (body, rows per CTA, key tile, stages, shared bytes, grid) goes to
the C entry, which runs exactly that body or refuses the plan.

:func:`imagen_attention_cuda` checks its tensors, allocates the output,
launches on the current stream and counts its launches in
``imagen_attention_cuda.launches`` (the bf16 instance's also in
``imagen_attention_cuda.launches_bf16``, those of its wgmma body also in
``imagen_attention_cuda.launches_bf16_wgmma``).  :func:`imagen_attention` is
what the UNet calls: it routes by shape and type, as the reference runs
any head dim and type.  A CUDA tensor whose head dim is in
:data:`HEAD_DIMS` and whose type is in :data:`KERNEL_DTYPES` goes to the
kernel (forward; the backward is plain math on the saved inputs), every
other tensor to the plain version.  Any error the kernel raises
propagates.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from sparsefusion_tpu_torch.ops.attention import (
    imagen_attention_backward_plain,
    imagen_attention_plain,
)

HEAD_DIMS = (8, 16, 32, 64)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the bf16 instance's bodies, by the C entry's body id
BODIES = ("mma_sync", "wgmma")
WGMMA_HEAD_DIMS = (16, 32, 64)
WGMMA_ROWS, WGMMA_KEYS, WGMMA_STAGES = 128, 128, 4
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How the bf16 instance runs one call: which body, the rows of H*N a
    CTA takes, keys per K/V tile, the ring's stages, the shared memory a
    CTA uses, and the grid (row blocks, batch)."""
    body: str
    rows_per_cta: int
    key_tile: int
    stages: int
    smem_bytes: int
    grid: tuple


def bf16_plan(batch: int, rows: int, n_keys: int, head_dim: int,
              sms: int = H100_SMS) -> AttentionPlan:
    """The plan for q (batch, rows = H*N, D) against (batch, n_keys, D).

    wgmma body at D in :data:`WGMMA_HEAD_DIMS` over more than one tile of
    keys: 128 rows a CTA (two consumer warpgroups), Q's tile, and a ring
    of 4 stages of K and V tiles, plus 9 mbarriers and 1024 bytes to align
    the block to the swizzle's period.  Otherwise the mma_sync body: 1, 2
    or 4 warps of 16 rows a CTA, halved while the grid would leave SMs
    idle, keys per tile 4096 / D capped at 128, two buffers of K and V at a
    padded pitch (D + 8, 24 at D = 8)."""
    d = head_dim
    if d in WGMMA_HEAD_DIMS and n_keys > WGMMA_KEYS:
        body, rows_per_cta = "wgmma", WGMMA_ROWS
        key_tile, stages = WGMMA_KEYS, WGMMA_STAGES
        smem = (rows_per_cta * d * 2 + 2 * stages * key_tile * d * 2
                + 8 * (2 * stages + 1) + 1024)
    else:
        body, key_tile, stages = "mma_sync", min(4096 // d, 128), 2
        smem = 2 * 2 * key_tile * (24 if d == 8 else d + 8) * 2
        warps = 4
        while warps > 1 and batch * -(-rows // (16 * warps)) < sms:
            warps //= 2
        rows_per_cta = 16 * warps
    return AttentionPlan(body, rows_per_cta, key_tile, stages, smem,
                         (-(-rows // rows_per_cta), batch))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.dtype != dtype:
        raise ValueError(f"q, k and v must have one dtype, got {name} "
                         f"{t.dtype} beside q {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def imagen_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Kernel forward: q (B, H, N, D), k/v (B, J, D), all f32 or all bf16,
    contiguous on one card, D in :data:`HEAD_DIMS` -> (B, H, N, D) in
    their type."""
    from sparsefusion_tpu_torch.kernels._build import load_library

    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype)
    if q.ndim != 4 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, H, N, D) and "
                         "(B, J, D) twice")
    b, h, n, d = q.shape
    if k.shape[0] != b or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if min(b, h * n, k.shape[1]) == 0:
        raise ValueError("empty attention")
    bf16 = q.dtype == torch.bfloat16
    lib = load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)]
    plan = None
    with torch.cuda.device(q.device):
        if bf16:
            plan = bf16_plan(b, h * n, k.shape[1], d,
                             _sm_count(q.device.index))
            err = lib.sf_imagen_attention_fwd_bf16(
                *ptrs, b, h * n, k.shape[1], d, BODIES.index(plan.body),
                plan.rows_per_cta, plan.key_tile, plan.stages,
                plan.smem_bytes, ctypes.c_void_p(stream))
        else:
            err = lib.sf_imagen_attention_fwd(
                *ptrs, b, h * n, k.shape[1], d, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"imagen attention kernel launch failed: CUDA error {err}"
            + (f" (plan {plan}; >= 10000: the tensor maps could not be "
               "made, CUresult + 10000)" if plan else ""))
    imagen_attention_cuda.launches += 1
    imagen_attention_cuda.launches_bf16 += bf16
    imagen_attention_cuda.launches_bf16_wgmma += bool(
        plan and plan.body == "wgmma")
    return out


imagen_attention_cuda.launches = 0
imagen_attention_cuda.launches_bf16 = 0
imagen_attention_cuda.launches_bf16_wgmma = 0


def reset_launches() -> None:
    imagen_attention_cuda.launches = 0
    imagen_attention_cuda.launches_bf16 = 0
    imagen_attention_cuda.launches_bf16_wgmma = 0


class ImagenAttentionFunction(torch.autograd.Function):
    """Kernel forward; plain backward on the saved q, k, v (the TPU
    kernel has no backward kernel either)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return imagen_attention_cuda(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        return imagen_attention_backward_plain(*ctx.saved_tensors, grad_out)


def takes_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The routing rule: CUDA tensors of one type the kernel has an
    instance for, at a head dim it has an instance for."""
    return (q.is_cuda and q.shape[-1] in HEAD_DIMS
            and q.dtype in KERNEL_DTYPES and k.dtype == v.dtype == q.dtype)


def imagen_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v with one shared kv head: the kernel where
    :func:`takes_kernel` holds, else the plain version."""
    if takes_kernel(q, k, v):
        return ImagenAttentionFunction.apply(q, k, v)
    return imagen_attention_plain(q, k, v)
