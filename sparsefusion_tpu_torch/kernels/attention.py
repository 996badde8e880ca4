"""Wrapper for the imagen attention CUDA kernel (K2,
``csrc/imagen_attention.cu``).

Hopper form of ``sparsefusion_tpu/kernels/attention.py::imagen_attention``:
``softmax(q k^T) v`` with one key/value head shared by all query heads,
in f32 (3xTF32 products) or bf16 (bf16 products, f32 logits and softmax,
P rounded to bf16).  The plain version is
``ops/attention.py::imagen_attention_plain``.

:func:`imagen_attention_cuda` checks its tensors, allocates the output,
launches on the current stream and counts its launches in
``imagen_attention_cuda.launches`` (the bf16 instance's also in
``imagen_attention_cuda.launches_bf16``).  :func:`imagen_attention` is
what the UNet calls: it routes by shape and type, as the reference runs
any head dim and type.  A CUDA tensor whose head dim is in
:data:`HEAD_DIMS` and whose type is in :data:`KERNEL_DTYPES` goes to the
kernel (forward; the backward is plain math on the saved inputs), every
other tensor to the plain version.  Any error the kernel raises
propagates.
"""
from __future__ import annotations

import ctypes

import torch

from sparsefusion_tpu_torch.ops.attention import (
    imagen_attention_backward_plain,
    imagen_attention_plain,
)

HEAD_DIMS = (8, 16, 32, 64)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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
    fwd = lib.sf_imagen_attention_fwd_bf16 if bf16 \
        else lib.sf_imagen_attention_fwd
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fwd(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
                  ctypes.c_void_p(v.data_ptr()),
                  ctypes.c_void_p(out.data_ptr()), b, h * n, k.shape[1], d,
                  ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"imagen attention kernel launch failed: CUDA "
                           f"error {err}")
    imagen_attention_cuda.launches += 1
    imagen_attention_cuda.launches_bf16 += bf16
    return out


imagen_attention_cuda.launches = 0
imagen_attention_cuda.launches_bf16 = 0


def reset_launches() -> None:
    imagen_attention_cuda.launches = 0
    imagen_attention_cuda.launches_bf16 = 0


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
