"""Wrapper for the imagen attention CUDA kernel (K2,
``csrc/imagen_attention.cu``).

Hopper form of ``sparsefusion_tpu/kernels/attention.py::imagen_attention``:
``softmax(q k^T) v`` with one key/value head shared by all query heads.
The plain version is ``ops/attention.py::imagen_attention_plain``.

:func:`imagen_attention_cuda` checks its tensors, allocates the output,
launches on the current stream and counts its launches in
``imagen_attention_cuda.launches``.  :func:`imagen_attention` is what the
UNet calls: the kernel for a CUDA tensor (forward; the backward is plain
math on the saved inputs), the plain version for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from sparsefusion_tpu_torch.ops.attention import (
    imagen_attention_backward_plain,
    imagen_attention_plain,
)

HEAD_DIMS = (8, 16, 32, 64)


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def imagen_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Kernel forward: q (B, H, N, D), k/v (B, J, D), all f32 contiguous on
    one card, D in :data:`HEAD_DIMS` -> (B, H, N, D)."""
    from sparsefusion_tpu_torch.kernels._build import load_library

    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t)
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
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = load_library().sf_imagen_attention_fwd(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, h * n, k.shape[1], d, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"imagen attention kernel launch failed: CUDA "
                           f"error {err}")
    imagen_attention_cuda.launches += 1
    return out


imagen_attention_cuda.launches = 0


def reset_launches() -> None:
    imagen_attention_cuda.launches = 0


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


def imagen_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v with one shared kv head: the kernel on a CUDA
    tensor (which raises on what it does not take), the plain version on
    a CPU tensor."""
    if q.is_cuda:
        return ImagenAttentionFunction.apply(q, k, v)
    return imagen_attention_plain(q, k, v)
