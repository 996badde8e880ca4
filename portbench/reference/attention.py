"""Attention with one key/value head shared by all query heads, in plain
PyTorch.

The plain version of the hand-written kernel K2
(``kernels/attention.py`` + ``csrc/imagen_attention.cu``), which the
view-conditioned UNet's ``nn/layers.py::Attention`` calls.  It is
``sparsefusion_tpu/kernels/attention.py::_attn_kernel`` (in f32 also its
``reference_attention``): the CPU path, the path for head dims the kernel
has no instance for, and the reference the kernel is held against.
"""
from __future__ import annotations

import torch


def imagen_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v in the TPU kernel's arithmetic (``_attn_kernel``):
    logits from q and k upcast to f32, the softmax in f32, P rounded to
    v's type, P v summed in f32, the output in q's type.  In f32 every
    cast is a no-op.

    Args:
        q: (B, H, N, D) pre-scaled queries.
        k, v: (B, J, D), shared by every head (null and context tokens
            already prepended).

    Returns:
        (B, H, N, D).
    """
    sim = torch.einsum("bhnd,bjd->bhnj", q.float(), k.float())
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum("bhnj,bjd->bhnd", attn.float(), v.float())
    return out.to(q.dtype)


def imagen_attention_backward_plain(q, k, v, grad_out):
    """Gradients (dq, dk, dv) of :func:`imagen_attention_plain`, from the
    saved inputs (the kernel has no backward of its own)."""
    qf, kf, vf, g = q.float(), k.float(), v.float(), grad_out.float()
    p = torch.softmax(torch.einsum("bhnd,bjd->bhnj", qf, kf), dim=-1)
    dv = torch.einsum("bhnj,bhnd->bjd", p, g)
    dp = torch.einsum("bhnd,bjd->bhnj", g, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhnj,bjd->bhnd", ds, kf)
    dk = torch.einsum("bhnj,bhnd->bjd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
