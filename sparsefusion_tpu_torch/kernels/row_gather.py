"""Wrapper for the row-gather CUDA kernel (K3, ``csrc/row_gather.cu``).

Hopper form of ``benchmarks/pallas_gather_micro.py::make_vmem_gather``:
``out[i] = table[idx[i]]`` for the micro's (R, 128) tables, bf16 or
f32.  The plain version is
``ops/row_gather.py::row_gather_plain``.

:func:`row_gather_cuda` checks its tensors, allocates the output,
launches on the current stream and counts its launches in
``row_gather_cuda.launches``.  An index outside [0, R) gives a row of
zeros.
"""
from __future__ import annotations

import ctypes

import torch

DTYPES = (torch.bfloat16, torch.float32)
WIDTH = 128


def row_gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel gather: (R, 128) bf16 or f32 contiguous table, (N,) int32
    indices on the same card -> (N, 128) rows in the table's type."""
    from sparsefusion_tpu_torch.kernels._build import load_library

    if not table.is_cuda:
        raise ValueError("row_gather_cuda takes CUDA tensors")
    if table.dtype not in DTYPES or table.ndim != 2 \
            or table.shape[1] != WIDTH:
        raise ValueError(f"table must be (R, {WIDTH}) bf16 or f32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if table.shape[0] >= 2 ** 31:
        raise ValueError("table rows must fit int32")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("table must be contiguous and 16-byte aligned")
    if idx.dtype != torch.int32 or idx.ndim != 1 or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous (N,) int32 vector, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != table.device:
        raise ValueError("table and idx must be on one device")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if idx.shape[0] == 0:
        return out
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = load_library().sf_row_gather(
            ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), idx.shape[0], table.shape[0],
            WIDTH * table.element_size(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"row gather kernel launch failed: CUDA error "
                           f"{err}")
    row_gather_cuda.launches += 1
    return out


row_gather_cuda.launches = 0


def reset_launches() -> None:
    row_gather_cuda.launches = 0
