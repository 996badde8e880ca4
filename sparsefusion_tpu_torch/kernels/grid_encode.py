"""Wrappers for the fused grid-encode CUDA kernel (``csrc/grid_encode.cu``).

Hopper form of ``sparsefusion_tpu/kernels/grid_gather.py::vmem_row_gather``
and its scatter-add adjoint: one kernel computes the whole encoding of
``ops/grid_encode.py`` from the master table, one computes the table
gradient with f32 atomics.  The plain version of both is
``ops/grid_encode.py::grid_encode_plain`` (autograd gives its gradient).

Both take a leading scene axis: points (S, N, 3) with S tables (S, T, C)
of one encoding, every scene's encodings (S, N, L*C) or table gradient
(S, T, C) in one launch (the port of ``jax.vmap`` over the encode).
Each wrapper checks its tensors, allocates its output, launches on the
current stream and counts its launches in ``<wrapper>.launches`` (a
scene-batched launch once) and the scenes they encoded in
``<wrapper>.scenes`` (S a launch); the forward's points (S x N a
launch) go to the span recorder's innermost open span as
``k1_points``, and its launches on a bf16 table to
``grid_encode_cuda.launches_bf16``.
:func:`level_plan` mirrors, in Python, how the kernels reduce each
level's index to the level's size.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from sparsefusion_tpu_torch.ops.grid_encode import GridEncoding
from sparsefusion_tpu_torch.utils import spans

MAX_LEVELS = 32
_LEVEL_DIMS = (1, 2, 4, 8)


def _level_args(enc: GridEncoding):
    """Host arrays the C entry points read: kept alive by the caller for
    the duration of the call."""
    if enc.input_dim != 3:
        raise ValueError(f"the CUDA grid encode is 3-D; got input_dim="
                         f"{enc.input_dim}")
    if not 1 <= enc.num_levels <= MAX_LEVELS:
        raise ValueError(f"num_levels={enc.num_levels} outside "
                         f"[1, {MAX_LEVELS}]")
    if enc.level_dim not in _LEVEL_DIMS:
        raise ValueError(f"level_dim={enc.level_dim} not in {_LEVEL_DIMS}")
    if enc.total_params >= 2 ** 32:
        raise ValueError("table rows must fit uint32")
    return (np.ascontiguousarray(enc.offsets, np.int64),
            np.ascontiguousarray(enc.scales, np.float32),
            np.ascontiguousarray(enc.strides, np.uint32),
            np.ascontiguousarray(enc.use_hash, np.int32))


IDENTITY, MASK, MODULO = "identity", "mask", "modulo"
_REDUCTIONS = (IDENTITY, MASK, MODULO)    # the C enum's order


def level_plan(enc: GridEncoding) -> list:
    """Per level, how the kernels reduce a corner's uint32 index to the
    level's size: the mirror of ``make_levels`` in ``csrc/grid_encode.cu``.

    ``"identity"`` where no corner of a point in the unit box can reach
    the size (a tiled level's index peaks at the far corner of the cell
    of x = 1 on every axis, floor(f32(scale + 0.5)) + 1 times the sum of
    its strides); ``"mask"`` (index & (size - 1)) where the size is a
    power of two; ``"modulo"`` otherwise.  Each equals index % size on
    every index the level can produce.
    """
    sizes = np.diff(enc.offsets)
    plan = []
    for lvl in range(enc.num_levels):
        size = int(sizes[lvl])
        max_index = 2 ** 32 - 1
        if not enc.use_hash[lvl]:
            pos = np.float32(enc.scales[lvl]) + np.float32(0.5)
            max_index = (int(np.floor(pos)) + 1) * int(
                enc.strides[lvl].astype(np.int64).sum())
        if max_index < size:
            plan.append(IDENTITY)
        elif size & (size - 1) == 0:
            plan.append(MASK)
        else:
            plan.append(MODULO)
    return plan


def level_plan_cuda(enc: GridEncoding) -> list:
    """The plan ``make_levels`` itself chooses, through the built library
    (host code only; launches nothing)."""
    from sparsefusion_tpu_torch.kernels._build import load_library

    offsets, scales, strides, use_hash = _level_args(enc)
    out = np.zeros(enc.num_levels, np.int32)
    fn = load_library().sf_grid_encode_plan
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    err = fn(enc.num_levels, _ptr(offsets), _ptr(scales), _ptr(strides),
             _ptr(use_hash), _ptr(out))
    if err != 0:
        raise RuntimeError(f"sf_grid_encode_plan failed: CUDA error {err}")
    return [_REDUCTIONS[r] for r in out]


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


# the kernels' grid.y: one row of blocks per scene
MAX_SCENES = 65535


def _scenes(x01: torch.Tensor) -> int:
    """S of (S, N, 3) points, 1 of (N, 3) ones."""
    return x01.shape[0] if x01.ndim == 3 else 1


def _check_points(x01: torch.Tensor) -> None:
    if not x01.is_cuda:
        raise ValueError("grid_encode_cuda takes CUDA tensors")
    if x01.dtype != torch.float32 or x01.ndim not in (2, 3) \
            or x01.shape[-1] != 3:
        raise ValueError(f"x01 must be (N, 3) or (S, N, 3) float32, got "
                         f"{tuple(x01.shape)} {x01.dtype}")
    if not 1 <= _scenes(x01) <= MAX_SCENES:
        raise ValueError(f"{_scenes(x01)} scenes outside [1, {MAX_SCENES}]")
    if not x01.is_contiguous():
        raise ValueError("x01 must be contiguous")


def _table_shape(x01: torch.Tensor, enc: GridEncoding) -> tuple:
    """(T, C) for (N, 3) points, (S, T, C) for (S, N, 3) ones."""
    return tuple(x01.shape[:-2]) + (enc.total_params, enc.level_dim)


def _check_table(table: torch.Tensor, enc: GridEncoding,
                 shape: Optional[tuple] = None) -> None:
    """A contiguous f32 or bf16 table of ``shape`` ((T, C) by default;
    (S, T, C) for S scenes' points) whose data is aligned to the kernel's
    vector row loads: min(C * element size, 16) bytes."""
    shape = shape or (enc.total_params, enc.level_dim)
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table dtype {table.dtype} not f32/bf16")
    if tuple(table.shape) != shape:
        raise ValueError(f"table shape {tuple(table.shape)} != {shape}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    align = min(enc.level_dim * table.element_size(), 16)
    if table.data_ptr() % align:
        raise ValueError(f"table data must be aligned to {align} bytes for "
                         f"the kernel's row loads; got address "
                         f"{table.data_ptr():#x}")


def _call(fn, x01, src, bf16, dst, enc):
    offsets, scales, strides, use_hash = _level_args(enc)
    stream = torch.cuda.current_stream(x01.device).cuda_stream
    with torch.cuda.device(x01.device):
        err = fn(ctypes.c_void_p(x01.data_ptr()),
                 ctypes.c_void_p(src.data_ptr()), int(bf16),
                 ctypes.c_void_p(dst.data_ptr()), x01.shape[-2],
                 _scenes(x01), enc.num_levels, enc.level_dim, _ptr(offsets),
                 _ptr(scales), _ptr(strides), _ptr(use_hash),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"grid encode kernel launch failed: CUDA error "
                           f"{err}")


def grid_encode_cuda(x01: torch.Tensor, table: torch.Tensor,
                     enc: GridEncoding) -> torch.Tensor:
    """Forward kernel: (N, 3) f32 points in [0, 1], (T, C) f32 or bf16
    table -> (N, L*C) f32 encodings (zero outside the unit box); or
    (S, N, 3) points and (S, T, C) tables -> (S, N, L*C), one launch."""
    from sparsefusion_tpu_torch.kernels._build import load_library

    _check_points(x01)
    if table.device != x01.device:
        raise ValueError("table and points must be on one device")
    _check_table(table, enc, _table_shape(x01, enc))
    out = torch.empty(x01.shape[:-1] + (enc.output_dim,),
                      dtype=torch.float32, device=x01.device)
    _call(load_library().sf_grid_encode_fwd, x01, table,
          table.dtype == torch.bfloat16, out, enc)
    grid_encode_cuda.launches += 1
    grid_encode_cuda.scenes += _scenes(x01)
    grid_encode_cuda.launches_bf16 += table.dtype == torch.bfloat16
    spans.count("k1_points", _scenes(x01) * x01.shape[-2])
    return out


grid_encode_cuda.launches = 0
grid_encode_cuda.scenes = 0
grid_encode_cuda.launches_bf16 = 0


def grid_encode_cuda_backward(x01: torch.Tensor, grad_out: torch.Tensor,
                              enc: GridEncoding,
                              table_bf16: bool = False) -> torch.Tensor:
    """Backward kernel: the (T, C) f32 table gradient of
    :func:`grid_encode_cuda` for output gradient ``grad_out`` (N, L*C);
    with a scene axis, (S, T, C) for (S, N, L*C), one launch.
    ``table_bf16`` rounds the weights as the bf16 forward did."""
    from sparsefusion_tpu_torch.kernels._build import load_library

    _check_points(x01)
    if grad_out.shape != x01.shape[:-1] + (enc.output_dim,) \
            or grad_out.dtype != torch.float32 \
            or grad_out.device != x01.device:
        raise ValueError(f"grad_out must be {x01.shape[:-1]} x "
                         f"{enc.output_dim} float32 on the points' device")
    grad_out = grad_out.contiguous()
    grad_table = torch.zeros(_table_shape(x01, enc), dtype=torch.float32,
                             device=x01.device)
    _call(load_library().sf_grid_encode_bwd, x01, grad_out, table_bf16,
          grad_table, enc)
    grid_encode_cuda_backward.launches += 1
    grid_encode_cuda_backward.scenes += _scenes(x01)
    return grad_table


grid_encode_cuda_backward.launches = 0
grid_encode_cuda_backward.scenes = 0


def reset_launches() -> None:
    grid_encode_cuda.launches = 0
    grid_encode_cuda.scenes = 0
    grid_encode_cuda.launches_bf16 = 0
    grid_encode_cuda_backward.launches = 0
    grid_encode_cuda_backward.scenes = 0


class GridEncodeFunction(torch.autograd.Function):
    """Kernel forward and kernel table-gradient backward.

    Takes the f32 master table (S masters (S, T, C) for (S, N, 3)
    points); with ``table_dtype="bfloat16"`` it reads
    a bf16 copy it makes itself, so the gradient it returns stays f32.
    """

    @staticmethod
    def forward(ctx, x01, master, enc, table_dtype):
        table = master if table_dtype is None else \
            master.to(getattr(torch, table_dtype)).contiguous()
        ctx.save_for_backward(x01)
        ctx.enc = enc
        ctx.bf16 = table.dtype == torch.bfloat16
        return grid_encode_cuda(x01, table, enc)

    @staticmethod
    def backward(ctx, grad_out):
        (x01,) = ctx.saved_tensors
        grad_table = None
        if ctx.needs_input_grad[1]:
            grad_table = grid_encode_cuda_backward(x01, grad_out, ctx.enc,
                                                   ctx.bf16)
        return None, grad_table, None, None


def grid_encode_fn(x01: torch.Tensor, master: torch.Tensor,
                   enc: GridEncoding,
                   table_dtype: Optional[str] = None) -> torch.Tensor:
    """Differentiable (in the table) kernel grid encode of (N, 3) points
    with a (T, C) master, or of (S, N, 3) points with (S, T, C) masters.
    Positions take no gradient: passing points that require one raises."""
    if x01.requires_grad:
        raise ValueError("the CUDA grid encode gives no gradient to the "
                         "positions; detach them (the renderer does)")
    if master.dtype != torch.float32:
        raise ValueError("the master table must be float32")
    if table_dtype not in (None, "bfloat16"):
        raise ValueError(f"table_dtype {table_dtype!r} not None/bfloat16")
    return GridEncodeFunction.apply(x01.to(torch.float32).contiguous(),
                                    master.contiguous(), enc, table_dtype)
