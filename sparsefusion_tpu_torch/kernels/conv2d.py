"""Wrapper for the split-K convolution CUDA kernel (K4,
``csrc/conv2d_splitk.cu``).

K4 replaces no TPU kernel (the JAX package leaves its convolutions to
XLA): it runs the UNet's f32 convolutions without a gradient, above all
the PLMS sampler's batch-1 evaluations, as one implicit GEMM (M = B*Ho*Wo
output pixels, N = C_out, K = C_in*kh*kw) whose K axis is split over the
CTAs of a thread-block cluster, so that a convolution of 16 or 64 output
pixels still spreads its weights over every SM.  The plain version is
``ops/conv2d.py::conv2d_plain``.

:func:`plan` picks the output tile's rows and the number of K splits from
(M, N, K) and the SM count; the C entry runs that plan or refuses it.
:func:`conv2d_splitk_cuda` checks its tensors, allocates the output,
launches on the current stream, counts its launches in
``conv2d_splitk_cuda.launches`` and adds 1 to the open span's counter
``k4_launches``.  :func:`conv2d` is what ``nn/layers.py::Conv2d`` calls:
the kernel where :func:`takes_kernel` holds, else the plain version.
K4 has no backward: a call that needs a gradient takes the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from sparsefusion_tpu_torch.ops.conv2d import conv2d_plain
from sparsefusion_tpu_torch.utils import spans

# the kernel's instances: rows of the output tile (BM), its columns (BN),
# the K block, the most splits (the portable cluster size)
TILE_ROWS = (16, 32, 64)
TILE_COLS = 64
K_BLOCK = 32
MAX_SPLITS = 8
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class SplitKPlan:
    """How K4 runs one convolution: the rows of an output tile (its
    columns are :data:`TILE_COLS`), the number of K splits (the CTAs of one
    cluster) and the grid (splits, column tiles, row tiles)."""
    tile_rows: int
    splits: int
    grid: tuple

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, n: int, k: int, sms: int = H100_SMS) -> SplitKPlan:
    """The plan for a GEMM of M output pixels, N output channels and a
    K-long reduction.  The tile rows: the least of :data:`TILE_ROWS` that
    holds M, else the largest (on an H100 64-row tiles ran every shape
    of the UNet above 32 pixels fastest, 128-row ones up to 1.7x slower).
    The splits: as many as fit the tiles into one wave of ``sms`` CTAs, at
    most :data:`MAX_SPLITS` and at most K's blocks; 1 where the tiles alone
    fill the card."""
    bm = next((r for r in TILE_ROWS if r >= m), TILE_ROWS[-1])
    tiles_n, tiles_m = _cdiv(n, TILE_COLS), _cdiv(m, bm)
    splits = max(1, min(MAX_SPLITS, sms // (tiles_m * tiles_n),
                        _cdiv(k, K_BLOCK)))
    return SplitKPlan(bm, splits, (splits, tiles_n, tiles_m))


def out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_splitk_cuda(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor = None, stride=1, padding=0,
                       run_plan: SplitKPlan = None) -> torch.Tensor:
    """Kernel forward: x (B, C_in, H, W), weight (C_out, C_in, kh, kw),
    bias (C_out,) or None, all f32 on one card -> (B, C_out, Ho, Wo) f32.
    Zero padding, groups 1, dilation 1; x is made contiguous.
    ``run_plan``: a plan to run in place of :func:`plan`'s (its tile rows
    and splits; the grid follows from them)."""
    from sparsefusion_tpu_torch.kernels._build import load_library

    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    tensors = (("x", x), ("weight", weight)) + (
        () if bias is None else (("bias", bias),))
    for name, t in tensors:
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"{name} must be an f32 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if t.device != x.device:
            raise ValueError("x, weight and bias must be on one device")
    if x.ndim != 4 or weight.ndim != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}: need (B, C, H, W) and "
                         "(C_out, C, kh, kw)")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match "
                         f"{weight.shape[0]} output channels")
    if min(sh, sw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"stride {stride}, padding {padding}")
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    ho, wo = out_size(h, kh, sh, ph), out_size(w, kw, sw, pw)
    if min(b, cin, cout, ho, wo) <= 0:
        raise ValueError(f"empty convolution: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}")
    if max(x.numel(), weight.numel(), b * cout * ho * wo) >= 2 ** 31:
        raise ValueError("tensors must have fewer than 2^31 elements")
    x = x.contiguous()
    weight = weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    k = cin * kh * kw
    p = run_plan or plan(b * ho * wo, cout, k, _sm_count(x.device.index))
    vec_w = int(k % 4 == 0 and weight.data_ptr() % 16 == 0)
    out = torch.empty((b, cout, ho, wo), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = load_library().sf_conv2d_splitk(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(weight.data_ptr()),
            ctypes.c_void_p(0 if bias is None else bias.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), b, cin, h, w, cout, kh, kw,
            sh, sw, ph, pw, p.tile_rows, p.splits, vec_w,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"split-K convolution kernel launch failed: CUDA "
                           f"error {err} (plan {p})")
    conv2d_splitk_cuda.launches += 1
    spans.count("k4_launches", 1)
    return out


conv2d_splitk_cuda.launches = 0


def reset_launches() -> None:
    conv2d_splitk_cuda.launches = 0


def takes_kernel(x, weight, bias=None, padding=0, dilation=1,
                 groups: int = 1) -> bool:
    """The routing rule: f32 CUDA tensors, no gradient needed (grad mode
    off, or none of x, the weight and the bias requires one), groups 1,
    dilation 1, and integer padding (not "same" or "valid")."""
    no_grad = not torch.is_grad_enabled() or not any(
        t is not None and t.requires_grad for t in (x, weight, bias))
    return (x.is_cuda and x.dtype == weight.dtype == torch.float32
            and no_grad and groups == 1 and _pair(dilation) == (1, 1)
            and not isinstance(padding, str))


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor = None,
           stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """A 2-D convolution with zero padding: the kernel where
    :func:`takes_kernel` holds, else the plain version."""
    if takes_kernel(x, weight, bias, padding, dilation, groups):
        return conv2d_splitk_cuda(x, weight, bias, stride, padding)
    return conv2d_plain(x, weight, bias, stride, padding, dilation, groups)
