"""Wrapper for the split-K convolution CUDA kernel (K4,
``csrc/conv2d_splitk.cu``).

K4 replaces no TPU kernel (the JAX package leaves its convolutions to
XLA): it runs the UNets' f32 convolutions without a gradient, above all
the PLMS sampler's batch-1 evaluations, as one implicit GEMM with the
output channels on ``wgmma``'s 64 rows and the output pixels (M =
B*Ho*Wo) on its 8-64 columns, K = C_in*kh*kw split over the CTAs of a
thread-block cluster, so that a convolution of 16 or 64 output pixels
still spreads its weights over the SMs.  In each CTA two producer
warpgroups stream the weight tiles by TMA and gather the input patch,
split once into its two TF32 halves; two consumer warpgroups issue three
TF32 ``wgmma`` products a step (3xTF32), taking the K blocks in turn or,
at 128 channels a tile, a 64-channel half of each.  Where the output has
64 pixels or fewer the weights' bytes bound it (on an H100 it reads them
at 42-54% of the memory rate), above that the products (54-63% of the
f32 rate, 22-26% of the 3xTF32 one, the gather that feeds them in the
way).  The plain version is ``ops/conv2d.py::conv2d_plain``.

:func:`plan` picks the output tile's pixels and channels and the number
of K splits from (M, N, K) and how many clusters of each size the card
runs at once (:func:`card_clusters`); the C entry runs that plan or
refuses it.  :func:`conv2d_splitk_cuda` checks its tensors, allocates the
output, launches on the current stream, counts its launches in
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

# the kernel's instances: output pixels of a tile (wgmma's N), its output
# channels (wgmma's M of one consumer warpgroup, or of both at 64 pixels),
# the K block, the most splits (the portable cluster size)
TILE_PIXELS = (8, 16, 32, 64)
TILE_CHANNELS = (64, 128)
# the compiled instances: (tile pixels, tile channels)
INSTANCES = tuple((bn, 64) for bn in TILE_PIXELS) + ((64, 128),)
K_BLOCK = 32
MAX_SPLITS = 8
# how many clusters of S CTAs (S = 1..8) an H100 runs at once: one CTA an
# SM (each holds 160-200 KB of shared memory), and clusters placed inside
# the card's GPCs (cudaOccupancyMaxActiveClusters, the same for every
# instance); a launch of more clusters takes a second wave
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)


@dataclasses.dataclass(frozen=True)
class SplitKPlan:
    """How K4 runs one convolution: the output pixels of a tile, the
    number of K splits (the CTAs of one cluster), the grid (splits,
    channel tiles, pixel tiles) and the output channels of a tile."""
    tile_pixels: int
    splits: int
    grid: tuple
    tile_channels: int = 64

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, n: int, k: int, clusters=H100_CLUSTERS) -> SplitKPlan:
    """The plan for a GEMM of M output pixels, N output channels and a
    K-long reduction, on a card that runs ``clusters[S - 1]`` clusters of
    S CTAs at once.  The tile's pixels: the least of :data:`TILE_PIXELS`
    that holds M (so no column of a small M is wasted), else 64.  Its
    channels: 128 where M > 64 and N > 64, so that the two consumer
    warpgroups share each gathered input tile (there the products, not the
    weights' bytes, bound the call, and the gather feeds them), else 64.
    The splits: the most (at most :data:`MAX_SPLITS` and at most K's
    blocks) whose clusters all run in one wave; 1 where the tiles alone
    fill the card."""
    bn = next((bn for bn in TILE_PIXELS if bn >= m), TILE_PIXELS[-1])
    rows = 128 if m > 64 and n > 64 else 64
    tiles_n, tiles_m = _cdiv(n, rows), _cdiv(m, bn)
    fits = [s for s in range(1, min(MAX_SPLITS, _cdiv(k, K_BLOCK)) + 1)
            if tiles_n * tiles_m <= clusters[s - 1]]
    splits = fits[-1] if fits else 1
    return SplitKPlan(bn, splits, (splits, tiles_n, tiles_m), rows)


def out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


@functools.lru_cache(maxsize=None)
def card_clusters(device_index: int) -> tuple:
    """How many clusters of S = 1..8 CTAs the card runs at once, as the
    CUDA runtime reports it for the kernel (:data:`H100_CLUSTERS` on an
    H100)."""
    from sparsefusion_tpu_torch.kernels._build import load_library

    lib = load_library()
    with torch.cuda.device(device_index):
        counts = tuple(lib.sf_conv2d_splitk_max_clusters(s)
                       for s in range(1, MAX_SPLITS + 1))
    if min(counts) < 1:
        raise RuntimeError(f"cluster occupancy query failed: {counts}")
    return counts


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_splitk_cuda(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor = None, stride=1, padding=0,
                       run_plan: SplitKPlan = None) -> torch.Tensor:
    """Kernel forward: x (B, C_in, H, W), weight (C_out, C_in, kh, kw),
    bias (C_out,) or None, all f32 on one card -> (B, C_out, Ho, Wo) f32.
    Zero padding, groups 1, dilation 1; x is made contiguous.
    ``run_plan``: a plan to run in place of :func:`plan`'s (its tile
    pixels, channels and splits; the grid follows from them)."""
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
    p = run_plan or plan(b * ho * wo, cout, k,
                         card_clusters(x.device.index))
    # TMA copies the weight tiles where its rows are 16-byte aligned
    tma_w = int(k % 4 == 0 and weight.data_ptr() % 16 == 0)
    out = torch.empty((b, cout, ho, wo), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = load_library().sf_conv2d_splitk(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(weight.data_ptr()),
            ctypes.c_void_p(0 if bias is None else bias.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), b, cin, h, w, cout, kh, kw,
            sh, sw, ph, pw, p.tile_pixels, p.tile_channels, p.splits, tma_w,
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
