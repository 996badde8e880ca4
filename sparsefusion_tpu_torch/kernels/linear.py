"""Wrapper for the 3xTF32 GEMM kernel of the linears (K5,
``csrc/linear_gemm.cu``).

K5 replaces no TPU kernel (the JAX package leaves its linears to XLA): it
runs Zero-1-to-3's spatial-transformer linears without a gradient, y = x
W^T + b in f32, as one GEMM with the output features on ``wgmma``'s 64
rows and the tokens on its 8-64 columns, K split over the CTAs of a
thread-block cluster.  In each CTA a producer warp copies the weight tile
and the token tile by TMA, both as they lie in device memory, and three
producer warps split each token tile once into its two TF32 halves; two
consumer warpgroups issue three TF32 ``wgmma`` products a step (3xTF32),
taking the K blocks in turn or, at 128 features a tile, a 64-feature half
of each.  The clusters stay on the card and take the output tiles in
turn.  The plain version is ``torch.nn.functional.linear``.

:func:`plan` picks the tile's tokens and features, the number of K splits
and of clusters from (T, N, K) and how many clusters of each size the card
runs at once (``kernels/conv2d.py::card_clusters``: K4 and K5 both hold
one CTA an SM) by K4's rule, and K5 has K4's instances; the C entry runs
that plan or refuses it.  :func:`linear_gemm_cuda` checks its tensors,
allocates the output, launches on the current stream, counts its
launches in ``linear_gemm_cuda.launches`` and adds 1 to the open span's
counter ``k5_launches``.  :func:`linear` is what ``nn/zero123.py::Linear``
calls: the kernel where :func:`takes_kernel` holds, else the plain
version.  K5 has no backward: a call that needs a gradient takes the plain
version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from sparsefusion_tpu_torch.kernels import conv2d
from sparsefusion_tpu_torch.utils import spans

# the kernel's instances, K4's: tokens of a tile (wgmma's N), its output
# features (64: one consumer warpgroup's rows; 128 at 64 tokens: both's),
# the K block, the most splits (the portable cluster size)
TILE_TOKENS = conv2d.TILE_PIXELS
INSTANCES = conv2d.INSTANCES
K_BLOCK = conv2d.K_BLOCK
MAX_SPLITS = conv2d.MAX_SPLITS
# the fewest rows of x the kernel takes: wgmma's narrowest N
MIN_TOKENS = 8


@dataclasses.dataclass(frozen=True)
class LinearPlan:
    """How K5 runs one GEMM: the tokens and output features of a tile, the
    number of K splits (the CTAs of one cluster) and of clusters, all on
    the card at once, each taking the output tiles in turn."""
    tile_tokens: int
    tile_rows: int
    splits: int
    clusters: int

    @property
    def ctas(self) -> int:
        return self.splits * self.clusters


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tiles(t: int, n: int, tile_tokens: int, tile_rows: int) -> int:
    """The output tiles of a GEMM of T tokens and N output features."""
    return _cdiv(n, tile_rows) * _cdiv(t, tile_tokens)


def plan(t: int, n: int, k: int, clusters=conv2d.H100_CLUSTERS) -> LinearPlan:
    """The plan for a GEMM of T tokens, N output features and a K-long
    reduction, on a card that runs ``clusters[S - 1]`` clusters of S CTAs
    at once: K4's (``kernels/conv2d.py::plan``, the tokens in place of its
    pixels), with as many clusters as the card holds at once of that size,
    or as there are tiles."""
    p = conv2d.plan(t, n, k, clusters)
    rows = p.tile_channels
    return LinearPlan(p.tile_pixels, rows, p.splits, min(
        tiles(t, n, p.tile_pixels, rows), clusters[p.splits - 1]))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (TMA's), copied only
    where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def linear_gemm_cuda(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor = None,
                     run_plan: LinearPlan = None) -> torch.Tensor:
    """Kernel forward: x (..., K), weight (N, K), bias (N,) or None, all
    f32 on one card, K % 4 == 0 and at least :data:`MIN_TOKENS` rows of x
    -> (..., N) f32.  ``run_plan``: a plan to run in place of
    :func:`plan`'s."""
    from sparsefusion_tpu_torch.kernels._build import load_library

    tensors = (("x", x), ("weight", weight)) + (
        () if bias is None else (("bias", bias),))
    for name, t in tensors:
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"{name} must be an f32 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if t.device != x.device:
            raise ValueError("x, weight and bias must be on one device")
    if x.ndim < 1 or weight.ndim != 2 or weight.shape[1] != x.shape[-1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}: need (..., K) and (N, K)")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match "
                         f"{weight.shape[0]} output features")
    n, k = weight.shape
    t = math.prod(x.shape[:-1])
    if k % 4 != 0 or t < MIN_TOKENS or n < 1:
        raise ValueError(f"K5 takes K % 4 == 0 and at least {MIN_TOKENS} "
                         f"rows: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}")
    if max(t * k, n * k, t * n) >= 2 ** 31:
        raise ValueError("tensors must have fewer than 2^31 elements")
    x2 = _aligned(x.reshape(t, k))
    weight = _aligned(weight)
    bias = None if bias is None else bias.contiguous()
    p = run_plan or plan(t, n, k, conv2d.card_clusters(x.device.index))
    y = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32,
                    device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = load_library().sf_linear_gemm(
            ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(weight.data_ptr()),
            ctypes.c_void_p(0 if bias is None else bias.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), t, n, k, p.tile_tokens,
            p.tile_rows, p.splits, p.clusters, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"linear GEMM kernel launch failed: CUDA error "
                           f"{err} (plan {p})")
    linear_gemm_cuda.launches += 1
    spans.count("k5_launches", 1)
    return y


linear_gemm_cuda.launches = 0


def reset_launches() -> None:
    linear_gemm_cuda.launches = 0


def takes_kernel(x, weight, bias=None) -> bool:
    """The routing rule: f32 CUDA tensors, no gradient needed (grad mode
    off, or none of x, the weight and the bias requires one), K % 4 == 0
    (TMA's 16-byte rows) and at least :data:`MIN_TOKENS` rows of x."""
    no_grad = not torch.is_grad_enabled() or not any(
        t is not None and t.requires_grad for t in (x, weight, bias))
    return (x.is_cuda and x.dtype == weight.dtype == torch.float32
            and no_grad and x.shape[-1] % 4 == 0
            and math.prod(x.shape[:-1]) >= MIN_TOKENS)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor = None) -> torch.Tensor:
    """``F.linear``: the kernel where :func:`takes_kernel` holds, else the
    plain version."""
    if takes_kernel(x, weight, bias):
        return linear_gemm_cuda(x, weight, bias)
    return F.linear(x, weight, bias)
