"""Multi-resolution tiled/hash grid encoding (instant-NGP).

Frozen copy of the port's ``ops/grid_encode.py`` (the JAX ``sparsefusion_tpu/ops/grid_encode.py``'s counterpart), same semantics:

* per level l: scale = 2^(l*S) * H - 1, resolution R = ceil(scale) + 1,
* pos = x * scale + 0.5 (align_corners=False), trilinear over 2^D corners,
* index: stride-based linear index over (R+1)^d, a dimension included
  only while its stride fits the level's table; 'hash' levels whose full
  grid exceeds the table xor the corner coords with the NGP primes,
* index = (index mod level_size) + level_offset into one flat [total, C]
  table; points outside the [0, 1] box encode to zeros,
* output layout [B, L*C], level-major per point.

:func:`grid_encode` dispatches on the device of its input: a CUDA tensor
goes to the hand-written kernel (``kernels/grid_encode.py``), a CPU
tensor to :func:`grid_encode_plain`, the plain PyTorch version below.
Both take a leading scene axis, the port of ``jax.vmap`` over the encode
in the JAX package's scene-batched loop (``distill/batched.py``): points
(S, B, D) and tables (S, T, C) of one ``GridEncoding``, every scene read
from its own table, in one call.

With ``table_dtype="bfloat16"`` the table is read in bf16 and, as in the
JAX blocked path (``ops/grid_encode_blocked.py:269``), the trilinear
weight is rounded to bf16 before an f32 product and f32 accumulation.
The master table stays f32 and so does its gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

# NGP hashing primes (prime[0]=1 keeps memory coherence for dim 0)
_PRIMES = (1, 2654435761, 805459861)
# torch has no general uint32 arithmetic: index math runs in int64 and is
# masked back to 32 bits, which keeps exactly the low bits uint32 wraps to
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GridEncoding:
    """Static per-level constants for a grid encoding (host-precomputed)."""

    input_dim: int
    num_levels: int
    level_dim: int
    base_resolution: int
    log2_hashmap_size: int
    gridtype: str  # 'hash' | 'tiled'
    per_level_scale: float
    offsets: np.ndarray          # (L+1,) int64 — table offsets per level
    scales: np.ndarray           # (L,) float32 — pos scale per level
    resolutions: np.ndarray      # (L,) int32
    strides: np.ndarray          # (L, D) uint32 — 0 where dim dropped
    use_hash: np.ndarray         # (L,) bool

    @property
    def total_params(self) -> int:
        return int(self.offsets[-1])

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


def make_grid_encoding(input_dim: int = 3, num_levels: int = 16,
                       level_dim: int = 2, base_resolution: int = 16,
                       log2_hashmap_size: int = 19,
                       desired_resolution: int | None = None,
                       per_level_scale: float = 2.0,
                       gridtype: str = "hash") -> GridEncoding:
    """Build the static encoding config."""
    if desired_resolution is not None:
        per_level_scale = float(np.exp2(
            np.log2(desired_resolution / base_resolution) / (num_levels - 1)))

    max_params = 2 ** log2_hashmap_size
    offsets = [0]
    scales, resolutions, strides, use_hash = [], [], [], []
    offset = 0
    for lvl in range(num_levels):
        scale = base_resolution * per_level_scale ** lvl - 1.0
        res = int(np.ceil(scale)) + 1
        params_in_level = min(max_params, (res + 1) ** input_dim)
        params_in_level = int(np.ceil(params_in_level / 8) * 8)
        st = []
        stride = 1
        for _ in range(input_dim):
            st.append(stride if stride <= params_in_level else 0)
            stride *= res + 1
        strides.append(st)
        use_hash.append(gridtype == "hash" and stride > params_in_level)
        scales.append(scale)
        resolutions.append(res)
        offset += params_in_level
        offsets.append(offset)

    return GridEncoding(
        input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
        base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
        gridtype=gridtype, per_level_scale=per_level_scale,
        offsets=np.asarray(offsets, np.int64),
        scales=np.asarray(scales, np.float32),
        resolutions=np.asarray(resolutions, np.int32),
        strides=np.asarray(strides, np.uint32),
        use_hash=np.asarray(use_hash, bool),
    )


def init_grid_params(generator: Optional[torch.Generator],
                     enc: GridEncoding, std: float = 1e-4,
                     device=None) -> torch.Tensor:
    """The table's init: uniform(-std, std), (total_params, level_dim)
    f32, drawn from ``generator`` on ``device``."""
    table = torch.empty((enc.total_params, enc.level_dim), device=device)
    return table.uniform_(-std, std, generator=generator)


def _round_table(table: torch.Tensor,
                 table_dtype: Optional[str]) -> torch.Tensor:
    """Table values as read in ``table_dtype``, in f32, with the identity
    as gradient: the master and its gradient stay f32."""
    if table_dtype is None:
        return table
    rounded = table.to(getattr(torch, table_dtype)).to(torch.float32)
    return table + (rounded - table).detach()


def _corners(x01: torch.Tensor, enc: GridEncoding):
    """The cell of every (point, level): the uint32 index of each of its
    2^D corners before the level's modulo, (B, L, 2^D) in int64 where a
    uint32 wrap can occur and int32 otherwise, corner k = sum_d bit_d 2^d;
    and the fractional position in the cell, (B, L, D) f32."""
    D = enc.input_dim
    dev = x01.device
    x01 = x01.to(torch.float32)

    def const(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    strides = enc.strides.astype(np.int64)                     # (L, D)
    # 64-bit index math only where a uint32 wrap can occur: hash levels,
    # or a tiled stride dot that can pass 2^31 (corner coords <= R)
    max_dot = int((enc.resolutions[:, None].astype(np.int64)
                   * strides).sum(-1).max()) + int(strides.sum(-1).max())
    wide = bool(enc.use_hash.any()) or max_dot >= 2 ** 31
    itype = torch.int64 if wide else torch.int32

    scales = const(enc.scales, torch.float32)                  # (L,)
    use_hash = const(enc.use_hash, torch.bool)
    bits = (np.arange(2 ** D)[:, None] >> np.arange(D)) & 1    # (K, D)

    pos = x01[:, None, :] * scales[None, :, None] + 0.5        # (B, L, D)
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    pos_grid = pos_grid.to(itype)
    if wide:
        pos_grid = pos_grid & _MASK32

    index = None
    if not enc.use_hash.all():
        # tiled: the stride dot of the base corner plus a constant
        # offset per corner
        base = (pos_grid * const(strides, itype)).sum(dim=-1, dtype=itype)
        index = base[..., None] + const(bits @ strides.T, itype).T
    if enc.use_hash.any():
        hashed = None
        for d in range(D):
            cd = pos_grid[..., d, None] + torch.arange(2, device=dev)
            hd = (cd * _PRIMES[d]) & _MASK32
            hashed = hd if hashed is None else (
                hd[..., :, None] ^ hashed[..., None, :]).flatten(-2)
        index = hashed if index is None else torch.where(
            use_hash[:, None], hashed, index)
    if wide:
        index = index & _MASK32
    return index, frac


def _rows(index: torch.Tensor, enc: GridEncoding) -> torch.Tensor:
    offsets = torch.as_tensor(enc.offsets, dtype=index.dtype,
                              device=index.device)
    sizes = (offsets[1:] - offsets[:-1])[:, None]
    return index % sizes + offsets[:-1, None]


def grid_corner_index(x01: torch.Tensor, enc: GridEncoding) -> torch.Tensor:
    """(B, L, 2^D) uint32 index of every corner of every (point, level)
    before it is reduced to the level's size (int64, or int32 where no
    wrap can occur); corner k = sum_d bit_d 2^d."""
    return _corners(x01, enc)[0]


def grid_corner_rows(x01: torch.Tensor, enc: GridEncoding) -> torch.Tensor:
    """(B, L, 2^D) table rows the encode reads: the corner index modulo
    the level's size, plus the level's offset.  Points outside the box
    get rows too; the encode zeroes them."""
    return _rows(grid_corner_index(x01, enc), enc)


def grid_encode_plain(x01: torch.Tensor, table: torch.Tensor,
                      enc: GridEncoding,
                      table_dtype: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch grid encode; autograd gives the table gradient.

    Args:
        x01: (B, D) points in [0, 1]; with a scene axis (S, B, D).
        table: (total_params, C) f32 master table; with a scene axis
            (S, total_params, C), and scene s's points read table s.
        table_dtype: None (f32) or "bfloat16": the dtype the table is read in.

    Returns:
        (B, L * C) f32 encodings, or (S, B, L * C), zero where inputs
        leave the unit box.
    """
    if table.ndim == 3:
        S, T, C = table.shape
        B = x01.shape[1]
        # scene s's rows sit at s * T in the (S * T, C) table
        first = torch.arange(S, device=x01.device).repeat_interleave(B) * T
        out = _encode_plain(x01.reshape(S * B, -1), table.reshape(S * T, C),
                            enc, table_dtype, first[:, None, None])
        return out.reshape(S, B, -1)
    return _encode_plain(x01, table, enc, table_dtype)


def _encode_plain(x01: torch.Tensor, table: torch.Tensor, enc: GridEncoding,
                  table_dtype: Optional[str],
                  first_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`grid_encode_plain` of (B, D) points; ``first_row`` (B, 1, 1)
    offsets each point's rows into ``table``."""
    B, D = x01.shape
    L, C = enc.num_levels, enc.level_dim
    x01 = x01.to(torch.float32)
    tbl = _round_table(table, table_dtype)
    index, frac = _corners(x01, enc)
    index = _rows(index, enc)                                  # (B, L, K)
    if first_row is not None:
        index = index + first_row

    # corner k = sum_d bit_d 2^d: combine the per-axis terms for bit 0/1
    # axis by axis, the new axis most significant.  The weight is
    # (w0 * w1) * w2, the product order of the kernel.
    w = None
    for d in range(D):
        wd = torch.stack([1.0 - frac[..., d], frac[..., d]], dim=-1)
        w = wd if w is None else (w[..., None, :] * wd[..., :, None]
                                  ).flatten(-2)                # (B, L, 2^d)
    if table_dtype is not None:
        w = w.to(getattr(torch, table_dtype)).to(torch.float32)

    K = index.shape[-1]
    out = torch.nn.functional.embedding_bag(
        index.reshape(B * L, K), tbl, per_sample_weights=w.reshape(B * L, K),
        mode="sum").reshape(B, L * C)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    return torch.where(oob[:, None], torch.zeros_like(out), out)


def grid_encode(x01: torch.Tensor, table: torch.Tensor, enc: GridEncoding,
                table_dtype: Optional[str] = None) -> torch.Tensor:
    """Encode (B, D) points in [0, 1] with the f32 master ``table``, or
    (S, B, D) points of S scenes with their (S, T, C) tables in one call.

    A CUDA tensor always goes to the hand-written kernel; a CPU tensor to
    the plain version.  Positions take no gradient on the kernel path.
    """
    return grid_encode_plain(x01, table, enc, table_dtype)


def ray_ordered_points(n_rays: int, n_samples: int,
                       generator: torch.Generator,
                       device="cpu") -> torch.Tensor:
    """(n_rays * n_samples, 3) points in [0, 1]^3 in the order the renderer
    hands them to the encode: ray by ray, samples fastest
    (``render/volume.py``, ``(R, S, 3).reshape(-1, 3)``).

    The rays are one camera's pixels in row-major order: from a point 1.5
    from the box's centre, through a square grid spanning +-0.25 about
    the centre, so neighbouring rays cross the same coarse cells.  Half of
    each ray's samples are stratified over its span in the box with the
    renderer's jitter; the other half are packed about the ray's hit on a
    sphere of radius 0.4 about the centre (sd 2% of the span), as the
    importance pass packs them.  Each ray's samples are sorted and clamped
    to the box, which piles the jittered ends onto its faces as the
    renderer's clamp does.  Drawn from ``generator`` on ``device``.
    """
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def unit(v):
        return v / v.norm(dim=-1, keepdim=True)

    view = unit(torch.randn(3, generator=generator, device=device))
    origin = 0.5 + 1.5 * view
    a = torch.randn(3, generator=generator, device=device)
    right = unit(a - (a @ view) * view)
    up = torch.linalg.cross(view, right)
    side = math.ceil(math.sqrt(n_rays))
    i = torch.arange(n_rays, device=device)
    s = ((i % side + 0.5) / side - 0.5)[:, None]
    r = ((i // side + 0.5) / side - 0.5)[:, None]
    d = unit(0.5 + 0.5 * (s * right + r * up) - origin)
    d = torch.where(d.abs() < 1e-6, torch.full_like(d, 1e-6), d)
    t0, t1 = -origin / d, (1.0 - origin) / d
    near = torch.minimum(t0, t1).amax(dim=-1, keepdim=True)
    far = torch.maximum(t0, t1).amin(dim=-1, keepdim=True)
    span = far - near
    n_strat = n_samples // 2
    strat = near + span * torch.linspace(0.0, 1.0, n_strat, device=device) \
        + (rand(n_rays, n_strat) - 0.5) * span / n_strat
    b = (d * (origin - 0.5)).sum(-1, keepdim=True)
    hit = -b - torch.sqrt(b * b - ((origin - 0.5) ** 2).sum() + 0.16)
    packed = hit + 0.02 * span * torch.randn(
        n_rays, n_samples - n_strat, generator=generator, device=device)
    t = torch.sort(torch.cat([strat, packed], dim=-1), dim=-1).values
    pts = origin + d[:, None, :] * t[..., None]
    return pts.clamp(0.0, 1.0).reshape(-1, 3)


def grid_encode_bound(x: torch.Tensor, table: torch.Tensor,
                      enc: GridEncoding, bound: float = 1.0,
                      table_dtype: Optional[str] = None) -> torch.Tensor:
    """Encode world points in [-bound, bound]: (..., D) with a (T, C)
    table, or (S, ..., D) with S scenes' (S, T, C) tables."""
    prefix = x.shape[:-1]
    scenes = x.shape[:1] if table.ndim == 3 else ()
    x01 = (x.reshape(*scenes, -1, enc.input_dim) + bound) / (2.0 * bound)
    out = grid_encode(x01, table, enc, table_dtype)
    return out.reshape(*prefix, enc.output_dim)
