"""Occupancy grid: morton coding, density-grid EMA, bitfield, guided sampling.

Counterpart of ``sparsefusion_tpu/render/occupancy.py``, same semantics:

* ``morton3D`` / ``morton3D_invert``: 10-bit-per-axis bit interleaving,
* ``density_grid_update``: the density at every cell centre (+ jitter)
  of each mip cascade, an EMA-decayed max with the old grid, the mean,
  and the bitfield at ``min(mean, density_thresh)``,
* ``packbits``: density > thresh packed 8 cells a byte in morton order,
  cell ``8j + k`` in bit ``k`` of byte ``j`` (least significant first),
* ``occupancy_lookup``: one bit per point, the smallest cascade whose
  bound holds the point,
* ``occupancy_near_far``: [near, far] tightened to the occupied span of
  each ray, probed at ``n_probe`` points.

Plain PyTorch on any device.  torch's uint32 has few operations, so the
bit arithmetic runs in int64 and keeps the low 32 bits, which is what
uint32 wraps to; codes come back as int32, as in the JAX package.
``density_grid_update`` takes its jitter, (C, H^3, 3) uniforms, as an
optional draw; without it the uniforms come from the caller's
``torch.Generator``.

A grid with ``n_scenes`` holds S scenes' density grids (S, C, H^3) and
bitfields (S, C*H^3/8), the JAX scene-batched loop's vmapped grids
(``distill/batched.py``): one update pass evaluates all S fields at once,
each scene against its own mean, and the lookup and near/far take (S, N,
3) points or rays, each scene in its own bitfield.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

_MASK32 = 0xFFFFFFFF


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor, as int32 (two's complement)."""
    v = v & _MASK32
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the bits of a 10-bit int to every 3rd bit (uint32 in int64)."""
    v = v.to(torch.int64) & _MASK32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3D(coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) int coords in [0, 1024) -> (N,) int32 morton codes."""
    x = _expand_bits(coords[..., 0])
    y = _expand_bits(coords[..., 1])
    z = _expand_bits(coords[..., 2])
    return _to_int32(x | (y << 1) | (z << 2))


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3D_invert(indices: torch.Tensor) -> torch.Tensor:
    """(N,) morton codes -> (N, 3) int32 coords."""
    i = indices.to(torch.int64) & _MASK32
    return torch.stack([_compact_bits(i), _compact_bits(i >> 1),
                        _compact_bits(i >> 2)], dim=-1).to(torch.int32)


def packbits(grid: torch.Tensor, density_thresh) -> torch.Tensor:
    """(C, H^3) densities (morton order) -> (C*H^3//8,) uint8 bitfield;
    ``density_thresh`` a float or a 0-d tensor.  S scenes' (S, C, H^3)
    grids with (S,) thresholds -> (S, C*H^3//8)."""
    lead = grid.shape[:-2]
    if lead:
        density_thresh = density_thresh.reshape(*lead, 1, 1)
    occ = (grid > density_thresh).to(torch.int32).reshape(*lead, -1, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=grid.device)
    return (occ << shifts).sum(dim=-1).to(torch.uint8)


def cascade_count(bound: float) -> int:
    """Mip cascades of a grid over [-bound, bound]^3."""
    return 1 + int(math.ceil(math.log2(max(bound, 1.0))))


@dataclasses.dataclass
class OccupancyGrid:
    """Mip-cascaded density grid state on one device; with ``n_scenes``,
    S scenes' grids with a leading scene axis."""

    bound: float = 4.0
    grid_size: int = 128
    density_thresh: float = 10.0
    device: Optional[torch.device] = None
    n_scenes: Optional[int] = None

    def __post_init__(self):
        self.cascade = cascade_count(self.bound)
        n = self.grid_size ** 3
        lead = () if self.n_scenes is None else (self.n_scenes,)
        self.density_grid = torch.zeros((*lead, self.cascade, n),
                                        dtype=torch.float32,
                                        device=self.device)
        self.mean_density = 0.0
        self.iter_density = 0
        self.bitfield = torch.zeros((*lead, self.cascade * n // 8),
                                    dtype=torch.uint8, device=self.device)

    def update(self, density_fn: Callable,
               generator: Optional[torch.Generator] = None,
               decay: float = 0.95,
               jitter: Optional[torch.Tensor] = None) -> "OccupancyGrid":
        """One maintenance step (``density_grid_update``); the mean a
        float, or S of them."""
        self.density_grid, self.bitfield, mean = density_grid_update(
            self.density_grid, density_fn, self.bound, self.grid_size,
            self.cascade, self.density_thresh, decay, generator=generator,
            jitter=jitter)
        self.mean_density = mean.tolist()
        self.iter_density += 1
        return self

    def occupancy_at(self, x: torch.Tensor) -> torch.Tensor:
        return occupancy_lookup(self.bitfield, x, self.bound,
                                self.grid_size, self.cascade)

    def occupancy_near_far(self, rays_o, rays_d, near, far,
                           n_probe: int = 64):
        return occupancy_near_far(self.bitfield, rays_o, rays_d, near, far,
                                  self.bound, self.grid_size, self.cascade,
                                  n_probe)

    def full_bitfield(self) -> torch.Tensor:
        """All-occupied bitfield (the guided paths' warm-up no-op)."""
        return torch.full_like(self.bitfield, 255)


def cell_points(grid_size: int, device=None) -> torch.Tensor:
    """(H^3, 3) cell centres in [-1, 1]^3, in morton order."""
    coords = morton3D_invert(torch.arange(grid_size ** 3, dtype=torch.int32,
                                          device=device))
    return 2.0 * coords.to(torch.float32) / (grid_size - 1) - 1.0


@torch.no_grad()
def density_grid_update(density_grid: torch.Tensor, density_fn: Callable,
                        bound: float, grid_size: int, cascade: int,
                        density_thresh: float, decay: float = 0.95,
                        generator: Optional[torch.Generator] = None,
                        jitter: Optional[torch.Tensor] = None):
    """One density-grid maintenance step.

    ``density_fn`` maps (P, 3) world points to (P,) densities.  ``jitter``
    (C, H^3, 3) uniforms in [0, 1) move each cascade's cell centres by up
    to half a cell; drawn from ``generator`` when not given.  With S
    scenes' (S, C, H^3) grids, ``density_fn`` maps (S, P, 3) points to (S,
    P) densities in one call a cascade, and ``jitter`` is (S, C, H^3, 3).

    Returns ``(new_density_grid, bitfield, mean_density)``, the mean a
    0-d tensor, or (S,).
    """
    gs = grid_size
    dev = density_grid.device
    lead = tuple(density_grid.shape[:-2])
    xyz01 = cell_points(gs, dev)
    if jitter is None:
        jitter = torch.rand((*lead, cascade, gs ** 3, 3),
                            generator=generator, device=dev)
    elif tuple(jitter.shape) != (*lead, cascade, gs ** 3, 3):
        raise ValueError(f"jitter {tuple(jitter.shape)} != "
                         f"{(*lead, cascade, gs ** 3, 3)}")
    jitter = jitter.to(dev)
    new_levels = []
    for cas in range(cascade):
        cas_bound = min(2 ** cas, bound)
        half_cell = cas_bound / gs
        pts = xyz01 * (cas_bound - half_cell)
        pts = pts + (jitter[..., cas, :, :] * 2 - 1) * half_cell
        new_levels.append(density_fn(pts).reshape(*lead, -1)
                          .to(torch.float32))
    tmp = torch.stack(new_levels, dim=-2)         # (C, H^3) morton order
    new_grid = torch.maximum(density_grid * decay, tmp)
    mean = new_grid.flatten(-2).mean(-1) if lead else new_grid.mean()
    thresh = torch.clamp(mean, max=density_thresh)
    return new_grid, packbits(new_grid, thresh), mean


def occupancy_lookup(bitfield: torch.Tensor, x: torch.Tensor, bound: float,
                     grid_size: int, cascade: int) -> torch.Tensor:
    """(N, 3) world points -> (N,) bool occupancy.  The mip level is the
    smallest cascade whose bound holds the point.  S scenes' (S, N, 3)
    points with their (S, C*H^3/8) bitfields -> (S, N)."""
    gs = grid_size
    mx = x.abs().amax(dim=-1)
    level = torch.clamp(torch.ceil(torch.log2(torch.clamp(mx, min=1.0))),
                        0, cascade - 1).to(torch.int64)
    # made on the device: a host tensor copied here would stall the loop
    # and cannot be captured in a CUDA graph
    bounds = torch.clamp(2.0 ** torch.arange(cascade, dtype=torch.float32,
                                             device=x.device), max=bound)
    cas_bound = bounds[level]
    pos = (x / cas_bound[..., None] + 1.0) * 0.5 * gs
    # truncated toward zero as astype(int32) does; clamped first so points
    # far outside the box (rays that miss it) convert to a defined value
    coords = torch.clamp(pos, -1.0, float(gs)).to(torch.int32)
    coords = torch.clamp(coords, 0, gs - 1)
    idx = level * (gs ** 3) + morton3D(coords).to(torch.int64)
    if bitfield.ndim == 2:
        # scene s's bits start at s times a bitfield's bits
        idx = idx + torch.arange(bitfield.shape[0], device=x.device)[
            :, None] * (8 * bitfield.shape[1])
    byte = bitfield.reshape(-1)[idx // 8].to(torch.int32)
    return ((byte >> (idx % 8).to(torch.int32)) & 1).to(torch.bool)


def occupancy_near_far(bitfield: torch.Tensor, rays_o: torch.Tensor,
                       rays_d: torch.Tensor, near: torch.Tensor,
                       far: torch.Tensor, bound: float, grid_size: int,
                       cascade: int, n_probe: int = 64):
    """Tighten [near, far] to the occupied span along each ray: returns
    (near, far, any_occ), each (N,); (S, N) for S scenes' (S, N, 3) rays
    in their (S, C*H^3/8) bitfields."""
    t = torch.linspace(0.0, 1.0, n_probe, device=near.device)
    ts = near[..., None] + (far - near)[..., None] * t        # (N, P)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * ts[..., None]
    occ = occupancy_lookup(bitfield, pts.reshape(*ts.shape[:-2], -1, 3),
                           bound, grid_size, cascade).reshape(ts.shape)
    any_occ = occ.any(dim=-1)
    inf = torch.full_like(ts, math.inf)
    big = torch.where(occ, ts, inf)
    small = torch.where(occ, ts, -inf)
    dt = (far - near) / (n_probe - 1)
    new_near = torch.where(
        any_occ, torch.clamp(big.amin(dim=-1) - dt, min=near, max=far), near)
    new_far = torch.where(
        any_occ, torch.clamp(small.amax(dim=-1) + dt, min=near, max=far), far)
    return new_near, new_far, any_occ
