"""Ray bundles matching PyTorch3D's grid raysampler.

Counterpart of ``sparsefusion_tpu/core/rays.py``: the reference builds
its rays with *reversed* NDC bounds (min_x = 1 - 1/W, max_x = -1 + 1/W)
and ``_xy_to_ray_bundle`` semantics: unproject each xy at depths 1 and 2,
direction = p2 - p1 (unnormalized, unit z in view space), origin =
p1 - direction (the camera center), lengths = linspace(min_depth,
max_depth) as view-space z-depths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sparsefusion_tpu_torch.core.cameras import Cameras, unproject_ndc_points


@dataclasses.dataclass(frozen=True)
class RayBundle:
    """origins (..., 3), directions (..., 3), lengths (..., P), xys (..., 2)."""

    origins: torch.Tensor
    directions: torch.Tensor
    lengths: torch.Tensor
    xys: Optional[torch.Tensor]


def xy_to_ray_bundle(cameras: Cameras, xy_grid: torch.Tensor,
                     min_depth: float, max_depth: float,
                     n_pts_per_ray: int) -> RayBundle:
    """PyTorch3D ``_xy_to_ray_bundle``; xy_grid is (N, ..., 2) NDC xys."""
    n = xy_grid.shape[0]
    spatial = xy_grid.shape[1:-1]
    xy_flat = xy_grid.reshape(n, -1, 2)
    p = xy_flat.shape[1]

    depths = torch.linspace(min_depth, max_depth, n_pts_per_ray,
                            dtype=xy_grid.dtype, device=xy_grid.device)
    lengths = depths.expand(n, p, n_pts_per_ray)

    ones = torch.ones((n, p, 1), dtype=xy_grid.dtype, device=xy_grid.device)
    plane1 = unproject_ndc_points(cameras, torch.cat([xy_flat, ones], -1))
    plane2 = unproject_ndc_points(cameras,
                                  torch.cat([xy_flat, 2.0 * ones], -1))
    directions = plane2 - plane1
    origins = plane1 - directions

    return RayBundle(
        origins=origins.reshape(n, *spatial, 3),
        directions=directions.reshape(n, *spatial, 3),
        lengths=lengths.reshape(n, *spatial, n_pts_per_ray),
        xys=xy_grid,
    )


def grid_xys(image_height: int, image_width: int, min_x: float, max_x: float,
             min_y: float, max_y: float, device=None) -> torch.Tensor:
    """The (H, W, 2) NDC xy grid a grid raysampler iterates over."""
    xs = torch.linspace(min_x, max_x, image_width, device=device)
    ys = torch.linspace(min_y, max_y, image_height, device=device)
    x_grid = xs[None, :].expand(image_height, image_width)
    y_grid = ys[:, None].expand(image_height, image_width)
    return torch.stack([x_grid, y_grid], dim=-1)


def grid_ray_bundle(cameras: Cameras, image_height: int, image_width: int,
                    n_pts_per_ray: int, min_depth: float,
                    max_depth: float) -> RayBundle:
    """Grid rays with the reference's reversed half-pixel bounds."""
    half_w = 1.0 / image_width
    half_h = 1.0 / image_height
    xy = grid_xys(image_height, image_width, 1.0 - half_w, -1.0 + half_w,
                  1.0 - half_h, -1.0 + half_h, device=cameras.device)
    xy = xy[None].expand(len(cameras), *xy.shape)
    return xy_to_ray_bundle(cameras, xy, min_depth, max_depth,
                            n_pts_per_ray)
