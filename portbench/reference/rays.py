"""Ray bundles matching PyTorch3D's grid raysampler.

Frozen copy of the port's ``core/rays.py`` (the JAX ``sparsefusion_tpu/core/rays.py``'s counterpart): the reference builds
its rays with *reversed* NDC bounds (min_x = 1 - 1/W, max_x = -1 + 1/W)
and ``_xy_to_ray_bundle`` semantics: unproject each xy at depths 1 and 2,
direction = p2 - p1 (unnormalized, unit z in view space), origin =
p1 - direction (the camera center), lengths = linspace(min_depth,
max_depth) as view-space z-depths.  The Monte Carlo sampler's uniform
xy draws come from an explicit ``torch.Generator``, or are passed in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from portbench.reference.cameras import Cameras, unproject_ndc_points


@dataclasses.dataclass(frozen=True)
class RayBundle:
    """origins (..., 3), directions (..., 3), lengths (..., P), xys (..., 2)."""

    origins: torch.Tensor
    directions: torch.Tensor
    lengths: torch.Tensor
    xys: Optional[torch.Tensor]


def ray_points(bundle: RayBundle) -> torch.Tensor:
    """World points along the rays, o + d * t: (..., P, 3) (pytorch3d
    ``ray_bundle_to_ray_points``)."""
    return (bundle.origins[..., None, :]
            + bundle.directions[..., None, :] * bundle.lengths[..., :, None])


Depth = Union[float, torch.Tensor]


def depth_linspace(min_depth: Depth, max_depth: Depth, n: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """``torch.linspace(min_depth, max_depth, n)``.  The ends are floats,
    or 0-d tensors on ``device`` (the train step's depth range, computed
    on the device): ``torch.linspace`` would read those on the host, so
    their points are made by device operations, with the formula of
    PyTorch's linspace kernels (from the start below the midpoint, from
    the end above it).  Within one ulp of the larger end's magnitude of
    ``torch.linspace`` on the same ends (its vectorised CPU loop rounds
    in another order), not bit-equal."""
    if not isinstance(min_depth, torch.Tensor) \
            and not isinstance(max_depth, torch.Tensor):
        return torch.linspace(min_depth, max_depth, n, dtype=dtype,
                              device=device)
    lo = torch.as_tensor(min_depth, dtype=dtype, device=device)
    hi = torch.as_tensor(max_depth, dtype=dtype, device=device)
    if n == 1:
        return lo.reshape(1)
    i = torch.arange(n, dtype=dtype, device=device)
    step = (hi - lo) / (n - 1)
    return torch.where(i < n // 2, lo + step * i, hi - step * (n - 1 - i))


def xy_to_ray_bundle(cameras: Cameras, xy_grid: torch.Tensor,
                     min_depth: Depth, max_depth: Depth,
                     n_pts_per_ray: int) -> RayBundle:
    """PyTorch3D ``_xy_to_ray_bundle``; xy_grid is (N, ..., 2) NDC xys;
    the depths floats or 0-d tensors (:func:`depth_linspace`)."""
    n = xy_grid.shape[0]
    spatial = xy_grid.shape[1:-1]
    xy_flat = xy_grid.reshape(n, -1, 2)
    p = xy_flat.shape[1]

    depths = depth_linspace(min_depth, max_depth, n_pts_per_ray,
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


@dataclasses.dataclass(frozen=True)
class GridRaysampler:
    """Fixed-shape grid ray sampler (pytorch3d GridRaysampler semantics);
    the depths floats or 0-d tensors (:func:`depth_linspace`)."""

    min_x: float
    max_x: float
    min_y: float
    max_y: float
    image_height: int
    image_width: int
    n_pts_per_ray: int
    min_depth: Depth
    max_depth: Depth

    def __call__(self, cameras: Cameras) -> RayBundle:
        xy = grid_xys(self.image_height, self.image_width, self.min_x,
                      self.max_x, self.min_y, self.max_y,
                      device=cameras.device)
        xy = xy[None].expand(len(cameras), *xy.shape)
        return xy_to_ray_bundle(cameras, xy, self.min_depth, self.max_depth,
                                self.n_pts_per_ray)


@dataclasses.dataclass(frozen=True)
class MonteCarloRaysampler:
    """Uniform-random xy sampler (pytorch3d MonteCarloRaysampler
    semantics): per camera, ``n_rays_per_image`` xs and then as many ys,
    uniform over the bounds, drawn from ``generator`` unless ``xys``
    (N, n_rays_per_image, 2) is given."""

    min_x: float
    max_x: float
    min_y: float
    max_y: float
    n_rays_per_image: int
    n_pts_per_ray: int
    min_depth: float
    max_depth: float

    def __call__(self, cameras: Cameras,
                 generator: Optional[torch.Generator] = None,
                 xys: Optional[torch.Tensor] = None) -> RayBundle:
        if xys is None:
            shape = (len(cameras), self.n_rays_per_image)

            def uniform(a, b):
                lo, hi = min(a, b), max(a, b)
                u = torch.rand(shape, generator=generator,
                               device=cameras.device)
                return lo + u * (hi - lo)

            xs = uniform(self.min_x, self.max_x)
            xys = torch.stack([xs, uniform(self.min_y, self.max_y)], dim=-1)
        return xy_to_ray_bundle(cameras, xys, self.min_depth,
                                self.max_depth, self.n_pts_per_ray)


def grid_ray_bundle(cameras: Cameras, image_height: int, image_width: int,
                    n_pts_per_ray: int, min_depth: Depth,
                    max_depth: Depth) -> RayBundle:
    """Grid rays with the reference's reversed half-pixel bounds; the
    depths floats or 0-d tensors (:func:`depth_linspace`)."""
    half_w = 1.0 / image_width
    half_h = 1.0 / image_height
    sampler = GridRaysampler(
        min_x=1.0 - half_w, max_x=-1.0 + half_w,
        min_y=1.0 - half_h, max_y=-1.0 + half_h,
        image_height=image_height, image_width=image_width,
        n_pts_per_ray=n_pts_per_ray, min_depth=min_depth, max_depth=max_depth)
    return sampler(cameras)


def monte_carlo_ray_bundle(cameras: Cameras,
                           generator: Optional[torch.Generator],
                           n_rays: int, n_pts_per_ray: int, min_depth: float,
                           max_depth: float, bbox=None,
                           xys: Optional[torch.Tensor] = None) -> RayBundle:
    """Monte Carlo rays over the full NDC square or a bbox (the
    reference's ``render_utils.py:66-87``)."""
    if bbox is None:
        bounds = dict(min_x=-1.0, max_x=1.0, min_y=-1.0, max_y=1.0)
    else:
        bounds = dict(min_x=-bbox[0][1], max_x=-bbox[0][3],
                      min_y=-bbox[0][0], max_y=-bbox[0][2])
    sampler = MonteCarloRaysampler(
        n_rays_per_image=n_rays, n_pts_per_ray=n_pts_per_ray,
        min_depth=min_depth, max_depth=max_depth, **bounds)
    return sampler(cameras, generator, xys)
