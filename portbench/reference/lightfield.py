"""Light-field rendering: the EFT over a camera's ray grid.

Frozen copy of the port's ``render/lightfield.py`` (the JAX ``sparsefusion_tpu/render/lightfield.py``'s counterpart): grid rays (the
reference's reversed half-pixel bounds) go through the EFT in equal
chunks; the per-ray rgb and feature outputs come back as images.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from portbench.reference.cameras import Cameras
from portbench.reference.rays import grid_ray_bundle
from portbench.reference.eft import batched_forward


def render_light_field(
    eft_apply: Callable,
    cameras: Cameras,
    image_height: int,
    image_width: int,
    min_depth: float,
    max_depth: float,
    n_pts_per_ray: int = 20,
    n_batches: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EFT rgb (N, H, W, 3) and feature (N, H, W, F) images of ``cameras``;
    ``eft_apply(origins (n, 3), dirs (n, 3), lengths (n, D))`` is the EFT
    bound to its context views."""
    bundle = grid_ray_bundle(cameras, image_height, image_width,
                             n_pts_per_ray, min_depth, max_depth)
    return batched_forward(eft_apply, bundle.origins, bundle.directions,
                           bundle.lengths, n_batches=n_batches)
