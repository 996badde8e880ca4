"""Procedural multi-view scene for tests and demos without CO3D on disk.

Counterpart of ``sparsefusion_tpu/data/synthetic.py``: an orbit of
cameras around colored gaussian density blobs, with ground-truth images
rendered through the port's own volume renderer.  The blob layout and
cameras come from numpy seeds, so both packages make the same scene.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from sparsefusion_tpu_torch.core.cameras import Cameras, look_at_view_transform
from sparsefusion_tpu_torch.core.rays import grid_ray_bundle
from sparsefusion_tpu_torch.data.contract import SceneData
from sparsefusion_tpu_torch.render.volume import (
    VolumeRendererConfig,
    render_rays,
)


def blob_field(centers: np.ndarray, colors: np.ndarray, sigma: float = 60.0,
               radius: float = 0.45, device=None):
    """Gaussian density blobs with per-blob albedo."""
    centers_t = torch.as_tensor(centers, dtype=torch.float32, device=device)
    colors_t = torch.as_tensor(colors, dtype=torch.float32, device=device)

    def field(x):
        d2 = ((x[:, None, :] - centers_t[None]) ** 2).sum(dim=-1)
        dens = sigma * torch.exp(-d2 / (2 * radius ** 2))  # (P, K)
        total = dens.sum(dim=-1)
        w = dens / torch.clamp(total[:, None], min=1e-8)
        return total, w @ colors_t

    return field


def orbit_cameras(n_views: int, radius: float = 3.0, height: float = 0.8,
                  focal: float = 3.0, image_size: int = 64,
                  seed: int = 0, device=None) -> Cameras:
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 2 * math.pi, n_views, endpoint=False)
    t = t + rng.uniform(-0.05, 0.05, n_views)
    h = height + rng.uniform(-0.15, 0.15, n_views)
    eye = np.stack([radius * np.cos(t), h, radius * np.sin(t)],
                   axis=1).astype(np.float32)
    at = np.zeros((1, 3), np.float32)
    up = np.array([[0.0, 1.0, 0.0]], np.float32)
    R, T = look_at_view_transform(eye, at, up)
    n = n_views
    return Cameras.create(R, T, np.full((n, 2), focal, np.float32),
                          np.zeros((n, 2), np.float32),
                          np.full((n, 2), float(image_size), np.float32),
                          device=device)


@torch.no_grad()
def make_synthetic_scene(n_views: int = 10, image_size: int = 64,
                         n_blobs: int = 4, seed: int = 0,
                         bound: float = 4.0, device=None) -> SceneData:
    """Render the blob scene on ``device``; returns host numpy arrays."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.7, 0.7, (n_blobs, 3)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (n_blobs, 3)).astype(np.float32)

    cams = orbit_cameras(n_views, image_size=image_size, seed=seed,
                         device=device)
    cfg = VolumeRendererConfig(num_steps=96, upsample_steps=0, bound=bound,
                               min_near=0.1)
    field = blob_field(centers, colors, device=device)
    bundle = grid_ray_bundle(cams, image_size, image_size, n_pts_per_ray=2,
                             min_depth=1.0, max_depth=5.0)
    out = render_rays(field, bundle.origins.reshape(-1, 3),
                      bundle.directions.reshape(-1, 3), cfg,
                      det_importance=True, bg_color=0.0)
    images = out["image"].reshape(n_views, image_size, image_size, 3)
    masks = out["weights_sum"].reshape(n_views, image_size, image_size, 1)

    cams = cams.to("cpu")
    n = n_views
    return SceneData(
        images=np.clip(images.cpu().numpy(), 0, 1).astype(np.float32),
        R=cams.R.numpy(), T=cams.T.numpy(),
        f=cams.focal_length.numpy(), c=cams.principal_point.numpy(),
        valid_region=np.ones((n, image_size, image_size, 1), np.float32),
        image_size=cams.image_size.numpy(),
        masks=np.clip(masks.cpu().numpy(), 0, 1).astype(np.float32),
        sequence_name=f"synthetic_{seed:03d}",
    )


class SyntheticDataset:
    """Dataset-shaped wrapper: index -> SceneData (new blob layout each)."""

    def __init__(self, n_scenes: int = 4, n_views: int = 10,
                 image_size: int = 64, device=None):
        self.n_scenes = n_scenes
        self.n_views = n_views
        self.image_size = image_size
        self.device = device
        self._cache = {}

    def __len__(self):
        return self.n_scenes

    def __getitem__(self, idx: int) -> SceneData:
        if idx not in self._cache:
            self._cache[idx] = make_synthetic_scene(
                self.n_views, self.image_size, seed=idx, device=self.device)
        return self._cache[idx]
