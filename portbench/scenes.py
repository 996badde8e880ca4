"""Synthetic scenes drawn from the run's seed: an orbit of cameras around
coloured gaussian density blobs, rendered through the reference's volume
renderer.

A copy of the blob-scene arithmetic of the port's ``data/synthetic.py``
(the layout, the cameras and the 96-sample render), made here so that the
program under test receives the scene as an input; the renders go view by
view, which keeps set-up memory to one view's samples.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.cameras import Cameras, look_at_view_transform
from portbench.reference.rays import grid_ray_bundle
from portbench.reference.volume import VolumeRendererConfig, render_rays


@dataclasses.dataclass
class Scene:
    images: np.ndarray        # (N, H, W, 3) in [0, 1]
    masks: np.ndarray         # (N, H, W, 1)
    valid_region: np.ndarray  # (N, H, W, 1)
    R: np.ndarray
    T: np.ndarray
    f: np.ndarray
    c: np.ndarray
    image_size: np.ndarray
    sequence_name: str

    def __len__(self) -> int:
        return self.images.shape[0]

    def cameras(self, device=None) -> Cameras:
        return Cameras.create(self.R, self.T, self.f, self.c,
                              self.image_size, device=device)


def _blob_field(centers, colors, device, sigma=60.0, radius=0.45):
    centers_t = torch.as_tensor(centers, dtype=torch.float32, device=device)
    colors_t = torch.as_tensor(colors, dtype=torch.float32, device=device)

    def field(x):
        d2 = ((x[:, None, :] - centers_t[None]) ** 2).sum(dim=-1)
        dens = sigma * torch.exp(-d2 / (2 * radius ** 2))
        total = dens.sum(dim=-1)
        w = dens / torch.clamp(total[:, None], min=1e-8)
        return total, w @ colors_t

    return field


def _orbit(n_views: int, image_size: int, rng, device, radius=3.0,
           height=0.8, focal=3.0) -> Cameras:
    t = np.linspace(0, 2 * math.pi, n_views, endpoint=False)
    t = t + rng.uniform(-0.05, 0.05, n_views)
    h = height + rng.uniform(-0.15, 0.15, n_views)
    eye = np.stack([radius * np.cos(t), h, radius * np.sin(t)],
                   axis=1).astype(np.float32)
    R, T = look_at_view_transform(eye, np.zeros((1, 3), np.float32),
                                  np.array([[0.0, 1.0, 0.0]], np.float32))
    n = n_views
    return Cameras.create(R, T, np.full((n, 2), focal, np.float32),
                          np.zeros((n, 2), np.float32),
                          np.full((n, 2), float(image_size), np.float32),
                          device=device)


@torch.no_grad()
def blob_scene(seed: int, n_views: int, image_size: int, device,
               n_blobs: int = 4, bound: float = 4.0) -> Scene:
    """One scene of ``n_blobs`` blobs, its layout and cameras from
    ``seed`` (a 32-bit seed)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.7, 0.7, (n_blobs, 3)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (n_blobs, 3)).astype(np.float32)
    cams = _orbit(n_views, image_size, np.random.RandomState(seed), device)
    cfg = VolumeRendererConfig(num_steps=96, upsample_steps=0, bound=bound,
                               min_near=0.1)
    field = _blob_field(centers, colors, device)
    bundle = grid_ray_bundle(cams, image_size, image_size, n_pts_per_ray=2,
                             min_depth=1.0, max_depth=5.0)
    origins = bundle.origins.reshape(n_views, -1, 3)
    dirs = bundle.directions.reshape(n_views, -1, 3)
    images, masks = [], []
    for v in range(n_views):
        out = render_rays(field, origins[v], dirs[v], cfg,
                          det_importance=True, bg_color=0.0)
        images.append(out["image"].reshape(image_size, image_size, 3).cpu())
        masks.append(out["weights_sum"].reshape(image_size, image_size,
                                                1).cpu())
    cams = cams.to("cpu")
    n = n_views
    return Scene(
        images=np.clip(torch.stack(images).numpy(), 0, 1).astype(np.float32),
        masks=np.clip(torch.stack(masks).numpy(), 0, 1).astype(np.float32),
        valid_region=np.ones((n, image_size, image_size, 1), np.float32),
        R=cams.R.numpy(), T=cams.T.numpy(), f=cams.focal_length.numpy(),
        c=cams.principal_point.numpy(), image_size=cams.image_size.numpy(),
        sequence_name=f"portbench_{seed}")


def input_views(seed: int, n_frames: int, n_views: int) -> list:
    """The demo's seeded choice of input views (a permutation's head)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n_frames, generator=g)[:n_views].tolist()
