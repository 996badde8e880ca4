"""Perspective cameras with PyTorch3D-compatible conventions, as tensors.

Counterpart of ``sparsefusion_tpu/core/cameras.py``; the conventions are
the same:

Row-vector convention (points are rows, transforms multiply on the right):

    x_view = x_world @ R + T                      # world-to-view
    C      = -T @ R^T                             # camera center in world

NDC unprojection of (x_ndc, y_ndc, depth):

    x = (x_ndc - px) * depth / fx,  y = (y_ndc - py) * depth / fy,  z = depth
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Cameras:
    """A batch of perspective cameras (NDC-space intrinsics).

    Attributes:
        R: (N, 3, 3) world-to-view rotations (row-vector convention).
        T: (N, 3) world-to-view translations.
        focal_length: (N, 2) NDC focal lengths (fx, fy).
        principal_point: (N, 2) NDC principal points (px, py).
        image_size: (N, 2) image sizes in pixels as (H, W).
    """

    R: torch.Tensor
    T: torch.Tensor
    focal_length: torch.Tensor
    principal_point: torch.Tensor
    image_size: torch.Tensor

    def __len__(self) -> int:
        return self.R.shape[0]

    @property
    def device(self) -> torch.device:
        return self.R.device

    def to(self, device) -> "Cameras":
        return Cameras(*(getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)))

    @staticmethod
    def create(R, T, focal_length, principal_point, image_size,
               device=None) -> "Cameras":
        def f32(a):
            if not isinstance(a, torch.Tensor):
                a = np.array(a, np.float32)  # a copy: views may be read-only
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        R = f32(R)
        T = f32(T)
        n = R.shape[0]
        focal_length = f32(focal_length).reshape(-1, 2).expand(n, 2)
        principal_point = f32(principal_point).reshape(-1, 2).expand(n, 2)
        image_size = f32(image_size).reshape(-1, 2).expand(n, 2)
        return Cameras(R, T, focal_length.contiguous(),
                       principal_point.contiguous(), image_size.contiguous())


def view_to_world(cameras: Cameras, points: torch.Tensor) -> torch.Tensor:
    """View-space points (N, P, 3) to world: x_world = (x_view - T) @ R^T."""
    if points.ndim == 2:
        points = points[None]
    return torch.einsum("npi,nji->npj", points - cameras.T[:, None, :],
                        cameras.R)


def camera_centers(cameras: Cameras) -> torch.Tensor:
    """Camera centers in world coordinates: C = -T @ R^T.  (N, 3)."""
    return -torch.einsum("ni,nji->nj", cameras.T, cameras.R)


def unproject_ndc_points(cameras: Cameras,
                         xy_depth: torch.Tensor) -> torch.Tensor:
    """(N, P, 3) (x_ndc, y_ndc, view depth z) -> (N, P, 3) world points."""
    f = cameras.focal_length[:, None, :]
    c = cameras.principal_point[:, None, :]
    depth = xy_depth[..., 2:3]
    xy_view = (xy_depth[..., :2] - c) * depth / f
    xv = torch.cat([xy_view, depth], dim=-1)
    return view_to_world(cameras, xv)


def get_camera_slice(cameras: Cameras, indices) -> Cameras:
    """Subset of cameras by indices."""
    idx = torch.as_tensor(indices, dtype=torch.long,
                          device=cameras.device).reshape(-1)
    return Cameras(*(getattr(cameras, f.name)[idx]
                     for f in dataclasses.fields(cameras)))


def concat_cameras(camera_list: Sequence[Cameras]) -> Cameras:
    """Concatenate camera batches."""
    return Cameras(*(torch.cat([getattr(c, f.name) for c in camera_list])
                     for f in dataclasses.fields(Cameras)))


def _w2v_matrix(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """4x4 world-to-view matrices, row-vector convention: [[R, 0], [T, 1]]."""
    n = R.shape[0]
    M = torch.zeros((n, 4, 4), dtype=R.dtype, device=R.device)
    M[:, :3, :3] = R
    M[:, 3, :3] = T
    M[:, 3, 3] = 1.0
    return M


def get_relative_cameras(cameras: Cameras, query_idx,
                         center_at_origin: bool = False) -> Cameras:
    """Re-express all cameras relative to a base query camera.

    The relative world-to-view transform is g_q^{-1} o g_i, where g_q has
    the query rotation and either the query translation
    (``center_at_origin=True``) or zero translation.
    """
    q = int(torch.as_tensor(query_idx).reshape(-1)[0])
    Rq = cameras.R[q][None]
    Tq = cameras.T[q][None]
    if not center_at_origin:
        Tq = torch.zeros_like(Tq)
    M_id_inv = torch.linalg.inv(_w2v_matrix(Rq, Tq))
    M_all = _w2v_matrix(cameras.R, cameras.T)
    M_rel = torch.einsum("bij,njk->nik", M_id_inv, M_all)
    return Cameras(
        R=M_rel[:, :3, :3].contiguous(),
        T=M_rel[:, 3, :3].contiguous(),
        focal_length=cameras.focal_length,
        principal_point=cameras.principal_point,
        image_size=cameras.image_size,
    )


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-5)


def look_at_rotation(eye, at, up) -> torch.Tensor:
    """Rotation for a camera at ``eye`` looking at ``at`` with ``up``.

    PyTorch3D ``look_at_rotation`` semantics; where ``up`` is parallel to
    the view direction an arbitrary axis orthogonal to it is used.  All
    inputs broadcast to (N, 3); returns (N, 3, 3).
    """
    eye, at, up = torch.broadcast_tensors(
        torch.atleast_2d(torch.as_tensor(eye, dtype=torch.float32)),
        torch.atleast_2d(torch.as_tensor(at, dtype=torch.float32)),
        torch.atleast_2d(torch.as_tensor(up, dtype=torch.float32)))
    z_axis = _normalize(at - eye)
    x_axis = _normalize(torch.linalg.cross(up, z_axis, dim=-1))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis, dim=-1))
    is_close = torch.all(x_axis.abs() < 5e-3, dim=-1, keepdim=True)
    ex = torch.tensor([1.0, 0.0, 0.0], device=z_axis.device)
    ez = torch.tensor([0.0, 0.0, 1.0], device=z_axis.device)
    arbitrary = torch.where(z_axis[..., :1].abs() < 0.9, ex, ez)
    replacement = _normalize(torch.linalg.cross(z_axis, arbitrary, dim=-1))
    x_axis = torch.where(is_close, replacement, x_axis)
    y_axis = torch.where(
        is_close, _normalize(torch.linalg.cross(z_axis, x_axis, dim=-1)),
        y_axis)
    R = torch.stack([x_axis, y_axis, z_axis], dim=1)  # rows = axes
    return R.transpose(1, 2)


def look_at_view_transform(eye, at, up):
    """(R, T) such that x_view = x_world @ R + T puts ``eye`` at the origin."""
    R = look_at_rotation(eye, at, up)
    eye2 = torch.atleast_2d(torch.as_tensor(eye, dtype=torch.float32,
                                            device=R.device))
    eye2 = eye2.expand(R.shape[0], 3)
    T = -torch.einsum("ni,nij->nj", eye2, R)
    return R, T
