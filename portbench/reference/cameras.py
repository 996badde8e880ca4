"""Perspective cameras with PyTorch3D-compatible conventions, as tensors.

Frozen copy of the port's ``core/cameras.py`` (the JAX ``sparsefusion_tpu/core/cameras.py``'s counterpart); the conventions are
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


def world_to_view(cameras: Cameras, points: torch.Tensor) -> torch.Tensor:
    """World points (P, 3) or (N or 1, P, 3) to each camera's view space:
    x_view = x_world @ R + T.  (N, P, 3)."""
    if points.ndim == 2:
        points = points[None]
    points = points.expand(len(cameras), *points.shape[1:])
    return torch.einsum("npi,nij->npj", points, cameras.R) \
        + cameras.T[:, None, :]


def _ndc_scale(cameras: Cameras) -> torch.Tensor:
    """Per-camera (sx, sy) NDC half-span of non-square images: PyTorch3D
    fixes the shorter side's range to [-1, 1] and scales the longer one
    by long / short; (1, 1) for square images.  (N, 2)."""
    h = cameras.image_size[:, 0]
    w = cameras.image_size[:, 1]
    short = torch.minimum(h, w)
    return torch.stack([w / short, h / short], dim=-1)


def transform_points_ndc(cameras: Cameras, points: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """World points to NDC as PerspectiveCameras.transform_points_ndc:
    (N, P, 3) of (x_ndc, y_ndc, 1 / z)."""
    xv = world_to_view(cameras, points)
    z = xv[..., 2:3]
    z = torch.where(z.abs() < eps,
                    torch.where(z >= 0, torch.full_like(z, eps),
                                torch.full_like(z, -eps)), z)
    f = cameras.focal_length[:, None, :]
    c = cameras.principal_point[:, None, :]
    return torch.cat([f * xv[..., :2] / z + c, 1.0 / z], dim=-1)


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


def stack_cameras(camera_list: Sequence[Cameras]) -> Cameras:
    """S camera batches of one length M as one batch with a (S, M) lead."""
    return Cameras(*(torch.stack([getattr(c, f.name) for c in camera_list])
                     for f in dataclasses.fields(Cameras)))


def pick_per_scene(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[s, idx[s]]`` for every scene s: (S, M, ...) and (S,) int64
    indices on ``a``'s device -> (S, ...), one gather on the device."""
    scenes = torch.arange(idx.shape[0], device=idx.device)
    return a[scenes, idx]


def pick_cameras(cameras: Cameras, idx: torch.Tensor) -> Cameras:
    """Camera ``idx[s]`` of scene s, for cameras with a (S, M) lead
    (:func:`stack_cameras`): a batch of S cameras, gathered on the device
    (the JAX batched loop's ``_pick_cam``)."""
    return Cameras(*(pick_per_scene(getattr(cameras, f.name), idx)
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
