"""Camera-path augmentation: circle fitting and interpolated orbits.

Frozen copy of the port's ``core/paths.py`` (the JAX ``sparsefusion_tpu/core/paths.py``'s counterpart): host-side numpy that
fits a plane and a circle to the scene's camera centers and returns n
evenly spaced cameras on the circle, looking at the point nearest to all
principal rays.  It runs once per scene at set-up.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.cameras import (
    Cameras,
    camera_centers,
    look_at_view_transform,
    unproject_ndc_points,
)


def _normalize(v, eps=1e-12):
    return v / (np.linalg.norm(v) + eps)


def fit_circle_2d(x: np.ndarray, y: np.ndarray):
    """LSQ circle fit: solve [x y 1] c = x^2 + y^2."""
    A = np.stack([x, y, np.ones_like(x)], axis=1)
    b = x ** 2 + y ** 2
    c, *_ = np.linalg.lstsq(A, b, rcond=None)
    xc, yc = c[0] / 2, c[1] / 2
    r = math.sqrt(max(c[2] + xc ** 2 + yc ** 2, 0.0))
    return xc, yc, r


def rodrigues_rot(P: np.ndarray, n0: np.ndarray, n1: np.ndarray) -> np.ndarray:
    """Rotate points by the rotation taking direction n0 to n1."""
    P = np.atleast_2d(P)
    n0 = _normalize(n0)
    n1 = _normalize(n1)
    k = np.cross(n0, n1)
    k_norm = np.linalg.norm(k)
    if k_norm < 1e-12:
        return P.copy()
    k = k / k_norm
    theta = math.acos(np.clip(np.dot(n0, n1), -1.0, 1.0))
    ct, st = math.cos(theta), math.sin(theta)
    return (P * ct + np.cross(np.broadcast_to(k, P.shape), P) * st
            + np.outer(P @ k, k) * (1 - ct))


def rodrigues_rot_per_point(P: np.ndarray, n1: np.ndarray,
                            theta: np.ndarray) -> np.ndarray:
    """Rotate each point about axis cross(P_i, n1) by theta_i (jitter)."""
    P = np.atleast_2d(P)
    k = np.cross(P, np.broadcast_to(n1, P.shape))
    k = k / (np.linalg.norm(k, axis=-1, keepdims=True) + 1e-12)
    ct = np.cos(theta)[:, None]
    st = np.sin(theta)[:, None]
    kdotp = np.sum(k * P, axis=-1, keepdims=True)
    return P * ct + np.cross(k, P) * st + k * kdotp * (1 - ct)


def generate_circle_points(t: np.ndarray, C: np.ndarray, r: float,
                           n: np.ndarray, u: np.ndarray) -> np.ndarray:
    """P(t) = r cos(t) u + r sin(t) (n x u) + C."""
    n = _normalize(n)
    u = _normalize(u)
    return (r * np.cos(t)[:, None] * u
            + r * np.sin(t)[:, None] * np.cross(n, u) + C)


def get_nearest_centroid(cams: Cameras) -> np.ndarray:
    """Closest point to all cameras' principal rays (least squares)."""
    cams = cams.to("cpu")
    centers = camera_centers(cams).numpy()
    n = len(cams)
    c_mean = cams.principal_point.numpy().mean(axis=0)
    xy = torch.as_tensor(np.tile(c_mean, (n, 1, 1)), dtype=torch.float32)
    ones = torch.ones((n, 1, 1))
    p1 = unproject_ndc_points(cams, torch.cat([xy, ones], -1)).numpy()
    p2 = unproject_ndc_points(cams, torch.cat([xy, 2 * ones], -1)).numpy()
    dirs = (p2 - p1)[:, 0, :]

    A = np.zeros((3 * n, n + 3))
    b = np.zeros((3 * n,))
    for i in range(n):
        A[3 * i:3 * i + 3, :3] = np.eye(3)
        A[3 * i:3 * i + 3, i + 3] = -dirs[i]
        b[3 * i:3 * i + 3] = centers[i]
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    return x[:3].astype(np.float32)


def get_interpolated_path(cams: Cameras, n: int = 50, method: str = "circle",
                          theta_offset_max: float = 0.0,
                          rng: np.random.RandomState | None = None
                          ) -> Cameras:
    """Fit a circle to the camera centers and return n orbit cameras on
    the device of ``cams``; ``rng`` draws the optional angle jitter."""
    if method != "circle":
        raise NotImplementedError(method)
    if rng is None:
        rng = np.random.RandomState(0)
    device = cams.device
    cams = cams.to("cpu")

    P = camera_centers(cams).numpy().astype(np.float64)
    P_mean = P.mean(axis=0)
    P_centered = P - P_mean
    _, _, Vt = np.linalg.svd(P_centered, full_matrices=False)
    normal = Vt[2, :]
    if np.linalg.norm(normal * 2 - P_mean) < np.linalg.norm(normal - P_mean):
        normal = -normal

    P_xy = rodrigues_rot(P_centered, normal, np.array([0.0, 0.0, 1.0]))
    xc, yc, r = fit_circle_2d(P_xy[:, 0], P_xy[:, 1])
    C = rodrigues_rot(np.array([xc, yc, 0.0]), np.array([0.0, 0.0, 1.0]),
                      normal)[0] + P_mean

    t = np.linspace(0, 2 * math.pi, n)
    u = P[0] - C
    new_centers = generate_circle_points(t, C, r, normal, u)

    if theta_offset_max > 0.0:
        aug = rng.rand(new_centers.shape[0]) * 2 * theta_offset_max \
            - theta_offset_max
        new_centers = rodrigues_rot_per_point(new_centers, normal, aug)

    look_at = get_nearest_centroid(cams)
    up = -normal
    R, T = look_at_view_transform(
        new_centers.astype(np.float32), look_at[None].astype(np.float32),
        up[None].astype(np.float32))

    c = cams.principal_point.numpy().mean(axis=0, keepdims=True)
    f = cams.focal_length.numpy().mean(axis=0, keepdims=True)
    image_size = cams.image_size.numpy()[:1]
    return Cameras.create(
        R=R, T=T,
        focal_length=np.broadcast_to(f, (n, 2)),
        principal_point=np.broadcast_to(c, (n, 2)),
        image_size=np.broadcast_to(image_size, (n, 2)),
        device=device,
    )


def get_angles(target_cam: Cameras, context_cams: Cameras,
               centroid: np.ndarray) -> np.ndarray:
    """Angles (degrees) between the target camera and each context camera
    about ``centroid``, numpy."""
    a = camera_centers(target_cam).detach().cpu().numpy() - centroid[None]
    b = camera_centers(context_cams).detach().cpu().numpy() - centroid[None]
    a = np.broadcast_to(a, b.shape)
    cos = np.sum(a * b, axis=-1) / (
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))
