"""Ray depths from 0-d tensors (the train step's depth range, computed on
the device) against the same depths as host floats through
``torch.linspace``.

Tolerance: one ulp of the larger end's magnitude, not bit-equality:
``torch.linspace``'s vectorised CPU loop rounds its points in another
order than the per-point formula the tensor form uses.  The origins and
directions do not depend on the depths and stay bit-equal.
"""
import numpy as np
import pytest
import torch

from sparsefusion_tpu_torch.core.cameras import (
    Cameras,
    look_at_view_transform,
)
from sparsefusion_tpu_torch.core.rays import depth_linspace, grid_ray_bundle
from sparsefusion_tpu_torch.train.trainer import (
    scene_depth_range,
    scene_depth_range_from_cam,
)


def _ulp(lo, hi):
    return float(np.spacing(np.float32(max(abs(lo), abs(hi)))))


@pytest.mark.parametrize("n", [1, 2, 7, 20, 64])
def test_tensor_depths_within_one_ulp_of_linspace(n):
    rng = np.random.RandomState(n)
    for _ in range(200):
        dist = np.float32(rng.uniform(0.5, 30.0))
        lo, hi = float(np.float32(dist - 5)), float(np.float32(dist + 5))
        want = torch.linspace(lo, hi, n)
        got = depth_linspace(torch.tensor(lo), torch.tensor(hi), n)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert (got - want).abs().max().item() <= _ulp(lo, hi)
        assert got[0].item() == lo and (n == 1 or got[-1].item() == hi)


def _cameras():
    eye = np.array([[4.0, 1.0, 2.0], [-3.0, 2.0, 5.0], [1.0, -4.0, 3.0]],
                   np.float32)
    R, T = look_at_view_transform(eye, np.zeros_like(eye),
                                  np.array([[0.0, 1.0, 0.0]] * 3, np.float32))
    return Cameras.create(R, T, [[2.0, 2.0]], [[0.0, 0.0]], [[64.0, 64.0]])


def test_grid_bundle_from_the_device_depth_range():
    """The train step's rays: the device range equals the host floats, and
    the bundle's lengths are within one ulp, the rest bit-equal."""
    cams = _cameras()
    near_t, far_t = scene_depth_range(cams)
    near, far = scene_depth_range_from_cam(cams)
    assert (near_t.item(), far_t.item()) == (near, far)
    want = grid_ray_bundle(cams, 8, 8, 20, near, far)
    got = grid_ray_bundle(cams, 8, 8, 20, near_t, far_t)
    assert torch.equal(got.origins, want.origins)
    assert torch.equal(got.directions, want.directions)
    assert torch.equal(got.xys, want.xys)
    assert (got.lengths - want.lengths).abs().max().item() <= _ulp(near, far)
