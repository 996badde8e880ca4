"""Port cameras, rays, paths, image ops, metrics and helpers vs the JAX
package, on the same numpy inputs.  f32 tolerance 1e-5 unless stated."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.core import paths as jpaths
from sparsefusion_tpu.core import rays as jrays
from sparsefusion_tpu.data.contract import SceneData as JSceneData
from sparsefusion_tpu.ops import image as jimg
from sparsefusion_tpu.utils import image as jutil
from sparsefusion_tpu.utils import metrics as jmetrics
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.core import paths as tpaths
from sparsefusion_tpu_torch.core import rays as trays
from sparsefusion_tpu_torch.data.contract import SceneData
from sparsefusion_tpu_torch.ops import image as timg
from sparsefusion_tpu_torch.utils import image as tutil
from sparsefusion_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _cam_arrays(n=5, seed=0):
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False) + rng.uniform(-.1, .1, n)
    eye = np.stack([3 * np.cos(t), 0.8 + rng.uniform(-.2, .2, n),
                    3 * np.sin(t)], 1).astype(np.float32)
    R, T = jcam.look_at_view_transform(eye, np.zeros((1, 3), np.float32),
                                       np.array([[0, 1, 0]], np.float32))
    f = (2.5 + rng.rand(n, 2)).astype(np.float32)
    c = (rng.rand(n, 2) * 0.1).astype(np.float32)
    size = np.tile([[48.0, 64.0]], (n, 1)).astype(np.float32)
    return np.asarray(R), np.asarray(T), f, c, size


def _both(seed=0):
    arrs = _cam_arrays(seed=seed)
    return jcam.Cameras.create(*arrs), tcam.Cameras.create(*arrs)


def test_look_at_view_transform_matches_jax():
    rng = np.random.RandomState(1)
    eye = rng.randn(6, 3).astype(np.float32) * 3
    at = rng.randn(1, 3).astype(np.float32) * 0.1
    up = np.array([[0, 1, 0]], np.float32)
    eye[0] = at[0] + np.array([0, 2, 0], np.float32)   # up || view axis
    Rj, Tj = jcam.look_at_view_transform(eye, at, up)
    Rt, Tt = tcam.look_at_view_transform(eye, at, up)
    _close(Rt, Rj)
    _close(Tt, Tj)


def test_camera_transforms_match_jax():
    cj, ct = _both()
    rng = np.random.RandomState(2)
    pts = rng.randn(7, 3).astype(np.float32)
    _close(tcam.camera_centers(ct), jcam.camera_centers(cj))
    _close(tcam.view_to_world(ct, torch.tensor(pts)),
           jcam.view_to_world(cj, jnp.asarray(pts)), tol=1e-4)
    xyd = rng.randn(5, 7, 3).astype(np.float32)
    _close(tcam.unproject_ndc_points(ct, torch.tensor(xyd)),
           jcam.unproject_ndc_points(cj, jnp.asarray(xyd)), tol=1e-4)


@pytest.mark.parametrize("center", [False, True])
def test_relative_slice_concat_match_jax(center):
    cj, ct = _both()
    rj = jcam.get_relative_cameras(cj, [2], center_at_origin=center)
    rt = tcam.get_relative_cameras(ct, [2], center_at_origin=center)
    _close(rt.R, rj.R, tol=1e-4)
    _close(rt.T, rj.T, tol=1e-4)
    sj = jcam.concat_cameras([jcam.get_camera_slice(rj, [3, 1]), rj])
    st = tcam.concat_cameras([tcam.get_camera_slice(rt, [3, 1]), rt])
    assert len(st) == len(sj) == 7
    for f in ("R", "T", "focal_length", "principal_point", "image_size"):
        _close(getattr(st, f), getattr(sj, f), tol=1e-4)


def test_grid_ray_bundle_matches_jax():
    cj, ct = _both()
    bj = jrays.grid_ray_bundle(cj, 6, 8, 4, 1.0, 3.0)
    bt = trays.grid_ray_bundle(ct, 6, 8, 4, 1.0, 3.0)
    assert bt.origins.shape == (5, 6, 8, 3)
    _close(bt.origins, bj.origins, tol=1e-4)
    _close(bt.directions, bj.directions, tol=1e-4)
    _close(bt.lengths, bj.lengths)
    _close(bt.xys, bj.xys)


def test_interpolated_path_matches_jax():
    cj, ct = _both(seed=3)
    pj = jpaths.get_interpolated_path(cj, n=12, theta_offset_max=0.17,
                                      rng=np.random.RandomState(0))
    pt = tpaths.get_interpolated_path(ct, n=12, theta_offset_max=0.17,
                                      rng=np.random.RandomState(0))
    assert len(pt) == 12
    for f in ("R", "T", "focal_length", "principal_point", "image_size"):
        _close(getattr(pt, f), getattr(pj, f), tol=1e-4)


@pytest.mark.parametrize("out_hw", [(5, 7), (17, 23), (12, 16)])
@pytest.mark.parametrize("align", [False, True])
def test_resize_bilinear_matches_jax(out_hw, align):
    img = np.random.RandomState(4).rand(2, 12, 16, 3).astype(np.float32)
    _close(timg.resize_bilinear(torch.tensor(img), out_hw, align),
           jimg.resize_bilinear(jnp.asarray(img), out_hw, align))


@pytest.mark.parametrize("out_hw", [(5, 7), (24, 40)])
def test_resize_nearest_matches_jax_and_torch(out_hw):
    img = np.random.RandomState(5).rand(2, 12, 16, 3).astype(np.float32)
    got = timg.resize_nearest(torch.tensor(img), out_hw)
    _close(got, jimg.resize_nearest(jnp.asarray(img), out_hw))
    ref = torch.nn.functional.interpolate(
        torch.tensor(img).permute(0, 3, 1, 2), size=out_hw, mode="nearest")
    _close(got, ref.permute(0, 2, 3, 1))


@pytest.mark.parametrize("align", [False, True])
def test_grid_sample_bilinear_matches_jax(align):
    rng = np.random.RandomState(6)
    img = rng.rand(2, 9, 11, 4).astype(np.float32)
    coords = (rng.rand(2, 30, 2) * 2.4 - 1.2).astype(np.float32)
    _close(timg.grid_sample_bilinear(torch.tensor(img), torch.tensor(coords),
                                     align),
           jimg.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(coords),
                                     align))


def test_psnr_ssim_match_jax():
    rng = np.random.RandomState(7)
    gt = rng.rand(24, 20, 3).astype(np.float32)
    pred = np.clip(gt + rng.randn(24, 20, 3).astype(np.float32) * 0.05, 0, 1)
    assert tmetrics.psnr(pred, gt) == pytest.approx(jmetrics.psnr(pred, gt),
                                                    rel=1e-12)
    assert tmetrics.ssim(pred, gt) == pytest.approx(jmetrics.ssim(pred, gt),
                                                    rel=1e-12)
    assert tmetrics.psnr(gt, gt) == float("inf")


def test_helpers_match_jax():
    rng = np.random.RandomState(8)
    x, y = rng.rand(2, 50).astype(np.float32)
    _close(tutil.huber(torch.tensor(x), torch.tensor(y)),
           jutil.huber(jnp.asarray(x), jnp.asarray(y)))
    for n in (1, 3, 7):
        assert tutil.split_list(list(range(10)), n) == \
            jutil.split_list(list(range(10)), n)
    np.testing.assert_array_equal(tutil.to_uint8(torch.tensor(x) * 1.2 - .1),
                                  jutil.to_uint8(x * 1.2 - .1))


def test_scene_contract_round_trip_matches_jax():
    R, T, f, c, size = _cam_arrays()
    rng = np.random.RandomState(9)
    d = {"images": rng.rand(5, 3, 48, 64).astype(np.float32), "R": R,
         "T": T, "f": f, "c": c, "image_size": size,
         "masks": rng.rand(5, 1, 48, 64).astype(np.float32)}
    st = SceneData.from_reference_dict(d, "s")
    sj = JSceneData.from_reference_dict(d, "s")
    assert len(st) == 5 and st.images.shape == (5, 48, 64, 3)
    for k, v in st.to_reference_dict().items():
        np.testing.assert_array_equal(v, sj.to_reference_dict()[k])
    _close(st.cameras().R, sj.cameras().R)
