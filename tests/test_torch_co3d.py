"""The port's CO3Dv2 reader against the JAX package's, on the on-disk
fixture of ``tests/test_co3d_loader.py``: the bbox helpers, the top-left
resize, the camera conversion, whole scenes at the train and test stages,
and ``-d co3d`` in the demo's (and train CLI's) ``load_dataset``.  The
resizes are the same f32 expressions in torch and in JAX: 1e-6."""
import argparse
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from sparsefusion_tpu.cli.demo import load_dataset as jload_dataset
from sparsefusion_tpu.data import co3d as jco3d
from sparsefusion_tpu_torch.cli.demo import load_dataset
from sparsefusion_tpu_torch.data import co3d
from tests.test_co3d_loader import write_fixture

torch.set_num_threads(2)


def test_bbox_helpers_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        mask = (rng.rand(23, 31) > 0.7).astype(np.float32) * rng.rand(23, 31)
        for thr in (0.4, 0.95):
            got = co3d.get_bbox_from_mask(mask, thr)
            np.testing.assert_array_equal(
                got, jco3d.get_bbox_from_mask(mask, thr))
            for ctx in (0.0, 0.3):
                xyxy = co3d.get_clamp_bbox_xyxy(got, ctx)
                np.testing.assert_array_equal(
                    xyxy, jco3d.get_clamp_bbox_xyxy(got, ctx))
                box = co3d.clamp_bbox_to_image(xyxy, mask.shape)
                np.testing.assert_array_equal(
                    box, jco3d.clamp_bbox_to_image(xyxy, mask.shape))
                np.testing.assert_array_equal(
                    co3d.crop_around_box(mask[None], box),
                    jco3d.crop_around_box(mask[None], box))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("hw", [(37, 61), (64, 20), (64, 64)])
def test_resize_topleft_matches_jax(hw, mode):
    img = np.random.RandomState(1).rand(3, *hw).astype(np.float32)
    got = co3d.resize_topleft(img, (64, 64), mode)
    want = jco3d.resize_topleft(img, (64, 64), mode)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("fmt", ["ndc_norm_image_bounds", "ndc_isotropic"])
def test_camera_conversion_matches_jax(fmt):
    vp = {"R": np.eye(3).tolist(), "T": [0.1, -0.2, 3.0],
          "focal_length": [2.0, 2.5], "principal_point": [0.1, -0.2],
          "intrinsics_format": fmt}
    crop = np.array([10.0, 4.0, 60.0, 50.0], np.float32)
    got = co3d.co3d_camera_to_ndc(vp, (60, 80), crop, 1.3, (64, 64))
    want = jco3d.co3d_camera_to_ndc(vp, (60, 80), crop, 1.3, (64, 64))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stage", ["train", "test"])
def test_dataset_matches_jax(tmp_path, stage):
    write_fixture(str(tmp_path))
    kw = dict(subset="fewview_train", stage=stage, sample_batch_size=5,
              image_size=64)
    got = co3d.CO3Dv2Dataset(str(tmp_path), "hydrant", **kw)
    want = jco3d.CO3Dv2Dataset(str(tmp_path), "hydrant", **kw)
    assert got.seq_list == want.seq_list and len(got) == 2
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a.sequence_name == b.sequence_name
        for field in dataclasses.fields(b):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if isinstance(y, np.ndarray):
                np.testing.assert_allclose(x, y, atol=1e-6, rtol=0,
                                           err_msg=field.name)


def test_demo_reads_co3d_like_jax(tmp_path):
    """``-d co3d``: subset ``fewview_dev`` at stage ``test``, as the JAX
    package's demo and train CLI read it."""
    write_fixture(str(tmp_path))
    lists = tmp_path / "hydrant" / "set_lists"
    shutil.copy(lists / "set_lists_fewview_train.json",
                lists / "set_lists_fewview_dev.json")
    args = argparse.Namespace(dataset_name="co3d", root=str(tmp_path),
                              category="hydrant", image_size=32)
    got = load_dataset(args, "cpu")
    want = jload_dataset(args)
    assert isinstance(got, co3d.CO3Dv2Dataset)
    assert (got.subset, got.stage) == ("fewview_dev", "test")
    assert got.seq_list == want.seq_list
    np.testing.assert_allclose(got[1].images, want[1].images, atol=1e-6)
