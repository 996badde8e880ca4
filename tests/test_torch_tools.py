"""The port's fixture and sweep tools (``sparsefusion_tpu_torch/tools/
{make_toy_fixture,parity_sweep}.py``) vs the JAX package's ``tools/``.

The fixture: the same keys and shapes as the JAX tool's at 32 px; the
cameras to 1e-5 and the rendered images and masks to 1e-4 (the two
renderers' exp differs by an ulp, as in ``test_torch_distill.py``);
each package's loader reads the other's pickle.  The sweep, on the CPU
at 32 px with the narrow UNet / VAE: 2 iterations, NGP-only and with
the diffusion arm; both outputs written, and each row's metrics equal
to a direct ``distillation_loop`` call on the same seed and views.
"""
import json
import sys

import numpy as np
import pytest
import torch

from sparsefusion_tpu.data.co3d_toy import CO3DToyDataset as JCO3DToyDataset
from sparsefusion_tpu_torch import models as tmodels
from sparsefusion_tpu_torch.cli.demo import select_input_views
from sparsefusion_tpu_torch.data.co3d_toy import CO3DToyDataset
from sparsefusion_tpu_torch.distill.loop import (
    DistillConfig,
    distillation_loop,
)
from sparsefusion_tpu_torch.tools import make_toy_fixture, parity_sweep

torch.set_num_threads(2)

FIXTURE = ["--categories", "hydrant", "teddybear", "--scenes", "2",
           "--views", "4", "--size", "32"]


def _jax_fixture(root, monkeypatch):
    from tools.make_toy_fixture import main

    monkeypatch.setattr(sys, "argv", ["make_toy_fixture", "--root",
                                      str(root), *FIXTURE])
    main()


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def test_fixture_matches_the_jax_tool(tmp_path, monkeypatch):
    paths = make_toy_fixture.main(["--root", str(tmp_path / "t"),
                                   *FIXTURE, "--device", "cpu"])
    _jax_fixture(tmp_path / "j", monkeypatch)
    assert len(paths) == 2
    for cat in ("hydrant", "teddybear"):
        rel = f"{cat}/{cat}_toy.pt"
        t, j = _load(tmp_path / "t" / rel), _load(tmp_path / "j" / rel)
        assert set(t) == set(j) == {cat} and len(t[cat]) == len(j[cat]) == 2
        for ts, js in zip(t[cat], j[cat]):
            assert set(ts) == set(js)
            for k in ts:
                assert isinstance(ts[k], torch.Tensor)
                assert ts[k].shape == js[k].shape, k
                assert ts[k].dtype == js[k].dtype, k
                tol = 1e-4 if k in ("images", "masks") else 1e-5
                np.testing.assert_allclose(ts[k].numpy(), js[k].numpy(),
                                           rtol=0, atol=tol, err_msg=k)
        # each package's loader reads the other's pickle
        for root, loader in ((tmp_path / "t", JCO3DToyDataset),
                             (tmp_path / "j", CO3DToyDataset)):
            ds = loader(str(root), cat)
            assert len(ds) == 2
            assert ds[1].images.shape == (4, 32, 32, 3)
            assert ds[1].masks is not None


def test_fixture_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_toy_fixture.main(["--root", "/nonexistent", "--scenes", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity_sweep.main(["--root", "/nonexistent"])


def _narrow_build(monkeypatch):
    real = tmodels.build_models

    def build(generator, device=None, **kw):
        return real(generator, device, **tmodels.narrow_model_configs())

    monkeypatch.setattr(tmodels, "build_models", build)
    return build


@pytest.mark.parametrize("diffusion", [False, True],
                         ids=["ngp_only", "diffusion"])
def test_sweep_rows_equal_direct_loop_calls(tmp_path, monkeypatch,
                                            diffusion):
    root = tmp_path / "fixture"
    make_toy_fixture.main(["--root", str(root), "--categories", "hydrant",
                           "--scenes", "1", "--views", "4", "--size", "32",
                           "--device", "cpu"])
    build = _narrow_build(monkeypatch)
    out = tmp_path / "sweep"
    argv = ["--root", str(root), "--categories", "hydrant", "missing",
            "--views", "2", "--scenes", "0", "3", "--max_itr", "2",
            "--out", str(out), "--device", "cpu"]
    if not diffusion:
        argv += ["--no_diffusion"]
    rows = parity_sweep.main(argv)

    assert [(r["category"], r["scene"], r["views"]) for r in rows] == \
        [("hydrant", 0, 2)]
    assert json.loads((out / "parity_sweep.json").read_text()) == rows
    table = (out / "parity_sweep.md").read_text().splitlines()
    assert table[0] == "| category | scene | views | psnr | ssim |"
    assert len(table) == 2 + len(rows)
    assert table[2].startswith("| hydrant | 0 | 2 | ")

    models = None
    if diffusion:
        models = build(torch.Generator().manual_seed(0), "cpu")
    for row in rows:
        scene = CO3DToyDataset(str(root), "hydrant")[0]
        idx = select_input_views(0, 0, len(scene), row["views"])
        res = distillation_loop(
            models, scene, idx, DistillConfig(max_itr=2),
            torch.Generator().manual_seed(0), use_diffusion=diffusion,
            verbose=False)
        assert {k: row[k] for k in res["metrics"]} == res["metrics"]
        assert np.isfinite(row["psnr"])
