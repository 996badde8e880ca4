"""The training visualization grid of the port against the JAX package's:
[context 1 | context 2 | ground truth | EFT render | diffusion sample] at
64 px with the narrow UNet and VAE and the full-width EFT.

Both run the same weights (the JAX side through the JAX package's
converters) and the same 64-step ancestral chain: the test replays the
JAX chain's normal draws (``k_init, k_loop = split(rng)``, then one split
of the loop key per step) into the port.  The EFT panel is the same
light-field render and bilinear upsample in f32: 1e-5.  The sample panel
goes through 64 UNet evaluations and the VAE decoder, each step's sums in
another order: 1e-3.
"""
import jax
import numpy as np
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.data.synthetic import make_synthetic_scene
from sparsefusion_tpu.train.visualize import (
    save_visualization as jax_save_visualization,
)
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.train.trainer import scene_depth_range_from_cam
from sparsefusion_tpu_torch.train.visualize import save_visualization
from tests.test_torch_train_step import _jax_models, _port_models

torch.set_num_threads(2)

LATENT, STEPS = 8, 64


def _chain_noises(key):
    k_init, k_loop = jax.random.split(key)
    draws = [jax.random.normal(k_init, (1, LATENT, LATENT, 4))]
    for _ in range(STEPS):
        k_loop, sub = jax.random.split(k_loop)
        draws.append(jax.random.normal(sub, (1, LATENT, LATENT, 4)))
    return [torch.tensor(np.ascontiguousarray(
        np.transpose(np.asarray(d), (0, 3, 1, 2)))) for d in draws]


def test_grid_matches_jax(tmp_path):
    scene = make_synthetic_scene(n_views=4, image_size=64, seed=2)
    query, ctx = 0, [1, 3]
    models = _port_models()
    jmodels = _jax_models(models)

    rel = tcam.get_relative_cameras(tcam.Cameras.create(
        scene.R, scene.T, scene.f, scene.c, scene.image_size), [query])
    near, far = scene_depth_range_from_cam(rel)
    key = jax.random.PRNGKey(9)
    evals0 = models.unet_evals
    grid = save_visualization(
        models, tcam.get_camera_slice(rel, [query]),
        torch.tensor(scene.images[query]), tcam.get_camera_slice(rel, ctx),
        torch.tensor(scene.images[ctx]), near, far,
        str(tmp_path / "port.jpg"), latent_hw=LATENT,
        noises=_chain_noises(key))
    assert models.unet_evals - evals0 == STEPS

    jrel = jcam.get_relative_cameras(scene.cameras(), [query])
    want = jax_save_visualization(
        jmodels, jmodels.unet_params, jmodels.eft_vars["params"],
        jcam.get_camera_slice(jrel, [query]), scene.images[query],
        jcam.get_camera_slice(jrel, ctx), scene.images[ctx], near, far,
        str(tmp_path / "jax.jpg"), key, latent_hw=LATENT)

    assert grid.shape == (64, 5 * 64, 3) and np.isfinite(grid).all()
    panels = np.split(grid, 5, axis=1)
    want_panels = np.split(np.asarray(want), 5, axis=1)
    for i in range(3):     # contexts and ground truth: the scene's images
        np.testing.assert_array_equal(panels[i], want_panels[i])
    np.testing.assert_allclose(panels[3], want_panels[3], atol=1e-5)
    np.testing.assert_allclose(panels[4], want_panels[4], atol=1e-3)
    assert (tmp_path / "port.jpg").exists()
