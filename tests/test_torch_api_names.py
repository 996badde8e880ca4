"""Every public top-level name of the JAX package has its counterpart in
the port, or stands on the list of names without one, with the reason.

The names are read from the JAX package's sources with ``ast`` (no
import of JAX for that part): each module's top-level functions, classes
and assignments that do not start with an underscore.  A counterpart is
the same name in the port's module of the same path, or the port name
``RENAMED`` gives.  Then a parity case, JAX against the port on the same
numpy inputs, for each name that the port's last modules added (f32,
1e-5 unless stated).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.core import harmonics as jharm
from sparsefusion_tpu.core import paths as jpaths
from sparsefusion_tpu.core import rays as jrays
from sparsefusion_tpu.diffusion import ddpm as jddpm
from sparsefusion_tpu.diffusion import plms as jplms
from sparsefusion_tpu.nn import unet as junet
from sparsefusion_tpu.ops.grid_encode import init_grid_params as j_init_grid
from sparsefusion_tpu.ops.grid_encode import make_grid_encoding as j_make_enc
from sparsefusion_tpu.utils import image as jimage
from sparsefusion_tpu.utils import metrics as jmetrics
from sparsefusion_tpu_torch import models as tmodels
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.core import harmonics as tharm
from sparsefusion_tpu_torch.core import paths as tpaths
from sparsefusion_tpu_torch.core import rays as trays
from sparsefusion_tpu_torch.diffusion import ddpm as tddpm
from sparsefusion_tpu_torch.diffusion import plms as tplms
from sparsefusion_tpu_torch.nn import unet as tunet
from sparsefusion_tpu_torch.ops.grid_encode import init_grid_params
from sparsefusion_tpu_torch.ops.grid_encode import make_grid_encoding
from sparsefusion_tpu_torch.utils import image as timage
from sparsefusion_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "sparsefusion_tpu", ROOT / "sparsefusion_tpu_torch"

# JAX name -> "port module path:port name", where the port's name differs
RENAMED = {
    ("kernels/attention.py", "reference_attention"):
        "ops/attention.py:imagen_attention_plain",
    ("nn/layers.py", "ChanFeedForward"): "nn/layers.py:chan_feed_forward",
    ("nn/layers.py", "Downsample"): "nn/layers.py:downsample",
    ("nn/layers.py", "pixel_shuffle"): "nn/layers.py:PixelShuffleUpsample",
    ("nn/vae.py", "VAEResnetBlock"): "nn/vae.py:ResnetBlock",
    ("nn/vae.py", "VAEAttnBlock"): "nn/vae.py:AttnBlock",
    ("train/trainer.py", "TrainState"): "train/trainer.py:TrainStep",
    ("train/trainer.py", "init_train_state"):
        "train/trainer.py:make_optimizers",
    ("train/trainer.py", "zero_if_not_finite"):
        "train/trainer.py:GuardedAdam",
    ("train/trainer.py", "ZeroIfNotFiniteState"):
        "train/trainer.py:notfinite_count",
    # the host loop whose step 0 and scan tail the fused loop's step-0 and
    # tail graphs are (distill/fused.py); with scan_tail or without, the
    # same numbers as the port's sampler
    ("diffusion/plms.py", "plms_sample_host"): "diffusion/plms.py:plms_sample",
}

# (JAX module, name or "*" for the whole module) -> why the port has none
NO_COUNTERPART = {
    ("utils/runtime.py", "*"):
        "XLA's persistent compilation cache; the port compiles nothing at "
        "run time but its kernels, built once into build/",
    ("ops/grid_encode_blocked.py", "*"):
        "the TPU's blocked table layout; K1 reads the master table",
    ("kernels/grid_gather.py", "*"):
        "the Pallas row gather inside the XLA encode, whose job K1 "
        "(csrc/grid_encode.cu) does fused",
    ("train/convert.py", "*"):
        "reference checkpoints to Flax trees; the port loads reference "
        "state dicts as they are, and its tests use the JAX converters",
    ("parallel/mesh.py", "make_mesh"): "XLA device meshes",
    ("parallel/mesh.py", "shard_batch"): "XLA batch sharding",
    ("parallel/mesh.py", "replicate_to_mesh"): "XLA replication",
    ("parallel/mesh.py", "batch_sharding"): "an XLA sharding spec",
    ("parallel/mesh.py", "replicated_sharding"): "an XLA sharding spec",
    ("nn/vae.py", "swish"): "torch's F.silu",
    ("nn/lpips.py", "convert_lpips_weights"):
        "torch state dicts to a Flax .npz; the port loads the state dicts",
    ("tools/convert_weights.py", "*"):
        "reference checkpoints to Flax .npz trees; the port loads the "
        "torch checkpoints as they are",
}


def _public_names(path: pathlib.Path):
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _jax_modules():
    """(path relative to the port's package root, JAX source): the JAX
    package's modules and the repository's ``tools/``."""
    for p in sorted(JAX_PKG.rglob("*.py")):
        yield p.relative_to(JAX_PKG).as_posix(), p
    for p in sorted((ROOT / "tools").glob("*.py")):
        yield f"tools/{p.name}", p


def test_every_public_jax_name_has_a_counterpart_or_a_reason():
    port_names, missing, counted = {}, [], 0
    for rel, path in _jax_modules():
        for name in _public_names(path):
            counted += 1
            if (rel, "*") in NO_COUNTERPART or (rel, name) in NO_COUNTERPART:
                continue
            target = RENAMED.get((rel, name), f"{rel}:{name}")
            mod, tname = target.split(":")
            if mod not in port_names:
                port_file = PORT_PKG / mod
                port_names[mod] = (set(_public_names(port_file))
                                   if port_file.exists() else set())
            if tname not in port_names[mod]:
                missing.append(f"{rel}:{name} -> {target}")
    assert counted > 200
    assert not missing, missing


def test_the_lists_name_only_real_jax_names():
    """No stale entry: every listed name still exists in the JAX package,
    every renamed target in the port, and every reason is given."""
    jax_names = {rel: set(_public_names(p)) for rel, p in _jax_modules()}
    for (rel, name), why in NO_COUNTERPART.items():
        assert rel in jax_names and why
        assert name == "*" or name in jax_names[rel], (rel, name)
        if name == "*":
            assert not (PORT_PKG / rel).exists(), rel
    for (rel, name), target in RENAMED.items():
        assert name in jax_names[rel], (rel, name)
        mod, tname = target.split(":")
        assert tname in _public_names(PORT_PKG / mod), target


# ---- parity of the names the last slice added -----------------------------

def _close(got, want, tol=1e-5):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _cameras(n=4, seed=0):
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False) + rng.uniform(-.1, .1, n)
    eye = np.stack([3 * np.cos(t), 0.8 + rng.uniform(-.2, .2, n),
                    3 * np.sin(t)], 1).astype(np.float32)
    R, T = jcam.look_at_view_transform(eye, np.zeros((1, 3), np.float32),
                                       np.array([[0, 1, 0]], np.float32))
    arrs = (np.asarray(R), np.asarray(T),
            (2.5 + rng.rand(n, 2)).astype(np.float32),
            (rng.rand(n, 2) * 0.1).astype(np.float32),
            np.tile([[24.0, 32.0]], (n, 1)).astype(np.float32))
    return jcam.Cameras.create(*arrs), tcam.Cameras.create(*arrs)


def _bundles_close(got, want):
    for f in ("origins", "directions", "lengths", "xys"):
        _close(getattr(got, f), getattr(want, f))


def test_grid_raysampler_and_ray_points_match_jax():
    jc, tc = _cameras()
    kw = dict(min_x=0.9, max_x=-0.9, min_y=0.8, max_y=-0.8, image_height=5,
              image_width=7, n_pts_per_ray=6, min_depth=1.0, max_depth=4.0)
    jb, tb = jrays.GridRaysampler(**kw)(jc), trays.GridRaysampler(**kw)(tc)
    _bundles_close(tb, jb)
    _close(trays.ray_points(tb), jrays.ray_points(jb))
    assert trays.ray_points(tb).shape == (4, 5, 7, 6, 3)


@pytest.mark.parametrize("bbox", [None, [[-0.5, -0.6, 0.4, 0.7]]])
def test_monte_carlo_rays_match_jax_on_its_draws(bbox):
    jc, tc = _cameras(seed=1)
    key = jax.random.PRNGKey(3)
    jb = jrays.monte_carlo_ray_bundle(jc, key, 9, 5, 0.5, 3.0, bbox=bbox)
    tb = trays.monte_carlo_ray_bundle(
        tc, None, 9, 5, 0.5, 3.0, bbox=bbox,
        xys=torch.from_numpy(np.array(jb.xys)))
    _bundles_close(tb, jb)
    # the sampler's own draws: from the generator, inside the bounds
    g = torch.Generator().manual_seed(0)
    own = trays.monte_carlo_ray_bundle(tc, g, 9, 5, 0.5, 3.0, bbox=bbox)
    again = trays.monte_carlo_ray_bundle(
        tc, torch.Generator().manual_seed(0), 9, 5, 0.5, 3.0, bbox=bbox)
    assert torch.equal(own.xys, again.xys) and own.xys.shape == (4, 9, 2)
    if bbox is None:
        assert own.xys.abs().max() <= 1.0
    else:
        b = bbox[0]
        assert own.xys[..., 0].min() >= min(-b[1], -b[3])
        assert own.xys[..., 0].max() <= max(-b[1], -b[3])
        assert own.xys[..., 1].min() >= min(-b[0], -b[2])
        assert own.xys[..., 1].max() <= max(-b[0], -b[2])


@pytest.mark.parametrize("append_input", [True, False])
def test_harmonic_embedding_matches_jax(append_input):
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    freqs = jharm.harmonic_frequencies(4, 0.5)
    _close(tharm.harmonic_embedding(torch.from_numpy(x), freqs,
                                    append_input),
           jharm.harmonic_embedding(jnp.asarray(x), freqs, append_input))


def test_get_angles_matches_jax():
    jc, tc = _cameras(n=5, seed=2)
    centroid = np.array([0.1, -0.2, 0.05])
    want = jpaths.get_angles(jcam.get_camera_slice(jc, [0]), jc, centroid)
    got = tpaths.get_angles(tcam.get_camera_slice(tc, [0]), tc, centroid)
    assert got.shape == (5,) and abs(got[0]) < 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_image_helpers_match_jax():
    x = np.random.RandomState(0).uniform(-0.5, 1.5, (2, 4, 5, 3)).astype(
        np.float32)
    t = torch.from_numpy(x)
    _close(timage.normalize(t), jimage.normalize(x))
    _close(timage.unnormalize(t), jimage.unnormalize(x))
    chw = timage.hwc_to_chw(t)
    assert chw.shape == (2, 3, 4, 5)
    _close(chw, jimage.hwc_to_chw(x), 0)
    _close(timage.chw_to_hwc(chw), jimage.chw_to_hwc(jimage.hwc_to_chw(x)), 0)


def test_get_metrics_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.rand(16, 16, 3).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(16, 16, 3), 0, 1).astype(np.float32)

    def lp(x, y):
        return np.abs(x - y).mean()

    assert tmetrics.get_metrics(a, b) == jmetrics.get_metrics(a, b)
    assert tmetrics.get_metrics(a, b, lp) == jmetrics.get_metrics(a, b, lp)


def test_count_params_matches_jax():
    from sparsefusion_tpu.models import count_params as jcount
    from sparsefusion_tpu_torch.nn.ngp import (
        NGPConfig,
        NGPField,
        export_jax_params,
    )

    field = NGPField(NGPConfig(num_levels=3, log2_hashmap_size=10))
    tree = export_jax_params(field)
    assert tmodels.count_params(field) == tmodels.count_params(tree) \
        == jcount(tree) == sum(p.numel() for p in field.parameters())


def test_sparsefusion_unet_config_matches_jax():
    import dataclasses

    got = dataclasses.asdict(tunet.sparsefusion_unet_config())
    want = dataclasses.asdict(junet.sparsefusion_unet_config())
    assert got == want


def test_make_denoise_fn_matches_jax():
    from sparsefusion_tpu.train.convert import convert_unet_state_dict

    tiny = dict(dim=32, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
                layer_attns=(False, True), layer_cross_attns=(False, False),
                cond_images_channels=16, attn_heads=2, attn_dim_head=8)
    g = torch.Generator().manual_seed(0)
    tm = tunet.EfficientUNet(tunet.UNetConfig(**tiny)).init_weights_(g)
    with torch.no_grad():
        tm.final_conv.weight.normal_(0.0, 0.1, generator=g)
    params = convert_unet_state_dict(
        {f"unets.0.{k}": v for k, v in tm.eval().state_dict().items()},
        num_levels=2, num_resnet_blocks=tiny["num_resnet_blocks"],
        layer_attns=tiny["layer_attns"])
    jfn = jax.jit(junet.make_denoise_fn(
        junet.EfficientUNet(junet.UNetConfig(**tiny)), params))
    tfn = tunet.make_denoise_fn(tm)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    cond = rng.randn(2, 8, 8, 16).astype(np.float32)
    log_snr = np.array([0.5, -1.0], np.float32)
    keep = np.array([True, False])
    want = np.asarray(jfn(x, log_snr, cond, keep))
    with torch.no_grad():
        got = tfn(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(log_snr),
                  torch.from_numpy(cond).permute(0, 3, 1, 2),
                  torch.from_numpy(keep)).permute(0, 2, 3, 1)
    assert np.abs(want).max() > 0.1
    # one UNet evaluation, as tests/test_torch_unet.py holds it
    _close(got, want, 5e-5)


def test_init_grid_params_matches_jax_distribution():
    """jax.random cannot be replayed in torch: the same shape, type and
    range, the draws reproducible from the generator, and the moments of
    U(-std, std) within 5 standard errors of the JAX draws'."""
    enc_kw = dict(num_levels=4, log2_hashmap_size=12, gridtype="tiled")
    jenc, tenc = j_make_enc(**enc_kw), make_grid_encoding(**enc_kw)
    want = np.asarray(j_init_grid(jax.random.PRNGKey(0), jenc))
    got = init_grid_params(torch.Generator().manual_seed(0), tenc)
    again = init_grid_params(torch.Generator().manual_seed(0), tenc)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert got.abs().max() <= 1e-4
    n, sd = got.numel(), 1e-4 / np.sqrt(3)
    for stat, se in ((lambda a: a.mean(), sd / np.sqrt(n)),
                     (lambda a: a.std(), sd / np.sqrt(2 * n))):
        assert abs(float(stat(got.numpy())) - float(stat(want))) < 5 * se


def _toy_denoise(layout):
    def fn(x, log_snr, cond, keep):
        shape = (-1, 1, 1, 1)
        ls = log_snr.reshape(shape)
        return 0.3 * x + 0.1 * cond[..., :4] + 0.02 * ls if layout == "nhwc" \
            else 0.3 * x + 0.1 * cond[:, :4] + 0.02 * ls
    return fn


@pytest.mark.parametrize("max_thres", [0.3, 0.995])
def test_plms_sampler_matches_jax(max_thres):
    rng = np.random.RandomState(5)
    image = rng.randn(2, 4, 4, 4).astype(np.float32)
    cond = rng.randn(2, 4, 4, 4).astype(np.float32)
    key = jax.random.PRNGKey(7)
    steps = 4
    jd = jddpm.DDPM(jddpm.DDPMConfig(timesteps=100))
    want = jplms.PLMSSampler(jd, steps).sample(
        _toy_denoise("nhwc"), key, jnp.asarray(image), max_thres,
        jnp.asarray(cond), return_noise=True)
    # the JAX sampler's normal draws along its key tree
    _, n_steps, _ = tplms.host_schedule(max_thres, steps)
    k_init, k = jax.random.split(key)
    draws = [jax.random.normal(k_init, image.shape)]
    k, sub = jax.random.split(k)
    k1, k2, _ = jax.random.split(sub, 3)
    draws += [jax.random.normal(k1, image.shape),
              jax.random.normal(k2, image.shape)]
    for _ in range(1, n_steps):
        k1, k = jax.random.split(k)
        draws.append(jax.random.normal(k1, image.shape))

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(a), (0, 3, 1, 2))))

    sampler = tplms.PLMSSampler(tddpm.DDPM(tddpm.DDPMConfig(timesteps=100)),
                                steps)
    got = sampler.sample(_toy_denoise("nchw"), nchw(image), max_thres,
                         nchw(cond), return_noise=True,
                         noises=[nchw(d) for d in draws])
    for g_, w_ in zip(got[:3], want[:3]):
        _close(g_.permute(0, 2, 3, 1), w_, 1e-4)
    _close(got[3], want[3], 1e-6)
    only = sampler.sample(_toy_denoise("nchw"), nchw(image), max_thres,
                          nchw(cond), noises=[nchw(d) for d in draws])
    assert torch.equal(only, got[0])
