"""The port's VAE, ResNet trunk, EFT and light-field renderer against the
JAX package, with the same weights on both sides.

Sizes are small (a narrow VAE at 16 x 16, the full-width EFT on a few
rays of a synthetic scene).  The VAE and EFT weights are the port's,
given to the JAX modules by the JAX package's converters; the ResNet
trunk goes the other way (JAX init, ``load_flax_tree``).  Tolerances,
f32 on both sides: VAE 1e-4 absolute on O(1) outputs (measured 2.3e-6
encode, 2.4e-6 decode); ResNet trunk 1e-4 (measured 1.2e-7); EFT rgb
1e-5 and features 1e-4 on layer-normed O(1) values (measured 4.8e-7 and
3.4e-6 for a ray query, 1.7e-6 and 1.5e-5 for a light-field render);
geometry 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core import cameras as jcam
from sparsefusion_tpu.core.harmonics import HarmonicEmbedding as JHarmonic
from sparsefusion_tpu.data.synthetic import make_synthetic_scene
from sparsefusion_tpu.nn.eft import EFTConfig as JEFTConfig
from sparsefusion_tpu.nn.eft import EpipolarFeatureTransformer as JEFT
from sparsefusion_tpu.nn.resnet import ResNet18Features as JResNet
from sparsefusion_tpu.nn.vae import AutoencoderKL as JVAE
from sparsefusion_tpu.nn.vae import VAEConfig as JVAEConfig
from sparsefusion_tpu.render.lightfield import (
    render_light_field as jax_render_light_field,
)
from sparsefusion_tpu.train.convert import (
    convert_eft_state_dict,
    convert_vae_state_dict,
)
from sparsefusion_tpu_torch.core import cameras as tcam
from sparsefusion_tpu_torch.core.harmonics import HarmonicEmbedding
from sparsefusion_tpu_torch.nn import eft as teft
from sparsefusion_tpu_torch.nn import resnet as tresnet
from sparsefusion_tpu_torch.nn import vae as tvae
from sparsefusion_tpu_torch.nn.flax_layout import (
    init_like_flax_,
    load_flax_tree,
)
from sparsefusion_tpu_torch.render.lightfield import render_light_field

torch.set_num_threads(2)


def nchw(a):
    return torch.tensor(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_stats(variables, seed):
    """Non-trivial batch statistics (a fresh init has mean 0, var 1)."""
    rng = np.random.RandomState(seed)
    variables = _np(variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) * 0.5 + 0.5).astype(np.float32),
        variables["batch_stats"])
    return variables


def test_vae_encode_decode_match_jax():
    cfg = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    jm = JVAE(JVAEConfig(**cfg))
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rng.randn(2, 8, 8, 4).astype(np.float32)
    tm = tvae.AutoencoderKL(tvae.VAEConfig(**cfg)).eval()
    init_like_flax_(tm, torch.Generator().manual_seed(0))
    variables = convert_vae_state_dict(tm.state_dict(), ch_mult=(1, 2),
                                       num_res_blocks=1)
    # jitted: an eager Flax apply dispatches op by op
    want_enc = np.asarray(jax.jit(
        lambda v, a: jm.apply(v, a, method=JVAE.encode_mode))(variables, x))
    want_dec = np.asarray(jax.jit(
        lambda v, a: jm.apply(v, a, method=JVAE.decode))(variables, z))
    with torch.no_grad():
        got_enc = nhwc(tm.encode_mode(nchw(x)))
        got_dec = nhwc(tm.decode(nchw(z)))
    np.testing.assert_allclose(got_enc, want_enc, atol=1e-4)
    np.testing.assert_allclose(got_dec, want_dec, atol=1e-4)


def test_resnet_trunk_matches_jax():
    jm = JResNet()
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    variables = _perturb_stats(jax.jit(jm.init)(jax.random.PRNGKey(1), x), 2)
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    tm = tresnet.ResNet18Features()
    load_flax_tree(tm, tresnet.jax_module_pairs(), variables["params"],
                   variables["batch_stats"])
    tm.train()   # batch norm keeps using the running statistics
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == (2, 16, 16, 512)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.fixture(scope="module")
def eft_pair():
    """JAX and port EFTs with the same weights, bound to two context views
    of a synthetic scene (relative frame of view 0)."""
    scene = make_synthetic_scene(n_views=4, image_size=32, seed=0)
    ctx = [1, 3]
    jcams = jcam.get_relative_cameras(scene.cameras(), [0],
                                      center_at_origin=True)
    jm = JEFT(JEFTConfig())
    imgs = jnp.asarray(scene.images[ctx])
    tm = teft.EpipolarFeatureTransformer(teft.EFTConfig()).eval()
    init_like_flax_(tm, torch.Generator().manual_seed(2))
    rng = np.random.RandomState(3)
    with torch.no_grad():   # non-trivial running statistics
        for name, buf in tm.named_buffers():
            if "running" in name:
                buf.copy_(torch.tensor(rng.rand(*buf.shape) * 0.5 + 0.5))
    # the JAX side gets the port's weights through the JAX converter
    variables = convert_eft_state_dict(tm.state_dict())
    jlatent = jax.jit(lambda v: jm.apply(v, imgs, method=JEFT.encode))(
        variables)

    @jax.jit
    def jax_apply(o, d, lengths):
        return jm.apply(variables, o, d, lengths,
                        jcam.get_camera_slice(jcams, ctx), imgs, jlatent)

    tcams = tcam.get_relative_cameras(
        tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                            scene.image_size), [0], center_at_origin=True)
    timgs = nchw(scene.images[ctx])
    with torch.no_grad():
        tlatent = tm.encode(timgs)

    def port_apply(o, d, lengths):
        return tm(o, d, lengths, tcam.get_camera_slice(tcams, ctx), timgs,
                  tlatent)

    return dict(jax_apply=jax_apply, port_apply=port_apply, jcams=jcams,
                tcams=tcams, jlatent=np.asarray(jlatent), tlatent=tlatent)


def test_eft_encode_matches_jax(eft_pair):
    np.testing.assert_allclose(nhwc(eft_pair["tlatent"]),
                               eft_pair["jlatent"], atol=1e-4)


def test_eft_ray_query_matches_jax(eft_pair):
    rng = np.random.RandomState(4)
    o = (rng.randn(6, 3) * 0.1).astype(np.float32)
    d = rng.randn(6, 3).astype(np.float32)
    lengths = np.sort(rng.uniform(1.0, 5.0, (6, 5)), -1).astype(np.float32)
    want_rgb, want_feat = eft_pair["jax_apply"](o, d, lengths)
    with torch.no_grad():
        rgb, feat = eft_pair["port_apply"](*map(torch.tensor, (o, d, lengths)))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=1e-5)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat),
                               atol=1e-4)


def test_render_light_field_matches_jax(eft_pair):
    """Grid rays of query view 2 through the EFT in 4 chunks."""
    jq = jcam.get_camera_slice(eft_pair["jcams"], [2])
    tq = tcam.get_camera_slice(eft_pair["tcams"], [2])
    want = jax_render_light_field(eft_pair["jax_apply"], jq, 4, 4, 1.0, 6.0,
                                  n_pts_per_ray=5, n_batches=4)
    with torch.no_grad():
        got = render_light_field(eft_pair["port_apply"], tq, 4, 4, 1.0, 6.0,
                                 n_pts_per_ray=5, n_batches=4)
    assert got[0].shape == (1, 4, 4, 3) and got[1].shape == (1, 4, 4, 256)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4)


def test_harmonics_and_ndc_projection_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(7, 6).astype(np.float32)
    np.testing.assert_allclose(HarmonicEmbedding(6, 1.0)(torch.tensor(x))
                               .numpy(), np.asarray(JHarmonic(6, 1.0)(x)),
                               rtol=1e-5, atol=1e-5)
    scene = make_synthetic_scene(n_views=3, image_size=16, seed=1)
    jc = scene.cameras()
    tc = tcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                             np.array([[16.0, 24.0]] * 3))
    jc = jcam.Cameras.create(scene.R, scene.T, scene.f, scene.c,
                             np.array([[16.0, 24.0]] * 3))
    pts = rng.randn(1, 9, 3).astype(np.float32)
    for name in ("world_to_view", "transform_points_ndc"):
        np.testing.assert_allclose(
            getattr(tcam, name)(tc, torch.tensor(pts)).numpy(),
            np.asarray(getattr(jcam, name)(jc, pts)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcam._ndc_scale(tc).numpy(),
                               np.asarray(jcam._ndc_scale(jc)))
