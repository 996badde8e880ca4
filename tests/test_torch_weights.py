"""The port's networks hold the reference parameter layout: structure at
full width without compute, the JAX parameter round trip, and loading of
reference-layout checkpoints.

* On the ``meta`` device (no memory, no compute), the port's
  ``UNetConfig()``, ``VAEConfig()`` and ``EFTConfig()`` state dicts, run
  through the JAX package's ``convert_*_state_dict``, give the tree of
  ``jax.eval_shape`` of the JAX inits leaf for leaf: the port's key names
  and shapes are the reference torch layout the converters read.
* ``load_jax_params`` of the converted port state dict gives back the
  identical state dict.
* Made-up state dicts in the reference checkpoint layouts (``unets.0.``,
  ``first_stage_model.`` / ``model.``, the EFT's ``encoder_model.`` with
  the unused resnet18 layer4 / fc, a torchvision resnet18) load through
  ``train/checkpoints.py`` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.core.cameras import Cameras as JCameras
from sparsefusion_tpu.nn.eft import EFTConfig as JEFTConfig
from sparsefusion_tpu.nn.eft import EpipolarFeatureTransformer as JEFT
from sparsefusion_tpu.nn.unet import EfficientUNet as JEfficientUNet
from sparsefusion_tpu.nn.unet import UNetConfig as JUNetConfig
from sparsefusion_tpu.nn.vae import AutoencoderKL as JVAE
from sparsefusion_tpu.nn.vae import VAEConfig as JVAEConfig
from sparsefusion_tpu.train import convert as C
from sparsefusion_tpu_torch.models import build_models, narrow_model_configs
from sparsefusion_tpu_torch.nn import eft as teft
from sparsefusion_tpu_torch.nn import unet as tunet
from sparsefusion_tpu_torch.nn import vae as tvae
from sparsefusion_tpu_torch.train import checkpoints

torch.set_num_threads(2)


def _zeros_like(sd, prefix=""):
    """Read-only zero arrays of the state dict's shapes (no memory)."""
    return {prefix + k: np.broadcast_to(np.zeros((), np.float32),
                                        tuple(v.shape))
            for k, v in sd.items()}


def _leaves(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_unet_shapes(key):
    return JEfficientUNet(JUNetConfig()).init(
        key, jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 32, 32, 256)))["params"]


def _jax_vae_shapes(key):
    return JVAE(JVAEConfig()).init(key, jnp.zeros((1, 64, 64, 3)))


def _jax_eft_shapes(key):
    cams = JCameras.create(jnp.eye(3)[None], jnp.zeros((1, 3)),
                           jnp.ones((1, 2)), jnp.zeros((1, 2)),
                           jnp.full((1, 2), 256.0))
    img = jnp.zeros((1, 32, 32, 3))

    def init_fn(model):
        return model(jnp.zeros((4, 3)), jnp.ones((4, 3)), jnp.ones((4, 2)),
                     cams, img, model.encode(img))

    return JEFT(JEFTConfig()).init(key, method=init_fn)


FULL = {
    "unet": (lambda: tunet.EfficientUNet(tunet.UNetConfig()),
             lambda sd: C.convert_unet_state_dict(_zeros_like(sd, "unets.0.")),
             _jax_unet_shapes, 400_608_797),
    "vae": (lambda: tvae.AutoencoderKL(tvae.VAEConfig()),
            lambda sd: C.convert_vae_state_dict(_zeros_like(sd)),
            _jax_vae_shapes, 83_653_863),
    "eft": (lambda: teft.EpipolarFeatureTransformer(teft.EFTConfig()),
            lambda sd: C.convert_eft_state_dict(_zeros_like(sd)),
            _jax_eft_shapes, None),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_layout_matches_jax_tree(name):
    make, convert, jax_init, n_params = FULL[name]
    with torch.device("meta"):
        model = make()
    converted = convert(model.state_dict())
    want = _leaves(jax.eval_shape(jax_init, jax.random.PRNGKey(0)))
    assert _leaves(converted) == want
    n_jax = sum(int(np.prod(s)) for p, s in want.items()
                if "batch_stats" not in p)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    if n_params is not None:
        assert n_jax == n_params


@pytest.fixture(scope="module")
def narrow():
    return build_models(torch.Generator().manual_seed(3), "cpu",
                        **narrow_model_configs())


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_load_jax_params_round_trip(narrow):
    ucfg = narrow.unet.config
    vcfg = narrow.vae.config
    with torch.no_grad():   # non-trivial running statistics
        for name, buf in narrow.eft.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.0)
    fresh = build_models(torch.Generator().manual_seed(4), "cpu",
                         **narrow_model_configs())

    tunet.load_jax_params(fresh.unet, C.convert_unet_state_dict(
        {f"unets.0.{k}": v for k, v in narrow.unet.state_dict().items()},
        num_levels=len(ucfg.dim_mults),
        num_resnet_blocks=ucfg.num_resnet_blocks,
        layer_attns=ucfg.layer_attns))
    tvae.load_jax_params(fresh.vae, C.convert_vae_state_dict(
        narrow.vae.state_dict(), ch_mult=vcfg.ch_mult,
        num_res_blocks=vcfg.num_res_blocks))
    teft.load_jax_params(fresh.eft, C.convert_eft_state_dict(
        narrow.eft.state_dict()))
    for a, b in ((narrow.unet, fresh.unet), (narrow.vae, fresh.vae),
                 (narrow.eft, fresh.eft)):
        _same_state(a, b)


def test_load_jax_params_refuses_a_short_tree(narrow):
    params = C.convert_vae_state_dict(
        narrow.vae.state_dict(), ch_mult=narrow.vae.config.ch_mult,
        num_res_blocks=narrow.vae.config.num_res_blocks)
    del params["params"]["quant_conv"]
    with pytest.raises(KeyError, match="quant_conv"):
        tvae.load_jax_params(narrow.vae, params)


def test_reference_checkpoints_load(narrow, tmp_path):
    src = build_models(torch.Generator().manual_seed(5), "cpu",
                       **narrow_model_configs())
    # the reference EFT holds a whole resnet18: layer4 and fc go unused
    eft_sd = {"encoder_model.layer4.0.conv1.weight": torch.ones(3),
              "encoder_model.fc.weight": torch.ones(2),
              **src.eft.state_dict()}
    vae_sd = {f"first_stage_model.{k}": v
              for k, v in src.vae.state_dict().items()}
    vae_sd["model.diffusion_model.input.weight"] = torch.ones(2)
    vldm_sd = {f"unets.0.{k}": v for k, v in src.unet.state_dict().items()}
    paths = {n: str(tmp_path / f"{n}.pt") for n in ("eft", "vae", "vldm")}
    torch.save({"model_state_dict": eft_sd}, paths["eft"])
    torch.save({"state_dict": vae_sd}, paths["vae"])
    torch.save({"model_state_dict": vldm_sd}, paths["vldm"])

    checkpoints.maybe_import_reference_weights(
        narrow, paths["eft"], paths["vae"], paths["vldm"], verbose=False)
    for a, b in ((src.unet, narrow.unet), (src.vae, narrow.vae),
                 (src.eft, narrow.eft)):
        _same_state(a, b)

    # a torchvision resnet18 state dict for the EFT trunk alone
    trunk = build_models(torch.Generator().manual_seed(6), "cpu",
                         **narrow_model_configs()).eft.encoder_model
    rn = dict(trunk.state_dict())
    rn["layer4.1.bn2.weight"] = torch.ones(4)
    rn["fc.bias"] = torch.ones(4)
    torch.save(rn, tmp_path / "resnet18.pth")
    checkpoints.import_resnet18_trunk(narrow, str(tmp_path / "resnet18.pth"),
                                      verbose=False)
    _same_state(trunk, narrow.eft.encoder_model)

    # a checkpoint that lacks an entry of the model is refused
    del vldm_sd["unets.0.final_conv.bias"]
    torch.save({"model_state_dict": vldm_sd}, paths["vldm"])
    with pytest.raises(KeyError, match="final_conv.bias"):
        checkpoints.maybe_import_reference_weights(
            narrow, vldm_ckpt=paths["vldm"], verbose=False)


def test_npz_jax_trees_load(narrow, tmp_path):
    """``.npz`` checkpoints are JAX trees flattened with '/' keys."""
    src = build_models(torch.Generator().manual_seed(7), "cpu",
                       **narrow_model_configs())
    vcfg = src.vae.config
    tree = C.convert_vae_state_dict(src.vae.state_dict(),
                                    ch_mult=vcfg.ch_mult,
                                    num_res_blocks=vcfg.num_res_blocks)
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(tmp_path / "vae.npz", **flat)
    checkpoints.maybe_import_reference_weights(
        narrow, vae_ckpt=str(tmp_path / "vae.npz"), verbose=False)
    _same_state(src.vae, narrow.vae)
