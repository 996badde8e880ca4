"""The port's LPIPS (``nn/lpips.py``) against the JAX package's.

Both sides run the same synthesized weights: a torchvision ``vgg16``
state dict (He-normal convolutions) and an lpips ``lin{i}.model.1.weight``
state dict (non-negative heads), which the port loads as they are and the
JAX side gets through its ``convert_lpips_weights``.  The distances and
their gradient in ``img0`` agree to 1e-4 relative: the value against its
own size, the gradient against the largest entry of the JAX gradient
(the same f32 convolutions summed in another order on the two sides).
No LPIPS weights ship with the repository, so the values themselves mean
nothing; agreement and the loaders are what is held here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.nn.lpips import LPIPS as JLPIPS
from sparsefusion_tpu.nn.lpips import convert_lpips_weights
from sparsefusion_tpu_torch.nn import lpips as tlpips

torch.set_num_threads(2)

RTOL = 1e-4


def synthesized_state_dicts(seed=0):
    """(torchvision vgg16 state dict, lpips lin state dict), seeded."""
    rng = np.random.RandomState(seed)
    model = tlpips.LPIPS()
    vgg, lin = {}, {}
    for name, p in model.state_dict().items():
        if name.startswith("vgg."):
            if name.endswith("weight"):
                fan_in = int(np.prod(p.shape[1:]))
                a = rng.randn(*p.shape) * np.sqrt(2.0 / fan_in)
            else:
                a = rng.randn(*p.shape) * 0.01
            vgg[name[len("vgg."):]] = torch.tensor(a, dtype=torch.float32)
        else:
            lin[name] = torch.tensor(np.abs(rng.randn(*p.shape)) * 0.1,
                                     dtype=torch.float32)
    # torchvision's classifier, which LPIPS does not read
    vgg["classifier.0.weight"] = torch.zeros(4, 8)
    return vgg, lin


@pytest.fixture(scope="module")
def weights():
    vgg, lin = synthesized_state_dicts()
    params = convert_lpips_weights(vgg, lin)
    port = tlpips.LPIPS().load_torch_weights(vgg, lin).requires_grad_(False)
    return vgg, lin, params, port


@pytest.mark.parametrize("size", [32, 64])
def test_lpips_value_and_input_gradient_match_jax(weights, size):
    _, _, params, port = weights
    rng = np.random.RandomState(size)
    img0 = rng.rand(2, size, size, 3).astype(np.float32)
    img1 = rng.rand(2, size, size, 3).astype(np.float32)

    jmodel = JLPIPS()

    def total(a, b):
        d = jmodel.apply({"params": params}, a, b, normalize=True)
        return d.sum(), d

    (_, want), want_grad = jax.jit(jax.value_and_grad(
        total, has_aux=True))(jnp.asarray(img0), jnp.asarray(img1))

    x0 = torch.tensor(img0, requires_grad=True)
    got = port(x0, torch.tensor(img1), normalize=True)
    got.sum().backward()

    want, want_grad = np.asarray(want), np.asarray(want_grad)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)
    err = np.abs(x0.grad.numpy() - want_grad).max()
    assert err <= RTOL * np.abs(want_grad).max(), err


def test_state_dict_from_jax_inverts_the_converter(weights):
    vgg, lin, params, port = weights
    sd = tlpips.lpips_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    want = port.state_dict()
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("form", ["params_object", "flat_keys", "pth_pair"])
def test_build_lpips_fn_reads_every_weights_form(weights, form, tmp_path):
    vgg, lin, params, port = weights
    if form == "params_object":
        spec = str(tmp_path / "lpips.npz")
        np.savez(spec, params=np.asarray(
            jax.tree_util.tree_map(np.asarray, params), dtype=object))
    elif form == "flat_keys":
        spec = str(tmp_path / "lpips.npz")
        np.savez(spec, **_flat(params))
    else:
        torch.save(vgg, tmp_path / "vgg16.pth")
        torch.save(lin, tmp_path / "lpips_vgg.pth")
        spec = f"{tmp_path / 'vgg16.pth'}, {tmp_path / 'lpips_vgg.pth'}"
    if form != "pth_pair":
        model = tlpips.load_lpips(spec)
        for k, v in port.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k
    fn = tlpips.build_lpips_fn(spec, "cpu")
    rng = np.random.RandomState(1)
    a = torch.tensor(rng.rand(2, 32, 32, 3), dtype=torch.float32)
    b = torch.tensor(rng.rand(2, 32, 32, 3), dtype=torch.float32)
    assert torch.equal(fn(a, b), port(a, b, normalize=True))
    # frozen weights: a backward reaches the images only
    a.requires_grad_()
    fn(a, b).sum().backward()
    assert a.grad is not None


@pytest.mark.parametrize("spec", ["missing.npz", "missing_vgg.pth,x.pth"])
def test_build_lpips_fn_warns_and_returns_none_without_weights(
        spec, tmp_path, capsys):
    assert tlpips.build_lpips_fn(str(tmp_path / spec), "cpu") is None
    assert "lpips weights not found" in capsys.readouterr().out
    assert tlpips.build_lpips_fn(None) is None
    assert tlpips.load_lpips(None) is None
