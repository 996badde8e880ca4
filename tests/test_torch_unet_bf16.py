"""The port's UNet in bf16 against the JAX package's
``EfficientUNet(dtype=jnp.bfloat16)``, and the bf16 copy the sampler uses.

The UNet is the JAX package's tiny test model (``tests/test_torch_unet``)
with a random final conv, the same weights on both sides through the JAX
package's converter.  Two bf16 forms of the port are held against the JAX
module: the train step's (``models.unet_compute_view``: f32 parameters,
bf16 compute; the JAX module on the f32 parameters) and the sampler's
(``SparseFusionModels.unet_half``: bf16 parameters; the JAX module on
``unet_params_half``'s bf16 parameters).

The two packages round at different places (XLA may keep an f32
intermediate between fused bf16 operations; torch rounds each operation's
result, and adds a conv's bias before rounding), so the tolerance is
loose: outputs of magnitude ~5 within 0.15 absolute (the JAX package's
own bf16 test against f32 uses 0.15 / 10% relative), relative Frobenius
error under 3e-2.  Measured: 1.6e-2 for the compute view, about as far
as either package's bf16 UNet is from its f32 one (1.4e-2).  One known
difference is the attention's logits: at 16 tokens the JAX ``Attention``
takes its einsum, which rounds the logits to bf16 before the softmax,
where the port (and the Pallas kernel the port follows) keeps them in
f32.  The test measures the gap again with the port's logits rounded the
same way and prints both: that rounding alone moves the gap by at most
a tenth of itself (measured 1.578e-2 -> 1.579e-2 for the compute view,
1.716e-2 -> 1.545e-2 for the bf16 copy), so it is not what separates the
two.  Against the f32 UNet
the bf16 outputs correlate above 0.99, as in the JAX package's test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.nn.unet import EfficientUNet as JEfficientUNet
from sparsefusion_tpu.nn.unet import UNetConfig as JUNetConfig
from sparsefusion_tpu.train.convert import convert_unet_state_dict
from sparsefusion_tpu_torch.models import build_models, unet_compute_view
from sparsefusion_tpu_torch.nn import layers
from sparsefusion_tpu_torch.nn.unet import EfficientUNet, UNetConfig
from sparsefusion_tpu_torch.ops.attention import imagen_attention_plain

torch.set_num_threads(2)

TINY = dict(dim=32, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
            layer_attns=(False, True), layer_cross_attns=(False, False),
            cond_images_channels=16, attn_heads=2, attn_dim_head=8)
ATOL, REL = 0.15, 3e-2


def nchw(a):
    return torch.tensor(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _port_unet():
    g = torch.Generator().manual_seed(0)
    tm = EfficientUNet(UNetConfig(**TINY)).init_weights_(g).eval()
    with torch.no_grad():
        tm.final_conv.weight.normal_(0.0, 0.1, generator=g)
        tm.final_conv.bias.normal_(0.0, 0.1, generator=g)
    return tm


def _jax_params(tm):
    return convert_unet_state_dict(
        {f"unets.0.{k}": v for k, v in tm.state_dict().items()},
        num_levels=2, num_resnet_blocks=TINY["num_resnet_blocks"],
        layer_attns=TINY["layer_attns"])


def _inputs():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    cond = rng.randn(2, 4, 4, 16).astype(np.float32)   # resized to 8 x 8
    log_snr = np.array([-3.0, 2.5], np.float32)
    keep = np.array([True, False])
    return x, log_snr, cond, keep


def _port_out(unet, x, log_snr, cond, keep):
    with torch.no_grad():
        out = unet(nchw(x), torch.tensor(log_snr), nchw(cond),
                   torch.tensor(keep))
    assert out.dtype == torch.float32
    return out.permute(0, 2, 3, 1).numpy()


def _rounded_logits(q, k, v):
    """The plain attention with its logits rounded to q's type first, as
    the JAX ``Attention``'s einsum path computes them."""
    sim = torch.einsum("bhnd,bjd->bhnj", q, k)
    attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhnj,bjd->bhnd", attn, v)


def _gap(got, want):
    return (float(np.abs(got - want).max()),
            float(np.linalg.norm(got - want) / np.linalg.norm(want)))


@pytest.mark.parametrize("form", ["compute_view", "half_copy"])
def test_bf16_unet_matches_jax_bf16(form, monkeypatch):
    tm = _port_unet()
    params = _jax_params(tm)
    if form == "half_copy":
        models = build_models(torch.Generator().manual_seed(0), "cpu",
                              unet_config=UNetConfig(**TINY))
        models.unet.load_state_dict(tm.state_dict())
        unet = models.unet_half()
        assert all(p.dtype == torch.bfloat16 for p in unet.parameters())
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16), params)
    else:
        unet = unet_compute_view(tm, torch.bfloat16)
        assert all(p.dtype == torch.float32 for p in unet.parameters())
    jm = JEfficientUNet(JUNetConfig(**TINY), dtype=jnp.bfloat16)
    args = _inputs()
    want = np.asarray(jax.jit(
        lambda *a: jm.apply({"params": params}, *a))(*args), np.float32)
    got = _port_out(unet, *args)
    f32 = _port_out(tm, *args)

    assert np.isfinite(got).all()
    err, rel = _gap(got, want)
    monkeypatch.setattr(layers, "imagen_attention", _rounded_logits)
    err_r, rel_r = _gap(_port_out(unet, *args), want)
    print(f"{form}: bf16 port vs JAX bf16 max {err:.3e} rel {rel:.3e}; with "
          f"the logits rounded as JAX's einsum: max {err_r:.3e} rel "
          f"{rel_r:.3e}; output scale {np.abs(want).max():.2f}")
    assert err <= ATOL and rel <= REL, (err, rel)
    assert err_r <= ATOL and rel_r <= REL, (err_r, rel_r)
    # bf16 against the port's f32 UNet: close, and far from garbage
    np.testing.assert_allclose(got, f32, atol=0.15, rtol=0.1)
    assert np.corrcoef(got.ravel(), f32.ravel())[0, 1] > 0.99


def test_plain_attention_rounding_is_the_kernels():
    """At the UNet's shapes in bf16, the port's attention (the kernel's
    arithmetic: f32 logits) and the logit-rounding einsum differ, which is
    the gap the test above attributes to them."""
    rng = np.random.RandomState(0)
    q = torch.tensor(rng.randn(2, 2, 16, 8) * 8 ** -0.5).bfloat16()
    k = torch.tensor(rng.randn(2, 17, 8)).bfloat16()
    v = torch.tensor(rng.randn(2, 17, 8)).bfloat16()
    a = imagen_attention_plain(q, k, v).float()
    b = _rounded_logits(q, k, v).float()
    assert 0 < (a - b).abs().max().item() < 5e-2


def test_half_copy_is_cached_and_remade_after_a_load():
    """The sampler's bf16 copy is made once; writing the f32 weights in
    place (a load) makes a new copy with the new weights."""
    models = build_models(torch.Generator().manual_seed(0), "cpu",
                          unet_config=UNetConfig(**TINY))
    half = models.unet_half()
    assert models.unet_half() is half
    assert not any(p.requires_grad for p in half.parameters())
    args = _inputs()
    before = _port_out(half, *args)

    tm = _port_unet()
    models.unet.load_state_dict(tm.state_dict())
    new = models.unet_half()
    assert new is not half and models.unet_half() is new
    for name, p in new.named_parameters():
        assert torch.equal(p, tm.state_dict()[name].bfloat16()), name
    after = _port_out(new, *args)
    assert not np.allclose(before, after)
    # a denoise call through the copy counts as an evaluation
    evals = models.unet_evals
    eps = models.denoise_fn(nchw(args[0]), torch.tensor(args[1]),
                            nchw(args[2]), None, bf16=True)
    assert models.unet_evals == evals + 1 and eps.dtype == torch.float32


def test_compute_view_trains_the_f32_parameters():
    """The train step's bf16 UNet shares the f32 parameters: its
    gradients land on them, in f32."""
    tm = _port_unet()
    view = unet_compute_view(tm, torch.bfloat16)
    assert {id(p) for p in view.parameters()} == \
        {id(p) for p in tm.parameters()}
    x, log_snr, cond, keep = _inputs()
    out = view(nchw(x), torch.tensor(log_snr), nchw(cond),
               torch.tensor(keep))
    out.square().mean().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in tm.parameters())
    assert tm.final_conv.compute_dtype == torch.float32
    assert view.final_conv.compute_dtype == torch.bfloat16
