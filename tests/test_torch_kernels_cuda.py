"""The CUDA kernels (grid encode K1, imagen attention K2 in f32 and bf16,
row gather K3) against their plain PyTorch versions, and the occupancy
grid on the card against the CPU, on a CUDA card.  Without one these
tests skip: a CUDA kernel has no CPU mode.  f32 matmuls and convolutions
run in full f32 here (``set_tf32(False)``, as the entry points set it).

This file imports no jax, so it also runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``.
"""
import math

import numpy as np
import pytest
import torch

from sparsefusion_tpu_torch.kernels import attention
from sparsefusion_tpu_torch.kernels import grid_encode as kernels
from sparsefusion_tpu_torch.ops.attention import imagen_attention_plain
from sparsefusion_tpu_torch.ops.grid_encode import (
    grid_encode,
    grid_encode_plain,
    make_grid_encoding,
)
from sparsefusion_tpu_torch.utils.precision import set_tf32


@pytest.fixture(autouse=True, scope="module")
def _full_f32():
    """Full f32 matmuls and convolutions for the module, as the port's
    entry points set them; the process's settings are restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    set_tf32(False)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before

CASES = {
    "tiled": (dict(num_levels=4, level_dim=2, base_resolution=4,
                   log2_hashmap_size=9, per_level_scale=1.9,
                   gridtype="tiled"), None),
    "hash": (dict(num_levels=4, level_dim=2, base_resolution=8,
                  log2_hashmap_size=10, gridtype="hash"), None),
    "tiled_bf16_c4": (dict(num_levels=4, level_dim=4, base_resolution=4,
                           log2_hashmap_size=9, per_level_scale=1.9,
                           gridtype="tiled"), "bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw, table_dtype = CASES[case]
    enc = make_grid_encoding(**kw)
    rng = np.random.RandomState(3)
    x = torch.tensor((rng.rand(4096, 3) * 1.1 - 0.05).astype(np.float32))
    table = torch.tensor((rng.randn(enc.total_params, enc.level_dim) * 0.5
                          ).astype(np.float32))
    g = torch.tensor(rng.randn(4096, enc.output_dim).astype(np.float32))

    tp = table.clone().requires_grad_()
    out_p = grid_encode_plain(x, tp, enc, table_dtype)
    (out_p * g).sum().backward()

    kernels.reset_launches()
    tk = table.cuda().requires_grad_()
    out_k = grid_encode(x.cuda(), tk, enc, table_dtype)
    (out_k * g.cuda()).sum().backward()
    torch.cuda.synchronize()
    assert kernels.grid_encode_cuda.launches == 1
    assert kernels.grid_encode_cuda_backward.launches == 1
    np.testing.assert_allclose(out_k.detach().cpu().numpy(),
                               out_p.detach().numpy(), atol=1e-5)
    # f32 atomics add in another order than the plain scatter
    np.testing.assert_allclose(tk.grad.cpu().numpy(), tp.grad.numpy(),
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_encode_refuses_position_gradients():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    enc = make_grid_encoding(num_levels=2, gridtype="tiled")
    x = torch.rand(8, 3, device="cuda", requires_grad=True)
    table = torch.zeros(enc.total_params, enc.level_dim, device="cuda")
    with pytest.raises(ValueError, match="positions"):
        grid_encode(x, table, enc)


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys", [17, 19, 1027])
def test_imagen_attention_kernel_matches_plain(n_keys):
    """The UNet's shapes (16 queries, 17 or 19 keys) and the long shape
    the TPU kernel was written for; f32, online softmax in the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    b, n = (2, 1024) if n_keys == 1027 else (1, 16)
    rng = np.random.RandomState(n_keys)
    q = torch.tensor(rng.randn(b, 8, n, 64).astype(np.float32) / 8).cuda()
    k = torch.tensor(rng.randn(b, n_keys, 64).astype(np.float32)).cuda()
    v = torch.tensor(rng.randn(b, n_keys, 64).astype(np.float32)).cuda()
    attention.reset_launches()
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention.imagen_attention(qa, ka, va)
    torch.cuda.synchronize()
    assert attention.imagen_attention_cuda.launches == 1
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    want = imagen_attention_plain(qp, kp, vp)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    g = torch.randn_like(out)
    (out * g).sum().backward()
    (want * g).sum().backward()
    for got, ref in ((qa, qp), (ka, kp), (va, vp)):
        torch.testing.assert_close(got.grad, ref.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_imagen_attention_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(1, 2, 4, 48, device="cuda")
    k = torch.zeros(1, 3, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        attention.imagen_attention_cuda(q, k, k)
    q = torch.zeros(1, 2, 4, 64, device="cuda")
    k = torch.zeros(1, 3, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        attention.imagen_attention_cuda(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention.imagen_attention_cuda(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="one dtype"):
        attention.imagen_attention_cuda(q, k.bfloat16(), k.bfloat16())


# (H, N) pairs with H*N = 5, 16, 128 and 8192 rows of one batch
ATTN_ROWS = [(1, 5), (8, 2), (8, 16), (8, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n_keys", [1, 7, 8, 9, 17, 19, 64, 65, 1027])
@pytest.mark.parametrize("hn", ATTN_ROWS, ids=lambda hn: f"H{hn[0]}N{hn[1]}")
@pytest.mark.parametrize("b", [1, 2])
def test_imagen_attention_kernel_ragged_shapes(b, hn, n_keys, d):
    """Partial m-tiles (rows not a multiple of 16), partial and single
    k/v tiles (J around the 8-key steps and the 32- or 64-key tiles),
    both head dims; the 3xTF32 products keep f32 accuracy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    h, n = hn
    rng = np.random.RandomState(b * 1000 + n_keys + d)
    q = torch.tensor((rng.randn(b, h, n, d) * d ** -0.5).astype(np.float32))
    k = torch.tensor(rng.randn(b, n_keys, d).astype(np.float32))
    v = torch.tensor(rng.randn(b, n_keys, d).astype(np.float32))
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    got = attention.imagen_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, imagen_attention_plain(q, k, v),
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("n_keys", [1, 7, 9, 17, 19, 127, 128, 129, 257,
                                    1027])
@pytest.mark.parametrize("bhn", [(1, 1, 5), (12, 2, 16), (12, 8, 16),
                                 (2, 2, 2048)],
                         ids=lambda bhn: "B{}H{}N{}".format(*bhn))
def test_imagen_attention_kernel_small_head_dims(bhn, n_keys, d):
    """Head dims 8 and 16 (the narrow UNet's ``attn_dim_head=8``): partial
    m-tiles, k/v tiles of 128 keys (J around one and two tiles), the
    train step's diffusion batch of 12; under the f32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    b, h, n = bhn
    rng = np.random.RandomState(b * 1000 + n_keys + d)
    q = torch.tensor((rng.randn(b, h, n, d) * d ** -0.5).astype(np.float32))
    k = torch.tensor(rng.randn(b, n_keys, d).astype(np.float32))
    v = torch.tensor(rng.randn(b, n_keys, d).astype(np.float32))
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    got = attention.imagen_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, imagen_attention_plain(q, k, v),
                               atol=1e-5, rtol=0)


# K2's bf16 instance against the plain version in bf16.  Both compute
# the logits and the softmax in f32 and round P to bf16; the kernel rounds
# the unnormalised exp(s - running max), the plain version the normalised
# P, and each output is rounded to bf16 once.  So they differ by one
# output ulp (2^-7 relative at most) plus the rounding of P on the sum
# over keys; an emulation of the kernel's arithmetic in torch on these
# shapes (every head dim alike) stays within 5.2e-3 beyond one ulp.
BF16_ATOL, BF16_RTOL = 1e-2, 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("n_keys", [1, 7, 17, 19, 65, 127, 128, 129, 255,
                                    256, 257, 1027, 4099])
@pytest.mark.parametrize("bhn", [(1, 1, 5), (3, 3, 37), (12, 8, 16),
                                 (2, 2, 2048)],
                         ids=lambda bhn: "B{}H{}N{}".format(*bhn))
def test_imagen_attention_bf16_kernel_matches_plain(bhn, n_keys, d):
    """Every head dim (D = 8 pads its reduction to 16), partial m-tiles,
    one key, ragged key tiles around 16-key steps and the 64- and 128-key
    tiles, up to 4099 keys (a wrong P fragment mapping shows only beyond
    8 keys).  Beyond 128 keys at D = 16, 32 and 64 the wgmma body runs
    (the counter says which body ran): keys on both sides of its 128-key
    tiles, and H*N = 111 rows with B = 3, which is not a multiple of its
    128-row CTAs, so rows leaking into the next batch would show."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    b, h, n = bhn
    rng = np.random.RandomState(b * 1000 + n_keys + d)
    q = torch.tensor((rng.randn(b, h, n, d) * d ** -0.5).astype(np.float32))
    k = torch.tensor(rng.randn(b, n_keys, d).astype(np.float32))
    v = torch.tensor(rng.randn(b, n_keys, d).astype(np.float32))
    q, k, v = (t.cuda().bfloat16() for t in (q, k, v))
    wgmma = d in (16, 32, 64) and n_keys > 128
    assert attention.bf16_plan(b, h * n, n_keys, d).body == \
        ("wgmma" if wgmma else "mma_sync")
    attention.reset_launches()
    got = attention.imagen_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert attention.imagen_attention_cuda.launches_bf16 == 1
    assert attention.imagen_attention_cuda.launches_bf16_wgmma == int(wgmma)
    torch.testing.assert_close(got.float(),
                               imagen_attention_plain(q, k, v).float(),
                               atol=BF16_ATOL, rtol=BF16_RTOL)


@pytest.mark.cuda
def test_imagen_attention_long_keys_route_as_before():
    """Over 1027 keys the dispatcher routes as it did before the wgmma
    body: f32 to the f32 instance (no bf16 launch), bf16 at D = 48 to the
    plain version (no launch), bf16 at D = 64 to the wgmma body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(7)

    def qkv(d, dtype):
        q = rng.randn(2, 2, 256, d).astype(np.float32) * d ** -0.5
        k, v = (rng.randn(2, 1027, d).astype(np.float32) for _ in range(2))
        return [torch.tensor(a).cuda().to(dtype) for a in (q, k, v)]

    cu = attention.imagen_attention_cuda
    for d, dtype, counts in ((64, torch.float32, (1, 0, 0)),
                             (48, torch.bfloat16, (0, 0, 0)),
                             (64, torch.bfloat16, (1, 1, 1))):
        q, k, v = qkv(d, dtype)
        attention.reset_launches()
        got = attention.imagen_attention(q, k, v)
        torch.cuda.synchronize()
        assert (cu.launches, cu.launches_bf16, cu.launches_bf16_wgmma) == \
            counts, (d, dtype)
        atol, rtol = (1e-5, 0) if dtype == torch.float32 \
            else (BF16_ATOL, BF16_RTOL)
        torch.testing.assert_close(got.float(),
                                   imagen_attention_plain(q, k, v).float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_imagen_attention_bf16_through_the_dispatcher():
    """The UNet's shape in bf16 with gradients: one bf16 launch, the plain
    backward in f32 cast back to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.RandomState(5)
    q = torch.tensor(rng.randn(1, 8, 16, 64).astype(np.float32) / 8)
    k = torch.tensor(rng.randn(1, 19, 64).astype(np.float32))
    v = torch.tensor(rng.randn(1, 19, 64).astype(np.float32))
    q, k, v = (t.cuda().bfloat16().requires_grad_() for t in (q, k, v))
    attention.reset_launches()
    out = attention.imagen_attention(q, k, v)
    g = torch.randn_like(out)
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert attention.imagen_attention_cuda.launches == 1
    assert attention.imagen_attention_cuda.launches_bf16 == 1
    assert attention.imagen_attention_cuda.launches_bf16_wgmma == 0
    want = attention.imagen_attention_backward_plain(q, k, v, g)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_imagen_attention_other_head_dims_take_the_plain_version(dtype):
    """D = 48 has no kernel instance: the dispatcher routes it to the plain
    version (the reference runs any head dim), launches nothing, and the
    kernel's own wrapper still refuses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(48)
    q = torch.tensor(rng.randn(2, 4, 16, 48).astype(np.float32) / 7)
    k = torch.tensor(rng.randn(2, 19, 48).astype(np.float32))
    v = torch.tensor(rng.randn(2, 19, 48).astype(np.float32))
    q, k, v = (t.cuda().to(dtype) for t in (q, k, v))
    attention.reset_launches()
    got = attention.imagen_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.imagen_attention_cuda.launches == 0
    assert got.dtype == dtype
    torch.testing.assert_close(got, imagen_attention_plain(q, k, v),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="head dim"):
        attention.imagen_attention_cuda(q, k, v)


@pytest.mark.cuda
def test_tiny_bf16_train_step_card_matches_cpu():
    """One bf16 train step of the tiny models (``--preset tiny``: K2's
    bf16 instance at D = 8) on the card and on the CPU from the same
    weights, batch and draws.  Both run the UNet in bf16 with rounding in
    different places (cuDNN's bf16 convolutions against the CPU's), so the
    loss agrees to 1e-2 relative and each model's gradients to 5e-2
    (Frobenius over the model); the parameters and Adam's moments stay
    f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.models import build_models
    from sparsefusion_tpu_torch.nn.unet import UNetConfig
    from sparsefusion_tpu_torch.nn.vae import VAEConfig
    from sparsefusion_tpu_torch.train import trainer

    models_cpu = build_models(
        torch.Generator().manual_seed(0), "cpu",
        unet_config=UNetConfig(dim=32, dim_mults=(1, 2),
                               num_resnet_blocks=(1, 1),
                               layer_attns=(False, True), attn_heads=2,
                               attn_dim_head=8),
        vae_config=VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1))
    with torch.no_grad():   # a zero final conv would hide the UNet
        models_cpu.unet.final_conv.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    cfg = trainer.TrainConfig(latent_size=8, context_size=2,
                              diffusion_batch_size=2,
                              compute_dtype="bfloat16")
    scene = make_synthetic_scene(n_views=4, image_size=64, seed=0)
    rng = np.random.RandomState(0)
    draws = {"times": rng.uniform(0, 0.999, 2), "noise": rng.randn(2, 4, 8, 8),
             "keep": rng.rand(2) < 0.9}
    out = {}
    for dev in ("cpu", "cuda"):
        models = copy.deepcopy(models_cpu)
        for m in (models.eft, models.vae, models.unet):
            m.to(dev)
        unet_opt, eft_opt = trainer.make_optimizers(cfg, models)
        step = trainer.make_train_step(models, cfg, unet_opt, eft_opt)
        batch = trainer.prepare_scene_batch([scene], [0], [[1, 2]], dev)
        d = [{k: torch.as_tensor(v, device=dev, dtype=torch.bool
                                 if k == "keep" else torch.float32)
              for k, v in draws.items()}]
        attention.reset_launches()
        loss = float(step(batch, draws=d)[0])
        out[dev] = {"loss": loss,
                    "launches": attention.imagen_attention_cuda.launches_bf16,
                    "grads": {f"{name}.{n}": p.grad.cpu()
                              for name, m in (("unet", models.unet),
                                              ("eft", models.eft))
                              for n, p in m.named_parameters()}}
        for opt in (unet_opt, eft_opt):
            for p in opt.params:
                assert p.dtype == torch.float32
                assert all(t.dtype == torch.float32 for key, t in
                           opt.adam.state[p].items() if key != "step")
    cpu, gpu = out["cpu"], out["cuda"]
    assert math.isfinite(gpu["loss"])
    assert cpu["launches"] == 0 and gpu["launches"] == 3
    assert abs(cpu["loss"] - gpu["loss"]) <= 1e-2 * abs(cpu["loss"])
    for model in ("unet", "eft"):
        names = [n for n in cpu["grads"] if n.startswith(model + ".")]
        gc = torch.cat([cpu["grads"][n].ravel() for n in names])
        gg = torch.cat([gpu["grads"][n].ravel() for n in names])
        assert ((gc - gg).norm() / gc.norm()).item() <= 5e-2, model


def _ray_points(n_rays, n_samples, seed):
    from sparsefusion_tpu_torch.ops.grid_encode import ray_ordered_points

    return ray_ordered_points(n_rays, n_samples,
                              torch.Generator(device="cuda").manual_seed(seed),
                              "cuda")


BWD_CASES = {
    # the main path's encoding on one launch's points, ray by ray
    "rays_ngp": (dict(num_levels=16, level_dim=2, base_resolution=16,
                      log2_hashmap_size=16, desired_resolution=8192,
                      gridtype="tiled"), None,
                 lambda: _ray_points(4096, 64, 0)),
    # every lane of every warp on the same 8 rows per level
    "identical_points": (CASES["tiled"][0], None,
                         lambda: torch.full((65536, 3), 0.4321,
                                            device="cuda")),
    "rays_bf16_c4": (CASES["tiled_bf16_c4"][0], "bfloat16",
                     lambda: _ray_points(1024, 64, 1)),
    "rays_hash": (CASES["hash"][0], None, lambda: _ray_points(1024, 64, 2)),
    "rays_c1": (dict(CASES["tiled"][0], level_dim=1), None,
                lambda: _ray_points(256, 64, 3)),
    "rays_c8": (dict(CASES["tiled"][0], level_dim=8), None,
                lambda: _ray_points(256, 64, 4)),
    # a partial last tile: 1000 points is not a multiple of the block
    "uniform_ragged": (CASES["hash"][0], None,
                       lambda: torch.rand(1000, 3, device="cuda") * 1.1
                       - 0.05),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_cuda_table_gradient_on_clustered_points(case):
    """The warp-merged backward against the plain scatter where many
    neighbouring points share rows.  Tolerance: f32 sums in another
    order, so it scales with the largest accumulated gradient.

    ``identical_points`` sums 65,536 terms w g_i into each of the point's
    rows, in an order the atomics choose anew at each launch, and is held
    against the double-summed gradient by the standard bound of an f32
    sum of n terms in any order: per element |got - want| <= gamma_n *
    sum_i |w g_i| + 2u |want|, u = 2^-24, gamma_n = n u / (1 - n u), n =
    65,536 (one rounding of each product and n - 1 additions; the second
    term the reference's rounding of its double sum and of its product by
    w).  The bound is derived, not fitted: the error's spread over 200
    launches is ``chip_smoke.py``'s ``k1_summation_bound_check``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw, table_dtype = BWD_CASES[case][:2]
    torch.manual_seed(5)
    x = BWD_CASES[case][2]()
    enc = make_grid_encoding(**kw)
    table = torch.randn(enc.total_params, enc.level_dim, device="cuda") * 0.5
    g = torch.randn(x.shape[0], enc.output_dim, device="cuda")

    got = kernels.grid_encode_cuda_backward(x, g, enc,
                                            table_dtype == "bfloat16")
    tp = table.clone().requires_grad_()
    if case == "identical_points":
        # the same gradient by linearity, without the drift of the plain
        # scatter's sequential f32 sum over 65,536 terms
        n, u = x.shape[0], 2.0 ** -24
        (absolute,) = torch.autograd.grad(
            grid_encode_plain(x[:1], tp, enc, table_dtype), tp,
            g.double().abs().sum(0, keepdim=True).float())
        x, g = x[:1], g.double().sum(0, keepdim=True).float()
    (want,) = torch.autograd.grad(grid_encode_plain(x, tp, enc, table_dtype),
                                  tp, g)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert scale > 0
    if case == "identical_points":
        bound = n * u / (1 - n * u) * absolute + 2 * u * want.abs()
        assert ((got - want).abs() <= bound).all(), \
            ((got - want).abs() / bound.clamp_min(1e-30)).max().item()
        return
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, scale), (err, scale)


# a small tiled grid: levels 0-1 take the identity, 2-3 wrap (mask)
FWD_ENC = dict(num_levels=4, base_resolution=4, log2_hashmap_size=9,
               per_level_scale=1.9, gridtype="tiled")


def _forward_check(x, enc, table_dtype, seed):
    """The forward kernel against the plain version on the same table;
    both read bf16 values and round the weights alike, so f32 sums in
    another order are the only difference."""
    rng = np.random.RandomState(seed)
    table = torch.tensor((rng.randn(enc.total_params, enc.level_dim) * 0.5
                          ).astype(np.float32), device="cuda")
    tk = table if table_dtype is None else table.to(torch.bfloat16)
    kernels.reset_launches()
    got = kernels.grid_encode_cuda(x, tk, enc)
    torch.cuda.synchronize()
    assert kernels.grid_encode_cuda.launches == 1
    assert got.shape == (x.shape[0], enc.output_dim) and got.is_contiguous()
    want = grid_encode_plain(x, table, enc, table_dtype)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("level_dim", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 255, 257, 4097])
def test_cuda_forward_ragged_tiles(n, level_dim, table_dtype):
    """Blocks of 256 points with a partial last one (or a lone point);
    every row width in f32 and bf16 (one vector load per row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    enc = make_grid_encoding(level_dim=level_dim, **FWD_ENC)
    rng = np.random.RandomState(n * 10 + level_dim)
    x = torch.tensor((rng.rand(n, 3) * 1.1 - 0.05).astype(np.float32),
                     device="cuda")
    if n == 1:
        x[0] = 0.3
    _forward_check(x, enc, table_dtype, n + level_dim)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("level_dim", [1, 2])
@pytest.mark.parametrize("num_levels", [1, 3, 5])
def test_cuda_forward_rows_off_16_bytes(num_levels, level_dim, table_dtype):
    """L * C not a multiple of 4: the rows of the output are not 16-byte
    aligned, so the kernel stores scalars; a last chunk of fewer levels
    than the 8 / C a chunk holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    enc = make_grid_encoding(level_dim=level_dim,
                             **dict(FWD_ENC, num_levels=num_levels))
    rng = np.random.RandomState(num_levels * 10 + level_dim)
    x = torch.tensor((rng.rand(777, 3) * 1.1 - 0.05).astype(np.float32),
                     device="cuda")
    _forward_check(x, enc, table_dtype, num_levels)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_cuda_forward_ray_ordered_and_outside_the_box(gridtype, table_dtype):
    """The renderer's order (a warp on 32 samples of one ray), with every
    seventh point moved out of the box: those encode to zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if gridtype == "tiled":     # NGPConfig()'s grid, levels 3-15 wrap
        enc = make_grid_encoding(num_levels=16, level_dim=2,
                                 base_resolution=16, log2_hashmap_size=16,
                                 desired_resolution=8192, gridtype="tiled")
    else:
        enc = make_grid_encoding(num_levels=8, level_dim=2,
                                 base_resolution=16, log2_hashmap_size=14,
                                 gridtype="hash")
    x = _ray_points(512, 64, 6)
    x[::7] = x[::7] * 1.3 - 0.15
    outside = ((x < 0) | (x > 1)).any(-1)
    assert outside.any() and not outside.all()
    got = _forward_check(x, enc, table_dtype, 6)
    assert (got[outside] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [None, "bfloat16"])
def test_cuda_32_levels_of_8(table_dtype):
    """L * C = 256: the backward's staged grad_out tile no longer fits 256
    points in 48 KB of shared memory, so it halves it (to 32 points); the
    forward writes each point's row in 32 chunks of one level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    enc = make_grid_encoding(num_levels=32, level_dim=8, base_resolution=4,
                             log2_hashmap_size=12, per_level_scale=1.2,
                             gridtype="hash")
    rng = np.random.RandomState(8)
    x = torch.tensor((rng.rand(1000, 3) * 1.1 - 0.05).astype(np.float32),
                     device="cuda")
    _forward_check(x, enc, table_dtype, 8)
    g = torch.tensor(rng.randn(1000, enc.output_dim).astype(np.float32),
                     device="cuda")
    got = kernels.grid_encode_cuda_backward(x, g, enc,
                                            table_dtype == "bfloat16")
    tp = torch.zeros(enc.total_params, 8, device="cuda", requires_grad=True)
    (want,) = torch.autograd.grad(grid_encode_plain(x, tp, enc, table_dtype),
                                  tp, g)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("level_dim,dtype", [
    (2, torch.float32), (4, torch.float32), (8, torch.float32),
    (4, torch.bfloat16), (8, torch.bfloat16)])
def test_cuda_forward_refuses_a_misaligned_table(level_dim, dtype):
    """A contiguous view one element into a buffer: the rows' vector loads
    would fault, so the wrapper raises before the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    enc = make_grid_encoding(level_dim=level_dim, **FWD_ENC)
    n = enc.total_params * level_dim
    flat = torch.zeros(n + 8, dtype=dtype, device="cuda")
    table = flat[1:1 + n].view(enc.total_params, level_dim)
    assert table.is_contiguous()
    x = torch.rand(64, 3, device="cuda")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        kernels.grid_encode_cuda(x, table, enc)
    assert kernels.grid_encode_cuda.launches == 0
    kernels.grid_encode_cuda(x, flat[:n].view(enc.total_params, level_dim),
                             enc)


@pytest.mark.cuda
@pytest.mark.parametrize("log2", [9, 12, 16, 19])
@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_cuda_level_plan_matches_its_mirror(gridtype, log2):
    """make_levels' choice of reduction, read back from the built
    library, against kernels/grid_encode.py::level_plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the library builds with nvcc")
    enc = make_grid_encoding(num_levels=16, level_dim=2, base_resolution=16,
                             log2_hashmap_size=log2, gridtype=gridtype,
                             desired_resolution=8192)
    assert kernels.level_plan_cuda(enc) == kernels.level_plan(enc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("table_rows", [8192, 16384, 32768])
@pytest.mark.parametrize("n", [0, 1, 4097, 131072])
def test_row_gather_kernel_matches_index_select(n, table_rows, dtype):
    """K3 against its plain version (one index_select), bit-equal: every
    table size of the JAX micro, an odd N and N = 0 (no launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from sparsefusion_tpu_torch.kernels import row_gather as k3
    from sparsefusion_tpu_torch.ops.row_gather import (
        row_gather,
        row_gather_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(n + table_rows)
    table = torch.randn(table_rows, 128, device="cuda",
                        generator=gen).to(dtype)
    idx = torch.randint(0, table_rows, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    k3.reset_launches()
    got = row_gather(table, idx)
    torch.cuda.synchronize()
    assert k3.row_gather_cuda.launches == (1 if n else 0)
    assert got.shape == (n, 128) and got.dtype == dtype
    assert torch.equal(got, row_gather_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_gather_kernel_zeroes_out_of_range_rows(dtype):
    """An index outside [0, R) reads nothing and gives a row of zeros;
    the other rows are the table's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from sparsefusion_tpu_torch.kernels.row_gather import row_gather_cuda

    table = torch.randn(8192, 128, device="cuda").to(dtype) + 3.0
    idx = torch.randint(0, 8192, (1000,), device="cuda", dtype=torch.int32)
    bad = torch.tensor([0, 17, 500, 999], device="cuda")
    idx[bad] = torch.tensor([-1, 8192, 2 ** 31 - 1, -2 ** 31],
                            device="cuda", dtype=torch.int32)
    got = row_gather_cuda(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got[bad], torch.zeros(4, 128, device="cuda",
                                             dtype=dtype))
    good = torch.ones(1000, dtype=torch.bool, device="cuda")
    good[bad] = False
    assert torch.equal(got[good], table.index_select(0, idx[good]))


@pytest.mark.cuda
def test_row_gather_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sparsefusion_tpu_torch.kernels.row_gather import row_gather_cuda

    table = torch.zeros(64, 128, device="cuda", dtype=torch.bfloat16)
    idx = torch.zeros(8, device="cuda", dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        row_gather_cuda(table, idx.long())
    with pytest.raises(ValueError, match="128"):
        row_gather_cuda(torch.zeros(64, 100, device="cuda"), idx)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(64 * 128 + 8, device="cuda", dtype=torch.bfloat16)
        row_gather_cuda(flat[1:1 + 64 * 128].view(64, 128), idx)
    with pytest.raises(ValueError, match="CUDA"):
        row_gather_cuda(table.cpu(), idx.cpu())


@pytest.mark.cuda
def test_occupancy_on_the_card_matches_the_cpu():
    """density_grid_update (the jitter passed in) and occupancy_near_far
    on the card against the CPU, at the loop's grid (128^3, 3 cascades):
    the grid within 1e-6 relative of its largest value (exp differs by an
    ulp), the bitfield equal but for cells within 1e-6 of the threshold,
    and near/far within 1e-5 relative on every ray but those with a probe
    at a cell face (tools/card_checks.py, which chip_smoke.py also runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sparsefusion_tpu_torch.tools.card_checks import occupancy_card_vs_cpu

    stats, bitfield = occupancy_card_vs_cpu("cuda")
    assert stats["rays_apart_away_from_faces"] == 0
    assert 0 < int(bitfield.sum())


# the scene axis: S scenes of one encoding in one launch (blockIdx.y)
SCENE_CASES = {
    "tiled_f32": (CASES["tiled"][0], None),
    "hash_f32": (CASES["hash"][0], None),
    "tiled_bf16_c4": CASES["tiled_bf16_c4"],
    "ngp_f32": (BWD_CASES["rays_ngp"][0], None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n_scenes", [1, 2, 5])
@pytest.mark.parametrize("case", sorted(SCENE_CASES))
def test_cuda_scene_batched_launch_matches_single_launches(case, n_scenes):
    """One scene-batched launch of each kernel against S single-scene
    launches on the same points and tables: the forward bit-equal (the
    same body on the same rows), the table gradient to the backward's
    tolerance (atomics add in another order); one launch counted for S
    scenes.  A ragged 1000 points a scene (a partial last block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw, table_dtype = SCENE_CASES[case]
    enc = make_grid_encoding(**kw)
    gen = torch.Generator(device="cuda").manual_seed(n_scenes)
    x = torch.rand(n_scenes, 1000, 3, device="cuda", generator=gen) \
        * 1.1 - 0.05
    master = torch.randn(n_scenes, enc.total_params, enc.level_dim,
                         device="cuda", generator=gen) * 0.5
    g = torch.randn(n_scenes, 1000, enc.output_dim, device="cuda",
                    generator=gen)
    bf16 = table_dtype == "bfloat16"
    table = master.to(torch.bfloat16) if bf16 else master
    kernels.reset_launches()
    out = kernels.grid_encode_cuda(x, table, enc)
    gt = kernels.grid_encode_cuda_backward(x, g, enc, bf16)
    torch.cuda.synchronize()
    assert kernels.grid_encode_cuda.launches == 1
    assert kernels.grid_encode_cuda.scenes == n_scenes
    assert kernels.grid_encode_cuda_backward.launches == 1
    assert kernels.grid_encode_cuda_backward.scenes == n_scenes
    assert out.shape == (n_scenes, 1000, enc.output_dim)
    assert gt.shape == master.shape
    for s in range(n_scenes):
        want = kernels.grid_encode_cuda(x[s].contiguous(), table[s], enc)
        want_g = kernels.grid_encode_cuda_backward(x[s].contiguous(), g[s],
                                                   enc, bf16)
        assert torch.equal(out[s], want), s
        scale = want_g.abs().max().item()
        err = (gt[s] - want_g).abs().max().item()
        assert err <= 1e-5 * max(1.0, scale), (s, err, scale)
    # and against the plain scene-batched version
    want = grid_encode_plain(x, master, enc, table_dtype)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_scene_batched_field_step():
    """An NGPFieldStack's forward and backward on the card: one K1 launch
    each for all S scenes, and each scene's gradient equal to its own
    field's (the sigma net's batched matmul against nn.Linear)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPField, \
        NGPFieldStack

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = NGPConfig(num_levels=8, level_dim=4, table_dtype="bfloat16")
    fields = [NGPField(cfg, device="cuda", generator=gen) for _ in range(3)]
    stack = NGPFieldStack(fields)
    x = torch.rand(3, 4096, 3, device="cuda", generator=gen) * 8.0 - 4.0
    kernels.reset_launches()
    sigma, albedo = stack(x)
    (sigma.sum() + albedo.sum()).backward()
    torch.cuda.synchronize()
    assert kernels.grid_encode_cuda.launches == 1
    assert kernels.grid_encode_cuda.launches_bf16 == 1
    assert kernels.grid_encode_cuda_backward.launches == 1
    for s, f in enumerate(fields):
        sg, al = f(x[s])
        (sg.sum() + al.sum()).backward()
        torch.testing.assert_close(sigma[s], sg, rtol=1e-5, atol=1e-6)
        scale = f.grid.grad.abs().max().item()
        err = (stack.grid.grad[s] - f.grid.grad).abs().max().item()
        assert err <= 1e-5 * max(1.0, scale), (s, err)
    with pytest.raises(ValueError, match="table shape"):
        kernels.grid_encode_cuda(x[:2].contiguous(), stack.grid.detach(),
                                 stack.enc)


# ---- the fused loop's CUDA graphs (distill/fused.py) ----------------------

def _tiny_loop(fused, max_itr=6, n_scenes=1):
    """The NGP-only loop at a tiny size; with ``n_scenes`` above 1, that
    many scenes in lockstep (``distill/batched.py``), a result each."""
    from sparsefusion_tpu_torch.data.synthetic import make_synthetic_scene
    from sparsefusion_tpu_torch.distill import batched, loop
    from sparsefusion_tpu_torch.nn.ngp import NGPConfig

    cfg = loop.DistillConfig(
        max_itr=max_itr, n_aug_cameras=2, num_steps=8, upsample_steps=8,
        max_ray_batch=256, ngp=NGPConfig(num_levels=4, log2_hashmap_size=10),
        fused_steps=fused)
    scenes = [make_synthetic_scene(n_views=3, image_size=32, seed=s)
              for s in range(n_scenes)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    if n_scenes > 1:
        return batched.batched_distillation_loop(
            None, scenes, [[0, 1]] * n_scenes, cfg, gen,
            use_diffusion=False, verbose=False)
    return loop.distillation_loop(None, scenes[0], [0, 1], cfg, gen,
                                  use_diffusion=False, verbose=False)


@pytest.mark.cuda
def test_cuda_fused_input_steps_match_the_eager_loop():
    """The NGP-only loop as CUDA graphs (the card's default) against the
    same programs uncaptured (``fused_steps=False``) from one seed: one
    warm-up, then a capture and five replays (the capture's and four
    more); the
    first loss bit-equal (nothing has updated yet), the rest within 1e-3
    relative (K1's backward adds with atomics, in another order in every
    run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    fused, eager = _tiny_loop(None), _tiny_loop(False)
    assert eager["fused"] == {"graphs": False, "warmups": 0, "captures": [],
                              "replays": 0}
    assert fused["fused"]["graphs"] and fused["fused"]["warmups"] == 1
    assert len(fused["fused"]["captures"]) == 1
    assert fused["fused"]["replays"] == 5
    assert fused["losses"][0] == eager["losses"][0]
    np.testing.assert_allclose(fused["losses"], eager["losses"], rtol=1e-3)


@pytest.mark.cuda
def test_cuda_batched_fused_input_steps_match_the_eager_batched_loop():
    """Two scenes in lockstep as CUDA graphs over the scene axis (the
    card's default) against the same programs uncaptured from one seed,
    as the single-scene test holds the loop: one warm-up, a capture and
    five replays; every scene's first loss bit-equal, the rest within
    1e-3 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    fused, eager = _tiny_loop(None, n_scenes=2), _tiny_loop(False, n_scenes=2)
    for f, e in zip(fused, eager):
        assert e["fused"] == {"graphs": False, "warmups": 0, "captures": [],
                              "replays": 0}
        assert f["fused"]["graphs"] and f["fused"]["warmups"] == 1
        assert len(f["fused"]["captures"]) == 1
        assert f["fused"]["replays"] == 5
        assert f["losses"][0] == e["losses"][0]
        np.testing.assert_allclose(f["losses"], e["losses"], rtol=1e-3)
    assert fused[0]["losses"] != fused[1]["losses"]


@pytest.mark.cuda
def test_cuda_replayed_graph_draws_the_eager_numbers():
    """A graph of the renderer's, the ray subset's and the sampler's draws
    gives, at each replay, the numbers the eager calls give from the same
    generator state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from sparsefusion_tpu_torch.distill.fused import GraphRunner

    dev = torch.device("cuda")
    gens = [torch.Generator(device=dev).manual_seed(4) for _ in range(2)]

    def draw(g):
        return [torch.rand((256, 8), generator=g, device=dev),
                torch.randint(0, 256, (64,), generator=g, device=dev),
                torch.randn((1, 4, 4, 4), generator=g, device=dev)]

    bufs = [torch.zeros_like(t) for t in draw(torch.Generator(device=dev))]

    def program():
        for buf, value in zip(bufs, draw(gens[0])):
            buf.copy_(value)

    runner = GraphRunner(dev, gens[0], [])
    for i in range(4):
        runner.run(("draws",), program, i)
        assert all(torch.equal(b, w) for b, w in zip(bufs, draw(gens[1])))
    assert (runner.warmups, len(runner.captures), runner.replays) == (1, 1, 3)


@pytest.mark.cuda
def test_cuda_graph_replays_count_their_launches():
    """K1's launch counter counts each replay's launch, not the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from sparsefusion_tpu_torch.distill.fused import (
        GraphRunner,
        launch_counters,
    )

    dev = torch.device("cuda")
    enc = make_grid_encoding(**CASES["hash"][0])
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((4096, 3), generator=gen, device=dev)
    table = torch.rand((enc.total_params, enc.level_dim), generator=gen,
                       device=dev)
    out = torch.zeros((4096, enc.output_dim), device=dev)

    def program():
        out.copy_(grid_encode(x, table, enc))

    runner = GraphRunner(dev, gen, launch_counters())
    kernels.reset_launches()
    for i in range(5):
        runner.run(("encode",), program, i)
    torch.cuda.synchronize()
    assert kernels.grid_encode_cuda.launches == 5
    assert runner.replays == 4
    torch.testing.assert_close(out, grid_encode_plain(x.cpu(), table.cpu(),
                                                      enc).cuda())


@pytest.mark.cuda
def test_cuda_failed_capture_raises():
    """A program that reads a value on the host cannot be captured: the
    capture raises, with no eager fallback.  In a process of its own: a
    failed capture leaves the CUDA generators registered with it in
    capture mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import torch
        from sparsefusion_tpu_torch.distill.fused import GraphRunner

        dev = torch.device("cuda")
        x = torch.ones(8, device=dev)
        runner = GraphRunner(dev, torch.Generator(device=dev), [])

        def program():
            if x.sum().item() < 0:
                x.zero_()

        runner.run(("host read",), program, 0)     # eager: fine
        try:
            runner.run(("host read",), program, 1)
        except RuntimeError as e:
            assert runner.replays == 0
            assert torch.cuda.current_stream(dev) == \\
                torch.cuda.default_stream(dev)
            print("raised:", type(e).__name__)
        else:
            raise SystemExit("the capture did not raise")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "raised:" in out.stdout, \
        out.stdout + out.stderr
