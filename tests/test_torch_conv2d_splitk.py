"""K4, the split-K convolution kernel (``csrc/conv2d_splitk.cu``,
``kernels/conv2d.py``): its arithmetic emulated on the CPU, its plan, its
routing, and on a CUDA card the kernel itself.

The kernel runs a convolution as an implicit GEMM with the output
channels on ``wgmma``'s 64 rows, the output pixels (M = B*Ho*Wo) on its
columns and K = C_in*kh*kw cut into the plan's S splits of whole 32-wide
blocks, one CTA of a thread-block cluster each.  In each CTA two
warpgroups take the split's blocks in turn (even, odd); each block is
four 8-deep steps of three TF32 products with f32 accumulation, every
operand split once as x = big + small (3xTF32, as K2:
``test_torch_attention_tf32split.py``; here big rounds to nearest and
small toward zero), summed into a fresh partial that is added to the
warpgroup's accumulator; the warpgroups' sums add (warpgroup 0's first),
then the S partial tiles in rank order 0..S-1, then the bias.
:func:`emulated_conv2d` repeats that arithmetic in PyTorch at the UNets'
batch-1 shapes with their channels cut: within 1e-5 of float64 and of
``F.conv2d``, where one TF32 pass is not.

The card tests (marker ``cuda``) skip without a card; this file imports
no jax, so ``python -m pytest --noconftest tests/test_torch_conv2d_splitk.py``
runs them on a machine without JAX.
"""
import functools
import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparsefusion_tpu_torch.kernels import conv2d as k4
from sparsefusion_tpu_torch.nn import layers
from sparsefusion_tpu_torch.ops.conv2d import conv2d_plain
from sparsefusion_tpu_torch.utils import spans

torch.set_num_threads(2)
TOL = 1e-5
# the kernel's consumer warpgroups: where a tile has 64 output channels
# each takes every K_GROUPS-th 32-wide K block of its split (at 128, each
# takes every block for its 64 channels)
K_GROUPS = 2
# no-grad convolutions of one evaluation of the full-width UNet
# (``UNetConfig()``): K4's launches in each ``unet`` span
UNET_CONVS = 133
# ... and of Zero-1-to-3's UNet (``Zero123Config()``)
Z123_CONVS = 98

# (x shape, weight shape, stride, padding): the UNets' batch-1 shapes with
# channels cut: the 15x15 stem, a 3x3 at M = 16 (4x4) and at M = 1024
# (32x32, 5 splits over 4.5 K blocks), the 4x4 stride-2 downsample; then
# Zero123's: a 1x1 projection at M = 64, the stride-2 3x3 into 16x16,
# CLIP's 14x14 stride-14 patch embedding
EMULATED = [((1, 8, 32, 32), (16, 8, 15, 15), 1, 7),
            ((1, 64, 4, 4), (64, 64, 3, 3), 1, 1),
            ((1, 16, 32, 32), (32, 16, 3, 3), 1, 1),
            ((1, 32, 16, 16), (64, 32, 4, 4), 2, 1),
            ((1, 96, 8, 8), (80, 96, 1, 1), 1, 0),
            ((1, 24, 32, 32), (40, 24, 3, 3), 2, 1),
            ((1, 3, 56, 56), (72, 3, 14, 14), 14, 0)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, nearest with ties away (the kernel's
    ``split_int``: the bits plus half a TF32 ulp, the low 13 cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f32 to TF32 toward zero: the low 13 bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> f32, rounded toward zero."""
    y = x64.float()
    return torch.where(y.double().abs() > x64.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _mma(acc, a, b, passes, toward_zero=False):
    """acc += a @ b over one 8-wide step, in ``passes`` TF32 products,
    the small ones first; ``toward_zero``: each product added as the
    tensor cores add it, exactly and then rounded toward zero."""
    a_big, b_big = tf32(a), tf32(b)
    terms = [(a_big, b_big)]
    if passes == 3:
        terms = [(tf32_toward_zero(a - a_big), b_big),
                 (a_big, tf32_toward_zero(b - b_big))] + terms
    for ta, tb in terms:
        if toward_zero:
            acc = _toward_zero(acc.double() + ta.double() @ tb.double())
        else:
            acc = acc + ta @ tb
    return acc


def emulated_conv2d(x, w, bias, stride, padding, passes=3,
                    toward_zero=False, block_partials=True):
    """K4's arithmetic on f32 CPU tensors, by the plan's splits: in each
    split, warpgroup g takes the split's blocks g, g + K_GROUPS, ... (every
    block where the plan's tiles have 128 channels); each
    32-wide block's four 8-deep steps summed into a fresh partial and
    added to the warpgroup's accumulator in f32 (``block_partials``; else
    every step into the accumulator), the warpgroups' sums added (group
    0's first), the splits' sums added in rank order, then the bias."""
    b, _, h, wd = x.shape
    cout, _, kh, kw = w.shape
    ho = k4.out_size(h, kh, stride, padding)
    wo = k4.out_size(wd, kw, stride, padding)
    # implicit im2col: (B*Ho*Wo, K), K in the weight's (c, ky, kx) order
    a = F.unfold(x, (kh, kw), padding=padding, stride=stride)
    a = a.transpose(1, 2).reshape(b * ho * wo, -1)
    wm = w.reshape(cout, -1)
    m, k = a.shape
    p = k4.plan(m, cout, k)
    groups = K_GROUPS if p.tile_channels == 64 else 1
    blocks = math.ceil(k / k4.K_BLOCK)
    parts = []
    for s in range(p.splits):
        kb0, kb1 = s * blocks // p.splits, (s + 1) * blocks // p.splits
        accs = [torch.zeros(m, cout) for _ in range(groups)]
        for kb in range(kb0, kb1):
            group = (kb - kb0) % groups
            acc = accs[group]
            part = torch.zeros(m, cout) if block_partials else acc
            k0 = kb * k4.K_BLOCK
            for kk in range(k0, min(k, k0 + k4.K_BLOCK), 8):
                part = _mma(part, a[:, kk:kk + 8], wm[:, kk:kk + 8].T,
                            passes, toward_zero)
            accs[group] = acc + part if block_partials else part
        total = accs[0]
        for acc in accs[1:]:
            total = total + acc
        parts.append(total)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    if bias is not None:
        out = out + bias
    return out.reshape(b, ho * wo, cout).transpose(1, 2).reshape(
        b, cout, ho, wo)


def _conv_inputs(xs, ws, seed=0):
    rng = np.random.RandomState(seed)
    k = ws[1] * ws[2] * ws[3]
    x = torch.tensor(rng.randn(*xs).astype(np.float32))
    w = torch.tensor((rng.randn(*ws) / math.sqrt(k)).astype(np.float32))
    bias = torch.tensor(rng.randn(ws[0]).astype(np.float32))
    return x, w, bias


def _case_id(case):
    xs, ws, s, p = case
    return f"{ws[2]}x{ws[3]}s{s}_M{xs[2]}x{xs[3]}_K{ws[1] * ws[2] * ws[3]}"


@pytest.mark.parametrize("case", EMULATED, ids=_case_id)
def test_3xtf32_split_k_meets_f32_tolerance(case):
    xs, ws, stride, padding = case
    x, w, bias = _conv_inputs(xs, ws)
    got = emulated_conv2d(x, w, bias, stride, padding, toward_zero=True)
    want64 = F.conv2d(x.double(), w.double(), bias.double(), stride, padding)
    err64 = (got.double() - want64).abs().max().item()
    err_plain = (got - conv2d_plain(x, w, bias, stride, padding)
                 ).abs().max().item()
    assert err64 <= TOL / 4, err64
    assert err_plain <= TOL, err_plain


def test_block_partials_hold_the_tensor_cores_rounding():
    """The 4x4 level's 3x3 at its full depth (K = 9216, 8 splits of 36
    blocks; output channels cut to 64): with every product added toward
    zero, as the tensor cores add, one accumulator over a warpgroup's 72
    steps of a split leaves the f32 tolerance, and a fresh partial each
    32-wide block keeps within it."""
    x, w, bias = _conv_inputs((1, 1024, 4, 4), (64, 1024, 3, 3))
    want64 = F.conv2d(x.double(), w.double(), bias.double(), 1, 1)

    def err(block_partials):
        got = emulated_conv2d(x, w, bias, 1, 1, toward_zero=True,
                              block_partials=block_partials)
        return (got.double() - want64).abs().max().item()

    assert err(True) <= TOL / 4
    assert err(False) > TOL


@pytest.mark.parametrize("case", EMULATED, ids=_case_id)
def test_single_pass_tf32_misses_f32_tolerance(case):
    xs, ws, stride, padding = case
    x, w, bias = _conv_inputs(xs, ws)
    got = emulated_conv2d(x, w, bias, stride, padding, passes=1)
    want64 = F.conv2d(x.double(), w.double(), bias.double(), stride, padding)
    assert (got.double() - want64).abs().max().item() > 10 * TOL


@functools.lru_cache(maxsize=None)
def unet_conv_calls(batch: int, unet: str = "vldm"):
    """Every convolution call of one no-grad evaluation at ``batch``, in
    order: (x shape, weight shape, stride, padding), traced on the meta
    device.  ``unet``: "vldm", the full-width UNet at the sampler's 32 x 32
    latent and 256 feature channels; "z123", Zero-1-to-3's UNet at its 8 x
    32 x 32 input and one 768-wide context token; "clip", CLIP ViT-L/14's
    image tower (its patch embedding) at 224 x 224."""
    from sparsefusion_tpu_torch.nn.unet import EfficientUNet, UNetConfig
    from sparsefusion_tpu_torch.nn.zero123 import (CLIPImageEncoder,
                                                   Zero123UNet)

    def meta(*shape):
        return torch.empty(*shape, device="meta")

    with torch.device("meta"):
        model, args = {
            "vldm": lambda: (EfficientUNet(UNetConfig()), (
                meta(batch, 4, 32, 32), meta(batch),
                meta(batch, 256, 32, 32))),
            "z123": lambda: (Zero123UNet(), (
                meta(batch, 8, 32, 32), meta(batch), meta(batch, 1, 768))),
            "clip": lambda: (CLIPImageEncoder(),
                             (meta(batch, 3, 224, 224),)),
        }[unet]()
    calls = []

    def hook(module, inputs, _):
        calls.append((tuple(inputs[0].shape), tuple(module.weight.shape),
                      module.stride, module.padding))

    for m in model.modules():
        if isinstance(m, layers.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(*args)
    return tuple(calls)


def _gemm(call):
    (b, cin, h, w), (cout, _, kh, kw), (sh, sw), (ph, pw) = call
    m = b * k4.out_size(h, kh, sh, ph) * k4.out_size(w, kw, sw, pw)
    return m, cout, cin * kh * kw


def test_unet_convolutions_are_counted():
    calls = unet_conv_calls(1)
    assert len(calls) == UNET_CONVS
    # the batch-1 GEMMs of the 4x4 and 8x8 levels, the 32x32 3x3 and the
    # 15x15 stem, among the calls
    gemms = {_gemm(c) for c in calls}
    assert {(16, 1024, 9216), (64, 1024, 13824), (1024, 256, 2304),
            (1024, 64, 58500)} <= gemms
    # Zero123's: the 32x32 3x3 320 -> 320, the 4x4 skip concatenation
    # 2560 -> 1280, a 1x1 projection at 8x8; CLIP's patch embedding
    z123 = unet_conv_calls(1, "z123")
    assert len(z123) == Z123_CONVS
    assert {(1024, 320, 2880), (16, 1280, 23040), (64, 1280, 1280)} <= {
        _gemm(c) for c in z123}
    assert {_gemm(c) for c in unet_conv_calls(1, "clip")} == {
        (256, 1024, 588)}


@pytest.mark.parametrize("batch", [1, 4])
def test_plan_covers_the_card_in_one_wave(batch):
    """At every distinct convolution of both UNets and CLIP's patch
    embedding at ``batch``: at most 8 splits (the portable cluster size)
    and at most K's blocks; all clusters in one wave of the card's
    cluster occupancy (:data:`H100_CLUSTERS`) unless the tiles alone
    exceed it, and the most splits that allows; a tile's pixels one of the
    instances, the least that holds M, else 64; its channels 128 where M
    and N pass 64 (the products bound those), else 64; one split where the
    tiles alone fill the card."""
    clusters = k4.H100_CLUSTERS
    shapes = {_gemm(c) for unet in ("vldm", "z123", "clip")
              for c in unet_conv_calls(batch, unet)}
    for m, n, k in sorted(shapes):
        p = k4.plan(m, n, k)
        tiles = p.grid[1] * p.grid[2]
        assert p.grid == (p.splits, math.ceil(n / p.tile_channels),
                          math.ceil(m / p.tile_pixels))
        assert p.tile_channels == (128 if m > 64 and n > 64 else 64)
        cap = min(k4.MAX_SPLITS, math.ceil(k / k4.K_BLOCK))
        assert 1 <= p.splits <= cap, (m, n, k, p)
        assert tiles <= clusters[p.splits - 1] or p.splits == 1, (m, n, k, p)
        assert p.splits == cap or tiles > clusters[p.splits], (m, n, k, p)
        assert p.tile_pixels in k4.TILE_PIXELS, (m, n, k, p)
        if m <= 64:
            assert p.tile_pixels // 2 < m or p.tile_pixels == 8, (m, n, k, p)
        else:
            assert p.tile_pixels == 64, (m, n, k, p)
        if tiles >= clusters[0]:
            assert p.splits == 1, (m, n, k, p)


def test_plan_at_the_main_shapes():
    """The 4x4 level: 16 tiles of 64 channels by 16 pixels, 6 splits (16
    clusters of 7 or 8 CTAs would take two waves); the 8x8 up block: 16
    tiles of 64 pixels, 6 splits; the 32x32 3x3: 2 x 16 tiles of 128
    channels by 64 pixels, 3 splits; the 15x15 stem (64 channels): 16
    tiles of 64 pixels, 6 splits; batch 4 at 32x32: 2 x 64 tiles, one
    split; Zero123's 4x4 skip convolution: 20 tiles, 5 splits; its 32x32
    3x3: 3 x 16 tiles of 128 channels, 2 splits; CLIP's patch embedding: 8
    x 4 tiles, 3 splits; a one-pixel 1x1: an 8-pixel tile."""
    assert k4.plan(16, 1024, 9216) == k4.SplitKPlan(16, 6, (6, 16, 1))
    assert k4.plan(64, 1024, 13824) == k4.SplitKPlan(64, 6, (6, 16, 1))
    assert k4.plan(1024, 256, 2304) == k4.SplitKPlan(64, 3, (3, 2, 16), 128)
    assert k4.plan(1024, 64, 58500) == k4.SplitKPlan(64, 6, (6, 1, 16))
    assert k4.plan(4096, 256, 2304) == k4.SplitKPlan(64, 1, (1, 2, 64), 128)
    assert k4.plan(16, 1280, 23040) == k4.SplitKPlan(16, 5, (5, 20, 1))
    assert k4.plan(1024, 320, 2880) == k4.SplitKPlan(64, 2, (2, 3, 16), 128)
    assert k4.plan(256, 1024, 588) == k4.SplitKPlan(64, 3, (3, 8, 4), 128)
    assert k4.plan(1, 1024, 512) == k4.SplitKPlan(8, 6, (6, 16, 1))
    # never more splits than K blocks
    assert k4.plan(1, 128, 64).splits == 2
    # a card that runs every cluster size 132 times: 8 splits, 128 CTAs
    assert k4.plan(16, 1024, 9216, (132,) * 8) == k4.SplitKPlan(
        16, 8, (8, 16, 1))


def _stand_in(is_cuda=True, dtype=torch.float32, requires_grad=False):
    """A tensor's routing attributes, for the rule without a card."""
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                 requires_grad=requires_grad)


def test_routing_rule():
    x, w = _stand_in(), _stand_in()
    with torch.no_grad():
        assert k4.takes_kernel(x, w)
        assert not k4.takes_kernel(_stand_in(is_cuda=False), w)
        assert not k4.takes_kernel(_stand_in(dtype=torch.bfloat16),
                                   _stand_in(dtype=torch.bfloat16))
        assert not k4.takes_kernel(x, w, groups=2)
        assert not k4.takes_kernel(x, w, dilation=2)
        assert not k4.takes_kernel(x, w, padding="same")
    with torch.enable_grad():
        # grad mode alone does not need a gradient: nothing requires one
        assert k4.takes_kernel(x, w)
        assert not k4.takes_kernel(x, _stand_in(requires_grad=True))
        assert not k4.takes_kernel(_stand_in(requires_grad=True), w)
        assert not k4.takes_kernel(x, w, _stand_in(requires_grad=True))


def test_cpu_conv2d_is_the_plain_version():
    conv = layers.Conv2d(6, 5, 3, stride=2, padding=1)
    x = torch.randn(2, 6, 9, 9)
    k4.reset_launches()
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            got = conv(x)
        assert torch.equal(got, F.conv2d(x, conv.weight, conv.bias, 2, 1))
    assert k4.conv2d_splitk_cuda.launches == 0


def test_conv2d_module_routes_to_the_kernel(monkeypatch):
    """Where the rule holds, ``layers.Conv2d`` hands the kernel its cast
    input, weight, bias, stride and padding, and returns its output."""
    seen = []

    def fake_kernel(x, weight, bias, stride, padding):
        seen.append((x, weight, bias, stride, padding))
        return "k4"

    monkeypatch.setattr(k4, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(k4, "conv2d_splitk_cuda", fake_kernel)
    conv = layers.Conv2d(4, 8, 4, stride=2, padding=1)
    x = torch.randn(1, 4, 8, 8)
    assert conv(x) == "k4"
    (xs, ws, bs, stride, padding), = seen
    assert xs is x and ws is conv.weight and bs is conv.bias
    assert (stride, padding) == ((2, 2), (1, 1))


def test_spans_line_reports_k4_launches():
    lines = []
    spans.enable(report=lines.append)
    try:
        for i in range(2):
            with spans.unit("distill/iteration", i):
                with spans.span("unet", unet_batch=1):
                    spans.count("k4_launches", UNET_CONVS)
                if i == 1:
                    with spans.span("loss_read"):
                        spans.sync_point()
    finally:
        spans.disable()
    assert f"unet 1.00/unit at batch 1, {UNET_CONVS} K4 launches each" \
        in lines[-1], lines


# ---- on a CUDA card ------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.fixture
def full_f32():
    """cuDNN and matmuls in full f32 (TF32 off, as the entry points set
    them) and cudnn.benchmark off, as the port runs; restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.benchmark) = before


def _card_inputs(call, gen):
    xs, ws, _, _ = call
    k = ws[1] * ws[2] * ws[3]
    x = torch.randn(*xs, device="cuda", generator=gen)
    w = torch.randn(*ws, device="cuda", generator=gen) / math.sqrt(k)
    bias = torch.randn(ws[0], device="cuda", generator=gen)
    return x, w, bias


def _check_against_plain(got, x, w, bias, stride, padding):
    """K4 within 1e-5 of the plain version in float64, and of the plain
    version in f32 within 1e-5 beyond the f32 plain version's own distance
    from float64 (cuDNN's f32 sums over K = 58,500 read 4e-5 from it, K4's
    2e-6).  Returns the three largest errors."""
    want = conv2d_plain(x, w, bias, stride, padding)
    want64 = conv2d_plain(x.double(), w.double(),
                          None if bias is None else bias.double(), stride,
                          padding)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err64 = (got.double() - want64).abs().max().item()
    err = (got - want).abs().max().item()
    plain64 = (want.double() - want64).abs().max().item()
    assert err64 <= TOL and err <= TOL + plain64, (err64, err, plain64)
    return err64, err, plain64


@pytest.mark.cuda
@pytest.mark.parametrize("unet,batch", [("vldm", 1), ("vldm", 4),
                                        ("z123", 1), ("z123", 4),
                                        ("clip", 1)])
def test_kernel_matches_plain_at_every_unet_shape(unet, batch, full_f32):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(batch)
    for call in sorted(set(unet_conv_calls(batch, unet))):
        x, w, bias = _card_inputs(call, gen)
        _, _, stride, padding = call
        got = k4.conv2d_splitk_cuda(x, w, bias, stride, padding)
        _check_against_plain(got, x, w, bias, stride, padding)


@pytest.mark.cuda
def test_kernel_ragged_shapes(full_f32):
    """Shapes off every tile: odd channels (K % 4 != 0: the producer copies
    the weight tiles itself, without TMA), a bias-free call, stride 2 with
    odd sizes, a non-contiguous input."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [((3, 5, 11, 13), (7, 5, 3, 3), 1, 1, True),
             ((2, 9, 7, 7), (70, 9, 1, 1), 1, 0, False),
             ((1, 12, 9, 9), (33, 12, 4, 4), 2, 1, True),
             ((2, 20, 6, 10), (130, 20, 5, 3), (1, 2), (2, 1), True)]
    for xs, ws, stride, padding, with_bias in cases:
        x, w, bias = _card_inputs((xs, ws, stride, padding), gen)
        bias = bias if with_bias else None
        for xin in (x, x.transpose(2, 3).contiguous().transpose(2, 3)):
            got = k4.conv2d_splitk_cuda(xin, w, bias, stride, padding)
            _check_against_plain(got, x, w, bias, stride, padding)


@pytest.mark.cuda
def test_every_instance_and_split_count(full_f32):
    """One convolution (the 4x4 stride-2 downsample into 8x8, K = 4096)
    under every instance (each tile width at 64 channels, and 128 channels
    by 64 pixels) and 1, 3, 5 and 8 splits (uneven shares of K's 128
    blocks, odd block counts for the two warpgroups, partial tiles split
    unevenly over the cluster)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    call = ((1, 256, 16, 16), (200, 256, 4, 4), 2, 1)
    x, w, bias = _card_inputs(call, gen)
    m, n = 64, 200
    for pixels, rows in k4.INSTANCES:
        for splits in (1, 3, 5, 8):
            p = k4.SplitKPlan(pixels, splits, (
                splits, math.ceil(n / rows), math.ceil(m / pixels)), rows)
            got = k4.conv2d_splitk_cuda(x, w, bias, 2, 1, run_plan=p)
            _check_against_plain(got, x, w, bias, 2, 1)


@pytest.mark.cuda
def test_two_launches_are_bit_equal(full_f32):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for call in (((1, 1024, 4, 4), (1024, 1024, 3, 3), (1, 1), (1, 1)),
                 ((1, 260, 32, 32), (64, 260, 15, 15), (1, 1), (7, 7))):
        x, w, bias = _card_inputs(call, gen)
        a = k4.conv2d_splitk_cuda(x, w, bias, call[2], call[3])
        b = k4.conv2d_splitk_cuda(x, w, bias, call[2], call[3])
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    _need_card()
    x = torch.randn(1, 4, 8, 8, device="cuda")
    w = torch.randn(8, 4, 3, 3, device="cuda")
    for args in ((x.bfloat16(), w.bfloat16()), (x.cpu(), w),
                 (x, w[:, :2])):
        with pytest.raises(ValueError):
            k4.conv2d_splitk_cuda(*args)


def _unet(gen, unet="vldm"):
    if unet == "z123":
        from sparsefusion_tpu_torch.models import _lecun_
        from sparsefusion_tpu_torch.nn.zero123 import Zero123UNet

        with torch.device("meta"):
            model = Zero123UNet()
        model = model.to_empty(device="cuda").eval()
        _lecun_(model, gen)
        return model
    from sparsefusion_tpu_torch.nn.unet import EfficientUNet, UNetConfig

    model = EfficientUNet(UNetConfig()).cuda()
    model.init_weights_(gen)
    with torch.no_grad():   # a zero final conv would hide the UNet
        model.final_conv.weight.normal_(0.0, 0.05, generator=gen)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("unet,convs", [("vldm", UNET_CONVS),
                                        ("z123", Z123_CONVS)])
def test_unet_forward_through_k4_matches_cudnn(unet, convs, full_f32):
    """One batch-1 evaluation as the sampler makes it: every convolution
    through K4, counted once a call by the launch counter and the spans'
    ``k4_launches``; the same evaluation with a gradient
    (cuDNN) agrees within f32 rounding (relative 1e-4, as the captured
    loop's losses are held to the uncaptured programs' in
    ``chip_smoke.py``)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = _unet(gen, unet)
    if unet == "z123":
        args = (torch.randn(1, 8, 32, 32, device="cuda", generator=gen),
                torch.full((1,), 500.0, device="cuda"),
                torch.randn(1, 1, 768, device="cuda", generator=gen))
    else:
        args = (torch.randn(1, 4, 32, 32, device="cuda", generator=gen),
                torch.full((1,), 0.5, device="cuda"),
                torch.randn(1, 256, 32, 32, device="cuda", generator=gen))
    k4.reset_launches()
    spans.enable()
    try:
        with spans.unit("distill/iteration", 0):
            with spans.span("unet", unet_batch=1), torch.no_grad():
                got = model(*args)
        torch.cuda.synchronize()
        snap = spans.snapshot()
    finally:
        spans.disable()
    assert k4.conv2d_splitk_cuda.launches == convs
    # each launch counts to the innermost open span: this evaluation's
    # ``unet`` span, or Zero123's spatial transformers (``st``) inside it
    # for their 1x1 projections
    first = [s for s in snap if s["name"] == "unet"][-1]["id"]
    assert sum((s.get("counts") or {}).get("k4_launches", 0)
               for s in snap if s["id"] >= first) == convs
    want = model(*args)   # parameters require grad: cuDNN
    assert k4.conv2d_splitk_cuda.launches == convs
    # cuDNN's f32 convolutions are themselves up to 4e-5 from float64
    rel = ((got - want.detach()).norm() / want.norm()).item()
    assert rel <= 1e-4, rel
