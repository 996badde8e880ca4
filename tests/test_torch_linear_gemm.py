"""K5, the linears' 3xTF32 GEMM kernel (``csrc/linear_gemm.cu``,
``kernels/linear.py``): its routing, its plan, Zero-1-to-3's modules that
call it and its arithmetic emulated on the CPU; on a CUDA card the kernel
itself.

The kernel computes y = x W^T + b with the output features on ``wgmma``'s
64 rows and the tokens on its columns, K cut into the plan's S splits of
whole 32-wide blocks, one CTA of a thread-block cluster each.  Where a tile
has 64 features the two consumer warpgroups take a split's blocks in turn
(even, odd), at 128 each takes every block for its 64; each block is four
8-deep steps of three TF32 products (weight small x token big, weight big x
token small, weight big x token big) summed into a fresh partial that is
added to the warpgroup's accumulator; the warpgroups' sums add (warpgroup
0's first), then the S partials in rank order 0..S-1, then the bias.
:func:`emulated_linear` repeats that arithmetic in PyTorch.

The card tests (marker ``cuda``) skip without a card; this file imports
no jax, so ``python -m pytest --noconftest tests/test_torch_linear_gemm.py``
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
from sparsefusion_tpu_torch.kernels import linear as k5
from sparsefusion_tpu_torch.nn import zero123
from sparsefusion_tpu_torch.utils import spans

torch.set_num_threads(2)
TOL = 1e-5
# Zero-1-to-3's transformer linears at batch 1, (T, N, K): the
# self-attention's four projections, the GEGLU projection and the
# feed-forward's output at 1024 tokens of 320, 256 of 640, 64 of 1280 and
# the middle block's 16 of 1280
Z123_SHAPES = {(t, n, k) for t, c in ((1024, 320), (256, 640), (64, 1280),
                                      (16, 1280))
               for n, k in ((c, c), (8 * c, c), (c, 4 * c))}
# the routed linears of one evaluation: 6 in each of 16 transformers
Z123_LINEARS = 96


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, nearest with ties away (the kernel's
    ``split_int``: the bits plus half a TF32 ulp, the low 13 cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f32 to TF32 toward zero: the low 13 bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> f32, rounded toward zero, as the tensor cores add."""
    y = x64.float()
    return torch.where(y.double().abs() > x64.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def emulated_linear(x, w, bias, p: k5.LinearPlan, passes=3):
    """K5's arithmetic on f32 CPU tensors (T, K), (N, K), (N,) under plan
    ``p``: each product of an 8-deep step added exactly and rounded toward
    zero, in the kernel's order."""
    t, k = x.shape
    blocks = math.ceil(k / k5.K_BLOCK)
    groups = 2 if p.tile_rows == 64 else 1

    def step(part, xs, ws):
        w_big, x_big = tf32(ws), tf32(xs)
        terms = [(x_big, w_big)]
        if passes == 3:
            terms = [(x_big, tf32_toward_zero(ws - w_big)),
                     (tf32_toward_zero(xs - x_big), w_big)] + terms
        for tx, tw in terms:
            part = _toward_zero(part.double() + tx.double() @ tw.double().T)
        return part

    out = None
    for s in range(p.splits):
        kb0, kb1 = s * blocks // p.splits, (s + 1) * blocks // p.splits
        accs = [torch.zeros(t, w.shape[0]) for _ in range(groups)]
        for kb in range(kb0, kb1):
            part = torch.zeros(t, w.shape[0])
            for kk in range(kb * k5.K_BLOCK,
                            min(k, (kb + 1) * k5.K_BLOCK), 8):
                part = step(part, x[:, kk:kk + 8], w[:, kk:kk + 8])
            g = (kb - kb0) % groups
            accs[g] = accs[g] + part
        total = accs[0] if groups == 1 else accs[0] + accs[1]
        out = total if out is None else out + total
    return out if bias is None else out + bias


def _inputs(t, n, k, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(t, k).astype(np.float32))
    w = torch.tensor((rng.randn(n, k) / math.sqrt(k)).astype(np.float32))
    bias = torch.tensor(rng.randn(n).astype(np.float32))
    return x, w, bias


# Zero123's shapes with the features cut, under their plans' splits and
# rows: T 64 at 64 features (two groups in turn), T 256 at 128 (one), the
# middle block's 16 tokens with K = 5120 over 8 splits
EMULATED = [(64, 72, 1280, 64, 5), (256, 136, 640, 128, 2),
            (16, 64, 5120, 64, 8), (1024, 8, 320, 128, 1)]


def _emulated_id(case):
    t, n, k, rows, s = case
    return f"T{t}_N{n}_K{k}_rows{rows}_S{s}"


def _plan_for(case):
    t, n, k, rows, s = case
    bn = next((b for b in k5.TILE_TOKENS if b >= t), 64)
    return k5.LinearPlan(bn, rows, s, 1)


@pytest.mark.parametrize("case", EMULATED, ids=_emulated_id)
def test_3xtf32_split_k_meets_f32_tolerance(case):
    t, n, k = case[:3]
    x, w, bias = _inputs(t, n, k)
    got = emulated_linear(x, w, bias, _plan_for(case))
    want64 = F.linear(x.double(), w.double(), bias.double())
    assert (got.double() - want64).abs().max().item() <= TOL / 4
    assert (got - F.linear(x, w, bias)).abs().max().item() <= TOL


@pytest.mark.parametrize("case", EMULATED, ids=_emulated_id)
def test_single_pass_tf32_misses_f32_tolerance(case):
    t, n, k = case[:3]
    x, w, bias = _inputs(t, n, k)
    got = emulated_linear(x, w, bias, _plan_for(case), passes=1)
    want64 = F.linear(x.double(), w.double(), bias.double())
    assert (got.double() - want64).abs().max().item() > 10 * TOL


def _stand_in(shape=(1, 16, 320), is_cuda=True, dtype=torch.float32,
              requires_grad=False):
    """A tensor's routing attributes, for the rule without a card."""
    return types.SimpleNamespace(shape=shape, is_cuda=is_cuda, dtype=dtype,
                                 requires_grad=requires_grad)


def test_routing_rule():
    w = _stand_in((640, 320))
    with torch.no_grad():
        assert k5.takes_kernel(_stand_in(), w)
        assert k5.takes_kernel(_stand_in((8, 320)), w)
        assert k5.takes_kernel(_stand_in((2, 4, 320)), w)
        # below wgmma's narrowest N: the one-row context projections
        assert not k5.takes_kernel(_stand_in((1, 1, 320)), w)
        assert not k5.takes_kernel(_stand_in((7, 320)), w)
        # K % 4 != 0: TMA's rows are 16 bytes
        assert not k5.takes_kernel(_stand_in((64, 322)), _stand_in((8, 322)))
        assert not k5.takes_kernel(_stand_in(is_cuda=False), w)
        assert not k5.takes_kernel(_stand_in(dtype=torch.bfloat16),
                                   _stand_in((640, 320), dtype=torch.bfloat16))
    with torch.enable_grad():
        # grad mode alone does not need a gradient: nothing requires one
        assert k5.takes_kernel(_stand_in(), w)
        assert not k5.takes_kernel(_stand_in(), _stand_in(
            (640, 320), requires_grad=True))
        assert not k5.takes_kernel(_stand_in(requires_grad=True), w)
        assert not k5.takes_kernel(_stand_in(), w,
                                   _stand_in((640,), requires_grad=True))


def test_cpu_linear_is_f_linear():
    """On the CPU ``linear`` and ``zero123.Linear`` are ``F.linear`` bit
    for bit, with and without a bias and a gradient, and launch nothing."""
    k5.reset_launches()
    x = torch.randn(2, 24, 40)
    for bias in (True, False):
        lin = zero123.Linear(40, 56, bias=bias)
        for grad in (False, True):
            with torch.set_grad_enabled(grad):
                want = F.linear(x, lin.weight, lin.bias)
                assert torch.equal(lin(x), want)
                assert torch.equal(k5.linear(x, lin.weight, lin.bias), want)
    assert k5.linear_gemm_cuda.launches == 0


def _small_block():
    torch.manual_seed(0)
    return zero123.BasicTransformerBlock(32, 4, 8, 24)


def test_zero123_modules_route_to_the_kernel(monkeypatch):
    """Each of a transformer block's linears hands ``kernels/linear.py::
    linear`` its input, weight and bias, and uses what it returns: the
    self-attention's four projections, the GEGLU projection and the
    feed-forward's output; the one-key cross-attention's value and output
    projections too (there the rule sends their one row to ``F.linear``)."""
    block = _small_block()
    seen = []

    def fake(x, weight, bias=None):
        seen.append((weight, bias))
        return F.linear(x, weight, bias) + 1.0

    x, ctx = torch.randn(1, 16, 32), torch.randn(1, 1, 24)
    with torch.no_grad():
        want = block(x, ctx)
        monkeypatch.setattr(k5, "linear", fake)
        got = block(x, ctx)
    a1, a2, ff = block.attn1, block.attn2, block.ff
    expected = [a1.to_q, a1.to_k, a1.to_v, a1.to_out[0], a2.to_v,
                a2.to_out[0], ff.net[0].proj, ff.net[2]]
    assert [id(w) for w, _ in seen] == [id(m.weight) for m in expected]
    assert [id(b) for _, b in seen] == [id(m.bias) for m in expected]
    assert not torch.allclose(got, want)


@functools.lru_cache(maxsize=None)
def z123_linear_calls(batch: int = 1):
    """Every ``zero123.Linear`` call of one no-grad evaluation of Zero123's
    UNet at ``batch`` (its 8 x 32 x 32 input, one 768-wide context token),
    in order: (x shape, weight shape), traced on the meta device."""
    calls = []

    def record(x, weight, bias=None):
        calls.append((tuple(x.shape), tuple(weight.shape)))
        return F.linear(x, weight, bias)

    with torch.device("meta"):
        model = zero123.Zero123UNet()
        args = (torch.empty(batch, 8, 32, 32), torch.empty(batch),
                torch.empty(batch, 1, 768))
    linear, k5.linear = k5.linear, record
    try:
        with torch.no_grad():
            model(*args)
    finally:
        k5.linear = linear
    return tuple(calls)


def _routed(calls):
    with torch.no_grad():
        return [(math.prod(xs[:-1]), ws[0], ws[1]) for xs, ws in calls
                if k5.takes_kernel(_stand_in(xs), _stand_in(ws))]


def test_zero123_linears_are_counted():
    """One evaluation: 96 linears routed to K5 at the 12 shapes, in each
    transformer the four projections at (T, C, C), the GEGLU projection
    and the feed-forward's output; five transformers at each level's
    width, one in the middle block; the 32 one-row projections of the
    cross-attentions' single context token are not routed."""
    calls = z123_linear_calls(1)
    routed = _routed(calls)
    assert len(routed) == Z123_LINEARS
    assert set(routed) == Z123_SHAPES
    for t, n, k in Z123_SHAPES:
        assert routed.count((t, n, k)) == (4 if n == k else 1) * (
            1 if t == 16 else 5)
    assert len(calls) - len(routed) == 32
    assert {xs[:-1] for xs, _ in calls} - {(1, t) for t, _, _ in
                                           Z123_SHAPES} == {(1, 1)}
    # at batch 4 every routed linear takes 4 x the tokens
    assert sorted(_routed(z123_linear_calls(4))) == sorted(
        (4 * t, n, k) for t, n, k in routed)


def test_zero123_state_dict_is_unchanged(monkeypatch):
    """``zero123.Linear`` keeps ``nn.Linear``'s parameters and names: the
    UNet's state dict has the same keys and shapes as with ``nn.Linear``
    (zero123's checkpoints load), and its transformers' 160 linears are
    ``zero123.Linear``."""
    routed = zero123.Linear
    with torch.device("meta"):
        model = zero123.Zero123UNet()
        monkeypatch.setattr(zero123, "Linear", torch.nn.Linear)
        plain = zero123.Zero123UNet()
    got = {key: v.shape for key, v in model.state_dict().items()}
    assert got == {key: v.shape for key, v in plain.state_dict().items()}
    assert sum(isinstance(m, routed) for m in model.modules()) == 160
    assert not any(isinstance(m, routed) for m in plain.modules())


@pytest.mark.parametrize("batch", [1, 4])
def test_plan_keeps_every_shape_on_the_card(batch):
    """At each routed shape of an evaluation at ``batch``: at most 8 splits
    (the portable cluster size) and at most K's blocks; as many clusters as
    the card runs at once of that size (:data:`conv2d.H100_CLUSTERS`), or
    as there are tiles, so every CTA is resident and no tile waits for a
    second wave; the tile's tokens the least instance that holds T, else
    64; the tile, its features and the splits K4's for the same GEMM."""
    clusters = k4.H100_CLUSTERS
    for t, n, k in sorted(set(_routed(z123_linear_calls(batch)))):
        p = k5.plan(t, n, k)
        assert (p.tile_tokens, p.tile_rows) in k5.INSTANCES
        assert 1 <= p.splits <= min(k5.MAX_SPLITS, math.ceil(k / 32))
        n_tiles = k5.tiles(t, n, p.tile_tokens, p.tile_rows)
        assert p.clusters == min(n_tiles, clusters[p.splits - 1]), (t, n, k)
        assert p.ctas <= clusters[0]
        bn = next((b for b in k5.TILE_TOKENS if b >= t), 64)
        assert p.tile_tokens == bn
        q = k4.plan(t, n, k)
        assert (p.tile_tokens, p.tile_rows, p.splits) == (
            q.tile_pixels, q.tile_channels, q.splits), (t, n, k)


def test_plan_at_the_main_shapes():
    """K4's rule at Zero123's shapes (over an evaluation's 96 linears
    within a few percent of the fastest plan measured at each shape on an
    H100, PERF.md section 6): 128 features where T > 64, so that both
    consumer warpgroups share each token tile, else 64; the most splits
    whose clusters all run in one wave (5 over the 20 feature tiles of
    1280, 2 over the 48 of 320 at 1024 tokens); one split, the clusters
    walking the tiles in turn, where the tiles alone fill the card."""
    want = {(1024, 320, 320): (64, 128, 2, 48),
            (1024, 2560, 320): (64, 128, 1, 132),
            (1024, 320, 1280): (64, 128, 2, 48),
            (256, 640, 640): (64, 128, 5, 20),
            (256, 5120, 640): (64, 128, 1, 132),
            (256, 640, 2560): (64, 128, 5, 20),
            (64, 1280, 1280): (64, 64, 5, 20),
            (64, 10240, 1280): (64, 64, 1, 132),
            (64, 1280, 5120): (64, 64, 5, 20),
            (16, 1280, 1280): (16, 64, 5, 20),
            (16, 10240, 1280): (16, 64, 1, 132),
            (16, 1280, 5120): (16, 64, 5, 20)}
    assert set(want) == Z123_SHAPES
    for shape, plan in want.items():
        assert k5.plan(*shape) == k5.LinearPlan(*plan), shape
    # the narrowest call: one 8-token tile of 64 features, one block of K
    assert k5.plan(8, 8, 4) == k5.LinearPlan(8, 64, 1, 1)


def test_plan_uses_the_card_it_is_given():
    """A card that runs 132 clusters of every size: the plan may take more
    splits; a card of 8 SMs: every plan still fits on it."""
    for t, n, k in sorted(Z123_SHAPES):
        p = k5.plan(t, n, k, (132,) * 8)
        assert p.clusters <= 132
        small = k5.plan(t, n, k, (8, 4, 2, 2, 1, 1, 1, 1))
        assert small.ctas <= 8


def test_graph_replays_advance_k5_launches():
    """A replayed CUDA graph adds the K5 launches its capture counted, as
    it adds K4's: K5's counter is among the graphs' launch counters."""
    from sparsefusion_tpu_torch.utils.graphs import launch_counters

    counters = launch_counters()
    assert (k5.linear_gemm_cuda, "launches") in counters
    assert (k4.conv2d_splitk_cuda, "launches") in counters


def test_spans_line_reports_k5_launches():
    """The ``--spans`` line counts each UNet evaluation's K4 and K5
    launches, those of the spans inside it (Zero123's transformers, ``st``)
    added."""
    lines = []
    spans.enable(report=lines.append)
    try:
        for i in range(2):
            with spans.unit("distill/iteration", i):
                with spans.span("unet", unet_batch=1):
                    spans.count("k4_launches", 66)
                    for _ in range(16):
                        with spans.span("st"):
                            spans.count("k4_launches", 2)
                            spans.count("k5_launches", 6)
                if i == 1:
                    with spans.span("loss_read"):
                        spans.sync_point()
    finally:
        spans.disable()
    assert ("unet 1.00/unit at batch 1, 98 K4 launches each, "
            f"{Z123_LINEARS} K5 launches each") in lines[-1], lines


# ---- on a CUDA card ------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.fixture
def full_f32():
    """Matmuls in full f32 (TF32 off, as the entry points set them);
    restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def _card_inputs(t, n, k, gen, lead=(1,)):
    x = torch.randn(*lead, t, k, device="cuda", generator=gen)
    w = torch.randn(n, k, device="cuda", generator=gen) / math.sqrt(k)
    bias = torch.randn(n, device="cuda", generator=gen)
    return x, w, bias


def _check(got, x, w, bias):
    """K5 within 1e-5 of float64, and of cuBLAS's f32 within 1e-5 beyond
    cuBLAS's own distance from float64.  Returns the errors."""
    want = F.linear(x, w, bias)
    want64 = F.linear(x.double(), w.double(),
                      None if bias is None else bias.double())
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err64 = (got.double() - want64).abs().max().item()
    err = (got - want).abs().max().item()
    plain64 = (want.double() - want64).abs().max().item()
    assert err64 <= TOL and err <= TOL + plain64, (err64, err, plain64)
    return err64, err, plain64


@pytest.mark.cuda
def test_kernel_matches_float64_at_zero123_shapes(full_f32):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for t, n, k in sorted(Z123_SHAPES):
        x, w, bias = _card_inputs(t, n, k, gen)
        _check(k5.linear_gemm_cuda(x, w, bias), x, w, bias)


@pytest.mark.cuda
def test_one_pass_tf32_misses_the_tolerance():
    """The control: cuBLAS with TF32 on (one TF32 pass) leaves 1e-5 of
    float64 at every Zero123 shape."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for t, n, k in sorted(Z123_SHAPES):
            x, w, bias = _card_inputs(t, n, k, gen)
            got = F.linear(x, w, bias)
            want64 = F.linear(x.double(), w.double(), bias.double())
            assert (got.double() - want64).abs().max().item() > TOL
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
def test_kernel_ragged_shapes(full_f32):
    """Shapes off every tile: tokens, features and K not multiples of the
    tile (N % 4 != 0 stores one feature at a time), no bias, leading
    dimensions, and an input whose start is not 16-byte aligned (copied)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    for t, n, k, with_bias in ((9, 70, 36, True), (77, 33, 100, False),
                               (1030, 130, 68, True), (300, 1000, 964, True),
                               (8, 8, 4, True)):
        x, w, bias = _card_inputs(t, n, k, gen, lead=(1,))
        bias = bias if with_bias else None
        _check(k5.linear_gemm_cuda(x, w, bias), x, w, bias)
    x, w, bias = _card_inputs(12, 96, 64, gen, lead=(3, 2))
    _check(k5.linear_gemm_cuda(x, w, bias), x, w, bias)
    flat = torch.randn(40 * 64 + 1, device="cuda", generator=gen)
    x = flat[1:].view(40, 64)
    assert x.data_ptr() % 16 != 0
    _check(k5.linear_gemm_cuda(x, w, bias), x, w, bias)


@pytest.mark.cuda
def test_every_instance_split_and_cluster_count(full_f32):
    """One GEMM (T 200, N 300, K 1000: ragged tiles, 32 K blocks) under
    every instance, 1, 3, 5 and 8 splits (uneven shares of K, odd block
    counts for the two warpgroups) and one cluster or as many as there are
    tiles (a cluster walking every tile in turn, or one tile each)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    t, n, k = 200, 300, 1000
    x, w, bias = _card_inputs(t, n, k, gen)
    for bn, rows in k5.INSTANCES:
        n_tiles = k5.tiles(t, n, bn, rows)
        for splits in (1, 3, 5, 8):
            for clusters in sorted({1, 3, min(n_tiles, 12)}):
                p = k5.LinearPlan(bn, rows, splits, clusters)
                got = k5.linear_gemm_cuda(x, w, bias, run_plan=p)
                _check(got, x, w, bias)


@pytest.mark.cuda
def test_two_launches_are_bit_equal(full_f32):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for t, n, k in ((64, 10240, 1280), (1024, 320, 1280), (16, 1280, 5120)):
        x, w, bias = _card_inputs(t, n, k, gen)
        a = k5.linear_gemm_cuda(x, w, bias)
        b = k5.linear_gemm_cuda(x, w, bias)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_replays_count_k5_launches(full_f32):
    """K5 in a captured program: each replay counts its launch, and the
    replays' outputs are the eager launch's bits."""
    _need_card()
    from sparsefusion_tpu_torch.utils.graphs import (
        GraphRunner,
        launch_counters,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    x, w, bias = _card_inputs(64, 1280, 1280, gen)
    want = k5.linear_gemm_cuda(x, w, bias)
    out = torch.zeros_like(want)

    def program():
        out.copy_(k5.linear(x, w, bias))

    runner = GraphRunner(dev, gen, launch_counters())
    k5.reset_launches()
    for i in range(5):
        runner.run(("linear",), program, i)
    torch.cuda.synchronize()
    assert k5.linear_gemm_cuda.launches == 5
    assert runner.replays == 4
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    _need_card()
    x = torch.randn(1, 16, 32, device="cuda")
    w = torch.randn(8, 32, device="cuda")
    for args in ((x.bfloat16(), w.bfloat16()), (x.cpu(), w), (x, w[:, :16]),
                 (x[..., :30], w[:, :30]), (x[:, :7], w),
                 (x, w, torch.randn(9, device="cuda"))):
        with pytest.raises(ValueError):
            k5.linear_gemm_cuda(*args)


@pytest.mark.cuda
def test_zero123_forward_through_k5_matches_cublas(full_f32):
    """One batch-1 Zero123 evaluation as the sampler makes it: its 96
    routed linears through K5, counted by the launch counter and by the
    spans' ``k5_launches``; the same evaluation with K5 refused (cuBLAS's
    f32 linears) agrees within 1e-5, relative."""
    _need_card()
    from sparsefusion_tpu_torch.models import _lecun_

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("meta"):
        model = zero123.Zero123UNet()
    model = model.to_empty(device="cuda").eval()
    _lecun_(model, gen)
    args = (torch.randn(1, 8, 32, 32, device="cuda", generator=gen),
            torch.full((1,), 500.0, device="cuda"),
            torch.randn(1, 1, 768, device="cuda", generator=gen))
    k5.reset_launches()
    spans.enable()
    try:
        with spans.unit("distill/iteration", 0):
            with spans.span("unet", unet_batch=1), torch.no_grad():
                got = model(*args)
        torch.cuda.synchronize()
        snap = spans.snapshot()
    finally:
        spans.disable()
    assert k5.linear_gemm_cuda.launches == Z123_LINEARS
    first = [s for s in snap if s["name"] == "unet"][-1]["id"]
    assert sum((s.get("counts") or {}).get("k5_launches", 0)
               for s in snap if s["id"] >= first) == Z123_LINEARS
    take = k5.takes_kernel
    k5.takes_kernel = lambda *a: False
    try:
        with torch.no_grad():
            want = model(*args)
    finally:
        k5.takes_kernel = take
    assert k5.linear_gemm_cuda.launches == Z123_LINEARS
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-5, rel
