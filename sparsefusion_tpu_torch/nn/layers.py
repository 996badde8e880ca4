"""Imagen-style UNet building blocks (NCHW), the ones the SparseFusion
UNet uses.

Counterpart of ``sparsefusion_tpu/nn/layers.py``.  Parameter names follow
the reference torch layout (imagen_pytorch) that the JAX converters read
(``train/convert.py``), so reference checkpoints load with
``load_state_dict``: e.g. the reference wraps attention in an einops
rearrange module, hence the ``.fn`` level of :class:`Fn`.

Token modules take (B, N, C); convolutional ones NCHW.  Parameters are
f32 (or a cast copy); every module runs in a compute dtype, flax's
``dtype=``: :class:`Linear` and :class:`Conv2d` cast their input and their
weight read to it, the gamma LayerNorms compute in f32 and return it
(eps 1e-3 outside f32), :class:`GroupNormF32` and :class:`LayerNormF32`
compute in f32 and return f32, as the JAX modules with
``dtype=jnp.float32``.  :func:`set_compute_dtype` sets it on a module
tree; f32 is the default, and there every cast is a no-op.
:class:`Attention` calls kernel K2 (``kernels/attention.py``),
:class:`Conv2d` kernel K4 (``kernels/conv2d.py``); the multi-head
:class:`CrossAttention` is a plain einsum, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sparsefusion_tpu_torch.kernels.attention import imagen_attention
from sparsefusion_tpu_torch.kernels.conv2d import conv2d


class _Compute:
    """Mixin: the module's compute dtype (a class default, set per
    instance by :func:`set_compute_dtype`)."""

    compute_dtype: torch.dtype = torch.float32


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the compute dtype of every module of ``module`` that has one."""
    for m in module.modules():
        if isinstance(m, _Compute):
            m.compute_dtype = dtype
    return module


class Linear(_Compute, nn.Linear):
    """``nn.Linear`` with its input, weight and bias cast to the compute
    dtype (flax ``nn.Dense(dtype=...)``)."""

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(_Compute, nn.Conv2d):
    """``nn.Conv2d`` with its input, weight and bias cast to the compute
    dtype (flax ``nn.Conv(dtype=...)``), zero-padded; kernel K4 where
    ``kernels/conv2d.py::takes_kernel`` holds (f32 on a card, no
    gradient)."""

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                      self.padding, self.dilation, self.groups)


class LayerNormF32(nn.LayerNorm):
    """``nn.LayerNorm`` (with bias) computed and returned in f32."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


class GroupNormF32(nn.GroupNorm):
    """``nn.GroupNorm`` computed and returned in f32."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


class Fn(nn.Module):
    """Holds ``fn``: the level the reference's einops wrappers add to the
    key layout (``...cross_attn.fn.to_q``, ``mid_attn.fn.fn.to_q``)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


def _gamma_norm(x: torch.Tensor, g: torch.Tensor, dim: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    eps = 1e-5 if x.dtype == torch.float32 else 1e-3
    xf = x.float()
    var = xf.var(dim=dim, unbiased=False, keepdim=True)
    mean = xf.mean(dim=dim, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * g.float()).to(out_dtype)


class LayerNorm(_Compute, nn.Module):
    """Gamma-only LayerNorm over the last axis, in f32 (eps 1e-5 on an f32
    input, 1e-3 otherwise), returned in the compute dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return _gamma_norm(x, self.g, -1, self.compute_dtype)


class ChanLayerNorm(_Compute, nn.Module):
    """Gamma-only LayerNorm over the channels of an NCHW tensor."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        return _gamma_norm(x, self.g, 1, self.compute_dtype)


class LearnedSinusoidalPosEmb(nn.Module):
    """Learned Fourier features of the log-SNR: (B,) -> (B, dim + 1)."""

    def __init__(self, dim: int = 16):
        super().__init__()
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, x):
        freqs = x[:, None] * self.weights[None, :] * 2 * math.pi
        return torch.cat([x[:, None], freqs.sin(), freqs.cos()], dim=-1)


class Attention(nn.Module):
    """Self-attention with one key/value head shared by all query heads,
    a learned null key/value and optional context tokens; token order
    [context, null, self].  (B, N, dim) -> (B, N, dim)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = dim_head * heads
        self.norm = LayerNorm(dim)
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, 2 * dim_head, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        if context_dim is not None:
            # a standard LayerNorm, with bias, in f32
            self.to_context = nn.Sequential(
                LayerNormF32(context_dim), Linear(context_dim, 2 * dim_head))
        self.to_out = nn.Sequential(Linear(inner, dim, bias=False),
                                    LayerNorm(dim))

    def forward(self, x, context=None):
        b, n, _ = x.shape
        x = self.norm(x)
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head)
        q = q * self.dim_head ** -0.5
        k, v = self.to_kv(x).chunk(2, dim=-1)
        nk = self.null_kv[0].expand(b, 1, self.dim_head)
        nv = self.null_kv[1].expand(b, 1, self.dim_head)
        k = torch.cat([nk.to(k.dtype), k], dim=1)
        v = torch.cat([nv.to(v.dtype), v], dim=1)
        if context is not None:
            ck, cv = self.to_context(context).chunk(2, dim=-1)
            k = torch.cat([ck, k], dim=1)
            v = torch.cat([cv, v], dim=1)
        out = imagen_attention(q.transpose(1, 2).contiguous(),
                               k.contiguous(), v.contiguous())
        out = out.transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)


class CrossAttention(nn.Module):
    """Multi-head cross-attention with a null key/value (the context goes
    un-normalised into the key/value projection)."""

    def __init__(self, dim: int, context_dim: int, dim_head: int = 64,
                 heads: int = 8):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = dim_head * heads
        self.norm = LayerNorm(dim)
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(context_dim, 2 * inner, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_out = nn.Sequential(Linear(inner, dim, bias=False),
                                    LayerNorm(dim))

    def forward(self, x, context):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(self.norm(x)).reshape(b, n, h, d)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        k = k.reshape(b, -1, h, d)
        v = v.reshape(b, -1, h, d)
        k = torch.cat([self.null_kv[0].expand(b, 1, h, d).to(k.dtype), k],
                      dim=1)
        v = torch.cat([self.null_kv[1].expand(b, 1, h, d).to(v.dtype), v],
                      dim=1)
        # the logits in the compute dtype (rounded in bf16, as the JAX
        # einsum's), the softmax in f32
        sim = torch.einsum("bnhd,bjhd->bhnj", q * d ** -0.5, k)
        attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhnj,bjhd->bnhd", attn, v).reshape(b, n, h * d)
        return self.to_out(out)


def chan_feed_forward(dim: int, mult: float = 2.0) -> nn.Sequential:
    """1x1-conv feed-forward on NCHW tensors (exact GELU)."""
    hidden = int(dim * mult)
    return nn.Sequential(ChanLayerNorm(dim),
                         Conv2d(dim, hidden, 1, bias=False),
                         nn.GELU(),
                         ChanLayerNorm(hidden),
                         Conv2d(hidden, dim, 1, bias=False))


class TransformerBlock(nn.Module):
    """depth x (self-attention over the h*w tokens + channel FF)."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8,
                 dim_head: int = 64, ff_mult: float = 2.0,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([Fn(Attention(dim, dim_head, heads, context_dim)),
                           chan_feed_forward(dim, ff_mult)])
            for _ in range(depth)])

    def forward(self, x, context=None):
        b, c, h, w = x.shape
        for attn, ff in self.layers:
            tokens = x.flatten(2).transpose(1, 2)
            tokens = attn.fn(tokens, context) + tokens
            x = tokens.transpose(1, 2).reshape(b, c, h, w)
            x = ff(x) + x
        return x


class GlobalContext(_Compute, nn.Module):
    """Squeeze-excite-style gate: attention-pooled channels -> sigmoid."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        hidden = max(3, dim_out // 2)
        self.to_k = Conv2d(dim_in, 1, 1)
        self.net = nn.Sequential(Conv2d(dim_in, hidden, 1), nn.SiLU(),
                                 Conv2d(hidden, dim_out, 1), nn.Sigmoid())

    def forward(self, x):
        dt = self.compute_dtype
        attn = torch.softmax(self.to_k(x).flatten(2).float(), dim=-1)
        pooled = torch.einsum("bkn,bcn->bck", attn.to(dt),
                              x.flatten(2).to(dt))
        return self.net(pooled[..., None])


class Block(nn.Module):
    """GroupNorm -> (FiLM) -> SiLU -> 3x3 conv: the norm in f32, FiLM and
    SiLU in the promoted type (f32 against a bf16 scale and shift), the
    conv in the compute dtype."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.groupnorm = GroupNormF32(groups, dim, eps=1e-5)
        self.project = Conv2d(dim, dim_out, 3, padding=1)

    def forward(self, x, scale_shift=None):
        x = self.groupnorm(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return self.project(F.silu(x))


class ResnetBlock(nn.Module):
    """FiLM ResNet block with optional cross-attention and gate."""

    def __init__(self, dim: int, dim_out: int,
                 cond_dim: Optional[int] = None,
                 time_cond_dim: Optional[int] = None, groups: int = 8,
                 use_gca: bool = False, attn_heads: int = 8,
                 attn_dim_head: int = 64):
        super().__init__()
        self.time_mlp = None
        if time_cond_dim is not None:
            self.time_mlp = nn.Sequential(
                nn.SiLU(), Linear(time_cond_dim, dim_out * 2))
        self.cross_attn = None
        if cond_dim is not None:
            self.cross_attn = Fn(CrossAttention(dim_out, cond_dim,
                                                attn_dim_head, attn_heads))
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.gca = GlobalContext(dim_out, dim_out) if use_gca else None
        self.res_conv = (Conv2d(dim, dim_out, 1) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, time_emb=None, cond=None):
        scale_shift = None
        if self.time_mlp is not None and time_emb is not None:
            scale_shift = self.time_mlp(time_emb)[:, :, None, None].chunk(
                2, dim=1)
        h = self.block1(x)
        if self.cross_attn is not None:
            b, c, hh, ww = h.shape
            tokens = h.flatten(2).transpose(1, 2)
            tokens = self.cross_attn.fn(tokens, cond) + tokens
            h = tokens.transpose(1, 2).reshape(b, c, hh, ww)
        h = self.block2(h, scale_shift=scale_shift)
        if self.gca is not None:
            h = h * self.gca(h)
        return h + self.res_conv(x)


class CrossEmbedLayer(nn.Module):
    """Multi-kernel stem conv: kernels sorted, channels dim/2, dim/4, ...,
    the rest to the largest; padding (k - stride) // 2."""

    def __init__(self, dim_in: int, dim_out: int,
                 kernel_sizes: Sequence[int] = (3, 7, 15), stride: int = 1):
        super().__init__()
        kernel_sizes = sorted(kernel_sizes)
        dim_scales = [int(dim_out / (2 ** i))
                      for i in range(1, len(kernel_sizes))]
        dim_scales.append(dim_out - sum(dim_scales))
        self.convs = nn.ModuleList([
            Conv2d(dim_in, d, k, stride=stride, padding=(k - stride) // 2)
            for k, d in zip(kernel_sizes, dim_scales)])

    def forward(self, x):
        return torch.cat([conv(x) for conv in self.convs], dim=1)


def downsample(dim: int, dim_out: int) -> Conv2d:
    """4x4 stride-2 conv."""
    return Conv2d(dim, dim_out, 4, stride=2, padding=1)


class ParallelConvs(nn.Module):
    """The last level's 'downsample': a 3x3 conv and a 1x1 conv, summed."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.fns = nn.ModuleList([Conv2d(dim, dim_out, 3, padding=1),
                                  Conv2d(dim, dim_out, 1)])

    def forward(self, x):
        return self.fns[0](x) + self.fns[1](x)


class PixelShuffleUpsample(nn.Module):
    """1x1 conv -> SiLU -> pixel shuffle (x2)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.net = nn.Sequential(Conv2d(dim, dim_out * 4, 1), nn.SiLU(),
                                 nn.PixelShuffle(2))

    def forward(self, x):
        return self.net(x)


# ---- imagen's Perceiver blocks (not used by the SparseFusion UNet) --------

class FeedForward(nn.Sequential):
    """Token feed-forward: gamma LayerNorm, Linear to ``dim * mult`` (no
    bias), exact GELU, gamma LayerNorm, Linear back; (B, N, dim)."""

    def __init__(self, dim: int, mult: float = 4.0):
        hidden = int(dim * mult)
        super().__init__(LayerNorm(dim), Linear(dim, hidden, bias=False),
                         nn.GELU(), LayerNorm(hidden),
                         Linear(hidden, dim, bias=False))


class PerceiverAttention(nn.Module):
    """Latent queries attending over the tokens and the latents together:
    (B, N, dim) tokens, (B, M, dim) latents -> (B, M, dim).  Its norms are
    standard LayerNorms (with bias, eps 1e-5, in f32); the logits are a
    plain einsum with the softmax in f32, as in the JAX package (K2 does
    not take it: every query head has its own key/value head here)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = dim_head * heads
        self.norm = LayerNormF32(dim)
        self.norm_latents = LayerNormF32(dim)
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim, bias=False),
                                    LayerNormF32(dim))

    def forward(self, x, latents):
        b = x.shape[0]
        h, d = self.heads, self.dim_head
        x = self.norm(x)
        latents = self.norm_latents(latents)
        q = self.to_q(latents).reshape(b, -1, h, d)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        k = k.reshape(b, -1, h, d)
        v = v.reshape(b, -1, h, d)
        sim = torch.einsum("bnhd,bjhd->bhnj", q * d ** -0.5, k)
        attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhnj,bjhd->bnhd", attn, v).reshape(b, -1, h * d)
        return self.to_out(out)


class PerceiverResampler(_Compute, nn.Module):
    """Attention pooling of (B, N, dim) conditioning tokens into
    ``num_latents_mean_pooled + num_latents`` latents: learned positions
    added to the tokens, the mean-pooled tokens projected into the first
    latents, then ``depth`` x (Perceiver attention + feed-forward), each
    residual.  ``pos_emb`` is the reference's ``pos_emb.weight``."""

    def __init__(self, dim: int, depth: int = 2, dim_head: int = 64,
                 heads: int = 8, num_latents: int = 64,
                 num_latents_mean_pooled: int = 4, max_seq_len: int = 512,
                 ff_mult: float = 4.0):
        super().__init__()
        self.num_latents_mean_pooled = num_latents_mean_pooled
        self.pos_emb = nn.Parameter(torch.randn(max_seq_len, dim))
        self.latents = nn.Parameter(torch.randn(num_latents, dim))
        if num_latents_mean_pooled > 0:
            self.to_latents_from_mean_pooled_seq = nn.Sequential(
                LayerNorm(dim), Linear(dim, dim * num_latents_mean_pooled))
        self.layers = nn.ModuleList([
            nn.ModuleList([PerceiverAttention(dim, dim_head, heads),
                           FeedForward(dim, ff_mult)])
            for _ in range(depth)])

    def forward(self, x):
        b, n, dim = x.shape
        x = x + self.pos_emb[:n]
        latents = self.latents[None].expand(b, -1, -1).to(self.compute_dtype)
        if self.num_latents_mean_pooled > 0:
            pooled = self.to_latents_from_mean_pooled_seq(x.mean(dim=1))
            latents = torch.cat([pooled.reshape(
                b, self.num_latents_mean_pooled, dim), latents], dim=-2)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return latents


def _feed_forward_pairs(t: str, j: str):
    return [(f"{t}0", f"{j}norm_in"), (f"{t}1", f"{j}in"),
            (f"{t}3", f"{j}norm_mid"), (f"{t}4", f"{j}out")]


def _perceiver_attention_pairs(t: str, j: str):
    return [(f"{t}norm", f"{j}norm"), (f"{t}norm_latents", f"{j}norm_latents"),
            (f"{t}to_q", f"{j}to_q"), (f"{t}to_kv", f"{j}to_kv"),
            (f"{t}to_out.0", f"{j}to_out"), (f"{t}to_out.1", f"{j}out_norm")]


def jax_module_pairs(module: nn.Module):
    """(torch module, JAX module path) of every module with parameters of
    a :class:`FeedForward`, :class:`PerceiverAttention` or
    :class:`PerceiverResampler`, for ``nn/flax_layout.py::load_flax_tree``
    (the root pair "" holds the resampler's own ``pos_emb`` and
    ``latents``)."""
    if isinstance(module, FeedForward):
        return _feed_forward_pairs("", "")
    if isinstance(module, PerceiverAttention):
        return _perceiver_attention_pairs("", "")
    if not isinstance(module, PerceiverResampler):
        raise TypeError(f"no JAX layout for {type(module).__name__}")
    pairs = [("", ""),
             ("to_latents_from_mean_pooled_seq.0", "pool_norm"),
             ("to_latents_from_mean_pooled_seq.1", "pool_proj")]
    for i in range(len(module.layers)):
        pairs += _perceiver_attention_pairs(f"layers.{i}.0.", f"attn_{i}/")
        pairs += _feed_forward_pairs(f"layers.{i}.1.", f"ff_{i}/")
    return pairs


def load_jax_params(module: nn.Module, params) -> None:
    """Fill a Perceiver block from its JAX params (a numpy tree)."""
    from sparsefusion_tpu_torch.nn.flax_layout import load_flax_tree

    load_flax_tree(module, jax_module_pairs(module), params)
