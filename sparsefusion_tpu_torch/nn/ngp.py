"""Instant-NGP radiance field (tiled-grid encoder + tiny MLP).

Counterpart of ``sparsefusion_tpu/nn/ngp.py``: a tiled grid encoder
(16 levels x 2 channels, 2^16 table, desired resolution 2048*bound), a
3-layer MLP(64) to [sigma_raw, albedo_rgb], density sigma =
trunc_exp(raw + center gaussian blob), sigmoid albedo.  Parameter names
follow the Flax module (``grid``, ``sigma_net_{i}``, ``bg_net_{i}``), so
:func:`load_jax_params` / :func:`export_jax_params` carry weights across.

:class:`NGPFieldStack` holds S such fields stacked on a leading scene
axis, the port of the JAX scene-batched loop's vmapped params
(``distill/batched.py``): one grid-encode launch and one batched matmul a
layer evaluate all S scenes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sparsefusion_tpu_torch.ops.grid_encode import (
    GridEncoding,
    grid_encode_bound,
    make_grid_encoding,
)


class TruncExp(torch.autograd.Function):
    """exp with its gradient clamped to exp(clip(x, -15, 15))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)


def freq_encode(x: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """NeRF frequency encoding [x, sin/cos(2^i x) ...]; D * (1 + 2 degree)."""
    outs = [x]
    for i in range(degree):
        f = (2.0 ** i) * x
        outs.append(torch.sin(f))
        outs.append(torch.cos(f))
    return torch.cat(outs, dim=-1)


def get_encoder(encoding: str, input_dim: int = 3, degree: int = 4,
                **grid_kwargs):
    """(encode_info, output_dim): a GridEncoding for grid types, a function
    for 'frequency'."""
    if encoding == "frequency":
        return (lambda x: freq_encode(x, degree)), input_dim * (1 + 2 * degree)
    if encoding in ("hashgrid", "tiledgrid"):
        gridtype = "hash" if encoding == "hashgrid" else "tiled"
        enc = make_grid_encoding(input_dim=input_dim, gridtype=gridtype,
                                 **grid_kwargs)
        return enc, enc.output_dim
    raise NotImplementedError(
        f"unknown encoding {encoding} (frequency|hashgrid|tiledgrid)")


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """Same fields as the JAX ``NGPConfig``.

    ``use_blocked_lookup``, ``pallas_gather`` and ``mm_scatter_rows``
    select TPU layouts of the same math; they are accepted and change
    nothing here (a CUDA tensor always takes the fused kernel).
    ``table_dtype="bfloat16"`` reads the table in bf16.
    """

    bound: float = 4.0
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 16
    gridtype: str = "tiled"
    num_layers: int = 3
    hidden_dim: int = 64
    density_blob_scale: float = 5.0
    density_blob_std: float = 0.2
    bg_radius: float = 0.0
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    bg_freq_degree: int = 4
    use_blocked_lookup: bool = True
    table_dtype: Optional[str] = None
    pallas_gather: bool = False
    mm_scatter_rows: int = 0

    def encoding(self) -> GridEncoding:
        return make_grid_encoding(
            input_dim=3, num_levels=self.num_levels,
            level_dim=self.level_dim, base_resolution=self.base_resolution,
            log2_hashmap_size=self.log2_hashmap_size,
            desired_resolution=int(2048 * self.bound),
            gridtype=self.gridtype)


def _dense(fan_in: int, fan_out: int, device, generator) -> nn.Linear:
    """nn.Linear with Flax Dense's default init: lecun-normal kernel
    (truncated normal), zero bias."""
    layer = nn.Linear(fan_in, fan_out, device=device)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


class NGPField(nn.Module):
    """Density + albedo field over [-bound, bound]^3."""

    def __init__(self, config: NGPConfig = NGPConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.enc = cfg.encoding()
        grid = torch.empty((self.enc.total_params, cfg.level_dim),
                           device=device)
        grid.uniform_(-1e-4, 1e-4, generator=generator)
        self.grid = nn.Parameter(grid)
        dims = [self.enc.output_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
        for i in range(cfg.num_layers):
            out = cfg.hidden_dim if i < cfg.num_layers - 1 else 4
            setattr(self, f"sigma_net_{i}",
                    _dense(dims[i], out, device, generator))
        if cfg.bg_radius > 0:
            bg_in = 3 * (1 + 2 * cfg.bg_freq_degree)
            dims = [bg_in] + [cfg.hidden_dim_bg] * (cfg.num_layers_bg - 1)
            for i in range(cfg.num_layers_bg):
                out = cfg.hidden_dim_bg if i < cfg.num_layers_bg - 1 else 3
                setattr(self, f"bg_net_{i}",
                        _dense(dims[i], out, device, generator))

    def density_blob(self, x: torch.Tensor) -> torch.Tensor:
        """Center gaussian prior on sigma."""
        cfg = self.config
        d = (x ** 2).sum(dim=-1)
        return cfg.density_blob_scale * torch.exp(
            -d / (2 * cfg.density_blob_std ** 2))

    def expand_tables(self) -> torch.Tensor:
        """The table the encode reads: the f32 master itself.  The JAX
        package expands a blocked TPU layout here; the port reads the
        master directly and applies ``table_dtype`` inside the encode."""
        return self.grid

    def forward(self, x: torch.Tensor, tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (..., 3) in [-bound, bound] -> (sigma (...,), albedo (..., 3))."""
        cfg = self.config
        table = self.grid if tables is None else tables
        h = grid_encode_bound(x, table, self.enc, bound=cfg.bound,
                              table_dtype=cfg.table_dtype)
        for i in range(cfg.num_layers):
            h = getattr(self, f"sigma_net_{i}")(h)
            if i < cfg.num_layers - 1:
                h = torch.relu(h)
        sigma = trunc_exp(h[..., 0] + self.density_blob(x))
        albedo = torch.sigmoid(h[..., 1:])
        return sigma, albedo

    def background(self, d: torch.Tensor) -> torch.Tensor:
        """View-direction background color."""
        cfg = self.config
        if cfg.bg_radius <= 0:
            raise ValueError("background net disabled (bg_radius=0)")
        h = freq_encode(d, cfg.bg_freq_degree)
        for i in range(cfg.num_layers_bg):
            h = getattr(self, f"bg_net_{i}")(h)
            if i < cfg.num_layers_bg - 1:
                h = torch.relu(h)
        return torch.sigmoid(h)


def _dense_names(field: NGPField):
    names = [f"sigma_net_{i}" for i in range(field.config.num_layers)]
    if field.config.bg_radius > 0:
        names += [f"bg_net_{i}" for i in range(field.config.num_layers_bg)]
    return names


@torch.no_grad()
def load_jax_params(field: NGPField, params: Dict) -> None:
    """Copy JAX ``NGPField`` params (a dict of numpy arrays) into ``field``:
    the grid as is; each Flax Dense kernel (in, out) transposed into
    ``nn.Linear.weight`` (out, in), its bias as is."""
    def put(dst: torch.Tensor, src) -> None:
        src = torch.from_numpy(np.array(src, np.float32))
        if dst.shape != src.shape:
            raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
        dst.copy_(src)

    put(field.grid, params["grid"])
    for name in _dense_names(field):
        layer = getattr(field, name)
        put(layer.weight, np.asarray(params[name]["kernel"]).T)
        put(layer.bias, params[name]["bias"])


@torch.no_grad()
def export_jax_params(field: NGPField) -> Dict:
    """Inverse of :func:`load_jax_params`: numpy params in the Flax layout."""
    out = {"grid": field.grid.detach().cpu().numpy()}
    for name in _dense_names(field):
        layer = getattr(field, name)
        out[name] = {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                     "bias": layer.bias.detach().cpu().numpy()}
    return out


def _split(points: int, most: int = 64) -> int:
    """The largest power of two up to ``most`` that divides ``points``."""
    k = 1
    while k < most and points % (2 * k) == 0:
        k *= 2
    return k


class _StackedDenseFn(torch.autograd.Function):
    """``baddbmm`` whose kernel gradient is split along the points.  The
    gradient h^T g of S scenes' (P, in) and (P, out) is S products with a
    reduction over P, which the library runs on S output tiles: at S = 4
    and P = 262,144 they took 75% of a scene-batched input step's device
    time on an H100 (PERF.md section 5).  Cut into S k products over P / k
    points each and summed over k, they spread over the card."""

    @staticmethod
    def forward(ctx, h, kernel, bias):
        ctx.save_for_backward(h, kernel)
        return torch.baddbmm(bias[:, None, :], h, kernel)

    @staticmethod
    def backward(ctx, g):
        h, kernel = ctx.saved_tensors
        S, P, n_in = h.shape
        k = _split(P)
        grad_h = torch.bmm(g, kernel.transpose(1, 2)) \
            if ctx.needs_input_grad[0] else None
        grad_kernel = torch.bmm(
            h.reshape(S * k, P // k, n_in).transpose(1, 2),
            g.reshape(S * k, P // k, -1)).reshape(S, k, n_in, -1).sum(1)
        return grad_h, grad_kernel, g.sum(1)


class StackedDense(nn.Module):
    """S dense layers in the Flax layout: ``kernel`` (S, in, out),
    ``bias`` (S, out); (S, P, in) -> (S, P, out) in one batched matmul."""

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(bias)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return _StackedDenseFn.apply(h, self.kernel, self.bias)


class NGPFieldStack(nn.Module):
    """S fields of one config with their parameters stacked on a leading
    scene axis: ``grid`` (S, T, C) and each dense layer a
    :class:`StackedDense`.  Points are (S, ..., 3), scene s's through
    field s."""

    def __init__(self, fields):
        super().__init__()
        fields = list(fields)
        cfg = fields[0].config
        if any(f.config != cfg for f in fields):
            raise ValueError("a field stack needs one NGPConfig")
        self.config = cfg
        self.enc = fields[0].enc
        self.n_scenes = len(fields)
        with torch.no_grad():
            self.grid = nn.Parameter(torch.stack([f.grid for f in fields]))
            for name in _dense_names(fields[0]):
                layers = [getattr(f, name) for f in fields]
                setattr(self, name, StackedDense(
                    torch.stack([m.weight.T for m in layers]),
                    torch.stack([m.bias for m in layers])))

    @classmethod
    def from_jax_params(cls, config: NGPConfig, stacked: Dict,
                        device=None) -> "NGPFieldStack":
        """The JAX scene-batched loop's params: every leaf with a leading
        S axis (numpy)."""
        n = len(stacked["grid"])
        fields = []
        for i in range(n):
            field = NGPField(config, device=device)
            load_jax_params(field, _leaf_at(stacked, i))
            fields.append(field)
        return cls(fields)

    def field_at(self, i: int) -> NGPField:
        """Scene ``i`` as an :class:`NGPField` (a copy)."""
        field = NGPField(self.config, device=self.grid.device)
        with torch.no_grad():
            field.grid.copy_(self.grid[i])
            for name in _dense_names(field):
                layer, stacked = getattr(field, name), getattr(self, name)
                layer.weight.copy_(stacked.kernel[i].T)
                layer.bias.copy_(stacked.bias[i])
        return field

    def _mlp(self, h: torch.Tensor, prefix: str, n_layers: int):
        for i in range(n_layers):
            h = getattr(self, f"{prefix}_{i}")(h)
            if i < n_layers - 1:
                h = torch.relu(h)
        return h

    density_blob = NGPField.density_blob

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (S, ..., 3) in [-bound, bound] -> (sigma (S, ...), albedo
        (S, ..., 3))."""
        cfg = self.config
        h = grid_encode_bound(x, self.grid, self.enc, bound=cfg.bound,
                              table_dtype=cfg.table_dtype)
        h = self._mlp(h.reshape(self.n_scenes, -1, h.shape[-1]),
                      "sigma_net", cfg.num_layers).reshape(*x.shape[:-1], 4)
        sigma = trunc_exp(h[..., 0] + self.density_blob(x))
        albedo = torch.sigmoid(h[..., 1:])
        return sigma, albedo

    def background(self, d: torch.Tensor) -> torch.Tensor:
        """(S, ..., 3) view directions -> (S, ..., 3) background colors."""
        cfg = self.config
        if cfg.bg_radius <= 0:
            raise ValueError("background net disabled (bg_radius=0)")
        h = freq_encode(d.reshape(self.n_scenes, -1, 3), cfg.bg_freq_degree)
        h = self._mlp(h, "bg_net", cfg.num_layers_bg)
        return torch.sigmoid(h).reshape(d.shape)


def _leaf_at(tree: Dict, i: int) -> Dict:
    return {k: _leaf_at(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}
