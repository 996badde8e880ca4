"""Instant-NGP radiance field (tiled-grid encoder + tiny MLP).

Counterpart of ``sparsefusion_tpu/nn/ngp.py``: a tiled grid encoder
(16 levels x 2 channels, 2^16 table, desired resolution 2048*bound), a
3-layer MLP(64) to [sigma_raw, albedo_rgb], density sigma =
trunc_exp(raw + center gaussian blob), sigmoid albedo.  Parameter names
follow the Flax module (``grid``, ``sigma_net_{i}``, ``bg_net_{i}``), so
:func:`load_jax_params` / :func:`export_jax_params` carry weights across.
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
