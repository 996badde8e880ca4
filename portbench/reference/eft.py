"""Epipolar Feature Transformer (EFT).

Frozen copy of the port's ``nn/eft.py`` (the JAX ``sparsefusion_tpu/nn/eft.py``'s counterpart): a light-field network
that, for each query ray, samples multi-scale ResNet18 features at the
epipolar points of every context view and aggregates them with three
small transformers (T1 across context views per point, T2 across depth
samples per (view, ray) then attention-pooled, T3 across views per ray
then attention-pooled), giving an RGB value and a 256-d feature per ray.

The transformers are written out (post-norm, ReLU, one head, the torch
``nn.TransformerEncoderLayer`` parameter names), with plain matmul
attention as in the JAX package.  Module names follow the reference EFT
state dict (``encoder_model.*``, ``t1.pre.0``,
``t1.encoder.layers.i.self_attn.in_proj_weight``, ...).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.cameras import (
    Cameras,
    camera_centers,
    transform_points_ndc,
)
from portbench.reference.harmonics import HarmonicEmbedding
from portbench.reference import resnet


@dataclasses.dataclass(frozen=True)
class EFTConfig:
    """Same fields and defaults as the JAX ``EFTConfig``."""

    use_r: bool = True
    n_harmonic_functions: int = 6
    omega0: float = 1.0
    in_dim: int = 3
    out_dim: int = 3
    out_sigmoid: bool = True
    intermediate_dim: int = 256
    n_transformer_layers: int = 4
    feat_size: int = 512
    return_features: bool = True

    @property
    def ray_dim(self) -> int:
        return 6 * (2 * self.n_harmonic_functions + 1)

    @property
    def depth_dim(self) -> int:
        return 2 * self.n_harmonic_functions + 1

    @property
    def patch_dim(self) -> int:
        return self.feat_size + self.in_dim


class _SelfAttention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` (packed in-projection,
    out_proj), computed with plain matmuls."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x):
        b, s, e = x.shape
        hd = e // self.nhead
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, s, self.nhead, hd) for t in (q, k, v))
        sim = torch.einsum("bihd,bjhd->bhij", q, k) / hd ** 0.5
        attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, s, e)
        return self.out_proj(out)


class TorchEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (post-norm, ReLU) on (B, S, E)
    tokens, attending over S."""

    def __init__(self, d_model: int, dim_feedforward: int, nhead: int = 1):
        super().__init__()
        self.self_attn = _SelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class TransformerEncoder(nn.Module):
    """Linear + GELU, then ``n_layer`` encoder layers."""

    def __init__(self, d_in: int, n_hidden: int = 256, n_layer: int = 4):
        super().__init__()
        self.pre = nn.Sequential(nn.Linear(d_in, n_hidden), nn.GELU())
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([
            TorchEncoderLayer(n_hidden, n_hidden) for _ in range(n_layer)])

    def forward(self, w):
        out = self.pre(w)
        for layer in self.encoder.layers:
            out = layer(out)
        return out


class EpipolarFeatureTransformer(nn.Module):
    """Encode the context views once (:meth:`encode`), then query rays."""

    def __init__(self, config: EFTConfig = EFTConfig()):
        super().__init__()
        cfg = self.config = config
        self.encoder_model = resnet.ResNet18Features(cfg.in_dim)
        self.harmonic = HarmonicEmbedding(cfg.n_harmonic_functions,
                                          cfg.omega0)
        r = 2 if cfg.use_r else 1
        d_hid = cfg.intermediate_dim
        n = cfg.n_transformer_layers
        self.t1 = TransformerEncoder(
            cfg.ray_dim + cfg.depth_dim + cfg.patch_dim, d_hid, n)
        self.t2 = TransformerEncoder(
            r * cfg.ray_dim + cfg.depth_dim + d_hid, d_hid, n)
        self.t3 = TransformerEncoder(r * cfg.ray_dim + d_hid, d_hid, n)
        self.t2_attn = nn.Linear(d_hid, 1)
        self.t3_attn = nn.Linear(d_hid, 1)
        self.color_layer = nn.Sequential(nn.Linear(d_hid, cfg.out_dim))

    def encode(self, input_images: torch.Tensor) -> torch.Tensor:
        """(NC, 3, H, W) -> (NC, 512, H/2, W/2) feature pyramid."""
        return self.encoder_model(input_images)

    def encode_plucker(self, origins, dirs):
        return self.harmonic(torch.cat(
            [dirs, torch.linalg.cross(origins, dirs, dim=-1)], dim=-1))

    def forward(self, origins: torch.Tensor, directions: torch.Tensor,
                lengths: torch.Tensor, input_cameras: Cameras,
                input_images: torch.Tensor, encoder_latent: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Query a chunk of rays.

        Args:
            origins, directions: (N, 3) world rays (directions with unit
                view-space z, as the grid sampler makes them).
            lengths: (N, D) depths along each ray.
            input_cameras: NC context cameras (relative frame).
            input_images: (NC, 3, H, W).
            encoder_latent: (NC, 512, H/2, W/2) from :meth:`encode`.

        Returns:
            rgb (N, 3), features (N, 256).
        """
        cfg = self.config
        n, d = lengths.shape
        nc = input_images.shape[0]
        xyz = origins[:, None, :] + directions[:, None, :] * lengths[..., None]

        # epipolar projection into every context view; the reference
        # samples at the sign-flipped NDC
        xy_cam = transform_points_ndc(input_cameras,
                                      xyz.reshape(1, n * d, 3))[..., :2]
        grid = -xy_cam[:, :, None, :]                    # (NC, ND, 1, 2)

        def sample(img):
            out = F.grid_sample(img, grid, mode="bilinear",
                                padding_mode="border", align_corners=True)
            return out[..., 0].permute(0, 2, 1).reshape(nc, n, d, -1)

        features = torch.cat([sample(encoder_latent), sample(input_images)],
                             dim=-1)

        # rays from each context camera to the points
        origins_b = camera_centers(input_cameras)[:, None, None, :].expand(
            nc, n, d, 3)
        input_dirs = xyz[None] - origins_b
        input_dirs = input_dirs / torch.clamp(
            torch.linalg.norm(input_dirs, dim=-1, keepdim=True), min=1e-12)
        reference_plucker = self.encode_plucker(origins_b, input_dirs)

        depths = self.harmonic(lengths[..., None])          # (N, D, 13)
        depths_b = depths[None].expand(nc, n, d, cfg.depth_dim)

        q_dirs = directions / torch.clamp(
            torch.linalg.norm(directions, dim=-1, keepdim=True), min=1e-12)
        query_plucker = self.encode_plucker(origins, q_dirs)  # (N, 78)

        # T1: across context views, per epipolar point
        t1_in = torch.cat([reference_plucker, depths_b, features], dim=-1)
        t1_tokens = t1_in.permute(1, 2, 0, 3).reshape(n * d, nc, -1)
        f1 = self.t1(t1_tokens).reshape(n, d, nc, -1).permute(2, 0, 1, 3)

        # T2: across depth, per (view, ray), then attention-pooled
        qp = query_plucker[None, :, None, :].expand(nc, n, d, cfg.ray_dim)
        t2_parts = [qp, reference_plucker] if cfg.use_r else [qp]
        t2_in = torch.cat(t2_parts + [depths_b, f1], dim=-1)
        f2 = self.t2(t2_in.reshape(nc * n, d, -1)).reshape(nc, n, d, -1)
        t2_w = torch.softmax(self.t2_attn(f2).float(), dim=-2)
        f2 = (f2 * t2_w.to(f2.dtype)).sum(dim=-2)             # (NC, N, F)

        # T3: across views, per ray, then attention-pooled
        qp3 = query_plucker[None].expand(nc, n, cfg.ray_dim)
        rp3 = reference_plucker[:, :, d // 2, :]
        t3_parts = [qp3, rp3] if cfg.use_r else [qp3]
        t3_in = torch.cat(t3_parts + [f2], dim=-1)
        f3 = self.t3(t3_in.transpose(0, 1)).transpose(0, 1)  # (NC, N, F)
        t3_w = torch.softmax(self.t3_attn(f3).float(), dim=0)
        f3 = (f3 * t3_w.to(f3.dtype)).sum(dim=0)              # (N, F)

        rgb = self.color_layer(f3)
        if cfg.out_sigmoid:
            rgb = torch.sigmoid(rgb)
        return rgb.float(), f3.float()


def batched_forward(apply_fn: Callable, origins, directions, lengths,
                    n_batches: int):
    """Evaluate rays in ``n_batches`` equal chunks.

    ``origins``/``directions`` (..., 3), ``lengths`` (..., D); returns rgb
    (..., 3) and features (..., F).
    """
    spatial = origins.shape[:-1]
    total = origins[..., 0].numel()
    if total % n_batches:
        raise ValueError(f"{total} rays do not split into {n_batches} "
                         "equal chunks")
    o = origins.reshape(n_batches, -1, 3)
    d = directions.reshape(n_batches, -1, 3)
    ln = lengths.reshape(n_batches, -1, lengths.shape[-1])
    outs = [apply_fn(o[i], d[i], ln[i]) for i in range(n_batches)]
    rgb = torch.cat([r for r, _ in outs]).reshape(*spatial, -1)
    feat = torch.cat([f for _, f in outs]).reshape(*spatial, -1)
    return rgb, feat
