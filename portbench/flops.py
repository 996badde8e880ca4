"""Operations and bytes of the benchmark's units of work, and the chip's
peaks.

Operations are counted as ``torch.utils.flop_counter.FlopCounterMode``
counts them (two per multiply-add, matrix products and convolutions)
over the reference's modules built on the meta device: nothing is
allocated and nothing runs.  A forward and a backward are each counted
once; recomputation (the renderer's checkpointed chunks) is not counted.
K1's least time is its bytes at the chip's bandwidth: each launch's
points and table read once, its output written once.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.cameras import Cameras
from portbench.reference.eft import EFTConfig, EpipolarFeatureTransformer
from portbench.reference.grid_encode import GridEncoding
from portbench.reference.ngp import NGPConfig
from portbench.reference.unet import EfficientUNet, UNetConfig
from portbench.reference.vae import AutoencoderKL, VAEConfig

# NVIDIA H100 SXM data sheet, dense: operations a second by precision,
# and HBM bytes a second
PEAK_OPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def peak_ops(config: dict) -> float:
    """The configuration's precision's peak (f32 with TF32 off: the f32
    rate outside the tensor cores)."""
    precision = config["precision"]
    if precision == "float32" and config.get("tf32"):
        precision = "tf32"
    return PEAK_OPS[precision]


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def _key(d: dict) -> tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in d.items()))


def _cfg(cls, key: tuple):
    return cls(**dict(key))


@functools.lru_cache(maxsize=None)
def _unet(key: tuple, batch: int, backward: bool, hw: int) -> int:
    cfg = _cfg(UNetConfig, key)
    with torch.device("meta"):
        unet = EfficientUNet(cfg)

        def call():
            feat = torch.zeros(batch, cfg.cond_images_channels, hw, hw,
                               requires_grad=backward)
            eps = unet(torch.zeros(batch, cfg.channels, hw, hw),
                       torch.zeros(batch), feat,
                       torch.ones(batch, dtype=torch.bool))
            if backward:
                eps.sum().backward()

        return _count(call)


def unet_fwd(unet: dict, batch: int = 1, hw: int = 32) -> int:
    """One UNet forward at ``batch`` on ``hw`` x ``hw`` latents."""
    return _unet(_key(unet), batch, False, hw)


def unet_fwd_bwd(unet: dict, batch: int, hw: int = 32) -> int:
    """A UNet forward and backward at ``batch`` on ``hw`` x ``hw``
    latents, the conditioning features' gradient included."""
    return _unet(_key(unet), batch, True, hw)


@functools.lru_cache(maxsize=None)
def _vae(key: tuple, image_size: int, decode: bool) -> int:
    with torch.device("meta"), torch.no_grad():
        vae = AutoencoderKL(_cfg(VAEConfig, key))
        if decode:
            z = torch.zeros(1, vae.config.z_channels, image_size // 8,
                            image_size // 8)
            return _count(lambda: vae.decode(z))
        x = torch.zeros(1, 3, image_size, image_size)
        return _count(lambda: vae.encode_mode(x))


def vae_encode(vae: dict, image_size: int) -> int:
    return _vae(_key(vae), image_size, False)


def vae_decode(vae: dict, image_size: int) -> int:
    return _vae(_key(vae), image_size, True)


@functools.lru_cache(maxsize=None)
def _eft(key: tuple, image_size: int, n_context: int, n_rays: int,
         n_pts: int) -> int:
    with torch.device("meta"):
        eft = EpipolarFeatureTransformer(_cfg(EFTConfig, key))
        nc = n_context

        def call():
            img = torch.zeros(nc, 3, image_size, image_size)
            cams = Cameras(torch.zeros(nc, 3, 3), torch.zeros(nc, 3),
                           torch.ones(nc, 2), torch.zeros(nc, 2),
                           torch.full((nc, 2), float(image_size)))
            rgb, feat = eft(torch.zeros(n_rays, 3), torch.ones(n_rays, 3),
                            torch.ones(n_rays, n_pts), cams, img,
                            eft.encode(img))
            (rgb.sum() + feat.sum()).backward()

        return _count(call)


def eft_fwd_bwd(eft: dict, image_size: int, n_context: int, n_rays: int,
                n_pts: int) -> int:
    """The EFT's encode of ``n_context`` views and its render of
    ``n_rays`` rays of ``n_pts`` depths, forward and backward."""
    return _eft(_key(eft), image_size, n_context, n_rays, n_pts)


def ngp_mlp_fwd_bwd(ngp: dict, n_points: int) -> int:
    """The NGP field's MLP on ``n_points`` encoded points, forward and
    backward (the encode itself is gathers, no products)."""
    cfg = NGPConfig(**ngp)
    width_in = cfg.num_levels * cfg.level_dim
    dims = [width_in] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [4]
    with torch.device("meta"):
        layers = [torch.nn.Linear(a, b) for a, b in zip(dims, dims[1:])]
        h0 = torch.zeros(n_points, width_in, requires_grad=True)

        def call():
            h = h0
            for i, layer in enumerate(layers):
                h = layer(h)
                if i < len(layers) - 1:
                    h = torch.relu(h)
            h.sum().backward()

        return _count(call)


def k1_launch_bytes(enc: GridEncoding, n_points: int) -> dict:
    """Least bytes of one K1 forward and one backward launch over
    ``n_points`` f32 points: the points (12 bytes) and the table read
    once and the (L * C) f32 features written once; backward, the points
    and the features' gradient read once and the table's gradient
    written once."""
    table = enc.total_params * enc.level_dim * 4
    feats = n_points * enc.num_levels * enc.level_dim * 4
    points = n_points * enc.input_dim * 4
    return {"forward": points + table + feats,
            "backward": points + feats + table}


def render_work(distill: dict, ngp: dict, enc: GridEncoding,
                image_size: int) -> tuple:
    """(operations, K1 least seconds) of one render of ``render_hw^2``
    rays with its gradient: each ``max_ray_batch`` chunk evaluates the
    field on ``num_steps`` and then ``upsample_steps`` samples a ray,
    forward and backward."""
    hw = image_size // distill["hw_scale"]
    rays = hw * hw
    chunk = min(distill["max_ray_batch"], rays)
    passes = [distill["num_steps"], distill["upsample_steps"]]
    ops = ngp_mlp_fwd_bwd(ngp, rays * sum(passes))
    k1_s = 0.0
    for s in passes:
        b = k1_launch_bytes(enc, chunk * s)
        k1_s += (rays // chunk) * (b["forward"] + b["backward"]) / PEAK_BYTES
    return ops, k1_s


def plms_evals(max_thres: float, plms_steps: int) -> int:
    """UNet evaluations of a partial-noise PLMS chain from ``max_thres``
    (cond_scale 1): the pseudo improved-Euler first step takes two, each
    later step one."""
    full = max_thres >= 0.99
    n = plms_steps if full else min(int(max_thres * plms_steps * 2),
                                    plms_steps)
    return 0 if n == 0 else n + 1
