"""Operations and bytes of one train step, counted on the meta device.

    python -m sparsefusion_tpu_torch.tools.flops [--image_size 256]
        [--diffusion_batch_size 12]

``torch.utils.flop_counter.FlopCounterMode`` (two operations per
multiply-add) over the full-width modules built on the meta device: no
weights are allocated and nothing runs, so this is cheap on any host.
Per step of ``train/trainer.py``: the UNet's forward and backward at the
diffusion batch, the EFT's encode, render and backward at each context
size, the frozen VAE's encode of the query; and the bytes of the Adam
updates (parameter, gradient and both moments read, parameter and both
moments written: 28 bytes a trained parameter).  ``chip_smoke.py`` takes
the step's bound from these counts: :func:`step_bound_s` at the peak of
the step's precision on one H100 SXM (the data sheet's dense rates: 67
TFLOP/s f32 outside the tensor cores, 495 TF32, 989 bf16).
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from sparsefusion_tpu_torch.core.cameras import Cameras
from sparsefusion_tpu_torch.models import count_params
from sparsefusion_tpu_torch.nn.eft import EFTConfig, EpipolarFeatureTransformer
from sparsefusion_tpu_torch.nn.unet import EfficientUNet, UNetConfig
from sparsefusion_tpu_torch.nn.vae import AutoencoderKL, VAEConfig

ADAM_BYTES_PER_PARAM = 28
# NVIDIA H100 SXM, dense, operations per second
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
PRECISIONS = ("float32", "tf32", "bfloat16")


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def train_step_counts(image_size: int = 256, diffusion_batch_size: int = 12,
                      n_pts: int = 20, unet_config: UNetConfig = UNetConfig(),
                      vae_config: VAEConfig = VAEConfig(),
                      eft_config: EFTConfig = EFTConfig(),
                      context_sizes=(2, 3, 4, 5)) -> dict:
    """{name: count}: ``unet_fwd_per_sample``, ``unet_fwd_bwd`` (the
    diffusion batch, the features' gradient included), ``eft_fwd_bwd_nc<n>``
    per context size, ``vae_encode``, the parameter counts and
    ``adam_bytes`` (UNet and EFT)."""
    hw = image_size // 8
    dbs = diffusion_batch_size
    out = {}
    with torch.device("meta"):
        unet = EfficientUNet(unet_config)
        c = unet_config.cond_images_channels

        def unet_call(b, backward):
            feat = torch.zeros(b, c, hw, hw, requires_grad=backward)
            eps = unet(torch.zeros(b, unet_config.channels, hw, hw),
                       torch.zeros(b), feat, torch.ones(b, dtype=torch.bool))
            if backward:
                eps.sum().backward()

        out["unet_fwd_per_sample"] = _count(lambda: unet_call(1, False))
        out["unet_fwd_bwd"] = _count(lambda: unet_call(dbs, True))
        out["unet_params"] = count_params(unet)
        del unet

        eft = EpipolarFeatureTransformer(eft_config)
        n_rays = hw * hw
        for nc in context_sizes:
            def eft_call(nc=nc):
                img = torch.zeros(nc, 3, image_size, image_size)
                cams = Cameras(torch.zeros(nc, 3, 3), torch.zeros(nc, 3),
                               torch.ones(nc, 2), torch.zeros(nc, 2),
                               torch.full((nc, 2), float(image_size)))
                rgb, feat = eft(torch.zeros(n_rays, 3), torch.ones(n_rays, 3),
                                torch.ones(n_rays, n_pts), cams, img,
                                eft.encode(img))
                (rgb.sum() + feat.sum()).backward()

            out[f"eft_fwd_bwd_nc{nc}"] = _count(eft_call)
        out["eft_params"] = count_params(eft)
        del eft

        vae = AutoencoderKL(vae_config)
        with torch.no_grad():
            out["vae_encode"] = _count(lambda: vae.encode_mode(
                torch.zeros(1, 3, image_size, image_size)))
        out["vae_params"] = count_params(vae)
    out["adam_bytes"] = ADAM_BYTES_PER_PARAM * (out["unet_params"]
                                                + out["eft_params"])
    return out


def step_flops(counts: dict, n_context: int) -> int:
    """Operations of one step of one scene with ``n_context`` views."""
    return (counts["unet_fwd_bwd"] + counts[f"eft_fwd_bwd_nc{n_context}"]
            + counts["vae_encode"])


def step_bound_s(counts: dict, n_context: int,
                 precision: str = "float32") -> float:
    """The least seconds one step's operations take on one H100:
    ``float32`` all at the f32 peak; ``tf32`` (f32 storage, TF32 matmuls
    and convolutions: every counted operation) all at the TF32 peak;
    ``bfloat16`` (``--bf16``: the UNet in bf16) the UNet's forward and
    backward at the bf16 peak, the EFT and the VAE at the f32 peak."""
    other = counts[f"eft_fwd_bwd_nc{n_context}"] + counts["vae_encode"]
    if precision == "float32":
        return (counts["unet_fwd_bwd"] + other) / F32_OPS_PER_S
    if precision == "tf32":
        return (counts["unet_fwd_bwd"] + other) / TF32_OPS_PER_S
    if precision == "bfloat16":
        return counts["unet_fwd_bwd"] / BF16_OPS_PER_S + other / F32_OPS_PER_S
    raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--diffusion_batch_size", type=int, default=12)
    args = p.parse_args(argv)
    counts = train_step_counts(args.image_size, args.diffusion_batch_size)
    counts.update({f"step_flops_nc{nc}": step_flops(counts, nc)
                   for nc in (2, 3, 4, 5)})
    counts.update({f"step_bound_ms_{p}_nc{nc}":
                   step_bound_s(counts, nc, p) * 1e3
                   for p in PRECISIONS for nc in (2, 3, 4, 5)})
    print(json.dumps(counts, indent=1))


if __name__ == "__main__":
    main()
