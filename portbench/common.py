"""What the cells' run loops share: the program's models and scenes
built from the benchmark's inputs, the reference's models, and the norms
the check compares."""
from __future__ import annotations

import torch

from portbench import spec, weights


def port_scene(scene):
    from sparsefusion_tpu_torch.data.contract import SceneData

    return SceneData(images=scene.images, R=scene.R, T=scene.T, f=scene.f,
                     c=scene.c, valid_region=scene.valid_region,
                     image_size=scene.image_size, masks=scene.masks,
                     sequence_name=scene.sequence_name)


def build_port_models(config: dict, seed: int, device):
    """The program's trio (``models.build_models``) with the benchmark's
    weights drawn from ``seed``."""
    from sparsefusion_tpu_torch.diffusion.ddpm import DDPMConfig
    from sparsefusion_tpu_torch.models import build_models
    from sparsefusion_tpu_torch.nn.eft import EFTConfig
    from sparsefusion_tpu_torch.nn.unet import UNetConfig
    from sparsefusion_tpu_torch.nn.vae import VAEConfig

    sizes = spec.program_sizes(config)
    gen = torch.Generator(device=device).manual_seed(0)
    models = build_models(gen, device,
                          unet_config=UNetConfig(**sizes["unet"]),
                          vae_config=VAEConfig(**sizes["vae"]),
                          eft_config=EFTConfig(**sizes["eft"]),
                          ddpm_config=DDPMConfig(**sizes["ddpm"]))
    for k, m in enumerate((models.eft, models.vae, models.unet)):
        weights.fill(m, spec.sub_seed(seed, spec.SEED_WEIGHTS, k))
    return models


def reference_models(config: dict, seed: int, device,
                     tf32_diffusion: bool = False):
    """The reference's trio with the seed's weights; ``tf32_diffusion``:
    the UNet and VAE compute with TF32 on (a control)."""
    from portbench.reference import sparsefusion as ref

    sizes = spec.program_sizes(config)
    fills = iter(spec.sub_seed(seed, spec.SEED_WEIGHTS, k) for k in range(3))
    models = ref.build_models(sizes, lambda m: weights.fill(m, next(fills)),
                              device)
    models.tf32 = tf32_diffusion
    return models


def readings(out: dict, program_end=None) -> dict:
    """Norms of a followed run: its losses, each leaf's first moment and
    change, and the sampler's outputs (in f64 on the host); with
    ``program_end``, the program's change from the same start."""
    start = out["start"]
    res = {"losses": out["losses"],
           "targets": [t.to("cpu", torch.float64)
                       for t in out.get("targets", [])],
           "moment": {n: float(t.double().norm())
                      for n, t in out["moment"].items()},
           "change": {n: float((out["end"][n] - start[n]).double().norm())
                      for n in start}}
    if program_end is not None:
        res["program_change"] = {
            n: float((program_end[n].to(start[n].device) - start[n])
                     .double().norm())
            for n in start if n in program_end}
    return res


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def marks(points: dict, t0: float) -> dict:
    """Set-up's milestones as seconds from the process's start."""
    return {k: v - t0 for k, v in points.items()}
