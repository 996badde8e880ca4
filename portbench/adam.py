"""The least bytes of the train step's Adam: for each trained parameter
its value, gradient and two moments read and its value and two moments
written, 7 x 4 bytes in f32, over the parameters of the reference's
UNet and, with ``train_eft``, EFT (built on the meta device)."""
from __future__ import annotations

import functools
import json

import torch

BYTES_PER_PARAM = 7 * 4


@functools.lru_cache(maxsize=None)
def _trained_params(config_json: str) -> int:
    from portbench import spec
    from portbench.reference.eft import EFTConfig, EpipolarFeatureTransformer
    from portbench.reference.unet import EfficientUNet, UNetConfig

    config = json.loads(config_json)
    sizes = spec.program_sizes(config)
    with torch.device("meta"):
        modules = [EfficientUNet(UNetConfig(**sizes["unet"]))]
        if config["train"]["train_eft"]:
            modules.append(EpipolarFeatureTransformer(
                EFTConfig(**sizes["eft"])))
    return sum(p.numel() for m in modules for p in m.parameters())


def trained_params(config: dict) -> int:
    return _trained_params(json.dumps(config, sort_keys=True))


def step_bytes(config: dict) -> int:
    """Adam's least bytes a train step."""
    return BYTES_PER_PARAM * trained_params(config)
