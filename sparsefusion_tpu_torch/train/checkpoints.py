"""The port's training checkpoints, and import of reference checkpoints.

Counterpart of ``sparsefusion_tpu/train/checkpoints.py``.  A training
checkpoint (:func:`save_checkpoint`) is one ``torch.save`` file of the
trainer's state (step, model state dicts, optimizers with their schedules
and guard counts, random states), written to a temporary file and renamed
into place, so a reader never sees half a checkpoint.

The port's module names are the reference's, so a checkpoint loads with
``load_state_dict`` once its prefixes are handled:

* EFT: ``model_state_dict`` of the EFT checkpoint, which also holds the
  whole torchvision resnet18 (``encoder_model.*``; layer4 and fc unused);
* VLDM: ``model_state_dict`` with the UNet under ``unets.0.``;
* SD VAE: ``state_dict`` with ``first_stage_model.`` / ``model.`` prefixes
  (:func:`strip_sd_prefixes`);
* resnet18: a torchvision state dict for the EFT trunk alone.

An ``.npz`` path is a JAX parameter tree saved by the JAX package's
``tools/convert_weights.py`` ("a/b/c" keys) and goes through the models'
``load_jax_params``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def save_checkpoint(path: str, state: Dict) -> None:
    """``torch.save`` ``state`` to ``path``: a temporary file beside it,
    then an atomic rename."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore_checkpoint(path: str, map_location="cpu") -> Dict:
    """The state a :func:`save_checkpoint` wrote (a file this program
    wrote, so it is unpickled in full)."""
    return torch.load(path, map_location=map_location, weights_only=False)


def strip_sd_prefixes(sd: Dict) -> Dict:
    """The reference's SD-VAE key rename."""
    return {k.replace("first_stage_model.", "").replace("model.", ""): v
            for k, v in sd.items()}


def load_torch_state_dict(path: str, key: Optional[str] = "model_state_dict"):
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None and key in ckpt:
        return ckpt[key]
    if "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def load_npz_pytree(path: str) -> Dict:
    """A flat "a/b/c"-keyed npz back into a nested dict of arrays."""
    tree: Dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return tree


def load_prefixed(module: nn.Module, sd: Dict, prefix: str = "") -> None:
    """Load the entries of ``sd`` under ``prefix`` that ``module`` has;
    every parameter and buffer of ``module`` must be among them (batch
    norm's ``num_batches_tracked`` excepted)."""
    own = module.state_dict()
    picked = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix) and k[len(prefix):] in own}
    missing = [k for k in own if k not in picked
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} entries of "
                       f"{type(module).__name__}, e.g. {missing[:3]}")
    module.load_state_dict(picked, strict=False)


def maybe_import_reference_weights(models, eft_ckpt: Optional[str] = None,
                                   vae_ckpt: Optional[str] = None,
                                   vldm_ckpt: Optional[str] = None,
                                   verbose: bool = True):
    """Load whichever checkpoints exist into the bundle; the printout
    follows the reference's load order."""
    from sparsefusion_tpu_torch.nn import eft, unet, vae

    if eft_ckpt and os.path.exists(eft_ckpt):
        if eft_ckpt.endswith(".npz"):
            eft.load_jax_params(models.eft, load_npz_pytree(eft_ckpt))
        else:
            load_prefixed(models.eft, load_torch_state_dict(eft_ckpt))
        if verbose:
            print("LOADING 1/3 loaded eft checkpoint from", eft_ckpt)
    elif verbose:
        print("LOADING 1/3 initialized eft from scratch")

    if vae_ckpt and os.path.exists(vae_ckpt):
        if vae_ckpt.endswith(".npz"):
            vae.load_jax_params(models.vae, load_npz_pytree(vae_ckpt))
        else:
            load_prefixed(models.vae, strip_sd_prefixes(
                load_torch_state_dict(vae_ckpt, key="state_dict")))
        if verbose:
            print("LOADING 2/3 loaded sd vae from", vae_ckpt)
    elif verbose:
        print("LOADING 2/3 initialized vae from scratch")

    if vldm_ckpt and os.path.exists(vldm_ckpt):
        if vldm_ckpt.endswith(".npz"):
            unet.load_jax_params(models.unet, load_npz_pytree(vldm_ckpt))
        else:
            load_prefixed(models.unet, load_torch_state_dict(vldm_ckpt),
                          prefix="unets.0.")
        if verbose:
            print("LOADING 3/3 loaded diffusion from", vldm_ckpt)
    elif verbose:
        print("LOADING 3/3 loaded diffusion from scratch")
    return models


def import_resnet18_trunk(models, path: Optional[str], verbose: bool = True):
    """Load a torchvision resnet18 state dict into the EFT trunk (the
    reference starts the EFT from an ImageNet resnet18)."""
    if not path or not os.path.exists(path):
        if verbose and path:
            print(f"WARNING: resnet18 weights not found at {path}; "
                  "EFT trunk stays randomly initialized")
        return models
    if path.endswith(".npz"):
        from sparsefusion_tpu_torch.nn import resnet
        from sparsefusion_tpu_torch.nn.flax_layout import load_flax_tree

        tree = load_npz_pytree(path)
        load_flax_tree(models.eft.encoder_model, resnet.jax_module_pairs(),
                       tree["params"], tree["batch_stats"])
    else:
        sd = load_torch_state_dict(path, key=None)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        load_prefixed(models.eft.encoder_model, sd)
    if verbose:
        print("loaded pretrained resnet18 trunk from", path)
    return models
