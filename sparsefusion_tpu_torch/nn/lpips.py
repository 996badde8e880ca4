"""LPIPS (VGG16) perceptual distance.

Counterpart of ``sparsefusion_tpu/nn/lpips.py``, the reference's
``lpips.LPIPS(net='vgg')``: VGG16 features at relu1_2 / relu2_2 /
relu3_3 / relu4_3 / relu5_3, each normalised to unit length over its
channels, squared differences through non-negative 1x1 "lin" heads, the
spatial mean, summed over the five layers.

The modules keep the torch layouts the weights come in: ``VGG16Features``
names its convolutions ``features.{i}`` as torchvision's ``vgg16`` does,
and the heads are ``lin{i}.model.1.weight`` (1, C, 1, 1) as in the lpips
package, so both state dicts load as they are.  ``LPIPS`` keeps the JAX
interface: (B, H, W, 3) images in, (B,) distances out.  The channel norm
is ``x / max(|x|, 1e-10)``, as in the JAX package (the lpips package
divides by ``|x| + 1e-10``, which differs near zero).  The convolutions
are ``torch.nn.functional.conv2d``: the JAX package runs them as XLA
convolutions outside any Pallas kernel.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from sparsefusion_tpu_torch.nn.flax_layout import load_flax_tree

# torchvision VGG16: conv widths per stage, 2x2 max pools between stages
_VGG_PLAN = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
             (512, 512, 512))
# the index of each conv in torchvision's vgg16.features
TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# the lpips ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """torchvision's ``vgg16().features`` up to relu5_3; returns the five
    relu stage outputs (NCHW)."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for stage, widths in enumerate(_VGG_PLAN):
            for w in widths:
                layers += [nn.Conv2d(cin, w, 3, padding=1),
                           nn.ReLU(inplace=False)]
                cin = w
            if stage < len(_VGG_PLAN) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        # the index after each stage's last relu
        self._stage_ends = (4, 9, 16, 23, 30)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, start = [], 0
        for end in self._stage_ends:
            for layer in self.features[start:end]:
                x = layer(x)
            feats.append(x)
            start = end
        return feats


class _Lin(nn.Module):
    """lpips' ``NetLinLayer``: ``model.1`` is the 1x1 conv to one channel
    (``model.0``, a dropout in training, is the identity here)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """``lpips.LPIPS(net='vgg')``: the distance between two images."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, widths in enumerate(_VGG_PLAN):
            setattr(self, f"lin{i}", _Lin(widths[-1]))
        # the scaling layer's constants by (device, dtype), each copied to
        # the device once: a copy from the host at every call would stall
        # the loop and cannot be captured in a CUDA graph
        self._consts = {}

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                normalize: bool = False) -> torch.Tensor:
        """img0 / img1: (B, H, W, 3), in [0, 1] if ``normalize`` else in
        [-1, 1].  Returns (B,)."""
        if normalize:
            img0 = 2 * img0 - 1
            img1 = 2 * img1 - 1
        key = (img0.device, img0.dtype)
        if key not in self._consts:
            self._consts[key] = (img0.new_tensor(_SHIFT),
                                 img0.new_tensor(_SCALE))
        shift, scale = self._consts[key]

        def feats(img):
            return self.vgg(((img - shift) / scale).permute(0, 3, 1, 2))

        total = 0.0
        for i, (a, b) in enumerate(zip(feats(img0), feats(img1))):
            a = a / torch.clamp(torch.linalg.vector_norm(
                a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(
                b, dim=1, keepdim=True), min=1e-10)
            lin = getattr(self, f"lin{i}").model[1]
            total = total + lin((a - b) ** 2).mean(dim=(1, 2, 3))
        return total

    def load_torch_weights(self, vgg_state_dict: Dict,
                           lin_state_dict: Dict) -> "LPIPS":
        """A torchvision ``vgg16`` state dict (its ``features.*`` keys;
        ``classifier.*`` is ignored) and an lpips ``lin{i}.model.1.weight``
        state dict, loaded as they are."""
        vgg = {f"vgg.{k}": v for k, v in vgg_state_dict.items()
               if k.startswith("features.")}
        lin = {k: v for k, v in lin_state_dict.items()
               if k.startswith("lin")}
        self.load_state_dict({**vgg, **lin})
        return self


def _jax_pairs():
    """(torch module, JAX module path) of every layer with weights."""
    pairs = [(f"vgg.features.{t}", f"vgg/conv_{j}")
             for j, t in enumerate(TORCH_CONV_IDX)]
    return pairs + [(f"lin{i}.model.1", f"lin_{i}")
                    for i in range(len(_VGG_PLAN))]


def _empty(device=None) -> LPIPS:
    """An LPIPS whose weights are allocated but not drawn (every caller
    loads them)."""
    with torch.device("meta"):
        model = LPIPS()
    return model.to_empty(device=device or "cpu")


def lpips_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX ``LPIPS`` params (nested dicts of numpy arrays, as
    ``convert_lpips_weights`` makes them) as this module's state dict:
    the inverse of that converter."""
    model = _empty()
    load_flax_tree(model, _jax_pairs(), params)
    return model.state_dict()


def load_lpips(weights_path: Optional[str] = None,
               device=None) -> Optional[LPIPS]:
    """An LPIPS with the weights of a JAX ``.npz``, in either of its forms:
    a pickled ``params`` tree, or flat ``a/b/c`` keys.  None when no path
    is given or the file does not exist."""
    if weights_path is None or not os.path.exists(weights_path):
        return None
    data = np.load(weights_path, allow_pickle=True)
    if "params" in data and data["params"].dtype == object:
        params = data["params"].item()
    else:
        from sparsefusion_tpu_torch.train.checkpoints import load_npz_pytree

        params = load_npz_pytree(weights_path)
    model = _empty(device)
    model.load_state_dict(lpips_state_dict_from_jax(params))
    return model


def _load_pair(spec: str, device) -> Optional[LPIPS]:
    vgg_path, lin_path = (s.strip() for s in spec.split(",", 1))
    if not (os.path.exists(vgg_path) and os.path.exists(lin_path)):
        return None
    vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=False)
    if hasattr(vgg_sd, "state_dict"):
        vgg_sd = vgg_sd.state_dict()
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=False)
    if "state_dict" in lin_sd:
        lin_sd = lin_sd["state_dict"]
    return _empty(device).load_torch_weights(vgg_sd, lin_sd)


def build_lpips_fn(spec: Optional[str], device=None) -> Optional[Callable]:
    """CLI entry: ``lpips_fn(img0_01, img1_01) -> (B,)`` on ``device`` from
    a converted ``.npz`` (:func:`load_lpips`) or a
    ``'vgg16.pth,lpips_vgg.pth'`` pair of torch state dicts.  Returns None
    when the weights are not there (with the JAX package's warning), and
    the caller runs without the perceptual term.  The weights are frozen:
    a backward through ``lpips_fn`` computes only the images' gradient."""
    if not spec:
        return None
    model = _load_pair(spec, device) if "," in spec else \
        load_lpips(spec, device)
    if model is None:
        print(f"WARNING: lpips weights not found ({spec}); "
              "perceptual loss disabled")
        return None
    model.eval().requires_grad_(False)

    def lpips_fn(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        return model(img0, img1, normalize=True)

    return lpips_fn
