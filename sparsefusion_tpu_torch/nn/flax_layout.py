"""The JAX package's parameter layout, seen from the port's modules.

Two things every network of the port needs from the Flax side:

* :func:`init_like_flax_` draws fresh weights from an explicit generator
  with the distributions Flax's defaults use (lecun-normal kernels, zero
  biases, unit norm scales), so a model at random initialisation has the
  statistics of the JAX package's.
* :func:`load_flax_tree` copies a JAX parameter tree (nested dicts of
  numpy arrays) into a module, given the pairs (torch module name, JAX
  module path) of one model.  Flax and the reference torch layout differ
  only by transposes (``train/convert.py`` of the JAX package lists
  them): conv kernels are (kh, kw, in, out), dense kernels (in, out), a
  1x1 conv used as a dense layer is a dense kernel, norm weights are
  "scale", batch statistics live in a separate "batch_stats" tree.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)
# leaves drawn from a standard normal in the JAX package (null key/value
# pairs, learned Fourier frequencies, the Perceiver's positions and latents)
_NORMAL_LEAVES = ("null_kv", "weights", "pos_emb", "latents")


def _lecun_normal_(w: torch.Tensor, generator) -> None:
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_like_flax_(module: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every parameter and buffer of ``module`` in place."""
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if isinstance(m, _NORMS) or name == "g":
                p.fill_(1.0 if name in ("weight", "g") else 0.0)
            elif name in _NORMAL_LEAVES:
                p.normal_(0.0, 1.0, generator=generator)
            elif name.endswith("bias"):
                p.zero_()
            else:
                _lecun_normal_(p, generator)
        for name, b in m.named_buffers(recurse=False):
            b.fill_(1 if name == "running_var" else 0)


def _leaf(module: nn.Module, name: str) -> Tuple[str, str]:
    """(tree, leaf) of a torch parameter or buffer in the Flax layout."""
    if name == "running_mean":
        return "batch_stats", "mean"
    if name == "running_var":
        return "batch_stats", "var"
    if name in ("weight", "in_proj_weight"):
        return "params", "scale" if isinstance(module, _NORMS) else "kernel"
    if name == "in_proj_bias":
        return "params", "bias"
    return "params", name


def _to_torch_layout(a: np.ndarray, leaf: str, shape) -> np.ndarray:
    a = np.asarray(a, np.float32)
    if leaf == "kernel" and a.ndim == 4:     # conv (kh, kw, in, out)
        a = np.transpose(a, (3, 2, 0, 1))
    elif leaf == "kernel":                   # dense (in, out)
        a = a.T
        if len(shape) == 4:                  # ... of a 1x1 conv
            a = a[:, :, None, None]
    if a.shape != tuple(shape):
        a = a.reshape(shape)                 # a channel gamma (1, C, 1, 1)
    return a


def _get(tree: Dict, path: str):
    node = tree
    for part in filter(None, path.split("/")):
        if part not in node:
            raise KeyError(f"{path}: no '{part}' in the JAX tree")
        node = node[part]
    return node


@torch.no_grad()
def load_flax_tree(module: nn.Module, pairs: Iterable[Tuple[str, str]],
                   params: Dict, batch_stats: Optional[Dict] = None) -> None:
    """Copy ``params`` (and ``batch_stats``) into ``module``.

    ``pairs`` maps torch module names to JAX module paths ("a/b/c");
    pairs whose torch module does not exist are skipped.  Every
    parameter and statistic of ``module`` must be covered exactly once.
    """
    trees = {"params": params, "batch_stats": batch_stats or {}}
    modules = dict(module.named_modules())
    done = set()
    for tname, jpath in pairs:
        m = modules.get(tname)
        if m is None:
            continue
        own = list(m.named_parameters(recurse=False)) + [
            (n, b) for n, b in m.named_buffers(recurse=False)
            if n != "num_batches_tracked"]
        for name, dst in own:
            tree, leaf = _leaf(m, name)
            src = _to_torch_layout(_get(trees[tree], f"{jpath}/{leaf}"),
                                   leaf, dst.shape)
            dst.copy_(torch.from_numpy(np.array(src, np.float32)))
            full = f"{tname}.{name}" if tname else name
            if full in done:
                raise ValueError(f"{full} loaded twice")
            done.add(full)
    missing = [n for n, _ in module.named_parameters() if n not in done]
    missing += [n for n, _ in module.named_buffers()
                if n not in done and not n.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"no JAX leaf for {missing[:5]} "
                         f"({len(missing)} in all)")
