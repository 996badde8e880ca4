"""Seeded weights, drawn on the device in a few large calls.

:func:`fill` draws every parameter of a module from one ``torch.Generator``
seeded by the run: norm scales 1 and biases 0, the leaves the JAX package
draws from a standard normal (null key/values, learned frequencies) at
unit scale, every other kernel lecun-normal (sd ``1 / sqrt(fan_in)``),
the UNet's final convolution included, so that the UNet's output is not
zero and the sampler's arithmetic shows in what the check compares.
The normal draws of all leaves are made in chunks of at most
``CHUNK`` numbers and cut into the leaves in the order of their sorted
names, so the same seed gives the program's modules and the reference's,
which share their parameter names, the same weights.
"""
from __future__ import annotations

import math

import torch
from torch import nn

_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)
_UNIT_LEAVES = ("null_kv", "weights", "pos_emb", "latents")
CHUNK = 1 << 27


def _rule(module: nn.Module, name: str, p: torch.Tensor):
    """(constant, None) or (None, standard deviation) of one leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if isinstance(module, _NORMS) or leaf == "g":
        return (1.0 if leaf in ("weight", "g") else 0.0), None
    if leaf in _UNIT_LEAVES:
        return None, 1.0
    if leaf.endswith("bias"):
        return 0.0, None
    return None, 1.0 / math.sqrt(max(1, p[0].numel()))


@torch.no_grad()
def fill(module: nn.Module, seed: int) -> None:
    """Draw ``module``'s parameters and batch statistics in place from
    ``seed``, on the module's device."""
    owners = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = (m, p)
        for bname, b in m.named_buffers(recurse=False):
            if bname in ("running_mean", "running_var"):
                b.fill_(1.0 if bname == "running_var" else 0.0)
            elif bname == "num_batches_tracked":
                b.zero_()
    drawn = []
    for name in sorted(owners):
        m, p = owners[name]
        const, std = _rule(m, name, p)
        if const is not None:
            p.fill_(const)
        else:
            drawn.append((p, std))
    if not drawn:
        return
    device = drawn[0][0].device
    gen = torch.Generator(device=device).manual_seed(seed)
    i = 0
    while i < len(drawn):
        group, n = [], 0
        while i < len(drawn) and (not group or
                                  n + drawn[i][0].numel() <= CHUNK):
            group.append(drawn[i])
            n += drawn[i][0].numel()
            i += 1
        flat = torch.randn(n, generator=gen, device=device)
        at = 0
        for p, std in group:
            k = p.numel()
            p.copy_(flat[at:at + k].view_as(p).mul_(std))
            at += k
        del flat
