"""ResNet18 multi-scale feature trunk (NCHW), the EFT's image encoder.

Frozen copy of the port's ``nn/resnet.py`` (the JAX ``sparsefusion_tpu/nn/resnet.py``'s counterpart): conv1 / bn / relu,
layer1-3 of a torchvision resnet18 (layer4 unused), the four activations
bilinearly upsampled (align_corners=True) to the conv1 resolution and
concatenated: 64 + 64 + 128 + 256 = 512 channels at H/2.  Module names
are torchvision's, so its state dict loads with ``load_state_dict``
(``strict=False`` for the unused layer4 / fc).  Batch norm always uses
the running statistics, as the JAX package's inference path does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that normalises with its running statistics in every
    mode (same parameters and buffers as ``nn.BatchNorm2d``)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                FrozenBatchNorm2d(cout))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet18Features(nn.Module):
    """(N, 3, H, W) -> (N, 512, H/2, W/2) feature pyramid."""

    def __init__(self, in_dim: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2),
                                    BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2),
                                    BasicBlock(256, 256))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        latents = [h]
        h = F.max_pool2d(h, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3):
            h = layer(h)
            latents.append(h)
        size = latents[0].shape[-2:]
        ups = [latents[0]] + [
            F.interpolate(lat, size=size, mode="bilinear",
                          align_corners=True) for lat in latents[1:]]
        return torch.cat(ups, dim=1)
