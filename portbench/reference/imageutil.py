"""Common numeric helpers (counterpart of ``sparsefusion_tpu/utils/image.py``)."""
from __future__ import annotations

import numpy as np
import torch


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1] with clipping."""
    return torch.clamp(x * 2.0 - 1.0, -1.0, 1.0)


def unnormalize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] with clipping."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def split_list(a, n):
    """Split a list into n nearly-equal parts."""
    k, m = divmod(len(a), n)
    return [a[i * k + min(i, m):(i + 1) * k + min(i + 1, m)]
            for i in range(n)]


def huber(x, y, scaling: float = 0.1):
    """Smooth-L1 used for the photometric losses."""
    diff_sq = (x - y) ** 2
    return (torch.sqrt(torch.clamp(1 + diff_sq / (scaling ** 2), min=1e-4))
            - 1.0) * scaling


def to_uint8(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def hwc_to_chw(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).movedim(-1, -3)


def chw_to_hwc(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).movedim(-3, -1)
