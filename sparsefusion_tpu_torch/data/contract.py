"""The dataset dict contract, as a typed scene container.

Counterpart of ``sparsefusion_tpu/data/contract.py``.  The reference's
``__getitem__`` contract: R (B,3,3), T (B,3), f/c (B,2) NDC intrinsics,
images (B,3,H,W), valid_region (B,1,H,W), image_size (B,2), plus
'masks' where foreground masks exist.  Scenes are stored as NHWC numpy
arrays, the JAX package's layout; :meth:`SceneData.cameras` puts the
cameras on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sparsefusion_tpu_torch.core.cameras import Cameras


@dataclasses.dataclass
class SceneData:
    """One scene (sequence of posed frames)."""

    images: np.ndarray          # (N, H, W, 3) float32 in [0, 1]
    R: np.ndarray               # (N, 3, 3)
    T: np.ndarray               # (N, 3)
    f: np.ndarray               # (N, 2) NDC focal
    c: np.ndarray               # (N, 2) NDC principal point
    valid_region: np.ndarray    # (N, H, W, 1) float32 {0, 1}
    image_size: np.ndarray      # (N, 2) (H, W) pixels
    masks: Optional[np.ndarray] = None   # (N, H, W, 1) fg probability
    bbox: Optional[np.ndarray] = None    # (N, 4) NDC valid bbox
    sequence_name: str = ""

    def __len__(self) -> int:
        return self.images.shape[0]

    def cameras(self, device=None) -> Cameras:
        return Cameras.create(self.R, self.T, self.f, self.c,
                              self.image_size, device=device)

    @staticmethod
    def from_reference_dict(d, sequence_name: str = "") -> "SceneData":
        """Build from the torch dict contract (tensors or arrays)."""

        def arr(x):
            if x is None:
                return None
            if hasattr(x, "detach"):
                x = x.detach().cpu().numpy()
            return np.asarray(x, np.float32)

        images = np.moveaxis(arr(d["images"]), 1, -1)  # NCHW -> NHWC
        valid = arr(d.get("valid_region"))
        if valid is None:
            valid = np.ones((*images.shape[:3], 1), np.float32)
        else:
            valid = np.moveaxis(valid, 1, -1)
        masks = arr(d.get("masks"))
        if masks is not None:
            masks = np.moveaxis(masks, 1, -1)
        image_size = arr(d.get("image_size"))
        if image_size is None:
            n, h, w = images.shape[:3]
            image_size = np.tile([[h, w]], (n, 1)).astype(np.float32)
        return SceneData(
            images=images, R=arr(d["R"]), T=arr(d["T"]), f=arr(d["f"]),
            c=arr(d["c"]), valid_region=valid, image_size=image_size,
            masks=masks, bbox=arr(d.get("bbox")),
            sequence_name=sequence_name)

    def to_reference_dict(self):
        """Export back to the documented torch-layout contract (numpy)."""
        out = {
            "images": np.moveaxis(self.images, -1, 1),
            "R": self.R, "T": self.T, "f": self.f, "c": self.c,
            "valid_region": np.moveaxis(self.valid_region, -1, 1),
            "image_size": self.image_size,
        }
        if self.masks is not None:
            out["masks"] = np.moveaxis(self.masks, -1, 1)
        if self.bbox is not None:
            out["bbox"] = self.bbox
        return out
