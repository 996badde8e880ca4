"""Image sampling and resizing for NHWC tensors.

Frozen copy of the port's ``ops/image.py`` (the JAX ``sparsefusion_tpu/ops/image.py``'s counterpart), with the same index
conventions (those of torch's ``F.grid_sample`` with border padding and
``F.interpolate`` bilinear / nearest), written out on NHWC tensors so
the port's public functions keep the JAX package's layout.
"""
from __future__ import annotations

import torch


def grid_sample_bilinear(image: torch.Tensor, coords: torch.Tensor,
                         align_corners: bool = True) -> torch.Tensor:
    """Bilinear sampling with border padding.

    Args:
        image: (B, H, W, C).
        coords: (B, N, 2) in [-1, 1], last dim (x, y): x indexes width.

    Returns:
        (B, N, C) sampled values.
    """
    b, h, w, c = image.shape
    x, y = coords[..., 0], coords[..., 1]
    if align_corners:
        ix = (x + 1.0) * 0.5 * (w - 1)
        iy = (y + 1.0) * 0.5 * (h - 1)
    else:
        ix = ((x + 1.0) * w - 1.0) * 0.5
        iy = ((y + 1.0) * h - 1.0) * 0.5
    ix = torch.clamp(ix, 0.0, w - 1)
    iy = torch.clamp(iy, 0.0, h - 1)

    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    fx = (ix - ix0)[..., None]
    fy = (iy - iy0)[..., None]
    ix0 = ix0.long()
    iy0 = iy0.long()
    ix1 = torch.clamp(ix0 + 1, max=w - 1)
    iy1 = torch.clamp(iy0 + 1, max=h - 1)

    flat = image.reshape(b, h * w, c)

    def gather(iy_, ix_):
        idx = (iy_ * w + ix_)[..., None].expand(*iy_.shape, c)
        return torch.gather(flat, 1, idx)

    v00 = gather(iy0, ix0)
    v01 = gather(iy0, ix1)
    v10 = gather(iy1, ix0)
    v11 = gather(iy1, ix1)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _source_coords(out_size: int, in_size: int, align_corners: bool,
                   device) -> torch.Tensor:
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        if out_size == 1:
            return torch.zeros((1,), dtype=torch.float32, device=device)
        scale = (in_size - 1) / (out_size - 1)
        return i * scale
    scale = in_size / out_size
    return torch.clamp((i + 0.5) * scale - 0.5, 0.0, in_size - 1)


def resize_bilinear(image: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear')`` for NHWC images."""
    b, h, w, c = image.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return image
    sy = _source_coords(oh, h, align_corners, image.device)
    sx = _source_coords(ow, w, align_corners, image.device)
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (sy - y0)[None, :, None, None]
    fx = (sx - x0)[None, None, :, None]
    top = image[:, y0][:, :, x0] * (1 - fx) + image[:, y0][:, :, x1] * fx
    bot = image[:, y1][:, :, x0] * (1 - fx) + image[:, y1][:, :, x1] * fx
    return top * (1 - fy) + bot * fy


def resize_nearest(image: torch.Tensor, out_hw) -> torch.Tensor:
    """torch ``F.interpolate(mode='nearest')``: src = floor(dst * in/out)."""
    b, h, w, c = image.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return image
    ys = torch.clamp(torch.arange(oh, device=image.device) * h // oh,
                     max=h - 1)
    xs = torch.clamp(torch.arange(ow, device=image.device) * w // ow,
                     max=w - 1)
    return image[:, ys][:, :, xs]
