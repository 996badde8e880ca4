"""Image quality metrics: PSNR and SSIM in numpy, without skimage.

Counterpart of ``sparsefusion_tpu/utils/metrics.py``.  SSIM follows
Wang et al. with skimage's defaults: uniform 7x7 window, K1=0.01,
K2=0.03, per channel then averaged, sample covariance (N/(N-1)).
"""
from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    mse = np.mean((pred - gt) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    """Same-size box filter with symmetric padding, via an integral image."""
    pad = size // 2
    padded = np.pad(img, ((pad, pad), (pad, pad)), mode="symmetric")
    c = np.cumsum(np.cumsum(padded, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    h, w = img.shape
    out = (c[size:size + h, size:size + w] - c[size:size + h, :w]
           - c[:h, size:size + w] + c[:h, :w])
    return out / (size * size)


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM over channels; crops the window margin like skimage."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred = pred[..., None]
        gt = gt[..., None]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    nw = win_size * win_size
    cov_norm = nw / (nw - 1)

    vals = []
    pad = (win_size - 1) // 2
    for ch in range(pred.shape[-1]):
        x = pred[..., ch]
        y = gt[..., ch]
        ux = _uniform_filter(x, win_size)
        uy = _uniform_filter(y, win_size)
        uxx = _uniform_filter(x * x, win_size)
        uyy = _uniform_filter(y * y, win_size)
        uxy = _uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        a1 = 2 * ux * uy + c1
        a2 = 2 * vxy + c2
        b1 = ux ** 2 + uy ** 2 + c1
        b2 = vx + vy + c2
        s = (a1 * a2) / (b1 * b2)
        vals.append(s[pad:-pad, pad:-pad].mean() if pad > 0 else s.mean())
    return float(np.mean(vals))


def get_metrics(pred: np.ndarray, gt: np.ndarray, lpips_fn=None):
    """(ssim, psnr) of two [0, 1] images, and the ``lpips_fn`` distance
    third when one is given."""
    s = ssim(pred, gt, data_range=1.0)
    p = psnr(pred, gt, data_range=1.0)
    if lpips_fn is None:
        return s, p
    return s, p, float(lpips_fn(pred, gt))
