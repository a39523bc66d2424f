"""HDR image quality metrics: mPSNR and log-RMSE.

Copied from ``astcenc_tpu/utils/metrics.py:59-95`` (which follows the
reference CLI's compute_error_metrics, astcenccli_error_metrics.cpp:48-108)
so that the port needs nothing of the JAX package. Inputs are float arrays
(or uint8, read as /255) of shape (..., >= 3); only RGB counts.
"""

from __future__ import annotations

import math

import numpy as np


def log_rmse(img_a, img_b) -> float:
    """Root mean square of the natural-log difference of RGB."""
    a = np.maximum(_norm(img_a)[..., :3].astype(np.float64), 0)
    b = np.maximum(_norm(img_b)[..., :3].astype(np.float64), 0)
    return float(np.sqrt(np.mean((np.log(a + 1e-6) - np.log(b + 1e-6)) ** 2)))


def mpsnr(img_a, img_b, fstop_lo: int = -10, fstop_hi: int = 10) -> float:
    """Multi-exposure PSNR of RGB over the f-stops fstop_lo..fstop_hi."""
    a = _norm(img_a)[..., :3].astype(np.float64)
    b = _norm(img_b)[..., :3].astype(np.float64)
    total = 0.0
    count = 0
    for fstop in range(fstop_lo, fstop_hi + 1):
        mul = 2.0 ** fstop
        total += np.sum((_tonemap(a * mul) - _tonemap(b * mul)) ** 2)
        count += a.size
    mse = total / count
    if mse <= 0:
        return 999.0
    return 10.0 * math.log10(255.0 * 255.0 / mse)


def _tonemap(x):
    x = np.clip(x, 0.0, 1.0)
    srgb = np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)
    return np.floor(srgb * 255.0 + 0.5)


def _norm(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)
