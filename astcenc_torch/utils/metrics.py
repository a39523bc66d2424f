"""Image quality metrics.

Mirrors the reference CLI's compute_error_metrics
(reference: Source/astcenccli_error_metrics.cpp:110-413): PSNR, alpha PSNR,
luminance PSNR, normal-map angular PSNR, log-RMSE and mPSNR for HDR, and the
"Quality metrics" block the CLI prints.

The port's own copy of ``astcenc_tpu/utils/metrics.py`` (NumPy only), so
that the port needs nothing of the JAX package. Inputs are float arrays (or
uint8, read as /255).
"""

from __future__ import annotations

import math

import numpy as np


def psnr(img_a: np.ndarray, img_b: np.ndarray, channels: int = 3) -> float:
    """Peak signal-to-noise ratio over the first `channels` channels.

    Inputs are float arrays in [0,1] or uint8.
    """
    a = _norm(img_a)[..., :channels].astype(np.float64)
    b = _norm(img_b)[..., :channels].astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse <= 0:
        return 999.0
    return 10.0 * math.log10(1.0 / mse)


def alpha_psnr(img_a, img_b) -> float:
    return psnr(_norm(img_a)[..., 3:4], _norm(img_b)[..., 3:4], channels=1)


def luma_psnr(img_a, img_b) -> float:
    wa = _norm(img_a)
    wb = _norm(img_b)
    la = wa[..., 0] * 0.2126 + wa[..., 1] * 0.7152 + wa[..., 2] * 0.0722
    lb = wb[..., 0] * 0.2126 + wb[..., 1] * 0.7152 + wb[..., 2] * 0.0722
    return psnr(la[..., None], lb[..., None], channels=1)


def normal_angular_psnr(img_a, img_b) -> float:
    """Mean angular error PSNR for normal maps (X in R, Y in A)."""
    def vecs(img):
        w = _norm(img)
        x = w[..., 0] * 2.0 - 1.0
        y = w[..., 3] * 2.0 - 1.0
        z = np.sqrt(np.maximum(1.0 - x * x - y * y, 0.0))
        v = np.stack([x, y, z], -1)
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return v / np.maximum(n, 1e-10)
    va, vb = vecs(img_a), vecs(img_b)
    cosang = np.clip(np.sum(va * vb, -1), -1.0, 1.0)
    ang = np.arccos(cosang) / math.pi  # normalized 0..1
    mse = np.mean(ang ** 2)
    if mse <= 0:
        return 999.0
    return 10.0 * math.log10(1.0 / mse)


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


# ---------------------------------------------------------------------------
# Reference-faithful compare stage
# ---------------------------------------------------------------------------

_COMPONENT_MASKS = (0x00, 0x07, 0x0C, 0x07, 0x0F)


def _mpsnr_tonemap(x, fstop):
    """mpsnr_operator (reference: astcenccli_error_metrics.cpp:66-78)."""
    v = np.power(np.maximum(x * (2.0 ** fstop), 0.0), 1.0 / 2.2)
    return np.clip(v * 255.0, 0.0, 255.0)


def compute_error_metrics(img1, img2, input_components: int,
                          hdr: bool = False, normal: bool = False,
                          fstop_lo: int = -10, fstop_hi: int = 10) -> dict:
    """Faithful port of the reference CLI's compute_error_metrics
    (reference: astcenccli_error_metrics.cpp:110-413).

    img1/img2: (H, W, 4) or (Z, H, W, 4) arrays — uint8 (treated as /255)
    or float (clamped to the FP16 finite range like the reference's
    F16/F32 loads). Returns a dict of the printed quantities.
    """
    a = _norm(img1).astype(np.float64)
    b = _norm(img2).astype(np.float64)
    if a.ndim == 3:
        a = a[None]
    if b.ndim == 3:
        b = b[None]
    if np.asarray(img1).dtype != np.uint8:
        a = np.clip(a, 0.0, 65504.0)
    if np.asarray(img2).dtype != np.uint8:
        b = np.clip(b, 0.0, 65504.0)
    # Intersection of dims (reference: :129-143)
    dz = min(a.shape[0], b.shape[0])
    dy = min(a.shape[1], b.shape[1])
    dx = min(a.shape[2], b.shape[2])
    a = a[:dz, :dy, :dx]
    b = b[:dz, :dy, :dx]

    cmask = _COMPONENT_MASKS[input_components]
    active = [c for c in range(4) if cmask & (1 << c)]
    pixels = float(dx * dy * dz)
    samples = pixels * len(active)

    diff = a - b
    errsum = np.sum(diff * diff, axis=(0, 1, 2))             # per channel
    ascale = np.concatenate([diff[..., :3] * a[..., 3:4], diff[..., 3:4]],
                            axis=-1)
    alpha_errsum = np.sum(ascale * ascale, axis=(0, 1, 2))
    rgb_peak = float(np.max(a[..., :3])) if hdr else 0.0

    out = {}
    num = float(np.sum(errsum[active]))
    out["psnr"] = 999.0 if num == 0.0 else 10.0 * math.log10(samples / num)
    rgb_psnr = out["psnr"]
    if cmask & 8:
        anum = float(np.sum(alpha_errsum[active]))
        out["alpha_psnr"] = (999.0 if anum == 0.0
                             else 10.0 * math.log10(samples / anum))
        rgb_num = float(np.sum(errsum[:3]))
        rgb_psnr = (999.0 if rgb_num == 0.0
                    else 10.0 * math.log10(pixels * 3.0 / rgb_num))
        out["rgb_psnr"] = rgb_psnr

    if hdr:
        la = np.log2(np.maximum(a, 1e-37))
        lb = np.log2(np.maximum(b, 1e-37))
        ldiff = la - lb
        log_errsum = np.sum(ldiff * ldiff, axis=(0, 1, 2))
        mp = np.zeros(4)
        for f in range(fstop_lo, fstop_hi + 1):
            d = _mpsnr_tonemap(a, f) - _mpsnr_tonemap(b, f)
            mp += np.sum(d * d, axis=(0, 1, 2))
        mpsnr_num = float(np.sum(mp[active]))
        stopcount = float(fstop_hi - fstop_lo + 1)
        mpsnr_denom = pixels * 3.0 * stopcount * 255.0 * 255.0
        out["rgb_peak"] = rgb_peak
        out["norm_psnr"] = rgb_psnr + 20.0 * math.log10(max(rgb_peak, 1e-37))
        out["mpsnr"] = (999.0 if mpsnr_num == 0.0
                        else 10.0 * math.log10(mpsnr_denom / mpsnr_num))
        out["log_rmse"] = math.sqrt(float(np.sum(log_errsum[active]))
                                    / pixels)

    if normal:
        def unit(img):
            v = (img[..., :3] - 0.5) * 2.0
            n = np.linalg.norm(v, axis=-1, keepdims=True)
            return np.where(n > 0, v / np.maximum(n, 1e-37),
                            np.array([1.0 / math.sqrt(3.0)] * 3))
        cosang = np.clip(np.sum(unit(a) * unit(b), -1), -1.0, 1.0)
        deg = np.degrees(np.arccos(cosang))
        out["mean_angular"] = float(np.mean(deg))
        out["worst_angular"] = float(np.max(deg))
    return out


def format_error_metrics(m: dict, input_components: int, hdr: bool,
                         normal: bool, fstop_lo: int = -10,
                         fstop_hi: int = 10) -> str:
    """The reference CLI's "Quality metrics" block, byte-compatible
    (reference: astcenccli_error_metrics.cpp:350-413)."""
    cmask = _COMPONENT_MASKS[input_components]
    lines = ["Quality metrics", "===============", ""]
    if cmask & 8:
        lines.append(f"    PSNR (LDR-RGBA):          {m['psnr']:9.4f} dB")
        lines.append(f"    Alpha-weighted PSNR:      "
                     f"{m['alpha_psnr']:9.4f} dB")
        lines.append(f"    PSNR (LDR-RGB):           "
                     f"{m['rgb_psnr']:9.4f} dB")
    else:
        lines.append(f"    PSNR (LDR-RGB):           {m['psnr']:9.4f} dB")
    if hdr:
        lines.append(f"    PSNR (RGB norm to peak):  {m['norm_psnr']:9.4f}"
                     f" dB (peak {m['rgb_peak']:f})")
        lines.append(f"    mPSNR (RGB):              {m['mpsnr']:9.4f} dB"
                     f" (fstops {fstop_lo:+d} to {fstop_hi:+d})")
        lines.append(f"    LogRMSE (RGB):            {m['log_rmse']:9.4f}")
    if normal:
        lines.append(f"    Mean Angular Error:       "
                     f"{m['mean_angular']:9.4f} degrees")
        lines.append(f"    Worst Angular Error:      "
                     f"{m['worst_angular']:9.4f} degrees")
    lines.append("")
    return "\n".join(lines)
