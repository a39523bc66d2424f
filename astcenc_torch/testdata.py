"""Seeded synthetic test images.

Natural-looking RGBA content for tests and the card smoke run, made with
numpy from a seed: a smooth luminance field with per-channel tints, soft
colour discs with hard edges, darker bars, and noise.

Most of the noise is shared by all four channels, as luminance noise is in
photographs, so the channels of most blocks are correlated. With
``independent_alpha`` the right half of the image gets an alpha channel of
its own (a seeded sinusoid with noise, as a mask or a detail map packed in
alpha would be): blocks there have decorrelated channels, which the
encoder's 2-plane stage (1 partition, alpha on its own weight plane) wins.
``synthetic_hdr_image`` is the float16 HDR counterpart.
"""

from __future__ import annotations

import numpy as np


def synthetic_image(height: int, width: int, seed: int = 0,
                    independent_alpha: bool = False) -> np.ndarray:
    """(height, width, 4) uint8 RGBA image made from ``seed``; with
    ``independent_alpha`` the right half's alpha is independent of RGB."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u = x / max(width - 1, 1)
    v = y / max(height - 1, 1)
    f = rng.uniform(1.0, 4.0, 2)
    ph = rng.uniform(0, 2 * np.pi, 2)
    lum = 0.5 + 0.25 * (np.sin(2 * np.pi * f[0] * (u + 0.6 * v) + ph[0])
                        * np.cos(np.pi * f[1] * (v - 0.3 * u) + ph[1]))
    img = np.empty((height, width, 4), np.float32)
    gain = rng.uniform(0.7, 1.1, 4)
    tph = rng.uniform(0, 2 * np.pi, 4)
    for c in range(4):
        tint = 0.08 * np.sin(2 * np.pi * (u * (c + 1) * 0.7 + v * 0.5)
                             + tph[c])
        img[..., c] = (lum - 0.5) * gain[c] + 0.5 + tint
    # Discs of a flat colour near the local tone: hard edges.
    for _ in range(max(4, (height * width) // 20000)):
        cx, cy = rng.uniform(0, width), rng.uniform(0, height)
        r = rng.uniform(0.02, 0.12) * min(height, width)
        shade = rng.uniform(0.3, 0.7)
        col = shade + rng.uniform(-0.05, 0.05, 4)
        m = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[m] = 0.6 * img[m] + 0.4 * col
    # Darker vertical bars (RGB only).
    for _ in range(3):
        x0 = int(rng.integers(0, width))
        w = int(rng.integers(2, max(3, width // 16)))
        img[:, x0:x0 + w, :3] = 0.5 + (img[:, x0:x0 + w, :3] - 0.5) * 0.8 - 0.1
    shared = rng.normal(0.0, 0.03, (height, width, 1)).astype(np.float32)
    own = rng.normal(0.0, 0.006, img.shape).astype(np.float32)
    img = img + shared + own
    if independent_alpha:
        fa = rng.uniform(3.0, 9.0, 2)
        pa = rng.uniform(0, 2 * np.pi, 2)
        alpha = (0.5 + 0.35 * np.sin(2 * np.pi * fa[0] * v + pa[0])
                 * np.cos(2 * np.pi * fa[1] * u + pa[1])
                 + rng.normal(0.0, 0.02, (height, width)))
        half = x >= width // 2
        img[..., 3] = np.where(half, alpha, img[..., 3])
    return np.clip(np.floor(img * 255.0 + 0.5), 0, 255).astype(np.uint8)


def synthetic_hdr_image(height: int, width: int, seed: int = 0,
                        independent_alpha: bool = False) -> np.ndarray:
    """(height, width, 4) float16 RGBA HDR image made from ``seed``: a
    smooth luminance field spanning about 2^-4 to 2^8 (12 stops, as an
    environment map or a lightmap has) with fine detail, per-channel tints
    of a quarter stop and multiplicative noise, tinted discs and darker
    bars with hard edges, a few small bright emitters (2^6 to 2^9), and an
    opaque alpha; with ``independent_alpha`` the right half's alpha is a
    seeded sinusoid in [0, 1] of its own, as in ``synthetic_image``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u = x / max(width - 1, 1)
    v = y / max(height - 1, 1)
    f = rng.uniform(1.0, 4.0, 2)
    ph = rng.uniform(0, 2 * np.pi, 2)
    t = 0.5 + 0.5 * (np.sin(2 * np.pi * f[0] * (u + 0.6 * v) + ph[0])
                     * np.cos(np.pi * f[1] * (v - 0.3 * u) + ph[1]))
    log_lum = -4.0 + 12.0 * t + rng.normal(0.0, 0.15, (height, width))
    img = np.empty((height, width, 4), np.float32)
    tph = rng.uniform(0, 2 * np.pi, 3)
    for c in range(3):
        tint = 0.25 * np.sin(2 * np.pi * (u * (c + 1) * 0.7 + v * 0.5)
                             + tph[c])
        img[..., c] = np.exp2(log_lum + tint)
    def disc(cx, cy, r):
        """The disc's bounding box and its mask there."""
        y0, y1 = max(0, int(cy - r)), min(height, int(cy + r) + 2)
        x0, x1 = max(0, int(cx - r)), min(width, int(cx + r) + 2)
        box = (slice(y0, y1), slice(x0, x1))
        return box, (x[box] - cx) ** 2 + (y[box] - cy) ** 2 < r * r

    # Tinted discs with hard edges, blended half into the field.
    for _ in range(max(6, (height * width) // 10000)):
        cx, cy = rng.uniform(0, width), rng.uniform(0, height)
        r = rng.uniform(0.02, 0.1) * min(height, width)
        col = np.exp2(rng.uniform(-2.0, 6.0)) * rng.uniform(0.4, 1.0, 3)
        box, m = disc(cx, cy, r)
        sub = img[box]
        sub[m, :3] = 0.5 * sub[m, :3] + 0.5 * col
    # Bars two stops darker, as window frames against a sky.
    for _ in range(4):
        x0 = int(rng.integers(0, width))
        img[:, x0:x0 + int(rng.integers(2, max(3, width // 16))), :3] *= 0.25
    for _ in range(max(3, (height * width) // 40000)):
        cx, cy = rng.uniform(0, width), rng.uniform(0, height)
        r = rng.uniform(1.5, 2.0 + 0.01 * min(height, width))
        col = np.exp2(rng.uniform(6.0, 9.0)) * rng.uniform(0.6, 1.0, 3)
        box, m = disc(cx, cy, r)
        img[box][m, :3] = col
    img[..., :3] *= 1.0 + rng.normal(0.0, 0.02, (height, width, 3))
    img[..., 3] = 1.0
    if independent_alpha:
        fa = rng.uniform(3.0, 9.0, 2)
        pa = rng.uniform(0, 2 * np.pi, 2)
        alpha = (0.5 + 0.35 * np.sin(2 * np.pi * fa[0] * v + pa[0])
                 * np.cos(2 * np.pi * fa[1] * u + pa[1])
                 + rng.normal(0.0, 0.02, (height, width)))
        img[..., 3] = np.where(x >= width // 2, np.clip(alpha, 0, 1),
                               img[..., 3])
    return np.clip(img, 0.0, 65504.0).astype(np.float16)
