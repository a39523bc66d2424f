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
``synthetic_hdr_image`` is the float16 HDR counterpart; ``alpha_holes``
cuts seeded transparent regions into an image's alpha; ``rgbm_image``
stores an HDR image as an RGBM texture; ``synthetic_volume`` is a 3D
texture (LDR or HDR); ``nonfinite_image`` holds a NaN or an infinity in
one texel of each 4x4 block. ``pack_batch``
makes the colour pack's inputs: seeded endpoint pairs, requested formats
and quant levels, with the pack's corner cases added on request.
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


def alpha_holes(image: np.ndarray, seed: int, count: int = 3) -> np.ndarray:
    """``image`` (uint8 RGBA) with its alpha set to 0 inside ``count``
    seeded discs of a fifth to a third of the shorter side in radius, as a
    cut-out mask (foliage, decals) has: blocks well inside a disc are wholly
    transparent, blocks at its edge partly so. RGB is left as it is."""
    rng = np.random.default_rng(seed)
    h, w = image.shape[:2]
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = image.copy()
    for _ in range(count):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.2, 0.34) * min(h, w)
        out[..., 3][(x - cx) ** 2 + (y - cy) ** 2 < r * r] = 0
    return out


def footprint_image(kind: str, height: int, width: int,
                    seed: int) -> np.ndarray:
    """The image of a footprint fixture (tests/data/torch_footprints/),
    every kind with an independent alpha: "ldr" (``synthetic_image``),
    "hdr" (``synthetic_hdr_image``) or "ldr_holes" (``synthetic_image``
    with ``alpha_holes`` of seed ``seed + 1``)."""
    if kind == "hdr":
        return synthetic_hdr_image(height, width, seed, independent_alpha=True)
    img = synthetic_image(height, width, seed, independent_alpha=True)
    if kind == "ldr_holes":
        img = alpha_holes(img, seed + 1)
    elif kind != "ldr":
        raise ValueError(f"unknown fixture image kind {kind!r}")
    return img


def rgbm_image(height: int, width: int, seed: int = 0,
               m_scale: float = 5.0, dark_spots: int = 3) -> np.ndarray:
    """(height, width, 4) uint8 RGBM texture, as engines store a lightmap
    in LDR: the square root of ``synthetic_hdr_image`` of ``seed`` (half
    its stops) brought to the range [0, m_scale], its 99th percentile at
    0.8 m_scale; then M = the
    texel's largest channel over m_scale rounded up to a step of 1/255,
    and RGB = colour / (M m_scale). ``dark_spots`` seeded 3x3 squares are
    black with M = 0 or 1/255, so that the encoder meets texels whose M
    decodes to zero."""
    hdr = synthetic_hdr_image(height, width, seed).astype(np.float32)[..., :3]
    rgb = np.sqrt(hdr / np.float32(np.percentile(hdr, 99.0)))
    rgb = np.clip(rgb * np.float32(0.8 * m_scale), 0.0, m_scale)
    m = np.ceil(rgb.max(-1) / m_scale * 255.0) / 255.0
    m = np.clip(m, 1.0 / 255.0, 1.0)
    out = np.empty((height, width, 4), np.float32)
    out[..., :3] = rgb / (m[..., None] * m_scale)
    out[..., 3] = m
    rng = np.random.default_rng(seed + 1)
    for k in range(dark_spots):
        y0 = int(rng.integers(0, max(1, height - 3)))
        x0 = int(rng.integers(0, max(1, width - 3)))
        out[y0:y0 + 3, x0:x0 + 3, :3] = 0.0
        out[y0:y0 + 3, x0:x0 + 3, 3] = (k % 2) / 255.0
    return np.clip(np.floor(out * 255.0 + 0.5), 0, 255).astype(np.uint8)


def synthetic_volume(depth: int, height: int, width: int, seed: int = 0,
                     hdr: bool = False) -> np.ndarray:
    """(depth, height, width, 4) RGBA volume texture made from ``seed``:
    uint8, or with ``hdr`` float16 spanning about 2^-4 to 2^8. A smooth
    3D luminance field with per-channel tints, seeded balls of a flat
    colour with hard edges, slabs a quarter darker, noise shared by the
    channels and a little of each channel's own; alpha is a 3D sinusoid of
    its own in the far half (x), opaque elsewhere. Made slice by slice in
    float32, so a 192^3 volume takes a few seconds."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(1.0, 3.0, 3).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    tph = rng.uniform(0, 2 * np.pi, 4).astype(np.float32)
    gain = rng.uniform(0.7, 1.1, 4).astype(np.float32)
    fa = rng.uniform(2.0, 6.0, 3).astype(np.float32)
    pa = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    nballs = max(4, (depth * height * width) // 400000)
    balls = [(rng.uniform(0, width), rng.uniform(0, height),
              rng.uniform(0, depth),
              rng.uniform(0.05, 0.2) * min(depth, height, width),
              rng.uniform(0.2, 0.8, 4)) for _ in range(nballs)]
    slabs = [(int(rng.integers(0, width)),
              int(rng.integers(1, max(2, width // 12)))) for _ in range(2)]
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    u = x / max(width - 1, 1)
    v = y / max(height - 1, 1)
    far = x >= width // 2
    out = np.empty((depth, height, width, 4),
                   np.float16 if hdr else np.uint8)
    for zi in range(depth):
        w_ = np.float32(zi / max(depth - 1, 1))
        lum = 0.5 + 0.25 * (np.sin(2 * np.pi * f[0] * (u + 0.5 * w_) + ph[0])
                            * np.cos(np.pi * f[1] * (v - 0.3 * u) + ph[1])
                            * np.cos(np.pi * f[2] * w_ + ph[2]))
        img = np.empty((height, width, 4), np.float32)
        for c in range(4):
            tint = 0.08 * np.sin(2 * np.pi * (u * (c + 1) * 0.7 + v * 0.5
                                              + w_ * 0.3) + tph[c])
            img[..., c] = (lum - 0.5) * gain[c] + 0.5 + tint
        for cx, cy, cz, r, col in balls:
            m = (x - cx) ** 2 + (y - cy) ** 2 + (zi - cz) ** 2 < r * r
            img[m] = 0.5 * img[m] + 0.5 * col
        for x0, wd in slabs:
            img[:, x0:x0 + wd, :3] *= 0.75
        img += rng.normal(0.0, 0.03, (height, width, 1)).astype(np.float32)
        img += rng.normal(0.0, 0.006, img.shape).astype(np.float32)
        alpha = (0.5 + 0.35 * np.sin(2 * np.pi * fa[0] * v + pa[0])
                 * np.cos(2 * np.pi * fa[1] * u + pa[1])
                 * np.cos(2 * np.pi * fa[2] * w_ + pa[2]))
        if hdr:
            img[..., :3] = np.exp2(-4.0 + 12.0 * np.clip(img[..., :3], 0, 1))
            img[..., 3] = np.where(far, np.clip(alpha, 0, 1), 1.0)
            out[zi] = np.clip(img, 0.0, 65504.0).astype(np.float16)
        else:
            img[..., 3] = np.where(far, alpha, img[..., 3])
            out[zi] = np.clip(np.floor(img * 255.0 + 0.5), 0, 255)
    return out


NONFINITE = (np.nan, np.inf, -np.inf)


def nonfinite_image() -> np.ndarray:
    """(4, 48, 4) float32 image of 12 blocks of 4x4, each 0.5 everywhere
    but its texel (0, 0) of one channel, which holds NaN, +Inf or -Inf:
    block 4 v + c holds ``NONFINITE[v]`` in channel c (the 36 cases of
    the three profiles' non-finite inputs are these 12 under each)."""
    img = np.full((4, 48, 4), 0.5, np.float32)
    for v, bad in enumerate(NONFINITE):
        for c in range(4):
            img[0, 4 * (4 * v + c), c] = bad
    return img


def feature_image(kind: str, shape, seed: int) -> np.ndarray:
    """The input of a feature fixture (tests/data/torch_features/) from its
    kind, shape and seed: "ldr_holes" and "hdr" (``footprint_image``),
    "rgbm" (``rgbm_image``), "nonfinite" (``nonfinite_image``), "volume"
    and "volume_hdr" (``synthetic_volume``, shape (depth, height,
    width))."""
    shape = tuple(int(s) for s in shape)
    if kind == "rgbm":
        return rgbm_image(*shape, seed)
    if kind == "nonfinite":
        return nonfinite_image()
    if kind in ("volume", "volume_hdr"):
        return synthetic_volume(*shape, seed, hdr=kind == "volume_hdr")
    return footprint_image(kind, *shape, seed)


def endpoint_pairs(rng, n: int):
    """(ep0, ep1, rgbs, rgbo), each (n, 4) float32: seeded endpoint pairs
    in the 0..65535 (LNS-code) domain from the numpy Generator ``rng``:
    mostly ordered pairs at every brightness, some wide, some equal, some
    out of range; rgbs is ep1's RGB with a scale in [0, 1], rgbo ep0's RGB
    with the alpha spread as its offset."""
    base = rng.uniform(0.0, 65535.0, (n, 1)).astype(np.float32)
    spread = np.exp2(rng.uniform(0, 16, (n, 1))).astype(np.float32)
    ep0 = base + rng.normal(0, 1, (n, 4)).astype(np.float32) * spread * 0.05
    ep1 = ep0 + np.abs(rng.normal(0, 1, (n, 4))).astype(np.float32) * spread
    ep1[: n // 16] = ep0[: n // 16]
    ep0[n // 16: n // 8] -= 3000.0
    rgbs = np.concatenate([ep1[:, :3], rng.uniform(0, 1, (n, 1))], 1)
    rgbo = np.concatenate([ep0[:, :3], np.abs(ep1[:, 3:] - ep0[:, 3:])], 1)
    return (ep0.astype(np.float32), ep1.astype(np.float32),
            rgbs.astype(np.float32), rgbo.astype(np.float32))


#: The requested formats of ``pack_batch``'s seeded rows: every format an
#: encoder asks for, LDR (0, 4, 6, 8, 10, 12) and HDR (2, 3, 7, 11, 14, 15).
PACK_FORMATS = (0, 2, 3, 4, 6, 7, 8, 10, 11, 12, 14, 15)

# quantize_hdr_rgbo's (colour, scale) cutoffs per mode and quantize_hdr_rgb's
# (b, c, d) cutoffs (ops/color_pack_hdr.py).
_RGBO_CUTOFFS = ((1024, 4096), (2048, 1024), (2048, 16384), (8192, 16384),
                 (32768, 16384))
_RGB_CUTOFFS = ((16384, 8192, 8192), (32768, 8192, 4096), (4096, 8192, 4096),
                (8192, 8192, 2048), (8192, 2048, 512), (2048, 8192, 1024),
                (2048, 2048, 256), (1024, 2048, 512))


def _pack_corners():
    """(ep0, ep1, rgbs, rgbo) rows, each (m, 4) float32, at the pack's
    corners: endpoints at 0 and 65535, ties of the major component, rgbo
    vectors on each side of every mode cutoff of quantize_hdr_rgbo and
    endpoint pairs at those of quantize_hdr_rgb."""
    rows = []
    top = 65535.0
    for a, b in ((0.0, 0.0), (top, top), (0.0, top), (top, 0.0)):
        for s in (0.0, 1.0):
            rows.append(([a] * 4, [b] * 4, [b, b, b, s], [a, a, a, b]))
    rows.append(([0.0, top, 0.0, top], [top, 0.0, top, 0.0],
                 [top, 0.0, top, 0.5], [0.0, top, 0.0, 0.0]))
    for v in (0.0, 300.0, 20000.0, 65535.0):
        for r, g, b in ((v, v, v), (v, v, v / 2), (v, v / 2, v),
                        (v / 2, v, v)):
            rows.append(([r / 2, g / 2, b / 2, 100.0], [r, g, b, 60000.0],
                         [r, g, b, 0.5], [r, g, b, v / 4]))
    r = 40000.0
    for gb_cut, s_cut in _RGBO_CUTOFFS:
        for d in (-1.0, -0.5, 0.0, 0.5, 1.0):
            for gb, s in ((gb_cut + d, s_cut + d), (gb_cut + d, 100.0),
                          (100.0, s_cut + d)):
                rgbo = [r, r - gb, r - gb, s]
                rows.append(([r - 500.0] * 3 + [0.0], [r] * 3 + [top],
                             [r] * 3 + [0.5], rgbo))
    a = 50000.0
    for b_cut, c_cut, d_cut in _RGB_CUTOFFS:
        for d in (-1.0, 0.0, 1.0):
            e1 = [a, a - b_cut + d, a - b_cut + d, top]
            e0 = [a - c_cut + d, a - b_cut - d_cut + d, a - b_cut + d_cut,
                  0.0]
            rows.append((e0, e1, e1[:3] + [1.0], e0[:3] + [0.0]))
    return tuple(np.array([row[i] for row in rows], np.float32)
                 for i in range(4))


def pack_batch(seed: int, n: int = 4096, corners: bool = False):
    """The colour pack's inputs: (ep0, ep1, rgbs, rgbo) (m, 4) float32,
    req_fmt (m,) and quant_level (m,) int32. n seeded rows
    (``endpoint_pairs``, formats from ``PACK_FORMATS``, quant levels 4-20);
    with ``corners`` also every row of ``_pack_corners`` under each of the
    16 formats at two quant levels, so that every (format, quant level)
    pair occurs."""
    rng = np.random.default_rng(seed)
    ep0, ep1, rgbs, rgbo = endpoint_pairs(rng, n)
    req = rng.choice(np.array(PACK_FORMATS, np.int32), n)
    ql = rng.integers(4, 21, n).astype(np.int32)
    out = [ep0, ep1, rgbs, rgbo, req, ql]
    if corners:
        cols = _pack_corners()
        m = cols[0].shape[0]
        i, f, k = np.meshgrid(np.arange(m), np.arange(16), np.arange(2),
                              indexing="ij")
        i, f, k = i.ravel(), f.ravel(), k.ravel()
        extra = [c[i] for c in cols]
        extra += [f.astype(np.int32),
                  (4 + (7 * i + 3 * f + 8 * k) % 17).astype(np.int32)]
        out = [np.concatenate([a, b]) for a, b in zip(out, extra)]
    return tuple(out)


def unpack_batch(seed: int, n: int):
    """The colour decode's inputs: fmt (n,) and vals (n, 8) int32. First
    fixed rows: every format 0-15 with all values 0 and with all 255; in
    FMT_HDR_RGB, FMT_HDR_RGB_LDR_ALPHA and FMT_HDR_RGBA 4 rows of each
    (modeval, majcomp) of the HDR RGB decode with each modeval of the HDR
    alpha decode (the top bits of values 1-5 and 6-7); in
    FMT_HDR_RGB_SCALE 16 rows of each of its 16 mode values (the top bits
    of values 0-2); the other bits seeded. Then seeded formats and values
    0..255 up to n rows (n at least 1,824)."""
    rng = np.random.default_rng(seed)
    fmts = [np.arange(16), np.arange(16)]
    vals = [np.zeros((16, 8), np.int64), np.full((16, 8), 255)]
    m, j, a = (x.ravel() for x in np.meshgrid(
        np.arange(8), np.arange(4), np.arange(4), indexing="ij"))
    top = np.repeat(np.stack([0 * m, m & 1, (m >> 1) & 1, m >> 2, j & 1,
                              j >> 1, a & 1, a >> 1], 1), 4, 0)
    for f in (11, 14, 15):
        fmts.append(np.full(len(top), f))
        vals.append(rng.integers(0, 128, top.shape) | (top << 7))
    mv = np.repeat(np.arange(16), 16)
    v = rng.integers(0, 256, (len(mv), 8))
    v[:, 0] = (v[:, 0] & 0x3F) | ((mv & 3) << 6)
    v[:, 1] = (v[:, 1] & 0x7F) | (((mv >> 2) & 1) << 7)
    v[:, 2] = (v[:, 2] & 0x7F) | ((mv >> 3) << 7)
    fmts.append(np.full(len(mv), 7))
    vals.append(v)
    k = sum(len(f) for f in fmts)
    if n < k:
        raise ValueError(f"n = {n}: the fixed rows alone are {k}")
    fmts.append(rng.integers(0, 16, n - k))
    vals.append(rng.integers(0, 256, (n - k, 8)))
    return (np.concatenate(fmts).astype(np.int32),
            np.concatenate(vals).astype(np.int32))
