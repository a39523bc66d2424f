"""Uncompressed image file I/O (PNG/TGA/BMP/JPG via Pillow; KTX/DDS/EXR in
dedicated modules).

Mirrors the reference CLI's loader registry behavior
(reference: Source/astcenccli_image_load_store.cpp:2409-2537): images load as
RGBA arrays; u8 for LDR formats, float32 for HDR formats.

The port's own copy of ``astcenc_tpu/io/image_io.py`` (NumPy only), so that
the port loads nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np


def load_image(path):
    """Load an image file as an (H, W, 4) array (uint8 LDR or float32 HDR).

    Returns (data, is_hdr, num_components_in_file).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext in (".exr", ".hdr"):
        return _load_hdr(path, ext)
    if ext == ".dds":
        from .dds import read_dds
        data, is_hdr = read_dds(path)
        if data.shape[0] == 1:
            data = data[0]
        return data, is_hdr, 4
    if ext == ".ktx":
        from .ktx import read_ktx
        kind, _, _, payload, is_srgb = read_ktx(path)
        if kind == "astc":
            raise ValueError(
                "KTX file is ASTC-compressed; use decompress mode (-dl)")
        data = payload
        ncomp = data.shape[-1]
        if ncomp < 4:  # pad to RGBA
            is_f = data.dtype != np.uint8
            one = 1.0 if is_f else 255
            pads = [data[..., :1] * 0 + (one if i == 3 else 0)
                    for i in range(ncomp, 4)]
            data = np.concatenate([data] + pads, axis=-1)
        if data.shape[0] == 1:
            data = data[0]
        is_hdr = data.dtype in (np.float16, np.float32)
        if is_hdr:
            data = data.astype(np.float32)
        return data, is_hdr, ncomp
    from PIL import Image
    img = Image.open(path)
    ncomp = len(img.getbands())
    rgba = np.asarray(img.convert("RGBA"), dtype=np.uint8)
    return rgba, False, ncomp


def save_image(path, data: np.ndarray, ncomp: int = 4):
    """Save an (H, W, 4) uint8 or float array to an image file."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".exr", ".hdr"):
        return _save_hdr(path, data, ext)
    from PIL import Image
    data = np.asarray(data)
    if data.dtype != np.uint8:
        data = np.clip(np.rint(np.nan_to_num(data) * 255.0), 0, 255).astype(np.uint8)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[ncomp]
    if ncomp == 1:
        img = Image.fromarray(data[:, :, 0], "L")
    elif ncomp == 3:
        img = Image.fromarray(data[:, :, :3], "RGB")
    else:
        img = Image.fromarray(data[:, :, :4].copy(), mode)
    img.save(path)


def _load_hdr(path, ext):
    if ext == ".hdr":
        data = _read_radiance_hdr(path)
        rgba = np.concatenate(
            [data, np.ones(data.shape[:2] + (1,), np.float32)], axis=-1)
        return rgba, True, 3
    from .exr import read_exr
    data, ncomp = read_exr(path)
    return data, True, ncomp


def _save_hdr(path, data, ext):
    data = np.asarray(data, np.float32)
    if ext == ".hdr":
        return _write_radiance_hdr(path, data[:, :, :3])
    from .exr import write_exr
    return write_exr(path, data, ncomp=4 if data.shape[-1] > 3 else 3)


def _read_radiance_hdr(path):
    """Minimal Radiance RGBE (.hdr) reader (RLE and flat scanlines)."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a radiance file")
        while True:
            line = f.readline().strip()
            if not line:
                break
        dims = f.readline().split()
        if dims[0] != b"-Y":
            raise ValueError("unsupported .hdr orientation")
        h, w = int(dims[1]), int(dims[3])
        out = np.zeros((h, w, 4), np.uint8)
        for y in range(h):
            head = f.read(4)
            if head[0] == 2 and head[1] == 2 and (head[2] << 8 | head[3]) == w:
                # New-style RLE
                for c in range(4):
                    x = 0
                    while x < w:
                        n = f.read(1)[0]
                        if n > 128:
                            out[y, x:x + n - 128, c] = f.read(1)[0]
                            x += n - 128
                        else:
                            out[y, x:x + n, c] = np.frombuffer(f.read(n), np.uint8)
                            x += n
            else:
                row = head + f.read(4 * w - 4)
                out[y] = np.frombuffer(row, np.uint8).reshape(w, 4)
    rgbe = out.astype(np.float32)
    exp = np.ldexp(1.0, out[:, :, 3].astype(np.int32) - 136)
    rgb = rgbe[:, :, :3] * exp[:, :, None]
    rgb[out[:, :, 3] == 0] = 0.0
    return rgb.astype(np.float32)


def _write_radiance_hdr(path, rgb):
    """Minimal Radiance RGBE (.hdr) writer (flat scanlines)."""
    h, w, _ = rgb.shape
    maxc = np.maximum(rgb[:, :, 0], np.maximum(rgb[:, :, 1], rgb[:, :, 2]))
    valid = maxc >= 1e-32
    mant, exp = np.frexp(np.where(valid, maxc, 1.0))
    scale = np.where(valid, mant * 256.0 / np.where(valid, maxc, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    for c in range(3):
        rgbe[:, :, c] = np.clip(rgb[:, :, c] * scale, 0, 255).astype(np.uint8)
    rgbe[:, :, 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
