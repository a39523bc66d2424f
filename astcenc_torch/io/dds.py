"""DDS container support (uncompressed RGBA surfaces).

Mirrors the reference CLI's DDS support, which reads/writes uncompressed
u8 / f16 / f32 RGBA surfaces (reference:
Source/astcenccli_image_load_store.cpp:1712-2400). Uses the DX10 extended
header with standard DXGI formats.

The port's own copy of ``astcenc_tpu/io/dds.py`` (NumPy only), so that
the port loads nothing of the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

_DDS_MAGIC = 0x20534444
_DX10_MAGIC = 0x30315844

_DXGI_R32G32B32A32_FLOAT = 2
_DXGI_R16G16B16A16_FLOAT = 10
_DXGI_R8G8B8A8_UNORM = 28


class DdsError(ValueError):
    pass


def write_dds(path, data: np.ndarray):
    """Write an uncompressed RGBA DDS (u8 / f16 / f32 by dtype)."""
    if data.ndim == 3:
        data = data[None]
    dz, dy, dx, _ = data.shape
    if data.dtype == np.uint8:
        dxgi, bpp = _DXGI_R8G8B8A8_UNORM, 4
    elif data.dtype == np.float16:
        dxgi, bpp = _DXGI_R16G16B16A16_FLOAT, 8
    else:
        data = data.astype(np.float32)
        dxgi, bpp = _DXGI_R32G32B32A32_FLOAT, 16

    flags = 1 | 2 | 4 | 0x1000 | 8
    caps2 = 0
    if dz > 1:
        flags |= 0x800000
        caps2 = 0x200000
    pitch = dx * bpp

    ddspf = struct.pack("<8I", 32, 4, _DX10_MAGIC, 0, 0, 0, 0, 0)
    header = struct.pack("<7I44s", 124, flags, dy, dx, pitch, dz, 1,
                         b"\0" * 44) + ddspf + struct.pack(
        "<5I", 0x1000, caps2, 0, 0, 0)
    dx10 = struct.pack("<5I", dxgi, 4 if dz > 1 else 3, 0, 1, 0)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", _DDS_MAGIC))
        f.write(header)
        f.write(dx10)
        f.write(np.ascontiguousarray(data).tobytes())


# DX10 DXGI format -> (numpy dtype, components, rgba channel map, kind)
# covering the reference's full dxgi_params table
# (astcenccli_image_load_store.cpp:1909-1925). Channel map entries:
# -1 = fill 0, -2 = fill 1, >=0 = source channel. kind: "u8" stays u8;
# "unorm" scales to float; "f" converts to float.
_RGBA = (0, 1, 2, 3)
_RGBX = (0, 1, 2, -2)
_BGRA = (2, 1, 0, 3)
_BGRX = (2, 1, 0, -2)
_RGB1 = (0, 1, 2, -2)
_BGR1 = (2, 1, 0, -2)
_RG01 = (0, 1, -1, -2)
_R001 = (0, -1, -1, -2)
_LLL1 = (0, 0, 0, -2)
_LLLA = (0, 0, 0, 1)

_DXGI_FORMATS = {
    2:  (np.float32, 4, _RGBA, "f"),    # R32G32B32A32_FLOAT
    6:  (np.float32, 3, _RGB1, "f"),    # R32G32B32_FLOAT
    10: (np.float16, 4, _RGBA, "f"),    # R16G16B16A16_FLOAT
    11: (np.uint16,  4, _RGBA, "unorm"),  # R16G16B16A16_UNORM
    16: (np.float32, 2, _RG01, "f"),    # R32G32_FLOAT
    28: (np.uint8,   4, _RGBA, "u8"),   # R8G8B8A8_UNORM
    34: (np.float16, 2, _RG01, "f"),    # R16G16_FLOAT
    35: (np.uint16,  2, _RG01, "unorm"),  # R16G16_UNORM
    41: (np.float32, 1, _R001, "f"),    # R32_FLOAT
    49: (np.uint8,   2, _RG01, "u8"),   # R8G8_UNORM
    54: (np.float16, 1, _R001, "f"),    # R16_FLOAT
    56: (np.uint16,  1, _R001, "unorm"),  # R16_UNORM
    61: (np.uint8,   1, _R001, "u8"),   # R8_UNORM
    86: (np.uint8,   4, _BGRA, "u8"),   # B8G8R8A8_UNORM
    87: (np.uint8,   4, _BGRX, "u8"),   # B8G8R8X8_UNORM
}


def _legacy_format(pf):
    """Legacy (non-DX10) pixel-format bitmask patterns
    (reference: astcenccli_image_load_store.cpp:1950-2030)."""
    _, flags, _, bitcount, rmask, gmask, bmask, amask = pf
    if (flags & 0x41) == 0x41 and bitcount == 32:
        if (rmask, gmask, bmask, amask) == (0xFF, 0xFF00, 0xFF0000,
                                            0xFF000000):
            return (np.uint8, 4, _RGBA, "u8")
        if (rmask, gmask, bmask, amask) == (0xFF0000, 0xFF00, 0xFF,
                                            0xFF000000):
            return (np.uint8, 4, _BGRA, "u8")
    if (flags & 0x40) and bitcount == 32:
        if (rmask, gmask, bmask) == (0xFF, 0xFF00, 0xFF0000):
            return (np.uint8, 4, _RGBX, "u8")
        if (rmask, gmask, bmask) == (0xFF0000, 0xFF00, 0xFF):
            return (np.uint8, 4, _BGRX, "u8")
    if (flags & 0x40) and bitcount == 24:
        if (rmask, gmask, bmask) == (0xFF, 0xFF00, 0xFF0000):
            return (np.uint8, 3, _RGB1, "u8")
        if (rmask, gmask, bmask) == (0xFF0000, 0xFF00, 0xFF):
            return (np.uint8, 3, _BGR1, "u8")
    if (flags & 0x40) and bitcount == 16 and rmask == 0xFFFF \
            and gmask == 0xFFFF0000:
        return (np.uint16, 2, _RG01, "unorm")
    if (flags & 0x20001) == 0x20001 and bitcount == 16 \
            and rmask == 0xFF and amask == 0xFF00:
        return (np.uint8, 2, _LLLA, "u8")
    if (flags & 0x20000) and bitcount == 8 and rmask == 0xFF:
        return (np.uint8, 1, _LLL1, "u8")
    if (flags & 0x20000) and bitcount == 16 and rmask == 0xFFFF:
        return (np.uint16, 1, _LLL1, "unorm")
    return None


def read_dds(path):
    """Read an uncompressed DDS surface, expanded to canonical RGBA.

    Supports the reference's full format matrix: the 15 DX10 DXGI formats
    and the legacy bitmask patterns (RGBA/BGRA/RGBX/BGRX/RGB/BGR u8,
    RG16/L16 unorm, A8L8, L8). Returns (data (Z,H,W,4), is_hdr); LDR
    surfaces come back uint8, HDR float32 (via fp16, matching the
    reference's RGBA16F canonical form).
    """
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 128 or struct.unpack("<I", raw[:4])[0] != _DDS_MAGIC:
        raise DdsError("not a DDS file")
    size, flags, dy, dx, pitch, dz, mips = struct.unpack("<7I", raw[4:32])
    if size != 124:
        raise DdsError("bad DDS header size")
    dz = max(dz, 1)
    pf = struct.unpack("<8I", raw[76:108])
    off = 4 + 124
    fmt = None
    if pf[1] & 4 and pf[2] == _DX10_MAGIC:
        dxgi = struct.unpack("<5I", raw[off:off + 20])[0]
        off += 20
        fmt = _DXGI_FORMATS.get(dxgi)
        if fmt is None:
            raise DdsError(f"unsupported DDS DXGI format {dxgi}")
    else:
        fmt = _legacy_format(pf)
        if fmt is None:
            raise DdsError("unsupported legacy DDS pixel format")
    dtype, ncomp, chmap, kind = fmt
    payload = raw[off:]

    need = dz * dy * dx * ncomp
    src = np.frombuffer(payload, dtype)
    if src.size < need:
        raise DdsError("truncated DDS payload")
    src = src[:need].reshape(dz, dy, dx, ncomp)

    if kind == "u8":
        conv, one, hdr = src, np.uint8(255), False
    elif kind == "unorm":
        # 16-bit unorm -> fp16 (reference R16_TO_RGBA16F class)
        conv = (src.astype(np.float32) / 65535.0).astype(np.float16)
        one, hdr = np.float16(1.0), True
    else:
        conv, one, hdr = src.astype(np.float16), np.float16(1.0), True
    out = np.empty((dz, dy, dx, 4), conv.dtype)
    for c, m in enumerate(chmap):
        if m == -1:
            out[..., c] = 0
        elif m == -2:
            out[..., c] = one
        else:
            out[..., c] = conv[..., m]
    if hdr:
        return out.astype(np.float32), True
    return out, False
