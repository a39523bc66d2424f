"""KTX v1 container support (compressed ASTC + uncompressed payloads).

Mirrors the reference CLI's KTX reader/writer behavior
(reference: Source/astcenccli_image_load_store.cpp:660-1540): Khronos ASTC
GL enums for every 2D/3D footprint, LDR + sRGB variants, endianness flips,
single-mip single-face surfaces.

The port's own copy of ``astcenc_tpu/io/ktx.py`` (NumPy only), so that
the port loads nothing of the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

_KTX_MAGIC = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x31, 0x31, 0xBB,
                    0x0D, 0x0A, 0x1A, 0x0A])
_ENDIAN = 0x04030201

_GL_RGBA = 0x1908
_GL_SRGB8_ALPHA8 = 0x8C43
_GL_UNSIGNED_BYTE = 0x1401
_GL_UNSIGNED_SHORT = 0x1403
_GL_HALF_FLOAT = 0x140B
_GL_FLOAT = 0x1406
_GL_RGBA8 = 0x8058
_GL_RGBA16F = 0x881A
_GL_RGBA32F = 0x8814

# Uncompressed channel layouts (reference scanline_transfer matrix,
# astcenccli_image_load_store.cpp:374-414): glFormat -> (components,
# rgba source-channel map; -1 = fill 0, -2 = fill 1, >=0 = source index).
_GL_CHANNEL_LAYOUTS = {
    0x1903: (1, (0, -1, -1, -2)),   # GL_RED        -> (r, 0, 0, 1)
    0x8227: (2, (0, 1, -1, -2)),    # GL_RG         -> (r, g, 0, 1)
    0x1907: (3, (0, 1, 2, -2)),     # GL_RGB        -> (r, g, b, 1)
    0x1908: (4, (0, 1, 2, 3)),      # GL_RGBA
    0x80E0: (3, (2, 1, 0, -2)),     # GL_BGR        -> (r, g, b, 1)
    0x80E1: (4, (2, 1, 0, 3)),      # GL_BGRA
    0x1909: (1, (0, 0, 0, -2)),     # GL_LUMINANCE  -> (l, l, l, 1)
    0x190A: (2, (0, 0, 0, 1)),      # GL_LUMINANCE_ALPHA
}

_2D_SIZES = ((4, 4), (5, 4), (5, 5), (6, 5), (6, 6), (8, 5), (8, 6), (8, 8),
             (10, 5), (10, 6), (10, 8), (10, 10), (12, 10), (12, 12))
_3D_SIZES = ((3, 3, 3), (4, 3, 3), (4, 4, 3), (4, 4, 4), (5, 4, 4),
             (5, 5, 4), (5, 5, 5), (6, 5, 5), (6, 6, 5), (6, 6, 6))

#: GL internal format -> (block_x, block_y, block_z, srgb)
ASTC_GL_FORMATS = {}
for i, (bx, by) in enumerate(_2D_SIZES):
    ASTC_GL_FORMATS[0x93B0 + i] = (bx, by, 1, False)
    ASTC_GL_FORMATS[0x93D0 + i] = (bx, by, 1, True)
for i, (bx, by, bz) in enumerate(_3D_SIZES):
    ASTC_GL_FORMATS[0x93C0 + i] = (bx, by, bz, False)
    ASTC_GL_FORMATS[0x93E0 + i] = (bx, by, bz, True)

GL_FORMAT_OF_BLOCK = {(v[0], v[1], v[2], v[3]): k
                      for k, v in ASTC_GL_FORMATS.items()}


class KtxError(ValueError):
    pass


def write_ktx_compressed(path, block_dims, image_dims, blocks: np.ndarray,
                         srgb: bool = False):
    """Write an ASTC-compressed KTX v1 file."""
    bx, by, bz = block_dims
    dx, dy, dz = image_dims
    try:
        fmt = GL_FORMAT_OF_BLOCK[(bx, by, bz, srgb)]
    except KeyError:
        raise KtxError(f"no ASTC GL enum for block {bx}x{by}x{bz}")
    payload = np.ascontiguousarray(blocks, np.uint8).tobytes()
    hdr = _KTX_MAGIC + struct.pack(
        "<13I", _ENDIAN,
        0,              # glType (compressed)
        1,              # glTypeSize
        0,              # glFormat
        fmt,            # glInternalFormat
        _GL_RGBA,       # glBaseInternalFormat
        dx, dy if dy > 1 or dz > 1 else 0, dz if dz > 1 else 0,
        0,              # arrayElements
        1,              # faces
        1,              # mipLevels
        0)              # keyValueBytes
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def write_ktx_uncompressed(path, data: np.ndarray, srgb: bool = False):
    """Write an uncompressed RGBA KTX v1 (u8 / f16 / f32 by dtype)."""
    if data.ndim == 3:
        data = data[None]
    dz, dy, dx, _ = data.shape
    if data.dtype == np.uint8:
        gtype, tsize, ifmt = _GL_UNSIGNED_BYTE, 1, (_GL_SRGB8_ALPHA8 if srgb
                                                    else _GL_RGBA8)
    elif data.dtype == np.float16:
        gtype, tsize, ifmt = _GL_HALF_FLOAT, 2, _GL_RGBA16F
    else:
        data = data.astype(np.float32)
        gtype, tsize, ifmt = _GL_FLOAT, 4, _GL_RGBA32F
    payload = np.ascontiguousarray(data).tobytes()
    hdr = _KTX_MAGIC + struct.pack(
        "<13I", _ENDIAN, gtype, tsize, _GL_RGBA, ifmt, _GL_RGBA,
        dx, dy if dy > 1 or dz > 1 else 0, dz if dz > 1 else 0,
        0, 1, 1, 0)
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def read_ktx(path):
    """Read a KTX v1 file.

    Returns for compressed payloads:
      ("astc", (bx, by, bz), (dx, dy, dz), blocks (N, 16) uint8, srgb)
    and for uncompressed payloads:
      ("raw", None, (dx, dy, dz), array (Z, H, W, 4), srgb)
    """
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:12] != _KTX_MAGIC:
        raise KtxError("not a KTX v1 file")
    fields = struct.unpack("<13I", raw[12:12 + 52])
    endianness = fields[0]
    swap = endianness != _ENDIAN
    if swap:
        fields = struct.unpack(">13I", raw[12:12 + 52])
    (_, gl_type, _, _, gl_ifmt, _, dx, dy, dz,
     arr, faces, mips, kv_bytes) = fields
    dy = max(dy, 1)
    dz = max(dz, 1)
    if arr > 0 or faces > 1:
        raise KtxError("unsupported KTX features (arrays/cubemaps)")
    off = 12 + 52 + kv_bytes
    (size,) = struct.unpack(">I" if swap else "<I", raw[off:off + 4])
    off += 4
    payload = raw[off:off + size]
    if len(payload) < size:
        raise KtxError("truncated KTX payload")

    if gl_type == 0:
        if gl_ifmt not in ASTC_GL_FORMATS:
            raise KtxError(f"unsupported compressed format 0x{gl_ifmt:X}")
        bx, by, bz, srgb = ASTC_GL_FORMATS[gl_ifmt]
        blocks = np.frombuffer(payload, np.uint8).reshape(-1, 16)
        return "astc", (bx, by, bz), (dx, dy, dz), blocks, srgb

    # Uncompressed: full reference format matrix — {R, RG, RGB, RGBA, BGR,
    # BGRA, L, LA} x {u8, u16, f16, f32}, expanded to canonical RGBA u8
    # (LDR) / f16 (HDR) exactly like the reference's copy_scanline
    # (astcenccli_image_load_store.cpp:427-660, :926-1200).
    gl_fmt = fields[3]
    if gl_fmt not in _GL_CHANNEL_LAYOUTS:
        raise KtxError(f"unsupported glFormat 0x{gl_fmt:X}")
    ncomp, chmap = _GL_CHANNEL_LAYOUTS[gl_fmt]
    if gl_type == _GL_UNSIGNED_BYTE:
        src = np.frombuffer(payload, np.uint8)
    elif gl_type == _GL_UNSIGNED_SHORT:
        src = np.frombuffer(payload, ">u2" if swap else "<u2")
    elif gl_type == _GL_HALF_FLOAT:
        src = np.frombuffer(payload, ">f2" if swap else "<f2")
    elif gl_type == _GL_FLOAT:
        src = np.frombuffer(payload, ">f4" if swap else "<f4")
    else:
        raise KtxError(f"unsupported glType 0x{gl_type:X}")
    if src.size < dz * dy * dx * ncomp:
        raise KtxError("truncated KTX payload")
    src = src[:dz * dy * dx * ncomp].reshape(dz, dy, dx, ncomp)
    if gl_type == _GL_UNSIGNED_BYTE:
        one = np.uint8(255)
        conv = src
    elif gl_type == _GL_UNSIGNED_SHORT:
        # 16-bit unorm loads convert to fp16 (R16_TO_RGBA16F class).
        one = np.float16(1.0)
        conv = (src.astype(np.float32) / 65535.0).astype(np.float16)
    else:
        one = np.float16(1.0)
        conv = src.astype(np.float16)
    out = np.empty(conv.shape[:3] + (4,), conv.dtype)
    for c, m in enumerate(chmap):
        if m == -1:
            out[..., c] = 0
        elif m == -2:
            out[..., c] = one
        else:
            out[..., c] = conv[..., m]
    srgb = gl_ifmt == _GL_SRGB8_ALPHA8
    return "raw", None, (dx, dy, dz), out, srgb
