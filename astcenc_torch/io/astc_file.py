""".astc container file reader/writer.

Format per the reference's Docs/FileFormat.md: 16-byte header (magic,
block dims, 24-bit image dims) followed by the raw 16-byte blocks in
raster order (x fastest, then y, then z).

The port's own copy of ``astcenc_tpu/io/astc_file.py`` (NumPy only), so that
the port loads nothing of the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"\x13\xab\xa1\x5c"


class AstcFileError(ValueError):
    pass


def read_astc(path_or_bytes):
    """Read a .astc file.

    Returns (block_dims (x,y,z), image_dims (x,y,z), blocks (N, 16) uint8).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if len(data) < 16 or data[:4] != MAGIC:
        raise AstcFileError("not a .astc file (bad magic)")
    bx, by, bz = data[4], data[5], data[6]
    dim_x = data[7] | (data[8] << 8) | (data[9] << 16)
    dim_y = data[10] | (data[11] << 8) | (data[12] << 16)
    dim_z = data[13] | (data[14] << 8) | (data[15] << 16)
    if bx < 1 or by < 1 or bz < 1 or dim_x < 1 or dim_y < 1 or dim_z < 1:
        raise AstcFileError("invalid .astc header dimensions")
    nx = (dim_x + bx - 1) // bx
    ny = (dim_y + by - 1) // by
    nz = (dim_z + bz - 1) // bz
    n = nx * ny * nz
    payload = data[16:16 + n * 16]
    if len(payload) < n * 16:
        raise AstcFileError("truncated .astc payload")
    blocks = np.frombuffer(payload, dtype=np.uint8).reshape(n, 16)
    return (bx, by, bz), (dim_x, dim_y, dim_z), blocks


def write_astc(path, block_dims, image_dims, blocks: np.ndarray):
    """Write a .astc file."""
    bx, by, bz = block_dims
    dx, dy, dz = image_dims
    header = MAGIC + struct.pack(
        "<BBB", bx, by, bz) + bytes([
            dx & 0xFF, (dx >> 8) & 0xFF, (dx >> 16) & 0xFF,
            dy & 0xFF, (dy >> 8) & 0xFF, (dy >> 16) & 0xFF,
            dz & 0xFF, (dz >> 8) & 0xFF, (dz >> 16) & 0xFF,
        ])
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(blocks, dtype=np.uint8).tobytes())
