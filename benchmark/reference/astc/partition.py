# Frozen copy of astcenc_torch/tables/partition.py (the partition hash
# and selection only), kept with the benchmark's reference decoder (2D
# blocks) so that the yardstick does not move with the program.
"""ASTC procedural partition tables.

The ASTC spec assigns texels to partitions with a procedural hash of
(seed, x, y, z, partition_count). We evaluate the hash fully vectorized in
NumPy over all 1024 seeds x all texels at once (reference:
Source/astcenc_partition_tables.cpp). Validated against the reference in
tests/test_bsd.py.
"""

from __future__ import annotations

import functools

import numpy as np

BLOCK_MAX_PARTITIONINGS = 1024
BLOCK_MAX_KMEANS_TEXELS = 64
BLOCK_BAD_PARTITIONING = 0xFFFF


def hash52(inp: np.ndarray) -> np.ndarray:
    """The ASTC partition hash (reference: astcenc_partition_tables.cpp:114)."""
    p = inp.astype(np.uint32).copy()
    p ^= p >> np.uint32(15)
    p *= np.uint32(0xEEDE0891)
    p ^= p >> np.uint32(5)
    p += p << np.uint32(16)
    p ^= p >> np.uint32(7)
    p ^= p >> np.uint32(3)
    p ^= p << np.uint32(6)
    p ^= p >> np.uint32(17)
    return p


def select_partition_batch(seeds: np.ndarray, coords: np.ndarray,
                           partition_count: int, small_block: bool) -> np.ndarray:
    """Partition index per (seed, texel).

    Args:
      seeds: (S,) int array of partition seeds (0..1023).
      coords: (T, 3) int array of texel x/y/z coordinates.
      partition_count: 1..4.
      small_block: texel_count < 32, doubles coordinates.

    Returns:
      (S, T) uint8 partition assignment.

    Reference: astcenc_partition_tables.cpp:142-263 (select_partition).
    """
    seeds = np.asarray(seeds, dtype=np.int64)
    x = coords[:, 0].astype(np.int64)
    y = coords[:, 1].astype(np.int64)
    z = coords[:, 2].astype(np.int64)
    if small_block:
        x, y, z = x * 2, y * 2, z * 2

    seed = seeds + (partition_count - 1) * 1024
    rnum = hash52(seed.astype(np.uint32)).astype(np.int64)

    def sq(v):
        return (v & 0xF) ** 2

    s1 = sq(rnum)
    s2 = sq(rnum >> 4)
    s3 = sq(rnum >> 8)
    s4 = sq(rnum >> 12)
    s5 = sq(rnum >> 16)
    s6 = sq(rnum >> 20)
    s7 = sq(rnum >> 24)
    s8 = sq(rnum >> 28)
    s9 = sq(rnum >> 18)
    s10 = sq(rnum >> 22)
    s11 = sq(rnum >> 26)
    s12 = sq(((rnum >> 30) | (rnum << 2)))

    odd = (seed & 1).astype(bool)
    sh_a = np.where(seed & 2, 4, 5)           # shift when the parity bit selects it
    sh_pc = 6 if partition_count == 3 else 5  # partition-count-dependent shift
    sh1 = np.where(odd, sh_a, sh_pc)
    sh2 = np.where(odd, sh_pc, sh_a)
    sh3 = np.where(seed & 0x10, sh1, sh2)

    s1 >>= sh1
    s2 >>= sh2
    s3 >>= sh1
    s4 >>= sh2
    s5 >>= sh1
    s6 >>= sh2
    s7 >>= sh1
    s8 >>= sh2
    s9 >>= sh3
    s10 >>= sh3
    s11 >>= sh3
    s12 >>= sh3

    # Broadcast: (S, 1) * (1, T)
    def outer(sc, coord):
        return sc[:, None] * coord[None, :]

    a = outer(s1, x) + outer(s2, y) + outer(s11, z) + (rnum >> 14)[:, None]
    b = outer(s3, x) + outer(s4, y) + outer(s12, z) + (rnum >> 10)[:, None]
    c = outer(s5, x) + outer(s6, y) + outer(s9, z) + (rnum >> 6)[:, None]
    d = outer(s7, x) + outer(s8, y) + outer(s10, z) + (rnum >> 2)[:, None]

    a &= 0x3F
    b &= 0x3F
    c &= 0x3F
    d &= 0x3F

    if partition_count <= 3:
        d = np.zeros_like(d)
    if partition_count <= 2:
        c = np.zeros_like(c)
    if partition_count <= 1:
        b = np.zeros_like(b)

    part = np.full(a.shape, 3, dtype=np.uint8)
    part = np.where((c >= d), 2, part)
    part = np.where((b >= c) & (b >= d), 1, part)
    part = np.where((a >= b) & (a >= c) & (a >= d), 0, part)
    return part
