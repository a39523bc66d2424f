# Frozen copy of astcenc_torch/tables/block_mode.py, kept
# with the benchmark's reference decoder (2D blocks) so that the
# yardstick does not move with the program.
"""ASTC block-mode field decoding.

Decodes the 11-bit block mode field into weight grid dimensions, weight quant
method, and dual-plane flag, for 2D blocks, per the ASTC specification.
Behavior matches the reference (Source/astcenc_block_sizes.cpp:36-240) and is
validated against it in tests/test_bsd.py.
"""

from __future__ import annotations

from .ise import sequence_bitcount

BLOCK_MAX_WEIGHTS = 64
BLOCK_MIN_WEIGHT_BITS = 24
BLOCK_MAX_WEIGHT_BITS = 96
WEIGHTS_MAX_BLOCK_MODES = 2048


def decode_block_mode_2d(block_mode: int):
    """Decode a 2D block mode.

    Returns (valid, weights_x, weights_y, is_dual_plane, quant_mode,
    weight_bits). Reference: astcenc_block_sizes.cpp:36-137.
    """
    base_quant_mode = (block_mode >> 4) & 1
    H = (block_mode >> 9) & 1
    D = (block_mode >> 10) & 1
    A = (block_mode >> 5) & 0x3

    weights_x = weights_y = 0

    if (block_mode & 3) != 0:
        base_quant_mode |= (block_mode & 3) << 1
        B = (block_mode >> 7) & 3
        sel = (block_mode >> 2) & 3
        if sel == 0:
            weights_x, weights_y = B + 4, A + 2
        elif sel == 1:
            weights_x, weights_y = B + 8, A + 2
        elif sel == 2:
            weights_x, weights_y = A + 2, B + 8
        else:
            B &= 1
            if block_mode & 0x100:
                weights_x, weights_y = B + 2, A + 2
            else:
                weights_x, weights_y = A + 2, B + 6
    else:
        base_quant_mode |= ((block_mode >> 2) & 3) << 1
        if ((block_mode >> 2) & 3) == 0:
            return False, 0, 0, False, 0, 0
        B = (block_mode >> 9) & 3
        sel = (block_mode >> 7) & 3
        if sel == 0:
            weights_x, weights_y = 12, A + 2
        elif sel == 1:
            weights_x, weights_y = A + 2, 12
        elif sel == 2:
            weights_x, weights_y = A + 6, B + 6
            D = 0
            H = 0
        else:
            sel2 = (block_mode >> 5) & 3
            if sel2 == 0:
                weights_x, weights_y = 6, 10
            elif sel2 == 1:
                weights_x, weights_y = 10, 6
            else:
                return False, 0, 0, False, 0, 0

    weight_count = weights_x * weights_y * (D + 1)
    quant_mode = (base_quant_mode - 2) + 6 * H
    is_dual_plane = D != 0
    weight_bits = sequence_bitcount(weight_count, quant_mode)
    valid = (weight_count <= BLOCK_MAX_WEIGHTS
             and BLOCK_MIN_WEIGHT_BITS <= weight_bits <= BLOCK_MAX_WEIGHT_BITS)
    return valid, weights_x, weights_y, is_dual_plane, quant_mode, weight_bits
