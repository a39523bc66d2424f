# Frozen copy of astcenc_torch/tables/quant.py, kept
# with the benchmark's reference decoder (2D blocks) so that the
# yardstick does not move with the program.
"""Weight and color-endpoint quantization tables.

All tables are generated from the ASTC specification's unquantization
algorithms (the A/B/C/D bit-mixing scheme of Khronos Data Format Spec §23.9
and §23.12). The reference codec ships these as precomputed literals
(Source/astcenc_quantization.cpp, Source/astcenc_weight_quant_xfer_tables.cpp,
generated by Utils/astc_quant_generator.cpp); we regenerate them and validate
bit-exact equality in tests/test_quant.py.

Table semantics:
  * Weights unquantize to [0, 64]; colors unquantize to [0, 255].
  * "uquant" = unquantized value; "pquant" = packed (ISE symbol) value.
  * The ISE symbol order is scrambled relative to value order for trit/quint
    quant levels, hence the scramble maps.
"""

from __future__ import annotations

import functools

import numpy as np

from .ise import BTQ_COUNTS, QUANT_LEVELS, QUANT_6

# --- Spec constants for the A/B/C/D unquantization scheme -------------------
#
# For a value with `bits` plain bits b_{n-1}..b_1 a and a trit/quint D:
#   A = replicate(a)                    (9 bits for color, 7 for weights)
#   B = sum_i b_i * MASK_i
#   T = D * C + B;  T ^= A;  T = (A & hi_bit) | (T >> 2)
# Weights additionally apply: if T > 32: T += 1 (expanding 0..63 to 0..64).
#
# Color constants (9-bit scheme), keyed by (trits, quints, bits):
_COLOR_CBD = {
    (1, 0, 1): (204, ()),
    (0, 1, 1): (113, ()),
    (1, 0, 2): (93, (0b100010110,)),
    (0, 1, 2): (54, (0b100001100,)),
    (1, 0, 3): (44, (0b010000101, 0b100001010)),
    (0, 1, 3): (26, (0b010000010, 0b100000101)),
    (1, 0, 4): (22, (0b001000001, 0b010000010, 0b100000100)),
    (0, 1, 4): (13, (0b001000000, 0b010000001, 0b100000010)),
    (1, 0, 5): (11, (0b000100000, 0b001000000, 0b010000001, 0b100000010)),
    (0, 1, 5): (6, (0b000100000, 0b001000000, 0b010000000, 0b100000001)),
    (1, 0, 6): (5, (0b000010000, 0b000100000, 0b001000000, 0b010000000,
                    0b100000001)),
}

# Weight constants (7-bit scheme):
_WEIGHT_CBD = {
    (1, 0, 1): (50, ()),
    (0, 1, 1): (28, ()),
    (1, 0, 2): (23, (0b1000101,)),
    (0, 1, 2): (13, (0b1000010,)),
    (1, 0, 3): (11, (0b0100001, 0b1000010)),
}


def _unquant_value(quant: int, value: int, is_weight: bool) -> int:
    """Unquantize one ISE symbol using the spec algorithm."""
    bits, trits, quints = BTQ_COUNTS[quant]
    width = 7 if is_weight else 9
    himask = 0x20 if is_weight else 0x80
    full = (1 << width) - 1

    if not trits and not quints:
        # Plain bits: replicate to the output width.
        if is_weight:
            # Replicate to 6 bits then expand (0..63 -> 0..64).
            v = value
            t = v << (6 - bits)
            rem = 6 - bits
            while rem > 0:
                rem -= bits
                t |= (v << rem) if rem > 0 else (v >> -rem)
            if t > 32:
                t += 1
            return t
        v = value
        t = v << (8 - bits)
        rem = 8 - bits
        while rem > 0:
            rem -= bits
            t |= (v << rem) if rem > 0 else (v >> -rem)
        return t

    D = value >> bits
    m = value & ((1 << bits) - 1)

    if bits == 0:
        # Trit/quint only; occurs for weights only (colors start at QUANT_6).
        assert is_weight
        return D * (32 if trits else 16)

    key = (trits, quints, bits)
    C, masks = (_WEIGHT_CBD if is_weight else _COLOR_CBD)[key]
    a = m & 1
    A = a * full
    B = 0
    for i, mask in enumerate(masks):
        B += ((m >> (i + 1)) & 1) * mask
    T = D * C + B
    T ^= A
    T = (A & himask) | (T >> 2)
    if is_weight and T > 32:
        T += 1
    return T


@functools.cache
def weight_unquant_map(quant: int) -> np.ndarray:
    """ISE symbol -> unquantized weight in [0, 64].

    Matches quant_and_xfer_tables[q].unscramble_and_unquant_map
    (reference: astcenc_weight_quant_xfer_tables.cpp).
    """
    levels = QUANT_LEVELS[quant]
    return np.array([_unquant_value(quant, v, True) for v in range(levels)],
                    dtype=np.int32)


@functools.cache
def weight_quant_tables(quant: int):
    """All weight quantization transfer tables for one quant level.

    Returns dict with:
      * ``unquant``: sorted unquantized values (value-rank order), [0,64]
      * ``scramble``: value-rank -> ISE symbol
      * ``unscramble_unquant``: ISE symbol -> unquantized value
      * ``prev_next``: (65, 2) for each unquant value v on the grid, the
        previous / next representable values (used by ±1 weight hill-climbs).
    """
    levels = QUANT_LEVELS[quant]
    unscramble_unquant = weight_unquant_map(quant)
    order = np.argsort(unscramble_unquant, kind="stable")
    unquant = unscramble_unquant[order]
    scramble = order.astype(np.int32)

    prev_next = np.zeros((65, 2), dtype=np.int32)
    vals = unquant  # sorted
    for r in range(levels):
        v = int(vals[r])
        prev_next[v, 0] = int(vals[max(r - 1, 0)])
        prev_next[v, 1] = int(vals[min(r + 1, levels - 1)])
    return {
        "unquant": unquant.astype(np.int32),
        "scramble": scramble,
        "unscramble_unquant": unscramble_unquant.astype(np.int32),
        "prev_next": prev_next,
    }


@functools.cache
def color_unquant_map(quant: int) -> np.ndarray:
    """ISE symbol -> unquantized color value in [0, 255].

    ``quant`` here is the absolute quant method (>= QUANT_6); color endpoints
    never use quant levels below QUANT_6.
    """
    assert quant >= QUANT_6
    levels = QUANT_LEVELS[quant]
    return np.array([_unquant_value(quant, v, False) for v in range(levels)],
                    dtype=np.int32)


@functools.cache
def color_quant_tables(quant: int):
    """Color quantization tables for one absolute quant method (>= QUANT_6).

    Returns dict with:
      * ``unquant_to_uquant_lo`` / ``_hi``: (256,) for each target value the
        nearest representable unquant value, with ties split low/high
        (reference: Utils/astc_quant_generator.cpp:345-389). The reference
        stores these interleaved as color_unquant_to_uquant_tables[q][512].
      * ``uquant_to_scrambled_pquant``: (256,) value -> ISE symbol (defined at
        representable values).
      * ``scrambled_pquant_to_uquant``: (levels,) ISE symbol -> value.
    """
    assert quant >= QUANT_6
    levels = QUANT_LEVELS[quant]
    sym_to_val = color_unquant_map(quant)

    lo = np.zeros(256, dtype=np.int32)
    hi = np.zeros(256, dtype=np.int32)
    vals = np.sort(np.unique(sym_to_val))
    for i in range(256):
        dist = np.abs(vals - i)
        mind = dist.min()
        cands = vals[dist == mind]
        lo[i] = cands.min()
        hi[i] = cands.max()

    val_to_sym = np.zeros(256, dtype=np.int32)
    for sym in range(levels):
        val_to_sym[sym_to_val[sym]] = sym

    return {
        "unquant_to_uquant_lo": lo,
        "unquant_to_uquant_hi": hi,
        "uquant_to_scrambled_pquant": val_to_sym,
        "scrambled_pquant_to_uquant": sym_to_val.astype(np.int32),
    }


@functools.cache
def quant_mode_table() -> np.ndarray:
    """(10, 128) table: [integer_count / 2][available bits] -> max quant level.

    The highest color quant method whose BISE size for ``2 * row`` integers
    fits in ``bits`` bits, or -1 (reference: astcenc_quantization.cpp:800).
    """
    from .ise import sequence_bitcount

    table = np.full((10, 128), -1, dtype=np.int32)
    for half in range(1, 10):
        n = 2 * half
        for q in range(21):
            need = sequence_bitcount(n, q)
            if need < 128:
                table[half, need:] = np.maximum(table[half, need:], q)
    return table
