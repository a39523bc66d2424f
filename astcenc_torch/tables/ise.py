"""Bounded Integer Sequence Encoding (BISE) tables.

ASTC stores weight and color integers using BISE: each value is split into a
plain-bits part and an optional trit (base 3) or quint (base 5) part. Groups
of 5 trits are packed into 8 bits and groups of 3 quints into 7 bits, with the
packed bits interleaved with the plain bits in a fixed stream layout.

Everything here is *generated* from the ASTC specification's trit/quint block
decode functions; nothing is hand-copied table data (reference:
Source/astcenc_integer_sequence.cpp:28-739). The port's copy of the JAX
package's ``tables/ise.py`` without its host-side encoder, which the port
does not call; the host-side decoder ``decode_ise`` serves
codec/block_info.py. tests/test_torch_tables.py holds the tables built from
it against the JAX package's.

The batched bit packing of the codec layer (codec/physical.py,
codec/decode_tables.py) consumes the static layout descriptors produced by
:func:`ise_layout`.
"""

from __future__ import annotations

import functools

import numpy as np

# Quant method enumeration, indexed identically to the ASTC format encoding.
QUANT_2 = 0
QUANT_3 = 1
QUANT_4 = 2
QUANT_5 = 3
QUANT_6 = 4
QUANT_8 = 5
QUANT_10 = 6
QUANT_12 = 7
QUANT_16 = 8
QUANT_20 = 9
QUANT_24 = 10
QUANT_32 = 11
QUANT_40 = 12
QUANT_48 = 13
QUANT_64 = 14
QUANT_80 = 15
QUANT_96 = 16
QUANT_128 = 17
QUANT_160 = 18
QUANT_192 = 19
QUANT_256 = 20

#: Number of representable levels for each quant method.
QUANT_LEVELS = (2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32,
                40, 48, 64, 80, 96, 128, 160, 192, 256)

#: (plain bits, has trit, has quint) per quant method
#: (reference: astcenc_integer_sequence.cpp:352-374).
BTQ_COUNTS = (
    (1, 0, 0), (0, 1, 0), (2, 0, 0), (0, 0, 1), (1, 1, 0), (3, 0, 0),
    (1, 0, 1), (2, 1, 0), (4, 0, 0), (2, 0, 1), (3, 1, 0), (5, 0, 0),
    (3, 0, 1), (4, 1, 0), (6, 0, 0), (4, 0, 1), (5, 1, 0), (7, 0, 0),
    (5, 0, 1), (6, 1, 0), (8, 0, 0),
)

#: (scale, divisor) pairs so that bits(n) = ceil(scale * n / divisor)
#: (reference: astcenc_integer_sequence.cpp:394-416).
_ISE_SIZES = (
    (1, 1), (8, 5), (2, 1), (7, 3), (13, 5), (3, 1), (10, 3), (18, 5),
    (4, 1), (13, 3), (23, 5), (5, 1), (16, 3), (28, 5), (6, 1), (19, 3),
    (33, 5), (7, 1), (22, 3), (38, 5), (8, 1),
)


def sequence_bitcount(count: int, quant: int) -> int:
    """Bits needed to BISE-encode ``count`` values at quant method ``quant``.

    Reference: astcenc_integer_sequence.cpp:419-433 (get_ise_sequence_bitcount).
    """
    if quant >= len(_ISE_SIZES):
        return 1024
    scale, divisor = _ISE_SIZES[quant]
    return (scale * count + divisor - 1) // divisor


def _decode_trit_block(T: int) -> list[int]:
    """Decode a packed 8-bit trit block into 5 trits (ASTC spec algorithm)."""
    t = [0] * 5
    if (T >> 2) & 0x7 == 0b111:
        C = (((T >> 5) & 0x7) << 2) | (T & 0x3)
        t[4] = t[3] = 2
    else:
        C = T & 0x1F
        if (T >> 5) & 0x3 == 0b11:
            t[4] = 2
            t[3] = (T >> 7) & 1
        else:
            t[4] = (T >> 7) & 1
            t[3] = (T >> 5) & 0x3
    if C & 0x3 == 0b11:
        t[2] = 2
        t[1] = (C >> 4) & 1
        c3 = (C >> 3) & 1
        t[0] = (c3 << 1) | (((C >> 2) & 1) & (1 - c3))
    elif (C >> 2) & 0x3 == 0b11:
        t[2] = 2
        t[1] = 2
        t[0] = C & 0x3
    else:
        t[2] = (C >> 4) & 1
        t[1] = (C >> 2) & 0x3
        c1 = (C >> 1) & 1
        t[0] = (c1 << 1) | ((C & 1) & (1 - c1))
    return t


def _decode_quint_block(Q: int) -> list[int]:
    """Decode a packed 7-bit quint block into 3 quints (ASTC spec algorithm)."""
    q = [0] * 3
    if (Q >> 1) & 0x3 == 0b11 and (Q >> 5) & 0x3 == 0:
        q0bit = Q & 1
        q[2] = ((q0bit << 2)
                | ((((Q >> 4) & 1) & (1 - q0bit)) << 1)
                | (((Q >> 3) & 1) & (1 - q0bit)))
        q[1] = 4
        q[0] = 4
    else:
        if (Q >> 1) & 0x3 == 0b11:
            q[2] = 4
            C = ((((Q >> 3) & 0x3) << 3)
                 | (((~(Q >> 5)) & 0x3) << 1)
                 | (Q & 1))
        else:
            q[2] = (Q >> 5) & 0x3
            C = Q & 0x1F
        if C & 0x7 == 0b101:
            q[1] = 4
            q[0] = (C >> 3) & 0x3
        else:
            q[1] = (C >> 3) & 0x3
            q[0] = C & 0x7
    return q


@functools.cache
def trit_tables() -> tuple[np.ndarray, np.ndarray]:
    """(decode, encode) trit block tables.

    decode: (256, 5) uint8 — trits t0..t4 of each packed value.
    encode: (3,3,3,3,3) uint8 indexed [t4][t3][t2][t1][t0] — the canonical
    packed value (the encoding the reference encoder emits).
    """
    decode = np.zeros((256, 5), dtype=np.uint8)
    encode = np.zeros((3, 3, 3, 3, 3), dtype=np.uint8)
    for T in range(256):
        t = _decode_trit_block(T)
        decode[T] = t
        # Ascending assignment makes the last matching T win, which reproduces
        # the reference's canonical encode choice for duplicate patterns.
        encode[t[4], t[3], t[2], t[1], t[0]] = T
    return decode, encode


@functools.cache
def quint_tables() -> tuple[np.ndarray, np.ndarray]:
    """(decode, encode) quint block tables; see :func:`trit_tables`."""
    decode = np.zeros((128, 3), dtype=np.uint8)
    encode = np.zeros((5, 5, 5), dtype=np.uint8)
    for Q in range(128):
        q = _decode_quint_block(Q)
        decode[Q] = q
        encode[q[2], q[1], q[0]] = Q
    return decode, encode


# Stream layout of the T bits within a trit block: element i of the block
# carries tbits[i] bits of T starting at T bit tshift[i].
_TRIT_TBITS = (2, 2, 1, 2, 1)
_TRIT_TSHIFT = (0, 2, 4, 5, 7)
_QUINT_TBITS = (3, 2, 2)
_QUINT_TSHIFT = (0, 3, 5)


@functools.cache
def ise_layout(quant: int, count: int):
    """Static bit layout for a BISE sequence.

    Returns a dict of numpy arrays describing, for each of ``count`` values:
      * ``m_offset``: bit offset of the plain-bits field of value i
      * plus, for each value, the offset/size/shift of its packed trit/quint
        bits (``t_offset``, ``t_bits``, ``t_shift``), empty for plain quants.

    The layout matches the reference stream construction
    (astcenc_integer_sequence.cpp:493-648): values are emitted in order, each
    followed immediately by its share of the trit/quint block bits.
    """
    bits, trits, quints = BTQ_COUNTS[quant]
    m_offset = np.zeros(count, dtype=np.int32)
    t_offset = np.zeros(count, dtype=np.int32)
    t_bits = np.zeros(count, dtype=np.int32)
    t_shift = np.zeros(count, dtype=np.int32)

    pos = 0
    for i in range(count):
        m_offset[i] = pos
        pos += bits
        if trits:
            j = i % 5
            t_bits[i] = _TRIT_TBITS[j]
            t_shift[i] = _TRIT_TSHIFT[j]
            t_offset[i] = pos
            pos += _TRIT_TBITS[j]
        elif quints:
            j = i % 3
            t_bits[i] = _QUINT_TBITS[j]
            t_shift[i] = _QUINT_TSHIFT[j]
            t_offset[i] = pos
            pos += _QUINT_TBITS[j]
    return {
        "bits": bits,
        "trits": trits,
        "quints": quints,
        "m_offset": m_offset,
        "t_offset": t_offset,
        "t_bits": t_bits,
        "t_shift": t_shift,
        "total_bits": sequence_bitcount(count, quant),
    }


def decode_ise(quant: int, count: int, data: np.ndarray, bit_offset: int = 0) -> np.ndarray:
    """Decode a batch of BISE sequences.

    Args:
      quant: quant method index.
      count: number of values to decode.
      data: (..., nbytes) uint8 packed bitstream.
      bit_offset: starting bit position within the stream.

    Returns:
      (..., count) int64 decoded values.
    """
    data = np.asarray(data, dtype=np.uint8)
    lay = ise_layout(quant, count)
    bits, trits, quints = lay["bits"], lay["trits"], lay["quints"]

    bitplane = np.unpackbits(data[..., None], axis=-1, bitorder="little")
    bitplane = bitplane.reshape(data.shape[:-1] + (-1,))

    def read(off, nb):
        v = np.zeros(data.shape[:-1], dtype=np.int64)
        for b in range(nb):
            v |= bitplane[..., bit_offset + off + b].astype(np.int64) << b
        return v

    out = np.zeros(data.shape[:-1] + (count,), dtype=np.int64)
    for i in range(count):
        out[..., i] = read(int(lay["m_offset"][i]), bits)

    if trits or quints:
        group = 5 if trits else 3
        dec, _ = trit_tables() if trits else quint_tables()
        ngroups = (count + group - 1) // group
        T = np.zeros(data.shape[:-1] + (ngroups,), dtype=np.int64)
        for i in range(count):
            g = i // group
            T[..., g] |= read(int(lay["t_offset"][i]), int(lay["t_bits"][i])) << int(lay["t_shift"][i])
        hi = dec[T]  # (..., ngroups, group)
        for i in range(count):
            out[..., i] |= hi[..., i // group, i % group].astype(np.int64) << bits
    return out
