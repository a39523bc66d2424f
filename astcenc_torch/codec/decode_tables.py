"""Device-resident descriptor tables for the batched decoder.

The reference decodes one block at a time with data-dependent control flow
(physical_to_symbolic + decompress_symbolic_block). The TPU design instead
precomputes, per block-size-descriptor, dense descriptor tensors indexed by
the block's mode/quant fields, so an entire batch of blocks decodes with pure
gathers + vector math under one jit. This module builds those tensors (host
NumPy; the context uploads them once).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..tables import ise, quant
from ..tables.bsd import BlockSizeDescriptor

#: Slot count for per-value weight stream descriptors (max 64 weights, padded
#: so both the 5-value trit and 3-value quint groupings reshape cleanly).
W_SLOTS = 64
W_TRIT_PAD = 70   # 14 trit groups * 5
W_QUINT_PAD = 66  # 22 quint groups * 3
C_SLOTS = 18      # max color integers per block
C_TRIT_PAD = 20   # 4 trit groups * 5
C_QUINT_PAD = 18  # 6 quint groups * 3


@dataclasses.dataclass
class DecodeTables:
    """All constant tensors needed by decompress_symbolic_batch."""

    dim: tuple
    texel_count: int

    # Raw block mode -> packed index (2048,), 0xFFFF if invalid
    block_mode_packed_index: np.ndarray

    # Per packed block mode (NM,)
    bm_quant: np.ndarray
    bm_dual: np.ndarray
    bm_weight_bits: np.ndarray
    bm_decimation_mode: np.ndarray

    # Weight ISE stream descriptors per packed mode (NM, W_SLOTS)
    w_bits: np.ndarray       # (NM,) plain bits per value
    w_class: np.ndarray      # (NM,) 0=plain 1=trit 2=quint
    w_count: np.ndarray      # (NM,) real (interleaved) weight count
    w_m_off: np.ndarray      # (NM, W_SLOTS)
    w_t_off: np.ndarray
    w_t_bits: np.ndarray
    w_t_shift: np.ndarray

    # Weight unquantization LUT (12, 32)
    weight_unquant: np.ndarray

    # Decimation stencils (ND, 4, T) + (ND, T)
    dec_texel_weights: np.ndarray
    dec_texel_contribs: np.ndarray

    # Color ISE stream descriptors per (quant-4, npairs-1) combo (153, C_SLOTS)
    c_bits: np.ndarray       # (153,)
    c_class: np.ndarray      # (153,)
    c_m_off: np.ndarray
    c_t_off: np.ndarray
    c_t_bits: np.ndarray
    c_t_shift: np.ndarray

    # Color unquant LUT (17, 256): [quant-4][ise symbol] -> value
    color_unquant: np.ndarray

    # quant_mode_table (10, 128)
    quant_mode_table: np.ndarray

    # Trit/quint block decode tables
    trits_of_integer: np.ndarray   # (256, 5)
    quints_of_integer: np.ndarray  # (128, 3)

    # Concatenated partition tables: row 0 = all-zeros (1 partition), then
    # the packed 2/3/4-partition tables. partition_row_map (3, 1024) maps
    # (pc-2, seed) -> row index in partition_of_texel_cat.
    partition_of_texel_cat: np.ndarray  # (R, T)
    partition_row_map: np.ndarray       # (3, 1024) row or -1


def _weight_descriptors(bsd: BlockSizeDescriptor):
    nm = bsd.block_mode_count_all
    w_bits = np.zeros(nm, np.int32)
    w_class = np.zeros(nm, np.int32)
    w_count = np.zeros(nm, np.int32)
    m_off = np.zeros((nm, W_SLOTS), np.int32)
    t_off = np.zeros((nm, W_SLOTS), np.int32)
    t_bits = np.zeros((nm, W_SLOTS), np.int32)
    t_shift = np.zeros((nm, W_SLOTS), np.int32)

    for i in range(nm):
        q = int(bsd.bm_quant_mode[i])
        dm = int(bsd.bm_decimation_mode[i])
        count = int(bsd.dm_weight_count[dm]) * (2 if bsd.bm_is_dual_plane[i] else 1)
        lay = ise.ise_layout(q, count)
        bits, trits, quints = lay["bits"], lay["trits"], lay["quints"]
        w_bits[i] = bits
        w_class[i] = 1 if trits else (2 if quints else 0)
        w_count[i] = count
        m_off[i, :count] = lay["m_offset"]
        t_off[i, :count] = lay["t_offset"]
        t_bits[i, :count] = lay["t_bits"]
        t_shift[i, :count] = lay["t_shift"]
    return w_bits, w_class, w_count, m_off, t_off, t_bits, t_shift


def _color_descriptors():
    c_bits = np.zeros(153, np.int32)
    c_class = np.zeros(153, np.int32)
    m_off = np.zeros((153, C_SLOTS), np.int32)
    t_off = np.zeros((153, C_SLOTS), np.int32)
    t_bits = np.zeros((153, C_SLOTS), np.int32)
    t_shift = np.zeros((153, C_SLOTS), np.int32)
    for q in range(ise.QUANT_6, 21):
        for npairs in range(1, 10):
            combo = (q - ise.QUANT_6) * 9 + (npairs - 1)
            count = 2 * npairs
            lay = ise.ise_layout(q, count)
            c_bits[combo] = lay["bits"]
            c_class[combo] = 1 if lay["trits"] else (2 if lay["quints"] else 0)
            m_off[combo, :count] = lay["m_offset"]
            t_off[combo, :count] = lay["t_offset"]
            t_bits[combo, :count] = lay["t_bits"]
            t_shift[combo, :count] = lay["t_shift"]
    return c_bits, c_class, m_off, t_off, t_bits, t_shift


@functools.cache
def _color_descriptors_cached():
    return _color_descriptors()


def build_decode_tables(bsd: BlockSizeDescriptor) -> DecodeTables:
    w_bits, w_class, w_count, wm, wt, wtb, wts = _weight_descriptors(bsd)
    c_bits, c_class, cm, ct, ctb, cts = _color_descriptors_cached()

    wuq = np.zeros((12, 32), np.int32)
    for q in range(12):
        t = quant.weight_quant_tables(q)["unscramble_unquant"]
        wuq[q, :len(t)] = t

    cuq = np.zeros((17, 256), np.int32)
    for q in range(ise.QUANT_6, 21):
        t = quant.color_quant_tables(q)["scrambled_pquant_to_uquant"]
        cuq[q - ise.QUANT_6, :len(t)] = t

    T = bsd.texel_count
    rows = [np.zeros((1, T), np.uint8)]
    row_map = np.full((3, 1024), -1, np.int64)
    base = 1
    for pc in (2, 3, 4):
        p = bsd.partitionings[pc]
        rows.append(p["partition_of_texel"])
        pk = p["packed_index"]
        valid = pk != 0xFFFF
        row_map[pc - 2, valid] = base + pk[valid]
        base += p["partition_of_texel"].shape[0]
    pot_cat = np.concatenate(rows, axis=0)

    trit_dec, _ = ise.trit_tables()
    quint_dec, _ = ise.quint_tables()

    return DecodeTables(
        dim=bsd.dim,
        texel_count=T,
        block_mode_packed_index=bsd.block_mode_packed_index.astype(np.int32),
        bm_quant=bsd.bm_quant_mode,
        bm_dual=bsd.bm_is_dual_plane.astype(np.int32),
        bm_weight_bits=bsd.bm_weight_bits,
        bm_decimation_mode=bsd.bm_decimation_mode,
        w_bits=w_bits, w_class=w_class, w_count=w_count,
        w_m_off=wm, w_t_off=wt, w_t_bits=wtb, w_t_shift=wts,
        weight_unquant=wuq,
        dec_texel_weights=bsd.dec_texel_weights,
        dec_texel_contribs=bsd.dec_texel_contribs_int,
        c_bits=c_bits, c_class=c_class,
        c_m_off=cm, c_t_off=ct, c_t_bits=ctb, c_t_shift=cts,
        color_unquant=cuq,
        quant_mode_table=quant.quant_mode_table(),
        trits_of_integer=trit_dec.astype(np.int32),
        quints_of_integer=quint_dec.astype(np.int32),
        partition_of_texel_cat=pot_cat.astype(np.int32),
        partition_row_map=row_map.astype(np.int32),
    )
