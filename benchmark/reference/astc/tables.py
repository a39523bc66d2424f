"""Decode tables of the reference decoder, for one 2D block size.

The descriptor tensors that ``decode.decompress_symbolic_batch`` gathers
from, built straight from the ASTC specification's block-mode, weight-grid,
integer-sequence and partition functions (the frozen copies beside this
file). Unlike an encoder's block size descriptor, nothing is pruned: every
block mode that fits the block and every partition seed of 2, 3 and 4
partitions decodes.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

from . import block_mode as bm
from . import decimation as dec
from . import ise
from . import partition as part
from . import quant

#: Slot count for per-value weight stream descriptors (max 64 weights, padded
#: so both the 5-value trit and 3-value quint groupings reshape cleanly).
W_SLOTS = 64
W_TRIT_PAD = 70   # 14 trit groups * 5
W_QUINT_PAD = 66  # 22 quint groups * 3
C_SLOTS = 18      # max color integers per block
C_TRIT_PAD = 20   # 4 trit groups * 5
C_QUINT_PAD = 18  # 6 quint groups * 3

BAD_MODE = 0xFFFF


def _block_modes(dim_x: int, dim_y: int):
    """Every legal 2D block mode that fits the block: its row of (quant,
    dual, weight bits, grid index), the grid list and the raw-mode map."""
    packed = np.full(2048, BAD_MODE, np.int64)
    rows, grids, grid_index = [], [], {}
    for mode in range(2048):
        valid, wx, wy, dual, q, wbits = bm.decode_block_mode_2d(mode)
        if not valid or wx > dim_x or wy > dim_y:
            continue
        if (wx, wy) not in grid_index:
            grid_index[(wx, wy)] = len(grids)
            grids.append(dec.decimation_info_2d(dim_x, dim_y, wx, wy))
        packed[mode] = len(rows)
        rows.append((q, int(dual), wbits, grid_index[(wx, wy)]))
    return packed, np.array(rows, np.int64), grids


def _weight_streams(rows, grids):
    nm = rows.shape[0]
    w_bits = np.zeros(nm, np.int32)
    w_class = np.zeros(nm, np.int32)
    m_off = np.zeros((nm, W_SLOTS), np.int32)
    t_off = np.zeros((nm, W_SLOTS), np.int32)
    t_bits = np.zeros((nm, W_SLOTS), np.int32)
    t_shift = np.zeros((nm, W_SLOTS), np.int32)
    for i, (q, dual, _, g) in enumerate(rows):
        count = grids[g]["weight_count"] * (2 if dual else 1)
        lay = ise.ise_layout(int(q), count)
        w_bits[i] = lay["bits"]
        w_class[i] = 1 if lay["trits"] else (2 if lay["quints"] else 0)
        m_off[i, :count] = lay["m_offset"]
        t_off[i, :count] = lay["t_offset"]
        t_bits[i, :count] = lay["t_bits"]
        t_shift[i, :count] = lay["t_shift"]
    return w_bits, w_class, m_off, t_off, t_bits, t_shift


def _color_streams():
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
def build(dim_x: int, dim_y: int) -> dict:
    """The decode tables of a dim_x x dim_y block, as host arrays."""
    packed, rows, grids = _block_modes(dim_x, dim_y)
    T = dim_x * dim_y
    w_bits, w_class, wm, wt, wtb, wts = _weight_streams(rows, grids)
    c_bits, c_class, cm, ct, ctb, cts = _color_streams()

    wuq = np.zeros((12, 32), np.int32)
    for q in range(12):
        t = quant.weight_quant_tables(q)["unscramble_unquant"]
        wuq[q, :len(t)] = t
    cuq = np.zeros((17, 256), np.int32)
    for q in range(ise.QUANT_6, 21):
        t = quant.color_quant_tables(q)["scrambled_pquant_to_uquant"]
        cuq[q - ise.QUANT_6, :len(t)] = t

    # Row 0: one partition; then all 1024 seeds of 2, 3 and 4 partitions.
    coords = np.stack(np.meshgrid(np.arange(dim_x), np.arange(dim_y),
                                  np.zeros(1, np.int64), indexing="xy"),
                      -1).reshape(T, 3)
    seeds = np.arange(1024)
    pot = [np.zeros((1, T), np.int64)]
    row_map = np.zeros((3, 1024), np.int64)
    for pc in (2, 3, 4):
        row_map[pc - 2] = 1 + (pc - 2) * 1024 + seeds
        pot.append(part.select_partition_batch(seeds, coords, pc, T < 32)
                   .astype(np.int64))

    trit_dec, _ = ise.trit_tables()
    quint_dec, _ = ise.quint_tables()
    return dict(
        dim=(dim_x, dim_y, 1), texel_count=T,
        block_mode_packed_index=packed,
        bm_quant=rows[:, 0], bm_dual=rows[:, 1], bm_weight_bits=rows[:, 2],
        bm_decimation_mode=rows[:, 3],
        w_bits=w_bits, w_class=w_class,
        w_m_off=wm, w_t_off=wt, w_t_bits=wtb, w_t_shift=wts,
        weight_unquant=wuq,
        dec_texel_weights=np.stack([g["texel_weights_tr"] for g in grids]),
        dec_texel_contribs=np.stack(
            [g["texel_weight_contribs_int_tr"] for g in grids]),
        c_bits=c_bits, c_class=c_class,
        c_m_off=cm, c_t_off=ct, c_t_bits=ctb, c_t_shift=cts,
        color_unquant=cuq,
        quant_mode_table=quant.quant_mode_table(),
        trits_of_integer=trit_dec.astype(np.int64),
        quints_of_integer=quint_dec.astype(np.int64),
        partition_of_texel_cat=np.concatenate(pot, 0),
        partition_row_map=row_map,
    )


def to_device(tables: dict, device) -> types.SimpleNamespace:
    """The tables as int32 tensors on ``device``; scalars and tuples as
    they are."""
    out = {}
    for k, v in tables.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v.astype(np.int32)).to(device)
        out[k] = v
    return types.SimpleNamespace(**out)
