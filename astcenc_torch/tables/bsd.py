"""Block size descriptor: all derived tables for one (block size, config).

This is the TPU equivalent of the reference's context-resident
``block_size_descriptor`` (reference: astcenc_internal.h:533-733, built by
astcenc_block_sizes.cpp:822-1218): a host-side NumPy structure holding every
table the batched codec kernels need. The context layer converts the arrays
used on the hot path into device-resident jnp constants once per context.

Mode/partition packing order intentionally matches the reference so that
candidate-ordering-sensitive selection heuristics agree, and so tests can
compare tables index-for-index.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import block_mode as bm
from . import decimation as dec
from . import partition as part
from . import percentile as perc
from .ise import sequence_bitcount

WEIGHTS_MAX_BLOCK_MODES = 2048
BLOCK_BAD_BLOCK_MODE = 0xFFFF
BLOCK_MAX_KMEANS_TEXELS = 64
BLOCK_MAX_WEIGHTS = 64


def _rand_init():
    return [0xFAF9E171CEA1EC6B, 0xF1B318CC06AF5D71]


def _rand(state):
    """xoroshiro128 step matching astc::rand (astcenc_mathlib.cpp:39-48)."""
    mask = (1 << 64) - 1

    def rotl(v, k):
        return ((v << k) | (v >> (64 - k))) & mask

    s0, s1 = state
    res = (s0 + s1) & mask
    s1 ^= s0
    state[0] = (rotl(s0, 24) ^ s1 ^ ((s1 << 16) & mask)) & mask
    state[1] = rotl(s1, 37)
    return res


def assign_kmeans_texels(texel_count: int) -> np.ndarray:
    """Texels used for k-means partition estimation.

    Identity for small blocks; a deterministic random subset for blocks with
    more than 64 texels (reference: astcenc_block_sizes.cpp:717-754).
    """
    if texel_count <= BLOCK_MAX_KMEANS_TEXELS:
        return np.arange(texel_count, dtype=np.int32)
    state = _rand_init()
    seen = np.zeros(texel_count, dtype=bool)
    out = []
    while len(out) < BLOCK_MAX_KMEANS_TEXELS:
        texel = (_rand(state) & 0xFF) % texel_count
        if not seen[texel]:
            out.append(texel)
            seen[texel] = True
    return np.array(out, dtype=np.int32)


@dataclasses.dataclass
class BlockSizeDescriptor:
    """Derived tables for one block size + mode-pruning config."""

    dim: tuple  # (x, y, z)
    texel_count: int

    # Block modes, packed order (always / selected-1p / selected-2p / rest)
    bm_mode_index: np.ndarray        # (NM,) uint16 raw 11-bit mode
    bm_decimation_mode: np.ndarray   # (NM,) packed decimation index
    bm_quant_mode: np.ndarray        # (NM,)
    bm_weight_bits: np.ndarray       # (NM,)
    bm_is_dual_plane: np.ndarray     # (NM,) bool
    block_mode_packed_index: np.ndarray  # (2048,) raw -> packed or 0xFFFF
    block_mode_count_1plane_always: int
    block_mode_count_1plane_selected: int
    block_mode_count_1plane_2plane_selected: int
    block_mode_count_all: int

    # Decimation modes, packed order
    dm_weight_dims: np.ndarray       # (ND, 3)
    dm_weight_count: np.ndarray      # (ND,)
    dm_maxprec_1plane: np.ndarray    # (ND,)
    dm_maxprec_2planes: np.ndarray   # (ND,)
    dm_refprec_1plane: np.ndarray    # (ND,) bitmask of quants used by 1-plane modes
    dm_refprec_2planes: np.ndarray   # (ND,)
    decimation_mode_count_always: int
    decimation_mode_count_selected: int
    decimation_mode_count_all: int

    # Dense decimation stencils padded to common shapes:
    #   dense (ND, T, Wmax) int32, rows sum to 16 over the W axis
    dec_dense: np.ndarray
    dec_dense_f32: np.ndarray
    # Sparse 4-tap form (for bit-exact integer undecimation):
    dec_texel_weights: np.ndarray        # (ND, 4, T)
    dec_texel_contribs_int: np.ndarray   # (ND, 4, T)
    dec_texel_weight_count: np.ndarray   # (ND, T)
    dec_weight_texel_count: np.ndarray   # (ND, Wmax)

    # Partition tables keyed by partition count 2..4 (see partition.py)
    partitionings: dict

    kmeans_texels: np.ndarray

    @property
    def max_weight_count(self) -> int:
        return int(self.dec_dense.shape[2])


@functools.cache
def build_bsd(dim_x: int, dim_y: int, dim_z: int = 1,
              can_omit_modes: bool = False, mode_cutoff: float = 1.0,
              partition_count_cutoff: int = 4) -> BlockSizeDescriptor:
    """Build the block size descriptor.

    Mirrors init_block_size_descriptor (reference: astcenc_block_sizes.cpp:
    1199-1218): the 4-pass 2D mode ordering (always / selected / dual-plane /
    everything) with percentile-based pruning, or the 2-pass 3D ordering.
    """
    if dim_z > 1:
        return _build_3d(dim_x, dim_y, dim_z, can_omit_modes,
                         partition_count_cutoff)
    return _build_2d(dim_x, dim_y, can_omit_modes, mode_cutoff,
                     partition_count_cutoff)


def _build_2d(dim_x, dim_y, can_omit_modes, mode_cutoff, partition_count_cutoff):
    texel_count = dim_x * dim_y
    percentiles = perc.percentile_table_2d(dim_x, dim_y)
    always_cutoff = 0.0

    decim_index: dict = {}
    dm_list = []          # dicts from decimation_info_2d
    dm_maxprec1, dm_maxprec2 = [], []
    dm_refprec1, dm_refprec2 = [], []
    dm_counts = [0, 0, 0, 0]

    bm_rows = []
    packed_index = np.full(WEIGHTS_MAX_BLOCK_MODES, BLOCK_BAD_BLOCK_MODE,
                           dtype=np.int64)
    bm_counts = [0, 0, 0, 0]

    limit = 3 if can_omit_modes else 4
    for j in range(limit):
        for i in range(WEIGHTS_MAX_BLOCK_MODES):
            if packed_index[i] != BLOCK_BAD_BLOCK_MODE:
                continue
            valid, wx, wy, dual, quant, wbits = bm.decode_block_mode_2d(i)
            if not valid or wx > dim_x or wy > dim_y:
                continue
            if (j <= 1 and dual) or (j == 2 and not dual):
                continue
            if dual:
                if 109 - wbits <= 0:
                    continue
            else:
                if 111 - wbits <= 0:
                    continue
            cutoff = always_cutoff if j == 0 else mode_cutoff
            percentile_hit = percentiles[i] <= cutoff
            if j != 3 and not percentile_hit:
                continue

            key = (wx, wy)
            if key not in decim_index:
                di = dec.decimation_info_2d(dim_x, dim_y, wx, wy)
                maxp1, maxp2 = _max_precisions(wx * wy)
                decim_index[key] = len(dm_list)
                dm_list.append(di)
                dm_maxprec1.append(maxp1)
                dm_maxprec2.append(maxp2)
                dm_refprec1.append(0)
                dm_refprec2.append(0)
                dm_counts[j] += 1
            dmi = decim_index[key]

            if dual:
                dm_refprec2[dmi] |= 1 << quant
            else:
                dm_refprec1[dmi] |= 1 << quant

            packed_index[i] = len(bm_rows)
            bm_rows.append((i, dmi, quant, wbits, dual))
            bm_counts[j] += 1

    kmeans = assign_kmeans_texels(texel_count)
    parts = part.partition_tables(dim_x, dim_y, 1, tuple(kmeans.tolist()),
                                  can_omit_modes, partition_count_cutoff)

    return _assemble(
        (dim_x, dim_y, 1), texel_count, bm_rows, packed_index, bm_counts,
        dm_list, dm_maxprec1, dm_maxprec2, dm_refprec1, dm_refprec2,
        dm_counts, parts, kmeans,
        bm_group_sizes=(bm_counts[0], bm_counts[0] + bm_counts[1],
                        bm_counts[0] + bm_counts[1] + bm_counts[2]),
        dm_group_sizes=(dm_counts[0], dm_counts[0] + dm_counts[1] + dm_counts[2]))


def _build_3d(dim_x, dim_y, dim_z, can_omit_modes, partition_count_cutoff):
    texel_count = dim_x * dim_y * dim_z

    decim_index = {}
    dm_list = []
    dm_maxprec1, dm_maxprec2 = [], []
    dm_refprec1, dm_refprec2 = [], []

    # 3D allocates every legal decimation grid up front
    # (reference: astcenc_block_sizes.cpp:1050-1095).
    for wx in range(2, dim_x + 1):
        for wy in range(2, dim_y + 1):
            for wz in range(2, dim_z + 1):
                wc = wx * wy * wz
                if wc > BLOCK_MAX_WEIGHTS:
                    continue
                di = dec.decimation_info_3d(dim_x, dim_y, dim_z, wx, wy, wz)
                maxp1, maxp2 = _max_precisions(wc)
                if 2 * wc > BLOCK_MAX_WEIGHTS:
                    maxp2 = -1
                decim_index[(wx, wy, wz)] = len(dm_list)
                dm_list.append(di)
                dm_maxprec1.append(maxp1)
                dm_maxprec2.append(maxp2)
                dm_refprec1.append(0xFFFF if maxp1 != -1 else 0)
                dm_refprec2.append(0xFFFF if maxp2 != -1 else 0)

    bm_rows = []
    packed_index = np.full(WEIGHTS_MAX_BLOCK_MODES, BLOCK_BAD_BLOCK_MODE,
                           dtype=np.int64)
    bm_counts = [0, 0]
    for j in range(2):
        for i in range(WEIGHTS_MAX_BLOCK_MODES):
            if packed_index[i] != BLOCK_BAD_BLOCK_MODE:
                continue
            valid, wx, wy, wz, dual, quant, wbits = bm.decode_block_mode_3d(i)
            if not valid or wx > dim_x or wy > dim_y or wz > dim_z:
                continue
            if (j == 0 and dual) or (j == 1 and not dual):
                continue
            if dual:
                if 109 - wbits <= 0:
                    continue
            else:
                if 111 - wbits <= 0:
                    continue
            dmi = decim_index[(wx, wy, wz)]
            packed_index[i] = len(bm_rows)
            bm_rows.append((i, dmi, quant, wbits, dual))
            bm_counts[j] += 1

    kmeans = assign_kmeans_texels(texel_count)
    parts = part.partition_tables(dim_x, dim_y, dim_z, tuple(kmeans.tolist()),
                                  can_omit_modes, partition_count_cutoff)

    nd = len(dm_list)
    return _assemble(
        (dim_x, dim_y, dim_z), texel_count, bm_rows, packed_index,
        bm_counts + [0, 0], dm_list, dm_maxprec1, dm_maxprec2,
        dm_refprec1, dm_refprec2, [0, nd, 0, 0], parts, kmeans,
        bm_group_sizes=(0, bm_counts[0], bm_counts[0] + bm_counts[1]),
        dm_group_sizes=(0, nd))


def _max_precisions(weight_count: int):
    """Highest weight quant level fitting the bit budget for 1/2 planes.

    Reference: construct_dt_entry_2d (astcenc_block_sizes.cpp:768-811).
    """
    maxprec_1plane = -1
    maxprec_2planes = -1
    try_2planes = 2 * weight_count <= BLOCK_MAX_WEIGHTS
    for q in range(12):
        b1 = sequence_bitcount(weight_count, q)
        if bm.BLOCK_MIN_WEIGHT_BITS <= b1 <= bm.BLOCK_MAX_WEIGHT_BITS:
            maxprec_1plane = q
        if try_2planes:
            b2 = sequence_bitcount(2 * weight_count, q)
            if bm.BLOCK_MIN_WEIGHT_BITS <= b2 <= bm.BLOCK_MAX_WEIGHT_BITS:
                maxprec_2planes = q
    return maxprec_1plane, maxprec_2planes


def _assemble(dim, texel_count, bm_rows, packed_index, bm_counts,
              dm_list, dm_maxprec1, dm_maxprec2, dm_refprec1, dm_refprec2,
              dm_counts, parts, kmeans, bm_group_sizes, dm_group_sizes):
    nm = len(bm_rows)
    nd = len(dm_list)
    rows = np.array(bm_rows, dtype=np.int64).reshape(nm, 5)

    wmax = max((d["weight_count"] for d in dm_list), default=1)
    T = texel_count
    dense = np.zeros((nd, T, wmax), dtype=np.int32)
    tw = np.zeros((nd, 4, T), dtype=np.int32)
    twc = np.zeros((nd, 4, T), dtype=np.int32)
    twn = np.zeros((nd, T), dtype=np.int32)
    wtc = np.zeros((nd, wmax), dtype=np.int32)
    wdims = np.zeros((nd, 3), dtype=np.int32)
    wcount = np.zeros(nd, dtype=np.int32)
    for i, d in enumerate(dm_list):
        w = d["weight_count"]
        dense[i, :, :w] = d["dense_matrix"]
        tw[i] = d["texel_weights_tr"]
        twc[i] = d["texel_weight_contribs_int_tr"]
        twn[i] = d["texel_weight_count"]
        wtc[i, :w] = d["weight_texel_count"]
        wdims[i] = d["weight_dims"]
        wcount[i] = w

    return BlockSizeDescriptor(
        dim=dim,
        texel_count=texel_count,
        bm_mode_index=rows[:, 0].astype(np.int32),
        bm_decimation_mode=rows[:, 1].astype(np.int32),
        bm_quant_mode=rows[:, 2].astype(np.int32),
        bm_weight_bits=rows[:, 3].astype(np.int32),
        bm_is_dual_plane=rows[:, 4].astype(bool),
        block_mode_packed_index=packed_index,
        block_mode_count_1plane_always=bm_group_sizes[0],
        block_mode_count_1plane_selected=bm_group_sizes[1],
        block_mode_count_1plane_2plane_selected=bm_group_sizes[2],
        block_mode_count_all=nm,
        dm_weight_dims=wdims,
        dm_weight_count=wcount,
        dm_maxprec_1plane=np.array(dm_maxprec1, dtype=np.int32),
        dm_maxprec_2planes=np.array(dm_maxprec2, dtype=np.int32),
        dm_refprec_1plane=np.array(dm_refprec1, dtype=np.int32),
        dm_refprec_2planes=np.array(dm_refprec2, dtype=np.int32),
        decimation_mode_count_always=dm_group_sizes[0],
        decimation_mode_count_selected=dm_group_sizes[1],
        decimation_mode_count_all=nd,
        dec_dense=dense,
        dec_dense_f32=dense.astype(np.float32) / 16.0,
        dec_texel_weights=tw,
        dec_texel_contribs_int=twc,
        dec_texel_weight_count=twn,
        dec_weight_texel_count=wtc,
        partitionings=parts,
        kmeans_texels=kmeans,
    )
