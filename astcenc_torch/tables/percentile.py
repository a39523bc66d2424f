"""Block-mode usage percentile priors for 2D block sizes.

The reference codec prunes rarely-useful block modes per quality preset using
empirical usage percentiles measured over a training image corpus
(reference: Source/astcenc_percentile_tables.cpp). These are measured data,
not derivable from the spec; we ship them as a binary data file
(``data/percentiles_2d.npz``, extracted from the reference's unpacked table
output by tools/gen_percentiles.py) and load them here.

3D block sizes have no percentile data and keep all modes, matching the
reference (astcenc_block_sizes.cpp:1014-1018).
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data", "percentiles_2d.npz")

#: Legal 2D block sizes (reference: astcenc_percentile_tables.cpp:1201-1226).
LEGAL_2D_SIZES = ((4, 4), (5, 4), (5, 5), (6, 5), (6, 6), (8, 5), (8, 6),
                  (8, 8), (10, 5), (10, 6), (10, 8), (10, 10), (12, 10),
                  (12, 12))

#: Legal 3D block sizes.
LEGAL_3D_SIZES = ((3, 3, 3), (4, 3, 3), (4, 4, 3), (4, 4, 4), (5, 4, 4),
                  (5, 5, 4), (5, 5, 5), (6, 5, 5), (6, 6, 5), (6, 6, 6))


def is_legal_2d_block_size(x: int, y: int) -> bool:
    return (x, y) in LEGAL_2D_SIZES


def is_legal_3d_block_size(x: int, y: int, z: int) -> bool:
    return (x, y, z) in LEGAL_3D_SIZES


@functools.cache
def _load():
    return np.load(_DATA)


@functools.cache
def percentile_table_2d(x: int, y: int) -> np.ndarray:
    """(2048,) float32 percentile of each block mode for a 2D block size.

    Lower percentile = more commonly useful. Modes with percentile <= the
    preset's cutoff are searched (reference: get_2d_percentile_table,
    astcenc_percentile_tables.cpp:1165).
    """
    if not is_legal_2d_block_size(x, y):
        raise ValueError(f"illegal 2D block size {x}x{y}")
    try:
        return _load()[f"{x}x{y}"]
    except (FileNotFoundError, KeyError):
        # Data file missing (e.g. fresh checkout without LFS-equivalent):
        # degrade to "search everything", which only affects speed, not
        # correctness.
        return np.zeros(2048, dtype=np.float32)
