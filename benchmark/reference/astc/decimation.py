# Frozen copy of astcenc_torch/tables/decimation.py, kept
# with the benchmark's reference decoder (2D blocks) so that the
# yardstick does not move with the program.
"""Weight-grid decimation tables.

ASTC interpolates a low-resolution weight grid over the block's texels using
fixed-point bilinear interpolation (2D; the 3D simplex is not kept here). These tables are the
exact integer interpolation stencils defined by the spec.

TPU-first representation: alongside the reference-style sparse stencils
(<= 4 contributions per texel), we build a *dense* (texels, weights) integer
contribution matrix. Undecimation then becomes a single matmul on the MXU:

    infilled[t] = (sum_w M[t, w] * weight[w]) >> 4        (M rows sum to 16)

which batches over thousands of blocks at once — the TPU-native replacement
for the reference's per-texel SIMD gather loops
(reference: astcenc_block_sizes.cpp:252-706, astcenc_decompress_symbolic.cpp:89-155).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.cache
def decimation_info_2d(texels_x: int, texels_y: int, weights_x: int, weights_y: int):
    """Build the 2D decimation stencil.

    Returns dict with:
      * ``texel_weight_count``: (T,) number of contributing weights per texel
      * ``texel_weights_tr``: (4, T) weight indices per texel
      * ``texel_weight_contribs_int_tr``: (4, T) integer contribs (sum = 16)
      * ``dense_matrix``: (T, W) int32 dense contribution matrix
      * ``weight_texel_count``: (W,) texels influenced by each weight
    """
    T = texels_x * texels_y
    W = weights_x * weights_y

    tw_idx = np.zeros((4, T), dtype=np.int32)
    tw_con = np.zeros((4, T), dtype=np.int32)
    tw_cnt = np.zeros(T, dtype=np.int32)
    dense = np.zeros((T, W), dtype=np.int32)

    for y in range(texels_y):
        for x in range(texels_x):
            texel = y * texels_x + x
            x_weight = (((1024 + texels_x // 2) // (texels_x - 1)) * x
                        * (weights_x - 1) + 32) >> 6
            y_weight = (((1024 + texels_y // 2) // (texels_y - 1)) * y
                        * (weights_y - 1) + 32) >> 6

            x_frac, x_int = x_weight & 0xF, x_weight >> 4
            y_frac, y_int = y_weight & 0xF, y_weight >> 4

            qw = [x_int + y_int * weights_x, 0, 0, 0]
            qw[1] = qw[0] + 1
            qw[2] = qw[0] + weights_x
            qw[3] = qw[2] + 1

            prod = x_frac * y_frac
            w3 = (prod + 8) >> 4
            wts = [16 - x_frac - y_frac + w3, x_frac - w3, y_frac - w3, w3]

            for i in range(4):
                if wts[i] != 0:
                    k = tw_cnt[texel]
                    tw_idx[k, texel] = qw[i]
                    tw_con[k, texel] = wts[i]
                    tw_cnt[texel] = k + 1
                    dense[texel, qw[i]] += wts[i]

    return _finish_decimation(tw_idx, tw_con, tw_cnt, dense,
                              (weights_x, weights_y, 1))


def _finish_decimation(tw_idx, tw_con, tw_cnt, dense, wdims):
    weight_texel_count = (dense != 0).sum(axis=0).astype(np.int32)
    return {
        "weight_dims": wdims,
        "weight_count": dense.shape[1],
        "texel_count": dense.shape[0],
        "texel_weight_count": tw_cnt,
        "texel_weights_tr": tw_idx,
        "texel_weight_contribs_int_tr": tw_con,
        "dense_matrix": dense,
        "dense_matrix_f32": dense.astype(np.float32) / 16.0,
        "weight_texel_count": weight_texel_count,
    }
