"""Candidate partitioning search, batched.

Port of ``astcenc_tpu/codec/partition_search.py`` (reference:
astcenc_find_best_partitioning.cpp): three rounds of k-means over every
block at once, the coverage-bitmap mismatch of the k-means clustering
against every selected partitioning (bitmaps packed into 64-bit words and
popcounts), a stable ranking by mismatch, the line-error ranking of the top
candidates (kernel K4, ``ops/psearch.py``) and the seed dedup.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .. import obs
from ..ops import ideal as ideal_ops
from ..ops import psearch as psearch_ops
from ..ops import softfloat as sf
from ..ops import texel_sum as ts

_CLUSTER_CUTOFFS = np.array([
    0.626220, 0.932770, 0.275454,
    0.318558, 0.240113, 0.009190,
    0.347661, 0.731960, 0.156391], dtype=np.float32)

# Rows of the mismatch table computed per slice of blocks: bounds the
# (blocks, partitionings) popcount intermediates.
_MISMATCH_ROWS = 4096


def device_tables(bsd, pc: int, device):
    """The BSD's partitionings of ``pc`` partitions as device tensors."""
    parts = bsd.partitionings[pc]

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(
            device)

    return types.SimpleNamespace(
        count_selected=int(parts["count_selected"]),
        pot=t(parts["partition_of_texel"], np.int32),          # (Q, T)
        counts=t(parts["partition_texel_count"], np.int32),    # (Q, 4)
        seed=t(parts["seed"], np.int32),                       # (Q,)
        packed_index=t(parts["packed_index"], np.int64),       # (1024,)
        coverage=t(_pack_bits(parts["coverage"]), np.int64),   # (Qs, 4)
        kmeans_texels=t(bsd.kmeans_texels, np.int64),
    )


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(..., 64) bool -> (...) int64 with bit j = bits[..., j]."""
    w = np.zeros(bits.shape[:-1], np.uint64)
    for j in range(bits.shape[-1]):
        w |= bits[..., j].astype(np.uint64) << np.uint64(j)
    return w.view(np.int64)


def _popcount(x):
    """Bits set in each int64 (SWAR; the masks drop the sign extension of
    the arithmetic shifts)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def kmeans(texels, cw, texel_count: int, partition_count: int):
    """Three rounds of k-means (reference:
    compute_kmeans_partition_ordering; port of ``_kmeans``,
    partition_search.py:27-85). ``cw``: a static tuple or per-block (N, 4)
    weights. Returns (N, T) int64 cluster per texel.
    Its sums add in the same order on every device (``ops/texel_sum.py``,
    ``softfloat.sum4``), so the card assigns the texels as the CPU does."""
    N, T, _ = texels.shape
    dev = texels.device
    if torch.is_tensor(cw):
        cwt, cwk = cw[:, None, :], cw[:, None, None, :]
    else:
        wait = obs.on and obs.sync("partition_search.channel_weight", "h2d")
        cwt = cwk = torch.tensor(cw, dtype=torch.float32, device=dev)
        if wait:
            obs.end(wait, cwt.nbytes)
    ni = torch.arange(N, device=dev)

    def dist_to(center):
        d = texels - center[:, None, :]
        return sf.sum4(d * d * cwt)

    centers = [texels[:, 145897 % texel_count]]
    distances = dist_to(centers[0])
    cutoff_idx = 3 * (partition_count - 2)
    for _ in range(1, partition_count):
        dcut = ts.row_sum(distances) * float(_CLUSTER_CUTOFFS[cutoff_idx])
        cutoff_idx += 1
        reached = ts.prefix_sums(distances) >= dcut[:, None]
        sample = torch.where(reached.any(-1),
                             reached.to(torch.int32).argmax(-1),
                             texel_count - 1)
        centers.append(texels[ni, sample])
        distances = torch.minimum(distances, dist_to(centers[-1]))
    centers = torch.stack(centers, 1)                        # (N, K, 4)
    tidx = torch.arange(T, device=dev)[None, :]

    def assign(centers):
        d = texels[:, :, None, :] - centers[:, None, :, :]
        part = sf.sum4(d * d * cwk).argmin(-1)               # first minimum
        # Empty clusters take texel k (reference kmeans_assign :184-198).
        for _ in range(partition_count):
            for k in range(partition_count):
                empty = ~(part == k).any(-1)
                part = torch.where(empty[:, None] & (tidx == k), k, part)
        return part

    part = assign(centers)
    ks = torch.arange(partition_count, device=dev)
    for _ in range(2):
        oh = (part[..., None] == ks).to(torch.float32)
        sums = ts.masked_sum(oh, texels)
        cnts = torch.clamp(oh.sum(1), min=1.0)
        part = assign(sums / cnts[..., None])
    return part


def partition_mismatch(km_words, cov, partition_count: int):
    """Mismatch counts of each block's k-means bitmaps against every
    selected partitioning (reference: partition_mismatch{2,3,4},
    :253-353).

    km_words: (N, 4) int64 bitmaps; cov: (Q, 4) int64. Returns (N, Q)
    int64, already halved."""
    P = partition_count
    outs = []
    for lo in range(0, km_words.shape[0], _MISMATCH_ROWS):
        a = km_words[lo:lo + _MISMATCH_ROWS]
        p = {(i, j): _popcount(a[:, None, i] ^ cov[None, :, j])
             for i in range(P) for j in range(P)}
        mn = torch.minimum
        if P == 2:
            v = mn(p[0, 0] + p[1, 1], p[0, 1] + p[1, 0])
        elif P == 3:
            v0 = mn(p[1, 1] + p[2, 2], p[1, 2] + p[2, 1]) + p[0, 0]
            v1 = mn(p[1, 0] + p[2, 2], p[1, 2] + p[2, 0]) + p[0, 1]
            v2 = mn(p[1, 0] + p[2, 1], p[1, 1] + p[2, 0]) + p[0, 2]
            v = mn(mn(v0, v1), v2)
        else:
            mx23 = mn(p[2, 2] + p[3, 3], p[2, 3] + p[3, 2])
            mx13 = mn(p[2, 1] + p[3, 3], p[2, 3] + p[3, 1])
            mx12 = mn(p[2, 1] + p[3, 2], p[2, 2] + p[3, 1])
            mx03 = mn(p[2, 0] + p[3, 3], p[2, 3] + p[3, 0])
            mx02 = mn(p[2, 0] + p[3, 2], p[2, 2] + p[3, 0])
            mx01 = mn(p[2, 1] + p[3, 0], p[2, 0] + p[3, 1])
            v0 = p[0, 0] + mn(mn(p[1, 1] + mx23, p[1, 2] + mx13),
                              p[1, 3] + mx12)
            v1 = p[0, 1] + mn(mn(p[1, 0] + mx23, p[1, 2] + mx03),
                              p[1, 3] + mx02)
            v2 = p[0, 2] + mn(mn(p[1, 1] + mx03, p[1, 0] + mx13),
                              p[1, 3] + mx01)
            v3 = p[0, 3] + mn(mn(p[1, 1] + mx02, p[1, 2] + mx01),
                              p[1, 0] + mx12)
            v = mn(mn(mn(v0, v1), v2), v3)
        outs.append(v // 2)
    return torch.cat(outs)


def _weight_imprecision(texel_count: int) -> float:
    wie = 0.055
    if texel_count <= 20:
        wie = 0.03
    elif texel_count <= 31:
        wie = 0.04
    elif texel_count <= 41:
        wie = 0.05
    return wie * wie


def find_best_partition_candidates(st, tabs, texel_count: int, cw,
                                   partition_count: int,
                                   partition_search_limit: int,
                                   requested_candidates: int):
    """Top partitioning candidates per block (reference:
    find_best_partition_candidates, :551-779; port of
    partition_search.py:138-263).

    tabs: ``device_tables`` of this partition count; cw: the config's
    channel weights, scaled per block by ``st["cw_scale"]`` where the
    block state has one (USE_ALPHA_WEIGHT, partition_search.py:149-157).
    Returns (seeds (N, C) int32 raw seeds, valid (N, C) bool)."""
    texels = st["texels"]
    N = texels.shape[0]
    P = partition_count
    search = min(partition_search_limit, tabs.count_selected)
    reqc = min(requested_candidates, search)

    cw_scale = st.get("cw_scale")
    part = kmeans(texels, ideal_ops.block_channel_weights(cw, cw_scale),
                  texel_count, P)
    km_at = part[:, tabs.kmeans_texels]                       # (N, <=64)
    shifts = torch.arange(km_at.shape[1], device=texels.device)
    words = torch.stack(
        [((km_at == p).to(torch.int64) << shifts).sum(-1) for p in range(4)],
        1)
    mism = partition_mismatch(words, tabs.coverage, P)
    top = torch.argsort(mism, dim=-1, stable=True)[:, :search].to(torch.int32)
    uncor, samec = psearch_ops.line_errors(
        texels.contiguous(), st["uses_alpha"].to(torch.int32).contiguous(),
        top.contiguous(), tabs.pot, tabs.counts, P,
        _weight_imprecision(texel_count), cw, cw_scale=cw_scale)
    return select_candidates(uncor, samec, tabs.seed, top.to(torch.int64),
                             reqc)


def select_candidates(uncor, samec, seeds_all, top, reqc: int):
    """Keep the best ``reqc`` of each metric, interleave them, and drop
    repeated seeds keeping the first (partition_search.py:266-284)."""
    N = uncor.shape[0]
    dev = uncor.device
    u_top = torch.gather(top, 1, torch.argsort(uncor, dim=-1, stable=True)[
        :, :reqc])
    s_top = torch.gather(top, 1, torch.argsort(samec, dim=-1, stable=True)[
        :, :reqc])
    inter = torch.stack([seeds_all[u_top], seeds_all[s_top]], -1).reshape(
        N, 2 * reqc)
    eq_prev = inter[:, :, None] == inter[:, None, :]
    keep = ~torch.triu(eq_prev, diagonal=1).any(1)
    key = (~keep).to(torch.int64) * (2 * reqc) + torch.arange(
        2 * reqc, device=dev)[None, :]
    perm = torch.argsort(key, dim=-1, stable=True)
    seeds = torch.gather(inter, 1, perm)[:, :reqc]
    nkeep = keep.sum(-1)
    valid = torch.arange(reqc, device=dev)[None, :] < torch.clamp(
        nkeep, max=reqc)[:, None]
    return seeds.to(torch.int32), valid
