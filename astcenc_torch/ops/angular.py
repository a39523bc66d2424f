"""Angular weight-range alignment, batched.

Port of ``astcenc_tpu/ops/angular.py`` (reference: astcenc_weight_align.cpp):
per (block, decimation) the sin/cos sums over a 64-bin histogram give an
angular offset per step, and the per-step errors pick a [low, high] weight
range for each quant level up to TUNE_MAX_ANGULAR_QUANT.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

ANGULAR_STEPS = 32
SINCOS_STEPS = 64
TUNE_MAX_ANGULAR_QUANT = 7  # QUANT_12

STEPS_FOR_QUANT_LEVEL = np.array([2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32],
                                 dtype=np.int32)


@functools.cache
def sincos_tables():
    """(64, 32) sin/cos tables (reference: prepare_angular_tables :72-84),
    computed in float32 exactly as the JAX package does."""
    j = np.arange(SINCOS_STEPS, dtype=np.float32)[:, None]
    step = np.arange(1, ANGULAR_STEPS + 1, dtype=np.float32)[None, :]
    ang = (2.0 * np.pi / (SINCOS_STEPS - 1.0)) * step * j
    return np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)


def compute_angular_offsets(dec_weights, wvalid):
    """(N, D, W) ideal decimated weights, (D, W) validity -> (N, D, 32)."""
    dev = dec_weights.device
    sin_t, cos_t = (torch.from_numpy(a).to(dev) for a in sincos_tables())
    isample = torch.floor(torch.clamp(dec_weights, 0.0, 1.0)
                          * (SINCOS_STEPS - 1.0) + 0.5).to(torch.int64)
    hist = torch.zeros(dec_weights.shape[:2] + (SINCOS_STEPS,),
                       dtype=torch.float32, device=dev)
    hist.scatter_add_(2, isample, wvalid[None].expand_as(isample).float())
    asum_y = torch.einsum("nds,sa->nda", hist, sin_t)
    asum_x = torch.einsum("nds,sa->nda", hist, cos_t)
    angle = torch.atan2(asum_y, asum_x)
    angle = torch.where(torch.isnan(angle), 0.0, angle)
    angle = torch.where((asum_x == 0.0) & (asum_y == 0.0), 0.0, angle)
    return angle * (1.0 / (2.0 * np.pi))


def lowest_and_highest_weight(dec_weights, wvalid, offsets, max_quant_steps):
    """Per angular step: lowest index, span, error and cut errors
    (reference: compute_lowest_and_highest_weight, :160-245)."""
    dev = dec_weights.device
    rcp = torch.arange(1, ANGULAR_STEPS + 1, dtype=torch.float32, device=dev)
    big = 3.4e38
    wv = wvalid[None]
    minw = torch.where(wv, dec_weights, big).amin(-1)
    maxw = torch.where(wv, dec_weights, -big).amax(-1)
    minidx = torch.round(minw[..., None] * rcp - offsets)
    maxidx = torch.round(maxw[..., None] * rcp - offsets)
    sval = dec_weights[..., None] * rcp - offsets[:, :, None, :]
    svalrte = torch.round(sval)
    diff = sval - svalrte
    ok = wvalid[None, :, :, None]
    errv = torch.where(ok, diff * diff, 0.0).sum(2)
    is_min = (svalrte == minidx[:, :, None, :]) & ok
    cutlo = torch.where(is_min, 1.0 - 2.0 * diff, 0.0).sum(2)
    is_max = (svalrte == maxidx[:, :, None, :]) & ok
    cuthi = torch.where(is_max, 1.0 + 2.0 * diff, 0.0).sum(2)
    span = (maxidx - minidx + 1.0).to(torch.int32)
    span = torch.minimum(span, max_quant_steps[..., None] + 3).clamp(min=2)
    ssize = 1.0 / rcp
    errscale = ssize * ssize
    return minidx, span, errv * errscale, cutlo * errscale, cuthi * errscale


def angular_endpoints_for_quant_levels(dec_weights, wvalid, max_precision):
    """[low, high] weight values per (n, d, quant level 0..7) (reference:
    compute_angular_endpoints_for_quant_levels, :256-355).

    max_precision: (N, D) int max quant level (min'd with the angular limit
    and the per-block quant limit). Returns (low, high), each (N, D, 8).
    """
    dev = dec_weights.device
    steps_tab = torch.from_numpy(STEPS_FOR_QUANT_LEVEL).to(dev)
    max_steps = steps_tab[max_precision.clamp(0, 11).to(torch.int64)]
    offsets = compute_angular_offsets(dec_weights, wvalid)
    lowest, span, err, cut_lo, cut_hi = lowest_and_highest_weight(
        dec_weights, wvalid, offsets, max_steps)
    step_ids = torch.arange(ANGULAR_STEPS, dtype=torch.int32, device=dev)
    step_ok = step_ids < max_steps[..., None]
    big = 1e30
    e0 = torch.where(step_ok, err, big)
    e_lo = torch.where(step_ok, err + cut_lo, big)
    e_hi = torch.where(step_ok, err + cut_hi, big)
    e_lohi = torch.where(step_ok, err + cut_lo + cut_hi, big)

    lows = []
    highs = []
    for lvl in range(TUNE_MAX_ANGULAR_QUANT + 1):
        s = int(STEPS_FOR_QUANT_LEVEL[lvl])
        # Per step the first minimum over (plain@s, cutlow@s+1,
        # cuthigh@s+1, cutlowhigh@s+2), then the first minimum over steps:
        # the reference's strict-< visit order.
        vbest = torch.where(span == s, e0, big)
        vidx = torch.zeros_like(span)
        for i, (c, sp) in enumerate(((e_lo, s + 1), (e_hi, s + 1),
                                     (e_lohi, s + 2)), start=1):
            c = torch.where(span == sp, c, big)
            upd = c < vbest
            vidx = torch.where(upd, i, vidx)
            vbest = torch.where(upd, c, vbest)
        best_err, bsi = vbest.min(-1)
        bsi = torch.where(best_err < big, bsi, 0)
        g = bsi[..., None]
        variant = torch.gather(vidx, -1, g)[..., 0]
        cutflag = ((variant == 1) | (variant == 3)).to(torch.float32)
        lw = torch.gather(lowest, -1, g)[..., 0] + cutflag
        hw = lw + float(s) - 1.0
        stepsize = 1.0 / (1.0 + bsi.to(torch.float32))
        off = torch.gather(offsets, -1, g)[..., 0]
        lows.append((off + lw) * stepsize)
        highs.append((off + hw) * stepsize)
    return torch.stack(lows, -1), torch.stack(highs, -1)
