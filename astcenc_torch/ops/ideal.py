"""Ideal endpoints and weights, batched over blocks.

Port of ``astcenc_tpu/ops/ideal.py`` (reference:
astcenc_ideal_endpoints_and_weights.cpp, astcenc_averages_and_directions.cpp).

Conventions: texels (N, T, 4) float32 in [0, 65535]; pmask (N, T, 4)
float32 one-hot partition membership.

Texel sums go through ``texel_sum.masked_sum`` and channel sums through
``softfloat.sum3``/``sum4``, so the card adds in the CPU's order and both
devices take the same decisions (ROADMAP §C3).
"""

from __future__ import annotations

import numpy as np
import torch

from . import softfloat as sf
from .texel_sum import masked_sum

_EPS_LINE = 1e-7


def partition_onehot(pot: torch.Tensor) -> torch.Tensor:
    """(N, T) partition ids -> (N, T, 4) float one-hot."""
    ar = torch.arange(4, dtype=pot.dtype, device=pot.device)
    return (pot[..., None] == ar).to(torch.float32)


def _cm(comp_mask, device):
    return torch.tensor(comp_mask, dtype=torch.float32, device=device)


def partition_means(texels, pmask):
    sums = masked_sum(pmask, texels)
    counts = pmask.sum(1)
    return sums / torch.clamp(counts[..., None], min=1.0), counts


def avgs_and_dirs(texels, pmask, comp_mask: tuple):
    """Partition average + dominant direction (reference:
    compute_avgs_and_dirs_4_comp, :388-456): the longest of the per-channel
    sums of positive-deviation vectors; the earlier channel wins ties."""
    cm = _cm(comp_mask, texels.device)
    texc = texels * cm
    avg, _ = partition_means(texc, pmask)
    avg_t = torch.einsum("ntp,npc->ntc", pmask, avg)
    best = None
    best_norm = None
    for c in range(4):
        if not comp_mask[c]:
            continue
        posm = pmask * ((texc[:, :, c] - avg_t[:, :, c]) > 0)[..., None]
        s = (masked_sum(posm, texc) - avg * posm.sum(1)[..., None]) * cm
        n = sf.sum4(s * s * cm)
        if best is None:
            best, best_norm = s, n
        else:
            upd = n > best_norm
            best = torch.where(upd[..., None], s, best)
            best_norm = torch.where(upd, n, best_norm)
    return avg, best


def normalize_safe(v, comp_mask: tuple):
    """normalize(v), falling back to the unit diagonal for zero length."""
    cm = _cm(comp_mask, v.device)
    lensq = sf.sum4(v * v * cm)[..., None]
    unit = cm / float(sum(comp_mask)) ** 0.5
    safe = v / sf.sqrt(torch.where(lensq > 0, lensq, 1.0))
    return torch.where(lensq == 0.0, unit, safe)


def ideal_colors_and_weights(texels, pmask, counts, data_min, data_max,
                             channel_weight, comp_mask: tuple,
                             omitted_component: int | None = None):
    """Project texels onto the per-partition dominant line (reference:
    compute_ideal_colors_and_weights_{4,3}_comp, :107-609).

    channel_weight is a static 4-tuple. Returns dict: weights (N, T),
    weight_error_scale (N, T), ep0/ep1 (N, P, 4), is_constant_wes (N,).
    """
    ncomp = sum(comp_mask)
    dev = texels.device
    cm = _cm(comp_mask, dev)
    error_weight = float(np.float32(sum(np.float32(c) * m for c, m in zip(
        channel_weight, comp_mask))) / np.float32(ncomp))
    inpart = pmask.transpose(1, 2) > 0                       # (N, P, T)
    big = 1e10
    active = counts > 0

    def line(param):
        """Per-partition [low, high] of param, weights and error scales."""
        lowp = torch.where(inpart, param[:, None, :], big).amin(2)
        highp = torch.where(inpart, param[:, None, :], -big).amax(2)
        degen = highp <= lowp
        lowp = torch.where(degen, 0.0, lowp)
        highp = torch.where(degen, _EPS_LINE, highp)
        length = highp - lowp
        lensq = length * length
        low_t = torch.einsum("ntp,np->nt", pmask, lowp)
        scale_t = torch.einsum("ntp,np->nt", pmask, 1.0 / length)
        lensq_t = torch.einsum("ntp,np->nt", pmask, lensq)
        w = torch.clamp((param - low_t) * scale_t, 0.0, 1.0)
        lensq_m = torch.where(active, lensq, lensq[:, :1])
        const_wes = (lensq_m == lensq[:, :1]).all(1)
        return lowp, highp, w, lensq_t * error_weight, const_wes

    if ncomp == 1:
        comp = comp_mask.index(1)
        low, high, w, wes, const_wes = line(texels[:, :, comp])
        sep = torch.arange(4, device=dev) == comp
        ep0 = torch.where(sep, low[..., None], data_min[:, None, :])
        ep1 = torch.where(sep, high[..., None], data_max[:, None, :])
        return {"weights": w, "weight_error_scale": wes, "ep0": ep0,
                "ep1": ep1, "is_constant_wes": const_wes}

    avg, dirv = avgs_and_dirs(texels, pmask, comp_mask)
    flip_sum = sf.sum3(dirv) if ncomp >= 3 else sf.sum4(dirv * cm)
    dirv = torch.where((flip_sum < 0)[..., None], -dirv, dirv)
    b = normalize_safe(dirv, comp_mask)
    avg_t = torch.einsum("ntp,npc->ntc", pmask, avg)
    b_t = torch.einsum("ntp,npc->ntc", pmask, b)
    param = sf.sum4((texels - avg_t) * b_t * cm)
    lowp, highp, w, wes, const_wes = line(param)
    ep0 = avg + b * lowp[..., None]
    ep1 = avg + b * highp[..., None]
    if omitted_component is not None:
        om = torch.arange(4, device=dev) == omitted_component
        ep0 = torch.where(om, data_min[:, None, :], ep0)
        ep1 = torch.where(om, data_max[:, None, :], ep1)
    return {"weights": w, "weight_error_scale": wes, "ep0": ep0, "ep1": ep1,
            "is_constant_wes": const_wes}


def ideal_weights_for_decimation(ei_weights, ei_wes, dec_int, dec_sq,
                                 dec_f32):
    """Ideal decimated weights: weighted average + one gradient step
    (reference: compute_ideal_weights_for_decimation, :845-971).

    dec_int/dec_sq/dec_f32: (D, T, W) stencils. Returns (N, D, W).
    """
    num = torch.einsum("dtw,nt->ndw", dec_int, ei_wes * ei_weights)
    den = torch.einsum("dtw,nt->ndw", dec_int, ei_wes) + 1e-10
    initial = num / den
    infilled = torch.einsum("dtw,ndw->ndt", dec_f32, initial)
    diff = (infilled - ei_weights[:, None, :]) * ei_wes[:, None, :]
    ec0 = torch.einsum("dtw,nt->ndw", dec_sq, ei_wes) + 1e-10
    ec1 = torch.einsum("dtw,ndt->ndw", dec_int, diff)
    step = torch.clamp((ec1 * -16.0) / ec0, -0.25, 0.25)
    return initial + step


def quantize_weights_for_modes(dec_ideal_by_mode, low, high, quant_unquant,
                               levels_m1, quant_of_mode):
    """Quantize ideal weights into each mode's [low, high] range (reference:
    compute_quantized_weights_for_decimation, :974-1080).

    dec_ideal_by_mode: (N, M, W); low/high: (N, M); quant_unquant (12, 32)
    int32; levels_m1 (12,) float32; quant_of_mode (M,) int64.
    Returns (uqf (N, M, W) float32, uq (N, M, W) int32).
    """
    degen = high <= low
    low = torch.where(degen, 0.0, low)
    high = torch.where(degen, 1.0, high)
    rscale = high - low
    scale = 1.0 / rscale
    scaled_low = low * scale
    rscale64 = rscale / 64.0
    qlm1 = levels_m1[quant_of_mode]                        # (M,)
    ix = torch.clamp(dec_ideal_by_mode * scale[..., None]
                     - scaled_low[..., None], 0.0, 1.0)
    wl = (ix * qlm1[None, :, None]).to(torch.int32)        # trunc
    wh = torch.minimum(wl + 1, qlm1.to(torch.int32)[None, :, None])
    lut = quant_unquant[quant_of_mode]                     # (M, 32)
    N, M, W = ix.shape
    lutb = lut[None].expand(N, M, 32)
    ixl = torch.gather(lutb, 2, wl.to(torch.int64))
    ixh = torch.gather(lutb, 2, wh.to(torch.int64))
    pick_h = (ixl + ixh).to(torch.float32) < 128.0 * ix
    uq = torch.where(pick_h, ixh, ixl)
    uqf = uq.to(torch.float32) * rscale64[..., None] + low[..., None]
    return uqf, uq


def weight_set_error(uqf_by_mode, ei_weights, ei_wes, dec_f32_by_mode):
    """Error of quantized weight sets vs the ideal per-texel weights
    (reference: compute_error_of_weight_set_1plane, :688-749). (N, M)."""
    infilled = torch.einsum("mtw,nmw->nmt", dec_f32_by_mode, uqf_by_mode)
    d = infilled - ei_weights[:, None, :]
    return (d * d * ei_wes[:, None, :]).sum(-1)
