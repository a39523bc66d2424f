"""Endpoint format selection, batched.

Port of ``astcenc_tpu/ops/formats.py`` (reference:
astcenc_pick_best_endpoint_format.cpp): encoding-choice error estimates,
the (quant level x integer count) colour-error tables, the per-mode best
combination for a bit budget, and the top-C candidate pick, with the
reference's loop-order tie breaks.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import color_unquant as cuq
from . import ideal as ideal_ops
from . import softfloat as sf
from .texel_sum import masked_sum

QUANT_6 = 4
ERROR_CALC_DEFAULT = 1e30

_BASELINE_QUANT_ERROR = np.array([
    (65536.0 * 65536.0 / 18.0) / (d * d)
    for d in (5, 7, 9, 11, 15, 19, 23, 31, 39, 47, 63, 79, 95, 127, 159, 191,
              255)], dtype=np.float32)


def _cw_parts(channel_weight, device):
    cw = torch.tensor(channel_weight, dtype=torch.float32, device=device)
    return cw[:3], cw[3], sf.sum3(cw)


def encoding_choice_errors(texels, pmask, ep0, ep1, channel_weight,
                           is_luminance, default_alpha: float):
    """Errors of the cheaper endpoint encodings per partition (reference:
    compute_encoding_choice_errors, :222-300). Returns dict of (N, P).
    Texel and channel sums in the CPU's order on every device."""
    dev = texels.device
    cw3, cw_a, _ = _cw_parts(channel_weight, dev)
    rgb_mask = (1, 1, 1, 0)
    avg, dirv = ideal_ops.avgs_and_dirs(texels, pmask, rgb_mask)
    uncor_b = ideal_ops.normalize_safe(dirv, rgb_mask)
    m3 = torch.tensor([1, 1, 1, 0.0], device=dev)
    samec_b = ideal_ops.normalize_safe(avg * m3, rgb_mask)
    unit3 = m3 / float(np.sqrt(3.0))

    def line_err(b_t, amod_t):
        param = sf.sum3(texels * b_t)
        dist = amod_t[..., :3] + param[..., None] * b_t[..., :3] \
            - texels[..., :3]
        return masked_sum(pmask, sf.sum3(dist * dist * cw3))

    def proj(a, b):
        d = sf.sum3(a * b)[..., None]
        return a - b * d

    def scatter(x):
        return torch.einsum("ntp,npc->ntc", pmask, x)

    uncor_amod = proj(avg, uncor_b)
    luma_amod = proj(avg, unit3.expand_as(avg))
    zeros = torch.zeros_like(texels)
    uncor_err = line_err(scatter(uncor_b), scatter(uncor_amod))
    samec_err = line_err(scatter(samec_b), zeros)
    rgbl_err = line_err(unit3.expand_as(texels), scatter(luma_amod))
    l_err = line_err(unit3.expand_as(texels), zeros)

    a_diff = texels[..., 3] - default_alpha
    a_drop = masked_sum(pmask, a_diff * a_diff) * cw_a
    epd = (ep1 - ep0).abs()
    can_offset = (epd[..., :3] < 0.12 * 65535.0).all(-1)
    return {
        "rgb_scale_error": (samec_err - uncor_err) * 0.7,
        "rgb_luma_error": (rgbl_err - uncor_err) * 1.5,
        "luminance_error": (l_err - uncor_err) * 3.0,
        "alpha_drop_error": a_drop * 3.0,
        "can_offset_encode": can_offset,
        "can_blue_contract": (~is_luminance[:, None]).expand_as(can_offset),
    }


def color_error_tables_ldr(eci, ep0, ep1, counts, channel_weight):
    """best_error/format per (n, p, quant 0..20, integer count 1..4), LDR
    (reference: :315-665). Returns ((N, P, 21, 4) f32, (N, P, 21, 4) i32)."""
    dev = ep0.device
    cw3, cw_a, ew_rgbsum = _cw_parts(channel_weight, dev)
    psize = counts.to(torch.float32)
    e0h = torch.clamp(ep0 - 65535.0, min=0.0)
    e1h = torch.clamp(ep1 - 65535.0, min=0.0)
    e0l = torch.clamp(ep0, max=0.0)
    e1l = torch.clamp(ep1, max=0.0)
    sum_range = e0l * e0l + e1l * e1l + e0h * e0h + e1h * e1h
    rgb_range_error = sf.sum3(sum_range[..., :3] * cw3) * 0.5 * psize
    alpha_range_error = sum_range[..., 3] * cw_a * 0.5 * psize
    base_rgb = ew_rgbsum * psize
    base_a = cw_a * psize
    base_rgba = base_rgb + base_a

    bcb = eci["can_blue_contract"]
    bc_rgba = torch.where(bcb, 0.625, 1.0)
    bc_rgb = torch.where(bcb, 0.5, 1.0)
    oe_rgba_base = torch.where(eci["can_offset_encode"], 0.5, 1.0)
    oe_rgb_base = torch.where(eci["can_offset_encode"], 0.25, 1.0)

    qv = np.arange(QUANT_6, 21)
    bq = torch.from_numpy(_BASELINE_QUANT_ERROR).to(dev)
    hi_oe = torch.from_numpy(qv >= 19).to(dev)
    oe_rgba = torch.where(hi_oe, 1.0, oe_rgba_base[..., None])
    oe_rgb = torch.where(hi_oe, 1.0, oe_rgb_base[..., None])
    qe_rgb = base_rgb[..., None] * bq
    qe_rgba = base_rgba[..., None] * bq
    rre = rgb_range_error[..., None]
    are = alpha_range_error[..., None]
    adrop = eci["alpha_drop_error"][..., None]
    rgbserr = eci["rgb_scale_error"][..., None]
    lumerr = eci["luminance_error"][..., None]

    full_rgba = qe_rgba * bc_rgba[..., None] * oe_rgba + rre + are
    full_rgb = qe_rgb * bc_rgb[..., None] * oe_rgb + rre + adrop
    rgbs_alpha = qe_rgba + rgbserr + rre + are
    use_rgbs_a = rgbs_alpha < full_rgb
    col2 = torch.where(use_rgbs_a, rgbs_alpha, full_rgb)
    fm2 = torch.where(use_rgbs_a, cuq.FMT_RGB_SCALE_ALPHA, cuq.FMT_RGB)
    ldr_rgbs = qe_rgb + rre + adrop + rgbserr
    lum_alpha = qe_rgba + rre + are + lumerr
    use_rgbs = ldr_rgbs < lum_alpha
    col1 = torch.where(use_rgbs, ldr_rgbs, lum_alpha)
    fm1 = torch.where(use_rgbs, cuq.FMT_RGB_SCALE, cuq.FMT_LUMINANCE_ALPHA)
    col0 = qe_rgb + rre + adrop + lumerr

    be_hi = torch.stack([col0, col1, col2, full_rgba], -1)
    i32 = torch.int32
    fm_hi = torch.stack([torch.full_like(fm1, cuq.FMT_LUMINANCE), fm1, fm2,
                         torch.full_like(fm1, cuq.FMT_RGBA)], -1).to(i32)
    pad = tuple(counts.shape) + (QUANT_6, 4)
    be = torch.cat([torch.full(pad, ERROR_CALC_DEFAULT, device=dev), be_hi],
                   -2)
    fm_lo = torch.tensor([cuq.FMT_LUMINANCE, cuq.FMT_RGB_SCALE, cuq.FMT_RGB,
                          cuq.FMT_RGBA], dtype=i32, device=dev).expand(pad)
    return be, torch.cat([fm_lo, fm_hi], -2)


def color_error_tables_hdr(eci, ep0, ep1, counts, channel_weight,
                           encode_hdr_alpha: bool):
    """best_error/format per (n, p, quant 0..20, integer count 1..4), HDR
    profiles (reference :379-559); formats 2, 7, 11 and 14 (15 with
    encode_hdr_alpha) by integer count. Returns ((N, P, 21, 4) f32,
    (N, P, 21, 4) i32)."""
    dev = ep0.device
    cw3, cw_a, ew_rgbsum = _cw_parts(channel_weight, dev)
    psize = counts.to(torch.float32)
    ul = 61440.0
    ua = ul if encode_hdr_alpha else 65535.0
    rgb = torch.arange(4, device=dev) < 3
    e0h = torch.clamp(ep0 - torch.where(rgb, ul, ua), min=0.0)
    e1h = torch.clamp(ep1 - torch.where(rgb, ul, ua), min=0.0)
    e0l = torch.clamp(ep0, max=0.0)
    e1l = torch.clamp(ep1, max=0.0)
    sum_range = e0l * e0l + e1l * e1l + e0h * e0h + e1h * e1h
    rgb_range_error = sf.sum3(sum_range[..., :3] * cw3) * 0.5 * psize
    alpha_range_error = sum_range[..., 3] * cw_a * 0.5 * psize

    # Statistics of the RGBO and RGB submode estimates (reference :382-512)
    r1, g1, b1 = ep1[..., 0], ep1[..., 1], ep1[..., 2]
    use_r = (r1 > g1) & (r1 > b1)
    use_g = ~use_r & (g1 > b1)
    af = torch.where(use_r, r1, torch.where(use_g, g1, b1))
    cf = torch.where(use_r, r1 - ep0[..., 0],
                     torch.where(use_g, g1 - ep0[..., 1], b1 - ep0[..., 2]))
    bf = af - torch.clamp(ep1[..., :3].amin(-1), min=0.0)
    df = (ep1[..., :3] - cf[..., None] - ep0[..., :3]).abs().amax(-1)
    b_, c_, d_ = (torch.clamp(x, 0.0, 65536.0).to(torch.int32)
                  for x in (bf, cf, df))

    rgbo_mode = torch.full_like(b_, 5)
    for m, ok in ((4, (b_ < 32768) & (c_ < 16384)),
                  (3, (b_ < 8192) & (c_ < 16384)),
                  (2, (b_ < 2048) & (c_ < 16384)),
                  (1, (b_ < 2048) & (c_ < 1024)),
                  (0, (b_ < 1024) & (c_ < 4096))):
        rgbo_mode = torch.where(ok, m, rgbo_mode)
    rgb_mode = torch.full_like(b_, 8)
    for m, (bc, cc, dc) in enumerate(((16384, 8192, 8192),
                                      (32768, 8192, 4096),
                                      (4096, 8192, 4096), (8192, 8192, 2048),
                                      (8192, 2048, 512), (2048, 8192, 1024),
                                      (2048, 2048, 256), (1024, 2048, 512))):
        rgb_mode = torch.where((b_ < bc) & (c_ < cc) & (d_ < dc), m, rgb_mode)
    # Scale factors by mode (exact powers of 4): RGBO 4, 4, 16, 64, 256,
    # 1024; RGB 64, 64, 16, 16, 4, 4, 1, 1 and 384 for mode 8.
    rgbo_scale = torch.exp2(2.0 * torch.clamp(rgbo_mode, min=1))
    rgb_scale = torch.where(rgb_mode == 8, 384.0,
                            torch.exp2(2.0 * (3 - rgb_mode // 2)))
    mode7mult = rgbo_scale * 0.0015
    mode11mult = rgb_scale * 0.010
    lumdif = sf.div(sf.sum3(ep1), 3.0) - sf.div(sf.sum3(ep0), 3.0)
    mode23mult = torch.where(lumdif < 960, 4.0,
                             torch.where(lumdif < 3968, 16.0, 128.0)) * 0.0005

    bq = torch.from_numpy(_BASELINE_QUANT_ERROR[8 - QUANT_6:]).to(dev)
    base_q = bq * psize[..., None]                         # (N, P, 13)
    rgb_q = ew_rgbsum * base_q * 2.0
    rgba_q = rgb_q + cw_a * base_q * 2.0
    rre = rgb_range_error[..., None]
    adrop = eci["alpha_drop_error"][..., None]
    be_hi = torch.stack([
        rgb_q * mode23mult[..., None] + rre + adrop
        + eci["luminance_error"][..., None],
        rgb_q * mode7mult[..., None] + rre + adrop
        + eci["rgb_luma_error"][..., None],
        rgb_q * mode11mult[..., None] + rre + adrop,
        rgba_q + rre + alpha_range_error[..., None]], -1)
    pad = tuple(counts.shape) + (8, 4)
    be = torch.cat([torch.full(pad, ERROR_CALC_DEFAULT, device=dev), be_hi],
                   -2)
    fm = torch.tensor([cuq.FMT_HDR_LUMINANCE_LARGE_RANGE,
                       cuq.FMT_HDR_RGB_SCALE, cuq.FMT_HDR_RGB,
                       cuq.FMT_HDR_RGBA if encode_hdr_alpha
                       else cuq.FMT_HDR_RGB_LDR_ALPHA], dtype=torch.int32,
                      device=dev).expand(tuple(counts.shape) + (21, 4))
    return be, fm


def combine_partitions(be, fm, pc: int):
    """Best combined (error, formats) per (quant, total integer count) for
    2-4 partitions (reference: {two,three,four}_partitions_find_best_
    combination_for_every_quantization_and_integer_count, :728, :842,
    :967). Combos whose per-partition integer counts differ by more than
    one are invalid; on equal error the later combo wins (the reference's
    <= updates in enumeration order).

    be/fm: (N, P, 21, 4). Returns (comb_err (N, 21, S) f32, comb_fmt
    (N, 21, S, pc) int32) with S = 7, 10, 13 for pc = 2, 3, 4.
    """
    S = {2: 7, 3: 10, 4: 13}[pc]
    N = be.shape[0]
    dev = be.device
    groups = [[] for _ in range(S)]
    for combo in itertools.product(range(4), repeat=pc):
        if max(combo) - min(combo) <= 1:
            groups[sum(combo)].append(combo)
    err_cols, fmt_cols = [], []
    for intcnt in range(S):
        combos = groups[intcnt]
        if not combos:
            err_cols.append(torch.full((N, 21), ERROR_CALC_DEFAULT,
                                       device=dev))
            fmt_cols.append(torch.zeros((N, 21, pc), dtype=torch.int32,
                                        device=dev))
            continue
        errs = []
        for c in combos:
            acc = be[:, 0, :, c[0]]
            for p in range(1, pc):
                acc = acc + be[:, p, :, c[p]]
            errs.append(torch.clamp(acc, max=1e10))
        errs = torch.stack(errs, -1)                        # (N, 21, K)
        K = len(combos)
        # Last minimum: the first minimum of the reversed combo axis.
        idx = K - 1 - errs.flip(-1).min(-1).indices
        err_cols.append(errs.amin(-1))
        fmts = torch.stack(
            [torch.stack([fm[:, p, :, c[p]] for p in range(pc)], -1)
             for c in combos], -2)                          # (N, 21, K, pc)
        fmt_cols.append(torch.gather(
            fmts, 2, idx[..., None, None].expand(N, 21, 1, pc))[:, :, 0])
    return torch.stack(err_cols, -1), torch.stack(fmt_cols, -2).to(
        torch.int32)


def best_for_bitcount(comb_err, comb_fmt, quant_mode_table_np, bitcounts_np,
                      pc: int = 1, mod_bits: int = 0):
    """Per-mode best (quant, quant_mod, formats, error) for its bit budget
    (reference: {one,two,three,four}_partitions_find_best_combination_for_
    bitcount, :678, :780, :905, :1041).

    comb_err: pc=1 (N, 21, 4), else (N, 21, S); comb_fmt: pc=1 (N, 21, 4),
    else (N, 21, S, pc); bitcounts_np: (M,) bits available per mode;
    mod_bits: the extra bits of the matched-format encoding (0, 2, 5, 8).
    Returns dict of (N, M) tensors and formats (N, M, pc).
    """
    dev = comb_err.device
    qmt = quant_mode_table_np
    bits = np.clip(np.asarray(bitcounts_np, np.int64), 0, 127)
    if pc == 1:
        ics = list(range(1, 5))
        ic_base = 1
        S = 4
        comb_fmt = comb_fmt[..., None]
    else:
        S = comb_err.shape[-1]
        ics = list(range(pc, min(4 * pc, 9) + 1))
        ic_base = pc
    cand = []
    for ic in ics:
        ql = qmt[ic, bits]
        qlc = torch.from_numpy(np.clip(ql, 0, 20).astype(np.int64)).to(dev)
        err_ic = comb_err[:, qlc, ic - ic_base]                   # (N, M)
        valid = torch.from_numpy(ql >= QUANT_6).to(dev)
        cand.append(torch.where(valid, err_ic, ERROR_CALC_DEFAULT))
    cand = torch.stack(cand, -1)
    best_err, best_idx = cand.min(-1)              # first minimum
    ics_t = torch.tensor(ics, device=dev)
    best_ic = torch.where(best_err >= ERROR_CALC_DEFAULT,
                          1 if pc == 1 else 0, ics_t[best_idx])
    qmt_b = torch.from_numpy(qmt[:, bits].astype(np.int64)).to(dev)
    qmt_m = torch.from_numpy(
        qmt[:, np.clip(bits + mod_bits, 0, 127)].astype(np.int64)).to(dev)
    M = bits.shape[0]
    mi = torch.arange(M, device=dev)[None, :]
    ql = qmt_b[best_ic, mi]
    ql_mod = qmt_m[best_ic, mi]
    qlc = ql.clamp(QUANT_6, 20)
    slot = (best_ic - ic_base).clamp(0, S - 1)
    N = comb_err.shape[0]
    ni = torch.arange(N, device=dev)[:, None]
    fmts = comb_fmt[ni, qlc, slot]                           # (N, M, pc)
    fmts = torch.where((ql >= QUANT_6)[..., None], fmts, cuq.FMT_LUMINANCE)
    return {"error": best_err, "quant": ql.to(torch.int32),
            "quant_mod": ql_mod.to(torch.int32),
            "formats": fmts.to(torch.int32)}


def select_candidates(total_errors, C: int):
    """The C best modes in the reference's order: repeated argmin with the
    lowest index winning ties (reference: :1286-1356).

    Returns (cand_modes (N, C) int64, -1 if none; cand_valid (N, C) bool).
    """
    errs = total_errors.clone()
    modes = []
    valids = []
    ar = torch.arange(errs.shape[-1], device=errs.device)[None, :]
    for _ in range(C):
        val, idx = errs.min(-1)
        ok = val < ERROR_CALC_DEFAULT
        modes.append(torch.where(ok, idx, -1))
        valids.append(ok)
        errs = torch.where(ar == idx[:, None], ERROR_CALC_DEFAULT, errs)
    return torch.stack(modes, -1), torch.stack(valids, -1)
