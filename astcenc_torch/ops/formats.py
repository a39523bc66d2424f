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

QUANT_6 = 4
ERROR_CALC_DEFAULT = 1e30

_BASELINE_QUANT_ERROR = np.array([
    (65536.0 * 65536.0 / 18.0) / (d * d)
    for d in (5, 7, 9, 11, 15, 19, 23, 31, 39, 47, 63, 79, 95, 127, 159, 191,
              255)], dtype=np.float32)


def _cw_parts(channel_weight, device):
    cw = torch.tensor(channel_weight, dtype=torch.float32, device=device)
    return cw[:3], cw[3], cw[:3].sum()


def encoding_choice_errors(texels, pmask, ep0, ep1, channel_weight,
                           is_luminance, default_alpha: float):
    """Errors of the cheaper endpoint encodings per partition (reference:
    compute_encoding_choice_errors, :222-300). Returns dict of (N, P)."""
    dev = texels.device
    cw3, cw_a, _ = _cw_parts(channel_weight, dev)
    rgb_mask = (1, 1, 1, 0)
    avg, dirv = ideal_ops.avgs_and_dirs(texels, pmask, rgb_mask)
    uncor_b = ideal_ops.normalize_safe(dirv, rgb_mask)
    m3 = torch.tensor([1, 1, 1, 0.0], device=dev)
    samec_b = ideal_ops.normalize_safe(avg * m3, rgb_mask)
    unit3 = m3 / float(np.sqrt(3.0))

    def line_err(b_t, amod_t):
        param = (texels[..., :3] * b_t[..., :3]).sum(-1)
        dist = amod_t[..., :3] + param[..., None] * b_t[..., :3] \
            - texels[..., :3]
        err = (dist * dist * cw3).sum(-1)
        return torch.einsum("ntp,nt->np", pmask, err)

    def proj(a, b):
        d = (a[..., :3] * b[..., :3]).sum(-1, keepdim=True)
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
    a_drop = torch.einsum("ntp,nt->np", pmask, a_diff * a_diff) * cw_a
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
    rgb_range_error = (sum_range[..., :3] * cw3).sum(-1) * 0.5 * psize
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
