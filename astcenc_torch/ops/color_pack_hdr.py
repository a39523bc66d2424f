"""Encoder-side colour endpoint packing of the HDR profiles.

Port of ``astcenc_tpu/ops/color_pack_hdr.py`` (reference
astcenc_color_quantize.cpp:925-1905): the reference's "try the modes in
order, the first that fits wins" loops and its
quantize_and_unquantize_retain_top_N_bits decrement loops become candidate
evaluation over the whole batch with first-valid selection. Colours are in
the 0..65535 LNS-code domain. Every table lookup goes through
``color_pack._Q``.

That is the plain version. On the card ``pack_color_endpoints`` launches the
colour pack kernel (``csrc/color_pack.cu``, ``color_pack.pack_cuda``) once
per call; its HDR arm is ``csrc/color_pack_hdr.cuh``, transcribed from this
module.
"""

from __future__ import annotations

import torch

from ..tables import ise
from . import _build
from . import color_pack as cp
from . import color_unquant as cuq
from . import softfloat as sf

_THIRD = torch.tensor(1.0 / 3.0, dtype=torch.float32).item()


def _rtn(x):
    return torch.floor(x + 0.5).to(torch.int32)


def _rtn_trunc(x):
    """astc::flt2int_rtn of a possibly negative value: C's (int)(v + 0.5f)
    truncates toward zero (reference astcenc_mathlib.h:328-332)."""
    return torch.trunc(x + 0.5).to(torch.int32)


def _retain_top_bits(q, value, top_mask: int, max_steps: int = 72):
    """quantize_and_unquantize_retain_top_{two,four}_bits (reference
    :833-905): the quantization of the first of value, value - 1, ... whose
    bits under top_mask survive it, all steps at once."""
    k = torch.arange(max_steps, dtype=torch.int32, device=value.device)
    vk = torch.clamp(value[..., None] - k, 0, 255)
    qk = q.color(vk)
    ok = (qk & top_mask) == (vk & top_mask)
    first = ok.to(torch.int32).argmax(-1, keepdim=True)
    return torch.gather(qk, -1, first)[..., 0]


def _swz(majcomp, r, g, b):
    return (torch.where(majcomp == 1, g, torch.where(majcomp == 2, b, r)),
            torch.where(majcomp == 1, r, g),
            torch.where(majcomp == 2, r, b))


def _majcomp(r, g, b):
    return torch.where((r > g) & (r > b), 0,
                       torch.where(g > b, 1, 2)).to(torch.int32)


def quantize_hdr_rgbo(color, q):
    """FMT_HDR_RGB_SCALE from the (B, 4) rgbo vector (reference
    :925-1253). Returns (B, 4) values."""
    color = torch.clamp(torch.cat([color[:, :3] + color[:, 3:4],
                                   color[:, 3:4]], 1), 0.0, 65535.0)
    r, g, b = color[:, 0], color[:, 1], color[:, 2]
    majcomp = _majcomp(r, g, b)
    cr, cg, cb = _swz(majcomp, r, g, b)
    g_base = cr - cg
    b_base = cr - cb
    s_base = color[:, 3]

    mode_bits = ((11, 5, 7), (11, 6, 5), (10, 5, 8), (9, 6, 7), (8, 7, 6))
    mode_cutoffs = ((1024, 4096), (2048, 1024), (2048, 16384),
                    (8192, 16384), (32768, 16384))
    mode_rscales = (32.0, 32.0, 64.0, 128.0, 256.0)
    B = color.shape[0]
    out = torch.zeros((B, 4), dtype=torch.int32, device=color.device)
    done = torch.zeros((B,), dtype=torch.bool, device=color.device)
    for mode in range(5):
        gb_cut, s_cut = mode_cutoffs[mode]
        pre_ok = (g_base <= gb_cut) & (b_base <= gb_cut) & (s_base <= s_cut)
        mode_enc = (mode | (majcomp << 2)) if mode < 4 else (majcomp | 0xC)
        rscale = mode_rscales[mode]
        mscale = 1.0 / rscale
        gb_intcut = 1 << mode_bits[mode][1]
        s_intcut = 1 << mode_bits[mode][2]

        r_int = _rtn(cr * mscale)
        r_q = _retain_top_bits(q, (r_int & 0x3F) | ((mode_enc & 3) << 6),
                               0xC0)
        r_int = (r_int & ~0x3F) | (r_q & 0x3F)
        r_f = r_int.to(torch.float32) * rscale

        g_int = _rtn(torch.clamp(r_f - cg, 0.0, 65535.0) * mscale)
        b_int = _rtn(torch.clamp(r_f - cb, 0.0, 65535.0) * mscale)
        ok = pre_ok & (g_int < gb_intcut) & (b_int < gb_intcut)

        bit0 = {0: (r_int >> 9) & 1, 2: (r_int >> 9) & 1,
                1: (r_int >> 8) & 1, 3: (r_int >> 8) & 1,
                4: (g_int >> 6) & 1}[mode]
        bit2 = ((r_int >> 7) & 1) if mode < 4 else ((b_int >> 6) & 1)
        bit1 = ((r_int >> 8) & 1) if mode in (0, 2) else ((g_int >> 5) & 1)
        if mode == 0:
            bit3 = (r_int >> 10) & 1
        elif mode == 2:
            bit3 = (r_int >> 6) & 1
        else:
            bit3 = (b_int >> 5) & 1
        g_low = ((g_int & 0x1F) | ((mode_enc & 0x4) << 5) | (bit0 << 6)
                 | (bit1 << 5))
        b_low = ((b_int & 0x1F) | ((mode_enc & 0x8) << 4) | (bit2 << 6)
                 | (bit3 << 5))
        g_q = _retain_top_bits(q, g_low, 0xF0)
        b_q = _retain_top_bits(q, b_low, 0xF0)
        g_int = (g_int & ~0x1F) | (g_q & 0x1F)
        b_int = (b_int & ~0x1F) | (b_q & 0x1F)
        g_f = g_int.to(torch.float32) * rscale
        b_f = b_int.to(torch.float32) * rscale

        rgb_errsum = (r_f - cr) + (r_f - g_f - cg) + (r_f - b_f - cb)
        s_f = torch.clamp(s_base + rgb_errsum * _THIRD, 0.0, 1e9)
        s_int = _rtn(s_f * mscale)
        ok = ok & (s_int < s_intcut)
        bit6 = ((r_int >> 9) & 1) if mode == 1 else ((s_int >> 5) & 1)
        if mode == 4:
            bit5 = (r_int >> 7) & 1
        elif mode == 1:
            bit5 = (r_int >> 10) & 1
        else:
            bit5 = (s_int >> 6) & 1
        bit4 = ((s_int >> 7) & 1) if mode == 2 else ((r_int >> 6) & 1)
        s_q = _retain_top_bits(
            q, (s_int & 0x1F) | (bit6 << 5) | (bit5 << 6) | (bit4 << 7), 0xF0)

        take = ok & ~done
        out = torch.where(take[:, None], torch.stack([r_q, g_q, b_q, s_q], -1),
                          out)
        done = done | ok

    # Fallback mode 5 (reference :1210-1253): RGB clamps first; the scale
    # is clamped only after the error is added.
    v = torch.clamp(color[:, :3], 0.0, 65020.0)
    iv = _rtn(v * (1.0 / 512.0))
    cv = iv.to(torch.float32) * 512.0
    errsum = ((cv[:, 0] - v[:, 0]) + (cv[:, 1] - v[:, 1])
              + (cv[:, 2] - v[:, 2]))
    s3 = torch.clamp(color[:, 3] + errsum * _THIRD, 0.0, 65020.0)
    i3 = _rtn(s3 * (1.0 / 512.0))
    encs = ((iv[:, 0] & 0x3F) | 0xC0, (iv[:, 1] & 0x7F) | 0x80,
            (iv[:, 2] & 0x7F) | 0x80, (i3 & 0x7F) | ((iv[:, 0] & 0x40) << 1))
    fb = torch.stack([_retain_top_bits(q, e, 0xF0) for e in encs], -1)
    return torch.where(done[:, None], out, fb)


def quantize_hdr_rgb(c0, c1, q):
    """FMT_HDR_RGB (reference :1253-1640). Returns (B, 6) values."""
    c0 = torch.clamp(c0, 0.0, 65535.0)
    c1 = torch.clamp(c1, 0.0, 65535.0)
    majcomp = _majcomp(c1[:, 0], c1[:, 1], c1[:, 2])
    c0r, c0g, c0bl = _swz(majcomp, c0[:, 0], c0[:, 1], c0[:, 2])
    c1r, c1g, c1bl = _swz(majcomp, c1[:, 0], c1[:, 1], c1[:, 2])

    a_base = torch.clamp(c1r, 0.0, 65535.0)
    b0_base = a_base - c1g
    b1_base = a_base - c1bl
    c_base = a_base - c0r
    d0_base = a_base - b0_base - c_base - c0g
    d1_base = a_base - b1_base - c_base - c0bl

    mode_bits = ((9, 7, 6, 7), (9, 8, 6, 6), (10, 6, 7, 7), (10, 7, 7, 6),
                 (11, 8, 6, 5), (11, 6, 8, 6), (12, 7, 7, 5), (12, 6, 7, 6))
    mode_cutoffs = ((16384, 8192, 8192), (32768, 8192, 4096),
                    (4096, 8192, 4096), (8192, 8192, 2048),
                    (8192, 2048, 512), (2048, 8192, 1024),
                    (2048, 2048, 256), (1024, 2048, 512))
    mode_rscales = (128.0, 128.0, 64.0, 64.0, 32.0, 32.0, 16.0, 16.0)
    B = c0.shape[0]
    out = torch.zeros((B, 6), dtype=torch.int32, device=c0.device)
    done = torch.zeros((B,), dtype=torch.bool, device=c0.device)
    for mode in range(7, -1, -1):
        b_cut, c_cut, d_cut = mode_cutoffs[mode]
        pre_ok = ((b0_base <= b_cut) & (b1_base <= b_cut) & (c_base <= c_cut)
                  & (d0_base.abs() <= d_cut) & (d1_base.abs() <= d_cut))
        rscale = mode_rscales[mode]
        mscale = 1.0 / rscale
        b_intcut = 1 << mode_bits[mode][1]
        c_intcut = 1 << mode_bits[mode][2]
        d_intcut = 1 << (mode_bits[mode][3] - 1)

        a_int = _rtn(a_base * mscale)
        a_q = q.color(a_int & 0xFF)
        a_int = (a_int & ~0xFF) | a_q
        a_f = a_int.to(torch.float32) * rscale

        c_int = _rtn(torch.clamp(a_f - c0r, 0.0, 65535.0) * mscale)
        ok = pre_ok & (c_int < c_intcut)
        c_q = _retain_top_bits(
            q, (c_int & 0x3F) | ((mode & 1) << 7) | ((a_int & 0x100) >> 2),
            0xC0)
        c_int = (c_int & ~0x3F) | (c_q & 0x3F)
        c_f = c_int.to(torch.float32) * rscale

        b0_int = _rtn(torch.clamp(a_f - c1g, 0.0, 65535.0) * mscale)
        b1_int = _rtn(torch.clamp(a_f - c1bl, 0.0, 65535.0) * mscale)
        ok = ok & (b0_int < b_intcut) & (b1_int < b_intcut)
        if mode in (0, 1, 3, 4, 6):
            bit0 = (b0_int >> 6) & 1
            bit1 = (b1_int >> 6) & 1
        elif mode == 2:
            bit0 = (a_int >> 9) & 1
            bit1 = (c_int >> 6) & 1
        else:  # 5, 7
            bit0 = (a_int >> 9) & 1
            bit1 = (a_int >> 10) & 1
        b0_q = _retain_top_bits(
            q, (b0_int & 0x3F) | (bit0 << 6) | (((mode >> 1) & 1) << 7), 0xC0)
        b1_q = _retain_top_bits(
            q, (b1_int & 0x3F) | (bit1 << 6) | (((mode >> 2) & 1) << 7), 0xC0)
        b0_int = (b0_int & ~0x3F) | (b0_q & 0x3F)
        b1_int = (b1_int & ~0x3F) | (b1_q & 0x3F)
        b0_f = b0_int.to(torch.float32) * rscale
        b1_f = b1_int.to(torch.float32) * rscale

        d0_int = _rtn_trunc(torch.clamp(a_f - b0_f - c_f - c0g,
                                        -65535.0, 65535.0) * mscale)
        d1_int = _rtn_trunc(torch.clamp(a_f - b1_f - c_f - c0bl,
                                        -65535.0, 65535.0) * mscale)
        ok = ok & (d0_int.abs() < d_intcut) & (d1_int.abs() < d_intcut)
        if mode in (0, 2):
            bit2 = (d0_int >> 6) & 1
            bit3 = (d1_int >> 6) & 1
        elif mode in (1, 4):
            bit2 = (b0_int >> 7) & 1
            bit3 = (b1_int >> 7) & 1
        elif mode == 3:
            bit2 = (a_int >> 9) & 1
            bit3 = (c_int >> 6) & 1
        elif mode == 5:
            bit2 = (c_int >> 7) & 1
            bit3 = (c_int >> 6) & 1
        else:  # 6, 7
            bit2 = (a_int >> 11) & 1
            bit3 = (c_int >> 6) & 1
        if mode in (4, 6):
            bit4 = (a_int >> 9) & 1
            bit5 = (a_int >> 10) & 1
        else:
            bit4 = (d0_int >> 5) & 1
            bit5 = (d1_int >> 5) & 1
        d0_q = _retain_top_bits(
            q, (d0_int & 0x1F) | (bit2 << 6) | (bit4 << 5)
            | ((majcomp & 1) << 7), 0xF0)
        d1_q = _retain_top_bits(
            q, (d1_int & 0x1F) | (bit3 << 6) | (bit5 << 5)
            | (((majcomp >> 1) & 1) << 7), 0xF0)

        take = ok & ~done
        out = torch.where(take[:, None],
                          torch.stack([a_q, c_q, b0_q, b1_q, d0_q, d1_q], -1),
                          out)
        done = done | ok

    # Flat fallback (reference :1600-1640)
    v = [torch.clamp(x, 0.0, 65020.0) for x in
         (c0[:, 0], c1[:, 0], c0[:, 1], c1[:, 1], c0[:, 2], c1[:, 2])]
    fb = [q.color(_rtn(v[i] / 256.0)) for i in range(4)]
    fb += [_retain_top_bits(q, _rtn(v[i] / 512.0) + 128, 0xC0)
           for i in range(4, 6)]
    return torch.where(done[:, None], out, torch.stack(fb, -1))


def _lum_pair(c0, c1):
    lum0 = sf.div(sf.sum3(c0), 3.0)
    lum1 = sf.div(sf.sum3(c1), 3.0)
    swap = lum1 < lum0
    avg = (lum0 + lum1) * 0.5
    return (_rtn(torch.where(swap, avg, lum0)),
            _rtn(torch.where(swap, avg, lum1)))


def quantize_hdr_luminance_large(c0, c1, q):
    """FMT_HDR_LUMINANCE_LARGE_RANGE (reference :1644-1706)."""
    il0, il1 = _lum_pair(c0, c1)
    up0 = torch.clamp((il0 + 128) >> 8, 0, 255)
    up1 = torch.clamp((il1 + 128) >> 8, 0, 255)
    lo0 = torch.clamp((il1 + 256) >> 8, 0, 255)
    lo1 = torch.clamp(il0 >> 8, 0, 255)
    ud0 = (up0 << 8) - il0
    ud1 = (up1 << 8) - il1
    ld0 = ((lo1 << 8) + 128) - il0
    ld1 = ((lo0 << 8) - 128) - il1
    use_up = ud0 * ud0 + ud1 * ud1 < ld0 * ld0 + ld1 * ld1
    return q.color(torch.stack([torch.where(use_up, up0, lo0),
                                torch.where(use_up, up1, lo1)], -1))


def try_quantize_hdr_luminance_small(c0, c1, q):
    """FMT_HDR_LUMINANCE_SMALL_RANGE (reference :1716-1812). Returns
    (ok (B,), values (B, 2))."""
    il0, il1 = _lum_pair(c0, c1)
    feasible = (il1 - il0) <= 2048

    # high-precision submode
    lo = torch.clamp((il0 + 16) >> 5, 0, 2047)
    hi = torch.clamp((il1 + 16) >> 5, 0, 2047)
    v0e = q.color(lo & 0x7F)
    lo2 = (lo & ~0x7F) | v0e
    diff = hi - lo2
    v1 = ((lo2 >> 3) & 0xF0) | torch.clamp(diff, 0, 15)
    v1e = q.color(v1)
    hp_ok = ((v0e < 0x80) & (diff >= 0) & (diff <= 15)
             & ((v1e & 0xF0) == (v1 & 0xF0)))
    hp_vals = torch.stack([v0e, v1e], -1)

    # low-precision submode
    lo = torch.clamp((il0 + 32) >> 6, 0, 1023)
    hi = torch.clamp((il1 + 32) >> 6, 0, 1023)
    v0e = q.color((lo & 0x7F) | 0x80)
    lo2 = (lo & ~0x7F) | (v0e & 0x7F)
    diff = hi - lo2
    v1 = ((lo2 >> 2) & 0xE0) | torch.clamp(diff, 0, 31)
    v1e = q.color(v1)
    lp_ok = (((v0e & 0x80) != 0) & (diff >= 0) & (diff <= 31)
             & ((v1e & 0xE0) == (v1 & 0xE0)))
    lp_vals = torch.stack([v0e, v1e], -1)
    return (feasible & (hp_ok | lp_ok),
            torch.where(hp_ok[:, None], hp_vals, lp_vals))


def quantize_hdr_alpha(a0, a1, q):
    """HDR alpha (reference :1816-1885). Returns (B, 2) values."""
    ia0 = _rtn(torch.clamp(a0, 0.0, 65280.0))
    ia1 = _rtn(torch.clamp(a1, 0.0, 65280.0))
    out = torch.zeros((ia0.shape[0], 2), dtype=torch.int32, device=a0.device)
    done = torch.zeros_like(ia0, dtype=torch.bool)
    testbits = (0xE0, 0xF0, 0xF8)
    for i in (2, 1, 0):
        val0 = (ia0 + (128 >> i)) >> (8 - i)
        val1 = (ia1 + (128 >> i)) >> (8 - i)
        v6 = (val0 & 0x7F) | ((i & 1) << 7)
        v6e = q.color(v6)
        ok = ((v6 ^ v6e) & 0x80) == 0
        val0b = (val0 & ~0x7F) | (v6e & 0x7F)
        diff = val1 - val0b
        cutoff = 32 >> i
        ok = ok & (diff >= -cutoff) & (diff < cutoff)
        v7 = ((i & 2) << 6) | ((val0b >> 7) << (6 - i)) | (diff & (2 * cutoff
                                                                  - 1))
        v7e = q.color(v7)
        ok = ok & (((v7 ^ v7e) & testbits[i]) == 0)
        take = ok & ~done
        out = torch.where(take[:, None], torch.stack([v6e, v7e], -1), out)
        done = done | ok
    fb = q.color(torch.stack([((ia0 + 256) >> 9) | 0x80,
                              ((ia1 + 256) >> 9) | 0x80], -1))
    return torch.where(done[:, None], out, fb)


def pack_color_endpoints_hdr(ep0, ep1, rgbo, req_fmt, quant_level):
    """HDR-format arm of pack_color_endpoints (reference :2049-2141):
    FMT_HDR_RGB_SCALE, FMT_HDR_RGB, FMT_HDR_LUMINANCE_*,
    FMT_HDR_RGB_LDR_ALPHA and FMT_HDR_RGBA. Returns (fmt (B,), values
    (B, 8))."""
    q = cp._Q(torch.clamp(quant_level - ise.QUANT_6, 0, 16))
    B = ep0.shape[0]
    z8 = torch.zeros((B, 8), dtype=torch.int32, device=ep0.device)

    def pad8(v):
        return torch.cat([v, z8[:, v.shape[1]:]], 1)

    v_rgbo = pad8(quantize_hdr_rgbo(rgbo, q))
    v_rgb6 = quantize_hdr_rgb(ep0, ep1, q)
    v_rgb = pad8(v_rgb6)
    sm_ok, sm_vals = try_quantize_hdr_luminance_small(ep0, ep1, q)
    lg_vals = quantize_hdr_luminance_large(ep0, ep1, q)
    v_lum = pad8(torch.where(sm_ok[:, None], sm_vals, lg_vals))
    f_lum = torch.where(sm_ok, cuq.FMT_HDR_LUMINANCE_SMALL_RANGE,
                        cuq.FMT_HDR_LUMINANCE_LARGE_RANGE)
    a = torch.clamp(sf.div(torch.stack([ep0[:, 3], ep1[:, 3]], -1), 257.0),
                    0.0, 255.0)
    v_rgba_ldr = torch.cat([v_rgb6, q.color_res(_rtn(a), a)], 1)
    v_rgba_hdr = torch.cat([v_rgb6, quantize_hdr_alpha(ep0[:, 3], ep1[:, 3],
                                                       q)], 1)
    full = torch.zeros_like(req_fmt)
    out_fmt = full + cuq.FMT_HDR_RGB
    out_vals = v_rgb
    lum = ((req_fmt == cuq.FMT_HDR_LUMINANCE_SMALL_RANGE)
           | (req_fmt == cuq.FMT_HDR_LUMINANCE_LARGE_RANGE))
    for m, f, v in ((req_fmt == cuq.FMT_HDR_RGB_SCALE,
                     full + cuq.FMT_HDR_RGB_SCALE, v_rgbo),
                    (lum, f_lum, v_lum),
                    (req_fmt == cuq.FMT_HDR_RGB_LDR_ALPHA,
                     full + cuq.FMT_HDR_RGB_LDR_ALPHA, v_rgba_ldr),
                    (req_fmt == cuq.FMT_HDR_RGBA, full + cuq.FMT_HDR_RGBA,
                     v_rgba_hdr)):
        out_fmt = torch.where(m, f, out_fmt)
        out_vals = torch.where(m[:, None], v, out_vals)
    return out_fmt.to(torch.int32), out_vals.to(torch.int32)


def pack_color_endpoints_plain(profile: int, ep0, ep1, rgbs, rgbo, req_fmt,
                               quant_level):
    """Plain version of ``pack_color_endpoints``: the LDR packer, and for
    the HDR profiles both arms with the HDR one taking the HDR formats."""
    fmt_l, vals_l = cp.pack_color_endpoints_ldr_plain(ep0, ep1, rgbs, req_fmt,
                                                      quant_level)
    if profile < cuq.PRF_HDR_RGB_LDR_A:
        return fmt_l, vals_l
    fmt_h, vals_h = pack_color_endpoints_hdr(ep0, ep1, rgbo, req_fmt,
                                             quant_level)
    is_hdr = cuq.is_format(req_fmt, cuq.HDR_FORMATS)
    return (torch.where(is_hdr, fmt_h, fmt_l),
            torch.where(is_hdr[:, None], vals_h, vals_l))


def pack_color_endpoints(profile: int, ep0, ep1, rgbs, rgbo, req_fmt,
                         quant_level):
    """Profile-aware pack_color_endpoints: ep0, ep1, rgbs, rgbo (B, 4)
    float32, req_fmt and quant_level (B,) int32 -> (fmt (B,), values
    (B, 8)) int32. One launch of the colour pack kernel or the plain
    version, as ``_build.use_kernel`` says."""
    if _build.use_kernel("color_pack", ep0):
        return cp.pack_cuda(profile, *cp.pack_args(ep0, ep1, rgbs, rgbo,
                                                   req_fmt, quant_level))
    return pack_color_endpoints_plain(profile, ep0, ep1, rgbs, rgbo, req_fmt,
                                      quant_level)
