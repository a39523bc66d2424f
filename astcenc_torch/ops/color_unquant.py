"""Decoder-side colour endpoint reconstruction, all four profiles.

Port of ``astcenc_tpu/ops/color_unquant.py`` (reference
astcenc_color_unquantize.cpp:844-1023): every endpoint format decodes on
the whole batch and the right one is selected per element. In the LDR
profiles the HDR formats decode as the error colour; in the HDR profiles
they decode to 16-bit LNS codes and the LDR formats to UNORM16.
"""

from __future__ import annotations

import torch

PRF_LDR_SRGB = 0
PRF_LDR = 1
PRF_HDR_RGB_LDR_A = 2
PRF_HDR = 3

FMT_LUMINANCE = 0
FMT_LUMINANCE_DELTA = 1
FMT_HDR_LUMINANCE_LARGE_RANGE = 2
FMT_HDR_LUMINANCE_SMALL_RANGE = 3
FMT_LUMINANCE_ALPHA = 4
FMT_LUMINANCE_ALPHA_DELTA = 5
FMT_RGB_SCALE = 6
FMT_HDR_RGB_SCALE = 7
FMT_RGB = 8
FMT_RGB_DELTA = 9
FMT_RGB_SCALE_ALPHA = 10
FMT_HDR_RGB = 11
FMT_RGBA = 12
FMT_RGBA_DELTA = 13
FMT_HDR_RGB_LDR_ALPHA = 14
FMT_HDR_RGBA = 15

_LDR_FORMATS = (0, 1, 4, 5, 6, 8, 9, 10, 12, 13)
HDR_FORMATS = (2, 3, 7, 11, 14, 15)
# Formats whose alpha takes the profile's default (reference :992-1010).
_ALPHA_DEFAULT_FORMATS = (2, 3, 7, 11)


def _stack(*c):
    return torch.stack(c, dim=-1)


def _uncontract(c):
    """Reverse blue contraction on RGB lanes (reference: :35-41)."""
    b = c[..., 2:3]
    return torch.cat([(c[..., :2] + b) >> 1, c[..., 2:]], dim=-1)


def _rgba_unpack(v0, v1):
    """Direct RGBA with blue-contract swap (reference: :105-121)."""
    swap = (v0[..., :3].sum(-1) > v1[..., :3].sum(-1))[..., None]
    return (torch.where(swap, _uncontract(v1), v0),
            torch.where(swap, _uncontract(v0), v1))


def _rgba_delta_unpack(v0, v1):
    """Delta RGBA with bit transfer and blue contraction (reference: :61-82)."""
    base = (v0 >> 1) | (v1 & 0x80)
    d = (v1 >> 1) & 0x3F
    d = torch.where((d & 0x20) != 0, d - 0x40, d)
    hi = d + base
    swap = (d[..., :3].sum(-1) < 0)[..., None]
    out0 = torch.where(swap, _uncontract(hi), base)
    out1 = torch.where(swap, _uncontract(base), hi)
    return out0.clamp(0, 255), out1.clamp(0, 255)


def is_format(fmt, formats):
    """fmt is one of ``formats`` (elementwise), without a device table."""
    out = fmt == formats[0]
    for f in formats[1:]:
        out = out | (fmt == f)
    return out


def _on(oh, mask: int):
    return (oh & mask) != 0


def _hdr_rgbo_unpack(v):
    """HDR RGB + scale-offset, FMT_HDR_RGB_SCALE (reference :310-489)."""
    v0, v1, v2, v3 = (v[..., i] for i in range(4))
    modeval = (((v0 & 0xC0) >> 6) | (((v1 & 0x80) >> 7) << 2)
               | (((v2 & 0x80) >> 7) << 3))
    not_c = (modeval & 0xC) != 0xC
    not_f = modeval != 0xF
    majcomp = torch.where(not_c, modeval >> 2,
                          torch.where(not_f, modeval & 3, 0))
    mode = torch.where(not_c, modeval & 3,
                       torch.where(not_f, torch.full_like(modeval, 4), 5))

    red = v0 & 0x3F
    green = v1 & 0x1F
    blue = v2 & 0x1F
    scale = v3 & 0x1F
    bit0 = (v1 >> 6) & 1
    bit1 = (v1 >> 5) & 1
    bit2 = (v2 >> 6) & 1
    bit3 = (v2 >> 5) & 1
    bit4 = (v3 >> 7) & 1
    bit5 = (v3 >> 6) & 1
    bit6 = (v3 >> 5) & 1
    oh = torch.ones_like(mode) << mode

    def put(x, mask, bit, sh):
        return x | torch.where(_on(oh, mask), bit << sh, 0)

    green = put(put(green, 0x30, bit0, 6), 0x3A, bit1, 5)
    blue = put(put(blue, 0x30, bit2, 6), 0x3A, bit3, 5)
    scale = put(put(put(scale, 0x3D, bit6, 5), 0x2D, bit5, 6), 0x04, bit4, 7)
    for mask, bit, sh in ((0x3B, bit4, 6), (0x04, bit3, 6), (0x10, bit5, 7),
                          (0x0F, bit2, 7), (0x05, bit1, 8), (0x0A, bit0, 8),
                          (0x05, bit0, 9), (0x02, bit6, 9), (0x01, bit3, 10),
                          (0x02, bit5, 10)):
        red = put(red, mask, bit, sh)

    shamt = torch.clamp(mode, min=1)                # 1, 1, 2, 3, 4, 5
    red = red << shamt
    green = green << shamt
    blue = blue << shamt
    scale = scale << shamt
    is_m5 = mode == 5
    green = torch.where(is_m5, green, red - green)
    blue = torch.where(is_m5, blue, red - blue)

    r, g, b = red, green, blue
    red = torch.where(majcomp == 1, g, torch.where(majcomp == 2, b, r))
    green = torch.where(majcomp == 1, r, g)
    blue = torch.where(majcomp == 2, r, b)

    h78 = torch.full_like(red, 0x7800)
    e0 = _stack(torch.clamp(red - scale, min=0) << 4,
                torch.clamp(green - scale, min=0) << 4,
                torch.clamp(blue - scale, min=0) << 4, h78)
    e1 = _stack(torch.clamp(red, min=0) << 4, torch.clamp(green, min=0) << 4,
                torch.clamp(blue, min=0) << 4, h78)
    return e0, e1


def _hdr_rgb_unpack(v):
    """HDR RGB direct, FMT_HDR_RGB (reference :498-679)."""
    v0, v1, v2, v3, v4, v5 = (v[..., i] for i in range(6))
    modeval = (((v1 & 0x80) >> 7) | (((v2 & 0x80) >> 7) << 1)
               | (((v3 & 0x80) >> 7) << 2))
    majcomp = ((v4 & 0x80) >> 7) | (((v5 & 0x80) >> 7) << 1)
    h78 = torch.full_like(v0, 0x7800)
    # majcomp == 3: direct mode
    d0 = _stack(v0 << 8, v2 << 8, (v4 & 0x7F) << 9, h78)
    d1 = _stack(v1 << 8, v3 << 8, (v5 & 0x7F) << 9, h78)

    a = v0 | ((v1 & 0x40) << 2)
    b0 = v2 & 0x3F
    b1 = v3 & 0x3F
    c = v1 & 0x3F
    dq0 = v4 & 0x7F
    dq1 = v5 & 0x7F
    # 7, 6, 7, 6, 5, 6, 5, 6 by modeval
    dbits = torch.where(modeval < 4, 7 - (modeval & 1), 5 + (modeval & 1))
    bit0 = (v2 >> 6) & 1
    bit1 = (v3 >> 6) & 1
    bit2 = (v4 >> 6) & 1
    bit3 = (v5 >> 6) & 1
    bit4 = (v4 >> 5) & 1
    bit5 = (v5 >> 5) & 1
    oh = torch.ones_like(modeval) << modeval

    def put(x, mask, bit, sh):
        return x | torch.where(_on(oh, mask), bit << sh, 0)

    for mask, bit, sh in ((0xA4, bit0, 9), (0x8, bit2, 9), (0x50, bit4, 9),
                          (0x50, bit5, 10), (0xA0, bit1, 10),
                          (0xC0, bit2, 11)):
        a = put(a, mask, bit, sh)
    c = put(put(put(c, 0x4, bit1, 6), 0xE8, bit3, 6), 0x20, bit2, 7)
    b0 = put(put(b0, 0x5B, bit0, 6), 0x12, bit2, 7)
    b1 = put(put(b1, 0x5B, bit1, 6), 0x12, bit3, 7)
    dq0 = put(put(dq0, 0xAF, bit4, 5), 0x5, bit2, 6)
    dq1 = put(put(dq1, 0xAF, bit5, 5), 0x5, bit3, 6)

    # sign-extend d0/d1 from dbits
    sx = 32 - dbits
    dq0 = (dq0 << sx) >> sx
    dq1 = (dq1 << sx) >> sx

    sh = (modeval >> 1) ^ 3
    a, b0, b1, c, dq0, dq1 = (x << sh for x in (a, b0, b1, c, dq0, dq1))
    red1 = a
    green1 = a - b0
    blue1 = a - b1
    red0 = a - c
    green0 = a - b0 - c - dq0
    blue0 = a - b1 - c - dq1
    red0, green0, blue0, red1, green1, blue1 = (
        torch.clamp(x, 0, 4095)
        for x in (red0, green0, blue0, red1, green1, blue1))

    def swz(r, g, b):
        return (torch.where(majcomp == 1, g, torch.where(majcomp == 2, b, r)),
                torch.where(majcomp == 1, r, g),
                torch.where(majcomp == 2, r, b))

    r0, g0, bl0 = swz(red0, green0, blue0)
    r1, g1, bl1 = swz(red1, green1, blue1)
    e0 = _stack(r0 << 4, g0 << 4, bl0 << 4, h78)
    e1 = _stack(r1 << 4, g1 << 4, bl1 << 4, h78)
    direct = (majcomp == 3)[..., None]
    return torch.where(direct, d0, e0), torch.where(direct, d1, e1)


def _hdr_alpha_unpack(v6, v7):
    """HDR alpha of FMT_HDR_RGBA (reference :776-820)."""
    modeval = ((v6 >> 7) & 1) | ((v7 >> 6) & 2)
    v6m = v6 & 0x7F
    v7m = v7 & 0x7F
    d0 = v6m << 5
    d1 = v7m << 5
    one = torch.ones_like(modeval)
    v6b = v6m | ((v7m << (modeval + 1)) & 0x780)
    half = (one << 5) >> modeval                    # 32 >> modeval
    v7b = v7m & ((one * 0x3F) >> modeval)
    v7b = (v7b ^ half) - half
    v6b = v6b << (4 - modeval)
    v7b = v7b << (4 - modeval)
    v7b = torch.clamp(v6b + v7b, 0, 0xFFF)
    out0 = torch.where(modeval == 3, d0, v6b)
    out1 = torch.where(modeval == 3, d1, v7b)
    return out0 << 4, out1 << 4


def unpack_color_endpoints(profile: int, fmt: torch.Tensor,
                           values: torch.Tensor):
    """Unpack a batch of colour endpoints.

    Args:
      profile: PRF_LDR_SRGB, PRF_LDR, PRF_HDR_RGB_LDR_A or PRF_HDR.
      fmt: (...,) int32 endpoint format per element.
      values: (..., 8) int32 packed colour values (0..255).

    Returns (ep0, ep1, rgb_hdr, alpha_hdr): (..., 4) int32 endpoints in
    UNORM16 or LNS space, and (...,) bool flags of the elements whose RGB
    and alpha are LNS (always False in the LDR profiles).
    """
    v = [values[..., i] for i in range(8)]
    zero = torch.zeros_like(v[0])
    n255 = zero + 255
    o0 = {}
    o1 = {}
    o0[0] = _stack(v[0], v[0], v[0], n255)
    o1[0] = _stack(v[1], v[1], v[1], n255)

    l0 = (v[0] >> 2) | (v[1] & 0xC0)
    l1 = torch.clamp(l0 + (v[1] & 0x3F), max=255)
    o0[1] = _stack(l0, l0, l0, n255)
    o1[1] = _stack(l1, l1, l1, n255)

    o0[4] = _stack(v[0], v[0], v[0], v[2])
    o1[4] = _stack(v[1], v[1], v[1], v[3])

    lum0 = (v[0] | ((v[1] & 0x80) << 1)) >> 1
    alp0 = (v[2] | ((v[3] & 0x80) << 1)) >> 1
    lum1 = v[1] & 0x7F
    alp1 = v[3] & 0x7F
    lum1 = torch.where((lum1 & 0x40) != 0, lum1 - 0x80, lum1) >> 1
    alp1 = torch.where((alp1 & 0x40) != 0, alp1 - 0x80, alp1) >> 1
    lum1 = (lum1 + lum0).clamp(0, 255)
    alp1 = (alp1 + alp0).clamp(0, 255)
    o0[5] = _stack(lum0, lum0, lum0, alp0)
    o1[5] = _stack(lum1, lum1, lum1, alp1)

    o0[6] = _stack((v[0] * v[3]) >> 8, (v[1] * v[3]) >> 8,
                   (v[2] * v[3]) >> 8, n255)
    o1[6] = _stack(v[0], v[1], v[2], n255)

    rgb0 = _stack(v[0], v[2], v[4], zero)
    rgb1 = _stack(v[1], v[3], v[5], zero)
    e0, e1 = _rgba_unpack(rgb0, rgb1)
    o0[8] = torch.cat([e0[..., :3], n255[..., None]], -1)
    o1[8] = torch.cat([e1[..., :3], n255[..., None]], -1)
    e0, e1 = _rgba_delta_unpack(rgb0, rgb1)
    o0[9] = torch.cat([e0[..., :3], n255[..., None]], -1)
    o1[9] = torch.cat([e1[..., :3], n255[..., None]], -1)

    o0[10] = _stack((v[0] * v[3]) >> 8, (v[1] * v[3]) >> 8,
                    (v[2] * v[3]) >> 8, v[4])
    o1[10] = _stack(v[0], v[1], v[2], v[5])

    rgba0 = _stack(v[0], v[2], v[4], v[6])
    rgba1 = _stack(v[1], v[3], v[5], v[7])
    o0[12], o1[12] = _rgba_unpack(rgba0, rgba1)
    o0[13], o1[13] = _rgba_delta_unpack(rgba0, rgba1)

    # HDR formats decode as the error colour in LDR profiles.
    err = _stack(n255, zero, n255, n255)
    ep0 = err
    ep1 = err
    f = fmt[..., None]
    for k in _LDR_FORMATS:
        ep0 = torch.where(f == k, o0[k], ep0)
        ep1 = torch.where(f == k, o1[k], ep1)
    no = torch.zeros_like(fmt, dtype=torch.bool)
    if profile == PRF_LDR:
        return ep0 * 257, ep1 * 257, no, no
    if profile == PRF_LDR_SRGB:
        return (ep0 << 8) | 0x80, (ep1 << 8) | 0x80, no, no

    h78 = zero + 0x7800
    y0a, y1a = v[0] << 4, v[1] << 4
    y0b, y1b = (v[1] << 4) + 8, (v[0] << 4) - 8
    ge = v[1] >= v[0]
    y0 = torch.where(ge, y0a, y0b)
    y1 = torch.where(ge, y1a, y1b)
    o0[2] = _stack(y0 << 4, y0 << 4, y0 << 4, h78)
    o1[2] = _stack(y1 << 4, y1 << 4, y1 << 4, h78)
    hi_mode = (v[0] & 0x80) != 0
    y0 = torch.where(hi_mode, ((v[1] & 0xE0) << 4) | ((v[0] & 0x7F) << 2),
                     ((v[1] & 0xF0) << 4) | ((v[0] & 0x7F) << 1))
    y1 = torch.where(hi_mode, (v[1] & 0x1F) << 2, (v[1] & 0xF) << 1)
    y1 = torch.clamp(y1 + y0, max=0xFFF)
    o0[3] = _stack(y0 << 4, y0 << 4, y0 << 4, h78)
    o1[3] = _stack(y1 << 4, y1 << 4, y1 << 4, h78)
    o0[7], o1[7] = _hdr_rgbo_unpack(values)
    e0, e1 = _hdr_rgb_unpack(values)
    o0[11], o1[11] = e0, e1
    o0[14] = torch.cat([e0[..., :3], v[6][..., None]], -1)
    o1[14] = torch.cat([e1[..., :3], v[7][..., None]], -1)
    a0, a1 = _hdr_alpha_unpack(v[6], v[7])
    o0[15] = torch.cat([e0[..., :3], a0[..., None]], -1)
    o1[15] = torch.cat([e1[..., :3], a1[..., None]], -1)
    for k in HDR_FORMATS:
        ep0 = torch.where(f == k, o0[k], ep0)
        ep1 = torch.where(f == k, o1[k], ep1)

    rgb_hdr = is_format(fmt, HDR_FORMATS)
    alpha_default = is_format(fmt, _ALPHA_DEFAULT_FORMATS)
    alpha_hdr = fmt == FMT_HDR_RGBA
    if profile == PRF_HDR:
        alpha_hdr = alpha_hdr | alpha_default
        defa = 0x7800
    else:
        defa = 0x00FF
    ep0 = torch.cat([ep0[..., :3], torch.where(alpha_default, defa,
                                               ep0[..., 3])[..., None]], -1)
    ep1 = torch.cat([ep1[..., :3], torch.where(alpha_default, defa,
                                               ep1[..., 3])[..., None]], -1)
    lanes = torch.stack([rgb_hdr, rgb_hdr, rgb_hdr, alpha_hdr], -1)
    scale = torch.where(lanes, 1, 257).to(ep0.dtype)
    return ep0 * scale, ep1 * scale, rgb_hdr, alpha_hdr
