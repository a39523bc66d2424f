"""Decoder-side colour endpoint reconstruction, LDR profiles.

Port of ``astcenc_tpu/ops/color_unquant.py`` for PRF_LDR and PRF_LDR_SRGB:
every LDR endpoint format decodes on the whole batch and the right one is
selected per element; HDR formats decode as the error colour, as the
reference does in LDR profiles (astcenc_color_unquantize.cpp:844-1023).
"""

from __future__ import annotations

import torch

PRF_LDR_SRGB = 0
PRF_LDR = 1

FMT_LUMINANCE = 0
FMT_LUMINANCE_DELTA = 1
FMT_LUMINANCE_ALPHA = 4
FMT_LUMINANCE_ALPHA_DELTA = 5
FMT_RGB_SCALE = 6
FMT_RGB = 8
FMT_RGB_DELTA = 9
FMT_RGB_SCALE_ALPHA = 10
FMT_RGBA = 12
FMT_RGBA_DELTA = 13

_LDR_FORMATS = (0, 1, 4, 5, 6, 8, 9, 10, 12, 13)


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


def unpack_color_endpoints(profile: int, fmt: torch.Tensor,
                           values: torch.Tensor):
    """Unpack a batch of colour endpoints.

    Args:
      profile: PRF_LDR or PRF_LDR_SRGB.
      fmt: (...,) int32 endpoint format per element.
      values: (..., 8) int32 packed colour values (0..255).

    Returns (ep0, ep1): (..., 4) int32 endpoints in UNORM16 space.
    """
    if profile not in (PRF_LDR, PRF_LDR_SRGB):
        raise NotImplementedError("HDR profiles are not ported yet")
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
    if profile == PRF_LDR:
        return ep0 * 257, ep1 * 257
    return (ep0 << 8) | 0x80, (ep1 << 8) | 0x80
