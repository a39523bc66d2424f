"""Exact integer <-> fp16 / LNS conversions of the codec.

Port of ``astcenc_tpu/ops/softfloat.py`` (reference
astcenc_vecmathlib.h:495-620): ASTC decodes to UNORM16 (LDR) or 16-bit LNS
(HDR) integers, converts those to fp16 bit patterns, and only then widens
to fp32, so the conversions are integer ops. ``float_to_lns`` is the
encoder's HDR texel load. ``div`` (the float32 quotient by a constant),
``sum3``/``sum4`` (channel sums in a fixed order) and ``sqrt`` (the
correctly rounded float32 root) give the same bits on every device.
"""

from __future__ import annotations

import torch


def div(x, d: float):
    """x / d, the float32 quotient on every device. On CUDA tensors PyTorch
    multiplies by the reciprocal when the divisor is a Python or CPU
    scalar, which can miss the quotient by one bit; a divisor on the
    tensor's own device divides, as the CPU, the JAX package and the colour
    pack kernel do. (Powers of two need no such care.)"""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def sum3(v):
    """(v0 + v1) + v2 over the last axis, in that order on every device
    (a reduction such as ``.sum(-1)`` may add in another order on the
    card; this is the CPU's order)."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def sum4(v):
    """((v0 + v1) + v2) + v3 over the last axis, the CPU's ``.sum(-1)`` of
    four channels, in that order on every device."""
    return ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]


def sqrt(x):
    """The correctly rounded float32 square root on every device (the
    card's; the CPU's float32 ``torch.sqrt`` misses it by one bit in a few
    values in a thousand). The root of the float64 value, rounded to
    float32, is the correctly rounded float32 root."""
    return torch.sqrt(x.double()).float()


def _bit_length(p: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int32 values below 2^24 (0 for 0)."""
    _, e = torch.frexp(p.to(torch.float32))
    return e.to(torch.int32)


def unorm16_to_sf16(p: torch.Tensor) -> torch.Tensor:
    """UNORM16 [0, 65535] -> fp16 bits in [0, 1] (reference
    astcenc_vecmathlib.h:503-533)."""
    p = p.to(torch.int32)
    lz = 16 - _bit_length(p)                 # clz32(p) - 16
    sh = torch.clamp(lz + 1, 0, 31)
    pn = (p << sh) & 0xFFFF
    pn = (pn >> 6) | ((14 - lz) << 10)
    r = torch.where(p == 0xFFFF, torch.full_like(p, 0x3C00), pn)
    return torch.where(p < 4, p << 8, r)


def lns_to_sf16(p: torch.Tensor) -> torch.Tensor:
    """16-bit LNS -> fp16 bits (reference astcenc_vecmathlib.h:537-556)."""
    p = p.to(torch.int32)
    mc = p & 0x7FF
    ec = p >> 11
    mt = torch.where(mc < 512, mc * 3,
                     torch.where(mc < 1536, mc * 4 - 512, mc * 5 - 2048))
    return torch.clamp((ec << 10) | (mt >> 3), max=0x7BFF)


def float16_to_float(bits: torch.Tensor) -> torch.Tensor:
    """fp16 bit pattern (int) -> fp32 value, IEEE-exact."""
    b = bits.to(torch.int32) & 0xFFFF
    b = ((b + 0x8000) & 0xFFFF) - 0x8000      # wrap into int16 range
    return b.to(torch.int16).view(torch.float16).to(torch.float32)


def float_to_float16(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> fp16 bit pattern (int32 in [0, 65535]), round to nearest
    even."""
    return x.to(torch.float32).to(torch.float16).view(torch.int16).to(
        torch.int32) & 0xFFFF


def float_to_lns(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> 16-bit LNS code as float (reference
    astcenc_vecmathlib.h:582-620): NaN, negatives and values below 2^-26
    give 0, values from 65536 up (and +Inf) give 65535."""
    a = a.to(torch.float32)
    bits = a.view(torch.int32)
    exp = ((bits >> 23) & 0xFF) - 126
    # sign and mantissa with the exponent of 0.5: a value in [0.5, 1)
    mant = ((bits & 0x007FFFFF) | (bits & -0x80000000) | 0x3F000000).view(
        torch.float32)
    underflow_nan = ~(a > (1.0 / 67108864.0))
    infinity = a >= 65536.0
    small = exp < -13
    av = torch.where(small, a * 33554432.0, (mant - 0.5) * 4096.0)
    expv = torch.where(small, 0, exp + 14)
    a2 = torch.where(av < 384.0, av * (4.0 / 3.0),
                     torch.where(av <= 1408.0, av + 128.0,
                                 (av + 512.0) * (4.0 / 5.0)))
    out = a2 + expv.to(torch.float32) * 2048.0 + 1.0
    out = torch.where(infinity, 65535.0, out)
    return torch.where(underflow_nan, 0.0, out)
