# Frozen copy of astcenc_torch/ops/softfloat.py, kept
# with the benchmark's reference decoder (2D blocks) so that the
# yardstick does not move with the program.
"""Exact integer <-> fp16 / LNS conversions of the codec.

Port of ``astcenc_tpu/ops/softfloat.py`` (reference
astcenc_vecmathlib.h:495-620): ASTC decodes to UNORM16 (LDR) or 16-bit LNS
(HDR) integers, converts those to fp16 bit patterns, and only then widens
to fp32, so the conversions are integer ops.
"""

from __future__ import annotations

import torch


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
