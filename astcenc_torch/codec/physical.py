"""Batched symbolic -> physical 128-bit block packing.

Port of ``astcenc_tpu/codec/physical.py`` (symbolic_to_physical_batch,
:156-323). Each block is four 32-bit words; every written field is an
(offset, value, width) triple whose contribution to the two words it
straddles is a shift, and because the fields of a valid ASTC layout are
bit-disjoint, the per-word OR is a sum. The word arithmetic runs in int64
with explicit 32-bit masks (torch's uint32 support is partial).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables import ise, quant
from .decompress import (C_QUINT_PAD, C_SLOTS, C_TRIT_PAD, W_QUINT_PAD,
                         W_SLOTS, W_TRIT_PAD)

_M32 = 0xFFFFFFFF
_LEVELS_M1 = np.array([1, 2, 3, 4, 5, 7, 9, 11, 15, 19, 23, 31], np.float32)


@functools.cache
def _host_tables():
    scram = np.zeros((12, 32), np.int64)
    for q in range(12):
        s = quant.weight_quant_tables(q)["scramble"]
        scram[q, :len(s)] = s
    cpack = np.zeros((17, 256), np.int64)
    for q in range(ise.QUANT_6, 21):
        cpack[q - ise.QUANT_6] = quant.color_quant_tables(q)[
            "uquant_to_scrambled_pquant"]
    _, tenc = ise.trit_tables()
    _, qenc = ise.quint_tables()
    return (scram, cpack, tenc.reshape(-1).astype(np.int64),
            qenc.reshape(-1).astype(np.int64))


_dev_cache: dict = {}


def _tables(device):
    key = str(device)
    if key not in _dev_cache:
        _dev_cache[key] = tuple(torch.from_numpy(a).to(device)
                                for a in _host_tables())
    return _dev_cache[key]


def _field_words(offsets, values, widths, valid):
    """(N, S) bit fields -> (N, 4) int64 words holding 32-bit values."""
    widths = widths.to(torch.int64)
    offsets = offsets.to(torch.int64)
    mask = (torch.ones_like(widths) << widths.clamp(max=32)) - 1
    ok = valid & (offsets >= 0) & (offsets + widths <= 128) & (widths > 0)
    v = torch.where(ok, values.to(torch.int64), 0) & mask & _M32
    o = offsets.clamp(0, 127)
    widx = o >> 5
    sh = o & 31
    lo = (v << sh) & _M32
    hi = v >> (32 - sh)                     # bits past the first word
    words = []
    for k in range(4):
        acc = (torch.where(widx == k, lo, 0).sum(1)
               + torch.where(widx == k - 1, hi, 0).sum(1))
        words.append(acc & _M32)
    return torch.stack(words, dim=1)


def _bitrev32(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & _M32


def _rev128(words):
    """Reverse the bit order of an (N, 4)-word 128-bit value."""
    return _bitrev32(torch.flip(words, dims=[1]))


def _ise_fields(symbols, nvals, bits, tclass, m_off, t_off, t_bits, t_shift,
                base_off, trit_pad, quint_pad, tenc, qenc):
    """BISE stream -> (offsets, values, widths, valid) field arrays."""
    N, S = symbols.shape
    slot = torch.arange(S, device=symbols.device)[None, :]
    valid = slot < nvals[:, None]
    m = symbols & ((1 << bits) - 1)
    hi = torch.where(valid, symbols >> bits, 0)

    hi5 = torch.nn.functional.pad(hi, (0, trit_pad - S)).reshape(
        N, trit_pad // 5, 5)
    tidx = (hi5[..., 4] * 81 + hi5[..., 3] * 27 + hi5[..., 2] * 9
            + hi5[..., 1] * 3 + hi5[..., 0]).clamp(0, 242)
    T5 = tenc[tidx.to(torch.int64)].repeat_interleave(5, dim=1)[:, :S]
    hi3 = torch.nn.functional.pad(hi, (0, quint_pad - S)).reshape(
        N, quint_pad // 3, 3)
    qidx = (hi3[..., 2] * 25 + hi3[..., 1] * 5 + hi3[..., 0]).clamp(0, 124)
    T3 = qenc[qidx.to(torch.int64)].repeat_interleave(3, dim=1)[:, :S]

    tcode = torch.where((tclass == 1)[:, None], T5,
                        torch.where((tclass == 2)[:, None], T3, 0))
    tval = (tcode >> t_shift) & ((1 << t_bits) - 1)

    offs = torch.cat([base_off + m_off, base_off + t_off], 1)
    vals = torch.cat([m.to(torch.int64), tval.to(torch.int64)], 1)
    wids = torch.cat([bits.expand_as(m), t_bits], 1)
    vld = torch.cat([valid, valid & (tclass != 0)[:, None]], 1)
    return offs, vals, wids, vld


def symbolic_to_physical_batch(t, scb) -> torch.Tensor:
    """Pack a batch of symbolic blocks to (N, 16) uint8 physical blocks.

    t: decode tables as device tensors; scb: dict of symbolic block
    tensors (see ``codec.trial.empty_scb``), optionally with the
    constant-colour fields ``const_u16``, ``const_f16``, ``constant_color``.
    """
    dev = scb["block_mode"].device
    scram, cpack, tenc, qenc = _tables(dev)
    i64 = torch.int64
    block_mode = scb["block_mode"]
    N = block_mode.shape[0]
    pc = scb["partition_count"]
    pk = t.block_mode_packed_index[block_mode.clamp(0, 2047).to(i64)]
    pk = pk.clamp(0, t.bm_quant.shape[0] - 1).to(i64)

    wq = t.bm_quant[pk]
    dual = t.bm_dual[pk]
    wbits_total = t.bm_weight_bits[pk]
    w_count = t.w_count[pk]
    w_bits = t.w_bits[pk][:, None]
    w_class = t.w_class[pk]

    # --- Weight stream --------------------------------------------------------
    lm1 = torch.from_numpy(_LEVELS_M1).to(dev)[wq.to(i64)][:, None]
    qw1 = torch.floor(scb["weights"].float() / 64.0 * lm1 + 0.5).to(i64)
    qw2 = torch.floor(scb["weights2"].float() / 64.0 * lm1 + 0.5).to(i64)
    srow = scram[wq.to(i64)]                                  # (N, 32)
    s1 = torch.gather(srow, 1, qw1.clamp(0, 31))
    s2 = torch.gather(srow, 1, qw2.clamp(0, 31))
    inter = torch.zeros((N, W_SLOTS), dtype=i64, device=dev)
    inter[:, 0::2] = s1[:, :32]
    inter[:, 1::2] = s2[:, :32]
    symbols = torch.where((dual == 1)[:, None], inter, s1)

    wf = _ise_fields(symbols, w_count, w_bits, w_class, t.w_m_off[pk],
                     t.w_t_off[pk], t.w_t_bits[pk], t.w_t_shift[pk],
                     torch.zeros((N, 1), dtype=torch.int32, device=dev),
                     W_TRIT_PAD, W_QUINT_PAD, tenc, qenc)
    # Weights fill from bit 127 downward: build forward, bit-reverse.
    words = _rev128(_field_words(*wf))

    # --- Header ---------------------------------------------------------------
    fmt = scb["color_formats"]
    matched = scb["color_formats_matched"]
    is_multi = pc > 1
    lanes = torch.arange(4, dtype=torch.int32, device=dev)[None, :]
    in_use = lanes < pc[:, None]
    classes = torch.where(in_use, fmt >> 2, 4)
    low_class = classes.min(1).values
    low_class = torch.where(low_class == 3, 2, low_class)
    classbit = torch.where(in_use, (fmt >> 2) - low_class[:, None], 0)
    lowbits = torch.where(in_use, fmt & 3, 0)
    encoded_type_u = (low_class + 1
                      + (classbit << (2 + lanes)).sum(1, dtype=torch.int32)
                      + (lowbits << (2 + pc[:, None] + 2 * lanes)).sum(
                          1, dtype=torch.int32))
    encoded_type = torch.where(matched, fmt[:, 0] << 2, encoded_type_u)
    ehs = torch.where(matched | ~is_multi, 0, 3 * pc - 4)
    below_weights = 128 - wbits_total - ehs

    ones = torch.ones((N,), dtype=torch.bool, device=dev)

    def c(v):
        return torch.full((N,), v, dtype=torch.int32, device=dev)

    hdr = [
        (c(0), block_mode, c(11), ones),
        (c(11), pc - 1, c(2), ones),
        (c(13), fmt[:, 0], c(4), ~is_multi),
        (c(13), scb["partition_index"], c(10), is_multi),
        (c(23), encoded_type & 0x3F, c(6), is_multi),
        (below_weights, encoded_type >> 6, ehs, is_multi & (ehs > 0)),
        (below_weights - 2, scb["plane2_component"].clamp(0, 3), c(2),
         dual == 1),
    ]
    h = [torch.stack([x[i] for x in hdr], 1) for i in range(4)]

    # --- Colour values --------------------------------------------------------
    nvals_p = torch.where(in_use, ((fmt >> 2) + 1) * 2, 0)
    starts = torch.cat([torch.zeros((N, 1), dtype=torch.int32, device=dev),
                        torch.cumsum(nvals_p, 1, dtype=torch.int32)[:, :3]],
                       1)
    icount = nvals_p.sum(1, dtype=torch.int32)
    cq = scb["quant_mode"].clamp(4, 20)
    prow = cpack[(cq - 4).to(i64)]                            # (N, 256)
    csym = torch.gather(prow, 1, scb["color_values"].clamp(0, 255)
                        .reshape(N, 32).to(i64)).reshape(N, 4, 8)
    j8 = torch.arange(8, device=dev)[None, None, :]
    sidx = (starts[:, :, None] + j8).clamp(0, C_SLOTS - 1)
    sval = torch.where(j8 < nvals_p[:, :, None], csym, 0)
    # Distinct in-use slots never collide; unused slots add zero.
    flat = torch.zeros((N, C_SLOTS), dtype=i64, device=dev).scatter_add_(
        1, sidx.reshape(N, 32).to(i64), sval.reshape(N, 32))

    combo = ((cq - 4) * 9 + ((icount >> 1) - 1)).clamp(0, 152).to(i64)
    base = torch.where(is_multi, 29, 17)[:, None].to(torch.int32)
    cf = _ise_fields(flat, icount, t.c_bits[combo][:, None], t.c_class[combo],
                     t.c_m_off[combo], t.c_t_off[combo], t.c_t_bits[combo],
                     t.c_t_shift[combo], base, C_TRIT_PAD, C_QUINT_PAD,
                     tenc, qenc)
    words = words + _field_words(*(torch.cat([h[i].to(cf[i].dtype), cf[i]], 1)
                                   for i in range(4)))

    # --- Byte split + constant-colour overrides -------------------------------
    sh8 = (torch.arange(4, device=dev) * 8)[None, None, :]
    pcb = ((words[:, :, None] >> sh8) & 0xFF).reshape(N, 16).to(torch.uint8)
    if "const_u16" in scb:
        const_u16 = scb["const_u16"]
        const_f16 = scb["const_f16"]
        ccol = scb["constant_color"]
        head_u16 = torch.tensor([0xFC, 0xFD] + [0xFF] * 6, dtype=torch.uint8,
                                device=dev)
        head_f16 = torch.tensor([0xFC] + [0xFF] * 7, dtype=torch.uint8,
                                device=dev)
        cc = torch.stack([ccol & 0xFF, (ccol >> 8) & 0xFF], -1).reshape(N, 8)
        head = torch.where(const_f16[:, None], head_f16, head_u16)
        cblock = torch.cat([head, cc.to(torch.uint8)], 1)
        pcb = torch.where((const_u16 | const_f16)[:, None], cblock, pcb)
    return pcb
