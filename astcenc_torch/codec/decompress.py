"""Batched physical-block decoding, LDR and HDR profiles.

Port of ``astcenc_tpu/codec/decompress.py`` (decompress_symbolic_batch,
:79-295): every block of an (N, 16)-byte batch flows through the same
gather/ALU pipeline, and invalid, constant-colour (void-extent, UNORM16 or
FP16) and error blocks resolve by masks at the end. HDR lanes decode from
LNS codes through fp16. Bit-exact against the JAX decoder.
"""

from __future__ import annotations

import torch

from . import decode_tables as _dt
from ..ops import color_unquant as cuq
from ..ops import softfloat as sf

W_SLOTS = _dt.W_SLOTS
W_TRIT_PAD = _dt.W_TRIT_PAD
W_QUINT_PAD = _dt.W_QUINT_PAD
C_SLOTS = _dt.C_SLOTS
C_TRIT_PAD = _dt.C_TRIT_PAD
C_QUINT_PAD = _dt.C_QUINT_PAD

# 0xFFFFE000 as an int32 bit pattern: the NaN error colour.
_ERROR_NAN_BITS = -0x2000


def error_nan(device) -> torch.Tensor:
    return torch.tensor(_ERROR_NAN_BITS, dtype=torch.int32,
                        device=device).view(torch.float32)


def _i64(x):
    return x.to(torch.int64)


def _bitplane(pcb):
    """(N, 16) uint8 -> (N, 128) int32 bits, LSB-first per byte."""
    sh = torch.arange(8, dtype=torch.int32, device=pcb.device)
    bits = (pcb.to(torch.int32)[:, :, None] >> sh) & 1
    return bits.reshape(pcb.shape[0], 128)


def _read_static(bp, off: int, n: int):
    sh = torch.arange(n, dtype=torch.int32, device=bp.device)
    return (bp[:, off:off + n] << sh).sum(1, dtype=torch.int32)


def _read_dyn(bp, off, nmax: int, nbits):
    """Read an up-to-nmax-bit field at a per-block offset."""
    ar = torch.arange(nmax, dtype=torch.int32, device=bp.device)
    idx = torch.clamp(off[:, None] + ar, 0, 127)
    g = torch.gather(bp, 1, _i64(idx))
    nb = nbits if torch.is_tensor(nbits) else torch.full_like(off, nbits)
    return torch.where(ar < nb[:, None], g << ar, 0).sum(1, dtype=torch.int32)


def _extract_fields(bp, offsets, nmax: int, nbits):
    """Per-slot bit fields: offsets (N, S), nbits (N, S) -> (N, S)."""
    N, S = offsets.shape
    ar = torch.arange(nmax, dtype=torch.int32, device=bp.device)
    idx = torch.clamp(offsets[..., None] + ar, 0, 127).reshape(N, S * nmax)
    g = torch.gather(bp, 1, _i64(idx)).reshape(N, S, nmax)
    return torch.where(ar < nbits[..., None], g << ar, 0).sum(
        2, dtype=torch.int32)


def _group_codes(tvals, shifts, group: int, pad: int):
    """Combine per-value trit/quint field bits into per-group codes."""
    N, S = tvals.shape
    contrib = torch.nn.functional.pad(tvals << shifts, (0, pad - S))
    return contrib.reshape(N, pad // group, group).sum(2, dtype=torch.int32)


def _lookup(tab, idx):
    """tab[idx] with the index clamped into range (gather semantics of
    the JAX reference)."""
    return tab[_i64(torch.clamp(idx, 0, tab.shape[0] - 1))]


def block_types(t, pcb: torch.Tensor):
    """Kind of each physical block, read from its header: (constant (N,)
    bool, partition count (N,) int32, weight planes (N,) int32). Constant
    blocks report 1 partition and 1 plane."""
    bp = _bitplane(pcb)
    block_mode = _read_static(bp, 0, 11)
    const = (block_mode & 0x1FF) == 0x1FC
    dual = _lookup(t.bm_dual, _lookup(t.block_mode_packed_index, block_mode))
    pc = torch.where(const, 1, _read_static(bp, 11, 2) + 1)
    planes = torch.where(const | (dual != 1), 1, 2).to(torch.int32)
    return const, pc, planes


def _formats(bp, wb, pc):
    """Endpoint format of each partition (N, 4), 0 past the partition
    count, from the header bits bp, weight bits wb and partition count
    pc; with the matched-format flag and the position and size of the
    extra format bits below the weights."""
    N = bp.shape[0]
    ehs = torch.where(pc > 1, 3 * pc - 4, 0)
    below = 128 - wb - ehs
    encoded_type = _read_static(bp, 23, 6) | (_read_dyn(bp, below, 8, ehs)
                                             << 6)
    baseclass = encoded_type & 0x3
    matched = (baseclass == 0) & (pc > 1)
    lanes = torch.arange(4, dtype=torch.int32, device=bp.device)[None, :]
    fmt_matched = ((encoded_type >> 2) & 0xF)[:, None].expand(N, 4)
    bclass = torch.clamp(baseclass - 1, min=0)
    fmt_un = ((((encoded_type[:, None] >> (2 + lanes)) & 1)
               + bclass[:, None]) << 2)
    fmt_un = fmt_un | ((encoded_type[:, None]
                        >> (2 + pc[:, None] + 2 * lanes)) & 3)
    fmt_multi = torch.where(matched[:, None], fmt_matched, fmt_un)
    fmt_single = _read_static(bp, 13, 4)[:, None].expand(N, 4)
    fmt = torch.where((pc == 1)[:, None], fmt_single, fmt_multi)
    return torch.where(lanes < pc[:, None], fmt, 0), matched, below, ehs


def endpoint_formats(t, pcb: torch.Tensor) -> torch.Tensor:
    """Endpoint format of each partition of each physical block, (N, 4)
    int32, -1 past the partition count and for constant blocks."""
    bp = _bitplane(pcb)
    block_mode = _read_static(bp, 0, 11)
    const = (block_mode & 0x1FF) == 0x1FC
    wb = _lookup(t.bm_weight_bits, _lookup(t.block_mode_packed_index,
                                           block_mode))
    pc = _read_static(bp, 11, 2) + 1
    fmt, _, _, _ = _formats(bp, wb, pc)
    lanes = torch.arange(4, device=pcb.device)[None, :]
    return torch.where(const[:, None] | (lanes >= pc[:, None]), -1, fmt)


def decompress_symbolic_batch(t, pcb: torch.Tensor, profile: int,
                              decode_unorm8: bool) -> torch.Tensor:
    """Decode a batch of physical ASTC blocks to texel colours.

    Args:
      t: decode tables as device tensors (``_host.decode_tables_to_torch``).
      pcb: (N, 16) uint8 physical blocks.
      profile: PRF_LDR_SRGB, PRF_LDR, PRF_HDR_RGB_LDR_A or PRF_HDR.
      decode_unorm8: round the decode through unorm8.

    Returns (N, T, 4) float32 texel colours (NaN error colour for invalid
    blocks).
    """
    dev = pcb.device
    N = pcb.shape[0]
    T = t.texel_count
    is_3d = t.dim[2] > 1
    i32 = torch.int32

    bp = _bitplane(pcb)
    bp_rev = torch.flip(bp, dims=[1])
    block_mode = _read_static(bp, 0, 11)

    # ---- Constant colour blocks (void extent) ----------------------------
    is_const = (block_mode & 0x1FF) == 0x1FC
    const_f16 = (block_mode & 0x200) != 0
    p = pcb.to(i32)
    ccol = torch.stack([p[:, 8 + 2 * i] | (p[:, 9 + 2 * i] << 8)
                        for i in range(4)], dim=-1)
    if not is_3d:
        rsv = _read_static(bp, 10, 2)
        vx = [_read_static(bp, 12 + 13 * i, 13) for i in range(4)]
        all_ones = ((vx[0] == 0x1FFF) & (vx[1] == 0x1FFF)
                    & (vx[2] == 0x1FFF) & (vx[3] == 0x1FFF))
        const_err = (rsv != 3) | (((vx[0] >= vx[1]) | (vx[2] >= vx[3]))
                                  & ~all_ones)
    else:
        vx = [_read_static(bp, 10 + 9 * i, 9) for i in range(6)]
        all_ones = vx[0] == 0x1FF
        for v in vx[1:]:
            all_ones = all_ones & (v == 0x1FF)
        const_err = (((vx[0] >= vx[1]) | (vx[2] >= vx[3]) | (vx[4] >= vx[5]))
                     & ~all_ones)

    # ---- Non-constant header decode --------------------------------------
    pidx = _lookup(t.block_mode_packed_index, block_mode)
    bad_mode = pidx == 0xFFFF
    pidx_c = torch.clamp(pidx, 0, t.bm_quant.shape[0] - 1)
    pk = _i64(pidx_c)
    wq = t.bm_quant[pk]
    dual = t.bm_dual[pk]
    wb = t.bm_weight_bits[pk]
    dm = t.bm_decimation_mode[pk]

    pc = _read_static(bp, 11, 2) + 1
    partition_index = torch.where(pc > 1, _read_static(bp, 13, 10), 0)

    # ---- Weight stream decode --------------------------------------------
    w_bits = t.w_bits[pk][:, None]
    w_class = t.w_class[pk]
    w_m_off = t.w_m_off[pk]
    w_t_off = t.w_t_off[pk]
    m_vals = _extract_fields(bp_rev, w_m_off, 6, w_bits.expand_as(w_m_off))
    tq_vals = _extract_fields(bp_rev, w_t_off, 3, t.w_t_bits[pk])
    w_t_shift = t.w_t_shift[pk]
    T_trit = _group_codes(tq_vals, w_t_shift, 5, W_TRIT_PAD)
    T_quint = _group_codes(tq_vals, w_t_shift, 3, W_QUINT_PAD)
    hi_trit = _lookup(t.trits_of_integer, T_trit).reshape(
        N, W_TRIT_PAD)[:, :W_SLOTS]
    hi_quint = _lookup(t.quints_of_integer, T_quint).reshape(
        N, W_QUINT_PAD)[:, :W_SLOTS]
    hi = torch.where(w_class[:, None] == 1, hi_trit,
                     torch.where(w_class[:, None] == 2, hi_quint, 0))
    wsym = m_vals | (hi << w_bits)
    w64 = t.weight_unquant[_i64(wq)[:, None], _i64(wsym.clamp(0, 31))]

    # Dual-plane de-interleave (plane 2 lives in the odd slots)
    z32 = torch.zeros((N, 32), dtype=i32, device=dev)
    p1 = torch.where(dual[:, None] == 1, torch.cat([w64[:, 0::2], z32], 1),
                     w64)
    p2 = torch.cat([w64[:, 1::2], z32], 1)

    # ---- Undecimate weights (integer bilinear infill) ---------------------
    tw = _i64(t.dec_texel_weights[_i64(dm)]).reshape(N, 4 * T)
    con = t.dec_texel_contribs[_i64(dm)]                     # (N, 4, T)

    def infill(plane):
        g = torch.gather(plane, 1, tw).reshape(N, 4, T)
        return (8 + (g * con).sum(1, dtype=i32)) >> 4

    wt1 = infill(p1)
    wt2 = infill(p2)

    # ---- Colour endpoint mode decode --------------------------------------
    fmt, matched, below, ehs = _formats(bp, wb, pc)
    lanes = torch.arange(4, dtype=i32, device=dev)[None, :]
    below_final = torch.where(matched, below + ehs, below)
    ehs_final = torch.where(matched, 0, ehs)
    icount = torch.where(lanes < pc[:, None], ((fmt >> 2) + 1) * 2, 0).sum(
        1, dtype=i32)

    color_bits_arr = torch.tensor([0, 111, 99, 99, 99], dtype=i32,
                                  device=dev)
    color_bits = (color_bits_arr[_i64(pc)] - wb - ehs_final
                  - torch.where(dual == 1, 2, 0)).clamp(0, 127)
    cquant = t.quant_mode_table[_i64((icount >> 1).clamp(0, 9)),
                                _i64(color_bits)]
    plane2_component = torch.where(
        dual == 1, _read_dyn(bp, below_final - 2, 2, 2), -1)

    bad = (bad_mode | ((dual == 1) & (pc == 4)) | (icount > 18)
           | (cquant < 4))
    prow = torch.where(
        pc == 1, 0,
        t.partition_row_map[_i64((pc - 2).clamp(0, 2)),
                            _i64(partition_index)])
    bad = bad | (prow < 0)
    prow = torch.clamp(prow, min=0)

    # ---- Colour integer stream decode --------------------------------------
    combo = _i64(((cquant - 4) * 9 + ((icount >> 1) - 1)).clamp(0, 152))
    c_bits = t.c_bits[combo][:, None]
    c_class = t.c_class[combo]
    base_off = torch.where(pc == 1, 17, 29)[:, None]
    c_m_off = t.c_m_off[combo] + base_off
    c_t_off = t.c_t_off[combo] + base_off
    cm = _extract_fields(bp, c_m_off, 8, c_bits.expand_as(c_m_off))
    ctq = _extract_fields(bp, c_t_off, 3, t.c_t_bits[combo])
    c_t_shift = t.c_t_shift[combo]
    cT_trit = _group_codes(ctq, c_t_shift, 5, C_TRIT_PAD)
    cT_quint = _group_codes(ctq, c_t_shift, 3, C_QUINT_PAD)
    chi_t = _lookup(t.trits_of_integer, cT_trit).reshape(
        N, C_TRIT_PAD)[:, :C_SLOTS]
    chi_q = _lookup(t.quints_of_integer, cT_quint).reshape(
        N, C_QUINT_PAD)[:, :C_SLOTS]
    chi = torch.where(c_class[:, None] == 1, chi_t,
                      torch.where(c_class[:, None] == 2, chi_q, 0))
    csym = cm | (chi << c_bits)
    cvals = t.color_unquant[_i64((cquant - 4).clamp(0, 16))[:, None],
                            _i64(csym.clamp(0, 255))]

    nvals = torch.where(lanes < pc[:, None], ((fmt >> 2) + 1) * 2, 0)
    starts = torch.cat([torch.zeros((N, 1), dtype=i32, device=dev),
                        torch.cumsum(nvals, 1, dtype=i32)[:, :3]], 1)
    ar8 = torch.arange(8, dtype=i32, device=dev)
    vidx = (starts[:, :, None] + ar8).clamp(0, C_SLOTS - 1)
    color_values = torch.gather(cvals, 1, _i64(vidx.reshape(N, 32))
                                ).reshape(N, 4, 8)

    # ---- Endpoint unpack + texel assembly ----------------------------------
    ep0, ep1, rgb_hdr, alpha_hdr = cuq.unpack_color_endpoints(
        profile, fmt, color_values)
    pot = _i64(t.partition_of_texel_cat[_i64(prow)])           # (N, T)
    ep0_t = torch.gather(ep0, 1, pot[:, :, None].expand(N, T, 4))
    ep1_t = torch.gather(ep1, 1, pot[:, :, None].expand(N, T, 4))
    use_p2 = (torch.arange(4, device=dev)[None, None, :]
              == plane2_component[:, None, None])
    wtex = torch.where(use_p2, wt2[:, :, None], wt1[:, :, None])
    color = (ep0_t * (64 - wtex) + ep1_t * wtex + 32) >> 6
    u8_mask = decode_unorm8 or profile == cuq.PRF_LDR_SRGB
    if u8_mask:
        color = (color >> 8) * 257
    f16 = sf.unorm16_to_sf16(color)
    if profile >= cuq.PRF_HDR_RGB_LDR_A:
        # LNS lanes: the RGB of HDR formats, and alpha where it is HDR.
        lns = torch.stack([rgb_hdr, rgb_hdr, rgb_hdr, alpha_hdr], -1)
        lns_t = torch.gather(lns, 1, pot[:, :, None].expand(N, T, 4))
        f16 = torch.where(lns_t, sf.lns_to_sf16(color), f16)
    out = sf.float16_to_float(f16)

    # ---- Constant colour resolution ----------------------------------------
    ccol_u8 = (ccol >> 8) * 257 if u8_mask else ccol
    const_u16_out = sf.float16_to_float(sf.unorm16_to_sf16(ccol_u8))
    nan = error_nan(dev)
    const_f16_out = (sf.float16_to_float(ccol)
                     if profile >= cuq.PRF_HDR_RGB_LDR_A else nan)
    const_out = torch.where(const_f16[:, None], const_f16_out, const_u16_out)
    err = torch.where(is_const, const_err, bad)
    out = torch.where(is_const[:, None, None], const_out[:, None, :], out)
    return torch.where(err[:, None, None], nan, out)
