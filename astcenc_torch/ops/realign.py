"""Weight realignment (+/-1 quantization step hill climb), decimated grids.

Port of ``astcenc_tpu/ops/realign.py::realign_decimated_grouped`` (:169;
reference astcenc_compress_symbolic.cpp:188-338): the grid weights split
into parity classes whose stencils share no texel, so each class updates
at once with Gauss-Seidel semantics kept inside the class.
"""

from __future__ import annotations

import torch

from . import gather


def realign_decimated_grouped(wgrid, texels, ep0_t, ep1_t, channel_weight,
                              pn_rows, dec_f32, incidence, wvalid, color_of,
                              ncolors: int, plane_mask=None):
    """Realign a decimated weight grid, one plane.

    Args:
      wgrid: (N, W) int32 unquantized grid weights 0..64.
      texels: (N, T, 4); ep0_t/ep1_t: (N, T, 4) per-texel decoded endpoints.
      channel_weight: static 4-tuple, or per-block (N, 4) weights.
      pn_rows: (N, 65, 2) int32 per-block prev/next unquant values.
      dec_f32: (N, T, W) per-block infill stencil; incidence: (N, T, W) 0/1.
      wvalid: (N, W) bool; color_of: (N, W) parity class per slot.
      plane_mask: (N, 4) bool channels this plane does not carry (their
        endpoint offset is taken as zero), or None.

    The prev/next rows are looked up through ``gather.row_lookup`` (kernel
    K8 on the card), as the JAX package does on the TPU.

    Returns (new_wgrid (N, W) int32, adjusted (N,) bool).
    """
    if torch.is_tensor(channel_weight):
        cw = [channel_weight[:, c, None] for c in range(4)]    # (N, 1) each
    else:
        cw = [float(c) for c in channel_weight]
    epd_t = ep1_t - ep0_t
    if plane_mask is not None:
        epd_t = torch.where(plane_mask[:, None, :], 0.0, epd_t)
    off_t = epd_t * (1.0 / 64.0)
    base_t = ep0_t
    T = texels.shape[1]

    def chan_sum(x):
        # x[..., 0] * cw0 + ... in channel order, as kernel K2 sums them.
        acc = x[..., 0] * cw[0]
        for c in range(1, 4):
            acc = acc + x[..., c] * cw[c]
        return acc

    def texel_sum(stencil, v):
        # sum_t stencil[n, t, w] * v[n, t] in ascending texel order: the
        # order of kernel K2's per-weight texel lists (zero terms add
        # nothing), so both versions take the same realign decisions.
        acc = stencil[:, 0, :] * v[:, 0, None]
        for t in range(1, T):
            acc = acc + stencil[:, t, :] * v[:, t, None]
        return acc

    C_t = chan_sum(off_t * off_t)
    infilled = torch.einsum("ntw,nw->nt", dec_f32, wgrid.to(torch.float32))
    adjusted = torch.zeros(wgrid.shape[0], dtype=torch.bool,
                           device=wgrid.device)
    # SC depends only on the fixed endpoints; each slot's prev/next lookup
    # is consumed before its own single update, so the initial lookup holds
    # for every class step.
    SC = texel_sum(dec_f32 * dec_f32, C_t)
    pnq = gather.row_lookup(pn_rows, wgrid.clamp(0, 64))
    down = pnq[..., 0]
    up = pnq[..., 1]
    for k in range(ncolors):
        diff = base_t + off_t * infilled[..., None] - texels
        A_t = chan_sum(diff * diff)
        B_t = chan_sum(diff * off_t)
        SA = texel_sum(incidence, A_t)
        SB = texel_sum(dec_f32, B_t)
        d_dn = (down - wgrid).to(torch.float32)
        d_up = (up - wgrid).to(torch.float32)
        e_dn = SA + 2.0 * d_dn * SB + d_dn * d_dn * SC
        e_up = SA + 2.0 * d_up * SB + d_up * d_up * SC
        ok = wvalid & (color_of == k)
        go_up = (e_up < SA) & (e_up < e_dn) & (wgrid < 64) & ok
        go_dn = ~go_up & (e_dn < SA) & (wgrid > 0) & ok
        new_w = torch.where(go_up, up, torch.where(go_dn, down, wgrid))
        delta = (new_w - wgrid).to(torch.float32)
        infilled = infilled + torch.einsum("ntw,nw->nt", dec_f32, delta)
        wgrid = new_w
        adjusted = adjusted | (go_up | go_dn).any(-1)
    return wgrid, adjusted
