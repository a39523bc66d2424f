"""Batched 1-plane, 1-partition compression trials.

Port of the 1-plane parts of ``astcenc_tpu/codec/trial.py`` (reference:
compress_symbolic_block_for_partition_1plane,
astcenc_compress_symbolic.cpp:353-676): per-mode search, candidate
refinement and the reference's sequential record selection, as batched
tensor ops. The mode search and the refinement rounds go through kernels
K1 (``ops/msearch.py``) and K2 (``ops/refine.py``) on the card.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from .._host import quant
from ..ops import angular as ang
from ..ops import color_pack as cpack
from ..ops import formats as fmts
from ..ops import ideal as ideal_ops
from ..ops import msearch as msearch_ops
from ..ops import refine as refine_ops

ERROR_CALC_DEFAULT = fmts.ERROR_CALC_DEFAULT
QUANT_32 = 11

# Copied from astcenc_tpu/codec/trial.py:71-76 (the quant levels live
# beside their one user, ops/msearch.py).
_FREE_BITS_1PLANE = {1: 115 - 4, 2: 111 - 4 - 10, 3: 108 - 4 - 10,
                     4: 105 - 4 - 10}


@dataclasses.dataclass
class EncoderTables:
    """Static per-BSD tables used by the trials (host NumPy)."""

    texel_count: int
    m1_quant: np.ndarray
    m1_dm: np.ndarray
    m1_weight_bits: np.ndarray
    m1_mode_index: np.ndarray
    m1_always_count: int
    m2_quant: np.ndarray
    m2_dm: np.ndarray
    m2_weight_bits: np.ndarray
    m2_mode_index: np.ndarray
    dec_int: np.ndarray       # (D, T, W)
    dec_sq: np.ndarray
    dec_f32: np.ndarray
    dec_wcount: np.ndarray    # (D,)
    dm_maxprec1: np.ndarray
    dm_maxprec2: np.ndarray
    dm_refprec1: np.ndarray
    dm_refprec2: np.ndarray
    dm_color: np.ndarray      # (D, W) weight parity class
    ncolors: int
    weight_quant_unquant: np.ndarray  # (12, 32)
    weight_prev_next: np.ndarray      # (12, 65, 2)
    quant_mode_table: np.ndarray      # (10, 128)


def build_encoder_tables(bsd) -> EncoderTables:
    """Copied from astcenc_tpu/codec/trial.py:112-159."""
    m1_end = bsd.block_mode_count_1plane_selected
    m2_end = bsd.block_mode_count_1plane_2plane_selected
    pn = np.zeros((12, 65, 2), np.int32)
    wuq = np.zeros((12, 32), np.int32)
    for q in range(12):
        t = quant.weight_quant_tables(q)
        pn[q] = t["prev_next"]
        wuq[q, :len(t["unquant"])] = t["unquant"]
    D, _, W = bsd.dec_dense.shape
    dm_color = np.zeros((D, W), np.int32)
    is_3d = bsd.dim[2] > 1
    for d in range(D):
        wx, wy, wz = bsd.dm_weight_dims[d]
        for w in range(int(bsd.dm_weight_count[d])):
            x = w % wx
            y = (w // wx) % wy
            z = w // (wx * wy)
            dm_color[d, w] = (x & 1) | ((y & 1) << 1) | ((z & 1) << 2)
    return EncoderTables(
        texel_count=bsd.texel_count,
        m1_quant=bsd.bm_quant_mode[:m1_end].copy(),
        m1_dm=bsd.bm_decimation_mode[:m1_end].copy(),
        m1_weight_bits=bsd.bm_weight_bits[:m1_end].copy(),
        m1_mode_index=bsd.bm_mode_index[:m1_end].copy(),
        m1_always_count=bsd.block_mode_count_1plane_always,
        m2_quant=bsd.bm_quant_mode[m1_end:m2_end].copy(),
        m2_dm=bsd.bm_decimation_mode[m1_end:m2_end].copy(),
        m2_weight_bits=bsd.bm_weight_bits[m1_end:m2_end].copy(),
        m2_mode_index=bsd.bm_mode_index[m1_end:m2_end].copy(),
        dec_int=bsd.dec_dense.astype(np.float32),
        dec_sq=(bsd.dec_dense.astype(np.float32)) ** 2,
        dec_f32=bsd.dec_dense_f32,
        dec_wcount=bsd.dm_weight_count.copy(),
        dm_maxprec1=bsd.dm_maxprec_1plane.copy(),
        dm_maxprec2=bsd.dm_maxprec_2planes.copy(),
        dm_refprec1=bsd.dm_refprec_1plane.copy(),
        dm_refprec2=bsd.dm_refprec_2planes.copy(),
        dm_color=dm_color,
        ncolors=8 if is_3d else 4,
        weight_quant_unquant=wuq,
        weight_prev_next=pn,
        quant_mode_table=quant.quant_mode_table(),
    )


def _sparse_stencils(dec_int_np):
    """Dense (D, T, W) integer stencils -> per-texel taps (D, T, 4) and
    per-weight texel lists (D, W, K), the format's sparse form."""
    D, T, W = dec_int_np.shape
    tap_w = np.zeros((D, T, 4), np.int32)
    tap_i = np.zeros((D, T, 4), np.int32)
    nz = dec_int_np != 0
    K = max(1, int(nz.sum(1).max()))
    wt_t = np.zeros((D, W, K), np.int32)
    wt_i = np.zeros((D, W, K), np.int32)
    wt_n = np.zeros((D, W), np.int32)
    for d in range(D):
        for t in range(T):
            ws = np.nonzero(nz[d, t])[0]
            if len(ws) > 4:
                raise ValueError("a texel has more than 4 stencil taps")
            tap_w[d, t, :len(ws)] = ws
            tap_i[d, t, :len(ws)] = dec_int_np[d, t, ws]
        for w in range(W):
            ts = np.nonzero(nz[d, :, w])[0]
            wt_n[d, w] = len(ts)
            wt_t[d, w, :len(ts)] = ts
            wt_i[d, w, :len(ts)] = dec_int_np[d, ts, w]
    return tap_w, tap_i, wt_t, wt_i, wt_n


def pass_tables(et: EncoderTables, only_always: bool, device):
    """Per-pass slices of the encoder tables (trial.py:322-353), on the
    device, in the dense form (plain versions) and the sparse form
    (kernels). The context caches them (``api.Context.pass_tables``)."""
    M1_full = et.m1_quant.shape[0]
    sel = np.arange(et.m1_always_count if only_always else M1_full)
    quant_m = et.m1_quant[sel]
    dm_global = et.m1_dm[sel]
    weight_bits = et.m1_weight_bits[sel]
    mode_index = et.m1_mode_index[sel]
    dms_used = np.unique(dm_global)
    remap = np.zeros(et.dec_int.shape[0], np.int32)
    remap[dms_used] = np.arange(len(dms_used), dtype=np.int32)
    dm_m = remap[dm_global]
    dec_int = et.dec_int[dms_used]
    wcount = et.dec_wcount[dms_used]
    W = int(min(dec_int.shape[2], ((int(wcount.max()) + 7) // 8) * 8))
    dec_int = dec_int[:, :, :W]
    dec_sq = et.dec_sq[dms_used][:, :, :W]
    dec_f32 = et.dec_f32[dms_used][:, :, :W]
    dm_color = et.dm_color[dms_used][:, :W]
    maxprec = et.dm_maxprec1[dms_used]
    wvalid = np.arange(W)[None, :] < wcount[:, None]
    bitcount = _FREE_BITS_1PLANE[1] - weight_bits

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return (x if dtype is None else x.to(dtype)).to(device)

    pt = types.SimpleNamespace(
        quant_m_np=quant_m, dm_m_np=dm_m, mode_index_np=mode_index,
        dms_used_np=dms_used,
        bitcount_np=bitcount, mode_active_np=bitcount > 0,
        quant_mode_table_np=et.quant_mode_table, ncolors=et.ncolors,
        dec_int=t(dec_int), dec_sq=t(dec_sq), dec_f32=t(dec_f32),
        wvalid=t(wvalid), dm_color=t(dm_color),
        maxprec=t(maxprec, torch.int32),
        weight_quant_unquant=t(et.weight_quant_unquant),
        weight_prev_next=t(et.weight_prev_next),
        W=W, D=len(dms_used),
    )
    # Kernel operands (sparse stencils, mode metadata, lookup tables).
    tap_w, tap_i, wt_t, wt_i, wt_n = _sparse_stencils(
        dec_int.astype(np.int32))
    meta = msearch_ops.make_mode_meta(
        quant_m, dm_m, weight_bits, mode_index, _FREE_BITS_1PLANE[1],
        et.weight_quant_unquant, et.quant_mode_table, 0, 1,
        ang.TUNE_MAX_ANGULAR_QUANT)
    levels_used = np.zeros(len(dms_used), np.int32)
    for rec in meta:
        if rec[5]:
            levels_used[rec[1]] |= 1 << rec[2]
    sin_t, cos_t = ang.sincos_tables()
    lo, hi = cpack.quant_tables_np()
    pt.k = types.SimpleNamespace(
        tap_w=t(tap_w), tap_i=t(tap_i), wt_t=t(wt_t), wt_i=t(wt_i),
        wt_n=t(wt_n), wcount=t(wcount, torch.int32),
        maxprec=t(maxprec, torch.int32),
        modes=t(msearch_ops.mode_meta_array(meta)),
        unq=t(et.weight_quant_unquant), sin_t=t(sin_t), cos_t=t(cos_t),
        levels_used=t(levels_used), dm_color=t(dm_color),
        pn=t(et.weight_prev_next),
        lohi=t(np.stack([lo, hi])),
    )
    return pt


def effective_cw(cfg):
    """Channel weights: the static config tuple. Per-block weights
    (USE_ALPHA_WEIGHT) are not ported, and the driver refuses them."""
    return (float(cfg.cw_r_weight), float(cfg.cw_g_weight),
            float(cfg.cw_b_weight), float(cfg.cw_a_weight))


def empty_scb(N: int, T: int, device):
    """Per-block symbolic state, carried across trials."""
    i32 = torch.int32

    def z(*s, dtype=i32):
        return torch.zeros(s, dtype=dtype, device=device)

    return {
        "errorval": torch.full((N,), ERROR_CALC_DEFAULT, device=device),
        "block_type_error": torch.ones((N,), dtype=torch.bool, device=device),
        "block_mode": z(N), "quant_mode": z(N),
        "partition_count": torch.ones((N,), dtype=i32, device=device),
        "partition_index": z(N), "color_formats": z(N, 4),
        "color_formats_matched": z(N, dtype=torch.bool),
        "color_values": z(N, 4, 8),
        "plane2_component": torch.full((N,), -1, dtype=i32, device=device),
        "weights": z(N, 64), "weights2": z(N, 64),
        "finished": z(N, dtype=torch.bool),
    }


def trial1_records(st, pt, cfg, profile: int, u8_mask: bool, quant_limit,
                   ext_valid, use_kernels: bool = True):
    """Per-mode search + candidate refinement of a 1-partition 1-plane
    trial (trial.py:304-757). Returns the per-record tensors that
    apply_records_1plane consumes, in reference visit order per candidate:
    [r0-pre, r0-post, r1-post, ...].

    st: block state (``compress.make_block_state``); pt: the pass's tables
    (``pass_tables``) on the texels' device; quant_limit (N,) int32;
    ext_valid (N,) bool lanes that may refine.
    """
    texels = st["texels"]
    dev = texels.device
    N, T, _ = texels.shape
    cw = effective_cw(cfg)
    pmask = torch.ones((N, T, 1), device=dev)
    counts = torch.full((N, 1), T, dtype=torch.int32, device=dev)

    ei4 = ideal_ops.ideal_colors_and_weights(
        texels, pmask, counts, st["data_min"], st["data_max"], cw,
        (1, 1, 1, 1))
    ei3 = ideal_ops.ideal_colors_and_weights(
        texels, pmask, counts, st["data_min"], st["data_max"], cw,
        (1, 1, 1, 0), omitted_component=3)
    ua = st["uses_alpha"]
    wei = torch.where(ua[:, None], ei4["weights"], ei3["weights"])
    wes = torch.where(ua[:, None], ei4["weight_error_scale"],
                      ei3["weight_error_scale"])
    ep0 = torch.where(ua[:, None, None], ei4["ep0"], ei3["ep0"])   # (N,1,4)
    ep1 = torch.where(ua[:, None, None], ei4["ep1"], ei3["ep1"])

    epc = (1.0 - ep0) / (ep1 - ep0)
    use_ep = (epc > 0.5) & (epc < 10.0)
    min_wt_cutoff = torch.where(use_ep, epc, 10.0).amin(dim=(1, 2))
    max_wq = torch.clamp(quant_limit, max=QUANT_32).to(torch.int32)

    eci = fmts.encoding_choice_errors(texels, pmask, ep0, ep1, cw,
                                      st["is_luminance"], st["default_alpha"])
    be, fm = fmts.color_error_tables_ldr(eci, ep0, ep1, counts, cw)
    comb_err = be[:, 0].contiguous()
    comb_fmt = fm[:, 0].contiguous()

    M = pt.quant_m_np.shape[0]
    C = max(1, min(cfg.tune_candidate_limit, M))
    R = cfg.tune_refinement_limit
    NC = N * C
    ms = msearch_ops.mode_search(
        pt, wei.contiguous(), wes.contiguous(), min_wt_cutoff.contiguous(),
        max_wq.contiguous(), comb_err, comb_fmt, C, use_kernel=use_kernels)
    valid_f = (ms["valid"] & ext_valid[:, None]).reshape(NC)
    wgrid0 = ms["uq"].reshape(NC, -1).contiguous()
    dm_f = ms["dm"].reshape(NC).contiguous()
    wq_f = ms["wq"].reshape(NC).contiguous()
    cq_f = ms["cq"].reshape(NC).contiguous()
    fmt_req_f = ms["fmt"].reshape(NC).contiguous()

    rf = refine_ops.trial1_refine(
        pt, wgrid0, dm_f, wq_f, valid_f.contiguous(), cq_f, fmt_req_f,
        texels.contiguous(), ep0[:, 0].contiguous(), ep1[:, 0].contiguous(),
        C, R, u8_mask, cw, profile, use_kernel=use_kernels)

    K = R + 1
    W = pt.W

    def rec(pre0, post):
        # (NC, ...) + (R, NC, ...) -> (N, C*K, ...)
        rr = torch.cat([pre0[None], post], 0)
        shp = tuple(rr.shape[2:])
        rr = rr.reshape((K, N, C) + shp)
        return rr.permute((1, 2, 0) + tuple(range(3, 3 + len(shp)))).reshape(
            (N, C * K) + shp)

    fmt4 = torch.zeros((R, NC, 4), dtype=torch.int32, device=dev)
    fmt4[..., 0] = rf["fmt"]
    vals4 = torch.zeros((R, NC, 4, 8), dtype=torch.int32, device=dev)
    vals4[:, :, 0] = rf["vals"]
    useq = cq_f[None].expand(R, NC)
    w64 = torch.zeros((N, C * K, 64), dtype=torch.int32, device=dev)
    w64[:, :, :W] = rec(wgrid0, rf["wpost"])
    return {"err": rec(rf["err_pre"], rf["err_post"]),
            "fmt": rec(fmt4[0], fmt4), "vals": rec(vals4[0], vals4),
            "useq": rec(useq[0], useq),
            "match": torch.zeros((N, C * K), dtype=torch.bool, device=dev),
            "w64": w64,
            "mode": ms["mode"].repeat_interleave(K, 1)}


def apply_records_1plane(scb, recs, threshold, pc: int, partition_index):
    """Reference-order sequential selection over a trial's records
    (trial.py:760-824): the first record that improves on the running best
    and beats the quality threshold wins, else the first global minimum."""
    rec_err = recs["err"]
    N, CK = rec_err.shape
    prev_best = scb["errorval"]
    shifted = torch.cat([prev_best[:, None], rec_err[:, :-1]], 1)
    run_min_before = torch.cummin(shifted, 1).values
    is_take = rec_err < run_min_before
    is_hit = is_take & (rec_err < threshold[:, None])
    any_hit = is_hit.any(1)
    # First True / first minimum: argmax of a 0/1 int tensor and min() both
    # return the first index on ties.
    first_hit = is_hit.to(torch.int32).argmax(1)
    argmin_idx = rec_err.min(1).indices
    win = torch.where(any_hit, first_hit, argmin_idx)
    ni = torch.arange(N, device=rec_err.device)
    win_err = rec_err[ni, win]
    best_in_mode = torch.clamp(rec_err.amin(1), max=ERROR_CALC_DEFAULT)
    take = (win_err < scb["errorval"]) & ~scb["finished"]

    def g(name):
        return recs[name][ni, win]

    t1 = take[:, None]
    new = dict(scb)
    new["errorval"] = torch.where(take, win_err, scb["errorval"])
    new["block_type_error"] = scb["block_type_error"] & ~take
    new["block_mode"] = torch.where(take, g("mode"), scb["block_mode"])
    new["quant_mode"] = torch.where(take, g("useq"), scb["quant_mode"])
    new["partition_count"] = torch.where(take, pc, scb["partition_count"])
    new["partition_index"] = torch.where(take, partition_index,
                                         scb["partition_index"])
    new["color_formats"] = torch.where(t1, g("fmt"), scb["color_formats"])
    new["color_formats_matched"] = torch.where(
        take, g("match"), scb["color_formats_matched"])
    new["color_values"] = torch.where(take[:, None, None], g("vals"),
                                      scb["color_values"])
    new["plane2_component"] = torch.where(take, -1, scb["plane2_component"])
    new["weights"] = torch.where(t1, g("w64"), scb["weights"])
    return new, best_in_mode
