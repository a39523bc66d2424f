"""Batched 1-plane and 2-plane compression trials.

Port of ``astcenc_tpu/codec/trial.py`` (reference:
compress_symbolic_block_for_partition_1plane / _2planes,
astcenc_compress_symbolic.cpp:353-1037): per-mode search, candidate
refinement and the reference's sequential record selection, as batched
tensor ops. The mode search goes through kernel K1 (``ops/msearch.py``),
the refinement rounds through K2 (1 plane, 1-4 partitions) and K3
(2 planes) (``ops/refine.py``) on the card. The HDR profiles refit and
pack in PyTorch between rounds and run each round through K5 (1 plane) or
K6 and K7 (2 planes), as the JAX package does (trial.py:624-659,
:1192-1226).

``ASTC_DISABLE_KERNELS`` switches the ``msearch`` and ``refine`` families
off where the JAX package honours them (trial.py:431-433, :596-598,
:1024-1026, :1164-1166): ``compress.compress_image`` reads it once per
image (``gather.disabled_kernels``) and hands the set down as
``disabled``. With
``refine`` off the trials run the plain refinement (the JAX package's XLA
branches), whose realign lookups still go to kernel K8 and whose colour
packs to the colour pack kernel K9.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from .. import config as host_config
from .. import obs
from ..tables import quant
from ..ops import angular as ang
from ..ops import color_pack_hdr as cph
from ..ops import color_unquant as cuq
from ..ops import formats as fmts
from ..ops import gather
from ..ops import ideal as ideal_ops
from ..ops import msearch as msearch_ops
from ..ops import recompute as recompute_ops
from ..ops import refine as refine_ops

ERROR_CALC_DEFAULT = fmts.ERROR_CALC_DEFAULT
QUANT_32 = 11
HDR_RGB_LDR_A = cuq.PRF_HDR_RGB_LDR_A

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


def _packed_lists(wt_t, wt_i):
    """(D, W, K) texel lists and factors -> (D, W, K) int16 t | f << 8
    (K1's form; T <= 216 and factors <= 16)."""
    return (wt_t | (wt_i << 8)).astype(np.int16)


def _packed_taps(tap_w, tap_i):
    """(D, T, 4) taps -> (D, T, 2) int32: the four weight indices and the
    four factors, one per byte (K1's form)."""
    sh = np.array([0, 8, 16, 24], np.int32)
    return np.stack([(tap_w << sh).sum(-1), (tap_i << sh).sum(-1)],
                    -1).astype(np.int32)


_MOD_BITS = {1: 0, 2: 2, 3: 5, 4: 8}
# Bits left for colour in a 2-plane block before weights (trial.py:989).
FREE_BITS_2PLANE = 109


def pass_tables(et: EncoderTables, kind: str, pc: int, device):
    """Per-pass slices of the encoder tables (trial.py:322-353, and
    :962-985 for 2 planes), on the device, in the dense form (plain
    versions) and the sparse form (kernels). The context caches them
    (``api.Context.pass_tables``).

    kind: "always" (the mode-0 pass), "full" (every 1-plane mode, pc 1-4)
    or "two" (every 2-plane mode, pc 1).
    """
    if kind == "two":
        if pc != 1:
            raise ValueError("2-plane passes have one partition")
        quant_m, dm_global = et.m2_quant, et.m2_dm
        weight_bits, mode_index = et.m2_weight_bits, et.m2_mode_index
        maxprec_all = et.dm_maxprec2
        free_bits = FREE_BITS_2PLANE
    else:
        M1 = et.m1_always_count if kind == "always" else et.m1_quant.shape[0]
        quant_m, dm_global = et.m1_quant[:M1], et.m1_dm[:M1]
        weight_bits, mode_index = et.m1_weight_bits[:M1], et.m1_mode_index[:M1]
        maxprec_all = et.dm_maxprec1
        free_bits = _FREE_BITS_1PLANE[pc]
    mod_bits = _MOD_BITS[pc]
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
    maxprec = maxprec_all[dms_used]
    wvalid = np.arange(W)[None, :] < wcount[:, None]
    bitcount = free_bits - weight_bits

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return (x if dtype is None else x.to(dtype)).to(device)

    pt = types.SimpleNamespace(
        kind=kind, pc=pc, mod_bits=mod_bits,
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
        quant_m, dm_m, weight_bits, mode_index, free_bits,
        et.weight_quant_unquant, et.quant_mode_table, mod_bits, pc,
        ang.TUNE_MAX_ANGULAR_QUANT)
    levels_used = np.zeros(len(dms_used), np.int32)
    for rec in meta:
        if rec[5]:
            levels_used[rec[1]] |= 1 << rec[2]
    sin_t, cos_t = ang.sincos_tables()
    lo, hi = gather.quant_tables_np()
    pt.k = types.SimpleNamespace(
        tap_w=t(tap_w), tap_i=t(tap_i), taps=t(_packed_taps(tap_w, tap_i)),
        wt_t=t(wt_t), wt_i=t(wt_i), wlist=t(_packed_lists(wt_t, wt_i)),
        wt_n=t(wt_n), wcount=t(wcount, torch.int32),
        maxprec=t(maxprec, torch.int32),
        modes=t(msearch_ops.mode_meta_array(meta)),
        unq=t(et.weight_quant_unquant), sin_t=t(sin_t), cos_t=t(cos_t),
        levels_used=t(levels_used), dm_color=t(dm_color),
        pn=t(et.weight_prev_next),
        lohi=t(np.stack([lo, hi])),
    )
    return pt


def config_cw(cfg):
    """The config's channel weights, a static 4-tuple."""
    return (float(cfg.cw_r_weight), float(cfg.cw_g_weight),
            float(cfg.cw_b_weight), float(cfg.cw_a_weight))


def effective_cw(cfg, st=None):
    """Per-block channel weights (trial.py:45-57): with USE_ALPHA_WEIGHT
    the block state holds ``cw_scale`` and each block's R, G and B weights
    scale by it, an (N, 4) tensor; otherwise the static config tuple."""
    return ideal_ops.block_channel_weights(
        config_cw(cfg), None if st is None else st.get("cw_scale"))


def rgbm_scale(cfg) -> float:
    """The M scale of the RGBM trial metric, or 0 without MAP_RGBM
    (compress.py:61-62)."""
    return (float(cfg.rgbm_m_scale)
            if cfg.flags & host_config.Flags.MAP_RGBM else 0.0)


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


def _ideal_fit(st, pmask, counts, cw, comp_mask, omitted=None):
    return ideal_ops.ideal_colors_and_weights(
        st["texels"], pmask, counts, st["data_min"], st["data_max"], cw,
        comp_mask, omitted_component=omitted)


def _by_alpha(ua, a, b):
    return {k: torch.where(ua.reshape((-1,) + (1,) * (a[k].dim() - 1)),
                           a[k], b[k])
            for k in ("weights", "weight_error_scale", "ep0", "ep1")}


def _records(pre0, post, N: int, C: int):
    """(NC, ...) round-0 value + (R, NC, ...) per round -> (N, C*K, ...)
    records in reference visit order per candidate: [r0-pre, r0-post,
    r1-post, ...]."""
    rr = torch.cat([pre0[None], post], 0)
    K = rr.shape[0]
    shp = tuple(rr.shape[2:])
    rr = rr.reshape((K, N, C) + shp)
    return rr.permute((1, 2, 0) + tuple(range(3, 3 + len(shp)))).reshape(
        (N, C * K) + shp)


def _w64(w):
    out = torch.zeros(w.shape[:-1] + (64,), dtype=torch.int32,
                      device=w.device)
    out[..., :w.shape[-1]] = w
    return out


def _switches(use_kernels: bool, disabled: frozenset):
    """(K1 runs the mode search, the refinement kernels run the rounds):
    ``use_kernels=False`` runs every plain version, ``disabled`` names the
    kernel families switched off."""
    return (use_kernels and "msearch" not in disabled,
            use_kernels and "refine" not in disabled)


def _color_error_tables(eci, ep0, ep1, counts, cw, profile: int):
    if profile >= HDR_RGB_LDR_A:
        return fmts.color_error_tables_hdr(eci, ep0, ep1, counts, cw,
                                           encode_hdr_alpha=profile == 3)
    return fmts.color_error_tables_ldr(eci, ep0, ep1, counts, cw)


def _hdr_rounds_1plane(pt, wgrid0, dm, wq, alive, cq, cqm, fmt_req, texels,
                       pot, ep0, ep1, C: int, R: int, u8_mask: bool,
                       cw: tuple, profile: int, use_kernels: bool,
                       refine: bool, cw_scale=None, rgbm: float = 0.0):
    """The R rounds of a 1-plane HDR trial (JAX trial.py:624-659): one
    bootstrap round (K5 with no realign) for the first infill, then per
    round the least-squares refit with the RGBO vector, the pack of both
    arms, the decode and one K5 round. Arguments and outputs are those of
    ``refine.trial1_refine``; with ``refine`` False the rounds run their
    plain version (its lookups on K8 unless ``use_kernels`` is False)."""
    NC, W = wgrid0.shape
    cw_l = refine_ops.lane_cw(cw, cw_scale, C)
    pc = fmt_req.shape[1]
    dev = texels.device
    tex = texels.repeat_interleave(C, 0)
    pmask = ideal_ops.partition_onehot(pot)[..., :pc].repeat_interleave(C, 0)
    counts = pmask.sum(1)
    e0 = ep0.repeat_interleave(C, 0)
    e1 = ep1.repeat_interleave(C, 0)
    wait = obs.on and obs.sync("trial.big_1plane", "h2d")
    big = torch.tensor(refine_ops._BIG, device=dev)
    if wait:
        obs.end(wait, big.nbytes)

    def rnd(grid, alive, d0, d1, ncolors):
        return refine_ops.refine_round_1plane(
            pt, grid, dm, wq, alive, d0, d1, texels, pot, C, ncolors,
            u8_mask, cw, cw_scale=cw_scale, rgbm=rgbm, use_kernel=refine,
            gathers=use_kernels)

    zero = torch.zeros((NC, 4, 4), dtype=torch.int32, device=dev)
    undec = rnd(wgrid0, alive, zero, zero, 0)["undec"]
    wgrid = wgrid0
    out = {k: [] for k in ("fmt", "vals", "useq", "match", "wpost",
                           "err_post")}
    for r in range(R):
        rc = recompute_ops.recompute_ideal_colors_1plane(
            tex, pmask, counts, undec, cw_l, e0, e1, is_hdr=True)
        e0, e1 = rc["ep0"], rc["ep1"]

        def pack(q):
            f, v = cph.pack_color_endpoints(
                profile, *(rc[k].reshape(NC * pc, 4)
                           for k in ("ep0", "ep1", "rgbs", "rgbo")),
                fmt_req.reshape(NC * pc), q.repeat_interleave(pc),
                use_kernel=use_kernels)
            return f.reshape(NC, pc), v.reshape(NC, pc, 8)

        fmt4, vals4, use_q, matched = refine_ops.pack_partitions(pack, cq,
                                                                cqm, pc)
        d0, d1, _, _ = cuq.unpack_color_endpoints(profile, fmt4, vals4)
        res = rnd(wgrid, alive, d0.contiguous(), d1.contiguous(),
                  pt.ncolors)
        if r == 0:
            err_pre = torch.where(alive, res["err_pre"], big)
        wgrid = torch.where(alive[:, None], res["grid"], wgrid)
        out["err_post"].append(torch.where(alive, res["err_post"], big))
        alive = alive & res["adjusted"]
        undec = res["undec"]
        for k, v in (("fmt", fmt4), ("vals", vals4), ("useq", use_q),
                     ("match", matched), ("wpost", wgrid)):
            out[k].append(v)
    res = {k: torch.stack(v) for k, v in out.items()}
    res["err_pre"] = err_pre
    return res


def _hdr_rounds_2plane(pt, wg1_0, wg2_0, dm, wq, alive, cq, fmt_req, p2c,
                       texels, data_mean, ep0, ep1, C: int, R: int,
                       u8_mask: bool, cw: tuple, profile: int,
                       use_kernels: bool, refine: bool, cw_scale=None,
                       rgbm: float = 0.0):
    """The R rounds of a 2-plane HDR trial (JAX trial.py:1192-1226): one
    K7 launch for both first infills, then per round the 2-plane refit
    with the RGBO vector, the pack, the decode and one K6 round. Arguments
    and outputs are those of ``refine.trial2_refine``; with ``refine``
    False the rounds run their plain version."""
    NC, W = wg1_0.shape
    N = ep0.shape[0]
    dev = texels.device
    cw_l = refine_ops.lane_cw(cw, cw_scale, C)
    rows = torch.arange(N, device=dev) % texels.shape[0]
    tex = texels[rows].repeat_interleave(C, 0)
    mean = data_mean[rows].repeat_interleave(C, 0)
    p2c_f = p2c.repeat_interleave(C, 0)
    e0 = ep0.repeat_interleave(C, 0)
    e1 = ep1.repeat_interleave(C, 0)
    wait = obs.on and obs.sync("trial.big_2plane", "h2d")
    big = torch.tensor(refine_ops._BIG, device=dev)
    if wait:
        obs.end(wait, big.nbytes)

    def rnd(g1, g2, alive, d0, d1, ncolors):
        return refine_ops.refine_round_2plane(
            pt, g1, g2, dm, wq, alive, p2c, d0, d1, texels, C, ncolors,
            u8_mask, cw, cw_scale=cw_scale, rgbm=rgbm, use_kernel=refine,
            gathers=use_kernels)

    zero = torch.zeros((NC, 4), dtype=torch.int32, device=dev)
    boot = rnd(wg1_0, wg2_0, alive, zero, zero, 0)
    u1, u2 = boot["undec1"], boot["undec2"]
    wg1, wg2 = wg1_0, wg2_0
    out = {k: [] for k in ("fmt", "vals", "w1post", "w2post", "err_post")}
    for r in range(R):
        rc = recompute_ops.recompute_ideal_colors_2planes(
            tex, u1, u2, p2c_f, cw_l, mean, e0, e1, is_hdr=True)
        e0, e1 = rc["ep0"], rc["ep1"]
        fmt, vals = cph.pack_color_endpoints(
            profile, e0, e1, rc["rgbs"], rc["rgbo"], fmt_req, cq,
            use_kernel=use_kernels)
        d0, d1, _, _ = cuq.unpack_color_endpoints(profile, fmt, vals)
        res = rnd(wg1, wg2, alive, d0.contiguous(), d1.contiguous(),
                  pt.ncolors)
        if r == 0:
            err_pre = torch.where(alive, res["err_pre"], big)
        a = alive[:, None]
        wg1 = torch.where(a, res["grid1"], wg1)
        wg2 = torch.where(a, res["grid2"], wg2)
        out["err_post"].append(torch.where(alive, res["err_post"], big))
        alive = alive & res["adjusted"]
        u1, u2 = res["undec1"], res["undec2"]
        for k, v in (("fmt", fmt), ("vals", vals), ("w1post", wg1),
                     ("w2post", wg2)):
            out[k].append(v)
    res = {k: torch.stack(v) for k, v in out.items()}
    res["err_pre"] = err_pre
    return res


def trial1_records(st, pt, cfg, profile: int, u8_mask: bool, quant_limit,
                   ext_valid, pot=None, counts=None, use_kernels: bool = True,
                   disabled: frozenset = frozenset()):
    """Per-mode search + candidate refinement of a 1-plane trial over one
    candidate partitioning per block (trial.py:304-757). Returns the
    per-record tensors that apply_records_1plane consumes, in reference
    visit order per candidate: [r0-pre, r0-post, r1-post, ...].

    st: block state (``compress.make_block_state``); pt: the pass's tables
    (``pass_tables``; pt.pc partitions) on the texels' device; quant_limit
    (N,) int32; ext_valid (N,) bool lanes that may refine; pot (N, T)
    int32 partition of each texel and counts (N, 4) texels per partition
    (None for one partition); use_kernels/disabled: see ``_switches``.
    """
    texels = st["texels"]
    dev = texels.device
    N, T, _ = texels.shape
    pc = pt.pc
    cw = effective_cw(cfg, st)
    cws = st.get("cw_scale")
    k_msearch, k_refine = _switches(use_kernels, disabled)
    if pot is None:
        pot = torch.zeros((N, T), dtype=torch.int32, device=dev)
        counts = torch.full((N, 1), T, dtype=torch.int32, device=dev)
    pmask = ideal_ops.partition_onehot(pot)[..., :pc]
    counts = counts[:, :pc]

    ei = _by_alpha(st["uses_alpha"],
                   _ideal_fit(st, pmask, counts, cw, (1, 1, 1, 1)),
                   _ideal_fit(st, pmask, counts, cw, (1, 1, 1, 0), 3))
    ep0, ep1 = ei["ep0"], ei["ep1"]                          # (N, pc, 4)
    epc = (1.0 - ep0) / (ep1 - ep0)
    use_ep = (epc > 0.5) & (epc < 10.0)
    min_wt_cutoff = torch.where(use_ep, epc, 10.0).amin(dim=(1, 2))
    max_wq = torch.clamp(quant_limit, max=QUANT_32).to(torch.int32)

    eci = fmts.encoding_choice_errors(texels, pmask, ep0, ep1, cw,
                                      st["is_luminance"], st["default_alpha"])
    be, fm = _color_error_tables(eci, ep0, ep1, counts, cw, profile)
    if pc == 1:
        comb_err, comb_fmt = be[:, 0], fm[:, 0]
    else:
        comb_err, comb_fmt = fmts.combine_partitions(be, fm, pc)

    M = pt.quant_m_np.shape[0]
    C = max(1, min(cfg.tune_candidate_limit, M))
    R = cfg.tune_refinement_limit
    NC = N * C
    ms = msearch_ops.mode_search(
        pt, ei["weights"].contiguous(), ei["weight_error_scale"].contiguous(),
        min_wt_cutoff.contiguous(), max_wq.contiguous(),
        comb_err.contiguous(), comb_fmt.contiguous(), C,
        use_kernel=k_msearch)
    valid_f = (ms["valid"] & ext_valid[:, None]).reshape(NC).contiguous()
    wgrid0 = ms["uq"].reshape(NC, -1).contiguous()

    def flat(k):
        return ms[k].reshape(NC).contiguous()

    args = (pt, wgrid0, flat("dm"), flat("wq"), valid_f, flat("cq"),
            flat("cqm"), ms["fmt"].reshape(NC, pc).contiguous(),
            texels.contiguous(), pot.to(torch.int32).contiguous(),
            ep0.contiguous(), ep1.contiguous(), C, R, u8_mask,
            config_cw(cfg), profile)
    kw = {"cw_scale": cws, "rgbm": rgbm_scale(cfg)}
    if profile >= HDR_RGB_LDR_A:
        rf = _hdr_rounds_1plane(*args, use_kernels, k_refine, **kw)
    else:
        rf = refine_ops.trial1_refine(*args, **kw, use_kernel=k_refine,
                                      gathers=use_kernels)

    def rec(name):
        return _records(rf[name][0], rf[name], N, C)

    return {"err": _records(rf["err_pre"], rf["err_post"], N, C),
            "fmt": rec("fmt"), "vals": rec("vals"), "useq": rec("useq"),
            "match": rec("match"),
            "w64": _w64(_records(wgrid0, rf["wpost"], N, C)),
            "mode": ms["mode"].repeat_interleave(R + 1, 1)}


def _select_win(scb, rec_err, threshold):
    """Reference-order sequential selection: the first record that
    improves on the running best and beats the quality threshold wins,
    else the first global minimum (trial.py:773-791)."""
    N = rec_err.shape[0]
    shifted = torch.cat([scb["errorval"][:, None], rec_err[:, :-1]], 1)
    run_min_before = torch.cummin(shifted, 1).values
    is_take = rec_err < run_min_before
    is_hit = is_take & (rec_err < threshold[:, None])
    # First True / first minimum: argmax of a 0/1 int tensor and min() both
    # return the first index on ties.
    win = torch.where(is_hit.any(1), is_hit.to(torch.int32).argmax(1),
                      rec_err.min(1).indices)
    ni = torch.arange(N, device=rec_err.device)
    best_in_mode = torch.clamp(rec_err.amin(1), max=ERROR_CALC_DEFAULT)
    return ni, win, rec_err[ni, win], best_in_mode


def apply_records_1plane(scb, recs, threshold, pc: int, partition_index):
    """Sequential selection over a 1-plane trial's records
    (trial.py:760-824)."""
    ni, win, win_err, best_in_mode = _select_win(scb, recs["err"], threshold)
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


# Channel masks of plane 1 for each plane-2 component: (without alpha,
# with alpha) (trial.py:827-832).
PLANE_COMPONENT_MASKS = {
    0: ((0, 1, 1, 0), (0, 1, 1, 1)),
    1: ((1, 0, 1, 0), (1, 0, 1, 1)),
    2: ((1, 1, 0, 0), (1, 1, 0, 1)),
    3: (None, (1, 1, 1, 0)),
}
# Visit order of the plane-2 components (the reference's loop order).
COMP_ORDER = (3, 2, 1, 0)


def trial2_records(st, pt, cfg, profile: int, u8_mask: bool, quant_limit,
                   ext_valid, use_kernels: bool = True,
                   disabled: frozenset = frozenset()):
    """The four 2-plane trials of each block, folded into one (4N,) batch
    in component order 3, 2, 1, 0 (trial.py:856-1315, fold_all=True).

    pt: the "two" pass tables; quant_limit (N,) int32; ext_valid (N, 4)
    bool per block and component in COMP_ORDER; use_kernels/disabled: see
    ``_switches``. Returns records shaped
    (4N, C*K, ...), row c*N + n for component COMP_ORDER[c] of block n.
    """
    texels = st["texels"]
    dev = texels.device
    N0, T, _ = texels.shape
    cw = effective_cw(cfg, st)
    cws = st.get("cw_scale")
    k_msearch, k_refine = _switches(use_kernels, disabled)
    pmask = torch.ones((N0, T, 1), device=dev)
    counts = torch.full((N0, 1), T, dtype=torch.int32, device=dev)
    ua = st["uses_alpha"]
    ei1_v, ei2_v = {}, {}
    for comp in range(4):
        no_alpha, with_alpha = PLANE_COMPONENT_MASKS[comp]
        ea = _ideal_fit(st, pmask, counts, cw, with_alpha, comp)
        ei1_v[comp] = (ea if no_alpha is None else _by_alpha(
            ua, ea, _ideal_fit(st, pmask, counts, cw, no_alpha)))
        ei2_v[comp] = _ideal_fit(st, pmask, counts, cw,
                                 tuple(int(i == comp) for i in range(4)))
    keys = ("weights", "weight_error_scale", "ep0", "ep1")
    ei1 = {k: torch.cat([ei1_v[c][k] for c in COMP_ORDER]) for k in keys}
    ei2 = {k: torch.cat([ei2_v[c][k] for c in COMP_ORDER]) for k in keys}
    p2c = torch.cat([torch.full((N0,), c, dtype=torch.int32, device=dev)
                     for c in COMP_ORDER])
    N = 4 * N0
    tex4 = texels.repeat(4, 1, 1)
    quant_limit = quant_limit.repeat(4)
    ext_valid = ext_valid.T.reshape(N)
    if cws is not None:
        # The four components' rows share their block's scale
        # (trial.py:934-935).
        cw, cws = cw.repeat(4, 1), cws.repeat(4)

    err_lane = torch.arange(4, device=dev)[None, :] == p2c[:, None]
    e10, e11 = ei1["ep0"][:, 0], ei1["ep1"][:, 0]
    r1 = (1.0 - e10) / (e11 - e10)
    m1 = torch.where((r1 > 0.5) & (r1 < 10.0), r1, 10.0)
    mcut1 = torch.where(err_lane, ERROR_CALC_DEFAULT, m1).amin(1)
    e20, e21 = ei2["ep0"][:, 0], ei2["ep1"][:, 0]
    r2 = (1.0 - e20) / (e21 - e20)
    m2 = torch.where((r2 > 0.5) & (r2 < 10.0), r2, 10.0)
    mcut2 = torch.where(err_lane, m2, ERROR_CALC_DEFAULT).amin(1)
    max_wq = torch.clamp(quant_limit, max=QUANT_32).to(torch.int32)

    sep = err_lane[:, None, :]
    ep0m = torch.where(sep, ei2["ep0"], ei1["ep0"])               # (N, 1, 4)
    ep1m = torch.where(sep, ei2["ep1"], ei1["ep1"])
    pmask4 = torch.ones((N, T, 1), device=dev)
    counts4 = torch.full((N, 1), T, dtype=torch.int32, device=dev)
    eci = fmts.encoding_choice_errors(tex4, pmask4, ep0m, ep1m, cw,
                                      st["is_luminance"].repeat(4),
                                      st["default_alpha"])
    be, fm = _color_error_tables(eci, ep0m, ep1m, counts4, cw, profile)

    M = pt.quant_m_np.shape[0]
    C = max(1, min(cfg.tune_candidate_limit, M))
    R = cfg.tune_refinement_limit
    NC = N * C
    ms = msearch_ops.mode_search(
        pt, ei1["weights"].contiguous(),
        ei1["weight_error_scale"].contiguous(), mcut1.contiguous(),
        max_wq.contiguous(), be[:, 0].contiguous(), fm[:, 0].contiguous(),
        C, wei2=ei2["weights"].contiguous(),
        wes2=ei2["weight_error_scale"].contiguous(),
        mcut2=mcut2.contiguous(), use_kernel=k_msearch)
    valid_f = (ms["valid"] & ext_valid[:, None]).reshape(NC).contiguous()
    wg1 = ms["uq"].reshape(NC, -1).contiguous()
    wg2 = ms["uq2"].reshape(NC, -1).contiguous()

    def flat(k):
        return ms[k].reshape(NC).contiguous()

    args = (pt, wg1, wg2, flat("dm"), flat("wq"), valid_f, flat("cq"),
            ms["fmt"][..., 0].reshape(NC).contiguous(), p2c,
            texels.contiguous(), st["data_mean"].contiguous(),
            ep0m[:, 0].contiguous(), ep1m[:, 0].contiguous(), C, R, u8_mask,
            config_cw(cfg), profile)
    kw = {"cw_scale": cws, "rgbm": rgbm_scale(cfg)}
    if profile >= HDR_RGB_LDR_A:
        rf = _hdr_rounds_2plane(*args, use_kernels, k_refine, **kw)
    else:
        rf = refine_ops.trial2_refine(*args, **kw, use_kernel=k_refine,
                                      gathers=use_kernels)

    K = R + 1
    fmt4 = torch.zeros((R, NC, 4), dtype=torch.int32, device=dev)
    fmt4[..., 0] = rf["fmt"]
    vals4 = torch.zeros((R, NC, 4, 8), dtype=torch.int32, device=dev)
    vals4[:, :, 0] = rf["vals"]
    return {"err": _records(rf["err_pre"], rf["err_post"], N, C),
            "fmt": _records(fmt4[0], fmt4, N, C),
            "vals": _records(vals4[0], vals4, N, C),
            "q": ms["cq"].repeat_interleave(K, 1),
            "mode": ms["mode"].repeat_interleave(K, 1),
            "w1_64": _w64(_records(wg1, rf["w1post"], N, C)),
            "w2_64": _w64(_records(wg2, rf["w2post"], N, C))}


def apply_records_2plane(scb, recs, threshold, p2c, active_in):
    """Sequential selection over a 2-plane trial's records
    (trial.py:1318-1374)."""
    ni, win, win_err, best_in_mode = _select_win(scb, recs["err"], threshold)
    take = (win_err < scb["errorval"]) & ~scb["finished"] & active_in

    def g(name):
        return recs[name][ni, win]

    t1 = take[:, None]
    new = dict(scb)
    new["errorval"] = torch.where(take, win_err, scb["errorval"])
    new["block_type_error"] = scb["block_type_error"] & ~take
    new["block_mode"] = torch.where(take, g("mode"), scb["block_mode"])
    new["quant_mode"] = torch.where(take, g("q"), scb["quant_mode"])
    new["partition_count"] = torch.where(take, 1, scb["partition_count"])
    new["partition_index"] = torch.where(take, 0, scb["partition_index"])
    new["color_formats"] = torch.where(t1, g("fmt"), scb["color_formats"])
    new["color_formats_matched"] = scb["color_formats_matched"] & ~take
    new["color_values"] = torch.where(take[:, None, None], g("vals"),
                                      scb["color_values"])
    new["plane2_component"] = torch.where(take, p2c, scb["plane2_component"])
    new["weights"] = torch.where(t1, g("w1_64"), scb["weights"])
    new["weights2"] = torch.where(t1, g("w2_64"), scb["weights2"])
    return new, best_in_mode
