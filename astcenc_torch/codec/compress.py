"""Batched block compression driver.

Port of ``astcenc_tpu/codec/compress.py``: make_block_state,
_lowest_correlation, the split-stage compress_symbolic_batch (:268-287)
with _stage1_1plane (:290-411), _stage2a_2plane (:432-494),
_stage2b_multipart and _stage2b_one_pc (:497-619), _finalize_pack
(:622-646), and compress_image (:1001-1123): with its alpha-scale RDO
(:1051-1059, :1081-1082; the mask ``_alpha_zero_blocks``, :1184-1215), its
cancel check before each chunk (:1086-1095) and its diagnostic trace
(-dtrace: ``_trace_blocks`` :180, ``_trace_pass`` :202, the lowest
correlation :452-456, the block positions :1104-1116). It takes what the JAX
encoder takes: 2D and 3D footprints, per-block alpha weighting
(USE_ALPHA_WEIGHT: the block state's ``cw_scale``), RGBM (the trials'
RGBM metric) and non-finite floats (NaN to 0, infinities clamped).

Every block of a chunk goes through stage 1 (the mode-0 pass and the full
1-partition 1-plane pass). Each later stage runs only on the blocks it
needs: the driver takes the unfinished (and, for stage 2a, 2-plane
eligible) blocks with ``nonzero``, runs the stage on them and scatters the
result back, as the reference's per-block early exits skip the rest
(astcenc_compress_symbolic.cpp:1283-1456). Stage 2a tries the four plane-2
components in one folded batch; stage 2b ranks partitionings and tries the
best few of each partition count 2..limit. In the HDR profiles the image
loads as LNS codes, the error threshold is 0 (no block leaves after stage
1) and constant blocks become FP16 void-extent blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as host_config
from .. import obs
from ..ops import _build
from ..ops import softfloat as sf
from ..ops import texel_sum as ts
from . import partition_search, physical, trial
from .trace import Tracer

TUNE_MIN_SEARCH_MODE0 = 0.85
ERROR_CALC_DEFAULT = 1e30
# Blocks per chunk: bounds the plain versions' (chunk, modes, weights,
# angular steps) intermediates on the device.
CHUNK = 16384

Flags = host_config.Flags
Profile = host_config.Profile


def make_block_state(texels, profile: int = 1, alpha_weight: bool = False):
    """Per-block state dict from (N, T, 4) float32 texels. The mean adds
    in the CPU's order of ``texels.mean(1)`` on every device. With
    ``alpha_weight`` (USE_ALPHA_WEIGHT) it holds ``cw_scale``, each block's
    largest alpha over 65535, which scales its R, G and B error weights
    (compress.py:100-103; reference astcenc_entry.cpp:1016-1035)."""
    data_min = texels.amin(1)
    data_max = texels.amax(1)
    gray = ((texels[..., 0] == texels[..., 1])
            & (texels[..., 0] == texels[..., 2])).all(1)
    default_alpha = 30720.0 if profile == 3 else 65535.0
    alpha1 = (data_min[:, 3] == default_alpha) & (
        data_max[:, 3] == default_alpha)
    st = {
        "texels": texels, "data_min": data_min, "data_max": data_max,
        "data_mean": sf.div(ts.block_sum(texels), float(texels.shape[1])),
        "grayscale": gray,
        "uses_alpha": data_min[:, 3] != data_max[:, 3],
        "is_luminance": gray & alpha1, "is_luminancealpha": gray & ~alpha1,
        "default_alpha": default_alpha,
    }
    if alpha_weight:
        st["cw_scale"] = data_max[:, 3] * (1.0 / 65535.0)
    return st


def _lowest_correlation(texels, channel_weight):
    """prepare_block_statistics (reference :1047-1159): the smallest
    |correlation| between two channels of each block; ``channel_weight`` a
    static tuple or per-block (N, 4) weights. Its sums add in one order on
    every device: the channel sums as the CPU's ``x.sum(1)``, the products
    of channel pairs texel after texel."""
    if torch.is_tensor(channel_weight):
        weight = (sf.sum4(channel_weight) / 4.0)[:, None]     # (N, 1)
    else:
        wait = obs.on and obs.sync("compress.correlation_weight", "h2d")
        cw = torch.tensor(channel_weight, dtype=torch.float32,
                          device=texels.device)
        if wait:
            obs.end(wait, cw.nbytes)
        weight = sf.sum4(cw) / 4.0
    T = texels.shape[1]
    rpt = 1.0 / torch.clamp(weight * T, min=1e-7)
    s = ts.block_sum(texels) * weight
    var = ts.texel_sum(texels, texels) * weight[..., None]
    var = var - s[:, :, None] * s[:, None, :] * rpt[..., None]
    d = sf.sqrt(torch.clamp(torch.diagonal(var, dim1=1, dim2=2), min=0.0))
    denom = d[:, :, None] * d[:, None, :]
    corr = var / torch.where(denom > 0, denom, 1.0)
    corr = torch.where(torch.isnan(corr) | (denom == 0), 1.0, corr)
    iu = torch.triu_indices(4, 4, offset=1, device=texels.device)
    return corr[:, iu[0], iu[1]].abs().amin(1)


class _Trace:
    """A tracer and the block index of each row of the batch a stage sees:
    the driver hands each stage the rows it compacted, so the hooks map
    every row back to its block. Each hook copies whole record tensors to
    the host once. ``bsd`` names the block modes; ``K`` is the number of
    records of a candidate, [r0-pre, r0-post, r1-post, ...]."""

    def __init__(self, tracer: Tracer, rows: np.ndarray, bsd, K: int):
        self.tracer = tracer
        self.rows = rows
        self.bsd = bsd
        self.K = K

    def sub(self, idx) -> "_Trace":
        """The trace of the compacted rows ``idx``."""
        return _Trace(self.tracer, self.rows[idx.cpu().numpy()], self.bsd,
                      self.K)

    def blocks(self, st, error_threshold, is_const):
        """Block-node attributes (compress.py:180; reference: compress_block,
        astcenc_compress_symbolic.cpp:1173-1212)."""
        dmin = st["data_min"].cpu().numpy()
        dmax = st["data_max"].cpu().numpy()
        thr = np.broadcast_to(torch.as_tensor(error_threshold).cpu().numpy(),
                              (len(self.rows),))
        isc = is_const.cpu().numpy()
        for n, gi in enumerate(self.rows.tolist()):
            b = self.tracer.block(gi, self.tracer.positions.get(gi,
                                                                (0, 0, 0)))
            for i, c in enumerate("rgba"):
                b.add(f"min_{c}", float(dmin[n, i]))
                b.add(f"max_{c}", float(dmax[n, i]))
            b.add("tune_error_threshold", float(thr[n]))
            if isc[n]:
                p = b.child("pass")
                p.add("partition_count", 0)
                p.add("plane_count", 1)
                p.add("exit", "quality hit")

    def value(self, key: str, values):
        """One attribute on every row's block node."""
        for gi, v in zip(self.rows.tolist(), values.cpu().numpy().tolist()):
            self.tracer.block(gi).add(key, float(v))

    def passes(self, recs, partition_count: int, plane_count: int, active,
               only_always: bool = False, plane_component=None,
               partition_index=None):
        """One pass node per active row, with one candidate node per
        candidate that has a record (compress.py:202; reference:
        astcenc_compress_symbolic.cpp:506-676, 1295-1429)."""
        bsd, K = self.bsd, self.K
        err = recs["err"].cpu().numpy()
        mode = recs["mode"].cpu().numpy()
        act = active.cpu().numpy()
        pidx = (None if partition_index is None
                else partition_index.cpu().numpy())
        bm_index = {int(m): i for i, m in enumerate(bsd.bm_mode_index)}
        wdims = bsd.dm_weight_dims
        C = err.shape[1] // K
        for n in np.nonzero(act)[0].tolist():
            p = self.tracer.block(int(self.rows[n])).child("pass")
            p.add("partition_count", int(partition_count))
            p.add("plane_count", int(plane_count))
            if plane_component is not None:
                p.add("plane_component", int(plane_component))
            if pidx is not None:
                p.add("partition_index", int(pidx[n]))
            if only_always:
                p.add("search_mode", "only_always")
            for c in range(C):
                errs = err[n, c * K:(c + 1) * K]
                if not np.any(errs < 1e29):
                    continue
                cn = p.child("candidate")
                bi = bm_index.get(int(mode[n, c * K]))
                if bi is not None:
                    wx, wy, wz = wdims[bsd.bm_decimation_mode[bi]]
                    cn.add("weight_x", int(wx))
                    cn.add("weight_y", int(wy))
                    cn.add("weight_z", int(wz))
                    cn.add("weight_quant", int(bsd.bm_quant_mode[bi]))
                cn.add("error_prerealign", float(errs[0]))
                for e in errs[1:].tolist():
                    cn.add("error_postrealign", float(e))


def _u8_mask(cfg) -> bool:
    return (int(cfg.profile) == int(Profile.LDR_SRGB)
            or bool(cfg.flags & Flags.USE_DECODE_UNORM8))


def _sub(d: dict, idx) -> dict:
    """Rows ``idx`` of every per-block tensor of a dict."""
    return {k: (v[idx] if torch.is_tensor(v) and v.dim() else v)
            for k, v in d.items()}


def _scatter(full: dict, idx, part: dict) -> dict:
    """``full`` with rows ``idx`` of every per-block tensor replaced."""
    out = dict(full)
    for k, v in part.items():
        if torch.is_tensor(v) and v.dim():
            t = full[k].clone()
            t[idx] = v
            out[k] = t
    return out


def stage1_1plane(ctx, texels, trace=None):
    """Block state, constant detection and the 1-partition 1-plane passes
    (compress.py:290-411). Returns (scb, aux); aux holds what the later
    stages and finalize read: the block state, the error threshold, the
    weight-quant limit and best error the later trials use, and the
    2-plane gate. ``trace``: a ``_Trace`` or None."""
    cfg = ctx.config
    et = ctx.encoder_tables()
    dt = ctx.torch_decode_tables()
    profile = int(cfg.profile)
    dev = texels.device
    N, T, _ = texels.shape
    st = make_block_state(texels, profile,
                          bool(cfg.flags & Flags.USE_ALPHA_WEIGHT))
    is_const = (st["data_min"] == st["data_max"]).all(1)
    tex0 = texels[:, 0]
    if profile >= int(Profile.HDR_RGB_LDR_A):
        # FP16 constant colour (reference :1224-1231): LNS lanes through
        # fp16, the UNORM16 alpha of profile 2 as a value in [0, 1].
        wait = obs.on and obs.sync("compress.lns_lanes", "h2d")
        lns = torch.tensor([True, True, True, profile == int(Profile.HDR)],
                           device=dev)
        if wait:
            obs.end(wait, lns.nbytes)
        const_color = torch.where(
            lns, sf.lns_to_sf16(tex0.to(torch.int32)),
            sf.float_to_float16(sf.div(tex0, 65535.0)))
    else:
        const_color = torch.floor(torch.clamp(tex0 / 65535.0, 0.0, 1.0)
                                  * 65535.0 + 0.5).to(torch.int32)

    # error_weight_sum (reference :1204), per block under USE_ALPHA_WEIGHT.
    cw = trial.effective_cw(cfg, st)
    ews = (sf.sum4(cw) * T if torch.is_tensor(cw) else float(sum(cw)) * T)
    l_scale = torch.where(st["is_luminance"], 1.0 / 1.5, 1.0)
    la_scale = torch.where(st["is_luminancealpha"], 1.0 / 1.05, 1.0)
    error_threshold = cfg.tune_db_limit * ews * l_scale * la_scale
    overshoot = 1.0 / cfg.tune_mse_overshoot
    if trace is not None:
        trace.blocks(st, error_threshold, is_const)

    scb = trial.empty_scb(N, T, dev)
    scb["finished"] = is_const
    pindex = torch.zeros((N,), dtype=torch.int32, device=dev)
    start_trial = 1
    if (cfg.tune_search_mode0_enable >= TUNE_MIN_SEARCH_MODE0
            and ctx.bsd.dim[2] == 1):
        start_trial = 0
    errorval_mult = (overshoot, 1.0)
    # Both passes search the full weight-quant range; each winner's quant
    # limits the later stages (astcenc_compress_symbolic.cpp:1292-1318).
    full_limit = torch.full((N,), trial.QUANT_32, dtype=torch.int32,
                            device=dev)
    quant_limit = full_limit
    best0 = torch.full((N,), ERROR_CALC_DEFAULT, device=dev)
    for i in range(start_trial, 2):
        thr1 = error_threshold * errorval_mult[i] * overshoot
        recs = trial.trial1_records(
            st, ctx.pass_tables("always" if i == 0 else "full"), cfg,
            profile, _u8_mask(cfg), full_limit, ~scb["finished"])
        if trace is not None:
            trace.passes(recs, 1, 1, ~scb["finished"], only_always=(i == 0))
        scb, errv = trial.apply_records_1plane(scb, recs, thr1, 1, pindex)
        won = ~scb["block_type_error"]
        pk = dt.block_mode_packed_index[
            scb["block_mode"].clamp(0, 2047).to(torch.int64)]
        wq = dt.bm_quant[pk.clamp(0, dt.bm_quant.shape[0] - 1)
                         .to(torch.int64)]
        quant_limit = torch.where(won, wq, quant_limit)
        best0 = torch.minimum(best0, errv)
        scb["finished"] = scb["finished"] | (
            errv < error_threshold * errorval_mult[i])

    lowest_correl = None
    if et.m2_quant.shape[0] > 0:
        lowest_correl = _lowest_correlation(texels, cw)
        skip2p = lowest_correl > cfg.tune_2plane_early_out_limit_correlation
    else:
        skip2p = torch.ones((N,), dtype=torch.bool, device=dev)
    aux = {"is_const": is_const, "const_color": const_color, "st": st,
           "error_threshold": error_threshold, "overshoot": overshoot,
           "quant_limit": quant_limit, "best0": best0, "skip2p": skip2p,
           "lowest_correl": lowest_correl}
    return scb, aux


def stage2a_2plane(ctx, st, scb, quant_limit, best0, error_threshold,
                   overshoot: float, trace=None):
    """1-partition 2-plane trials (compress.py:432-494) on blocks the
    correlation gate left eligible: the four plane-2 components in one
    folded batch, then per component the reference's sequential take and
    early-outs (a block stops trying components once one comes out 1.85x
    worse than its best 1-plane error)."""
    cfg = ctx.config
    N = st["texels"].shape[0]
    dev = st["texels"].device
    cand_act = []
    for comp in trial.COMP_ORDER:
        a = ~(st["data_min"][:, comp] == st["data_max"][:, comp])
        if comp != 3:
            a = a & ~st["grayscale"]
        cand_act.append(a)
    ext_valid = torch.stack(cand_act, 1) & ~scb["finished"][:, None]
    recs = trial.trial2_records(st, ctx.pass_tables("two"), cfg,
                                int(cfg.profile), _u8_mask(cfg), quant_limit,
                                ext_valid)
    stopped = torch.zeros((N,), dtype=torch.bool, device=dev)
    for i, comp in enumerate(trial.COMP_ORDER):
        recs_i = {k: v.reshape((4, N) + tuple(v.shape[1:]))[i]
                  for k, v in recs.items()}
        active = cand_act[i] & ~stopped & ~scb["finished"]
        if trace is not None:
            trace.passes(recs_i, 1, 2, active, plane_component=comp)
        p2c = torch.full((N,), comp, dtype=torch.int32, device=dev)
        scb, errv = trial.apply_records_2plane(
            scb, recs_i, error_threshold * overshoot, p2c, active)
        errv = torch.where(active, errv, ERROR_CALC_DEFAULT)
        stopped = stopped | (active & (errv > best0 * 1.85))
        scb["finished"] = scb["finished"] | (active
                                             & (errv < error_threshold))
    return scb


def _req_index(cfg, pc: int) -> int:
    return (cfg.tune_2partition_index_limit, cfg.tune_3partition_index_limit,
            cfg.tune_4partition_index_limit)[pc - 2]


def _req_trials(cfg, pc: int) -> int:
    return (cfg.tune_2partitioning_candidate_limit,
            cfg.tune_3partitioning_candidate_limit,
            cfg.tune_4partitioning_candidate_limit)[pc - 2]


def multipart_pcs(ctx) -> tuple:
    """Partition counts with selected partitionings and a trial budget
    (compress.py:517-530)."""
    cfg = ctx.config
    return tuple(
        pc for pc in range(2, cfg.tune_partition_count_limit + 1)
        if ctx.bsd.partitionings[pc]["count_selected"]
        and min(_req_trials(cfg, pc), _req_index(cfg, pc)))


def stage2b_one_pc(ctx, st, scb, quant_limit, best_prev, pc: int,
                   error_threshold, overshoot: float, trace=None):
    """One partition count of the multi-partition search
    (compress.py:533-619): rank the partitionings, try the best few in one
    folded batch, replay the sequential take with the inner early-outs,
    then the outer early-out against the previous count's best error.
    Returns (scb, best error of this count)."""
    cfg = ctx.config
    N, T, _ = st["texels"].shape
    dev = st["texels"].device
    exit_factor = (0.0, cfg.tune_2partition_early_out_limit_factor,
                   cfg.tune_3partition_early_out_limit_factor, 0.0)[pc - 1]
    ntrials = min(_req_trials(cfg, pc), _req_index(cfg, pc))
    tabs = ctx.partition_tables(pc)
    seeds, valid = partition_search.find_best_partition_candidates(
        st, tabs, T, trial.config_cw(cfg), pc, _req_index(cfg, pc),
        ntrials)
    ntr = min(ntrials, seeds.shape[1])
    rows = tabs.packed_index[seeds[:, :ntr].clamp(0, 1023).to(torch.int64)
                             ].clamp(0, tabs.pot.shape[0] - 1)
    rows = rows.T.reshape(ntr * N)                 # trial-major folding
    st_f = {k: (v.repeat((ntr,) + (1,) * (v.dim() - 1))
                if torch.is_tensor(v) else v) for k, v in st.items()}
    ext = (valid[:, :ntr] & ~scb["finished"][:, None]).T.reshape(ntr * N)
    recs = trial.trial1_records(
        st_f, ctx.pass_tables("full", pc), cfg, int(cfg.profile),
        _u8_mask(cfg), quant_limit.repeat(ntr), ext, pot=tabs.pot[rows],
        counts=tabs.counts[rows])
    best_this = torch.full((N,), ERROR_CALC_DEFAULT, device=dev)
    for ti in range(ntr):
        recs_i = {k: v.reshape((ntr, N) + tuple(v.shape[1:]))[ti]
                  for k, v in recs.items()}
        ok = valid[:, ti]
        if trace is not None:
            trace.passes(recs_i, pc, 1, ok & ~scb["finished"],
                         partition_index=seeds[:, ti])
        saved = scb["finished"]
        scb = dict(scb)
        scb["finished"] = saved | ~ok
        scb, errv = trial.apply_records_1plane(
            scb, recs_i, error_threshold * overshoot, pc, seeds[:, ti])
        errv = torch.where(ok, errv, ERROR_CALC_DEFAULT)
        best_this = torch.minimum(best_this, errv)
        stop_in = best_this > best_prev * (exit_factor * 1.85)
        scb["finished"] = saved | (ok & (stop_in | (errv < error_threshold)))
    scb["finished"] = scb["finished"] | (best_this > best_prev * exit_factor)
    return scb, best_this


def finalize_pack(dt, et, scb, aux, profile: int):
    """Fallback/constant-block selection + physical pack
    (compress.py:622-646): constant blocks are UNORM16 void-extent blocks
    in the LDR profiles and FP16 ones in the HDR profiles; blocks no trial
    encoded become UNORM16 void-extent blocks."""
    is_const = aux["is_const"]
    scb = dict(scb)
    fallback = scb["block_type_error"] & ~is_const
    hdr = profile >= int(Profile.HDR_RGB_LDR_A)
    scb["const_u16"] = fallback if hdr else is_const | fallback
    scb["const_f16"] = is_const if hdr else torch.zeros_like(is_const)
    scb["constant_color"] = aux["const_color"]
    err_lane = scb["block_type_error"]
    scb["block_mode"] = torch.where(err_lane, int(et.m1_mode_index[0]),
                                    scb["block_mode"])
    scb["quant_mode"] = torch.where(err_lane, 4, scb["quant_mode"])
    scb["partition_count"] = torch.where(err_lane, 1,
                                         scb["partition_count"])
    return physical.symbolic_to_physical_batch(dt, scb)


def _nonzero(mask, site: str):
    """Indices of the set entries of a device mask; the host waits on the
    device for their count."""
    wait = obs.on and obs.sync(site)
    idx = torch.nonzero(mask)[:, 0]
    if wait:
        obs.end(wait)
    return idx


def compress_symbolic(ctx, texels, trace=None):
    """Stage 1 -> 2a -> 2b on one chunk of (N, T, 4) float32 texels on
    ctx.device (compress.py:268-286). Returns (scb, aux) before the
    finalize step. ``trace``: a ``_Trace`` over the chunk's rows, or
    None."""
    cfg = ctx.config
    N = texels.shape[0]
    sp = obs.on and obs.begin("stage1", blocks=N)
    scb, aux = stage1_1plane(ctx, texels, trace=trace)
    if sp:
        obs.end(sp)
        obs.count("blocks.stage1", N)
        obs.count_device("blocks.const", aux["is_const"].sum())
    st = aux["st"]
    thr, ovs = aux["error_threshold"], aux["overshoot"]
    ql, best0 = aux["quant_limit"], aux["best0"]
    if ctx.encoder_tables().m2_quant.shape[0] > 0:
        if trace is not None:
            trace.value("lowest_correl", aux["lowest_correl"])
        sp = obs.on and obs.begin("stage2a")
        idx = _nonzero(~scb["finished"] & ~aux["skip2p"],
                       "compress.stage2a.nonzero")
        if idx.numel():
            sub = stage2a_2plane(ctx, _sub(st, idx), _sub(scb, idx), ql[idx],
                                 best0[idx], thr[idx], ovs,
                                 trace=trace and trace.sub(idx))
            scb = _scatter(scb, idx, sub)
        if sp:
            sp.attrs["blocks"] = idx.numel()
            obs.end(sp)
            obs.count("blocks.stage2a", idx.numel())
    pcs = multipart_pcs(ctx)
    best_prev = best0
    for pc in range(2, cfg.tune_partition_count_limit + 1):
        best_this = torch.full_like(best0, ERROR_CALC_DEFAULT)
        if pc in pcs:
            sp = obs.on and obs.begin("stage2b", pc=pc)
            idx = _nonzero(~scb["finished"], "compress.stage2b.nonzero")
            if idx.numel():
                sub, bt = stage2b_one_pc(
                    ctx, _sub(st, idx), _sub(scb, idx), ql[idx],
                    best_prev[idx], pc, thr[idx], ovs,
                    trace=trace and trace.sub(idx))
                scb = _scatter(scb, idx, sub)
                best_this[idx] = bt
            if sp:
                sp.attrs["blocks"] = idx.numel()
                obs.end(sp)
                obs.count(f"blocks.stage2b.pc{pc}", idx.numel())
        # A skipped count leaves the next one the default baseline.
        best_prev = best_this
    return scb, aux


def compress_blocks(ctx, texels, trace=None):
    """Compress one chunk of (N, T, 4) float32 texels on ctx.device to
    (N, 16) uint8 blocks."""
    scb, aux = compress_symbolic(ctx, texels, trace=trace)
    sp = obs.on and obs.begin("finalize", blocks=texels.shape[0])
    out = finalize_pack(ctx.torch_decode_tables(), ctx.encoder_tables(),
                        scb, aux, int(ctx.config.profile))
    if sp:
        obs.end(sp)
    return out


def blockify(data: np.ndarray, block_dims) -> np.ndarray:
    """(Z, H, W, 4) float32 -> (N, T, 4) edge-clamped blocks in raster
    order (compress.py:1068-1075)."""
    bx, by, bz = block_dims
    Z, H, W, _ = data.shape
    nx, ny, nz = -(-W // bx), -(-H // by), -(-Z // bz)
    idx_x = np.minimum(np.arange(nx * bx), W - 1)
    idx_y = np.minimum(np.arange(ny * by), H - 1)
    idx_z = np.minimum(np.arange(nz * bz), Z - 1)
    padded = data[np.ix_(idx_z, idx_y, idx_x)]
    blocks = padded.reshape(nz, bz, ny, by, nx, bx, 4)
    return np.ascontiguousarray(blocks.transpose(0, 2, 4, 1, 3, 5, 6).reshape(
        nz * ny * nx, bz * by * bx, 4))


def _encode_unorm_sanitized(f: np.ndarray) -> np.ndarray:
    """Unorm-encode float input to [0, 65535]; NaN maps to 0."""
    return np.fmin(np.fmax(f * 65535.0, 0.0), 65535.0)


def _apply_load_swizzle(image, swizzle):
    if tuple(swizzle) == (0, 1, 2, 3):
        return image
    one = 255 if image.dtype == np.uint8 else 1.0
    chans = {0: image[..., 0], 1: image[..., 1], 2: image[..., 2],
             3: image[..., 3], 4: np.zeros_like(image[..., 0]),
             5: np.full_like(image[..., 0], one)}
    return np.stack([chans[s] for s in swizzle], axis=-1)


def _xla_cumsum(x: np.ndarray) -> np.ndarray:
    """Inclusive float32 prefix sums of ``x`` along axis 0 in XLA:CPU's
    order of ``jnp.cumsum``: runs of 16 (the last padded with zeros), each
    summed in sequence, the run totals scanned the same way, and each run's
    exclusive prefix of the totals added to it."""
    n = x.shape[0]
    if n <= 16:
        return np.cumsum(x, axis=0, dtype=np.float32)
    m = -(-n // 16)
    runs = np.concatenate(
        [x, np.zeros((m * 16 - n,) + x.shape[1:], np.float32)]
    ).reshape((m, 16) + x.shape[1:])
    inner = np.cumsum(runs, axis=1, dtype=np.float32)
    totals = _xla_cumsum(inner[:, -1])
    before = np.concatenate([np.zeros_like(totals[:1]), totals[:-1]])
    return (inner + before[:, None]).reshape((m * 16,) + x.shape[1:])[:n]


def _alpha_zero_blocks(alpha, bx, by, radius, nx, ny) -> np.ndarray:
    """(ny * nx,) mask of the blocks whose footprint, grown by ``radius``,
    holds ~zero alpha (compress.py:1184-1215; reference: the summed-area
    table of astcenc_compute_variance.cpp:48-505 and the zero-block
    substitution of astcenc_entry.cpp:974-1035). ``alpha`` is the (H, W)
    UNORM16 alpha plane. Float32 on the host, summed in XLA:CPU's order
    (``_xla_cumsum``) so that the mask is JAX's bit for bit: on a large
    plane the table's rounding decides blocks near the threshold."""
    a01 = np.asarray(alpha, np.float32) / np.float32(65535.0)
    r = radius
    ap = np.pad(a01, ((r, r + 1), (r, r + 1)), mode="edge")
    sat = _xla_cumsum(_xla_cumsum(ap).T).T
    sat = np.pad(sat, ((1, 0), (1, 0)))
    H, W = a01.shape
    k = 2 * r + 1
    # Window sum of the (2r+1)^2 neighbourhood centred at each texel.
    win = (((sat[k:k + H, k:k + W] - sat[k:k + H, :W]) - sat[:H, k:k + W])
           + sat[:H, :W])
    avg = win / np.float32(k * k)
    xf = bx + 2 * (r - 1)
    yf = by + 2 * (r - 1)
    has_alpha = avg > np.float32(0.9 / (255.0 * float(xf * yf)))
    hp = np.pad(has_alpha, ((0, ny * by - H), (0, nx * bx - W)))
    return ~hp.reshape(ny, by, nx, bx).any(axis=(1, 3)).reshape(-1)


def image_to_blocks(ctx, image, swizzle=(0, 1, 2, 3)) -> np.ndarray:
    """Host side of compress_image: channel fill, swizzle, UNORM16 scale,
    alpha-scale RDO, blockify. Returns (N, T, 4) float32."""
    image = np.asarray(image)
    if image.ndim == 3:
        image = image[None]
    C = image.shape[-1]
    if C < 4:
        pad = np.zeros(image.shape[:-1] + (4 - C,), image.dtype)
        if C == 3:
            pad[...] = 255 if image.dtype == np.uint8 else 1.0
        image = np.concatenate([image, pad], axis=-1)
    image = _apply_load_swizzle(image, swizzle)
    profile = int(ctx.config.profile)
    if image.dtype == np.uint8:
        data = image.astype(np.float32) * (65535.0 / 255.0)
    elif profile >= int(Profile.HDR_RGB_LDR_A):
        # HDR profiles load RGB, and alpha in profile 3, as LNS codes; the
        # alpha of profile 2 stays UNORM16 (compress.py:1034-1043,
        # reference astcenc_image.cpp:192-219).
        f = image.astype(np.float32)
        data = sf.float_to_lns(torch.from_numpy(f)).numpy()
        if profile == int(Profile.HDR_RGB_LDR_A):
            data[..., 3] = _encode_unorm_sanitized(f[..., 3])
    else:
        data = _encode_unorm_sanitized(image.astype(np.float32))
    blocks = blockify(data.astype(np.float32), ctx.block_dims)
    # Alpha-scale RDO, 2D only: blocks with ~zero alpha around them become
    # transparent black before the encode (compress.py:1051-1059).
    bx, by, bz = ctx.block_dims
    Z, H, W = data.shape[:3]
    radius = int(ctx.config.a_scale_radius)
    if radius != 0 and bz == 1 and Z == 1:
        zero = _alpha_zero_blocks(data[0, :, :, 3], bx, by, radius,
                                  -(-W // bx), -(-H // by))
        blocks[zero] = 0.0
    return blocks


def _trace_positions(tracer, rows, block_dims, shape):
    """The texel position of each block of ``rows`` (compress.py:1104-1116)
    for an image of ``shape`` ((H, W, C) or (Z, H, W, C))."""
    bx, by, bz = block_dims
    H, W = shape[-3], shape[-2]
    nx, ny = -(-W // bx), -(-H // by)
    for gi in rows.tolist():
        tracer.positions[gi] = ((gi % nx) * bx, ((gi // nx) % ny) * by,
                                (gi // (nx * ny)) * bz)


def compress_image(ctx, image, swizzle=(0, 1, 2, 3), progress_callback=None,
                   tracer=None):
    """Compress an image array to (N, 16) uint8 blocks in raster order.

    ``ASTC_DISABLE_KERNELS`` is read once per call
    (``ops._build.kernel_scope``); inside ``ops._build.plain()`` every
    kernel's plain version runs, for comparison on the card. The call
    clears the context's cancel flag at its start and reads it before each
    chunk: once it is set (``api.compress_cancel``), the blocks of the
    chunks not started come back as zero bytes (compress.py:1086-1095).
    ``tracer``
    (``codec.trace.Tracer``), if given, receives one block node per block
    with its position, and the pass and candidate nodes of each stage that
    block ran (compress.py:1104-1116); the blocks are the untraced ones.
    """
    ctx.cancel_requested = False
    with _build.kernel_scope():
        sp = obs.on and obs.call("compress_image")
        pp = obs.on and obs.begin("image_to_blocks")
        blocks = image_to_blocks(ctx, image, swizzle)
        if pp:
            obs.end(pp)
        n = blocks.shape[0]
        if sp:
            shape = np.shape(image)
            sp.attrs.update(texels=int(np.prod(shape[:-1])), blocks=n,
                            chunks=-(-n // CHUNK))
        outs = []
        for lo in range(0, n, CHUNK):
            if ctx.cancel_requested:
                outs.append(torch.zeros((n - lo, 16), dtype=torch.uint8))
                break
            cp = obs.on and obs.begin("chunk", first=lo,
                                      blocks=min(CHUNK, n - lo))
            tex = _copy(torch.from_numpy(blocks[lo:lo + CHUNK]), ctx.device,
                        "h2d")
            trace = None
            if tracer is not None:
                trace = _Trace(tracer, np.arange(lo, lo + tex.shape[0]),
                               ctx.bsd, ctx.config.tune_refinement_limit + 1)
                _trace_positions(tracer, trace.rows, ctx.block_dims,
                                 np.asarray(image).shape)
            out = compress_blocks(ctx, tex, trace=trace)
            outs.append(_copy(out, "cpu", "d2h"))
            if cp:
                obs.end(cp)
            if progress_callback is not None:
                progress_callback(min(100.0, 100.0 * min(lo + CHUNK, n) / n))
        ap = obs.on and obs.begin("assemble")
        out = torch.cat(outs).numpy()
        if ap:
            obs.end(ap)
        if sp:
            obs.end(sp)
        return out


def _copy(t, device, way: str):
    """``t`` on ``device``: the chunk's blocking copy of its texels to the
    device ("h2d") or of its blocks back ("d2h"), in a span of its own."""
    if not obs.on:
        return t.to(device)
    sp = obs.begin(way, bytes=t.nbytes)
    wait = obs.sync(f"compress.chunk_{way}", way)
    out = t.to(device)
    obs.end(wait, t.nbytes)
    obs.end(sp)
    return out
