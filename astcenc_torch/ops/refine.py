"""Refinement rounds of a trial: kernels K2 (1 plane) and K3 (2 planes)
for the LDR profiles, K5 (1 plane), K6 and K7 (2 planes) for one round of
the HDR profiles, and their plain versions.

K5 replaces ``refine_pallas.py::_refine_kernel`` (:184, launched by
``_refine_call`` :1368/:1381 from ``refine_round_1plane``); K6 and K7
replace ``_refine2_kernel`` (:1090) and ``_refine2_boot_kernel`` (:1244),
launched by ``_refine2_call`` (:1275/:1289) from ``refine_round_2plane``.
K6 keeps K3's layout (``csrc/refine_round2.cu``: a texel row per CTA,
the two planes realigned at once on half-warps); K5 runs one candidate
per half-warp (``csrc/refine_round.cu``). Both share K2's and K3's trial
error and realign step (``csrc/refine_common.cuh``); the refit, the
pack and the decode run between the rounds in PyTorch
(``_rounds_1plane``, ``_rounds_2plane``).

K2 replaces the TPU kernel
``astcenc_tpu/ops/refine_pallas.py::_trial1_full_kernel`` (:348, launched
by ``_trial1_full_call`` :603/:616 from ``trial1_refine_full`` :639); K3
replaces ``_trial2_full_kernel`` (:689, launched by ``_trial2_full_call``
:982/:995). For each (block, candidate) lane and each of R rounds they
infill the weight grid(s), refit the endpoints by least squares, pack them
in the requested LDR format, decode them, take the trial error before
(round 0) and after a parity-class realign of the grid(s), and drop lanes
whose realign changed nothing. K2 handles 1-4 partitions, with the
matched-format second pack for 2-4 (every partition in one format at the
quant level the shared format field frees); K3 one partition and two
planes, both realigned against one stencil, each under its plane mask.

On the card (``csrc/refine.cu``, ``csrc/refine2.cu``; the pack, decode,
trial error and realign step live in ``csrc/refine_common.cuh``) texels,
per-texel decoded endpoints and the grids sit in shared memory, the texel
reductions are warp shuffles, and the stencil sums use the sparse form of
the decimation stencils (at most 4 taps per texel, and per-weight texel
lists for the transposed sums). The R rounds stay in one launch. K2 runs
one CTA per block and one warp per candidate: the block's texels and the
round-independent refit terms of its partitions are loaded and computed
once per CTA; a warp takes all its partitions' refit sums in one pass over
the texels, and its lanes solve, pack (the matched-format packs beside the
plain ones) and decode the partitions side by side. K3 runs one CTA per
texel row and a warp per (plane-2 component, candidate) pair that reads
it: the row's texels and RGB-scale projection are shared, lanes 0-4 solve
the channels and the RGB-scale line side by side, lanes 0-3 run the trials
of an RGB(A) pack, and the two planes realign at once on the two halves of
the warp. The work is a long chain of dependent scalar and warp-reduction
steps per lane: the kernels are latency bound, and rely on many resident
warps to hide that latency.

Each kernel has a form with per-block channel weights (USE_ALPHA_WEIGHT:
``cw_scale``, each block's alpha scale, times the config's R, G and B
weights, as ``refine_pallas.py::_asr_cw`` takes them; a null scale is the
static form) and K2, K3, K5 and K6 one with the RGBM trial metric
(``rgbm``, the M scale; ``refine_pallas.py::_err_from_colors``). K7 reads
no weight: its one form serves both.

One rounds driver per plane count (``_rounds_1plane``, ``_rounds_2plane``)
serves every path that is not K2 or K3: each round refits in PyTorch,
packs, decodes and then runs one round, K5/K6/K7 or its plain version.
With the plain round it is the plain version of K2 and K3
(``trial1_refine_plain``, ``trial2_refine_plain``), the XLA refine loops
of ``trial.py:660-721`` (1 plane) and ``:1227-1288`` (2 planes); with the
round router it is the HDR path and the path of the ``refine`` family
switched off (``_build.use_kernel``). On the card the plain rounds still
look their realign rows up through K8, pack through the colour pack kernel
K9 and decode through the colour decode kernel, as the JAX package's XLA
branches run their gathers on the TPU; inside ``_build.plain()`` they are
plain throughout.
"""

from __future__ import annotations

import ctypes

import torch

from .. import obs
from . import _build
from . import color_pack_hdr as cph
from . import color_unquant as cuq
from . import ideal as ideal_ops
from . import realign as realign_ops
from . import recompute as recompute_ops

_BIG = 1e30


def _count_launch(kernel: str, cw_scale, rgbm: float) -> None:
    """Count a launch of ``kernel`` (``launch.<kernel>``) and of its
    weighted or RGBM form (``launch.<kernel>.<form>``, form "asr", "rgbm"
    or "asr+rgbm")."""
    obs.count("launch." + kernel)
    parts = [name for name, on in (("asr", cw_scale is not None),
                                   ("rgbm", rgbm > 0.0)) if on]
    if parts:
        obs.count(f"launch.{kernel}.{'+'.join(parts)}")


def lane_cw(cw, cw_scale, C: int):
    """Channel weights of each lane (lane i of block i // C): the static
    tuple, or (NC, 4) per-block weights (``ideal.block_channel_weights``)."""
    w = ideal_ops.block_channel_weights(cw, cw_scale)
    return w.repeat_interleave(C, 0) if torch.is_tensor(w) else w


def _chan(cw, c):
    """Weight of channel c against (N, T) terms."""
    return cw[:, c, None] if torch.is_tensor(cw) else float(cw[c])


def _color_err(texels, color, cw, u8_mask: bool, rgbm: float = 0.0):
    """Summed trial error, in the kernels' order: channels in sequence per
    texel, texels by ``lane_sum`` (csrc/refine_common.cuh::trial_error).
    ``rgbm`` > 0: the RGBM metric (JAX trial.py:186-205), RGB compared
    after multiplying each by its texel's M and the scale, and
    ERROR_CALC_DEFAULT where any texel's decoded M is 0."""
    if u8_mask:
        color = torch.floor(color / 256.0) * 257.0
    if rgbm > 0.0:
        m = color[..., 3]
        err_t = None
        for c in range(3):
            dec = color[..., c] * m * rgbm
            org = texels[..., c] * texels[..., 3] * rgbm
            dd = torch.clamp((org - dec).abs(), max=1e15)
            term = dd * dd * _chan(cw, c)
            err_t = term if err_t is None else err_t + term
        err = recompute_ops.lane_sum(torch.clamp(err_t, max=1e30), -1)
        return torch.where((m == 0.0).any(-1), _BIG, err)
    d = torch.clamp((texels - color).abs(), max=1e15)
    dd = d * d
    err_t = dd[..., 0] * _chan(cw, 0)
    for c in range(1, 4):
        err_t = err_t + dd[..., c] * _chan(cw, c)
    return recompute_ops.lane_sum(torch.clamp(err_t, max=1e30), -1)


def _infill(Mint, wgrid):
    return ((8 + torch.einsum("ntw,nw->nt", Mint, wgrid.to(torch.float32)))
            .to(torch.int32) >> 4).to(torch.float32)


def trial_error_1plane(texels, wgrid, Mint, ep0_t, ep1_t, cw, u8_mask: bool,
                       rgbm: float = 0.0):
    """compute_symbolic_block_difference_1plane for per-texel endpoints
    (reference astcenc_decompress_symbolic.cpp:407-618). (N,)."""
    w = _infill(Mint, wgrid)[..., None]
    color = torch.floor((ep0_t * (64.0 - w) + ep1_t * w + 32.0) / 64.0)
    return _color_err(texels, color, cw, u8_mask, rgbm)


def trial_error_2plane(texels, wgrid1, wgrid2, p2c, Mint, ep0, ep1, cw,
                       u8_mask: bool, rgbm: float = 0.0):
    """compute_symbolic_block_difference_2plane, 1 partition (port of
    ``astcenc_tpu/codec/trial.py:238``); ep0/ep1 (N, 4) decoded. (N,)."""
    w1 = _infill(Mint, wgrid1)
    w2 = _infill(Mint, wgrid2)
    use2 = torch.arange(4, device=texels.device)[None, None, :] \
        == p2c[:, None, None]
    w = torch.where(use2, w2[..., None], w1[..., None])
    color = torch.floor((ep0[:, None, :] * (64.0 - w)
                         + ep1[:, None, :] * w + 32.0) / 64.0)
    return _color_err(texels, color, cw, u8_mask, rgbm)


def _lane_tables(pt, dm, wq):
    dml = dm.to(torch.int64)
    Mint = pt.dec_int[dml]
    Mf32 = pt.dec_f32[dml]
    return (Mint, Mf32, (Mint != 0).to(torch.float32), pt.wvalid[dml],
            pt.dm_color[dml], pt.weight_prev_next[wq.to(torch.int64)])


def pack_partitions(pack, cq, cqm, pc: int):
    """The pack of a pc-partition lane (JAX trial.py:556-594): ``pack(q)``
    packs every partition at colour quant q into (NC, pc) formats and
    (NC, pc, 8) values. For pc >= 2 a second, matched-format pack at cqm
    replaces the first where every partition kept one format and the
    matched pack does too. Returns fmt (NC, 4), vals (NC, 4, 8), the quant
    used (NC,) and matched (NC,) bool."""
    fmt_p, vals_p = pack(cq)
    NC = fmt_p.shape[0]
    matched = torch.zeros((NC,), dtype=torch.bool, device=fmt_p.device)
    use_q = cq
    if pc >= 2:
        all_same = (cq != cqm) & (fmt_p == fmt_p[:, :1]).all(1)
        fmt_m, vals_m = pack(cqm.clamp(4, 20))
        same_mod = (fmt_m == fmt_m[:, :1]).all(1)
        matched = all_same & same_mod & (cqm >= 4)
        fmt_p = torch.where(matched[:, None], fmt_m, fmt_p)
        vals_p = torch.where(matched[:, None, None], vals_m, vals_p)
        use_q = torch.where(matched, cqm, cq)
    fmt4 = torch.zeros((NC, 4), dtype=torch.int32, device=fmt_p.device)
    vals4 = torch.zeros((NC, 4, 8), dtype=torch.int32, device=fmt_p.device)
    fmt4[:, :pc] = fmt_p
    vals4[:, :pc] = vals_p
    return fmt4, vals4, use_q.to(torch.int32), matched


def _rounds_1plane(rnd, pt, wgrid0, dm, wq, alive, cq, cqm, fmt_req, texels,
                   pot, ep0, ep1, C: int, R: int, u8_mask: bool, cw: tuple,
                   profile: int, cw_scale=None, rgbm: float = 0.0):
    """The R rounds of a 1-plane trial (JAX trial.py:624-721): one
    bootstrap round (no realign) for the first infill, then per round the
    least-squares refit (with the RGBO vector under the HDR profiles), the
    pack of every partition (``pack_partitions``), the decode and one
    round ``rnd`` (``refine_round_1plane`` or its plain version), whose
    infill the next refit reads. Arguments and outputs as
    ``trial1_refine_plain``'s."""
    NC = wgrid0.shape[0]
    pc = fmt_req.shape[1]
    tex = texels.repeat_interleave(C, 0)
    pmask = ideal_ops.partition_onehot(pot)[..., :pc].repeat_interleave(C, 0)
    counts = pmask.sum(1)
    e0 = ep0.repeat_interleave(C, 0)
    e1 = ep1.repeat_interleave(C, 0)
    cw_l = lane_cw(cw, cw_scale, C)
    is_hdr = profile >= cuq.PRF_HDR_RGB_LDR_A

    def step(grid, alive, d0, d1, ncolors):
        return rnd(pt, grid, dm, wq, alive, d0, d1, texels, pot, C, ncolors,
                   u8_mask, cw, cw_scale=cw_scale, rgbm=rgbm)

    def lanes(x):
        return None if x is None else x.reshape(NC * pc, 4)

    zero = torch.zeros((NC, 4, 4), dtype=torch.int32, device=texels.device)
    undec = step(wgrid0, alive, zero, zero, 0)["undec"]
    wgrid = wgrid0
    out = {k: [] for k in ("fmt", "vals", "useq", "match", "wpost",
                           "err_post")}
    for r in range(R):
        rc = recompute_ops.recompute_ideal_colors_1plane(
            tex, pmask, counts, undec, cw_l, e0, e1, is_hdr=is_hdr)
        e0, e1 = rc["ep0"], rc["ep1"]

        def pack(q):
            f, v = cph.pack_color_endpoints(
                profile, lanes(e0), lanes(e1), lanes(rc["rgbs"]),
                lanes(rc.get("rgbo")), fmt_req.reshape(NC * pc),
                q.repeat_interleave(pc))
            return f.reshape(NC, pc), v.reshape(NC, pc, 8)

        fmt4, vals4, use_q, matched = pack_partitions(pack, cq, cqm, pc)
        d0, d1, _, _ = cuq.unpack_color_endpoints(profile, fmt4, vals4)
        res = step(wgrid, alive, d0.contiguous(), d1.contiguous(),
                   pt.ncolors)
        if r == 0:
            err_pre = torch.where(alive, res["err_pre"], _BIG)
        wgrid = torch.where(alive[:, None], res["grid"], wgrid)
        out["err_post"].append(torch.where(alive, res["err_post"], _BIG))
        alive = alive & res["adjusted"]
        undec = res["undec"]
        for k, v in (("fmt", fmt4), ("vals", vals4), ("useq", use_q),
                     ("match", matched), ("wpost", wgrid)):
            out[k].append(v)
    res = {k: torch.stack(v) for k, v in out.items()}
    res["err_pre"] = err_pre
    return res


def _rounds_2plane(rnd, pt, wg1_0, wg2_0, dm, wq, alive, cq, fmt_req, p2c,
                   texels, data_mean, ep0, ep1, C: int, R: int,
                   u8_mask: bool, cw: tuple, profile: int, cw_scale=None,
                   rgbm: float = 0.0):
    """The R rounds of a 2-plane trial (JAX trial.py:1192-1288): one
    bootstrap round for both first infills, then per round the 2-plane
    refit (with the RGBO vector under the HDR profiles), the pack, the
    decode and one round ``rnd`` (``refine_round_2plane`` or its plain
    version). Arguments and outputs as ``trial2_refine_plain``'s."""
    NC = wg1_0.shape[0]
    N = ep0.shape[0]
    dev = texels.device
    rows = torch.arange(N, device=dev) % texels.shape[0]
    tex = texels[rows].repeat_interleave(C, 0)
    mean = data_mean[rows].repeat_interleave(C, 0)
    p2c_f = p2c.repeat_interleave(C, 0)
    e0 = ep0.repeat_interleave(C, 0)
    e1 = ep1.repeat_interleave(C, 0)
    cw_l = lane_cw(cw, cw_scale, C)
    is_hdr = profile >= cuq.PRF_HDR_RGB_LDR_A

    def step(g1, g2, alive, d0, d1, ncolors):
        return rnd(pt, g1, g2, dm, wq, alive, p2c, d0, d1, texels, C,
                   ncolors, u8_mask, cw, cw_scale=cw_scale, rgbm=rgbm)

    zero = torch.zeros((NC, 4), dtype=torch.int32, device=dev)
    boot = step(wg1_0, wg2_0, alive, zero, zero, 0)
    u1, u2 = boot["undec1"], boot["undec2"]
    wg1, wg2 = wg1_0, wg2_0
    out = {k: [] for k in ("fmt", "vals", "w1post", "w2post", "err_post")}
    for r in range(R):
        rc = recompute_ops.recompute_ideal_colors_2planes(
            tex, u1, u2, p2c_f, cw_l, mean, e0, e1, is_hdr=is_hdr)
        e0, e1 = rc["ep0"], rc["ep1"]
        fmt, vals = cph.pack_color_endpoints(
            profile, e0, e1, rc["rgbs"], rc.get("rgbo"), fmt_req, cq)
        d0, d1, _, _ = cuq.unpack_color_endpoints(profile, fmt, vals)
        res = step(wg1, wg2, alive, d0.contiguous(), d1.contiguous(),
                   pt.ncolors)
        if r == 0:
            err_pre = torch.where(alive, res["err_pre"], _BIG)
        a = alive[:, None]
        wg1 = torch.where(a, res["grid1"], wg1)
        wg2 = torch.where(a, res["grid2"], wg2)
        out["err_post"].append(torch.where(alive, res["err_post"], _BIG))
        alive = alive & res["adjusted"]
        u1, u2 = res["undec1"], res["undec2"]
        for k, v in (("fmt", fmt), ("vals", vals), ("w1post", wg1),
                     ("w2post", wg2)):
            out[k].append(v)
    res = {k: torch.stack(v) for k, v in out.items()}
    res["err_pre"] = err_pre
    return res


def trial1_refine_plain(pt, wgrid0, dm, wq, alive, cq, cqm, fmt_req, texels,
                        pot, ep0, ep1, C: int, R: int, u8_mask: bool,
                        cw: tuple, profile: int, cw_scale=None,
                        rgbm: float = 0.0):
    """R refinement rounds for N*C lanes of a 1-plane trial, pc = 1..4:
    the rounds driver with the plain round, K2's plain version.

    Args:
      pt: pass tables (``codec.trial.pass_tables``).
      wgrid0: (NC, W) int32 starting grids; dm/wq/cq/cqm: (NC,) int32;
      fmt_req: (NC, pc) int32; alive: (NC,) bool; texels: (N, T, 4)
      float32; pot: (N, T) int32 partition of each texel; ep0/ep1:
      (N, pc, 4) ideal endpoints; lane i belongs to block i // C.
      cw: the config's channel weights; cw_scale: (N,) float32 alpha scale
      of each block (USE_ALPHA_WEIGHT) or None; rgbm: the RGBM scale of
      the trial error, or 0.

    Returns dict fmt (R, NC, 4), vals (R, NC, 4, 8), useq (R, NC), match
    (R, NC) bool, wpost (R, NC, W) int32; err_pre (NC,) and err_post
    (R, NC) float32, alive-masked to 1e30.
    """
    return _rounds_1plane(refine_round_1plane_plain, pt, wgrid0, dm, wq,
                          alive, cq, cqm, fmt_req, texels, pot, ep0, ep1, C,
                          R, u8_mask, cw, profile, cw_scale, rgbm)


def trial2_refine_plain(pt, wg1_0, wg2_0, dm, wq, alive, cq, fmt_req, p2c,
                        texels, data_mean, ep0, ep1, C: int, R: int,
                        u8_mask: bool, cw: tuple, profile: int,
                        cw_scale=None, rgbm: float = 0.0):
    """R refinement rounds for N*C lanes of a 2-plane, 1-partition trial:
    the rounds driver with the plain round, K3's plain version.

    Args:
      wg1_0/wg2_0: (NC, W) int32 starting grids of both planes;
      dm/wq/cq/fmt_req: (NC,) int32; alive: (NC,) bool; p2c: (N,) int32
      plane-2 component; texels: (N0, T, 4) and data_mean (N0, 4), where
      block b reads texel row b % N0 (the four plane-2 components of a
      block are four blocks); ep0/ep1: (N, 4) ideal endpoints; lane i
      belongs to block i // C; cw_scale: (N,) alpha scale of each block or
      None, and rgbm, as for ``trial1_refine_plain``.

    Returns dict fmt (R, NC), vals (R, NC, 8), w1post/w2post (R, NC, W)
    int32; err_pre (NC,) and err_post (R, NC) float32, alive-masked.
    """
    return _rounds_2plane(refine_round_2plane_plain, pt, wg1_0, wg2_0, dm,
                          wq, alive, cq, fmt_req, p2c, texels, data_mean,
                          ep0, ep1, C, R, u8_mask, cw, profile, cw_scale,
                          rgbm)


def _lib(name):
    lib = _build.load(name)
    if not getattr(lib, "_astc_typed", False):
        fn = getattr(lib, "astc_" + name)
        fn.restype = ctypes.c_int
        nptr = 19 if name == "refine" else 20
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * 11
                       + [ctypes.c_float] * 4
                       + [ctypes.c_void_p, ctypes.c_float]
                       + [ctypes.c_void_p] * 3)
        lib.astc_error_string.restype = ctypes.c_char_p
        lib.astc_error_string.argtypes = [ctypes.c_int]
        lib._astc_typed = True
    return lib


def _check_common(pt, W, T, R, profile, dev):
    if profile not in (cuq.PRF_LDR, cuq.PRF_LDR_SRGB):
        raise ValueError(f"profile {profile}: K2 and K3 take the LDR "
                         "profiles only; HDR rounds run through K5-K7")
    if not 1 <= R <= 8:
        raise ValueError(f"refinement count {R} outside 1..8")
    k = pt.k
    if W != k.wt_n.shape[1] or T != k.tap_w.shape[1]:
        raise ValueError("grid or texel count does not match the tables")
    if k.tap_w.device != dev:
        raise ValueError(f"pass tables on {k.tap_w.device}, inputs on {dev}")
    return k


def _scale_ptr(cw_scale, n: int):
    """The alpha scale operand of a launch: null for the static form."""
    if cw_scale is None:
        return None
    _build.check(cw_scale, "cw_scale", torch.float32, (n,))
    return _build.ptr(cw_scale)


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.astc_error_string(rc).decode())


def trial1_refine_cuda(pt, wgrid0, dm, wq, alive, cq, cqm, fmt_req, texels,
                       pot, ep0, ep1, C: int, R: int, u8_mask: bool,
                       cw: tuple, profile: int, cw_scale=None,
                       rgbm: float = 0.0):
    """Launch kernel K2; same arguments and outputs as the plain version."""
    NC, W = wgrid0.shape
    N, T, _ = texels.shape
    pc = fmt_req.shape[1]
    dev = texels.device
    k = _check_common(pt, W, T, R, profile, dev)
    f32, i32 = torch.float32, torch.int32
    if NC != N * C:
        raise ValueError(f"{NC} lanes for {N} blocks x {C} candidates")
    if not 1 <= C <= 8:
        raise ValueError(f"candidate count {C} outside 1..8")
    if not 1 <= pc <= 4:
        raise ValueError(f"partition count {pc} outside 1..4")
    _build.check(wgrid0, "wgrid0", i32, (NC, W))
    for name, t in (("dm", dm), ("wq", wq), ("cq", cq), ("cqm", cqm)):
        _build.check(t, name, i32, (NC,))
    _build.check(fmt_req, "fmt_req", i32, (NC, pc))
    _build.check(alive, "alive", torch.bool, (NC,))
    _build.check(texels, "texels", f32, (N, T, 4))
    _build.check(pot, "pot", i32, (N, T))
    _build.check(ep0, "ep0", f32, (N, pc, 4))
    _build.check(ep1, "ep1", f32, (N, pc, 4))
    scale = _scale_ptr(cw_scale, N)
    out_i = torch.empty((R, NC, 40 + W), dtype=i32, device=dev)
    out_e = torch.empty((R + 1, NC), dtype=f32, device=dev)
    lib = _lib("refine")
    if NC:
        p = _build.ptr
        rc = lib.astc_refine(
            p(wgrid0), p(dm), p(wq), p(alive), p(cq), p(cqm), p(fmt_req),
            p(texels), p(pot), p(ep0), p(ep1), p(k.tap_w), p(k.tap_i),
            p(k.wt_t), p(k.wt_i), p(k.wt_n), p(k.dm_color), p(k.pn),
            p(k.lohi), N, C, T, W, k.wt_n.shape[0], k.wt_t.shape[2], R, pc,
            pt.ncolors, int(u8_mask), profile, *(float(c) for c in cw),
            scale, float(rgbm), p(out_i), p(out_e),
            ctypes.c_void_p(_build.stream(dev.index)))
        _raise_on(lib, rc, "refine")
        if obs.on:
            _count_launch("refine", cw_scale, rgbm)
    return {"fmt": out_i[..., 0:4], "vals": out_i[..., 4:36].reshape(
                R, NC, 4, 8),
            "useq": out_i[..., 36], "match": out_i[..., 37] != 0,
            "wpost": out_i[..., 40:], "err_pre": out_e[0],
            "err_post": out_e[1:]}


def trial2_refine_cuda(pt, wg1_0, wg2_0, dm, wq, alive, cq, fmt_req, p2c,
                       texels, data_mean, ep0, ep1, C: int, R: int,
                       u8_mask: bool, cw: tuple, profile: int,
                       cw_scale=None, rgbm: float = 0.0):
    """Launch kernel K3; same arguments and outputs as the plain version."""
    NC, W = wg1_0.shape
    N0, T, _ = texels.shape
    N = ep0.shape[0]
    dev = texels.device
    k = _check_common(pt, W, T, R, profile, dev)
    f32, i32 = torch.float32, torch.int32
    if NC != N * C or (N0 and N % N0):
        raise ValueError(f"{NC} lanes for {N} blocks x {C} candidates "
                         f"over {N0} texel rows")
    if W > 63:
        raise ValueError(f"grid of {W} weights: K3 takes at most 63")
    if not 1 <= C <= 8:
        raise ValueError(f"candidate count {C} outside 1..8")
    for name, t in (("wg1_0", wg1_0), ("wg2_0", wg2_0)):
        _build.check(t, name, i32, (NC, W))
    for name, t in (("dm", dm), ("wq", wq), ("cq", cq),
                    ("fmt_req", fmt_req)):
        _build.check(t, name, i32, (NC,))
    _build.check(alive, "alive", torch.bool, (NC,))
    _build.check(p2c, "p2c", i32, (N,))
    _build.check(texels, "texels", f32, (N0, T, 4))
    _build.check(data_mean, "data_mean", f32, (N0, 4))
    _build.check(ep0, "ep0", f32, (N, 4))
    _build.check(ep1, "ep1", f32, (N, 4))
    scale = _scale_ptr(cw_scale, N)
    out_i = torch.empty((R, NC, 16 + 2 * W), dtype=i32, device=dev)
    out_e = torch.empty((R + 1, NC), dtype=f32, device=dev)
    lib = _lib("refine2")
    if NC:
        p = _build.ptr
        rc = lib.astc_refine2(
            p(wg1_0), p(wg2_0), p(dm), p(wq), p(alive), p(cq), p(fmt_req),
            p(p2c), p(texels), p(data_mean), p(ep0), p(ep1), p(k.tap_w),
            p(k.tap_i), p(k.wt_t), p(k.wt_i), p(k.wt_n), p(k.dm_color),
            p(k.pn), p(k.lohi), N, N0, C, T, W, k.wt_n.shape[0],
            k.wt_t.shape[2], R, pt.ncolors, int(u8_mask), profile,
            *(float(c) for c in cw), scale, float(rgbm), p(out_i), p(out_e),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _raise_on(lib, rc, "refine2")
        if obs.on:
            _count_launch("refine2", cw_scale, rgbm)
    return {"fmt": out_i[..., 0], "vals": out_i[..., 1:9],
            "w1post": out_i[..., 16:16 + W], "w2post": out_i[..., 16 + W:],
            "err_pre": out_e[0], "err_post": out_e[1:]}


# --- one refinement round: K5 (1 plane), K6 and K7 (2 planes) ---------------
# The HDR trials refit and pack in PyTorch between rounds (trial.py), so a
# round is one launch: the trial error of the incoming grid(s) against the
# decoded endpoints, the realign (lanes still alive only), the error after
# it and the infill the next refit needs. With ncolors == 0 (bootstrap) K5
# skips the realign; K7 is the 2-plane bootstrap, the two infills alone.

def refine_round_1plane_plain(pt, wgrid, dm, wq, alive, ep0, ep1, texels,
                              pot, C: int, ncolors: int, u8_mask: bool,
                              cw: tuple, cw_scale=None, rgbm: float = 0.0):
    """One 1-plane round (JAX trial.py:675-713 without the refit and
    pack) for NC lanes; lane i belongs to block i // C.

    Args:
      wgrid: (NC, W) int32 grids; dm/wq: (NC,) int32; alive: (NC,) bool;
      ep0/ep1: (NC, 4, 4) int32 decoded endpoints by partition and
      channel; texels: (N, T, 4) float32; pot: (N, T) int32 partition of
      each texel; ncolors: parity classes to realign (0: bootstrap);
      cw_scale: (N,) alpha scale of each block or None, and rgbm, as for
      ``trial1_refine_plain``.

    Returns dict grid (NC, W) int32 (realigned where alive), adjusted
    (NC,) bool, undec (NC, T) float32 infill of grid, err_pre and
    err_post (NC,) float32 trial errors of the incoming and the returned
    grid.
    """
    tex = texels.repeat_interleave(C, 0)
    idx = pot.to(torch.int64).repeat_interleave(C, 0)[..., None].expand(
        -1, -1, 4)
    ep0_t = torch.gather(ep0.to(torch.float32), 1, idx)
    ep1_t = torch.gather(ep1.to(torch.float32), 1, idx)
    cw = lane_cw(cw, cw_scale, C)
    Mint, Mf32, incid, wvalid, color_of, pn_rows = _lane_tables(pt, dm, wq)
    err_pre = trial_error_1plane(tex, wgrid, Mint, ep0_t, ep1_t, cw, u8_mask,
                                 rgbm)
    grid, err_post = wgrid, err_pre
    adjusted = torch.zeros_like(alive)
    if ncolors:
        new_w, adj = realign_ops.realign_decimated_grouped(
            wgrid, tex, ep0_t, ep1_t, cw, pn_rows, Mf32, incid, wvalid,
            color_of, ncolors)
        grid = torch.where(alive[:, None], new_w, wgrid)
        adjusted = adj & alive
        err_post = trial_error_1plane(tex, grid, Mint, ep0_t, ep1_t, cw,
                                      u8_mask, rgbm)
    return {"grid": grid, "adjusted": adjusted, "err_pre": err_pre,
            "err_post": err_post,
            "undec": torch.einsum("ntw,nw->nt", Mf32,
                                  grid.to(torch.float32)) / 64.0}


def refine_round_2plane_plain(pt, wg1, wg2, dm, wq, alive, p2c, ep0, ep1,
                              texels, C: int, ncolors: int, u8_mask: bool,
                              cw: tuple, cw_scale=None, rgbm: float = 0.0):
    """One 2-plane, 1-partition round (JAX trial.py:1237-1282 without the
    refit and pack), or with ncolors == 0 the bootstrap infills alone.

    Args:
      wg1/wg2: (NC, W) int32 grids of both planes; dm/wq: (NC,) int32;
      alive: (NC,) bool; p2c: (N,) int32 plane-2 component per block;
      ep0/ep1: (NC, 4) int32 decoded endpoints; texels: (N0, T, 4), block
      b reading row b % N0; lane i belongs to block i // C; cw_scale:
      (N,) alpha scale of each block or None, and rgbm, as for
      ``trial1_refine_plain``.

    Returns dict grid1/grid2 (NC, W), adjusted (NC,) bool, undec1/undec2
    (NC, T) and err_pre/err_post (NC,); the bootstrap returns undec1 and
    undec2 only.
    """
    Mint, Mf32, incid, wvalid, color_of, pn_rows = _lane_tables(pt, dm, wq)

    def undec(g):
        return torch.einsum("ntw,nw->nt", Mf32, g.to(torch.float32)) / 64.0

    if ncolors == 0:
        return {"undec1": undec(wg1), "undec2": undec(wg2)}
    NC = wg1.shape[0]
    rows = torch.arange(NC // C, device=texels.device) % texels.shape[0]
    tex = texels[rows].repeat_interleave(C, 0)
    p2c_f = p2c.repeat_interleave(C, 0)
    p2lanes = torch.arange(4, device=tex.device)[None, :] == p2c_f[:, None]
    cw = lane_cw(cw, cw_scale, C)
    e0, e1 = ep0.to(torch.float32), ep1.to(torch.float32)
    err_pre = trial_error_2plane(tex, wg1, wg2, p2c_f, Mint, e0, e1, cw,
                                 u8_mask, rgbm)
    ep0_t = e0[:, None, :].expand_as(tex)
    ep1_t = e1[:, None, :].expand_as(tex)
    nw1, adj1 = realign_ops.realign_decimated_grouped(
        wg1, tex, ep0_t, ep1_t, cw, pn_rows, Mf32, incid, wvalid, color_of,
        ncolors, plane_mask=p2lanes)
    nw2, adj2 = realign_ops.realign_decimated_grouped(
        wg2, tex, ep0_t, ep1_t, cw, pn_rows, Mf32, incid, wvalid, color_of,
        ncolors, plane_mask=~p2lanes)
    a = alive[:, None]
    nw1 = torch.where(a, nw1, wg1)
    nw2 = torch.where(a, nw2, wg2)
    return {"grid1": nw1, "grid2": nw2, "adjusted": (adj1 | adj2) & alive,
            "undec1": undec(nw1), "undec2": undec(nw2), "err_pre": err_pre,
            "err_post": trial_error_2plane(tex, nw1, nw2, p2c_f, Mint, e0, e1,
                                           cw, u8_mask, rgbm)}


def _round_lib(name):
    lib = _build.load(name)
    if not getattr(lib, "_astc_typed", False):
        if name == "refine_round":
            lib.astc_refine_round.restype = ctypes.c_int
            lib.astc_refine_round.argtypes = (
                [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                + [ctypes.c_float] * 4 + [ctypes.c_void_p, ctypes.c_float]
                + [ctypes.c_void_p] * 5)
        else:
            lib.astc_refine_round2.restype = ctypes.c_int
            lib.astc_refine_round2.argtypes = (
                [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9
                + [ctypes.c_float] * 4 + [ctypes.c_void_p, ctypes.c_float]
                + [ctypes.c_void_p] * 7)
            lib.astc_refine_boot2.restype = ctypes.c_int
            lib.astc_refine_boot2.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                + [ctypes.c_void_p] * 3)
        lib.astc_error_string.restype = ctypes.c_char_p
        lib.astc_error_string.argtypes = [ctypes.c_int]
        lib._astc_typed = True
    return lib


def _check_round(pt, W, T, dev):
    k = pt.k
    if W != k.wt_n.shape[1] or T != k.tap_w.shape[1]:
        raise ValueError("grid or texel count does not match the tables")
    if k.tap_w.device != dev:
        raise ValueError(f"pass tables on {k.tap_w.device}, inputs on {dev}")
    return k


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def refine_round_1plane_cuda(pt, wgrid, dm, wq, alive, ep0, ep1, texels,
                             pot, C: int, ncolors: int, u8_mask: bool,
                             cw: tuple, cw_scale=None, rgbm: float = 0.0):
    """Launch kernel K5; same arguments and outputs as the plain version."""
    NC, W = wgrid.shape
    N, T, _ = texels.shape
    dev = texels.device
    k = _check_round(pt, W, T, dev)
    f32, i32 = torch.float32, torch.int32
    if NC != N * C:
        raise ValueError(f"{NC} lanes for {N} blocks x {C} candidates")
    _build.check(wgrid, "wgrid", i32, (NC, W))
    for name, t in (("dm", dm), ("wq", wq)):
        _build.check(t, name, i32, (NC,))
    _build.check(alive, "alive", torch.bool, (NC,))
    _build.check(ep0, "ep0", i32, (NC, 4, 4))
    _build.check(ep1, "ep1", i32, (NC, 4, 4))
    _build.check(texels, "texels", f32, (N, T, 4))
    _build.check(pot, "pot", i32, (N, T))
    scale = _scale_ptr(cw_scale, N)
    grid = torch.empty((NC, W), dtype=i32, device=dev)
    adjusted = torch.empty((NC,), dtype=i32, device=dev)
    undec = torch.empty((NC, T), dtype=f32, device=dev)
    err = torch.empty((2, NC), dtype=f32, device=dev)
    if NC:
        lib = _round_lib("refine_round")
        p = _build.ptr
        rc = lib.astc_refine_round(
            p(wgrid), p(dm), p(wq), p(alive), p(ep0), p(ep1), p(texels),
            p(pot), p(k.tap_w), p(k.tap_i), p(k.wt_t), p(k.wt_i), p(k.wt_n),
            p(k.dm_color), p(k.pn), N, C, T, W, k.wt_n.shape[0],
            k.wt_t.shape[2], ncolors, int(u8_mask),
            *(float(c) for c in cw), scale, float(rgbm), p(grid), p(adjusted),
            p(undec), p(err), _stream(dev))
        _raise_on(lib, rc, "refine_round")
        if obs.on:
            _count_launch("refine_round", cw_scale, rgbm)
    return {"grid": grid, "adjusted": adjusted != 0, "undec": undec,
            "err_pre": err[0], "err_post": err[1]}


def refine_round_2plane_cuda(pt, wg1, wg2, dm, wq, alive, p2c, ep0, ep1,
                             texels, C: int, ncolors: int, u8_mask: bool,
                             cw: tuple, cw_scale=None, rgbm: float = 0.0):
    """Launch kernel K6 (ncolors > 0) or K7 (ncolors == 0); same arguments
    and outputs as the plain version. K7 reads no weight."""
    NC, W = wg1.shape
    N0, T, _ = texels.shape
    dev = texels.device
    k = _check_round(pt, W, T, dev)
    f32, i32 = torch.float32, torch.int32
    if NC % C or (N0 and (NC // C) % N0):
        raise ValueError(f"{NC} lanes of {C} candidates over {N0} texel rows")
    if W > 63:
        raise ValueError(f"grid of {W} weights: K6 takes at most 63")
    N = NC // C
    for name, t in (("wg1", wg1), ("wg2", wg2)):
        _build.check(t, name, i32, (NC, W))
    _build.check(dm, "dm", i32, (NC,))
    u1 = torch.empty((NC, T), dtype=f32, device=dev)
    u2 = torch.empty((NC, T), dtype=f32, device=dev)
    lib = _round_lib("refine_round2")
    p = _build.ptr
    if ncolors == 0:
        if NC:
            rc = lib.astc_refine_boot2(
                p(wg1), p(wg2), p(dm), p(k.tap_w), p(k.tap_i), NC, T, W,
                k.wt_n.shape[0], p(u1), p(u2), _stream(dev))
            _raise_on(lib, rc, "refine_boot2")
            if obs.on:
                _count_launch("refine_boot2", cw_scale, rgbm)
        return {"undec1": u1, "undec2": u2}
    _build.check(wq, "wq", i32, (NC,))
    _build.check(alive, "alive", torch.bool, (NC,))
    _build.check(p2c, "p2c", i32, (N,))
    _build.check(ep0, "ep0", i32, (NC, 4))
    _build.check(ep1, "ep1", i32, (NC, 4))
    _build.check(texels, "texels", f32, (N0, T, 4))
    scale = _scale_ptr(cw_scale, N)
    g1 = torch.empty((NC, W), dtype=i32, device=dev)
    g2 = torch.empty((NC, W), dtype=i32, device=dev)
    adjusted = torch.empty((NC,), dtype=i32, device=dev)
    err = torch.empty((2, NC), dtype=f32, device=dev)
    if NC:
        rc = lib.astc_refine_round2(
            p(wg1), p(wg2), p(dm), p(wq), p(alive), p(p2c), p(ep0), p(ep1),
            p(texels), p(k.tap_w), p(k.tap_i), p(k.wt_t), p(k.wt_i),
            p(k.wt_n), p(k.dm_color), p(k.pn), N, N0, C, T, W,
            k.wt_n.shape[0], k.wt_t.shape[2], ncolors, int(u8_mask),
            *(float(c) for c in cw), scale, float(rgbm), p(g1), p(g2),
            p(adjusted), p(u1), p(u2), p(err), _stream(dev))
        _raise_on(lib, rc, "refine_round2")
        if obs.on:
            _count_launch("refine_round2", cw_scale, rgbm)
    return {"grid1": g1, "grid2": g2, "adjusted": adjusted != 0,
            "undec1": u1, "undec2": u2, "err_pre": err[0],
            "err_post": err[1]}


def trial1_refine(pt, wgrid0, dm, wq, alive, cq, cqm, fmt_req, texels, pot,
                  ep0, ep1, C: int, R: int, u8_mask: bool, cw: tuple,
                  profile: int, cw_scale=None, rgbm: float = 0.0):
    """1-plane refinement rounds: kernel K2 for the LDR profiles where
    ``_build.use_kernel`` allows it; otherwise, and for every HDR profile,
    the rounds driver with ``refine_round_1plane`` (K5 or the plain round)
    as its round. ``cw_scale`` (N,) selects the per-block weights' form,
    ``rgbm`` > 0 the RGBM metric."""
    args = (pt, wgrid0, dm, wq, alive, cq, cqm, fmt_req, texels, pot, ep0,
            ep1, C, R, u8_mask, cw, profile)
    kw = {"cw_scale": cw_scale, "rgbm": float(rgbm)}
    if (_build.use_kernel("refine", texels)
            and profile < cuq.PRF_HDR_RGB_LDR_A):
        return trial1_refine_cuda(*args, **kw)
    return _rounds_1plane(refine_round_1plane, *args, **kw)


def trial2_refine(pt, wg1_0, wg2_0, dm, wq, alive, cq, fmt_req, p2c, texels,
                  data_mean, ep0, ep1, C: int, R: int, u8_mask: bool,
                  cw: tuple, profile: int, cw_scale=None, rgbm: float = 0.0):
    """2-plane refinement rounds: kernel K3 for the LDR profiles where
    ``_build.use_kernel`` allows it, otherwise the rounds driver with
    ``refine_round_2plane``; the rest as for ``trial1_refine``."""
    args = (pt, wg1_0, wg2_0, dm, wq, alive, cq, fmt_req, p2c, texels,
            data_mean, ep0, ep1, C, R, u8_mask, cw, profile)
    kw = {"cw_scale": cw_scale, "rgbm": float(rgbm)}
    if (_build.use_kernel("refine", texels)
            and profile < cuq.PRF_HDR_RGB_LDR_A):
        return trial2_refine_cuda(*args, **kw)
    return _rounds_2plane(refine_round_2plane, *args, **kw)


def refine_round_1plane(pt, wgrid, dm, wq, alive, ep0, ep1, texels, pot,
                        C: int, ncolors: int, u8_mask: bool, cw: tuple,
                        cw_scale=None, rgbm: float = 0.0):
    """One 1-plane round: kernel K5 or the plain version, as
    ``_build.use_kernel`` says; ``cw_scale`` and ``rgbm`` as for
    ``trial1_refine``."""
    fn = (refine_round_1plane_cuda if _build.use_kernel("refine", texels)
          else refine_round_1plane_plain)
    return fn(pt, wgrid, dm, wq, alive, ep0, ep1, texels, pot, C, ncolors,
              u8_mask, cw, cw_scale=cw_scale, rgbm=float(rgbm))


def refine_round_2plane(pt, wg1, wg2, dm, wq, alive, p2c, ep0, ep1, texels,
                        C: int, ncolors: int, u8_mask: bool, cw: tuple,
                        cw_scale=None, rgbm: float = 0.0):
    """One 2-plane round: kernel K6 (K7 for the bootstrap, ncolors == 0)
    or the plain version, as ``_build.use_kernel`` says; the rest as for
    ``refine_round_1plane``."""
    fn = (refine_round_2plane_cuda if _build.use_kernel("refine", texels)
          else refine_round_2plane_plain)
    return fn(pt, wg1, wg2, dm, wq, alive, p2c, ep0, ep1, texels, C,
              ncolors, u8_mask, cw, cw_scale=cw_scale, rgbm=float(rgbm))
