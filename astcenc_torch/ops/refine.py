"""Refinement rounds of a 1-plane trial: kernel K2 and its plain version.

Replaces the TPU kernel
``astcenc_tpu/ops/refine_pallas.py::_trial1_full_kernel`` (:348, launched
by ``_trial1_full_call`` :603/:616 from ``trial1_refine_full`` :639). For
each (block, candidate) lane and each of R rounds it infills the weight
grid, refits the endpoints by least squares, packs them in the requested
LDR format, decodes them, takes the trial error before (round 0) and
after a parity-class realign of the grid, and drops lanes whose realign
changed nothing.

On the card (``csrc/refine.cu``) one warp handles one lane: texels and the
grid sit in shared memory, the texel reductions are warp shuffles, the
stencil sums use the sparse form of the decimation stencils (at most 4
taps per texel, and per-weight texel lists for the transposed sums), and
the endpoint pack and decode run redundantly on every lane of the warp, so
their branches are uniform. The R rounds stay in one launch. The work is a
long chain of dependent scalar and warp-reduction steps per lane: the
kernel is latency bound, and it relies on many resident warps (one per
lane, ~350k for a 2048x2048 image) to hide that latency.

The plain version is the XLA refine loop of ``trial.py:660-721``, built on
``recompute``, ``color_pack`` and ``realign``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import color_pack as cpack
from . import color_unquant as cuq
from . import realign as realign_ops
from . import recompute as recompute_ops

#: Launches of the CUDA kernel (the plain version does not count).
launches = 0


def trial_error_1plane(texels, wgrid, Mint, ep0_t, ep1_t, cw, u8_mask: bool):
    """compute_symbolic_block_difference_1plane for per-texel endpoints
    (reference astcenc_decompress_symbolic.cpp:407-618). (N,)."""
    infill = ((8 + torch.einsum("ntw,nw->nt", Mint, wgrid.to(torch.float32)))
              .to(torch.int32) >> 4)
    w = infill.to(torch.float32)[..., None]
    color = torch.floor((ep0_t * (64.0 - w) + ep1_t * w + 32.0) / 64.0)
    if u8_mask:
        color = torch.floor(color / 256.0) * 257.0
    d = torch.clamp((texels - color).abs(), max=1e15)
    cwt = torch.tensor(cw, dtype=torch.float32, device=texels.device)
    err_t = torch.clamp((d * d * cwt).sum(-1), max=1e30)
    return err_t.sum(-1)


def trial1_refine_plain(pt, wgrid0, dm, wq, alive, cq, fmt_req, texels,
                        ep0, ep1, C: int, R: int, u8_mask: bool, cw: tuple,
                        profile: int):
    """R refinement rounds for N*C lanes, 1 partition.

    Args:
      pt: pass tables (``codec.trial.pass_tables``).
      wgrid0: (NC, W) int32 starting grids; dm/wq/cq/fmt_req: (NC,) int32;
      alive: (NC,) bool; texels: (N, T, 4) float32; ep0/ep1: (N, 4) ideal
      endpoints; lane i belongs to block i // C.

    Returns dict fmt (R, NC), vals (R, NC, 8), wpost (R, NC, W) int32;
    err_pre (NC,) and err_post (R, NC) float32, alive-masked to 1e30.
    """
    dev = texels.device
    NC, W = wgrid0.shape
    T = texels.shape[1]
    tex = texels.repeat_interleave(C, 0)
    e0 = ep0.repeat_interleave(C, 0)[:, None, :]
    e1 = ep1.repeat_interleave(C, 0)[:, None, :]
    dml = dm.to(torch.int64)
    Mint = pt.dec_int[dml]
    Mf32 = pt.dec_f32[dml]
    incid = (Mint != 0).to(torch.float32)
    wvalid = pt.wvalid[dml]
    color_of = pt.dm_color[dml]
    pn_rows = pt.weight_prev_next[wq.to(torch.int64)]       # (NC, 65, 2)
    pmask = torch.ones((NC, T, 1), device=dev)
    counts = torch.full((NC, 1), T, dtype=torch.int32, device=dev)
    big = torch.tensor(1e30, device=dev)
    wgrid = wgrid0
    fmts, vals, wposts, posts = [], [], [], []
    err_pre = None
    for r in range(R):
        undec = torch.einsum("ntw,nw->nt", Mf32, wgrid.to(torch.float32)) \
            / 64.0
        rc = recompute_ops.recompute_ideal_colors_1plane(
            tex, pmask, counts, undec, cw, e0, e1)
        e0, e1 = rc["ep0"], rc["ep1"]
        fmt, v = cpack.pack_color_endpoints_ldr(e0[:, 0], e1[:, 0],
                                                rc["rgbs"][:, 0], fmt_req, cq)
        ep0i, ep1i = cuq.unpack_color_endpoints(profile, fmt, v)
        ep0_t = ep0i.to(torch.float32)[:, None, :].expand(NC, T, 4)
        ep1_t = ep1i.to(torch.float32)[:, None, :].expand(NC, T, 4)
        if r == 0:
            err_pre = torch.where(alive, trial_error_1plane(
                tex, wgrid, Mint, ep0_t, ep1_t, cw, u8_mask), big)
        new_w, adjusted = realign_ops.realign_decimated_grouped(
            wgrid, tex, ep0_t, ep1_t, cw, pn_rows, Mf32, incid, wvalid,
            color_of, pt.ncolors)
        wgrid = torch.where(alive[:, None], new_w, wgrid)
        post = trial_error_1plane(tex, wgrid, Mint, ep0_t, ep1_t, cw, u8_mask)
        posts.append(torch.where(alive, post, big))
        alive = alive & adjusted
        fmts.append(fmt)
        vals.append(v)
        wposts.append(wgrid)
    return {"fmt": torch.stack(fmts), "vals": torch.stack(vals),
            "wpost": torch.stack(wposts), "err_pre": err_pre,
            "err_post": torch.stack(posts)}


def _lib():
    lib = _build.load("refine")
    if not getattr(lib, "_astc_typed", False):
        lib.astc_refine.restype = ctypes.c_int
        lib.astc_refine.argtypes = ([ctypes.c_void_p] * 17
                                    + [ctypes.c_int] * 10
                                    + [ctypes.c_float] * 4
                                    + [ctypes.c_void_p] * 3)
        lib.astc_error_string.restype = ctypes.c_char_p
        lib.astc_error_string.argtypes = [ctypes.c_int]
        lib._astc_typed = True
    return lib


def trial1_refine_cuda(pt, wgrid0, dm, wq, alive, cq, fmt_req, texels, ep0,
                       ep1, C: int, R: int, u8_mask: bool, cw: tuple,
                       profile: int):
    """Launch kernel K2; same arguments and outputs as the plain version."""
    global launches
    if profile not in (cuq.PRF_LDR, cuq.PRF_LDR_SRGB):
        raise NotImplementedError("HDR profiles are not ported yet")
    NC, W = wgrid0.shape
    N, T, _ = texels.shape
    k = pt.k
    f32, i32 = torch.float32, torch.int32
    if NC != N * C:
        raise ValueError(f"{NC} lanes for {N} blocks x {C} candidates")
    if not 1 <= R <= 8:
        raise ValueError(f"refinement count {R} outside 1..8")
    _build.check(wgrid0, "wgrid0", i32, (NC, W))
    for name, t in (("dm", dm), ("wq", wq), ("cq", cq), ("fmt_req", fmt_req)):
        _build.check(t, name, i32, (NC,))
    _build.check(alive, "alive", torch.bool, (NC,))
    _build.check(texels, "texels", f32, (N, T, 4))
    _build.check(ep0, "ep0", f32, (N, 4))
    _build.check(ep1, "ep1", f32, (N, 4))
    if W != k.wt_n.shape[1] or T != k.tap_w.shape[1]:
        raise ValueError("grid or texel count does not match the tables")
    dev = texels.device
    if k.tap_w.device != dev:
        raise ValueError(f"pass tables on {k.tap_w.device}, inputs on {dev}")
    out_i = torch.empty((R, NC, 16 + W), dtype=i32, device=dev)
    out_e = torch.empty((R + 1, NC), dtype=f32, device=dev)
    lib = _lib()
    if NC:
        stream = torch.cuda.current_stream(dev).cuda_stream
        p = _build.ptr
        rc = lib.astc_refine(
            p(wgrid0), p(dm), p(wq), p(alive), p(cq), p(fmt_req), p(texels),
            p(ep0), p(ep1), p(k.tap_w), p(k.tap_i), p(k.wt_t), p(k.wt_i),
            p(k.wt_n), p(k.dm_color), p(k.pn), p(k.lohi),
            N, C, T, W, k.wt_n.shape[0], k.wt_t.shape[2], R, pt.ncolors,
            int(u8_mask), profile, *(float(c) for c in cw),
            p(out_i), p(out_e), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError("refine kernel launch failed: "
                               + lib.astc_error_string(rc).decode())
        launches += 1
    return {"fmt": out_i[..., 0], "vals": out_i[..., 1:9],
            "wpost": out_i[..., 16:], "err_pre": out_e[0],
            "err_post": out_e[1:]}


def trial1_refine(pt, wgrid0, dm, wq, alive, cq, fmt_req, texels, ep0, ep1,
                  C: int, R: int, u8_mask: bool, cw: tuple, profile: int,
                  use_kernel: bool = True):
    """Refinement rounds: kernel K2 for CUDA tensors, the plain version for
    CPU tensors. ``use_kernel=False`` runs the plain version anywhere."""
    args = (pt, wgrid0, dm, wq, alive, cq, fmt_req, texels, ep0, ep1, C, R,
            u8_mask, cw, profile)
    if texels.is_cuda and use_kernel:
        return trial1_refine_cuda(*args)
    if not texels.is_cuda and texels.device.type != "cpu":
        raise ValueError(f"unsupported device {texels.device}")
    return trial1_refine_plain(*args)
