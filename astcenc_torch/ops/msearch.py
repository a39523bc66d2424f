"""Trial front end (mode search): kernel K1 and its plain version.

Replaces the TPU kernel ``astcenc_tpu/ops/msearch_pallas.py::_ms_kernel``
(:281, launched by ``_ms_call`` :442/:458 from ``mode_search`` :497). Per
block it computes the ideal decimated weights of every decimation in use,
the angular [low, high] weight range per (decimation, quant level <= 7),
each mode's quantized weight grid and weight-set error, the endpoint
format(s) and colour quant picked from the combined colour-error table,
and the top C modes (strict <, so on equal error the earlier mode stays
ahead). It serves 1-plane passes of 1-4 partitions (the table then holds
the best format combination per total integer count, and each mode also
gets the quant level of the matched-format encoding) and 2-plane passes
(both planes' grids and errors per mode).

On the card (``csrc/msearch.cu``) a CTA of 256 threads takes a few blocks
at a time and splits each step of the search into independent items, one
thread each, between barriers: the ideal weights over (decimation, weight),
the angular sums over (decimation, step), the first minimum over steps per
(decimation, level), the modes over (block, mode) with one thread
quantizing and scoring a whole grid, the top C by C rounds of argmin at
the end, and the winners' grids recomputed over (candidate, weight). The
stencil taps (where they fit) stay in shared memory for the CTA's life,
the blocks' ideal weights, ranges and mode totals beside them. The work
is a few hundred thousand dependent float operations per block from a
few hundred bytes of input: the kernel is
bound by instruction issue and latency, not by memory, and its design
trades the warp-per-block kernel's serial steps, warp reductions and
32-fold repeated comparisons for parallel items. Every sum keeps that
kernel's order (its lane-strided partial sums and butterfly, emulated in
one thread), so its outputs are unchanged bit for bit.

The angular offsets use the same 64 x 32 sin/cos tables as the JAX XLA
path and ``atan2f`` from CUDA's libm (the XLA path uses arctan2); the
TPU kernel's polynomial atan2 and rotation recurrence are not carried over.

The plain version is the XLA branch of ``trial.py:460-555``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import obs
from . import _build
from . import angular as ang
from . import formats as fmts
from . import ideal as ideal_ops

_QUANT_LEVELS = (2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32)
QUANT_LEVELS_M1 = np.array([1, 2, 3, 4, 5, 7, 9, 11, 15, 19, 23, 31],
                           dtype=np.float32)
META_COLS = 40
MAX_C = 8


def make_mode_meta(quant_m, dm_m, weight_bits, mode_index, free_bits: int,
                   quant_unquant, quant_mode_table, mod_bits: int, pc: int,
                   max_angular_quant: int):
    """Static per-mode metadata (copied from msearch_pallas.make_mode_meta).

    Returns a tuple of per-mode records (mode_index, dm, wq, levels,
    unquant tuple, ang_ok, ic_chain tuple of (ql, ql_clipped, ql_mod, slot),
    nv_ql, nv_ql_mod); modes with no bits left for colour are dropped, and
    the chain holds only the valid (ql >= fmts.QUANT_6) integer counts.
    """
    M = len(quant_m)
    if pc == 1:
        ic_range = range(1, 5)
        ic_base = 1
    else:
        ic_range = range(pc, min(4 * pc, 9) + 1)
        ic_base = pc
    recs = []
    for m in range(M):
        bits = int(free_bits - weight_bits[m])
        if bits <= 0:
            continue
        q = int(quant_m[m])
        levels = _QUANT_LEVELS[q]
        unq = tuple(int(v) for v in quant_unquant[q][:levels])
        ang_ok = q <= max_angular_quant
        bc = min(max(bits, 0), 127)
        chain = []
        for ic in ic_range:
            ql = int(quant_mode_table[ic, bc])
            if ql < fmts.QUANT_6:
                continue
            ql_mod = int(quant_mode_table[ic, min(bc + mod_bits, 127)])
            chain.append((ql, min(max(ql, 0), 20), ql_mod, ic - ic_base))
        nv_ql = int(quant_mode_table[1 if pc == 1 else 0, bc])
        nv_ql_mod = int(quant_mode_table[1 if pc == 1 else 0,
                                         min(bc + mod_bits, 127)])
        recs.append((int(mode_index[m]), int(dm_m[m]), q, levels, unq,
                     ang_ok, tuple(chain), nv_ql, nv_ql_mod))
    return tuple(recs)


def mode_meta_array(meta) -> np.ndarray:
    """make_mode_meta records -> (M, 40) int32 rows for the kernel:
    [mode_index, dm, wq, levels, ang_ok, nchain, nv_ql, nv_ql_mod,
    (ql, ql_clipped, ql_mod, slot) x up to 8]."""
    out = np.zeros((len(meta), META_COLS), np.int32)
    for i, (mi, d, q, levels, _, ang_ok, chain, nv, nvm) in enumerate(meta):
        out[i, :8] = (mi, d, q, levels, int(ang_ok), len(chain), nv, nvm)
        for j, c in enumerate(chain):
            out[i, 8 + 4 * j:12 + 4 * j] = c
    return out


def _plane_grids(pt, wei, wes, mcut, maxwq):
    """One plane's ideal decimated weights, quantized per mode, and their
    weight-set error (trial.py:460-510): (uqf, uq (N, M, W), err (N, M))."""
    dev = wei.device
    quant_m = pt.quant_m_np
    dec_ideal = ideal_ops.ideal_weights_for_decimation(
        wei, wes, pt.dec_int, pt.dec_sq, pt.dec_f32)
    max_precision = torch.minimum(
        torch.clamp(pt.maxprec[None, :], max=ang.TUNE_MAX_ANGULAR_QUANT),
        maxwq[:, None])
    low_v, high_v = ang.angular_endpoints_for_quant_levels(
        dec_ideal, pt.wvalid, max_precision)
    ang_ok_np = quant_m <= ang.TUNE_MAX_ANGULAR_QUANT
    ang_ok = torch.from_numpy(ang_ok_np).to(dev)
    dm_i = torch.from_numpy(pt.dm_m_np.astype(np.int64)).to(dev)
    ql_i = torch.from_numpy(np.where(ang_ok_np, quant_m, 0)
                            .astype(np.int64)).to(dev)
    low_m = torch.where(ang_ok, low_v[:, dm_i, ql_i], 0.0)
    high_m = torch.where(ang_ok, high_v[:, dm_i, ql_i], 1.0)
    high_m = torch.where(high_m > 1.02 * mcut[:, None], 1.0, high_m)
    qm = torch.from_numpy(quant_m.astype(np.int64)).to(dev)
    uqf, uq = ideal_ops.quantize_weights_for_modes(
        dec_ideal[:, dm_i], low_m, high_m, pt.weight_quant_unquant,
        torch.from_numpy(QUANT_LEVELS_M1).to(dev), qm)
    return uq, ideal_ops.weight_set_error(uqf, wei, wes, pt.dec_f32[dm_i])


def mode_search_plain(pt, wei, wes, mcut, maxwq, comb_err, comb_fmt,
                      C: int, wei2=None, wes2=None, mcut2=None):
    """Plain PyTorch mode search (the XLA branches of trial.py:460-555
    and, for two planes, :1055-1150).

    Args:
      pt: the pass tables (``codec.trial.pass_tables``); pt.pc partitions.
      wei/wes: (N, T) ideal per-texel weights / error scales.
      mcut: (N,) min-weight cutoff; maxwq: (N,) int32 max weight quant.
      comb_err/comb_fmt: pc = 1: (N, 21, 4) colour-error table and formats;
        pc > 1: (N, 21, S) and (N, 21, S, pc) (``formats.combine_partitions``).
      wei2/wes2/mcut2: the second plane of a 2-plane pass.

    Returns dict of (N, C) tensors mode, dm, wq, valid, cq, cqm, err, fmt
    (N, C, pc), uq (N, C, W) and, for two planes, uq2; slots without a
    valid mode hold zeros and err 1e30.
    """
    dev = wei.device
    N = wei.shape[0]
    quant_m = pt.quant_m_np
    M = quant_m.shape[0]
    uq, qwt_err = _plane_grids(pt, wei, wes, mcut, maxwq)
    if wei2 is not None:
        uq2, err2 = _plane_grids(pt, wei2, wes2, mcut2, maxwq)
        qwt_err = qwt_err + err2
    qm = torch.from_numpy(quant_m.astype(np.int64)).to(dev)
    mode_ok = (torch.from_numpy(pt.mode_active_np).to(dev)[None, :]
               & (qm[None, :] <= maxwq[:, None]))
    qwt_err = torch.where(mode_ok, qwt_err, 1e38)

    bb = fmts.best_for_bitcount(comb_err, comb_fmt, pt.quant_mode_table_np,
                                pt.bitcount_np, pt.pc, pt.mod_bits)
    total = torch.where(qwt_err >= 1e37, fmts.ERROR_CALC_DEFAULT,
                        bb["error"] + qwt_err)
    cand, valid = fmts.select_candidates(total, C)
    cc = cand.clamp(0, M - 1)
    ni = torch.arange(N, device=dev)[:, None]
    dm_i = torch.from_numpy(pt.dm_m_np.astype(np.int64)).to(dev)
    mi = torch.from_numpy(pt.mode_index_np.astype(np.int64)).to(dev)
    i32 = torch.int32
    out = {
        "mode": mi[cc], "dm": dm_i[cc], "wq": qm[cc],
        "cq": bb["quant"][ni, cc].clamp(4, 20),
        "cqm": bb["quant_mod"][ni, cc].clamp(0, 20),
    }
    # Slots without a valid mode carry zeros, as the kernels write them.
    out = {k: torch.where(valid, v, 0).to(i32) for k, v in out.items()}
    out["fmt"] = torch.where(valid[..., None], bb["formats"][ni, cc],
                             0).to(i32)
    out["uq"] = torch.where(valid[..., None], uq[ni, cc], 0).to(i32)
    if wei2 is not None:
        out["uq2"] = torch.where(valid[..., None], uq2[ni, cc], 0).to(i32)
    out["valid"] = valid
    out["err"] = torch.where(valid, total[ni, cc], fmts.ERROR_CALC_DEFAULT)
    return out


def _lib():
    lib = _build.load("msearch")
    if not getattr(lib, "_astc_typed", False):
        lib.astc_msearch.restype = ctypes.c_int
        lib.astc_msearch.argtypes = [ctypes.c_void_p] * 19 + [
            ctypes.c_int] * 10 + [ctypes.c_void_p] * 3
        lib.astc_error_string.restype = ctypes.c_char_p
        lib.astc_error_string.argtypes = [ctypes.c_int]
        lib._astc_typed = True
    return lib


def mode_search_cuda(pt, wei, wes, mcut, maxwq, comb_err, comb_fmt, C: int,
                     wei2=None, wes2=None, mcut2=None):
    """Launch kernel K1; same arguments and outputs as the plain version
    except ``err``, which is the total error of each candidate."""
    N, T = wei.shape
    k = pt.k
    pc = pt.pc
    two = wei2 is not None
    D, W = k.wt_n.shape
    if not 1 <= C <= MAX_C:
        raise ValueError(f"candidate count {C} outside 1..{MAX_C}")
    if two and pc != 1:
        raise ValueError("2-plane mode search has one partition")
    S = 4 if pc == 1 else comb_err.shape[2]
    f32, i32 = torch.float32, torch.int32
    for name, t in (("wei", wei), ("wes", wes)) + (
            (("wei2", wei2), ("wes2", wes2)) if two else ()):
        _build.check(t, name, f32, (N, T))
    _build.check(mcut, "mcut", f32, (N,))
    if two:
        _build.check(mcut2, "mcut2", f32, (N,))
    _build.check(maxwq, "maxwq", i32, (N,))
    _build.check(comb_err, "comb_err", f32, (N, 21, S))
    _build.check(comb_fmt, "comb_fmt", i32,
                 (N, 21, 4) if pc == 1 else (N, 21, S, pc))
    dev = wei.device
    if k.taps.device != dev:
        raise ValueError(f"pass tables on {k.taps.device}, inputs on {dev}")
    out_i = torch.empty((N, C, 16 + W * (2 if two else 1)), dtype=i32,
                        device=dev)
    out_e = torch.empty((N, C), dtype=f32, device=dev)
    lib = _lib()
    if N:
        p = _build.ptr
        none = ctypes.c_void_p(0)
        rc = lib.astc_msearch(
            p(wei), p(wes), p(mcut), p(wei2) if two else none,
            p(wes2) if two else none, p(mcut2) if two else none, p(maxwq),
            p(comb_err), p(comb_fmt), p(k.taps), p(k.wlist), p(k.wt_n),
            p(k.wcount), p(k.maxprec), p(k.modes), p(k.unq),
            p(k.sin_t), p(k.cos_t), p(k.levels_used),
            N, T, W, D, k.wt_t.shape[2], k.modes.shape[0], C, S, pc,
            int(two), p(out_i), p(out_e),
            ctypes.c_void_p(_build.stream(dev.index)))
        if rc != 0:
            raise RuntimeError("msearch kernel launch failed: "
                               + lib.astc_error_string(rc).decode())
        if obs.on:
            obs.count("launch.msearch")
    out = {
        "mode": out_i[..., 0], "dm": out_i[..., 1], "wq": out_i[..., 2],
        "valid": out_i[..., 3] != 0, "cq": out_i[..., 4],
        "cqm": out_i[..., 5], "fmt": out_i[..., 8:8 + pc],
        "uq": out_i[..., 16:16 + W], "err": out_e,
    }
    if two:
        out["uq2"] = out_i[..., 16 + W:]
    return out


def mode_search(pt, wei, wes, mcut, maxwq, comb_err, comb_fmt, C: int,
                wei2=None, wes2=None, mcut2=None, use_kernel: bool = True):
    """Mode search: kernel K1 for CUDA tensors, the plain version for CPU
    tensors. ``use_kernel=False`` runs the plain version on any device."""
    args = (pt, wei, wes, mcut, maxwq, comb_err, comb_fmt, C, wei2, wes2,
            mcut2)
    if wei.is_cuda and use_kernel:
        return mode_search_cuda(*args)
    if not wei.is_cuda and wei.device.type != "cpu":
        raise ValueError(f"unsupported device {wei.device}")
    return mode_search_plain(*args)
