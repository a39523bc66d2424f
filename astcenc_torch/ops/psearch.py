"""Partition-candidate line-error ranking: kernel K4 and its plain version.

Replaces the TPU kernel ``astcenc_tpu/ops/psearch_pallas.py::
_psearch_kernel`` (:37, launched by ``_psearch_call`` :155/:161 from
``line_errors`` :182). For every block and each of its S top-ranked
candidate partitionings (P = 2..4 partitions) it computes the partition
means, each partition's dominant direction (the first-longest sum of
positive deviations), the squared errors of the texels to the
uncorrelated line and to the same-chroma line, and a line-length penalty
(reference: astcenc_find_best_partitioning.cpp:551-779). Blocks whose
alpha is constant rank on RGB only.

On the card (``csrc/psearch.cu``) one thread block takes one ASTC block:
its texels are loaded once into shared memory, and each half-warp takes one
of the S candidates in turn. A lane reads its texels' partition ids from
the partition table by packed index into one register (no (N, S, T) tensor
is built), each phase is one pass over its texels for all partitions, and
the sums are reduced by shuffles in the order of a one-warp-per-candidate
kernel.

A second form takes per-block channel weights (USE_ALPHA_WEIGHT,
``psearch_pallas.py:39-45``): each block's R, G and B weights times its
alpha scale ``cw_scale``.

The plain version is the XLA branch of ``partition_search.py:210-263``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import obs
from . import _build
from . import ideal as ideal_ops


def _line_errors(tex_rep, pmask, counts_f, cw, wie: float, comp_mask):
    dev = tex_rep.device
    avg, dirv = ideal_ops.avgs_and_dirs(tex_rep, pmask, comp_mask)
    wait = obs.on and obs.sync("psearch.comp_mask", "h2d")
    cm = torch.tensor(comp_mask, dtype=torch.float32, device=dev)
    if wait:
        obs.end(wait, cm.nbytes)
    if torch.is_tensor(cw):
        cwt = cw[:, None, :]
    else:
        wait = obs.on and obs.sync("psearch.channel_weight", "h2d")
        cwt = torch.tensor(cw, dtype=torch.float32, device=dev)
        if wait:
            obs.end(wait, cwt.nbytes)
    uncor_b = ideal_ops.normalize_safe(dirv, comp_mask)
    samec_b = ideal_ops.normalize_safe(avg * cm, comp_mask)
    d = (avg * uncor_b * cm).sum(-1, keepdim=True)
    uncor_amod = avg - uncor_b * d
    b_t = torch.einsum("ntp,npc->ntc", pmask, uncor_b)
    am_t = torch.einsum("ntp,npc->ntc", pmask, uncor_amod)
    param_u = (tex_rep * b_t * cm).sum(-1)
    dist_u = am_t + param_u[..., None] * b_t - tex_rep
    err_u = (dist_u * dist_u * cwt * cm).sum(-1)
    bs_t = torch.einsum("ntp,npc->ntc", pmask, samec_b)
    param_s = (tex_rep * bs_t * cm).sum(-1)
    dist_s = param_s[..., None] * bs_t - tex_rep
    err_s = (dist_s * dist_s * cwt * cm).sum(-1)
    big = 1e10
    inpart = pmask.transpose(1, 2) > 0
    lo = torch.where(inpart, param_u[:, None, :], big).amin(2)
    hi = torch.where(inpart, param_u[:, None, :], -big).amax(2)
    ll = torch.clamp(hi - lo, min=1e-7)
    ew = counts_f * wie
    lsq = ll * ll
    u_extra = (((uncor_b * cm) ** 2).sum(-1) * lsq * ew).sum(-1)
    s_extra = (((samec_b * cm) ** 2).sum(-1) * lsq * ew).sum(-1)
    return err_u.sum(-1) + u_extra, err_s.sum(-1) + s_extra


def line_errors_plain(texels, uses_alpha, top, pot_table, count_table,
                      P: int, wie: float, cw: tuple, cw_scale=None):
    """Plain PyTorch line errors (the XLA branch of
    partition_search.py:210-263).

    Args:
      texels: (N, T, 4) float32; uses_alpha: (N,) int32 (0 or 1);
      top: (N, S) int32 packed partitioning indices; pot_table: (Q, T)
      int32 partition of each texel; count_table: (Q, 4) int32; cw: the
      config's channel weights; cw_scale: (N,) float32 alpha scale of each
      block (USE_ALPHA_WEIGHT) or None.

    Returns (uncor (N, S), samec (N, S)) float32.
    """
    N, S = top.shape
    T = texels.shape[1]
    topl = top.to(torch.int64)
    pot = pot_table[topl].reshape(N * S, T)
    counts_f = count_table[topl].reshape(N * S, 4)[:, :P].to(torch.float32)
    tex_rep = texels[:, None].expand(N, S, T, 4).reshape(N * S, T, 4)
    pmask = ideal_ops.partition_onehot(pot)[..., :P]
    cw = ideal_ops.block_channel_weights(cw, cw_scale)
    if torch.is_tensor(cw):
        cw = cw.repeat_interleave(S, 0)
    u4, s4 = _line_errors(tex_rep, pmask, counts_f, cw, wie, (1, 1, 1, 1))
    u3, s3 = _line_errors(tex_rep, pmask, counts_f, cw, wie, (1, 1, 1, 0))
    ua = (uses_alpha != 0).repeat_interleave(S)
    return (torch.where(ua, u4, u3).reshape(N, S),
            torch.where(ua, s4, s3).reshape(N, S))


def _lib():
    lib = _build.load("psearch")
    if not getattr(lib, "_astc_typed", False):
        lib.astc_psearch.restype = ctypes.c_int
        lib.astc_psearch.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 4
                                     + [ctypes.c_float] * 5
                                     + [ctypes.c_void_p] * 4)
        lib.astc_error_string.restype = ctypes.c_char_p
        lib.astc_error_string.argtypes = [ctypes.c_int]
        lib._astc_typed = True
    return lib


def line_errors_cuda(texels, uses_alpha, top, pot_table, count_table,
                     P: int, wie: float, cw: tuple, cw_scale=None):
    """Launch kernel K4; same arguments and outputs as the plain version
    (the kernel counts each partition's texels itself). With ``cw_scale``
    its per-block weights' form runs."""
    N, S = top.shape
    T = texels.shape[1]
    Q = pot_table.shape[0]
    f32, i32 = torch.float32, torch.int32
    if not 2 <= P <= 4:
        raise ValueError(f"partition count {P} outside 2..4")
    _build.check(texels, "texels", f32, (N, T, 4))
    _build.check(uses_alpha, "uses_alpha", i32, (N,))
    _build.check(top, "top", i32, (N, S))
    _build.check(pot_table, "pot_table", i32, (Q, T))
    scale = None
    if cw_scale is not None:
        _build.check(cw_scale, "cw_scale", f32, (N,))
        scale = _build.ptr(cw_scale)
    out_u = torch.empty((N, S), dtype=f32, device=texels.device)
    out_s = torch.empty((N, S), dtype=f32, device=texels.device)
    lib = _lib()
    if N and S:
        p = _build.ptr
        rc = lib.astc_psearch(
            p(texels), p(uses_alpha), p(top), p(pot_table), N, S, T, P,
            float(wie), *(float(c) for c in cw), scale, p(out_u), p(out_s),
            ctypes.c_void_p(
                torch.cuda.current_stream(texels.device).cuda_stream))
        if rc != 0:
            raise RuntimeError("psearch kernel launch failed: "
                               + lib.astc_error_string(rc).decode())
        if obs.on:
            obs.count("launch.psearch")
            if cw_scale is not None:
                obs.count("launch.psearch.asr")
    return out_u, out_s


def line_errors(texels, uses_alpha, top, pot_table, count_table, P: int,
                wie: float, cw: tuple, cw_scale=None):
    """Line errors: kernel K4 or the plain version, as
    ``_build.use_kernel`` says."""
    args = (texels, uses_alpha, top, pot_table, count_table, P, wie, cw,
            cw_scale)
    if obs.on:
        obs.count(f"psearch.partitionings.pc{P}", top.shape[0] * top.shape[1])
    if _build.use_kernel("psearch", texels):
        return line_errors_cuda(*args)
    return line_errors_plain(*args)
