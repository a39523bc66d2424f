"""Encoder-side colour endpoint packing, LDR formats, and the colour pack
kernel.

Port of ``astcenc_tpu/ops/color_pack.py::pack_color_endpoints_ldr`` (:615;
reference astcenc_color_quantize.cpp:1909-2147): every delta and
blue-contract variant is tried on the whole batch with validity masks and
the best valid one is kept per element, in the reference's trial order and
with its error tie breaks. Colours are in the 0..255 domain; quantization
uses the unquant -> uquant lo/hi tie-break tables
(``gather.quant_lookup_plain``).

That is the plain version. On the card a pack call is one launch of the
colour pack kernel (``csrc/color_pack.cu``, ``pack_cuda``), which replaces
the TPU's colour quantizer lookup ``gather_pallas.py::_master_kernel``
(:170): one thread per row runs the reference's scalar pack of the arm its
requested format names, both the LDR arm here and the HDR arm of
``color_pack_hdr``, with the lookup tables in shared memory.
``pack_color_endpoints_ldr`` and ``color_pack_hdr.pack_color_endpoints``
route to it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import obs
from ..tables import ise
from . import _build
from . import color_unquant as cuq
from . import gather
from . import softfloat as sf

_BIG = 1e30


class _Q:
    """Per-row colour quant tables (qidx = quant level - QUANT_6), the
    counterpart of the JAX package's ``QuantQ``: each call looks up all its
    values, (B, ...) for the B rows, in one ``gather.quant_lookup_plain``."""

    def __init__(self, qidx):
        self.idx = qidx.to(torch.int32)

    def lookup(self, v):
        """(lo, hi) table values of v (B, ...) int."""
        packed = gather.quant_lookup_plain(
            self.idx, v.reshape(v.shape[0], -1)).reshape(v.shape)
        return packed & 0xFF, packed >> 8

    def color(self, v):
        """quant_color: round ties up (reference :73-78)."""
        return self.lookup(v)[1]

    def color_res(self, v, vf):
        """quant_color with the residual bias (reference :108-125)."""
        lo, hi = self.lookup(v)
        return torch.where((vf - v.to(torch.float32)) >= -0.1, hi, lo)


def _rtn(x):
    """float_to_int_rtn: floor(x + 0.5); torch.round rounds half to even."""
    return torch.floor(x + 0.5).to(torch.int32)


def _set3(v, a):
    """v with lane 3 replaced by a."""
    return torch.cat([v[..., :3], a[..., None]], -1)


_NUDGE_LIMIT = 2049    # the step at which the JAX version gives up


def _quantize_rgb(c0, c1, q: _Q):
    """quantize_rgb (reference :169-192): nudge c0 down and c1 up by an
    accumulated 0.2 until the quantized RGB sums order; the first step
    that orders them wins. As in the JAX version, a lane still unordered
    at step 2049 takes that step's c1 for both endpoints. The steps go in
    passes of 4, 8, 16, then 32: each pass accumulates the nudges one by
    one (the same float32 sums as a step-by-step loop) and quantizes them
    in one lookup; LDR lanes rarely need more than the first pass, HDR
    ones often need hundreds of steps."""
    def ev(a, b):
        return (q.color_res(torch.clamp(_rtn(a), min=0), a),
                q.color_res(torch.clamp(_rtn(b), max=255), b))

    o0, o1 = ev(c0, c1)
    done = sf.sum3(o0) <= sf.sum3(o1)
    step, K = 0, 4                             # steps taken; this pass's
    while True:
        wait = obs.on and obs.sync("color_pack.rgb_steps")
        more = not bool(done.all())
        if wait:
            obs.end(wait)
        if not more:
            break
        a, b = [], []
        for _ in range(K):
            c0 = c0 - np.float32(0.2)
            c1 = c1 + np.float32(0.2)
            a.append(c0)
            b.append(c1)
        a, b = ev(torch.stack(a, 1), torch.stack(b, 1))   # (B, K, 4)
        steps = step + torch.arange(1, K + 1, device=c0.device)
        ok = (sf.sum3(a) <= sf.sum3(b)) & (steps <= _NUDGE_LIMIT)
        first = ok.to(torch.int32).argmax(1)
        take = ok.any(1) & ~done
        # A lane unordered through step 2049 takes that step's c1 for both.
        forced = ~ok.any(1) & ~done & (step + K >= _NUDGE_LIMIT)
        pick = torch.where(forced, _NUDGE_LIMIT - step - 1, first)
        ni = torch.arange(len(first), device=c0.device)
        sa, sb = a[ni, pick.long()], b[ni, pick.long()]
        o0 = torch.where(take[:, None], sa, torch.where(forced[:, None], sb,
                                                        o0))
        o1 = torch.where((take | forced)[:, None], sb, o1)
        done = done | take | forced
        step += K
        K = min(2 * K, 32)
    return o0, o1


def _try_rgb_delta(c0, c1, q: _Q):
    """try_quantize_rgb_delta (reference :321-400)."""
    c0a = _rtn(c0) << 1
    c0be = q.color(c0a & 0xFF)
    c0b2 = c0be | (c0a & 0x100)
    c1d = (_rtn(c1) << 1) - c0b2
    c1d = _set3(c1d, torch.zeros_like(c1d[..., 3]))
    ok = ((c1d[..., :3] <= 63) & (c1d[..., :3] >= -64)).all(-1)
    c1d = (c1d & 0x7F) | ((c0b2 & 0x100) >> 1)
    c1de = q.color(c1d)
    ok &= (((c1d ^ c1de) & 0xC0)[..., :3] == 0).all(-1)
    d = (c1de >> 1) & 0x3F
    d = torch.where((d & 0x20) != 0, d - 0x40, d)
    base = (c0be >> 1) | (c1de & 0x80)
    ok &= sf.sum3(d) >= 0
    s = base + d
    ok &= ((s[..., :3] >= 0) & (s[..., :3] <= 0xFF)).all(-1)
    return ok, c0be, c1de


def _try_alpha_delta(c0, c1, q: _Q):
    """try_quantize_alpha_delta (reference :505-556)."""
    a0a = _rtn(c0[..., 3]) << 1
    a0be = q.color(a0a & 0xFF)
    a0b2 = a0be | (a0a & 0x100)
    a1d = (_rtn(c1[..., 3]) << 1) - a0b2
    ok = (a1d <= 63) & (a1d >= -64)
    a1d = (a1d & 0x7F) | ((a0b2 & 0x100) >> 1)
    a1de = q.color(a1d)
    ok &= ((a1d ^ a1de) & 0xC0) == 0
    a1du = a1de & 0x7F
    a1du = torch.where((a1du & 0x40) != 0, a1du - 0x80, a1du) + a0b2
    ok &= (a1du >= 0) & (a1du <= 0x1FF)
    return ok, a0be, a1de


def _bc(c):
    """Inverse blue contraction on RGB lanes (reference :245-247)."""
    b = c[..., 2:3]
    return torch.cat([c[..., :3] * 2.0 - b, c[..., 3:]], -1)


def _in_range(c):
    return ((c[..., :3] >= 0) & (c[..., :3] <= 255.0)).all(-1)


def _try_rgb_blue_contract(c0, c1, q: _Q):
    """try_quantize_rgb_blue_contract (reference :238-270); outputs swap."""
    c0b = _bc(c0)
    c1b = _bc(c1)
    ok = _in_range(c0b) & _in_range(c1b)
    c0i = q.color_res(_rtn(c0b), c0b)
    c1i = q.color_res(_rtn(c1b), c1b)
    ok &= sf.sum3(c1i) > sf.sum3(c0i)
    return ok, c1i, c0i


def _try_rgb_delta_blue_contract(c0in, c1in, q: _Q):
    """try_quantize_rgb_delta_blue_contract (reference :403-485)."""
    c0 = _bc(c1in)
    c1 = _bc(c0in)
    ok = _in_range(c0) & _in_range(c1)
    c0a = _rtn(c0) << 1
    c0be = q.color(c0a & 0xFF)
    c0b2 = c0be | (c0a & 0x100)
    c1d = (_rtn(c1) << 1) - c0b2
    c1d = _set3(c1d, torch.zeros_like(c1d[..., 3]))
    ok &= ((c1d[..., :3] <= 63) & (c1d[..., :3] >= -64)).all(-1)
    c1d = (c1d & 0x7F) | ((c0b2 & 0x100) >> 1)
    c1de = q.color(c1d)
    ok &= (((c1d ^ c1de) & 0xC0)[..., :3] == 0).all(-1)
    d = (c1de >> 1) & 0x3F
    d = torch.where((d & 0x20) != 0, d - 0x40, d)
    base = (c0be >> 1) | (c1de & 0x80)
    ok &= sf.sum3(d) < 0
    s = base + d
    ok &= ((s[..., :3] >= 0) & (s[..., :3] <= 0xFF)).all(-1)
    return ok, c0be, c1de


def _encoding_error(c0f, c1f, u0, u1):
    """Squared endpoint error, the four channels summed pairwise as the
    JAX package's jitted sum is (candidates can tie to the last bit)."""
    e0 = c0f - u0.to(torch.float32)
    e1 = c1f - u1.to(torch.float32)
    t = e0 * e0 + e1 * e1
    return (t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3])


def _pack_rgb_or_rgba(c0, c1, q: _Q, with_alpha: bool):
    """FMT_RGB / FMT_RGBA with delta and blue-contract trials (reference
    :1933-2096). Returns (fmt (B,), values (B, 8))."""
    B = c0.shape[0]
    dev = c0.device
    best_err = torch.full((B,), _BIG, device=dev)
    best_fmt = torch.zeros((B,), dtype=torch.int32, device=dev)
    out0 = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    out1 = torch.zeros_like(out0)
    delta_ok_quant = q.idx <= (18 - ise.QUANT_6)
    n255 = torch.full((B,), 255, dtype=torch.int32, device=dev)

    def unpack(e0, e1, delta):
        u0, u1 = (cuq._rgba_delta_unpack(e0, e1) if delta
                  else cuq._rgba_unpack(e0, e1))
        if not with_alpha:
            u0, u1 = _set3(u0, n255), _set3(u1, n255)
        return u0, u1

    def consider(ok, fmt_id, e0, e1, delta):
        nonlocal best_err, best_fmt, out0, out1
        err = _encoding_error(c0, c1, *unpack(e0, e1, delta))
        take = ok & (err < best_err)
        best_err = torch.where(take, err, best_err)
        best_fmt = torch.where(take, fmt_id, best_fmt)
        out0 = torch.where(take[:, None], e0, out0)
        out1 = torch.where(take[:, None], e1, out1)

    e0q, e1q = _quantize_rgb(c0, c1, q)
    if with_alpha:
        okd, e0d, e1d = _try_rgb_delta_blue_contract(c0, c1, q)
        oka, a0, a1 = _try_alpha_delta(c1, c0, q)     # swapped for BC
        consider(okd & oka & delta_ok_quant, cuq.FMT_RGBA_DELTA,
                 _set3(e0d, a0), _set3(e1d, a1), True)
        okd, e0d, e1d = _try_rgb_delta(c0, c1, q)
        oka, a0, a1 = _try_alpha_delta(c0, c1, q)
        consider(okd & oka & delta_ok_quant, cuq.FMT_RGBA_DELTA,
                 _set3(e0d, a0), _set3(e1d, a1), True)
        okb, e0b, e1b = _try_rgb_blue_contract(c0, c1, q)
        a0q = q.color_res(_rtn(c1[..., 3]), c1[..., 3])   # alpha swaps
        a1q = q.color_res(_rtn(c0[..., 3]), c0[..., 3])
        consider(okb & (q.idx < 16), cuq.FMT_RGBA, _set3(e0b, a0q),
                 _set3(e1b, a1q), False)
        a0q = q.color_res(_rtn(c0[..., 3]), c0[..., 3])
        a1q = q.color_res(_rtn(c1[..., 3]), c1[..., 3])
        e0q, e1q = _set3(e0q, a0q), _set3(e1q, a1q)
    else:
        okd, e0d, e1d = _try_rgb_delta_blue_contract(c0, c1, q)
        consider(okd & delta_ok_quant, cuq.FMT_RGB_DELTA, e0d, e1d, True)
        okd, e0d, e1d = _try_rgb_delta(c0, c1, q)
        consider(okd & delta_ok_quant, cuq.FMT_RGB_DELTA, e0d, e1d, True)
        okb, e0b, e1b = _try_rgb_blue_contract(c0, c1, q)
        consider(okb & (q.idx < 16), cuq.FMT_RGB, e0b, e1b, False)
    # Fallback: taken whenever better or nothing chosen yet.
    err = _encoding_error(c0, c1, *unpack(e0q, e1q, False))
    take = (err < best_err) | (best_err >= _BIG)
    best_fmt = torch.where(take, cuq.FMT_RGBA if with_alpha else cuq.FMT_RGB,
                           best_fmt)
    out0 = torch.where(take[:, None], e0q, out0)
    out1 = torch.where(take[:, None], e1q, out1)
    vals = torch.stack([out0[:, 0], out1[:, 0], out0[:, 1], out1[:, 1],
                        out0[:, 2], out1[:, 2], out0[:, 3], out1[:, 3]], -1)
    if not with_alpha:
        vals[:, 6:] = 0
    return best_fmt, vals


def _pack_rgbs(rgbs, q: _Q):
    """FMT_RGB_SCALE values (reference quantize_rgbs :734-766)."""
    scale = 1.0 / 257.0
    rgb = torch.clamp(rgbs[..., :3] * scale, 0.0, 255.0)
    qv = q.color_res(_rtn(rgb), rgb)
    oldsum = sf.sum3(rgbs) * scale
    newsum = qv.sum(-1).to(torch.float32)
    scalea = torch.clamp(rgbs[..., 3] * (oldsum + 1e-10) / (newsum + 1e-10),
                         0.0, 1.0)
    s = q.color(torch.clamp(_rtn(scalea * 256.0), 0, 255))
    return torch.cat([qv, s[:, None]], -1)


def _lum(c):
    return sf.sum3(c) * np.float32(1.0 / 3.0)


def _pack_luminance(c0, c1, q: _Q):
    """FMT_LUMINANCE (reference quantize_luminance :795-820)."""
    lum0 = _lum(c0)
    lum1 = _lum(c1)
    swap = lum0 > lum1
    avg = (lum0 + lum1) * 0.5
    lum0 = torch.where(swap, avg, lum0)
    lum1 = torch.where(swap, avg, lum1)
    return torch.stack([q.color_res(_rtn(lum0), lum0),
                        q.color_res(_rtn(lum1), lum1)], -1)


def _pack_luminance_alpha(c0, c1, q: _Q):
    """FMT_LUMINANCE_ALPHA with the delta trial (reference :2105-2117)."""
    l0 = _lum(c0)
    l1 = _lum(c1)

    def chan_delta(v0, v1):
        v0a = _rtn(v0) << 1
        v0be = q.color(v0a & 0xFF)
        v0b2 = v0be | (v0a & 0x100)
        v1d = (_rtn(v1) << 1) - v0b2
        ok = (v1d <= 63) & (v1d >= -64)
        v1d = (v1d & 0x7F) | ((v0b2 & 0x100) >> 1)
        v1de = q.color(v1d)
        ok &= ((v1d ^ v1de) & 0xC0) == 0
        v1du = v1de & 0x7F
        v1du = torch.where((v1du & 0x40) != 0, v1du - 0x80, v1du) + v0b2
        ok &= (v1du >= 0) & (v1du <= 0x1FF)
        return ok, v0be, v1de

    okl, l0e, l1e = chan_delta(l0, l1)
    oka, a0e, a1e = chan_delta(c0[..., 3], c1[..., 3])
    ok = okl & oka & (q.idx <= (18 - ise.QUANT_6))
    dvals = torch.stack([l0e, l1e, a0e, a1e], -1)
    a0 = c0[..., 3]
    a1 = c1[..., 3]
    vals = torch.stack([q.color_res(_rtn(l0), l0), q.color_res(_rtn(l1), l1),
                        q.color_res(_rtn(a0), a0), q.color_res(_rtn(a1), a1)],
                       -1)
    fmt = torch.where(ok, cuq.FMT_LUMINANCE_ALPHA_DELTA,
                      cuq.FMT_LUMINANCE_ALPHA)
    return fmt, torch.where(ok[:, None], dvals, vals)


def pack_color_endpoints_ldr_plain(ep0, ep1, rgbs, req_fmt, quant_level):
    """Batched LDR pack_color_endpoints (reference :1909-2147), the plain
    version of ``pack_color_endpoints_ldr``.

    ep0/ep1/rgbs: (B, 4) float32 in the 0..65535 domain; req_fmt (B,) int32
    requested format; quant_level (B,) absolute colour quant (>= QUANT_6).
    Returns (fmt (B,) int32, values (B, 8) int32 in 0..255).
    """
    q = _Q(torch.clamp(quant_level - ise.QUANT_6, 0, 16))
    c0 = sf.div(torch.clamp(ep0, 0.0, 65535.0), 257.0)
    c1 = sf.div(torch.clamp(ep1, 0.0, 65535.0), 257.0)
    B = ep0.shape[0]
    dev = ep0.device
    z8 = torch.zeros((B, 8), dtype=torch.int32, device=dev)

    def pad8(v):
        return torch.cat([v, z8[:, v.shape[1]:]], 1)

    fmt_rgb, vals_rgb = _pack_rgb_or_rgba(c0, c1, q, with_alpha=False)
    fmt_rgba, vals_rgba = _pack_rgb_or_rgba(c0, c1, q, with_alpha=True)
    vals_rgbs = pad8(_pack_rgbs(rgbs, q))
    a0q = q.color_res(_rtn(c0[..., 3]), c0[..., 3])
    a1q = q.color_res(_rtn(c1[..., 3]), c1[..., 3])
    vals_rgbsa = vals_rgbs.clone()
    vals_rgbsa[:, 4] = a0q
    vals_rgbsa[:, 5] = a1q
    vals_lum = pad8(_pack_luminance(c0, c1, q))
    fmt_la, v_la = _pack_luminance_alpha(c0, c1, q)
    vals_la = pad8(v_la)

    full = torch.full_like(req_fmt, 0)
    cases = [
        (cuq.FMT_RGB, fmt_rgb, vals_rgb),
        (cuq.FMT_RGBA, fmt_rgba, vals_rgba),
        (cuq.FMT_RGB_SCALE, full + cuq.FMT_RGB_SCALE, vals_rgbs),
        (cuq.FMT_RGB_SCALE_ALPHA, full + cuq.FMT_RGB_SCALE_ALPHA, vals_rgbsa),
        (cuq.FMT_LUMINANCE, full + cuq.FMT_LUMINANCE, vals_lum),
        (cuq.FMT_LUMINANCE_ALPHA, fmt_la, vals_la),
    ]
    out_fmt = full + cuq.FMT_LUMINANCE
    out_vals = vals_lum
    for fid, f, v in cases:
        m = req_fmt == fid
        out_fmt = torch.where(m, f, out_fmt)
        out_vals = torch.where(m[:, None], v, out_vals)
    return out_fmt.to(torch.int32), out_vals.to(torch.int32)


_pack_fn = None


def _bind_pack():
    """astc_color_pack of the built library, its argument types set once."""
    global _pack_fn
    lib = _build.load("color_pack")
    fn = lib.astc_color_pack
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3)
    lib.astc_error_string.restype = ctypes.c_char_p
    lib.astc_error_string.argtypes = [ctypes.c_int]
    _pack_fn = fn
    return fn


def pack_cuda(profile: int, ep0, ep1, rgbs, rgbo, req_fmt, quant_level):
    """Launch the colour pack kernel on one pack call: the profile-aware
    pack of ``color_pack_hdr.pack_color_endpoints_plain`` (the LDR arm
    alone for profiles 0 and 1, where rgbo may be None). ep0, ep1, rgbs,
    rgbo (B, 4) float32 and req_fmt, quant_level (B,) int32, contiguous
    CUDA tensors. Returns (fmt (B,), vals (B, 8)) int32."""
    B = ep0.shape[0]
    f32, i32 = torch.float32, torch.int32
    hdr = profile >= cuq.PRF_HDR_RGB_LDR_A
    for name, t in (("ep0", ep0), ("ep1", ep1), ("rgbs", rgbs)) + (
            (("rgbo", rgbo),) if hdr else ()):
        _build.check(t, name, f32, (B, 4))
    _build.check(req_fmt, "req_fmt", i32, (B,))
    _build.check(quant_level, "quant_level", i32, (B,))
    dev = ep0.device
    fmt = torch.empty((B,), dtype=i32, device=dev)
    vals = torch.empty((B, 8), dtype=i32, device=dev)
    if B:
        fn = _pack_fn or _bind_pack()
        rc = fn(ep0.data_ptr(), ep1.data_ptr(), rgbs.data_ptr(),
                rgbo.data_ptr() if hdr else None, req_fmt.data_ptr(),
                quant_level.data_ptr(), gather.quant_tables(dev).data_ptr(),
                B, profile, fmt.data_ptr(), vals.data_ptr(),
                _build.stream(ep0.get_device()))
        if rc != 0:
            raise RuntimeError("color_pack kernel launch failed: "
                               + _build.load("color_pack").astc_error_string(
                                   rc).decode())
        if obs.on:
            obs.count("launch.color_pack")
    return fmt, vals


def use_pack_kernel(ep0, use_kernel: bool) -> bool:
    """Whether a pack call goes to the kernel: for CUDA tensors unless
    ``use_kernel`` is False; the plain version for CPU tensors; any other
    device raises."""
    if ep0.is_cuda:
        return use_kernel
    if ep0.device.type != "cpu":
        raise ValueError(f"unsupported device {ep0.device}")
    return False


def pack_args(*ts):
    """The pack's tensors as the kernel takes them: float32 endpoints and
    int32 requests, contiguous (no copy where they already are)."""
    return [None if t is None else t.to(
        torch.float32 if t.is_floating_point() else torch.int32).contiguous()
        for t in ts]


def pack_color_endpoints_ldr(ep0, ep1, rgbs, req_fmt, quant_level,
                             use_kernel: bool = True):
    """Batched LDR pack_color_endpoints: the colour pack kernel for CUDA
    tensors (one launch), the plain version for CPU tensors or with
    ``use_kernel=False``. Arguments and outputs as the plain version's."""
    if use_pack_kernel(ep0, use_kernel):
        return pack_cuda(cuq.PRF_LDR, *pack_args(ep0, ep1, rgbs, None,
                                                  req_fmt, quant_level))
    return pack_color_endpoints_ldr_plain(ep0, ep1, rgbs, req_fmt,
                                          quant_level)
