"""Encoder-side colour endpoint packing, LDR formats.

Port of ``astcenc_tpu/ops/color_pack.py::pack_color_endpoints_ldr`` (:615;
reference astcenc_color_quantize.cpp:1909-2147): every delta and
blue-contract variant is tried on the whole batch with validity masks and
the best valid one is kept per element, in the reference's trial order and
with its error tie breaks. Colours are in the 0..255 domain; quantization
uses the unquant -> uquant lo/hi tie-break tables.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables import ise, quant
from . import color_unquant as cuq

_BIG = 1e30


@functools.cache
def quant_tables_np():
    """(lo (17, 256), hi (17, 256)) int32 colour quant tables."""
    lo = np.zeros((17, 256), np.int32)
    hi = np.zeros((17, 256), np.int32)
    for q in range(ise.QUANT_6, 21):
        t = quant.color_quant_tables(q)
        lo[q - ise.QUANT_6] = t["unquant_to_uquant_lo"]
        hi[q - ise.QUANT_6] = t["unquant_to_uquant_hi"]
    return lo, hi


_dev_tables: dict = {}


def quant_tables(device):
    key = str(device)
    if key not in _dev_tables:
        _dev_tables[key] = tuple(torch.from_numpy(a).to(device)
                                 for a in quant_tables_np())
    return _dev_tables[key]


class _Q:
    """Per-element colour quant table row (qidx = quant level - QUANT_6)."""

    def __init__(self, qidx):
        self.idx = qidx.to(torch.int64)
        self.lo, self.hi = quant_tables(qidx.device)

    def _row(self, v):
        q = self.idx.reshape(self.idx.shape + (1,) * (v.dim() - 1))
        return q, torch.clamp(v, 0, 255).to(torch.int64)

    def color(self, v):
        """quant_color: round ties up (reference :73-78)."""
        q, vi = self._row(v)
        return self.hi[q, vi]

    def color_res(self, v, vf):
        """quant_color with the residual bias (reference :108-125)."""
        q, vi = self._row(v)
        use_hi = (vf - v.to(torch.float32)) >= -0.1
        return torch.where(use_hi, self.hi[q, vi], self.lo[q, vi])


def _rtn(x):
    """float_to_int_rtn: floor(x + 0.5); torch.round rounds half to even."""
    return torch.floor(x + 0.5).to(torch.int32)


def _sum3(v):
    return v[..., 0] + v[..., 1] + v[..., 2]


def _set3(v, a):
    """v with lane 3 replaced by a."""
    return torch.cat([v[..., :3], a[..., None]], -1)


def _quantize_rgb(c0, c1, q: _Q):
    """quantize_rgb (reference :169-192): nudge c0 down and c1 up by an
    accumulated 0.2 until the quantized RGB sums order; finished lanes
    freeze. Bounded at 2048 steps like the JAX version."""
    def ev(a, b):
        return (q.color_res(torch.clamp(_rtn(a), min=0), a),
                q.color_res(torch.clamp(_rtn(b), max=255), b))

    o0, o1 = ev(c0, c1)
    done = _sum3(o0) <= _sum3(o1)
    it = 0
    while not bool(done.all()):
        d = done[:, None]
        c0 = torch.where(d, c0, c0 - np.float32(0.2))
        c1 = torch.where(d, c1, c1 + np.float32(0.2))
        a, b = ev(c0, c1)
        ok = _sum3(a) <= _sum3(b)
        newly = (ok & ~done)[:, None]
        o0 = torch.where(newly, a, o0)
        o1 = torch.where(newly, b, o1)
        if it >= 2048:
            forced = (~done & ~ok)[:, None]
            o0 = torch.where(forced, b, o0)
            o1 = torch.where(forced, b, o1)
            done = done | True
        done = done | ok
        it += 1
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
    ok &= _sum3(d) >= 0
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
    ok &= _sum3(c1i) > _sum3(c0i)
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
    ok &= _sum3(d) < 0
    s = base + d
    ok &= ((s[..., :3] >= 0) & (s[..., :3] <= 0xFF)).all(-1)
    return ok, c0be, c1de


def _encoding_error(c0f, c1f, u0, u1):
    e0 = c0f - u0.to(torch.float32)
    e1 = c1f - u1.to(torch.float32)
    return (e0 * e0 + e1 * e1).sum(-1)


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
    oldsum = _sum3(rgbs) * scale
    newsum = qv.sum(-1).to(torch.float32)
    scalea = torch.clamp(rgbs[..., 3] * (oldsum + 1e-10) / (newsum + 1e-10),
                         0.0, 1.0)
    s = q.color(torch.clamp(_rtn(scalea * 256.0), 0, 255))
    return torch.cat([qv, s[:, None]], -1)


def _lum(c):
    return _sum3(c) * np.float32(1.0 / 3.0)


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


def pack_color_endpoints_ldr(ep0, ep1, rgbs, req_fmt, quant_level):
    """Batched LDR pack_color_endpoints (reference :1909-2147).

    ep0/ep1/rgbs: (B, 4) float32 in the 0..65535 domain; req_fmt (B,) int32
    requested format; quant_level (B,) absolute colour quant (>= QUANT_6).
    Returns (fmt (B,) int32, values (B, 8) int32 in 0..255).
    """
    q = _Q(torch.clamp(quant_level - ise.QUANT_6, 0, 16))
    c0 = torch.clamp(ep0, 0.0, 65535.0) / 257.0
    c1 = torch.clamp(ep1, 0.0, 65535.0) / 257.0
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
