// Shared device code of kernels K2 (refine.cu) and K3 (refine2.cu): the LDR
// colour pack and decode, the trial error and the parity-class realign of a
// decimated weight grid. Every function runs redundantly on all 32 lanes
// of a warp (scalar pack/decode, uniform branches) or splits texels and
// weights over the lanes and reduces with warp shuffles.
//
// Arithmetic follows the plain PyTorch versions in ops/color_pack.py,
// ops/color_unquant.py, ops/refine.py and ops/realign.py, sum for sum.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace astc {

enum {
  FMT_LUMINANCE = 0,
  FMT_LUMINANCE_DELTA = 1,
  FMT_LUMINANCE_ALPHA = 4,
  FMT_LUMINANCE_ALPHA_DELTA = 5,
  FMT_RGB_SCALE = 6,
  FMT_RGB = 8,
  FMT_RGB_DELTA = 9,
  FMT_RGB_SCALE_ALPHA = 10,
  FMT_RGBA = 12,
  FMT_RGBA_DELTA = 13,
};

// ---------------------------------------------------------------------------
// Colour quantization (astcenc_color_quantize.cpp), scalar per lane.
// ---------------------------------------------------------------------------

// The colour quant tables of one quant level: for each value 0..255 the
// quantized values just below (lo) and above (hi) it. Plain loads, so the
// tables may lie in global memory (K2, K3) or in shared memory.
struct Quant {
  const int* lo;
  const int* hi;
  int qidx;
  // quant_color: round ties up.
  __device__ int col(int v) const { return hi[clampi(v, 0, 255)]; }
  // quant_color with the residual bias.
  __device__ int res(int v, float vf) const {
    const int vc = clampi(v, 0, 255);
    return (vf - (float)v >= -0.1f) ? hi[vc] : lo[vc];
  }
};

// The same tables packed as lo | hi << 8 in 16 bits (the colour pack kernel
// stages all 17 levels in shared memory, 8.7 KB).
struct Quant16 {
  const uint16_t* t;
  int qidx;
  __device__ int col(int v) const { return t[clampi(v, 0, 255)] >> 8; }
  __device__ int res(int v, float vf) const {
    const int e = t[clampi(v, 0, 255)];
    return (vf - (float)v >= -0.1f) ? e >> 8 : e & 0xFF;
  }
};

__device__ __forceinline__ int sum3(const int* v) { return v[0] + v[1] + v[2]; }

__device__ void uncontract(const int* c, int* o) {
  o[0] = (c[0] + c[2]) >> 1;
  o[1] = (c[1] + c[2]) >> 1;
  o[2] = c[2];
  o[3] = c[3];
}

__device__ void rgba_unpack(const int* v0, const int* v1, int* o0, int* o1) {
  int u0[4], u1[4];
  uncontract(v0, u0);
  uncontract(v1, u1);
  const bool swap = sum3(v0) > sum3(v1);
  for (int i = 0; i < 4; ++i) {
    o0[i] = swap ? u1[i] : v0[i];
    o1[i] = swap ? u0[i] : v1[i];
  }
}

__device__ void rgba_delta_unpack(const int* v0, const int* v1, int* o0,
                                  int* o1) {
  int base[4], hi[4], d[4];
  for (int i = 0; i < 4; ++i) {
    base[i] = (v0[i] >> 1) | (v1[i] & 0x80);
    int a = (v1[i] >> 1) & 0x3F;
    d[i] = (a & 0x20) ? a - 0x40 : a;
    hi[i] = d[i] + base[i];
  }
  const bool swap = (d[0] + d[1] + d[2]) < 0;
  int ub[4], uh[4];
  uncontract(base, ub);
  uncontract(hi, uh);
  for (int i = 0; i < 4; ++i) {
    o0[i] = clampi(swap ? uh[i] : base[i], 0, 255);
    o1[i] = clampi(swap ? ub[i] : hi[i], 0, 255);
  }
}

__device__ void blue_contract(const float* c, float* o) {
  o[0] = c[0] * 2.f - c[2];
  o[1] = c[1] * 2.f - c[2];
  o[2] = c[2] * 2.f - c[2];
  o[3] = c[3];
}

__device__ bool in_range(const float* c) {
  bool ok = true;
  for (int i = 0; i < 3; ++i) ok = ok && c[i] >= 0.f && c[i] <= 255.f;
  return ok;
}

// Shared tail of try_quantize_rgb_delta[_blue_contract] (:321-485).
template <class Q>
__device__ bool rgb_delta(const Q& q, const float* c0, const float* c1,
                          bool want_negative, int* e0, int* e1) {
  int c0b2[4], c1d[4];
  for (int i = 0; i < 4; ++i) {
    const int c0a = rtn(c0[i]) * 2;
    e0[i] = q.col(c0a & 0xFF);
    c0b2[i] = e0[i] | (c0a & 0x100);
    c1d[i] = (i == 3) ? 0 : rtn(c1[i]) * 2 - c0b2[i];
  }
  bool ok = true;
  for (int i = 0; i < 3; ++i) ok = ok && c1d[i] <= 63 && c1d[i] >= -64;
  for (int i = 0; i < 4; ++i) {
    c1d[i] = (c1d[i] & 0x7F) | ((c0b2[i] & 0x100) >> 1);
    e1[i] = q.col(c1d[i]);
  }
  int d[3], dsum = 0;
  for (int i = 0; i < 3; ++i) {
    ok = ok && ((c1d[i] ^ e1[i]) & 0xC0) == 0;
    const int a = (e1[i] >> 1) & 0x3F;
    d[i] = (a & 0x20) ? a - 0x40 : a;
    dsum += d[i];
  }
  ok = ok && (want_negative ? dsum < 0 : dsum >= 0);
  for (int i = 0; i < 3; ++i) {
    const int s = ((e0[i] >> 1) | (e1[i] & 0x80)) + d[i];
    ok = ok && s >= 0 && s <= 0xFF;
  }
  return ok;
}

// try_quantize_alpha_delta / the channel delta of luminance_alpha.
template <class Q>
__device__ bool chan_delta(const Q& q, float v0, float v1, int* e0,
                           int* e1) {
  const int v0a = rtn(v0) * 2;
  *e0 = q.col(v0a & 0xFF);
  const int v0b2 = *e0 | (v0a & 0x100);
  int v1d = rtn(v1) * 2 - v0b2;
  bool ok = v1d <= 63 && v1d >= -64;
  v1d = (v1d & 0x7F) | ((v0b2 & 0x100) >> 1);
  *e1 = q.col(v1d);
  ok = ok && ((v1d ^ *e1) & 0xC0) == 0;
  int v1du = *e1 & 0x7F;
  v1du = ((v1du & 0x40) ? v1du - 0x80 : v1du) + v0b2;
  return ok && v1du >= 0 && v1du <= 0x1FF;
}

// quantize_rgb (:169-192): accumulated 0.2 nudges until the sums order.
template <class Q>
__device__ void quantize_rgb(const Q& q, const float* c0, const float* c1,
                             int* o0, int* o1) {
  float a[4], b[4];
  for (int i = 0; i < 4; ++i) {
    a[i] = c0[i];
    b[i] = c1[i];
    o0[i] = q.res(max(rtn(a[i]), 0), a[i]);
    o1[i] = q.res(min(rtn(b[i]), 255), b[i]);
  }
  if (sum3(o0) <= sum3(o1)) return;
  for (int it = 0;; ++it) {
    int x0[4], x1[4];
    for (int i = 0; i < 4; ++i) {
      a[i] = a[i] - 0.2f;
      b[i] = b[i] + 0.2f;
      x0[i] = q.res(max(rtn(a[i]), 0), a[i]);
      x1[i] = q.res(min(rtn(b[i]), 255), b[i]);
    }
    if (sum3(x0) <= sum3(x1)) {
      for (int i = 0; i < 4; ++i) {
        o0[i] = x0[i];
        o1[i] = x1[i];
      }
      return;
    }
    if (it >= 2048) {
      for (int i = 0; i < 4; ++i) {
        o0[i] = x1[i];
        o1[i] = x1[i];
      }
      return;
    }
  }
}

// The four channels sum pairwise, as ops/color_pack.py and the JAX
// package's jitted sum do: candidates can tie to the last bit.
__device__ float encoding_error(const float* c0, const float* c1,
                                const int* u0, const int* u1) {
  float t[4];
  for (int i = 0; i < 4; ++i) {
    const float e0 = c0[i] - (float)u0[i];
    const float e1 = c1[i] - (float)u1[i];
    t[i] = e0 * e0 + e1 * e1;
  }
  return (t[0] + t[1]) + (t[2] + t[3]);
}

struct Trials {
  float best_err = kBig;
  int fmt = 0;
  int out0[4] = {0, 0, 0, 0};
  int out1[4] = {0, 0, 0, 0};
};

__device__ void consider(Trials& tr, const float* c0, const float* c1,
                         bool with_alpha, bool ok, int fmt, const int* e0,
                         const int* e1, bool delta) {
  int u0[4], u1[4];
  if (delta)
    rgba_delta_unpack(e0, e1, u0, u1);
  else
    rgba_unpack(e0, e1, u0, u1);
  if (!with_alpha) u0[3] = u1[3] = 255;
  const float err = encoding_error(c0, c1, u0, u1);
  if (ok && err < tr.best_err) {
    tr.best_err = err;
    tr.fmt = fmt;
    for (int i = 0; i < 4; ++i) {
      tr.out0[i] = e0[i];
      tr.out1[i] = e1[i];
    }
  }
}

// FMT_RGB / FMT_RGBA with delta and blue-contract trials (:1933-2096).
template <class Q>
__device__ int pack_rgb_or_rgba(const Q& q, const float* c0,
                                const float* c1, bool with_alpha, int* vals) {
  Trials tr;
  const bool delta_ok_quant = q.qidx <= 18 - 4;
  int e0[4], e1[4];
  float bc0[4], bc1[4];
  blue_contract(c1, bc0);     // delta blue contract: swapped inputs
  blue_contract(c0, bc1);
  bool ok = in_range(bc0) && in_range(bc1);
  ok = rgb_delta(q, bc0, bc1, true, e0, e1) && ok;
  if (with_alpha) {
    int a0, a1;
    const bool oka = chan_delta(q, c1[3], c0[3], &a0, &a1);
    e0[3] = a0;
    e1[3] = a1;
    consider(tr, c0, c1, true, ok && oka && delta_ok_quant, FMT_RGBA_DELTA,
             e0, e1, true);
  } else {
    consider(tr, c0, c1, false, ok && delta_ok_quant, FMT_RGB_DELTA, e0, e1,
             true);
  }
  ok = rgb_delta(q, c0, c1, false, e0, e1);
  if (with_alpha) {
    int a0, a1;
    const bool oka = chan_delta(q, c0[3], c1[3], &a0, &a1);
    e0[3] = a0;
    e1[3] = a1;
    consider(tr, c0, c1, true, ok && oka && delta_ok_quant, FMT_RGBA_DELTA,
             e0, e1, true);
  } else {
    consider(tr, c0, c1, false, ok && delta_ok_quant, FMT_RGB_DELTA, e0, e1,
             true);
  }
  // Blue contract, non-delta: outputs swap (and alpha swaps with them).
  blue_contract(c0, bc0);
  blue_contract(c1, bc1);
  ok = in_range(bc0) && in_range(bc1);
  int i0[4], i1[4];
  for (int i = 0; i < 4; ++i) {
    i0[i] = q.res(rtn(bc0[i]), bc0[i]);
    i1[i] = q.res(rtn(bc1[i]), bc1[i]);
  }
  ok = ok && sum3(i1) > sum3(i0);
  if (with_alpha) {
    i1[3] = q.res(rtn(c1[3]), c1[3]);
    i0[3] = q.res(rtn(c0[3]), c0[3]);
  }
  consider(tr, c0, c1, with_alpha, ok && q.qidx < 16,
           with_alpha ? FMT_RGBA : FMT_RGB, i1, i0, false);
  // Fallback: taken whenever better or nothing chosen yet.
  int f0[4], f1[4];
  quantize_rgb(q, c0, c1, f0, f1);
  if (with_alpha) {
    f0[3] = q.res(rtn(c0[3]), c0[3]);
    f1[3] = q.res(rtn(c1[3]), c1[3]);
  }
  int u0[4], u1[4];
  rgba_unpack(f0, f1, u0, u1);
  if (!with_alpha) u0[3] = u1[3] = 255;
  const float err = encoding_error(c0, c1, u0, u1);
  if (err < tr.best_err || tr.best_err >= kBig) {
    tr.fmt = with_alpha ? FMT_RGBA : FMT_RGB;
    for (int i = 0; i < 4; ++i) {
      tr.out0[i] = f0[i];
      tr.out1[i] = f1[i];
    }
  }
  for (int i = 0; i < 4; ++i) {
    vals[2 * i] = tr.out0[i];
    vals[2 * i + 1] = tr.out1[i];
  }
  if (!with_alpha) vals[6] = vals[7] = 0;
  return tr.fmt;
}

// LDR pack_color_endpoints (:1909-2147) for one requested format, with the
// tables of the row's quant level.
template <class Q>
__device__ int pack_ldr_q(const Q& q, const float* ep0, const float* ep1,
                          const float* rgbs, int req_fmt, int* vals) {
  float c0[4], c1[4];
  for (int i = 0; i < 4; ++i) {
    c0[i] = clampf(ep0[i], 0.f, 65535.f) / 257.f;
    c1[i] = clampf(ep1[i], 0.f, 65535.f) / 257.f;
  }
  for (int i = 0; i < 8; ++i) vals[i] = 0;
  const float third = (float)(1.0 / 3.0);
  switch (req_fmt) {
    case FMT_RGB:
      return pack_rgb_or_rgba(q, c0, c1, false, vals);
    case FMT_RGBA:
      return pack_rgb_or_rgba(q, c0, c1, true, vals);
    case FMT_RGB_SCALE:
    case FMT_RGB_SCALE_ALPHA: {
      const float scale = (float)(1.0 / 257.0);
      int qv[3];
      for (int i = 0; i < 3; ++i) {
        const float v = clampf(rgbs[i] * scale, 0.f, 255.f);
        qv[i] = q.res(rtn(v), v);
        vals[i] = qv[i];
      }
      const float oldsum = ((rgbs[0] + rgbs[1]) + rgbs[2]) * scale;
      const float newsum = (float)(qv[0] + qv[1] + qv[2]);
      const float sa = clampf(rgbs[3] * (oldsum + 1e-10f) / (newsum + 1e-10f),
                              0.f, 1.f);
      vals[3] = q.col(clampi(rtn(sa * 256.f), 0, 255));
      if (req_fmt == FMT_RGB_SCALE) return FMT_RGB_SCALE;
      vals[4] = q.res(rtn(c0[3]), c0[3]);
      vals[5] = q.res(rtn(c1[3]), c1[3]);
      return FMT_RGB_SCALE_ALPHA;
    }
    case FMT_LUMINANCE_ALPHA: {
      const float l0 = ((c0[0] + c0[1]) + c0[2]) * third;
      const float l1 = ((c1[0] + c1[1]) + c1[2]) * third;
      int d[4];
      const bool okl = chan_delta(q, l0, l1, &d[0], &d[1]);
      const bool oka = chan_delta(q, c0[3], c1[3], &d[2], &d[3]);
      if (okl && oka && q.qidx <= 18 - 4) {
        for (int i = 0; i < 4; ++i) vals[i] = d[i];
        return FMT_LUMINANCE_ALPHA_DELTA;
      }
      vals[0] = q.res(rtn(l0), l0);
      vals[1] = q.res(rtn(l1), l1);
      vals[2] = q.res(rtn(c0[3]), c0[3]);
      vals[3] = q.res(rtn(c1[3]), c1[3]);
      return FMT_LUMINANCE_ALPHA;
    }
    default: {   // FMT_LUMINANCE, and any other request
      float l0 = ((c0[0] + c0[1]) + c0[2]) * third;
      float l1 = ((c1[0] + c1[1]) + c1[2]) * third;
      if (l0 > l1) {
        const float avg = (l0 + l1) * 0.5f;
        l0 = l1 = avg;
      }
      vals[0] = q.res(rtn(l0), l0);
      vals[1] = q.res(rtn(l1), l1);
      return FMT_LUMINANCE;
    }
  }
}

// pack_ldr_q with the (2, 17, 256) lo/hi tables in global memory (K2, K3).
__device__ int pack_ldr(const int* lohi, const float* ep0, const float* ep1,
                        const float* rgbs, int req_fmt, int quant_level,
                        int* vals) {
  Quant q;
  q.qidx = clampi(quant_level - 4, 0, 16);
  q.lo = lohi + q.qidx * 256;
  q.hi = lohi + 17 * 256 + q.qidx * 256;
  return pack_ldr_q(q, ep0, ep1, rgbs, req_fmt, vals);
}

// LDR unpack_color_endpoints (astcenc_color_unquantize.cpp:844-1023).
__device__ void unpack_ldr(int fmt, const int* v, int profile, int* e0,
                           int* e1) {
  const int v0[4] = {v[0], v[2], v[4], fmt == FMT_RGBA || fmt == FMT_RGBA_DELTA ? v[6] : 0};
  const int v1[4] = {v[1], v[3], v[5], fmt == FMT_RGBA || fmt == FMT_RGBA_DELTA ? v[7] : 0};
  switch (fmt) {
    case FMT_LUMINANCE:
      for (int i = 0; i < 3; ++i) { e0[i] = v[0]; e1[i] = v[1]; }
      e0[3] = e1[3] = 255;
      break;
    case FMT_LUMINANCE_DELTA: {
      const int l0 = (v[0] >> 2) | (v[1] & 0xC0);
      const int l1 = min(l0 + (v[1] & 0x3F), 255);
      for (int i = 0; i < 3; ++i) { e0[i] = l0; e1[i] = l1; }
      e0[3] = e1[3] = 255;
      break;
    }
    case FMT_LUMINANCE_ALPHA:
      for (int i = 0; i < 3; ++i) { e0[i] = v[0]; e1[i] = v[1]; }
      e0[3] = v[2];
      e1[3] = v[3];
      break;
    case FMT_LUMINANCE_ALPHA_DELTA: {
      const int lum0 = (v[0] | ((v[1] & 0x80) << 1)) >> 1;
      const int alp0 = (v[2] | ((v[3] & 0x80) << 1)) >> 1;
      int lum1 = v[1] & 0x7F, alp1 = v[3] & 0x7F;
      lum1 = ((lum1 & 0x40) ? lum1 - 0x80 : lum1) >> 1;
      alp1 = ((alp1 & 0x40) ? alp1 - 0x80 : alp1) >> 1;
      lum1 = clampi(lum1 + lum0, 0, 255);
      alp1 = clampi(alp1 + alp0, 0, 255);
      for (int i = 0; i < 3; ++i) { e0[i] = lum0; e1[i] = lum1; }
      e0[3] = alp0;
      e1[3] = alp1;
      break;
    }
    case FMT_RGB_SCALE:
    case FMT_RGB_SCALE_ALPHA:
      for (int i = 0; i < 3; ++i) {
        e0[i] = (v[i] * v[3]) >> 8;
        e1[i] = v[i];
      }
      e0[3] = fmt == FMT_RGB_SCALE ? 255 : v[4];
      e1[3] = fmt == FMT_RGB_SCALE ? 255 : v[5];
      break;
    case FMT_RGB:
    case FMT_RGBA:
      rgba_unpack(v0, v1, e0, e1);
      if (fmt == FMT_RGB) e0[3] = e1[3] = 255;
      break;
    case FMT_RGB_DELTA:
    case FMT_RGBA_DELTA:
      rgba_delta_unpack(v0, v1, e0, e1);
      if (fmt == FMT_RGB_DELTA) e0[3] = e1[3] = 255;
      break;
    default:   // HDR formats decode as the error colour in LDR profiles
      e0[0] = e1[0] = 255;
      e0[1] = e1[1] = 0;
      e0[2] = e1[2] = 255;
      e0[3] = e1[3] = 255;
      break;
  }
  for (int i = 0; i < 4; ++i) {
    if (profile == 1) {
      e0[i] *= 257;
      e1[i] *= 257;
    } else {
      e0[i] = (e0[i] << 8) | 0x80;
      e1[i] = (e1[i] << 8) | 0x80;
    }
  }
}

// Sparse decimation stencil of one decimation mode: per texel up to 4
// (weight, integer factor) taps, per weight the ascending list of texels.
struct Stencil {
  const int* tw;    // (T, 4) weight index per texel tap
  const int* ti;    // (T, 4) integer factor 0..16
  const int* wtt;   // (W, K) texel list per weight
  const int* wti;   // (W, K) integer factor
  const int* wtn;   // (W,) list length
  const int* col;   // (W,) parity class
  int K;
};

__device__ __forceinline__ Stencil stencil_of(
    const int* tap_w, const int* tap_i, const int* wt_t, const int* wt_i,
    const int* wt_n, const int* dm_color, int d, int T, int W, int K) {
  return Stencil{tap_w + (size_t)d * T * 4, tap_i + (size_t)d * T * 4,
                 wt_t + (size_t)d * W * K, wt_i + (size_t)d * W * K,
                 wt_n + d * W, dm_color + d * W, K};
}

// Infilled weight of texel t as a float (sum of factor/16 * weight).
__device__ __forceinline__ float infill_f(const Stencil& s, const int* wg,
                                          int t) {
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v += ((float)s.ti[t * 4 + k] * 0.0625f) * (float)wg[s.tw[t * 4 + k]];
  return v;
}

// Decoder infill of texel t: (8 + sum factor * weight) >> 4.
__device__ __forceinline__ float infill_i(const Stencil& s, const int* wg,
                                          int t) {
  int v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) v += s.ti[t * 4 + k] * wg[s.tw[t * 4 + k]];
  return (float)((8 + v) >> 4);
}

// Trial error of a block against its decode: per-texel decoded endpoints
// e0t/e1t (T, 4); channel p2c (or none, -1) takes plane 2's weights.
__device__ float trial_error(int lane, int T, const float* tex,
                             const float* e0t, const float* e1t,
                             const Stencil& s, const int* wg1, const int* wg2,
                             int p2c, const float* cw, bool u8_mask) {
  float e = 0.f;
  for (int t = lane; t < T; t += 32) {
    const float w1 = infill_i(s, wg1, t);
    const float w2 = p2c >= 0 ? infill_i(s, wg2, t) : w1;
    float et = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float w = c == p2c ? w2 : w1;
      float color = floorf((e0t[t * 4 + c] * (64.f - w) + e1t[t * 4 + c] * w
                            + 32.f) / 64.f);
      if (u8_mask) color = floorf(color / 256.f) * 257.f;
      const float dd = fminf(fabsf(tex[t * 4 + c] - color), 1e15f);
      et += (dd * dd) * cw[c];
    }
    e += fminf(et, kBig);
  }
  return warp_sum(e);
}

// Scratch of one warp for realign(): per texel (T,) and per weight (W,).
struct RealignScratch {
  float* inf;
  float* At;
  float* Bt;
  float* Ct;
  float* dlt;
  int* dn;
  int* up;
};

// Parity-class realign of one weight plane (ops/realign.py): the weights
// of one parity class share no texel, so each class moves at once by one
// quantization step up or down where that lowers the error. Channels with
// their bit clear in chmask are not carried by this plane (offset zero).
// Returns whether any weight moved; wg is updated in place.
__device__ bool realign(int lane, int T, int W, int ncolors, const float* tex,
                        const float* e0t, const float* e1t, unsigned chmask,
                        const float* cw, const Stencil& s, const int* pnq,
                        int* wg, const RealignScratch& x) {
  for (int t = lane; t < T; t += 32) {
    x.inf[t] = infill_f(s, wg, t);
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[c] = ((chmask >> c) & 1u)
                 ? (e1t[t * 4 + c] - e0t[t * 4 + c]) * (1.f / 64.f) : 0.f;
    x.Ct[t] = ((o[0] * o[0] * cw[0] + o[1] * o[1] * cw[1])
               + o[2] * o[2] * cw[2]) + o[3] * o[3] * cw[3];
  }
  __syncwarp();
  float sc_w[2];
  for (int j = 0, w = lane; w < W; w += 32, ++j) {
    const int v = clampi(wg[w], 0, 64);
    x.dn[w] = pnq[v * 2];
    x.up[w] = pnq[v * 2 + 1];
    float sc = 0.f;
    for (int k = 0; k < s.wtn[w]; ++k) {
      const float f = (float)s.wti[w * s.K + k] * 0.0625f;
      sc += (f * f) * x.Ct[s.wtt[w * s.K + k]];
    }
    sc_w[j] = sc;
  }
  __syncwarp();
  bool adjusted = false;
  for (int k = 0; k < ncolors; ++k) {
    for (int t = lane; t < T; t += 32) {
      float A = 0.f, B = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float off = ((chmask >> c) & 1u)
            ? (e1t[t * 4 + c] - e0t[t * 4 + c]) * (1.f / 64.f) : 0.f;
        const float diff = (e0t[t * 4 + c] + off * x.inf[t]) - tex[t * 4 + c];
        A += (diff * diff) * cw[c];
        B += (diff * off) * cw[c];
      }
      x.At[t] = A;
      x.Bt[t] = B;
    }
    __syncwarp();
    bool moved = false;
    for (int j = 0, w = lane; w < W; w += 32, ++j) {
      float delta = 0.f;
      if (s.wtn[w] > 0 && s.col[w] == k) {
        float SA = 0.f, SB = 0.f;
        for (int kk = 0; kk < s.wtn[w]; ++kk) {
          const int t = s.wtt[w * s.K + kk];
          SA += x.At[t];
          SB += ((float)s.wti[w * s.K + kk] * 0.0625f) * x.Bt[t];
        }
        const int cur = wg[w];
        const float d_dn = (float)(x.dn[w] - cur);
        const float d_up = (float)(x.up[w] - cur);
        const float e_dn = (SA + (2.f * d_dn) * SB) + (d_dn * d_dn) * sc_w[j];
        const float e_up = (SA + (2.f * d_up) * SB) + (d_up * d_up) * sc_w[j];
        const bool go_up = e_up < SA && e_up < e_dn && cur < 64;
        const bool go_dn = !go_up && e_dn < SA && cur > 0;
        const int nw = go_up ? x.up[w] : (go_dn ? x.dn[w] : cur);
        delta = (float)(nw - cur);
        wg[w] = nw;
        moved = moved || go_up || go_dn;
      }
      x.dlt[w] = delta;
    }
    adjusted = __any_sync(kFull, moved) || adjusted;
    __syncwarp();
    for (int t = lane; t < T; t += 32) {
      float d = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        d += ((float)s.ti[t * 4 + kk] * 0.0625f) * x.dlt[s.tw[t * 4 + kk]];
      x.inf[t] = x.inf[t] + d;
    }
    __syncwarp();
  }
  return adjusted;
}

}  // namespace astc
