// Shared device code of kernels K2 (refine.cu), K3 (refine2.cu), K5
// (refine_round.cu), K6 (refine_round2.cu) and the colour pack
// (color_pack.cu): the LDR colour pack and decode, the trial error and the
// parity-class realign of a decimated weight grid. The pack and decode are
// scalar code for one thread; the trial error and the realign split
// texels and weights over the lanes of a warp and reduce with shuffles.
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

// One of the four trial encodings of an RGB(A) pack: its encoding error,
// whether it may be taken, its format and its values.
struct RgbTrial {
  float err;
  int ok, fmt, e0[4], e1[4];
};

// Trial k of pack_rgb_or_rgba (:1933-2096), in its order: 0 delta with
// blue contract, 1 delta, 2 blue contract, 3 the quantize_rgb fallback.
// K2 runs the four on four lanes; pack_rgb_or_rgba runs them in turn.
template <class Q>
__device__ void rgb_trial(const Q& q, const float* c0, const float* c1,
                          bool with_alpha, int k, RgbTrial& t) {
  int e0[4], e1[4], u0[4], u1[4];
  bool ok = true;
  if (k <= 1) {
    const bool delta_ok_quant = q.qidx <= 18 - 4;
    if (k == 0) {
      float bc0[4], bc1[4];
      blue_contract(c1, bc0);     // delta blue contract: swapped inputs
      blue_contract(c0, bc1);
      ok = in_range(bc0) && in_range(bc1);
      ok = rgb_delta(q, bc0, bc1, true, e0, e1) && ok;
    } else {
      ok = rgb_delta(q, c0, c1, false, e0, e1);
    }
    if (with_alpha) {
      int a0, a1;
      const bool oka = k == 0 ? chan_delta(q, c1[3], c0[3], &a0, &a1)
                              : chan_delta(q, c0[3], c1[3], &a0, &a1);
      e0[3] = a0;
      e1[3] = a1;
      ok = ok && oka;
    }
    ok = ok && delta_ok_quant;
    t.fmt = with_alpha ? FMT_RGBA_DELTA : FMT_RGB_DELTA;
    rgba_delta_unpack(e0, e1, u0, u1);
  } else if (k == 2) {
    // Blue contract, non-delta: outputs swap (and alpha swaps with them).
    float bc0[4], bc1[4];
    blue_contract(c0, bc0);
    blue_contract(c1, bc1);
    ok = in_range(bc0) && in_range(bc1);
    for (int i = 0; i < 4; ++i) {
      e1[i] = q.res(rtn(bc0[i]), bc0[i]);
      e0[i] = q.res(rtn(bc1[i]), bc1[i]);
    }
    ok = ok && sum3(e0) > sum3(e1);
    if (with_alpha) {
      e0[3] = q.res(rtn(c1[3]), c1[3]);
      e1[3] = q.res(rtn(c0[3]), c0[3]);
    }
    ok = ok && q.qidx < 16;
    t.fmt = with_alpha ? FMT_RGBA : FMT_RGB;
    rgba_unpack(e0, e1, u0, u1);
  } else {
    quantize_rgb(q, c0, c1, e0, e1);
    if (with_alpha) {
      e0[3] = q.res(rtn(c0[3]), c0[3]);
      e1[3] = q.res(rtn(c1[3]), c1[3]);
    }
    t.fmt = with_alpha ? FMT_RGBA : FMT_RGB;
    rgba_unpack(e0, e1, u0, u1);
  }
  if (!with_alpha) u0[3] = u1[3] = 255;
  t.err = encoding_error(c0, c1, u0, u1);
  t.ok = ok ? 1 : 0;
  for (int i = 0; i < 4; ++i) {
    t.e0[i] = e0[i];
    t.e1[i] = e1[i];
  }
}

// pack_rgb_or_rgba's choice, fed trial k = 0, 1, 2, 3 in turn: the first
// strict minimum of the first three that may be taken, then the fallback
// where it is better or nothing was taken. Whether trial k is the choice
// so far.
__device__ __forceinline__ bool rgb_better(float& best, int k,
                                           const RgbTrial& t) {
  const bool take = k < 3 ? t.ok && t.err < best
                          : t.err < best || best >= kBig;
  if (take) best = t.err;
  return take;
}

// The chosen trial's values, in pack order, and its format.
__device__ __forceinline__ int rgb_emit(const RgbTrial& t, bool with_alpha,
                                        int* vals) {
  for (int i = 0; i < 4; ++i) {
    vals[2 * i] = t.e0[i];
    vals[2 * i + 1] = t.e1[i];
  }
  if (!with_alpha) vals[6] = vals[7] = 0;
  return t.fmt;
}

// The choice among four trials held side by side (K2).
__device__ int rgb_choose(const RgbTrial* t, bool with_alpha, int* vals) {
  float best = kBig;
  int pick = 3;
  for (int k = 0; k < 4; ++k)
    if (rgb_better(best, k, t[k])) pick = k;
  return rgb_emit(t[pick], with_alpha, vals);
}

// FMT_RGB / FMT_RGBA with delta and blue-contract trials (:1933-2096).
template <class Q>
__device__ int pack_rgb_or_rgba(const Q& q, const float* c0,
                                const float* c1, bool with_alpha, int* vals) {
  RgbTrial t, pick;
  float best = kBig;
  for (int k = 0; k < 4; ++k) {
    rgb_trial(q, c0, c1, with_alpha, k, t);
    if (rgb_better(best, k, t)) pick = t;
  }
  return rgb_emit(pick, with_alpha, vals);
}

// The endpoints of one partition on the 0..255 scale of the LDR pack.
__device__ __forceinline__ void ldr_colors(const float* ep0, const float* ep1,
                                           float* c0, float* c1) {
  for (int i = 0; i < 4; ++i) {
    c0[i] = clampf(ep0[i], 0.f, 65535.f) / 257.f;
    c1[i] = clampf(ep1[i], 0.f, 65535.f) / 257.f;
  }
}

// The LDR pack of every requested format but FMT_RGB and FMT_RGBA, from
// the endpoints on the 0..255 scale (ldr_colors). K2 runs this and the
// RGB(A) trials apart, so it carries no dead copy of the other.
template <class Q>
__device__ int pack_ldr_other(const Q& q, const float* c0, const float* c1,
                              const float* rgbs, int req_fmt, int* vals) {
  for (int i = 0; i < 8; ++i) vals[i] = 0;
  const float third = (float)(1.0 / 3.0);
  switch (req_fmt) {
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

// LDR pack_color_endpoints (:1909-2147) for one requested format, with the
// tables of the row's quant level.
template <class Q>
__device__ int pack_ldr_q(const Q& q, const float* ep0, const float* ep1,
                          const float* rgbs, int req_fmt, int* vals) {
  float c0[4], c1[4];
  ldr_colors(ep0, ep1, c0, c1);
  if (req_fmt == FMT_RGB || req_fmt == FMT_RGBA)
    return pack_rgb_or_rgba(q, c0, c1, req_fmt == FMT_RGBA, vals);
  return pack_ldr_other(q, c0, c1, rgbs, req_fmt, vals);
}

// pack_ldr_q with the (2, 17, 256) lo/hi tables in global memory (K3).
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

// Trial error of a block against its decode: decoded endpoints e0t/e1t of
// texel t at [t * ES + c] (ES = 4: one per texel, (T, 4); ES = 0: the same
// four for every texel); channel p2c (or none, -1) takes plane 2's weights.
// G lanes run it: a warp, or a half-warp whose lane l takes the texels
// lanes l and l + 16 of a warp would and adds their two sums as a warp's
// butterfly does first, so that the result is the warp's bit for bit (the
// other half-warp runs its own block beside it).
template <int ES = 4, int G = 32>
__device__ float trial_error(int lane, int T, const float* tex,
                             const float* e0t, const float* e1t,
                             const Stencil& s, const int* wg1, const int* wg2,
                             int p2c, const float* cw, bool u8_mask) {
  auto texel = [&](int t) {
    const float w1 = infill_i(s, wg1, t);
    const float w2 = p2c >= 0 ? infill_i(s, wg2, t) : w1;
    float et = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float w = c == p2c ? w2 : w1;
      float color = floorf((e0t[t * ES + c] * (64.f - w) + e1t[t * ES + c] * w
                            + 32.f) / 64.f);
      if (u8_mask) color = floorf(color / 256.f) * 257.f;
      const float dd = fminf(fabsf(tex[t * 4 + c] - color), 1e15f);
      et += (dd * dd) * cw[c];
    }
    return fminf(et, kBig);
  };
  float e = 0.f;
  for (int t = lane; t < T; t += 32) e += texel(t);
  if (G == 32) return warp_sum(e);
  float e16 = 0.f;
  for (int t = lane + 16; t < T; t += 32) e16 += texel(t);
  e += e16;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) e += __shfl_xor_sync(kFull, e, o);
  return e;
}

constexpr int kMaxClasses = 8;   // parity classes of a weight grid

// Scratch of one realign() at a time: per texel (T,): inf, At, Bt, Ct; per
// weight (W,): dlt, sc, dn, up, cls; cls_off (kMaxClasses + 1,). The class
// lists (cls, cls_off) depend on the stencil alone, so two realigns of one
// stencil may share them.
struct RealignScratch {
  float* inf;
  float* At;
  float* Bt;
  float* Ct;
  float* dlt;
  float* sc;
  int* dn;
  int* up;
  int* cls;      // class k's weights: cls[cls_off[k]..cls_off[k + 1])
  int* cls_off;
};

// Words of a RealignScratch (floats and ints), laid out from p in the
// order above.
__host__ __device__ inline int realign_words(int T, int W) {
  return 4 * T + 5 * W + kMaxClasses + 1;
}

__device__ inline RealignScratch realign_scratch(float* p, int T, int W) {
  RealignScratch x;
  x.inf = p;
  x.At = x.inf + T;
  x.Bt = x.At + T;
  x.Ct = x.Bt + T;
  x.dlt = x.Ct + T;
  x.sc = x.dlt + W;
  x.dn = reinterpret_cast<int*>(x.sc + W);
  x.up = x.dn + W;
  x.cls = x.up + W;
  x.cls_off = x.cls + W;
  return x;
}

// The weights of each parity class (those with texels), once per stencil:
// every realign() of the same decimation reads these lists.
__device__ void realign_classes(int lane, int W, int ncolors,
                                const Stencil& s, const RealignScratch& x) {
  int n = 0;                   // the same on every lane
  for (int k = 0; k < ncolors; ++k) {
    if (lane == 0) x.cls_off[k] = n;
    for (int base = 0; base < W; base += 32) {
      const int w = base + lane;
      const bool in = w < W && s.wtn[w] > 0 && s.col[w] == k;
      const unsigned m = __ballot_sync(kFull, in);
      if (in) x.cls[n + __popc(m & ((1u << lane) - 1u))] = w;
      n += __popc(m);
    }
  }
  if (lane == 0) x.cls_off[ncolors] = n;
  __syncwarp();
}

// Parity-class realign of one weight plane (ops/realign.py): the weights
// of one parity class share no texel, so each class moves at once by one
// quantization step up or down where that lowers the error. Channels with
// their bit clear in chmask are not carried by this plane (offset zero).
// Each texel's terms A, B are refreshed in the pass that moves its infill
// (the next class reads only those); the last class's infill update, which
// nothing reads, is skipped. Needs realign_classes() of the same stencil.
// Returns whether any weight moved; wg is updated in place.
//
// G lanes run it (lane 0..G-1 of the group whose lanes gmask names): a
// warp, or a half-warp so that a warp realigns two planes at once. Every
// texel's and every weight's terms are taken by one lane, so the results
// do not depend on G. Endpoints as for trial_error (ES).
template <int G = 32, int ES = 4>
__device__ bool realign(int lane, int T, int W, int ncolors, const float* tex,
                        const float* e0t, const float* e1t, unsigned chmask,
                        const float* cw, const Stencil& s, const int* pnq,
                        int* wg, const RealignScratch& x,
                        unsigned gmask = kFull) {
  auto off_of = [&](int t, int c) {
    return ((chmask >> c) & 1u)
               ? (e1t[t * ES + c] - e0t[t * ES + c]) * (1.f / 64.f) : 0.f;
  };
  auto terms = [&](int t, float inf) {
    float A = 0.f, B = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float off = off_of(t, c);
      const float diff = (e0t[t * ES + c] + off * inf) - tex[t * 4 + c];
      A += (diff * diff) * cw[c];
      B += (diff * off) * cw[c];
    }
    x.At[t] = A;
    x.Bt[t] = B;
  };
  for (int t = lane; t < T; t += G) {
    const float inf = infill_f(s, wg, t);
    x.inf[t] = inf;
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = off_of(t, c);
    x.Ct[t] = ((o[0] * o[0] * cw[0] + o[1] * o[1] * cw[1])
               + o[2] * o[2] * cw[2]) + o[3] * o[3] * cw[3];
    terms(t, inf);
  }
  __syncwarp(gmask);
  for (int w = lane; w < W; w += G) {
    const int v = clampi(wg[w], 0, 64);
    x.dn[w] = pnq[v * 2];
    x.up[w] = pnq[v * 2 + 1];
    float c = 0.f;
    for (int k = 0; k < s.wtn[w]; ++k) {
      const float f = (float)s.wti[w * s.K + k] * 0.0625f;
      c += (f * f) * x.Ct[s.wtt[w * s.K + k]];
    }
    x.sc[w] = c;
    x.dlt[w] = 0.f;
  }
  __syncwarp(gmask);
  bool adjusted = false;
  for (int k = 0; k < ncolors; ++k) {
    bool moved = false;
    for (int j = x.cls_off[k] + lane; j < x.cls_off[k + 1]; j += G) {
      const int w = x.cls[j];
      float SA = 0.f, SB = 0.f;
      for (int kk = 0; kk < s.wtn[w]; ++kk) {
        const int t = s.wtt[w * s.K + kk];
        SA += x.At[t];
        SB += ((float)s.wti[w * s.K + kk] * 0.0625f) * x.Bt[t];
      }
      const int cur = wg[w];
      const float d_dn = (float)(x.dn[w] - cur);
      const float d_up = (float)(x.up[w] - cur);
      const float e_dn = (SA + (2.f * d_dn) * SB) + (d_dn * d_dn) * x.sc[w];
      const float e_up = (SA + (2.f * d_up) * SB) + (d_up * d_up) * x.sc[w];
      const bool go_up = e_up < SA && e_up < e_dn && cur < 64;
      const bool go_dn = !go_up && e_dn < SA && cur > 0;
      const int nw = go_up ? x.up[w] : (go_dn ? x.dn[w] : cur);
      x.dlt[w] = (float)(nw - cur);
      wg[w] = nw;
      moved = moved || go_up || go_dn;
    }
    // The previous class's deltas are spent.
    if (k > 0)
      for (int j = x.cls_off[k - 1] + lane; j < x.cls_off[k]; j += G)
        x.dlt[x.cls[j]] = 0.f;
    adjusted = __any_sync(gmask, moved) || adjusted;
    __syncwarp(gmask);
    if (k == ncolors - 1) break;
    for (int t = lane; t < T; t += G) {
      float d = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        d += ((float)s.ti[t * 4 + kk] * 0.0625f) * x.dlt[s.tw[t * 4 + kk]];
      const float inf = x.inf[t] + d;
      x.inf[t] = inf;
      terms(t, inf);
    }
    __syncwarp(gmask);
  }
  return adjusted;
}

}  // namespace astc
