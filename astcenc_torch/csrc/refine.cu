// Kernel K2: all R refinement rounds of a 1-plane, 1-partition trial.
//
// Replaces astcenc_tpu/ops/refine_pallas.py::_trial1_full_kernel. One warp
// per (block, candidate) lane; see ops/refine.py for the design note. Each
// round: infill the grid, least-squares endpoint refit
// (ops/recompute.py), LDR colour pack (ops/color_pack.py), decode
// (ops/color_unquant.py), trial error before (round 0) and after a
// parity-class realign (ops/realign.py). The pack and decode are scalar
// code that every lane of the warp runs on the same values.
//
// Trial errors are integer-valued float arithmetic; the refit needs IEEE
// divides and square roots, so this file is built without fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace astc;

constexpr int kWarps = 4;

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

struct Args {
  const int* wgrid0;         // (NC, W)
  const int* dm;             // (NC,)
  const int* wq;             // (NC,)
  const bool* alive;         // (NC,)
  const int* cq;             // (NC,)
  const int* fmt_req;        // (NC,)
  const float* texels;       // (N, T, 4)
  const float* ep0;          // (N, 4)
  const float* ep1;          // (N, 4)
  const int* tap_w;          // (D, T, 4)
  const int* tap_i;          // (D, T, 4)
  const int* wt_t;           // (D, W, K)
  const int* wt_i;           // (D, W, K)
  const int* wt_n;           // (D, W)
  const int* dm_color;       // (D, W)
  const int* pn;             // (12, 65, 2)
  const int* lohi;           // (2, 17, 256)
  int N, C, T, W, D, K, R, ncolors, u8_mask, profile;
  float cw[4];
  int* out_i;                // (R, NC, 16 + W)
  float* out_e;              // (R + 1, NC)
};

// ---------------------------------------------------------------------------
// Colour quantization (astcenc_color_quantize.cpp), scalar per lane.
// ---------------------------------------------------------------------------

struct Quant {
  const int* lo;
  const int* hi;
  int qidx;
  // quant_color: round ties up.
  __device__ int col(int v) const { return __ldg(hi + clampi(v, 0, 255)); }
  // quant_color with the residual bias.
  __device__ int res(int v, float vf) const {
    const int vc = clampi(v, 0, 255);
    return (vf - (float)v >= -0.1f) ? __ldg(hi + vc) : __ldg(lo + vc);
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
__device__ bool rgb_delta(const Quant& q, const float* c0, const float* c1,
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
__device__ bool chan_delta(const Quant& q, float v0, float v1, int* e0,
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
__device__ void quantize_rgb(const Quant& q, const float* c0, const float* c1,
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

__device__ float encoding_error(const float* c0, const float* c1,
                                const int* u0, const int* u1) {
  float acc = 0.f;
  for (int i = 0; i < 4; ++i) {
    const float e0 = c0[i] - (float)u0[i];
    const float e1 = c1[i] - (float)u1[i];
    acc += e0 * e0 + e1 * e1;
  }
  return acc;
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
__device__ int pack_rgb_or_rgba(const Quant& q, const float* c0,
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

// LDR pack_color_endpoints (:1909-2147) for one requested format.
__device__ int pack_ldr(const int* lohi, const float* ep0, const float* ep1,
                        const float* rgbs, int req_fmt, int quant_level,
                        int* vals) {
  Quant q;
  q.qidx = clampi(quant_level - 4, 0, 16);
  q.lo = lohi + q.qidx * 256;
  q.hi = lohi + 17 * 256 + q.qidx * 256;
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

__host__ __device__ inline int warp_words(int T, int W) { return 8 * T + 4 * W; }

__global__ void __launch_bounds__(kWarps * 32)
refine_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int NC = a.N * a.C;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= NC) return;
  const int T = a.T, W = a.W, K = a.K;
  const int b = i / a.C;
  const float cw0 = a.cw[0], cw1 = a.cw[1], cw2 = a.cw[2], cw3 = a.cw[3];
  const float cw[4] = {cw0, cw1, cw2, cw3};
  const float ls_weight = (float)((double)cw0 + (double)cw1 + (double)cw2);

  float* tex = smem + warp * warp_words(T, W);   // (T, 4)
  float* scale_t = tex + 4 * T;
  float* inf = scale_t + T;    // undecimated / infilled weights
  float* At = inf + T;
  float* Bt = At + T;
  float* dlt = Bt + T;         // (W,) realign deltas
  int* wg = reinterpret_cast<int*>(dlt + W);
  int* dn = wg + W;
  int* up = dn + W;

  for (int j = lane; j < 4 * T; j += 32) tex[j] = a.texels[(size_t)b * T * 4 + j];
  for (int w = lane; w < W; w += 32) wg[w] = a.wgrid0[(size_t)i * W + w];
  __syncwarp();

  const int d = a.dm[i];
  const int q = a.wq[i];
  bool alive = a.alive[i];
  const int cqv = a.cq[i];
  const int freq = a.fmt_req[i];
  const int* tw = a.tap_w + (size_t)d * T * 4;
  const int* ti = a.tap_i + (size_t)d * T * 4;
  const int* wtt = a.wt_t + (size_t)d * W * K;
  const int* wti = a.wt_i + (size_t)d * W * K;
  const int* wtn = a.wt_n + d * W;
  const int* col = a.dm_color + d * W;
  const int* pnq = a.pn + q * 65 * 2;
  float e0c[4], e1c[4];
  for (int c = 0; c < 4; ++c) {
    e0c[c] = a.ep0[b * 4 + c];
    e1c[c] = a.ep1[b * 4 + c];
  }

  // Round-independent refit terms: channel sums and the RGB scale line.
  float rsum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = lane; t < T; t += 32)
    for (int c = 0; c < 4; ++c) rsum[c] += tex[t * 4 + c];
  float rws[4], sd[3];
  for (int c = 0; c < 4; ++c) {
    rsum[c] = warp_sum(rsum[c]) * cw[c];
    rws[c] = fmaxf(cw[c] * (float)T, 1e-17f);
  }
  {
    float mean[3];
    for (int c = 0; c < 3; ++c) mean[c] = rsum[c] / rws[c];
    const float norm = sqrtf((mean[0] * mean[0] + mean[1] * mean[1])
                             + mean[2] * mean[2]);
    for (int c = 0; c < 3; ++c) sd[c] = mean[c] / (norm > 0.f ? norm : 1.f);
  }
  float smin = 1e10f, smax = -1e10f;
  for (int t = lane; t < T; t += 32) {
    const float s = (sd[0] * tex[t * 4] + sd[1] * tex[t * 4 + 1])
                    + sd[2] * tex[t * 4 + 2];
    scale_t[t] = s;
    smin = fminf(smin, s);
    smax = fmaxf(smax, s);
  }
  smin = warp_min(smin);
  smax = warp_max(smax);
  const float scalediv = clampf(smin / fmaxf(smax, 1e-10f), 0.f, 1.f);
  float sds[3];
  for (int c = 0; c < 3; ++c) sds[c] = sd[c] * smax;
  __syncwarp();

  auto trial_err = [&](const int* e0i, const int* e1i) -> float {
    float e = 0.f;
    for (int t = lane; t < T; t += 32) {
      int s = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += ti[t * 4 + k] * wg[tw[t * 4 + k]];
      const float w = (float)((8 + s) >> 4);
      float et = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float color = floorf(((float)e0i[c] * (64.f - w) + (float)e1i[c] * w
                              + 32.f) / 64.f);
        if (a.u8_mask) color = floorf(color / 256.f) * 257.f;
        const float dd = fminf(fabsf(tex[t * 4 + c] - color), 1e15f);
        et += (dd * dd) * cw[c];
      }
      e += fminf(et, kBig);
    }
    return warp_sum(e);
  };

  for (int r = 0; r < a.R; ++r) {
    // --- infill + least-squares refit ---------------------------------
    float wmin = 1.f, wmax = 0.f, ls = 0.f, ms = 0.f, rs = 0.f;
    float cvy[4] = {0.f, 0.f, 0.f, 0.f}, cvx[4] = {0.f, 0.f, 0.f, 0.f};
    float sv0 = 0.f, sv1 = 0.f;
    for (int t = lane; t < T; t += 32) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s += ((float)ti[t * 4 + k] * 0.0625f) * (float)wg[tw[t * 4 + k]];
      const float idx = s / 64.f;
      const float om = 1.f - idx;
      wmin = fminf(wmin, idx);
      wmax = fmaxf(wmax, idx);
      ls += om * om;
      ms += om * idx;
      rs += idx * idx;
      for (int c = 0; c < 4; ++c) {
        cvy[c] += tex[t * 4 + c] * idx;
        cvx[c] += tex[t * 4 + c] * om;
      }
      sv0 += om * scale_t[t];
      sv1 += idx * scale_t[t];
    }
    wmin = warp_min(wmin);
    wmax = warp_max(wmax);
    ls = warp_sum(ls);
    ms = warp_sum(ms);
    rs = warp_sum(rs);
    for (int c = 0; c < 4; ++c) {
      cvy[c] = warp_sum(cvy[c]) * cw[c];
      cvx[c] = warp_sum(cvx[c]) * cw[c];
    }
    sv0 = warp_sum(sv0) * ls_weight;
    sv1 = warp_sum(sv1) * ls_weight;

    const bool all_same = wmin >= wmax * 0.999f;
    float ep0[4], ep1[4], rgbs[4];
    for (int c = 0; c < 4; ++c) {
      const float left = ls * cw[c], middle = ms * cw[c], right = rs * cw[c];
      const float det = left * right - middle * middle;
      const float rdet = 1.f / det;
      const float mss = (left * left + (2.f * middle) * middle) + right * right;
      const float e0f = (right * cvx[c] - middle * cvy[c]) * rdet;
      const float e1f = (left * cvy[c] - middle * cvx[c]) * rdet;
      const bool full = fabsf(det) > mss * 1e-4f && !isnan(e0f) && !isnan(e1f);
      const float avg = (cvx[c] + cvy[c]) / rws[c];
      if (all_same) {
        ep0[c] = isnan(avg) ? e0c[c] : avg;
        ep1[c] = isnan(avg) ? e1c[c] : avg;
      } else {
        ep0[c] = full ? e0f : e0c[c];
        ep1[c] = full ? e1f : e1c[c];
      }
    }
    {
      const float lm0 = ls * ls_weight, lm1 = ms * ls_weight, lm2 = rs * ls_weight;
      const float ls_det = lm0 * lm2 - lm1 * lm1;
      const float ls_rdet = 1.f / ls_det;
      const float ls_mss = (lm0 * lm0 + (2.f * lm1) * lm1) + lm2 * lm2;
      const float se0 = (lm2 * sv0 - lm1 * sv1) * ls_rdet;
      const float se1 = (lm0 * sv1 - lm1 * sv0) * ls_rdet;
      const bool ls_ok = fabsf(ls_det) > ls_mss * 1e-4f && !isnan(se0)
                         && !isnan(se1) && se0 < se1;
      for (int c = 0; c < 3; ++c)
        rgbs[c] = all_same ? sds[c] : (ls_ok ? sd[c] * se1 : sds[c]);
      rgbs[3] = all_same ? 1.f
                         : (ls_ok ? se0 / (se1 != 0.f ? se1 : 1.f) : scalediv);
    }
    for (int c = 0; c < 4; ++c) {
      e0c[c] = ep0[c];
      e1c[c] = ep1[c];
    }

    // --- pack + decode ------------------------------------------------
    int vals[8];
    const int fmt = pack_ldr(a.lohi, ep0, ep1, rgbs, freq, cqv, vals);
    int e0i[4], e1i[4];
    unpack_ldr(fmt, vals, a.profile, e0i, e1i);

    if (r == 0) {
      const float ep = trial_err(e0i, e1i);
      if (lane == 0) a.out_e[i] = alive ? ep : kBig;
    }

    // --- parity-class realign -------------------------------------------
    bool adjusted = false;
    if (alive) {
      float off[4];
      for (int c = 0; c < 4; ++c) off[c] = (float)(e1i[c] - e0i[c]) * (1.f / 64.f);
      const float Ct = ((off[0] * off[0] * cw0 + off[1] * off[1] * cw1)
                        + off[2] * off[2] * cw2) + off[3] * off[3] * cw3;
      for (int t = lane; t < T; t += 32) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s += ((float)ti[t * 4 + k] * 0.0625f) * (float)wg[tw[t * 4 + k]];
        inf[t] = s;
      }
      float sc_w[2];
      for (int j = 0, w = lane; w < W; w += 32, ++j) {
        const int v = clampi(wg[w], 0, 64);
        dn[w] = pnq[v * 2];
        up[w] = pnq[v * 2 + 1];
        float sc = 0.f;
        for (int k = 0; k < wtn[w]; ++k) {
          const float f = (float)wti[w * K + k] * 0.0625f;
          sc += (f * f) * Ct;
        }
        sc_w[j] = sc;
      }
      __syncwarp();
      const int wc_limit = W;
      for (int k = 0; k < a.ncolors; ++k) {
        for (int t = lane; t < T; t += 32) {
          float A = 0.f, B = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float diff = ((float)e0i[c] + off[c] * inf[t]) - tex[t * 4 + c];
            A += (diff * diff) * cw[c];
            B += (diff * off[c]) * cw[c];
          }
          At[t] = A;
          Bt[t] = B;
        }
        __syncwarp();
        bool moved = false;
        for (int j = 0, w = lane; w < wc_limit; w += 32, ++j) {
          float delta = 0.f;
          if (wtn[w] > 0 && col[w] == k) {
            float SA = 0.f, SB = 0.f;
            for (int kk = 0; kk < wtn[w]; ++kk) {
              const int t = wtt[w * K + kk];
              SA += At[t];
              SB += ((float)wti[w * K + kk] * 0.0625f) * Bt[t];
            }
            const int cur = wg[w];
            const float d_dn = (float)(dn[w] - cur);
            const float d_up = (float)(up[w] - cur);
            const float e_dn = (SA + (2.f * d_dn) * SB) + (d_dn * d_dn) * sc_w[j];
            const float e_up = (SA + (2.f * d_up) * SB) + (d_up * d_up) * sc_w[j];
            const bool go_up = e_up < SA && e_up < e_dn && cur < 64;
            const bool go_dn = !go_up && e_dn < SA && cur > 0;
            const int nw = go_up ? up[w] : (go_dn ? dn[w] : cur);
            delta = (float)(nw - cur);
            wg[w] = nw;
            moved = moved || go_up || go_dn;
          }
          dlt[w] = delta;
        }
        adjusted = __any_sync(kFull, moved) || adjusted;
        __syncwarp();
        for (int t = lane; t < T; t += 32) {
          float s = 0.f;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            s += ((float)ti[t * 4 + kk] * 0.0625f) * dlt[tw[t * 4 + kk]];
          inf[t] = inf[t] + s;
        }
        __syncwarp();
      }
    }
    const float ep = trial_err(e0i, e1i);
    int* o = a.out_i + ((size_t)r * NC + i) * (16 + W);
    if (lane == 0) {
      a.out_e[(size_t)(r + 1) * NC + i] = alive ? ep : kBig;
      o[0] = fmt;
      for (int k = 0; k < 8; ++k) o[1 + k] = vals[k];
      for (int k = 9; k < 16; ++k) o[k] = 0;
    }
    for (int w = lane; w < W; w += 32) o[16 + w] = wg[w];
    alive = alive && adjusted;
    __syncwarp();
  }
}

}  // namespace

extern "C" int astc_refine(
    const int* wgrid0, const int* dm, const int* wq, const bool* alive,
    const int* cq, const int* fmt_req, const float* texels, const float* ep0,
    const float* ep1, const int* tap_w, const int* tap_i, const int* wt_t,
    const int* wt_i, const int* wt_n, const int* dm_color, const int* pn,
    const int* lohi, int N, int C, int T, int W, int D, int K, int R,
    int ncolors, int u8_mask, int profile, float cw0, float cw1, float cw2,
    float cw3, int* out_i, float* out_e, void* stream) {
  if (N < 0 || C < 1 || W > 64 || T > 216 || R < 1 || (profile != 0 && profile != 1))
    return (int)cudaErrorInvalidValue;
  Args a{wgrid0, dm, wq, alive, cq, fmt_req, texels, ep0, ep1, tap_w, tap_i,
         wt_t, wt_i, wt_n, dm_color, pn, lohi, N, C, T, W, D, K, R, ncolors,
         u8_mask, profile, {cw0, cw1, cw2, cw3}, out_i, out_e};
  const size_t smem = sizeof(float) * (size_t)warp_words(T, W) * kWarps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long lanes = (long long)N * C;
  const long long grid = (lanes + kWarps - 1) / kWarps;
  if (grid == 0) return 0;
  refine_kernel<<<(unsigned)grid, kWarps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
