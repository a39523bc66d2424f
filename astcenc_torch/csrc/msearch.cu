// Kernel K1: trial front end (mode search), 1 or 2 planes, 1-4 partitions.
//
// Replaces astcenc_tpu/ops/msearch_pallas.py::_ms_kernel. One warp per
// ASTC block, lanes over weights and texels; see ops/msearch.py for the
// design note. Per block and per plane:
//   1. ideal decimated weights of every decimation in the pass
//      (weighted average + one gradient step),
//   2. angular [low, high] weight ranges per (decimation, quant <= 7);
// then per mode:
//   3. quantize each plane's grid into its range, weight-set error,
//      endpoint formats/quant from the combined colour-error table
//      (for 2-4 partitions: the best format combination per total integer
//      count, and the quant of the matched-format encoding),
//   4. top-C modes by insertion with strict < (earlier mode wins ties).
// Arithmetic follows the XLA formulation of the JAX package; sums run in
// another order (per-weight texel lists, warp butterflies).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace astc;

constexpr int kWarps = 4;
constexpr int kMaxC = 8;
constexpr int kMeta = 40;

__constant__ int kSteps[12] = {2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32};

struct Args {
  const float* wei;        // (N, T)
  const float* wes;        // (N, T)
  const float* mcut;       // (N,)
  const float* wei2;       // (N, T) plane 2, or null
  const float* wes2;       // (N, T)
  const float* mcut2;      // (N,)
  const int* maxwq;        // (N,)
  const float* comb_err;   // (N, 21, S)
  const int* comb_fmt;     // (N, 21, S, pc)
  const int* tap_w;        // (D, T, 4) weight index per texel tap
  const int* tap_i;        // (D, T, 4) integer factor (0..16)
  const int* wt_t;         // (D, W, K) texel list per weight
  const int* wt_i;         // (D, W, K) integer factor
  const int* wt_n;         // (D, W)   list length
  const int* wcount;       // (D,)
  const int* maxprec;      // (D,)
  const int* modes;        // (M, 40) mode_meta_array rows
  const int* unq;          // (12, 32) weight value-rank -> unquant
  const float* sin_t;      // (64, 32)
  const float* cos_t;      // (64, 32)
  const int* levels_used;  // (D,) bitmask of angular levels needed
  int N, T, W, D, K, M, C, S, pc, two;
  int* out_i;              // (N, C, 16 + W * (1 + two))
  float* out_e;            // (N, C)
};

// Shared floats per warp and plane: wei, wes, scratch (T each), ideal
// decimated weights (D, W), angular ranges (D, 8) x 2, the current
// quantized grid as float and int (W each), the top-C grids (C, W).
__host__ __device__ inline int plane_floats(int T, int W, int D, int C) {
  return 3 * T + D * W + 16 * D + 2 * W + C * W;
}

struct Plane {
  float* wei;
  float* wes;
  float* scr;
  float* di;    // (D, W)
  float* lo;    // (D, 8)
  float* hi;    // (D, 8)
  float* uqf;   // (W,)
  int* uqc;     // (W,)
  int* buq;     // (C, W)
};

__device__ Plane plane_at(float* base, int T, int W, int D) {
  Plane p;
  p.wei = base;
  p.wes = p.wei + T;
  p.scr = p.wes + T;
  p.di = p.scr + T;
  p.lo = p.di + D * W;
  p.hi = p.lo + 8 * D;
  p.uqf = p.hi + 8 * D;
  p.uqc = reinterpret_cast<int*>(p.uqf + W);
  p.buq = p.uqc + W;
  return p;
}

// Stages 1 and 2 for one plane: ideal decimated weights and angular ranges.
__device__ void plane_tables(const Args& a, int lane, const Plane& pl,
                             int maxwq) {
  const int T = a.T, W = a.W, D = a.D, K = a.K;
  for (int d = 0; d < D; ++d) {
    float* dd = pl.di + d * W;
    const int* wtt = a.wt_t + (size_t)d * W * K;
    const int* wti = a.wt_i + (size_t)d * W * K;
    const int* wtn = a.wt_n + d * W;
    const int* tw = a.tap_w + (size_t)d * T * 4;
    const int* ti = a.tap_i + (size_t)d * T * 4;
    for (int w = lane; w < W; w += 32) {
      float num = 0.f, den = 0.f;
      for (int k = 0; k < wtn[w]; ++k) {
        const int t = wtt[w * K + k];
        const float f = (float)wti[w * K + k];
        num += f * (pl.wes[t] * pl.wei[t]);
        den += f * pl.wes[t];
      }
      dd[w] = num / (den + 1e-10f);
    }
    __syncwarp();
    for (int t = lane; t < T; t += 32) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s += ((float)ti[t * 4 + k] * 0.0625f) * dd[tw[t * 4 + k]];
      pl.scr[t] = (s - pl.wei[t]) * pl.wes[t];
    }
    __syncwarp();
    for (int w = lane; w < W; w += 32) {
      float ec0 = 0.f, ec1 = 0.f;
      for (int k = 0; k < wtn[w]; ++k) {
        const int t = wtt[w * K + k];
        const float f = (float)wti[w * K + k];
        ec0 += (f * f) * pl.wes[t];
        ec1 += f * pl.scr[t];
      }
      ec0 += 1e-10f;
      dd[w] = dd[w] + clampf((ec1 * -16.f) / ec0, -0.25f, 0.25f);
    }
    __syncwarp();
  }

  for (int d = 0; d < D; ++d) {
    const int lv = a.levels_used[d];
    if (!lv) continue;
    const float* dd = pl.di + d * W;
    const int wc = a.wcount[d];
    float mn = 3.4e38f, mx = -3.4e38f;
    for (int w = lane; w < wc; w += 32) {
      mn = fminf(mn, dd[w]);
      mx = fmaxf(mx, dd[w]);
    }
    mn = warp_min(mn);
    mx = warp_max(mx);
    const int mp = clampi(min(min(a.maxprec[d], 7), maxwq), 0, 11);
    const int msteps = kSteps[mp];

    float gbest[8], gcut[8], glw[8], goff[8];
    int gbsi[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      gbest[l] = kBig;
      gcut[l] = 0.f;
      gbsi[l] = 0;
      glw[l] = 0.f;
      goff[l] = 0.f;
    }
    for (int s = 0; s < msteps; ++s) {
      const float fa = (float)(s + 1);
      float sy = 0.f, sx = 0.f;
      for (int w = lane; w < wc; w += 32) {
        const int is = (int)floorf(clampf(dd[w], 0.f, 1.f) * 63.f + 0.5f);
        sy += a.sin_t[is * 32 + s];
        sx += a.cos_t[is * 32 + s];
      }
      sy = warp_sum(sy);
      sx = warp_sum(sx);
      float ang = atan2f(sy, sx);
      if (isnan(ang) || (sx == 0.f && sy == 0.f)) ang = 0.f;
      const float off = ang * 0.15915494309189535f;   // 1 / (2 pi)
      const float minidx = rintf(mn * fa - off);
      const float maxidx = rintf(mx * fa - off);
      float e = 0.f, cl = 0.f, ch = 0.f;
      for (int w = lane; w < wc; w += 32) {
        const float sv = dd[w] * fa - off;
        const float r = rintf(sv);
        const float df = sv - r;
        e += df * df;
        if (r == minidx) cl += 1.f - 2.f * df;
        if (r == maxidx) ch += 1.f + 2.f * df;
      }
      e = warp_sum(e);
      cl = warp_sum(cl);
      ch = warp_sum(ch);
      int span = (int)(maxidx - minidx + 1.f);
      span = max(min(span, msteps + 3), 2);
      const float ss = 1.f / fa;
      const float esc = ss * ss;
      const float ev = e * esc, clo = cl * esc, chi = ch * esc;
      const float cand[4] = {ev, ev + clo, ev + chi, (ev + clo) + chi};
      const int dsp[4] = {0, 1, 1, 2};
      const float cut[4] = {0.f, 1.f, 0.f, 1.f};
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        if (!((lv >> l) & 1)) continue;
        if (s == 0) {
          glw[l] = minidx;
          goff[l] = off;
        }
        const int q = kSteps[l];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float val = (span == q + dsp[v]) ? cand[v] : kBig;
          if (val < gbest[l]) {
            gbest[l] = val;
            gbsi[l] = s;
            gcut[l] = cut[v];
            glw[l] = minidx;
            goff[l] = off;
          }
        }
      }
    }
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      if (!((lv >> l) & 1)) continue;
      const float lw = glw[l] + gcut[l];
      const float hw = (lw + (float)kSteps[l]) - 1.f;
      const float st = 1.f / (1.f + (float)gbsi[l]);
      if (lane == 0) {
        pl.lo[d * 8 + l] = (goff[l] + lw) * st;
        pl.hi[d * 8 + l] = (goff[l] + hw) * st;
      }
    }
  }
  __syncwarp();
}

// Stage 3 for one plane and mode: quantize the grid into its range
// (pl.uqc, pl.uqf) and return the weight-set error.
__device__ float quantize_plane(const Args& a, int lane, const Plane& pl,
                                const int* r, float mcut) {
  const int T = a.T, W = a.W;
  const int d = r[1], q = r[2], levels = r[3], ang_ok = r[4];
  float low = 0.f, high = 1.f;
  if (ang_ok) {
    low = pl.lo[d * 8 + q];
    high = pl.hi[d * 8 + q];
  }
  if (high > 1.02f * mcut) high = 1.f;
  if (high <= low) {
    low = 0.f;
    high = 1.f;
  }
  const float rscale = high - low;
  const float scale = 1.f / rscale;
  const float sl = low * scale;
  const float rs64 = rscale / 64.f;
  const float qlm1 = (float)(levels - 1);
  const int* utab = a.unq + q * 32;
  const float* dd = pl.di + d * W;
  for (int w = lane; w < W; w += 32) {
    const float ix = clampf(dd[w] * scale - sl, 0.f, 1.f);
    const int wl = (int)(ix * qlm1);
    const int wh = min(wl + 1, levels - 1);
    const int il = utab[wl], ih = utab[wh];
    const int u = ((float)(il + ih) < 128.f * ix) ? ih : il;
    pl.uqc[w] = u;
    pl.uqf[w] = (float)u * rs64 + low;
  }
  __syncwarp();
  const int* tw = a.tap_w + (size_t)d * T * 4;
  const int* ti = a.tap_i + (size_t)d * T * 4;
  float e = 0.f;
  for (int t = lane; t < T; t += 32) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      s += ((float)ti[t * 4 + k] * 0.0625f) * pl.uqf[tw[t * 4 + k]];
    const float df = s - pl.wei[t];
    e += (df * df) * pl.wes[t];
  }
  return warp_sum(e);
}

__global__ void __launch_bounds__(kWarps * 32)
msearch_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= a.N) return;
  const int T = a.T, W = a.W, D = a.D, C = a.C, S = a.S, pc = a.pc;
  const int pf = plane_floats(T, W, D, C);
  float* base = smem + warp * pf * (a.two ? 2 : 1);
  const Plane p1 = plane_at(base, T, W, D);
  const Plane p2 = plane_at(base + pf, T, W, D);

  for (int t = lane; t < T; t += 32) {
    p1.wei[t] = a.wei[(size_t)n * T + t];
    p1.wes[t] = a.wes[(size_t)n * T + t];
    if (a.two) {
      p2.wei[t] = a.wei2[(size_t)n * T + t];
      p2.wes[t] = a.wes2[(size_t)n * T + t];
    }
  }
  __syncwarp();
  const float mcut = a.mcut[n];
  const float mcut2 = a.two ? a.mcut2[n] : 0.f;
  const int maxwq = a.maxwq[n];

  plane_tables(a, lane, p1, maxwq);
  if (a.two) plane_tables(a, lane, p2, maxwq);

  // --- modes, top-C insertion -----------------------------------------------
  float bv[kMaxC];
  int bm[kMaxC], bfmt[kMaxC], bcq[kMaxC], bcqm[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    bv[c] = kBig;
    bm[c] = -1;
    bfmt[c] = 0;
    bcq[c] = 0;
    bcqm[c] = 0;
  }
  for (int i = lane; i < C * W; i += 32) {
    p1.buq[i] = 0;
    if (a.two) p2.buq[i] = 0;
  }
  const float* ce = a.comb_err + (size_t)n * 21 * S;
  const int* cf = a.comb_fmt + (size_t)n * 21 * S * pc;

  for (int m = 0; m < a.M; ++m) {
    const int* r = a.modes + m * kMeta;
    const int q = r[2], nch = r[5], nv = r[6], nvm = r[7];
    float qwt = quantize_plane(a, lane, p1, r, mcut);
    if (a.two) qwt = qwt + quantize_plane(a, lane, p2, r, mcut2);
    if (q > maxwq) qwt = 1e38f;

    // Format chain: first minimum over the valid integer counts.
    float best = kBig;
    int bi = -1;
    for (int j = 0; j < nch; ++j) {
      const float v = ce[r[9 + 4 * j] * S + r[11 + 4 * j]];
      if (j == 0 || v < best) {
        best = v;
        bi = j;
      }
    }
    int ql, qlm, row;
    if (bi < 0 || best >= kBig) {
      ql = nv;
      qlm = nvm;
      row = ql >= 4 ? clampi(ql, 4, 20) * S : -1;
    } else {
      ql = r[8 + 4 * bi];
      qlm = r[10 + 4 * bi];
      row = r[9 + 4 * bi] * S + r[11 + 4 * bi];
    }
    int fmt = 0;   // 4 bits per partition
    if (row >= 0)
      for (int p = 0; p < pc; ++p) fmt |= cf[(size_t)row * pc + p] << (4 * p);
    const float total = (qwt >= 1e37f) ? kBig : best + qwt;

    if (total < bv[C - 1]) {
      int pos = C - 1;
      while (pos > 0 && total < bv[pos - 1]) --pos;
      for (int c = C - 1; c > pos; --c) {
        bv[c] = bv[c - 1];
        bm[c] = bm[c - 1];
        bfmt[c] = bfmt[c - 1];
        bcq[c] = bcq[c - 1];
        bcqm[c] = bcqm[c - 1];
        for (int w = lane; w < W; w += 32) {
          p1.buq[c * W + w] = p1.buq[(c - 1) * W + w];
          if (a.two) p2.buq[c * W + w] = p2.buq[(c - 1) * W + w];
        }
      }
      bv[pos] = total;
      bm[pos] = m;
      bfmt[pos] = fmt;
      bcq[pos] = ql;
      bcqm[pos] = qlm;
      for (int w = lane; w < W; w += 32) {
        p1.buq[pos * W + w] = p1.uqc[w];
        if (a.two) p2.buq[pos * W + w] = p2.uqc[w];
      }
    }
    __syncwarp();
  }

  const int row_len = 16 + W * (a.two ? 2 : 1);
  for (int c = 0; c < C; ++c) {
    int* o = a.out_i + ((size_t)n * C + c) * row_len;
    const int m = bm[c];
    if (lane < 16) {
      int v = 0;
      switch (lane) {
        case 0: v = m >= 0 ? a.modes[m * kMeta] : 0; break;
        case 1: v = m >= 0 ? a.modes[m * kMeta + 1] : 0; break;
        case 2: v = m >= 0 ? a.modes[m * kMeta + 2] : 0; break;
        case 3: v = bv[c] < kBig ? 1 : 0; break;
        case 4: v = m >= 0 ? clampi(bcq[c], 4, 20) : 0; break;
        case 5: v = m >= 0 ? clampi(bcqm[c], 0, 20) : 0; break;
        default:
          if (lane >= 8 && lane < 8 + pc) v = (bfmt[c] >> (4 * (lane - 8))) & 15;
          break;
      }
      o[lane] = v;
    }
    if (lane == 0) a.out_e[(size_t)n * C + c] = bv[c];
    for (int w = lane; w < W; w += 32) {
      o[16 + w] = p1.buq[c * W + w];
      if (a.two) o[16 + W + w] = p2.buq[c * W + w];
    }
  }
}

}  // namespace

extern "C" int astc_msearch(
    const float* wei, const float* wes, const float* mcut, const float* wei2,
    const float* wes2, const float* mcut2, const int* maxwq,
    const float* comb_err, const int* comb_fmt, const int* tap_w,
    const int* tap_i, const int* wt_t, const int* wt_i, const int* wt_n,
    const int* wcount, const int* maxprec, const int* modes, const int* unq,
    const float* sin_t, const float* cos_t, const int* levels_used, int N,
    int T, int W, int D, int K, int M, int C, int S, int pc, int two,
    int* out_i, float* out_e, void* stream) {
  if (C < 1 || C > kMaxC || N < 0 || W > 64 || T > 216 || pc < 1 || pc > 4
      || S < 1 || (two && (pc != 1 || !wei2 || !wes2 || !mcut2)))
    return (int)cudaErrorInvalidValue;
  Args a{wei, wes, mcut, wei2, wes2, mcut2, maxwq, comb_err, comb_fmt, tap_w,
         tap_i, wt_t, wt_i, wt_n, wcount, maxprec, modes, unq, sin_t, cos_t,
         levels_used, N, T, W, D, K, M, C, S, pc, two, out_i, out_e};
  const size_t smem = sizeof(float) * (size_t)plane_floats(T, W, D, C)
                      * (two ? 2 : 1) * kWarps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        msearch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + kWarps - 1) / kWarps;
  if (grid == 0) return 0;
  msearch_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
