// Kernel K1: trial front end (mode search), 1 or 2 planes, 1-4 partitions.
//
// Replaces astcenc_tpu/ops/msearch_pallas.py::_ms_kernel. Per block and
// plane: the ideal decimated weights of every decimation in the pass
// (weighted average + one gradient step) and the angular [low, high]
// weight ranges per (decimation, quant <= 7); per mode: each plane's grid
// quantized into its range, its weight-set error, the endpoint formats and
// colour quant from the combined colour-error table (for 2-4 partitions the
// best format combination per total integer count, and the quant of the
// matched-format encoding); then the top-C modes (strict <, the earlier
// mode wins a tie). See ops/msearch.py for the design note.
//
// Layout for the H100: a CTA of 256 threads takes G blocks at a time
// (persistent over groups of blocks) and runs the work as independent
// items, one thread each, between __syncthreads:
//   P0 the blocks' texel weights into shared memory;
//   P1 (block, plane, decimation, weight): the weighted average;
//   P2 (block, plane, decimation, texel / weight): the texel residuals,
//      the gradient step, each decimation's weight extents;
//   P3 (block, plane, decimation, step): the angular sums of one step;
//   P4 (block, plane, decimation, level): the first minimum over steps;
//   P5 (block, plane, mode): quantized grid and weight-set error;
//   P6 (block, mode): total with the format chain;
//   P7 (block): top-C by C rounds of argmin over the modes (one warp);
//   P8 (block, candidate, weight): the winners' grids recomputed, headers.
// The pass's stencil taps (where they fit) and the weight unquantization
// table sit in shared memory for the CTA's life; the sin/cos tables and
// the texel lists are read through the read-only cache (staged in shared
// memory they left room for fewer blocks and measured slower). The
// blocks' ideal weights, angular records and ranges and the mode totals
// stay on chip. No tensor cores: the stencils have 4 taps out of W and
// the error sums are exact float32 chains, so there is no dense product to
// hand them.
//
// Every texel or weight sum runs in the order of the warp-per-block kernel
// this replaced (lane-strided partial sums combined by an xor butterfly,
// lane_order_sum), and every other expression as it did, so the outputs
// are bit-identical to it.
//
// phases: load ideal_weights gradient_step angular_steps angular_levels
//         mode_errors mode_totals top_c output

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace astc;

constexpr int kThreads = 256;
constexpr int kMaxC = 8;
constexpr int kMaxG = 8;         // blocks per group: one warp each in P7
constexpr int kMeta = 40;
constexpr int kMaxSteps = 12;    // kSteps[7]: angular levels stop at quant 7
constexpr int kRec = 6;          // words per (decimation, step) record
// G gives P5 about one (block, plane, mode) item per thread, within this
// much shared memory per CTA.
constexpr int kBudget = 112 * 1024;
constexpr int kTapBudget = 24 * 1024;

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
  const int* taps;         // (D, T, 2) packed: 4 weight indices, 4 factors
  const uint16_t* wlist;   // (D, W, K) texel list per weight: t | f << 8
  const int* wt_n;         // (D, W)   list length
  const int* wcount;       // (D,)
  const int* maxprec;      // (D,)
  const int* modes;        // (M, 40) mode_meta_array rows
  const int* unq;          // (12, 32) weight value-rank -> unquant
  const float* sin_t;      // (64, 32)
  const float* cos_t;      // (64, 32)
  const int* levels_used;  // (D,) bitmask of angular levels needed
  int N, T, W, D, K, M, C, S, pc, planes, G, taps_shared;
  int* out_i;              // (N, C, 16 + W * planes)
  float* out_e;            // (N, C)
};

// Words of one plane of one block: wei, wes (T each), the ideal weights
// (D, W), a scratch holding first the weights before the gradient step
// (D, W) and the texel residuals (D, T), then the angular records (D, 12,
// 6), the ranges lo, hi (D, 8 each), each decimation's weight extents
// (D, 2) and the sin/cos row of each ideal weight (D, W bytes).
__host__ __device__ inline int scratch_words(int T, int W, int D) {
  return D * (W + T) > D * kMaxSteps * kRec ? D * (W + T)
                                             : D * kMaxSteps * kRec;
}
__host__ __device__ inline int plane_words(int T, int W, int D) {
  return 2 * T + D * W + scratch_words(T, W, D) + 18 * D + (D * W + 3) / 4;
}
// One block: its planes, each plane's weight-set error per mode and the
// total error of every mode.
__host__ __device__ inline int block_words(int T, int W, int D, int M,
                                           int planes) {
  return planes * plane_words(T, W, D) + (planes + 1) * M;
}
// The CTA's tables: the weight unquantization table, the taps where they
// fit, one byte per thread and weight for P5's quantized grids, the
// winners of P7.
__host__ __device__ inline int table_bytes(int T, int W, int D, int taps) {
  return 4 * (12 * 32 + (taps ? 2 * D * T : 0)) + ((kThreads * W + 3) & ~3)
         + 4 * 2 * kMaxG * kMaxC;
}

struct Plane {
  float* wei;
  float* wes;
  float* dd;    // (D, W)
  float* scr;   // (D, W) pre-step weights, (D, T) residuals; then records
  float* lo;    // (D, 8)
  float* hi;    // (D, 8)
  float* ext;   // (D, 2) min, max of the ideal weights
  unsigned char* slot;   // (D, W) sin/cos table row of each ideal weight
};

__device__ __forceinline__ Plane plane_at(float* base, int T, int W, int D) {
  Plane p;
  p.wei = base;
  p.wes = p.wei + T;
  p.dd = p.wes + T;
  p.scr = p.dd + D * W;
  p.lo = p.scr + scratch_words(T, W, D);
  p.hi = p.lo + 8 * D;
  p.ext = p.hi + 8 * D;
  p.slot = reinterpret_cast<unsigned char*>(p.ext + 2 * D);
  return p;
}

// Sums of terms i < n in the order of a warp-per-block kernel: lane j adds
// terms j, j + 32, ... in turn, starting from zero (``add(acc, i)`` adds
// term i, or nothing), and the 32 partial sums then combine as warp_sum's
// xor butterfly does: the sum over lanes j = b mod S is the sum over
// b mod 2S plus the sum over b + S mod 2S. The recursion unfolds at
// compile time, so no partial sum leaves the registers. V is float or a
// tuple of floats summed componentwise.
struct F2 {
  float x, y;
};
struct F3 {
  float x, y, z;
};
__device__ __forceinline__ F2 operator+(F2 a, F2 b) {
  return {a.x + b.x, a.y + b.y};
}
__device__ __forceinline__ F3 operator+(F3 a, F3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

template <int S, bool Short, class V, class F>
__device__ __forceinline__ V lane_tree(int b, int n, V zero, F& add) {
  if constexpr (S == 32) {
    V acc = zero;
    if constexpr (Short) {       // n <= 64: at most two terms per lane
      if (b < n) add(acc, b);
      if (b + 32 < n) add(acc, b + 32);
    } else {
      for (int i = b; i < n; i += 32) add(acc, i);
    }
    return acc;
  } else {
    return lane_tree<2 * S, Short>(b, n, zero, add)
           + lane_tree<2 * S, Short>(b + S, n, zero, add);
  }
}

template <bool Short = false, class V, class F>
__device__ __forceinline__ V lane_order_sum(int n, V zero, F add) {
  return lane_tree<1, Short>(0, n, zero, add);
}

// Tap k of texel t: (weight index, integer factor).
__device__ __forceinline__ int tap_w(const int* tp, int t, int k) {
  return (tp[2 * t] >> (8 * k)) & 0xFF;
}
__device__ __forceinline__ int tap_i(const int* tp, int t, int k) {
  return (tp[2 * t + 1] >> (8 * k)) & 0xFF;
}

// The quantization range of one plane for a mode.
struct Range {
  float low, rs64, scale, sl, qlm1;
};

__device__ __forceinline__ Range mode_range(const Plane& pl, const int* r,
                                            float mcut) {
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
  Range g;
  const float rscale = high - low;
  g.scale = 1.f / rscale;
  g.sl = low * g.scale;
  g.rs64 = rscale / 64.f;
  g.low = low;
  g.qlm1 = (float)(levels - 1);
  return g;
}

// The quantized weight (unquantized value 0..64) of ideal weight dv.
__device__ __forceinline__ int quant_weight(const Range& g, const int* utab,
                                            int levels, float dv) {
  const float ix = clampf(dv * g.scale - g.sl, 0.f, 1.f);
  const int wl = (int)(ix * g.qlm1);
  const int wh = min(wl + 1, levels - 1);
  const int il = utab[wl], ih = utab[wh];
  return ((float)(il + ih) < 128.f * ix) ? ih : il;
}

// Weight-set error of one plane's grid for a mode; the grid's values go
// through this thread's byte column ub[w * kThreads].
__device__ float plane_error(const Args& a, const Plane& pl, const int* r,
                             float mcut, const int* taps, const int* unq,
                             unsigned char* ub) {
  const int T = a.T, W = a.W, d = r[1], q = r[2], levels = r[3];
  const Range g = mode_range(pl, r, mcut);
  const int* utab = unq + q * 32;
  const float* dd = pl.dd + d * W;
  for (int w = 0; w < W; ++w)
    ub[w * kThreads] = (unsigned char)quant_weight(g, utab, levels, dd[w]);
  const int* tp = taps + (size_t)d * T * 2;
  return lane_order_sum(T, 0.f, [&](float& acc, int t) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float uqf = (float)ub[tap_w(tp, t, k) * kThreads] * g.rs64 + g.low;
      s += ((float)tap_i(tp, t, k) * 0.0625f) * uqf;
    }
    const float df = s - pl.wei[t];
    acc += (df * df) * pl.wes[t];
  });
}

// The format chain of a mode: the first minimum of the colour error over
// the valid integer counts, its quant levels and formats (4 bits each).
struct Chain {
  float best;
  int ql, qlm, fmt;
};

__device__ Chain format_chain(const Args& a, int n, const int* r) {
  const int S = a.S, pc = a.pc, nch = r[5];
  const float* ce = a.comb_err + (size_t)n * 21 * S;
  const int* cf = a.comb_fmt + (size_t)n * 21 * S * pc;
  Chain c;
  c.best = kBig;
  int bi = -1;
  for (int j = 0; j < nch; ++j) {
    const float v = __ldg(ce + r[9 + 4 * j] * S + r[11 + 4 * j]);
    if (j == 0 || v < c.best) {
      c.best = v;
      bi = j;
    }
  }
  int row;
  if (bi < 0 || c.best >= kBig) {
    c.ql = r[6];
    c.qlm = r[7];
    row = c.ql >= 4 ? clampi(c.ql, 4, 20) * S : -1;
  } else {
    c.ql = r[8 + 4 * bi];
    c.qlm = r[10 + 4 * bi];
    row = r[9 + 4 * bi] * S + r[11 + 4 * bi];
  }
  c.fmt = 0;
  if (row >= 0)
    for (int p = 0; p < pc; ++p)
      c.fmt |= __ldg(cf + (size_t)row * pc + p) << (4 * p);
  return c;
}

__device__ __forceinline__ int msteps_of(const Args& a, int d, int maxwq) {
  return kSteps[clampi(min(min(__ldg(a.maxprec + d), 7), maxwq), 0, 11)];
}

__global__ void __launch_bounds__(kThreads)
msearch_kernel(Args a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int T = a.T, W = a.W, D = a.D, K = a.K, M = a.M, C = a.C;
  const int G = a.G, P = a.planes;
  int* unq_s = reinterpret_cast<int*>(smem);
  int* tap_s = unq_s + 12 * 32;
  const int* taps = a.taps_shared ? tap_s : a.taps;
  unsigned char* ubytes = reinterpret_cast<unsigned char*>(
      tap_s + (a.taps_shared ? 2 * D * T : 0));
  int* win = reinterpret_cast<int*>(ubytes + ((kThreads * W + 3) & ~3));
  float* winv = reinterpret_cast<float*>(win + kMaxG * kMaxC);
  float* blocks = winv + kMaxG * kMaxC;
  const int bw = block_words(T, W, D, M, P);
  const int pw = plane_words(T, W, D);

  for (int i = tid; i < 12 * 32; i += kThreads) unq_s[i] = __ldg(a.unq + i);
  if (a.taps_shared)
    for (int i = tid; i < 2 * D * T; i += kThreads) tap_s[i] = __ldg(a.taps + i);
  __syncthreads();

  const int groups = (a.N + G - 1) / G;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    PHASE_START(threadIdx.x == 0);
    const int n0 = grp * G;
    const int ng = min(G, a.N - n0);
    auto plane = [&](int g, int p) {
      return plane_at(blocks + g * bw + p * pw, T, W, D);
    };

    // --- P0: texel weights ---------------------------------------------
    for (int i = tid; i < ng * P * T; i += kThreads) {
      const int t = i % T, gp = i / T, p = gp % P, g = gp / P;
      const size_t src = (size_t)(n0 + g) * T + t;
      const Plane pl = plane(g, p);
      pl.wei[t] = __ldg((p ? a.wei2 : a.wei) + src);
      pl.wes[t] = __ldg((p ? a.wes2 : a.wes) + src);
    }
    __syncthreads();
    PHASE_MARK(0);

    // --- P1: weighted average per decimated weight -------------------------
    for (int i = tid; i < ng * P * D * W; i += kThreads) {
      const int w = i % W, r1 = i / W, d = r1 % D, gp = r1 / D;
      const Plane pl = plane(gp / P, gp % P);
      const uint16_t* wl = a.wlist + ((size_t)d * W + w) * K;
      const int nk = __ldg(a.wt_n + d * W + w);
      float num = 0.f, den = 0.f;
      for (int k = 0; k < nk; ++k) {
        const int e = __ldg(wl + k);
        const int t = e & 0xFF;
        const float f = (float)(e >> 8);
        num += f * (pl.wes[t] * pl.wei[t]);
        den += f * pl.wes[t];
      }
      pl.scr[d * W + w] = num / (den + 1e-10f);
    }
    __syncthreads();
    PHASE_MARK(1);

    // --- P2: one gradient step: the texel residuals of each decimation,
    // then each weight's step from those of its texels --------------------
    for (int i = tid; i < ng * P * D * T; i += kThreads) {
      const int t = i % T, r1 = i / T, d = r1 % D, gp = r1 / D;
      const Plane pl = plane(gp / P, gp % P);
      const int* tp = taps + (size_t)d * T * 2;
      const float* pre = pl.scr + d * W;
      float s = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        s += ((float)tap_i(tp, t, kk) * 0.0625f) * pre[tap_w(tp, t, kk)];
      pl.scr[D * W + d * T + t] = (s - pl.wei[t]) * pl.wes[t];
    }
    __syncthreads();
    for (int i = tid; i < ng * P * D * W; i += kThreads) {
      const int w = i % W, r1 = i / W, d = r1 % D, gp = r1 / D;
      const Plane pl = plane(gp / P, gp % P);
      const uint16_t* wl = a.wlist + ((size_t)d * W + w) * K;
      const float* res = pl.scr + D * W + d * T;
      const int nk = __ldg(a.wt_n + d * W + w);
      float ec0 = 0.f, ec1 = 0.f;
      for (int k = 0; k < nk; ++k) {
        const int e = __ldg(wl + k);
        const int t = e & 0xFF;
        const float f = (float)(e >> 8);
        ec0 += (f * f) * pl.wes[t];
        ec1 += f * res[t];
      }
      ec0 += 1e-10f;
      const float v = pl.scr[d * W + w]
                      + clampf((ec1 * -16.f) / ec0, -0.25f, 0.25f);
      pl.dd[d * W + w] = v;
      pl.slot[d * W + w] =
          (unsigned char)(int)floorf(clampf(v, 0.f, 1.f) * 63.f + 0.5f);
    }
    __syncthreads();
    for (int i = tid; i < ng * P * D; i += kThreads) {
      const int d = i % D, gp = i / D;
      const Plane pl = plane(gp / P, gp % P);
      const float* dd = pl.dd + d * W;
      const int wc = __ldg(a.wcount + d);
      float mn = 3.4e38f, mx = -3.4e38f;
      for (int w = 0; w < wc; ++w) {
        mn = fminf(mn, dd[w]);
        mx = fmaxf(mx, dd[w]);
      }
      pl.ext[2 * d] = mn;
      pl.ext[2 * d + 1] = mx;
    }
    __syncthreads();
    PHASE_MARK(2);

    // --- P3: angular sums, one (decimation, step) each ----------------------
    for (int i = tid; i < ng * P * D * kMaxSteps; i += kThreads) {
      const int s = i % kMaxSteps, r1 = i / kMaxSteps, d = r1 % D,
                gp = r1 / D, g = gp / P;
      if (!__ldg(a.levels_used + d)) continue;
      const int msteps = msteps_of(a, d, __ldg(a.maxwq + n0 + g));
      if (s >= msteps) continue;
      const Plane pl = plane(g, gp % P);
      const float* dd = pl.dd + d * W;
      const unsigned char* slot = pl.slot + d * W;
      const int wc = __ldg(a.wcount + d);
      const float mn = pl.ext[2 * d], mx = pl.ext[2 * d + 1];
      const float fa = (float)(s + 1);
      const F2 sc = lane_order_sum<true>(wc, F2{0.f, 0.f},
                                         [&](F2& acc, int w) {
        const int k = slot[w] * 32 + s;
        acc.x += __ldg(a.sin_t + k);
        acc.y += __ldg(a.cos_t + k);
      });
      const float sy = sc.x, sx = sc.y;
      float ang = atan2f(sy, sx);
      if (isnan(ang) || (sx == 0.f && sy == 0.f)) ang = 0.f;
      const float off = ang * 0.15915494309189535f;   // 1 / (2 pi)
      const float minidx = rintf(mn * fa - off);
      const float maxidx = rintf(mx * fa - off);
      // e: squared distances to the nearest index; cl, ch: the pulls of
      // the weights at the lowest and highest index.
      const F3 ec = lane_order_sum<true>(wc, F3{0.f, 0.f, 0.f},
                                   [&](F3& acc, int w) {
        const float sv = dd[w] * fa - off;
        const float r = rintf(sv);
        const float df = sv - r;
        acc.x += df * df;
        if (r == minidx) acc.y += 1.f - 2.f * df;
        if (r == maxidx) acc.z += 1.f + 2.f * df;
      });
      const float e = ec.x, cl = ec.y, ch = ec.z;
      int span = (int)(maxidx - minidx + 1.f);
      span = max(min(span, msteps + 3), 2);
      const float ss = 1.f / fa;
      const float esc = ss * ss;
      float* rec = pl.scr + (d * kMaxSteps + s) * kRec;
      rec[0] = e * esc;
      rec[1] = cl * esc;
      rec[2] = ch * esc;
      rec[3] = minidx;
      rec[4] = off;
      rec[5] = __int_as_float(span);
    }
    __syncthreads();
    PHASE_MARK(3);

    // --- P4: per level, the first minimum over the steps --------------------
    for (int i = tid; i < ng * P * D * 8; i += kThreads) {
      const int l = i % 8, r1 = i / 8, d = r1 % D, gp = r1 / D, g = gp / P;
      if (!((__ldg(a.levels_used + d) >> l) & 1)) continue;
      const int msteps = msteps_of(a, d, __ldg(a.maxwq + n0 + g));
      const Plane pl = plane(g, gp % P);
      const int q = kSteps[l];
      const float* rec0 = pl.scr + d * kMaxSteps * kRec;
      float gbest = kBig, gcut = 0.f, glw = rec0[3], goff = rec0[4];
      int gbsi = 0;
      const int dsp[4] = {0, 1, 1, 2};
      const float cut[4] = {0.f, 1.f, 0.f, 1.f};
      for (int s = 0; s < msteps; ++s) {
        const float* rec = rec0 + s * kRec;
        const float ev = rec[0], clo = rec[1], chi = rec[2];
        const int span = __float_as_int(rec[5]);
        const float cand[4] = {ev, ev + clo, ev + chi, (ev + clo) + chi};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float val = (span == q + dsp[v]) ? cand[v] : kBig;
          if (val < gbest) {
            gbest = val;
            gbsi = s;
            gcut = cut[v];
            glw = rec[3];
            goff = rec[4];
          }
        }
      }
      const float lw = glw + gcut;
      const float hw = (lw + (float)q) - 1.f;
      const float st = 1.f / (1.f + (float)gbsi);
      pl.lo[d * 8 + l] = (goff + lw) * st;
      pl.hi[d * 8 + l] = (goff + hw) * st;
    }
    __syncthreads();
    PHASE_MARK(4);

    // --- P5: every plane of every mode of every block --------------------
    for (int i = tid; i < ng * P * M; i += kThreads) {
      const int m = i % M, gp = i / M, g = gp / P, p = gp % P;
      const int* r = a.modes + m * kMeta;
      blocks[g * bw + P * pw + p * M + m] = plane_error(
          a, plane(g, p), r, __ldg((p ? a.mcut2 : a.mcut) + n0 + g), taps,
          unq_s, ubytes + tid);
    }
    __syncthreads();
    PHASE_MARK(5);

    // --- P6: each mode's total with its format chain ------------------------
    for (int i = tid; i < ng * M; i += kThreads) {
      const int m = i % M, g = i / M, n = n0 + g;
      const int* r = a.modes + m * kMeta;
      const float* pe = blocks + g * bw + P * pw;
      float qwt = pe[m];
      if (P == 2) qwt = qwt + pe[M + m];
      if (r[2] > __ldg(a.maxwq + n)) qwt = 1e38f;
      const Chain ch = format_chain(a, n, r);
      blocks[g * bw + P * pw + P * M + m] = (qwt >= 1e37f) ? kBig
                                                            : ch.best + qwt;
    }
    __syncthreads();
    PHASE_MARK(6);

    // --- P7: top-C, C rounds of argmin with ties to the earlier mode -------
    {
      const int g = tid >> 5, lane = tid & 31;
      if (g < ng) {
        float* tot = blocks + g * bw + P * pw + P * M;
        for (int c = 0; c < C; ++c) {
          float bv = kBig;
          int bm = -1;
          for (int m = lane; m < M; m += 32)
            if (tot[m] < bv) {
              bv = tot[m];
              bm = m;
            }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(kFull, bv, o);
            const int om = __shfl_xor_sync(kFull, bm, o);
            if (ov < bv || (ov == bv && om < bm)) {
              bv = ov;
              bm = om;
            }
          }
          if (lane == 0) {
            win[g * kMaxC + c] = bm;
            winv[g * kMaxC + c] = bv;
            if (bm >= 0) tot[bm] = kBig;
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    PHASE_MARK(7);

    // --- P8: the winners' grids and headers ----------------------------------
    const int row_len = 16 + W * P;
    for (int i = tid; i < ng * C * row_len; i += kThreads) {
      const int j = i % row_len, gc = i / row_len, c = gc % C, g = gc / C;
      const int n = n0 + g;
      const int m = win[g * kMaxC + c];
      int v = 0;
      if (m >= 0) {
        const int* r = a.modes + m * kMeta;
        if (j >= 16) {
          const int p = (j - 16) / W, w = (j - 16) % W;
          const Plane pl = plane(g, p);
          const Range rg = mode_range(pl, r, __ldg((p ? a.mcut2 : a.mcut) + n));
          v = quant_weight(rg, unq_s + r[2] * 32, r[3], pl.dd[r[1] * W + w]);
        } else if (j < 3) {
          v = r[j];
        } else if (j == 3) {
          v = 1;
        } else if (j == 4 || j == 5 || (j >= 8 && j < 8 + a.pc)) {
          const Chain ch = format_chain(a, n, r);
          v = j == 4 ? clampi(ch.ql, 4, 20)
              : j == 5 ? clampi(ch.qlm, 0, 20) : (ch.fmt >> (4 * (j - 8))) & 15;
        }
      }
      a.out_i[((size_t)n * C + c) * row_len + j] = v;
      if (j == 0) a.out_e[(size_t)n * C + c] = winv[g * kMaxC + c];
    }
    __syncthreads();
    PHASE_MARK(8);
  }
}

}  // namespace

extern "C" int astc_msearch(
    const float* wei, const float* wes, const float* mcut, const float* wei2,
    const float* wes2, const float* mcut2, const int* maxwq,
    const float* comb_err, const int* comb_fmt, const int* taps,
    const uint16_t* wlist, const int* wt_n, const int* wcount,
    const int* maxprec, const int* modes, const int* unq, const float* sin_t,
    const float* cos_t, const int* levels_used, int N, int T, int W, int D,
    int K, int M, int C, int S, int pc, int two, int* out_i, float* out_e,
    void* stream) {
  if (C < 1 || C > kMaxC || N < 0 || W > 64 || T > 216 || pc < 1 || pc > 4
      || S < 1 || M < 0 || (two && (pc != 1 || !wei2 || !wes2 || !mcut2)))
    return (int)cudaErrorInvalidValue;
  const int planes = two ? 2 : 1;
  const int staged = 4 * 2 * D * T <= kTapBudget ? 1 : 0;
  const int fixed = table_bytes(T, W, D, staged);
  const int per = 4 * block_words(T, W, D, M, planes);
  int G = (kThreads + planes * M - 1) / (planes * (M > 0 ? M : 1));
  if (G > (kBudget - fixed) / per) G = (kBudget - fixed) / per;
  G = G < 1 ? 1 : (G > kMaxG ? kMaxG : G);
  const int smem = fixed + per * G;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        msearch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (N + G - 1) / G;
  if (groups == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, msearch_kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  Args a{wei, wes, mcut, wei2, wes2, mcut2, maxwq, comb_err, comb_fmt, taps,
         wlist, wt_n, wcount, maxprec, modes, unq, sin_t, cos_t, levels_used,
         N, T, W, D, K, M, C, S, pc, planes, G, staged, out_i, out_e};
  const int grid = groups < sms * per_sm ? groups : sms * per_sm;
  msearch_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
