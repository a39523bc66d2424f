// Kernel K3: all R refinement rounds of a 2-plane, 1-partition trial.
//
// Replaces astcenc_tpu/ops/refine_pallas.py::_trial2_full_kernel. Each
// round: infill both grids, 2-plane least-squares refit (ops/recompute.py::
// recompute_ideal_colors_2planes), LDR colour pack and decode, trial error
// before (round 0) and after realigning both planes against the one
// stencil, plane 1 on every channel but the plane-2 component and plane 2
// on that component alone (refine_common.cuh).
//
// Layout for the H100: the four plane-2 components of a block are four
// blocks that read one texel row, so one CTA takes a texel row and a warp
// each (component, candidate) pair that reads it (up to 16 warps; with
// more than 4 candidates a row's components take two CTAs). The row's
// texels and its RGB-scale projection are loaded and computed once per
// CTA. In each round a warp takes its refit sums in one pass over the
// texels; lane c solves channel c and lane 4 the RGB-scale line; lanes 0-3
// run the four trial encodings of an RGB(A) pack side by side (the pack of
// K2, refine_common.cuh) and lane 0 decodes; the two planes realign at once,
// one on each half-warp. The decoded endpoints are the same for every
// texel, so the trial error and the realign read one copy of them.
//
// Every sum keeps its lane-strided order and warp butterfly, and every
// pack and decode its arithmetic, so the records are bit-identical to the
// one-warp-per-lane kernel this replaced and to the plain version (the
// realign takes each texel's and each weight's terms on one lane, so its
// results do not depend on how many lanes run it). The work is a long
// chain of dependent steps per warp: the kernel is latency bound.
//
// Built without fast math: the refit needs IEEE divides and square roots.
//
// Forms: with a non-null cw_scale (USE_ALPHA_WEIGHT; the TPU kernel's
// has_asr) each block's R, G and B weights are the config's times its
// scale (block_cw), its refit weights with them; rgbm > 0 selects the
// RGBM trial metric (trial_error). A null cw_scale and rgbm 0 give the
// static form unchanged, and a scale of 1 the static form's outputs.
//
// phases: setup refit solve pack decode trial_error realign output

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "refine_common.cuh"

namespace {

using namespace astc;

constexpr int kMaxWarps = 16;  // warps per CTA
constexpr int kMaxC = 8;       // candidates per block
constexpr int kOut = 16;       // header words per round and lane

struct Args {
  const int* wg1;            // (NC, W) plane-1 grids
  const int* wg2;            // (NC, W) plane-2 grids
  const int* dm;             // (NC,)
  const int* wq;             // (NC,)
  const bool* alive;         // (NC,)
  const int* cq;             // (NC,)
  const int* fmt_req;        // (NC,)
  const int* p2c;            // (N,) plane-2 component per block
  const float* texels;       // (N0, T, 4); block b reads row b % N0
  const float* mean;         // (N0, 4) block means
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
  int N, N0, C, T, W, D, K, R, ncolors, u8_mask, profile;
  int comps_per_cta;         // plane-2 components of a row per CTA
  float cw[4];
  const float* cw_scale;     // (N,) alpha scale of each block, or null
  float rgbm;                // RGBM scale, or 0
  int* out_i;                // (R, NC, 16 + 2 W)
  float* out_e;              // (R + 1, NC)
};

// The row's RGB-scale direction and range (warp 0 writes).
struct RowSetup {
  float sd[3], sds[3], sdiv;
};

// A warp's state in shared memory.
struct Lane {
  float ep0[4], ep1[4], rgbs[4];  // refit endpoints and RGB-scale line
  float dec0[4], dec1[4];         // decoded endpoints
  int fmt, vals[8];
  RgbTrial tri[4];                // one per lane 0-3
};

// Shared words: per CTA tex (4T), scale_t (T) and the setup; per warp a
// Lane, both grids (2W) and a realign scratch per plane.
__host__ __device__ inline int cta_words(int T) {
  return 5 * T + (int)(sizeof(RowSetup) / 4);
}
__host__ __device__ inline int warp_words(int T, int W) {
  return (int)(sizeof(Lane) / 4) + 2 * W + 2 * realign_words(T, W);
}

// 2x2 least-squares endpoints of one channel (recompute.py solve()).
__device__ __forceinline__ bool solve(float lsum, float msum, float rsum,
                                      float w, float cvx, float cvy,
                                      float* e0, float* e1) {
  const float left = lsum * w, middle = msum * w, right = rsum * w;
  const float det = left * right - middle * middle;
  const float rdet = 1.f / det;
  const float mss = (left * left + (2.f * middle) * middle) + right * right;
  *e0 = (right * cvx - middle * cvy) * rdet;
  *e1 = (left * cvy - middle * cvx) * rdet;
  return fabsf(det) > mss * 1e-4f && !isnan(*e0) && !isnan(*e1);
}

// v[c] of a 4-vector in registers, for a c known only at run time.
__device__ __forceinline__ float pick(const float* v, int c) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (c == k) r = v[k];
  return r;
}

// At most 64 registers a thread (a few spill), so that two CTAs of 12
// warps fit an SM: at 96 registers (one CTA an SM) the kernel took 36%
// longer (tools/torch_phase_clocks.py).
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
refine2_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int T = a.T, W = a.W, C = a.C;
  const int NC = a.N * C;
  const int row = blockIdx.x % a.N0;
  const int comp = (blockIdx.x / a.N0) * a.comps_per_cta + warp / C;
  const int b = row + comp * a.N0;
  const bool valid = warp < a.comps_per_cta * C && b < a.N;
  const int i = b * C + warp % C;
  PHASE_START(lane == 0 && valid);
  float cw[4];
  block_cw(a.cw, a.cw_scale && valid ? a.cw_scale[b] : 1.f, cw);
  const float ls_weight = rgb_weight(cw);

  float* tex = smem;                               // (T, 4)
  float* scale_t = tex + 4 * T;
  RowSetup& S = *reinterpret_cast<RowSetup*>(scale_t + T);
  float* wbase = smem + cta_words(T) + warp * warp_words(T, W);
  Lane& L = *reinterpret_cast<Lane*>(wbase);
  int* w1 = reinterpret_cast<int*>(wbase + sizeof(Lane) / 4);
  int* w2 = w1 + W;
  const RealignScratch x1 = realign_scratch(
      reinterpret_cast<float*>(w2 + W), T, W);

  for (int j = threadIdx.x; j < 4 * T; j += blockDim.x)
    tex[j] = a.texels[(size_t)row * T * 4 + j];
  __syncthreads();

  // Round-independent: the RGB scale direction from the block mean.
  if (warp == 0) {
    float sd[3];
    const float* m = a.mean + (size_t)row * 4;
    const float norm = sqrtf((m[0] * m[0] + m[1] * m[1]) + m[2] * m[2]);
    for (int c = 0; c < 3; ++c) sd[c] = m[c] / (norm > 0.f ? norm : 1.f);
    float smin = 3.4e38f, smax = -3.4e38f;
    for (int t = lane; t < T; t += 32) {
      const float s = (sd[0] * tex[t * 4] + sd[1] * tex[t * 4 + 1])
                      + sd[2] * tex[t * 4 + 2];
      scale_t[t] = s;
      smin = fminf(smin, s);
      smax = fmaxf(smax, s);
    }
    smin = warp_min(smin);
    smax = warp_max(smax);
    if (lane == 0) {
      for (int c = 0; c < 3; ++c) {
        S.sd[c] = sd[c];
        S.sds[c] = sd[c] * smax;
      }
      S.sdiv = clampf(smin / fmaxf(smax, 1e-10f), 0.f, 1.f);
    }
  }
  __syncthreads();
  if (!valid) return;

  const int p2c = a.p2c[b];
  for (int w = lane; w < W; w += 32) {
    w1[w] = a.wg1[(size_t)i * W + w];
    w2[w] = a.wg2[(size_t)i * W + w];
  }
  const Stencil st = stencil_of(a.tap_w, a.tap_i, a.wt_t, a.wt_i, a.wt_n,
                                a.dm_color, a.dm[i], T, W, a.K);
  const int* pnq = a.pn + a.wq[i] * 65 * 2;
  realign_classes(lane, W, a.ncolors, st, x1);
  bool alive = a.alive[i];
  const int cqv = a.cq[i];
  const int freq = a.fmt_req[i];
  const bool rgb = freq == FMT_RGB || freq == FMT_RGBA;
  // Lane c < 4 keeps channel c's previous endpoints.
  const int lc = lane & 3;
  float pe0 = a.ep0[b * 4 + lc], pe1 = a.ep1[b * 4 + lc];
  const float cwc = pick(cw, lc);
  const float rws = fmaxf(cwc * (float)T, 1e-17f);
  // Half-warp h realigns plane h + 1: its grid, channels and scratch (the
  // class lists are the stencil's, shared by both).
  const int half = lane >> 4;
  const unsigned hmask = half ? 0xFFFF0000u : 0x0000FFFFu;
  const unsigned m2c = 1u << p2c;
  const unsigned hch = half ? m2c : 0xFu & ~m2c;
  int* const wh = half ? w2 : w1;
  RealignScratch xh = realign_scratch(x1.inf + half * realign_words(T, W),
                                      T, W);
  xh.cls = x1.cls;
  xh.cls_off = x1.cls_off;
  PHASE_MARK(0);

  for (int r = 0; r < a.R; ++r) {
    // --- infill both planes + 2-plane least-squares refit sums ---------------
    float l1 = 0.f, m1 = 0.f, r1 = 0.f, l2 = 0.f, m2 = 0.f, r2 = 0.f;
    float wmin1 = 3.4e38f, wmax1 = -3.4e38f, wmin2 = 3.4e38f,
          wmax2 = -3.4e38f;
    float cvy[4] = {0.f, 0.f, 0.f, 0.f}, cvx[4] = {0.f, 0.f, 0.f, 0.f};
    float sv0 = 0.f, sv1 = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float u1 = infill_f(st, w1, t) / 64.f;
      const float u2 = infill_f(st, w2, t) / 64.f;
      const float o1 = 1.f - u1, o2 = 1.f - u2;
      l1 += o1 * o1;
      m1 += o1 * u1;
      r1 += u1 * u1;
      l2 += o2 * o2;
      m2 += o2 * u2;
      r2 += u2 * u2;
      wmin1 = fminf(wmin1, u1);
      wmax1 = fmaxf(wmax1, u1);
      wmin2 = fminf(wmin2, u2);
      wmax2 = fmaxf(wmax2, u2);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float ci = c == p2c ? u2 : u1;
        cvy[c] += tex[t * 4 + c] * ci;
        cvx[c] += tex[t * 4 + c] * (1.f - ci);
      }
      sv0 += o1 * scale_t[t];
      sv1 += u1 * scale_t[t];
    }
    l1 = warp_sum(l1);
    m1 = warp_sum(m1);
    r1 = warp_sum(r1);
    l2 = warp_sum(l2);
    m2 = warp_sum(m2);
    r2 = warp_sum(r2);
    wmin1 = warp_min(wmin1);
    wmax1 = warp_max(wmax1);
    wmin2 = warp_min(wmin2);
    wmax2 = warp_max(wmax2);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cvy[c] = warp_sum(cvy[c]) * cw[c];
      cvx[c] = warp_sum(cvx[c]) * cw[c];
    }
    sv0 = warp_sum(sv0) * ls_weight;
    sv1 = warp_sum(sv1) * ls_weight;
    PHASE_MARK(1);

    // --- solves: lane c channel c, lane 4 the RGB-scale line -----------------
    const bool same1 = wmin1 >= wmax1 * 0.999f;
    const bool same2 = wmin2 >= wmax2 * 0.999f;
    if (lane < 4) {
      const float cx = pick(cvx, lane), cy = pick(cvy, lane);
      const float avg = (cx + cy) / rws;
      const bool two = lane == p2c;
      float e0f, e1f;
      const bool ok = two ? solve(l2, m2, r2, cwc, cx, cy, &e0f, &e1f)
                          : solve(l1, m1, r1, cwc, cx, cy, &e0f, &e1f);
      const bool same = two ? same2 : same1;
      if (same && !isnan(avg)) {
        pe0 = pe1 = avg;
      } else if (!same && ok) {
        pe0 = e0f;
        pe1 = e1f;
      }
      L.ep0[lane] = pe0;
      L.ep1[lane] = pe1;
    } else if (lane == 4) {
      const float lm0 = l1 * ls_weight, lm1 = m1 * ls_weight,
                  lm2 = r1 * ls_weight;
      const float ls_det = lm0 * lm2 - lm1 * lm1;
      const float ls_mss = (lm0 * lm0 + (2.f * lm1) * lm1) + lm2 * lm2;
      const float se0 = (lm2 * sv0 - lm1 * sv1) / ls_det;
      const float se1 = (lm0 * sv1 - lm1 * sv0) / ls_det;
      const bool ls_ok = fabsf(ls_det) > ls_mss * 1e-4f && !isnan(se0)
                         && !isnan(se1) && se0 < se1;
      for (int c = 0; c < 3; ++c)
        L.rgbs[c] = same1 ? S.sds[c] : (ls_ok ? S.sd[c] * se1 : S.sds[c]);
      L.rgbs[3] = same1 ? 1.f
                        : (ls_ok ? se0 / (se1 != 0.f ? se1 : 1.f) : S.sdiv);
    }
    __syncwarp();
    PHASE_MARK(2);

    // --- pack: lanes 0-3 the four trials of an RGB(A) pack, else lane 0 ----
    if (lane < 4 && (rgb || lane == 0)) {
      Quant q;
      q.qidx = clampi(cqv - 4, 0, 16);
      q.lo = a.lohi + q.qidx * 256;
      q.hi = a.lohi + 17 * 256 + q.qidx * 256;
      float c0[4], c1[4];
      ldr_colors(L.ep0, L.ep1, c0, c1);
      if (rgb)
        rgb_trial(q, c0, c1, freq == FMT_RGBA, lane, L.tri[lane]);
      else
        L.fmt = pack_ldr_other(q, c0, c1, L.rgbs, freq, L.vals);
    }
    __syncwarp();
    PHASE_MARK(3);

    // --- decode: lane 0 ------------------------------------------------------
    if (lane == 0) {
      if (rgb) L.fmt = rgb_choose(L.tri, freq == FMT_RGBA, L.vals);
      int e0i[4], e1i[4];
      unpack_ldr(L.fmt, L.vals, a.profile, e0i, e1i);
      for (int c = 0; c < 4; ++c) {
        L.dec0[c] = (float)e0i[c];
        L.dec1[c] = (float)e1i[c];
      }
    }
    __syncwarp();
    PHASE_MARK(4);

    if (r == 0) {
      const float ep = trial_error<0>(lane, T, tex, L.dec0, L.dec1, st, w1,
                                      w2, p2c, cw, a.u8_mask != 0, a.rgbm);
      if (lane == 0) a.out_e[i] = alive ? ep : kBig;
    }
    PHASE_MARK(5);
    bool adjusted = false;
    if (alive) {
      const bool moved = realign<16, 0>(lane & 15, T, W, a.ncolors, tex,
                                        L.dec0, L.dec1, hch, cw, st, pnq, wh,
                                        xh, hmask);
      adjusted = __any_sync(kFull, moved);
    }
    PHASE_MARK(6);
    const float ep = trial_error<0>(lane, T, tex, L.dec0, L.dec1, st, w1, w2,
                                    p2c, cw, a.u8_mask != 0, a.rgbm);
    PHASE_MARK(5);
    int* o = a.out_i + ((size_t)r * NC + i) * (kOut + 2 * W);
    if (lane == 0) {
      a.out_e[(size_t)(r + 1) * NC + i] = alive ? ep : kBig;
      o[0] = L.fmt;
      for (int k = 0; k < 8; ++k) o[1 + k] = L.vals[k];
      for (int k = 9; k < kOut; ++k) o[k] = 0;
    }
    for (int w = lane; w < W; w += 32) {
      o[kOut + w] = w1[w];
      o[kOut + W + w] = w2[w];
    }
    alive = alive && adjusted;
    __syncwarp();
    PHASE_MARK(7);
  }
}

}  // namespace

extern "C" int astc_refine2(
    const int* wg1, const int* wg2, const int* dm, const int* wq,
    const bool* alive, const int* cq, const int* fmt_req, const int* p2c,
    const float* texels, const float* mean, const float* ep0,
    const float* ep1, const int* tap_w, const int* tap_i, const int* wt_t,
    const int* wt_i, const int* wt_n, const int* dm_color, const int* pn,
    const int* lohi, int N, int N0, int C, int T, int W, int D, int K, int R,
    int ncolors, int u8_mask, int profile, float cw0, float cw1, float cw2,
    float cw3, const float* cw_scale, float rgbm, int* out_i, float* out_e,
    void* stream) {
  if (N < 0 || N0 < 1 || N % N0 || C < 1 || C > kMaxC || W > 63 || T > 216
      || R < 1 || ncolors < 0 || ncolors > kMaxClasses
      || (profile != 0 && profile != 1))
    return (int)cudaErrorInvalidValue;
  const int comps = N / N0;
  const int per_cta = min(comps, kMaxWarps / C);
  Args a{wg1, wg2, dm, wq, alive, cq, fmt_req, p2c, texels, mean, ep0, ep1,
         tap_w, tap_i, wt_t, wt_i, wt_n, dm_color, pn, lohi, N, N0, C, T, W,
         D, K, R, ncolors, u8_mask, profile, per_cta, {cw0, cw1, cw2, cw3},
         cw_scale, rgbm, out_i, out_e};
  if (N == 0) return 0;
  const int warps = per_cta * C;
  const size_t smem =
      sizeof(float) * ((size_t)cta_words(T) + (size_t)warps * warp_words(T, W));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = N0 * ((comps + per_cta - 1) / per_cta);
  refine2_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
