// Kernels K6 and K7: one refinement round of a 2-plane, 1-partition trial
// for the HDR profiles (the LDR profiles run all rounds in K3, refine2.cu),
// and its bootstrap.
//
// K6 replaces astcenc_tpu/ops/refine_pallas.py::_refine2_kernel: K5's round
// (refine_round.cu) for two planes. Per lane (a block's candidate): the
// trial error of both incoming grids, the realign of plane 1 on every
// channel but the plane-2 component and of plane 2 on that component alone,
// both against one stencil (lanes still alive only), the error after it
// and both infills.
//
// Layout for the H100, as K3: the four plane-2 components of a block are
// four blocks of one folded batch that read one texel row (b % N0), so one
// CTA takes a texel row and a warp each (component, candidate) pair that
// reads it (up to 16 warps; with more than 4 candidates a row's components
// take two CTAs). The row's texels are loaded once per CTA. A warp's
// decoded endpoints are the same for every texel, so the trial error and
// the realign read one pair of them; the two planes realign at once, one
// on each half-warp, each with a scratch of its own and the class lists
// built once. Every sum keeps its lane-strided order and warp butterfly
// (the realign takes each texel's and each weight's terms on one lane, so
// its results do not depend on how many lanes run it): the outputs are
// bit-identical to the one-warp-per-lane kernel this replaced and to the
// plain version. Latency bound, as K3.
//
// K7 replaces _refine2_boot_kernel: the infills of both incoming grids and
// nothing else, one thread per (lane, texel). It reads two grid rows and the
// stencil taps and writes two floats per texel: bound by device memory
// bytes, and at the trials' sizes by launch latency.
//
// Forms of K6 (K7 reads no weight): with a non-null cw_scale (USE_ALPHA_WEIGHT; the TPU kernel's
// has_asr) each block's R, G and B weights are the config's times its
// scale (block_cw); rgbm > 0 selects the RGBM trial metric (trial_error).
// A null cw_scale and rgbm 0 give the static form unchanged, and a scale
// of 1 the static form's outputs.
//
// phases: setup trial_error realign output

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "refine_common.cuh"

namespace {

using namespace astc;

constexpr int kMaxWarps = 16;  // K6 warps per CTA
constexpr int kMaxC = 8;       // candidates per block
constexpr int kThreads = 256;  // K7 threads per CTA

struct Args {
  const int* wg1;            // (NC, W) plane-1 grids
  const int* wg2;            // (NC, W) plane-2 grids
  const int* dm;             // (NC,)
  const int* wq;             // (NC,)
  const bool* alive;         // (NC,)
  const int* p2c;            // (N,) plane-2 component per block
  const int* ep0;            // (NC, 4) decoded endpoints
  const int* ep1;            // (NC, 4)
  const float* texels;       // (N0, T, 4); block b reads row b % N0
  const int* tap_w;          // (D, T, 4)
  const int* tap_i;          // (D, T, 4)
  const int* wt_t;           // (D, W, K)
  const int* wt_i;           // (D, W, K)
  const int* wt_n;           // (D, W)
  const int* dm_color;       // (D, W)
  const int* pn;             // (12, 65, 2)
  int N, N0, C, T, W, D, K, ncolors, u8_mask;
  int comps_per_cta;         // plane-2 components of a row per CTA
  float cw[4];
  const float* cw_scale;     // (N,) alpha scale of each block, or null
  float rgbm;                // RGBM scale, or 0
  int* g1;                   // (NC, W)
  int* g2;                   // (NC, W)
  int* adjusted;             // (NC,)
  float* u1;                 // (NC, T)
  float* u2;                 // (NC, T)
  float* err;                // (2, NC): before and after the realign
};

// Shared words: per CTA the row's texels (4T); per warp the decoded
// endpoint pair (8), both grids (2W) and a realign scratch per plane.
__host__ __device__ inline int warp_words(int T, int W) {
  return 8 + 2 * W + 2 * realign_words(T, W);
}

// Two CTAs an SM cap K6 at 64 registers; it takes 55-56 with or without
// the cap, and a cap of 40 (3 CTAs) spills and ran 2.5% longer (PERF.md).
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
refine_round2_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int T = a.T, W = a.W, C = a.C;
  const int NC = a.N * C;
  const int row = blockIdx.x % a.N0;
  const int comp = (blockIdx.x / a.N0) * a.comps_per_cta + warp / C;
  const int b = row + comp * a.N0;
  const bool valid = b < a.N;
  const int i = b * C + warp % C;
  PHASE_START(lane == 0 && valid);
  float cw[4];
  block_cw(a.cw, a.cw_scale && valid ? a.cw_scale[b] : 1.f, cw);

  float* tex = smem;                               // (T, 4)
  float* dec0 = smem + 4 * T + warp * warp_words(T, W);
  float* dec1 = dec0 + 4;
  int* w1 = reinterpret_cast<int*>(dec1 + 4);
  int* w2 = w1 + W;
  const RealignScratch x1 = realign_scratch(
      reinterpret_cast<float*>(w2 + W), T, W);

  // The warp's own loads are issued before the CTA's: its decimation and
  // plane-2 component, both grids (W <= 63, two words a lane each) and its
  // endpoints (lane l < 4: ep0[l], 4 <= l < 8: ep1[l - 4]).
  int dmi = 0, p2c = 0, epv = 0, g[4] = {0, 0, 0, 0};
  if (valid) {
    dmi = a.dm[i];
    p2c = a.p2c[b];
    if (lane < 8)
      epv = lane < 4 ? a.ep0[(size_t)i * 4 + lane]
                     : a.ep1[(size_t)i * 4 + lane - 4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int w = lane + (k & 1) * 32;
      if (w < W) g[k] = (k < 2 ? a.wg1 : a.wg2)[(size_t)i * W + w];
    }
  }
  for (int j = threadIdx.x; j < 4 * T; j += blockDim.x)
    tex[j] = a.texels[(size_t)row * T * 4 + j];
  __syncthreads();
  if (!valid) return;

  if (lane < 8) dec0[lane] = (float)epv;       // dec1 follows dec0
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int w = lane + (k & 1) * 32;
    if (w < W) (k < 2 ? w1 : w2)[w] = g[k];
  }
  __syncwarp();
  const Stencil st = stencil_of(a.tap_w, a.tap_i, a.wt_t, a.wt_i, a.wt_n,
                                a.dm_color, dmi, T, W, a.K);
  const bool u8 = a.u8_mask != 0;
  PHASE_MARK(0);

  const float err_pre = trial_error<0>(lane, T, tex, dec0, dec1, st, w1, w2,
                                       p2c, cw, u8, a.rgbm);
  PHASE_MARK(1);
  float err_post = err_pre;
  bool adjusted = false;
  if (a.alive[i]) {
    // Half-warp h realigns plane h + 1: its grid, channels and scratch (the
    // class lists are the stencil's, shared by both).
    realign_classes(lane, W, a.ncolors, st, x1);
    const int half = lane >> 4;
    const unsigned m2c = 1u << p2c;
    RealignScratch xh = realign_scratch(x1.inf + half * realign_words(T, W),
                                        T, W);
    xh.cls = x1.cls;
    xh.cls_off = x1.cls_off;
    const bool moved = realign<16, 0>(
        lane & 15, T, W, a.ncolors, tex, dec0, dec1,
        half ? m2c : 0xFu & ~m2c, cw, st, a.pn + a.wq[i] * 65 * 2,
        half ? w2 : w1, xh, half ? 0xFFFF0000u : 0x0000FFFFu);
    adjusted = __any_sync(kFull, moved);
    __syncwarp();
    PHASE_MARK(2);
    err_post = trial_error<0>(lane, T, tex, dec0, dec1, st, w1, w2, p2c, cw,
                              u8, a.rgbm);
    PHASE_MARK(1);
  }
  for (int w = lane; w < W; w += 32) {
    a.g1[(size_t)i * W + w] = w1[w];
    a.g2[(size_t)i * W + w] = w2[w];
  }
  for (int t = lane; t < T; t += 32) {
    a.u1[(size_t)i * T + t] = infill_f(st, w1, t) / 64.f;
    a.u2[(size_t)i * T + t] = infill_f(st, w2, t) / 64.f;
  }
  if (lane == 0) {
    a.adjusted[i] = adjusted ? 1 : 0;
    a.err[i] = err_pre;
    a.err[(size_t)NC + i] = err_post;
  }
  PHASE_MARK(3);
}

// K7: u = infill / 64 of both grids, one thread per (lane, texel); the sum
// of infill_f's taps in infill_f's order.
__global__ void __launch_bounds__(kThreads)
refine_boot2_kernel(const int* __restrict__ wg1, const int* __restrict__ wg2,
                    const int* __restrict__ dm, const int* __restrict__ tap_w,
                    const int* __restrict__ tap_i, long long NC, int T, int W,
                    float* __restrict__ u1, float* __restrict__ u2) {
  const long long n = NC * T;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / T;
    const int t = (int)(e - i * T);
    const int d = __ldg(dm + i);
    const int* tw = tap_w + ((size_t)d * T + t) * 4;
    const int* ti = tap_i + ((size_t)d * T + t) * 4;
    const int* r1 = wg1 + i * W;
    const int* r2 = wg2 + i * W;
    float v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float f = (float)__ldg(ti + k) * 0.0625f;
      const int w = __ldg(tw + k);
      v1 += f * (float)__ldg(r1 + w);
      v2 += f * (float)__ldg(r2 + w);
    }
    u1[e] = v1 / 64.f;
    u2[e] = v2 / 64.f;
  }
}

}  // namespace

extern "C" int astc_refine_round2(
    const int* wg1, const int* wg2, const int* dm, const int* wq,
    const bool* alive, const int* p2c, const int* ep0, const int* ep1,
    const float* texels, const int* tap_w, const int* tap_i, const int* wt_t,
    const int* wt_i, const int* wt_n, const int* dm_color, const int* pn,
    int N, int N0, int C, int T, int W, int D, int K, int ncolors,
    int u8_mask, float cw0, float cw1, float cw2, float cw3,
    const float* cw_scale, float rgbm, int* g1, int* g2, int* adjusted,
    float* u1, float* u2, float* err, void* stream) {
  if (N < 0 || N0 < 1 || N % N0 || C < 1 || C > kMaxC || W > 63 || T > 216
      || ncolors < 1 || ncolors > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  const int comps = N / N0;
  const int per_cta = min(comps, kMaxWarps / C);
  Args a{wg1, wg2, dm, wq, alive, p2c, ep0, ep1, texels, tap_w, tap_i, wt_t,
         wt_i, wt_n, dm_color, pn, N, N0, C, T, W, D, K, ncolors, u8_mask,
         per_cta, {cw0, cw1, cw2, cw3}, cw_scale, rgbm, g1, g2, adjusted, u1,
         u2, err};
  if (N == 0) return 0;
  const int warps = per_cta * C;
  const size_t smem =
      sizeof(float) * (4 * (size_t)T + (size_t)warps * warp_words(T, W));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine_round2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = N0 * ((comps + per_cta - 1) / per_cta);
  refine_round2_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int astc_refine_boot2(const int* wg1, const int* wg2,
                                 const int* dm, const int* tap_w,
                                 const int* tap_i, int NC, int T, int W,
                                 int D, float* u1, float* u2, void* stream) {
  if (NC < 0 || W > 64 || T > 216 || D < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)NC * T;
  if (n == 0) return 0;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  refine_boot2_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      wg1, wg2, dm, tap_w, tap_i, (long long)NC, T, W, u1, u2);
  return (int)cudaGetLastError();
}
