// Kernels K6 and K7: one refinement round of a 2-plane, 1-partition trial
// for the HDR profiles (the LDR profiles run all rounds in K3, refine2.cu),
// and its bootstrap.
//
// K6 replaces astcenc_tpu/ops/refine_pallas.py::_refine2_kernel: K5's round
// (refine_round.cu) for two planes. One warp per (block, candidate) lane;
// the trial error of both incoming grids, the realign of plane 1 on every
// channel but the plane-2 component and of plane 2 on that component alone,
// both against one stencil (lanes still alive only), the error after it
// and both infills. The four plane-2 components of a block are four blocks
// of one folded batch that read the same texel row (b % N0), as in K3.
// Latency bound, as K3.
//
// K7 replaces _refine2_boot_kernel: the infills of both incoming grids and
// nothing else, one thread per (lane, texel). It reads two grid rows and the
// stencil taps and writes two floats per texel: bound by device memory
// bytes, and at the trials' sizes by launch latency.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "refine_common.cuh"

namespace {

using namespace astc;

constexpr int kWarps = 4;
constexpr int kThreads = 256;

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
  float cw[4];
  int* g1;                   // (NC, W)
  int* g2;                   // (NC, W)
  int* adjusted;             // (NC,)
  float* u1;                 // (NC, T)
  float* u2;                 // (NC, T)
  float* err;                // (2, NC): before and after the realign
};

__host__ __device__ inline int warp_words(int T, int W) {
  return 12 * T + realign_words(T, W) + 2 * W;
}

__global__ void __launch_bounds__(kWarps * 32)
refine_round2_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int NC = a.N * a.C;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= NC) return;
  const int T = a.T, W = a.W;
  const int b = i / a.C;
  const int row = b % a.N0;
  const int p2c = a.p2c[b];
  const float cw[4] = {a.cw[0], a.cw[1], a.cw[2], a.cw[3]};

  float* tex = smem + warp * warp_words(T, W);   // (T, 4)
  float* e0t = tex + 4 * T;
  float* e1t = e0t + 4 * T;
  const RealignScratch x = realign_scratch(e1t + 4 * T, T, W);
  int* w1 = reinterpret_cast<int*>(e1t + 4 * T + realign_words(T, W));
  int* w2 = w1 + W;

  for (int j = lane; j < 4 * T; j += 32) {
    tex[j] = a.texels[(size_t)row * T * 4 + j];
    e0t[j] = (float)a.ep0[(size_t)i * 4 + (j & 3)];
    e1t[j] = (float)a.ep1[(size_t)i * 4 + (j & 3)];
  }
  for (int w = lane; w < W; w += 32) {
    w1[w] = a.wg1[(size_t)i * W + w];
    w2[w] = a.wg2[(size_t)i * W + w];
  }
  __syncwarp();

  const Stencil st = stencil_of(a.tap_w, a.tap_i, a.wt_t, a.wt_i, a.wt_n,
                                a.dm_color, a.dm[i], T, W, a.K);
  const bool u8 = a.u8_mask != 0;
  const float err_pre = trial_error(lane, T, tex, e0t, e1t, st, w1, w2, p2c,
                                    cw, u8);
  float err_post = err_pre;
  bool adjusted = false;
  if (a.alive[i]) {
    const int* pnq = a.pn + a.wq[i] * 65 * 2;
    const unsigned m2c = 1u << p2c;
    realign_classes(lane, W, a.ncolors, st, x);
    const bool a1 = realign(lane, T, W, a.ncolors, tex, e0t, e1t,
                            0xFu & ~m2c, cw, st, pnq, w1, x);
    const bool a2 = realign(lane, T, W, a.ncolors, tex, e0t, e1t, m2c, cw,
                            st, pnq, w2, x);
    adjusted = a1 || a2;
    err_post = trial_error(lane, T, tex, e0t, e1t, st, w1, w2, p2c, cw, u8);
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
    int u8_mask, float cw0, float cw1, float cw2, float cw3, int* g1,
    int* g2, int* adjusted, float* u1, float* u2, float* err, void* stream) {
  if (N < 0 || N0 < 1 || C < 1 || W > 63 || T > 216 || ncolors < 1
      || ncolors > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  Args a{wg1, wg2, dm, wq, alive, p2c, ep0, ep1, texels, tap_w, tap_i, wt_t,
         wt_i, wt_n, dm_color, pn, N, N0, C, T, W, D, K, ncolors, u8_mask,
         {cw0, cw1, cw2, cw3}, g1, g2, adjusted, u1, u2, err};
  const size_t smem = sizeof(float) * (size_t)warp_words(T, W) * kWarps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine_round2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = ((long long)N * C + kWarps - 1) / kWarps;
  if (grid == 0) return 0;
  refine_round2_kernel<<<(unsigned)grid, kWarps * 32, smem,
                         (cudaStream_t)stream>>>(a);
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
