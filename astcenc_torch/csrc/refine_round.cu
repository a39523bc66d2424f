// Kernel K5: one refinement round of a 1-plane trial, 1-4 partitions, for
// the HDR profiles (the LDR profiles run all rounds in K2, refine.cu).
//
// Replaces astcenc_tpu/ops/refine_pallas.py::_refine_kernel. The refit and
// the HDR colour pack run between rounds in PyTorch (codec/trial.py); each
// round hands this kernel the grid and the decoded endpoints. One warp per
// (block, candidate) lane, as K2: texels, per-texel decoded endpoints and
// the grid in shared memory, texel sums by warp shuffles, the sparse
// stencils (at most 4 taps per texel, per-weight texel lists). Per lane:
// the trial error of the incoming grid, the parity-class realign of lanes
// still alive, the error after it and the infill the next refit needs
// (refine_common.cuh, shared with K2 and K3). With ncolors == 0 (the
// bootstrap round) it skips the realign. Like K2 the work is a chain of
// dependent scalar and warp-reduction steps: latency bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "refine_common.cuh"

namespace {

using namespace astc;

constexpr int kWarps = 4;

struct Args {
  const int* wgrid;          // (NC, W)
  const int* dm;             // (NC,)
  const int* wq;             // (NC,)
  const bool* alive;         // (NC,)
  const int* ep0;            // (NC, 4, 4) decoded, partition x channel
  const int* ep1;            // (NC, 4, 4)
  const float* texels;       // (N, T, 4)
  const int* pot;            // (N, T) partition of each texel
  const int* tap_w;          // (D, T, 4)
  const int* tap_i;          // (D, T, 4)
  const int* wt_t;           // (D, W, K)
  const int* wt_i;           // (D, W, K)
  const int* wt_n;           // (D, W)
  const int* dm_color;       // (D, W)
  const int* pn;             // (12, 65, 2)
  int N, C, T, W, D, K, ncolors, u8_mask;
  float cw[4];
  int* grid;                 // (NC, W)
  int* adjusted;             // (NC,)
  float* undec;              // (NC, T)
  float* err;                // (2, NC): before and after the realign
};

__host__ __device__ inline int warp_words(int T, int W) {
  return 12 * T + realign_words(T, W) + W;
}

__global__ void __launch_bounds__(kWarps * 32)
refine_round_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int NC = a.N * a.C;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= NC) return;
  const int T = a.T, W = a.W;
  const int b = i / a.C;
  const float cw[4] = {a.cw[0], a.cw[1], a.cw[2], a.cw[3]};

  float* tex = smem + warp * warp_words(T, W);   // (T, 4)
  float* e0t = tex + 4 * T;                      // (T, 4) decoded endpoints
  float* e1t = e0t + 4 * T;
  const RealignScratch x = realign_scratch(e1t + 4 * T, T, W);
  int* wg = reinterpret_cast<int*>(e1t + 4 * T + realign_words(T, W));

  for (int j = lane; j < 4 * T; j += 32)
    tex[j] = a.texels[(size_t)b * T * 4 + j];
  for (int t = lane; t < T; t += 32) {
    const int p = a.pot[(size_t)b * T + t];
    for (int c = 0; c < 4; ++c) {
      e0t[t * 4 + c] = (float)a.ep0[(size_t)i * 16 + p * 4 + c];
      e1t[t * 4 + c] = (float)a.ep1[(size_t)i * 16 + p * 4 + c];
    }
  }
  for (int w = lane; w < W; w += 32) wg[w] = a.wgrid[(size_t)i * W + w];
  __syncwarp();

  const Stencil st = stencil_of(a.tap_w, a.tap_i, a.wt_t, a.wt_i, a.wt_n,
                                a.dm_color, a.dm[i], T, W, a.K);
  const bool u8 = a.u8_mask != 0;
  const float err_pre = trial_error(lane, T, tex, e0t, e1t, st, wg, wg, -1,
                                    cw, u8);
  float err_post = err_pre;
  bool adjusted = false;
  if (a.ncolors > 0 && a.alive[i]) {
    realign_classes(lane, W, a.ncolors, st, x);
    adjusted = realign(lane, T, W, a.ncolors, tex, e0t, e1t, 0xFu, cw, st,
                       a.pn + a.wq[i] * 65 * 2, wg, x);
    err_post = trial_error(lane, T, tex, e0t, e1t, st, wg, wg, -1, cw, u8);
  }
  for (int w = lane; w < W; w += 32) a.grid[(size_t)i * W + w] = wg[w];
  for (int t = lane; t < T; t += 32)
    a.undec[(size_t)i * T + t] = infill_f(st, wg, t) / 64.f;
  if (lane == 0) {
    a.adjusted[i] = adjusted ? 1 : 0;
    a.err[i] = err_pre;
    a.err[(size_t)NC + i] = err_post;
  }
}

}  // namespace

extern "C" int astc_refine_round(
    const int* wgrid, const int* dm, const int* wq, const bool* alive,
    const int* ep0, const int* ep1, const float* texels, const int* pot,
    const int* tap_w, const int* tap_i, const int* wt_t, const int* wt_i,
    const int* wt_n, const int* dm_color, const int* pn, int N, int C, int T,
    int W, int D, int K, int ncolors, int u8_mask, float cw0, float cw1,
    float cw2, float cw3, int* grid, int* adjusted, float* undec, float* err,
    void* stream) {
  if (N < 0 || C < 1 || W > 64 || T > 216 || ncolors < 0 || ncolors > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  Args a{wgrid, dm, wq, alive, ep0, ep1, texels, pot, tap_w, tap_i, wt_t,
         wt_i, wt_n, dm_color, pn, N, C, T, W, D, K, ncolors, u8_mask,
         {cw0, cw1, cw2, cw3}, grid, adjusted, undec, err};
  const size_t smem = sizeof(float) * (size_t)warp_words(T, W) * kWarps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid_n = ((long long)N * C + kWarps - 1) / kWarps;
  if (grid_n == 0) return 0;
  refine_round_kernel<<<(unsigned)grid_n, kWarps * 32, smem,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
