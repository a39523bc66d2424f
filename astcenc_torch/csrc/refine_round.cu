// Kernel K5: one refinement round of a 1-plane trial, 1-4 partitions, for
// the HDR profiles (the LDR profiles run all rounds in K2, refine.cu).
//
// Replaces astcenc_tpu/ops/refine_pallas.py::_refine_kernel. The refit and
// the HDR colour pack run between rounds in PyTorch (codec/trial.py); each
// round hands this kernel the grid and the decoded endpoints. Per lane (a
// block's candidate): the trial error of the incoming grid, the
// parity-class realign of lanes still alive, the error after it and the
// infill the next refit needs (refine_common.cuh, shared with K2 and K3).
// With ncolors == 0 (the bootstrap round) it skips the realign.
//
// Layout for the H100: one CTA per two blocks, one half-warp per
// candidate: warp w takes candidates 2w and 2w + 1 of the CTA's. The
// blocks' texels and partition ids are loaded once per CTA.
// Where the blocks of a warp's candidates have all their texels in one
// partition (every block at 1 partition) it reads one decoded endpoint
// pair per candidate; otherwise each half-warp copies its partitions'
// pairs out to the texels once, from the shared partition ids. A candidate
// has its own grid and realign scratch; the bootstrap takes no scratch.
// Half-warps keep more of their lanes busy than a warp would on the realign
// sweep's short loops (a parity class of a 6x6 grid has ~9 weights); a
// half-warp realigns only a live candidate, and syncs and votes on its own
// lanes while it does.
//
// Every sum keeps the lane-strided order and butterfly of a warp
// (trial_error<ES, 16>; the realign takes each texel's and each weight's
// terms on one lane), so the outputs are bit-identical to the
// one-warp-per-lane kernel this replaced and to the plain version. Like K2
// the work is a chain of dependent scalar and warp-reduction steps:
// latency bound.
//
// phases: setup trial_error realign output

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "refine_common.cuh"

namespace {

using namespace astc;

constexpr int kMaxC = 8;       // candidates per block

// Blocks per CTA: at -medium (C = 3) one block a CTA leaves a half-warp
// idle and took 29% longer than two, four no shorter (PERF.md).
constexpr int kBlocksPerCta = 2;
constexpr int kMaxWarps = (kBlocksPerCta * kMaxC + 1) / 2;

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

// Shared words: per block its texels (4T) and partition ids (T); per
// candidate the decoded endpoints (8T: one pair, or a pair per texel), the
// grid (W) and, but for the bootstrap, a realign scratch.
__host__ __device__ inline int cand_words(int T, int W, int ncolors) {
  return 8 * T + W + (ncolors > 0 ? realign_words(T, W) : 0);
}

// Two CTAs an SM: with that bound ptxas takes 64 registers in place of
// 48, and the kernel ran 1.6% faster over its forms (PERF.md).
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
refine_round_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane >> 4, hl = lane & 15;
  const int T = a.T, W = a.W, C = a.C;
  const int NC = a.N * C;
  const int bpc = kBlocksPerCta;
  const int b0 = blockIdx.x * bpc;              // the CTA's first block
  const int nb = min(bpc, a.N - b0);
  const int slot = 2 * warp + half;             // the CTA's candidate
  const int bw = slot / C;
  // A half-warp past the CTA's candidates runs the first one, as a
  // candidate no longer alive, and writes nothing.
  const bool valid = bw < nb;
  const int i = valid ? (b0 + bw) * C + slot % C : b0 * C;
  const int bs = valid ? bw : 0;
  const bool valid0 = __shfl_sync(kFull, (int)valid, 0) != 0;
  PHASE_START(hl == 0 && valid);
  const float cw[4] = {a.cw[0], a.cw[1], a.cw[2], a.cw[3]};

  const float* tex = smem + bs * 4 * T;                    // (T, 4)
  int* pids = reinterpret_cast<int*>(smem + bpc * 4 * T);
  const int* pid = pids + bs * T;
  const int cw_words = cand_words(T, W, a.ncolors);
  float* cbase = smem + bpc * 5 * T;
  float* e0t = cbase + slot * cw_words;
  float* e1t = e0t + 4 * T;
  int* wg = reinterpret_cast<int*>(e1t + 4 * T);

  // The candidate's own loads are issued before the CTA's: its decimation,
  // grid (W <= 64, four words a lane), both endpoint rows and its flags.
  const int dmi = a.dm[i];
  const bool alive = valid && a.alive[i];
  int g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    g[k] = hl + 16 * k < W ? a.wgrid[(size_t)i * W + hl + 16 * k] : 0;
  const int epa = a.ep0[(size_t)i * 16 + hl];
  const int epb = a.ep1[(size_t)i * 16 + hl];
  for (int j = threadIdx.x; j < nb * 4 * T; j += blockDim.x)
    smem[j] = a.texels[(size_t)b0 * T * 4 + j];
  for (int j = threadIdx.x; j < nb * T; j += blockDim.x)
    pids[j] = a.pot[(size_t)b0 * T + j];
  __syncthreads();
  if (!valid0) return;                  // a warp past every candidate

#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (hl + 16 * k < W) wg[hl + 16 * k] = g[k];
  // Both candidates' blocks in one partition each: one endpoint pair
  // (e0t[c], e1t[c]); else a pair per texel (e0t[4t + c], e1t[4t + c]).
  const int p0 = pid[0];
  bool one = true;
  for (int t = hl; t < T; t += 16) one = one && pid[t] == p0;
  one = __all_sync(kFull, one);
  const int n = one ? 4 : 4 * T;
  for (int j0 = 0; j0 < n; j0 += 16) {
    const int j = j0 + hl;
    const int k = (one ? p0 : (j < n ? pid[j >> 2] : 0)) * 4 + (j & 3);
    const float v0 = (float)__shfl_sync(kFull, epa, half * 16 + k);
    const float v1 = (float)__shfl_sync(kFull, epb, half * 16 + k);
    if (j < n) {
      e0t[j] = v0;
      e1t[j] = v1;
    }
  }
  __syncwarp();
  const Stencil st = stencil_of(a.tap_w, a.tap_i, a.wt_t, a.wt_i, a.wt_n,
                                a.dm_color, dmi, T, W, a.K);
  const bool u8 = a.u8_mask != 0;
  PHASE_MARK(0);

  const float err_pre =
      one ? trial_error<0, 16>(hl, T, tex, e0t, e1t, st, wg, wg, -1, cw, u8)
          : trial_error<4, 16>(hl, T, tex, e0t, e1t, st, wg, wg, -1, cw, u8);
  PHASE_MARK(1);
  float err_post = err_pre;
  bool adjusted = false;
  if (a.ncolors > 0 && __any_sync(kFull, alive)) {
    // The class lists of both candidates, each by the whole warp.
    for (int h = 0; h < 2; ++h)
      realign_classes(lane, W, a.ncolors,
                      stencil_of(a.tap_w, a.tap_i, a.wt_t, a.wt_i, a.wt_n,
                                 a.dm_color, __shfl_sync(kFull, dmi, 16 * h),
                                 T, W, a.K),
                      realign_scratch(
                          cbase + (2 * warp + h) * cw_words + 8 * T + W, T,
                          W));
    const RealignScratch x = realign_scratch(
        reinterpret_cast<float*>(wg + W), T, W);
    const int* pnq = a.pn + a.wq[i] * 65 * 2;
    const unsigned hmask = half ? 0xFFFF0000u : 0x0000FFFFu;
    if (alive)
      adjusted =
          one ? realign<16, 0>(hl, T, W, a.ncolors, tex, e0t, e1t, 0xFu, cw,
                               st, pnq, wg, x, hmask)
              : realign<16, 4>(hl, T, W, a.ncolors, tex, e0t, e1t, 0xFu, cw,
                               st, pnq, wg, x, hmask);
    PHASE_MARK(2);
    err_post =
        one ? trial_error<0, 16>(hl, T, tex, e0t, e1t, st, wg, wg, -1, cw, u8)
            : trial_error<4, 16>(hl, T, tex, e0t, e1t, st, wg, wg, -1, cw,
                                 u8);
    PHASE_MARK(1);
  }
  if (valid) {
    for (int w = hl; w < W; w += 16) a.grid[(size_t)i * W + w] = wg[w];
    for (int t = hl; t < T; t += 16)
      a.undec[(size_t)i * T + t] = infill_f(st, wg, t) / 64.f;
    if (hl == 0) {
      a.adjusted[i] = adjusted ? 1 : 0;
      a.err[i] = err_pre;
      a.err[(size_t)NC + i] = err_post;
    }
  }
  PHASE_MARK(3);
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
  if (N < 0 || C < 1 || C > kMaxC || W > 64 || T > 216 || ncolors < 0
      || ncolors > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  Args a{wgrid, dm, wq, alive, ep0, ep1, texels, pot, tap_w, tap_i, wt_t,
         wt_i, wt_n, dm_color, pn, N, C, T, W, D, K, ncolors, u8_mask,
         {cw0, cw1, cw2, cw3}, grid, adjusted, undec, err};
  if (N == 0) return 0;
  const int bpc = kBlocksPerCta;
  const int warps = (bpc * C + 1) / 2;
  const size_t smem = sizeof(float) * ((size_t)bpc * 5 * T
                                       + (size_t)2 * warps
                                             * cand_words(T, W, ncolors));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  refine_round_kernel<<<(N + bpc - 1) / bpc, warps * 32, smem,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
