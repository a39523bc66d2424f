// Kernel K2: all R refinement rounds of a 1-plane trial, 1-4 partitions.
//
// Replaces astcenc_tpu/ops/refine_pallas.py::_trial1_full_kernel. Each
// round: infill the grid, least-squares endpoint refit per partition
// (ops/recompute.py), LDR colour pack per partition (ops/color_pack.py)
// and, for 2-4 partitions, the matched-format second pack, decode
// (ops/color_unquant.py), trial error before (round 0) and after a
// parity-class realign (refine_common.cuh). See ops/refine.py for the
// design note.
//
// Layout for the H100: one CTA per block, one warp per candidate of it.
// The block's texels, partition ids and RGB-scale projections, and the
// round-independent refit terms of its partitions, are loaded and computed
// once per CTA and shared by its candidates. In each round a warp takes
// every partition's refit sums in one pass over the texels (one set of
// accumulators per partition, reduced together), then four lanes solve
// each partition's channels and one its RGB-scale line; the packs run side
// by side, four lanes per partition (and
// four more per partition for the matched-format pack), each lane one of
// the four trial encodings of an RGB(A) pack; lane p decodes partition p.
// The realign sweep, the trial error and the packs' arithmetic are
// refine_common.cuh's, shared with K3, K5, K6 and the colour pack; the
// parity classes' weight lists are built once per candidate.
//
// Every sum keeps its lane-strided order and warp butterfly, and every
// pack and decode its arithmetic, so the records are bit-identical to the
// one-warp-per-lane kernel this replaced and to the plain version. Trial
// errors are integer-valued float arithmetic; the refit needs IEEE
// divides and square roots, so this file is built without fast math.
//
// Forms: with a non-null cw_scale (USE_ALPHA_WEIGHT; the TPU kernel's
// has_asr) each block's R, G and B weights are the config's times its
// scale (block_cw), its refit weights with them; rgbm > 0 selects the
// RGBM trial metric (trial_error). A null cw_scale and rgbm 0 give the
// static form unchanged, and a scale of 1 the static form's outputs.
//
// phases: setup refit pack decode trial_error realign output

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "refine_common.cuh"

namespace {

using namespace astc;

constexpr int kMaxC = 8;
constexpr int kOut = 40;     // header words per round and lane

struct Args {
  const int* wgrid0;         // (NC, W)
  const int* dm;             // (NC,)
  const int* wq;             // (NC,)
  const bool* alive;         // (NC,)
  const int* cq;             // (NC,)
  const int* cqm;            // (NC,) quant of the matched-format encoding
  const int* fmt_req;        // (NC, pc)
  const float* texels;       // (N, T, 4)
  const int* pot;            // (N, T) partition of each texel
  const float* ep0;          // (N, pc, 4)
  const float* ep1;          // (N, pc, 4)
  const int* tap_w;          // (D, T, 4)
  const int* tap_i;          // (D, T, 4)
  const int* wt_t;           // (D, W, K)
  const int* wt_i;           // (D, W, K)
  const int* wt_n;           // (D, W)
  const int* dm_color;       // (D, W)
  const int* pn;             // (12, 65, 2)
  const int* lohi;           // (2, 17, 256)
  int N, C, T, W, D, K, R, pc, ncolors, u8_mask, profile;
  float cw[4];
  const float* cw_scale;     // (N,) alpha scale of each block, or null
  float rgbm;                // RGBM scale, or 0
  int* out_i;                // (R, NC, 40 + W)
  float* out_e;              // (R + 1, NC)
};

// Round-independent refit terms of the block's partitions (warp 0 writes).
struct Setup {
  float rws[4][4], sd[4][3], sds[4][3], sdiv[4];
};

// Per-candidate state in shared memory.
struct Part {
  float pe0[4][4], pe1[4][4];     // previous endpoints
  float ep0[4][4], ep1[4][4], rgbs[4][4];
  int fmt[2][4];                  // plain and matched-format pack
  int vals[2][4][8];
  float dec0[4][4], dec1[4][4];   // decoded endpoints
  RgbTrial tri[32];               // one per lane
};

// Shared words: per block tex (4T), pid, scale_t (T each) and the setup;
// per warp e0t, e1t (4T each), the realign scratch, the grid (W) and a
// Part.
__host__ __device__ inline int block_words(int T) {
  return 6 * T + (int)(sizeof(Setup) / 4);
}
__host__ __device__ inline int warp_words(int T, int W) {
  return 8 * T + realign_words(T, W) + W + (int)(sizeof(Part) / 4);
}

// Per-partition texel sums of the refit, as a lane accumulates them.
struct Sums {
  float wmin, wmax, ls, ms, rs, cvy[4], cvx[4], sv0, sv1;
};

__device__ __forceinline__ void zero(Sums& s) {
  s.wmin = 1.f;
  s.wmax = 0.f;
  s.ls = s.ms = s.rs = s.sv0 = s.sv1 = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) s.cvy[c] = s.cvx[c] = 0.f;
}

// PC is the partition count, so that only PC partitions' sums take
// registers. At most 64 registers a thread (a few spill): more resident
// warps hide the latency of the per-lane chains, and it measured faster
// than 128.
template <int PC>
__global__ void __launch_bounds__(kMaxC * 32, 4)
refine_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int T = a.T, W = a.W, pc = PC, C = a.C;
  const int NC = a.N * C;
  const int i = b * C + warp;
  PHASE_START(lane == 0);
  float cw[4];
  block_cw(a.cw, a.cw_scale ? a.cw_scale[b] : 1.f, cw);
  const float ls_weight = rgb_weight(cw);

  float* tex = smem;                              // (T, 4)
  int* pid = reinterpret_cast<int*>(tex + 4 * T);
  float* scale_t = reinterpret_cast<float*>(pid + T);
  Setup& S = *reinterpret_cast<Setup*>(scale_t + T);
  float* e0t = smem + block_words(T) + warp * warp_words(T, W);
  float* e1t = e0t + 4 * T;
  const RealignScratch x = realign_scratch(e1t + 4 * T, T, W);
  int* wg = reinterpret_cast<int*>(e1t + 4 * T + realign_words(T, W));
  Part& P = *reinterpret_cast<Part*>(wg + W);

  for (int j = threadIdx.x; j < 4 * T; j += blockDim.x)
    tex[j] = a.texels[(size_t)b * T * 4 + j];
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    pid[t] = a.pot[(size_t)b * T + t];
  for (int w = lane; w < W; w += 32) wg[w] = a.wgrid0[(size_t)i * W + w];
  if (lane < 4 * pc) {
    (&P.pe0[0][0])[lane] = a.ep0[(size_t)b * pc * 4 + lane];
    (&P.pe1[0][0])[lane] = a.ep1[(size_t)b * pc * 4 + lane];
  }
  __syncthreads();

  // Round-independent refit terms per partition (warp 0): texel count,
  // channel means, the RGB scale direction and the scale range.
  if (warp == 0) {
    float cnt[4] = {0.f, 0.f, 0.f, 0.f};
    float rsum[4][4];
#pragma unroll
    for (int p = 0; p < PC; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) rsum[p][c] = 0.f;
    for (int t = lane; t < T; t += 32) {
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        if (pid[t] != p) continue;
        cnt[p] += 1.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) rsum[p][c] += tex[t * 4 + c];
      }
    }
    float sd[4][3];
#pragma unroll
    for (int p = 0; p < PC; ++p) {
      cnt[p] = warp_sum(cnt[p]);
      float rws[4], mean[3];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        rsum[p][c] = warp_sum(rsum[p][c]) * cw[c];
        rws[c] = fmaxf(cw[c] * cnt[p], 1e-17f);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) mean[c] = rsum[p][c] / rws[c];
      const float norm = sqrtf((mean[0] * mean[0] + mean[1] * mean[1])
                               + mean[2] * mean[2]);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        sd[p][c] = mean[c] / (norm > 0.f ? norm : 1.f);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) S.rws[p][c] = rws[c];
      }
    }
    float smin[4] = {1e10f, 1e10f, 1e10f, 1e10f};
    float smax[4] = {-1e10f, -1e10f, -1e10f, -1e10f};
    for (int t = lane; t < T; t += 32) {
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        if (pid[t] != p) continue;
        const float s = (sd[p][0] * tex[t * 4] + sd[p][1] * tex[t * 4 + 1])
                        + sd[p][2] * tex[t * 4 + 2];
        scale_t[t] = s;
        smin[p] = fminf(smin[p], s);
        smax[p] = fmaxf(smax[p], s);
      }
    }
#pragma unroll
    for (int p = 0; p < PC; ++p) {
      smin[p] = warp_min(smin[p]);
      smax[p] = warp_max(smax[p]);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          S.sd[p][c] = sd[p][c];
          S.sds[p][c] = sd[p][c] * smax[p];
        }
        S.sdiv[p] = clampf(smin[p] / fmaxf(smax[p], 1e-10f), 0.f, 1.f);
      }
    }
  }
  __syncthreads();

  const Stencil st = stencil_of(a.tap_w, a.tap_i, a.wt_t, a.wt_i, a.wt_n,
                                a.dm_color, a.dm[i], T, W, a.K);
  const int* pnq = a.pn + a.wq[i] * 65 * 2;
  bool alive = a.alive[i];
  const int cqv = a.cq[i];
  const int cqm = a.cqm[i];
  // The matched-format packs (2-4 partitions) run beside the plain ones.
  const bool want_matched = pc >= 2 && cqv != cqm && cqm >= 4;
  realign_classes(lane, W, a.ncolors, st, x);
  PHASE_MARK(0);

  for (int r = 0; r < a.R; ++r) {
    // --- infill + least-squares refit, all partitions in one pass --------
    Sums s[PC];
#pragma unroll
    for (int p = 0; p < PC; ++p) zero(s[p]);
    for (int t = lane; t < T; t += 32) {
      const int tp = pid[t];
      const float idx = infill_f(st, wg, t) / 64.f;
      const float om = 1.f - idx;
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        if (tp != p) continue;
        s[p].wmin = fminf(s[p].wmin, idx);
        s[p].wmax = fmaxf(s[p].wmax, idx);
        s[p].ls += om * om;
        s[p].ms += om * idx;
        s[p].rs += idx * idx;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[p].cvy[c] += tex[t * 4 + c] * idx;
          s[p].cvx[c] += tex[t * 4 + c] * om;
        }
        s[p].sv0 += om * scale_t[t];
        s[p].sv1 += idx * scale_t[t];
      }
    }
    // Every lane ends with every partition's sums. Lane 4p + c solves
    // channel c of partition p; lane 16 + p its RGB-scale line.
    const int sp = lane < 16 ? lane >> 2 : lane - 16;
    Sums m;
    zero(m);
#pragma unroll
    for (int p = 0; p < PC; ++p) {
      Sums& q = s[p];
      q.wmin = warp_min(q.wmin);
      q.wmax = warp_max(q.wmax);
      q.ls = warp_sum(q.ls);
      q.ms = warp_sum(q.ms);
      q.rs = warp_sum(q.rs);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        q.cvy[c] = warp_sum(q.cvy[c]) * cw[c];
        q.cvx[c] = warp_sum(q.cvx[c]) * cw[c];
      }
      q.sv0 = warp_sum(q.sv0) * ls_weight;
      q.sv1 = warp_sum(q.sv1) * ls_weight;
      if (sp == p) m = q;
    }
    const bool all_same = m.wmin >= m.wmax * 0.999f;
    if (lane < 4 * pc) {
      const int p = sp, c = lane & 3;
      float cvx = m.cvx[0], cvy = m.cvy[0];
#pragma unroll
      for (int k = 1; k < 4; ++k)
        if (c == k) {
          cvx = m.cvx[k];
          cvy = m.cvy[k];
        }
      const float left = m.ls * cw[c], middle = m.ms * cw[c],
                  right = m.rs * cw[c];
      const float det = left * right - middle * middle;
      const float rdet = 1.f / det;
      const float e0f = (right * cvx - middle * cvy) * rdet;
      const float e1f = (left * cvy - middle * cvx) * rdet;
      const float mss = (left * left + (2.f * middle) * middle)
                        + right * right;
      const bool full = fabsf(det) > mss * 1e-4f && !isnan(e0f)
                        && !isnan(e1f);
      const float avg = (cvx + cvy) / S.rws[p][c];
      float ep0, ep1;
      if (all_same) {
        ep0 = isnan(avg) ? P.pe0[p][c] : avg;
        ep1 = isnan(avg) ? P.pe1[p][c] : avg;
      } else {
        ep0 = full ? e0f : P.pe0[p][c];
        ep1 = full ? e1f : P.pe1[p][c];
      }
      P.ep0[p][c] = P.pe0[p][c] = ep0;
      P.ep1[p][c] = P.pe1[p][c] = ep1;
    } else if (lane >= 16 && lane < 16 + pc) {
      const int p = sp;
      const float lm0 = m.ls * ls_weight, lm1 = m.ms * ls_weight,
                  lm2 = m.rs * ls_weight;
      const float ls_det = lm0 * lm2 - lm1 * lm1;
      const float ls_rdet = 1.f / ls_det;
      const float ls_mss = (lm0 * lm0 + (2.f * lm1) * lm1) + lm2 * lm2;
      const float se0 = (lm2 * m.sv0 - lm1 * m.sv1) * ls_rdet;
      const float se1 = (lm0 * m.sv1 - lm1 * m.sv0) * ls_rdet;
      const bool ls_ok = fabsf(ls_det) > ls_mss * 1e-4f && !isnan(se0)
                         && !isnan(se1) && se0 < se1;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        P.rgbs[p][c] = all_same ? S.sds[p][c]
                                : (ls_ok ? S.sd[p][c] * se1 : S.sds[p][c]);
      P.rgbs[p][3] = all_same ? 1.f
                              : (ls_ok ? se0 / (se1 != 0.f ? se1 : 1.f)
                                       : S.sdiv[p]);
    }
    __syncwarp();
    PHASE_MARK(1);

    // --- packs: lanes 4j..4j+3 take job j, partition j % pc, plain (at cq)
    // for j < pc, matched-format (at cqm) for pc <= j < 2pc ----------------
    {
      const int job = lane >> 2, k = lane & 3, p = job % pc, sel = job / pc;
      const bool active = job < pc || (want_matched && job < 2 * pc);
      const int req = active ? a.fmt_req[(size_t)i * pc + p] : 0;
      const bool rgb = req == FMT_RGB || req == FMT_RGBA;
      if (active && (rgb || k == 0)) {
        Quant q;
        q.qidx = clampi((sel ? clampi(cqm, 4, 20) : cqv) - 4, 0, 16);
        q.lo = a.lohi + q.qidx * 256;
        q.hi = a.lohi + 17 * 256 + q.qidx * 256;
        float c0[4], c1[4];
        ldr_colors(P.ep0[p], P.ep1[p], c0, c1);
        if (rgb) {
          rgb_trial(q, c0, c1, req == FMT_RGBA, k, P.tri[lane]);
        } else {
          int v[8];
          P.fmt[sel][p] = pack_ldr_other(q, c0, c1, P.rgbs[p], req, v);
          for (int c = 0; c < 8; ++c) P.vals[sel][p][c] = v[c];
        }
      }
      __syncwarp();
      if (active && rgb && k == 0)
        P.fmt[sel][p] = rgb_choose(P.tri + lane, req == FMT_RGBA,
                                   P.vals[sel][p]);
      __syncwarp();
    }
    bool same = true, matched = want_matched;
    for (int p = 1; p < pc; ++p) {
      same = same && P.fmt[0][p] == P.fmt[0][0];
      matched = matched && P.fmt[1][p] == P.fmt[1][0];
    }
    matched = matched && same;
    const int sel = matched ? 1 : 0;
    PHASE_MARK(2);

    // --- decode: lane p ---------------------------------------------------
    if (lane < pc) {
      int e0i[4], e1i[4];
      unpack_ldr(P.fmt[sel][lane], P.vals[sel][lane], a.profile, e0i, e1i);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        P.dec0[lane][c] = (float)e0i[c];
        P.dec1[lane][c] = (float)e1i[c];
      }
    }
    __syncwarp();
    for (int j = lane; j < 4 * T; j += 32) {
      e0t[j] = P.dec0[pid[j >> 2]][j & 3];
      e1t[j] = P.dec1[pid[j >> 2]][j & 3];
    }
    __syncwarp();
    PHASE_MARK(3);

    if (r == 0) {
      const float ep = trial_error(lane, T, tex, e0t, e1t, st, wg, wg, -1, cw,
                                   a.u8_mask != 0, a.rgbm);
      if (lane == 0) a.out_e[i] = alive ? ep : kBig;
    }
    PHASE_MARK(4);
    bool adjusted = false;
    if (alive)
      adjusted = realign(lane, T, W, a.ncolors, tex, e0t, e1t, 0xFu, cw, st,
                         pnq, wg, x);
    PHASE_MARK(5);
    const float ep = trial_error(lane, T, tex, e0t, e1t, st, wg, wg, -1, cw,
                                 a.u8_mask != 0, a.rgbm);
    PHASE_MARK(4);
    int* o = a.out_i + ((size_t)r * NC + i) * (kOut + W);
    if (lane == 0) a.out_e[(size_t)(r + 1) * NC + i] = alive ? ep : kBig;
    for (int j = lane; j < kOut; j += 32) {
      int v = 0;
      if (j < 4) {
        v = j < pc ? P.fmt[sel][j] : 0;
      } else if (j < 36) {
        const int p = (j - 4) >> 3;
        v = p < pc ? P.vals[sel][p][(j - 4) & 7] : 0;
      } else if (j == 36) {
        v = matched ? cqm : cqv;
      } else if (j == 37) {
        v = matched ? 1 : 0;
      }
      o[j] = v;
    }
    for (int w = lane; w < W; w += 32) o[kOut + w] = wg[w];
    alive = alive && adjusted;
    __syncwarp();
    PHASE_MARK(6);
  }
}

template <class K>
int launch(K kernel, const Args& a, int N, int C, int smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<N, 32 * C, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int astc_refine(
    const int* wgrid0, const int* dm, const int* wq, const bool* alive,
    const int* cq, const int* cqm, const int* fmt_req, const float* texels,
    const int* pot, const float* ep0, const float* ep1, const int* tap_w,
    const int* tap_i, const int* wt_t, const int* wt_i, const int* wt_n,
    const int* dm_color, const int* pn, const int* lohi, int N, int C, int T,
    int W, int D, int K, int R, int pc, int ncolors, int u8_mask, int profile,
    float cw0, float cw1, float cw2, float cw3, const float* cw_scale,
    float rgbm, int* out_i, float* out_e, void* stream) {
  if (N < 0 || C < 1 || C > kMaxC || W > 64 || T > 216 || R < 1 || pc < 1
      || pc > 4 || ncolors < 0 || ncolors > kMaxClasses
      || (profile != 0 && profile != 1))
    return (int)cudaErrorInvalidValue;
  Args a{wgrid0, dm, wq, alive, cq, cqm, fmt_req, texels, pot, ep0, ep1,
         tap_w, tap_i, wt_t, wt_i, wt_n, dm_color, pn, lohi, N, C, T, W, D, K,
         R, pc, ncolors, u8_mask, profile, {cw0, cw1, cw2, cw3}, cw_scale,
         rgbm, out_i, out_e};
  const int smem = 4 * (block_words(T) + C * warp_words(T, W));
  if (N == 0) return 0;
  switch (pc) {
    case 1: return launch(refine_kernel<1>, a, N, C, smem, stream);
    case 2: return launch(refine_kernel<2>, a, N, C, smem, stream);
    case 3: return launch(refine_kernel<3>, a, N, C, smem, stream);
    default: return launch(refine_kernel<4>, a, N, C, smem, stream);
  }
}
