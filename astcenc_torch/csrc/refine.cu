// Kernel K2: all R refinement rounds of a 1-plane trial, 1-4 partitions.
//
// Replaces astcenc_tpu/ops/refine_pallas.py::_trial1_full_kernel. One warp
// per (block, candidate) lane; see ops/refine.py for the design note. Each
// round: infill the grid, least-squares endpoint refit per partition
// (ops/recompute.py), LDR colour pack per partition (ops/color_pack.py)
// and, for 2-4 partitions, the matched-format second pack, decode
// (ops/color_unquant.py), trial error before (round 0) and after a
// parity-class realign (refine_common.cuh). The pack and decode are scalar
// code that every lane of the warp runs on the same values; per-partition
// results go through shared memory.
//
// Trial errors are integer-valued float arithmetic; the refit needs IEEE
// divides and square roots, so this file is built without fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "refine_common.cuh"

namespace {

using namespace astc;

constexpr int kWarps = 4;
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
  int* out_i;                // (R, NC, 40 + W)
  float* out_e;              // (R + 1, NC)
};

// Per-partition state of one lane, in shared memory (lane 0 writes).
struct Part {
  float pe0[4][4], pe1[4][4];     // previous endpoints
  float ep0[4][4], ep1[4][4], rgbs[4][4];
  float sd[4][3], sds[4][3], sdiv[4], rws[4][4];
  int vals[2][4][8];              // plain and matched-format packs
  float dec0[4][4], dec1[4][4];   // decoded endpoints
};

__host__ __device__ inline int warp_words(int T, int W) {
  return 18 * T + 4 * W + (int)(sizeof(Part) / 4);
}

__global__ void __launch_bounds__(kWarps * 32)
refine_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int NC = a.N * a.C;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= NC) return;
  const int T = a.T, W = a.W, pc = a.pc;
  const int b = i / a.C;
  const float cw[4] = {a.cw[0], a.cw[1], a.cw[2], a.cw[3]};
  const float ls_weight =
      (float)((double)a.cw[0] + (double)a.cw[1] + (double)a.cw[2]);

  float* tex = smem + warp * warp_words(T, W);   // (T, 4)
  float* e0t = tex + 4 * T;                      // (T, 4) decoded endpoints
  float* e1t = e0t + 4 * T;
  float* scale_t = e1t + 4 * T;
  RealignScratch x;
  x.inf = scale_t + T;
  x.At = x.inf + T;
  x.Bt = x.At + T;
  x.Ct = x.Bt + T;
  int* pid = reinterpret_cast<int*>(x.Ct + T);
  x.dlt = reinterpret_cast<float*>(pid + T);
  int* wg = reinterpret_cast<int*>(x.dlt + W);
  x.dn = wg + W;
  x.up = x.dn + W;
  Part& P = *reinterpret_cast<Part*>(x.up + W);

  for (int j = lane; j < 4 * T; j += 32)
    tex[j] = a.texels[(size_t)b * T * 4 + j];
  for (int t = lane; t < T; t += 32) pid[t] = a.pot[(size_t)b * T + t];
  for (int w = lane; w < W; w += 32) wg[w] = a.wgrid0[(size_t)i * W + w];
  if (lane < 16 && lane < 4 * pc) {
    (&P.pe0[0][0])[lane] = a.ep0[(size_t)b * pc * 4 + lane];
    (&P.pe1[0][0])[lane] = a.ep1[(size_t)b * pc * 4 + lane];
  }
  __syncwarp();

  const Stencil st = stencil_of(a.tap_w, a.tap_i, a.wt_t, a.wt_i, a.wt_n,
                                a.dm_color, a.dm[i], T, W, a.K);
  const int* pnq = a.pn + a.wq[i] * 65 * 2;
  bool alive = a.alive[i];
  const int cqv = a.cq[i];
  const int cqm = a.cqm[i];

  // Round-independent refit terms per partition: texel count, channel
  // means, the RGB scale direction and the scale range.
  for (int p = 0; p < pc; ++p) {
    float rsum[4] = {0.f, 0.f, 0.f, 0.f};
    float cnt = 0.f;
    for (int t = lane; t < T; t += 32) {
      if (pid[t] != p) continue;
      cnt += 1.f;
      for (int c = 0; c < 4; ++c) rsum[c] += tex[t * 4 + c];
    }
    cnt = warp_sum(cnt);
    float rws[4], mean[3], sd[3];
    for (int c = 0; c < 4; ++c) {
      rsum[c] = warp_sum(rsum[c]) * cw[c];
      rws[c] = fmaxf(cw[c] * cnt, 1e-17f);
    }
    for (int c = 0; c < 3; ++c) mean[c] = rsum[c] / rws[c];
    const float norm = sqrtf((mean[0] * mean[0] + mean[1] * mean[1])
                             + mean[2] * mean[2]);
    for (int c = 0; c < 3; ++c) sd[c] = mean[c] / (norm > 0.f ? norm : 1.f);
    float smin = 1e10f, smax = -1e10f;
    for (int t = lane; t < T; t += 32) {
      if (pid[t] != p) continue;
      const float s = (sd[0] * tex[t * 4] + sd[1] * tex[t * 4 + 1])
                      + sd[2] * tex[t * 4 + 2];
      scale_t[t] = s;
      smin = fminf(smin, s);
      smax = fmaxf(smax, s);
    }
    smin = warp_min(smin);
    smax = warp_max(smax);
    if (lane == 0) {
      for (int c = 0; c < 4; ++c) P.rws[p][c] = rws[c];
      for (int c = 0; c < 3; ++c) {
        P.sd[p][c] = sd[c];
        P.sds[p][c] = sd[c] * smax;
      }
      P.sdiv[p] = clampf(smin / fmaxf(smax, 1e-10f), 0.f, 1.f);
    }
  }
  __syncwarp();

  for (int r = 0; r < a.R; ++r) {
    // --- infill + least-squares refit, per partition ----------------------
    for (int p = 0; p < pc; ++p) {
      float wmin = 1.f, wmax = 0.f, ls = 0.f, ms = 0.f, rs = 0.f;
      float cvy[4] = {0.f, 0.f, 0.f, 0.f}, cvx[4] = {0.f, 0.f, 0.f, 0.f};
      float sv0 = 0.f, sv1 = 0.f;
      for (int t = lane; t < T; t += 32) {
        if (pid[t] != p) continue;
        const float idx = infill_f(st, wg, t) / 64.f;
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
        const float mss = (left * left + (2.f * middle) * middle)
                          + right * right;
        const float e0f = (right * cvx[c] - middle * cvy[c]) * rdet;
        const float e1f = (left * cvy[c] - middle * cvx[c]) * rdet;
        const bool full = fabsf(det) > mss * 1e-4f && !isnan(e0f)
                          && !isnan(e1f);
        const float avg = (cvx[c] + cvy[c]) / P.rws[p][c];
        if (all_same) {
          ep0[c] = isnan(avg) ? P.pe0[p][c] : avg;
          ep1[c] = isnan(avg) ? P.pe1[p][c] : avg;
        } else {
          ep0[c] = full ? e0f : P.pe0[p][c];
          ep1[c] = full ? e1f : P.pe1[p][c];
        }
      }
      {
        const float lm0 = ls * ls_weight, lm1 = ms * ls_weight,
                    lm2 = rs * ls_weight;
        const float ls_det = lm0 * lm2 - lm1 * lm1;
        const float ls_rdet = 1.f / ls_det;
        const float ls_mss = (lm0 * lm0 + (2.f * lm1) * lm1) + lm2 * lm2;
        const float se0 = (lm2 * sv0 - lm1 * sv1) * ls_rdet;
        const float se1 = (lm0 * sv1 - lm1 * sv0) * ls_rdet;
        const bool ls_ok = fabsf(ls_det) > ls_mss * 1e-4f && !isnan(se0)
                           && !isnan(se1) && se0 < se1;
        for (int c = 0; c < 3; ++c)
          rgbs[c] = all_same ? P.sds[p][c]
                             : (ls_ok ? P.sd[p][c] * se1 : P.sds[p][c]);
        rgbs[3] = all_same ? 1.f
                           : (ls_ok ? se0 / (se1 != 0.f ? se1 : 1.f)
                                    : P.sdiv[p]);
      }
      __syncwarp();
      if (lane == 0) {
        for (int c = 0; c < 4; ++c) {
          P.ep0[p][c] = P.pe0[p][c] = ep0[c];
          P.ep1[p][c] = P.pe1[p][c] = ep1[c];
          P.rgbs[p][c] = rgbs[c];
        }
      }
      __syncwarp();
    }

    // --- pack (and the matched-format pack) + decode ----------------------
    int fmt[4] = {0, 0, 0, 0}, fmt_m[4] = {0, 0, 0, 0};
    bool same = true;
    for (int p = 0; p < pc; ++p) {
      int v[8];
      fmt[p] = pack_ldr(a.lohi, P.ep0[p], P.ep1[p], P.rgbs[p],
                        a.fmt_req[(size_t)i * pc + p], cqv, v);
      same = same && fmt[p] == fmt[0];
      __syncwarp();
      if (lane == 0)
        for (int k = 0; k < 8; ++k) P.vals[0][p][k] = v[k];
    }
    bool matched = false;
    if (pc >= 2 && same && cqv != cqm && cqm >= 4) {
      matched = true;
      for (int p = 0; p < pc; ++p) {
        int v[8];
        fmt_m[p] = pack_ldr(a.lohi, P.ep0[p], P.ep1[p], P.rgbs[p],
                            a.fmt_req[(size_t)i * pc + p], clampi(cqm, 4, 20),
                            v);
        matched = matched && fmt_m[p] == fmt_m[0];
        __syncwarp();
        if (lane == 0)
          for (int k = 0; k < 8; ++k) P.vals[1][p][k] = v[k];
      }
    }
    __syncwarp();
    const int sel = matched ? 1 : 0;
    for (int p = 0; p < pc; ++p) {
      if (matched) fmt[p] = fmt_m[p];
      int e0i[4], e1i[4];
      unpack_ldr(fmt[p], P.vals[sel][p], a.profile, e0i, e1i);
      __syncwarp();
      if (lane == 0)
        for (int c = 0; c < 4; ++c) {
          P.dec0[p][c] = (float)e0i[c];
          P.dec1[p][c] = (float)e1i[c];
        }
    }
    __syncwarp();
    for (int j = lane; j < 4 * T; j += 32) {
      e0t[j] = P.dec0[pid[j >> 2]][j & 3];
      e1t[j] = P.dec1[pid[j >> 2]][j & 3];
    }
    __syncwarp();

    if (r == 0) {
      const float ep = trial_error(lane, T, tex, e0t, e1t, st, wg, wg, -1, cw,
                                   a.u8_mask != 0);
      if (lane == 0) a.out_e[i] = alive ? ep : kBig;
    }
    bool adjusted = false;
    if (alive)
      adjusted = realign(lane, T, W, a.ncolors, tex, e0t, e1t, 0xFu, cw, st,
                         pnq, wg, x);
    const float ep = trial_error(lane, T, tex, e0t, e1t, st, wg, wg, -1, cw,
                                 a.u8_mask != 0);
    int* o = a.out_i + ((size_t)r * NC + i) * (kOut + W);
    if (lane == 0) {
      a.out_e[(size_t)(r + 1) * NC + i] = alive ? ep : kBig;
      for (int p = 0; p < 4; ++p) {
        o[p] = p < pc ? fmt[p] : 0;
        for (int k = 0; k < 8; ++k)
          o[4 + p * 8 + k] = p < pc ? P.vals[sel][p][k] : 0;
      }
      o[36] = matched ? cqm : cqv;
      o[37] = matched ? 1 : 0;
      o[38] = o[39] = 0;
    }
    for (int w = lane; w < W; w += 32) o[kOut + w] = wg[w];
    alive = alive && adjusted;
    __syncwarp();
  }
}

}  // namespace

extern "C" int astc_refine(
    const int* wgrid0, const int* dm, const int* wq, const bool* alive,
    const int* cq, const int* cqm, const int* fmt_req, const float* texels,
    const int* pot, const float* ep0, const float* ep1, const int* tap_w,
    const int* tap_i, const int* wt_t, const int* wt_i, const int* wt_n,
    const int* dm_color, const int* pn, const int* lohi, int N, int C, int T,
    int W, int D, int K, int R, int pc, int ncolors, int u8_mask, int profile,
    float cw0, float cw1, float cw2, float cw3, int* out_i, float* out_e,
    void* stream) {
  if (N < 0 || C < 1 || W > 64 || T > 216 || R < 1 || pc < 1 || pc > 4
      || (profile != 0 && profile != 1))
    return (int)cudaErrorInvalidValue;
  Args a{wgrid0, dm, wq, alive, cq, cqm, fmt_req, texels, pot, ep0, ep1,
         tap_w, tap_i, wt_t, wt_i, wt_n, dm_color, pn, lohi, N, C, T, W, D, K,
         R, pc, ncolors, u8_mask, profile, {cw0, cw1, cw2, cw3}, out_i,
         out_e};
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
