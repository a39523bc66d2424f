// Kernel K3: all R refinement rounds of a 2-plane, 1-partition trial.
//
// Replaces astcenc_tpu/ops/refine_pallas.py::_trial2_full_kernel. One warp
// per (block, candidate) lane, the layout of K2 (refine.cu). Each round:
// infill both grids, 2-plane least-squares refit (ops/recompute.py::
// recompute_ideal_colors_2planes), LDR colour pack and decode, trial error
// before (round 0) and after realigning both planes against the one
// stencil, plane 1 on every channel but the plane-2 component and plane 2
// on that component alone (refine_common.cuh).
//
// Built without fast math: the refit needs IEEE divides and square roots.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "refine_common.cuh"

namespace {

using namespace astc;

constexpr int kWarps = 4;
constexpr int kOut = 16;     // header words per round and lane

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
  float cw[4];
  int* out_i;                // (R, NC, 16 + 2 W)
  float* out_e;              // (R + 1, NC)
};

__host__ __device__ inline int warp_words(int T, int W) {
  return 17 * T + 5 * W;
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

__global__ void __launch_bounds__(kWarps * 32)
refine2_kernel(Args a) {
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
  const float ls_weight =
      (float)((double)a.cw[0] + (double)a.cw[1] + (double)a.cw[2]);

  float* tex = smem + warp * warp_words(T, W);   // (T, 4)
  float* e0t = tex + 4 * T;
  float* e1t = e0t + 4 * T;
  float* scale_t = e1t + 4 * T;
  RealignScratch x;
  x.inf = scale_t + T;
  x.At = x.inf + T;
  x.Bt = x.At + T;
  x.Ct = x.Bt + T;
  x.dlt = x.Ct + T;
  int* w1 = reinterpret_cast<int*>(x.dlt + W);
  int* w2 = w1 + W;
  x.dn = w2 + W;
  x.up = x.dn + W;

  for (int j = lane; j < 4 * T; j += 32)
    tex[j] = a.texels[(size_t)row * T * 4 + j];
  for (int w = lane; w < W; w += 32) {
    w1[w] = a.wg1[(size_t)i * W + w];
    w2[w] = a.wg2[(size_t)i * W + w];
  }
  __syncwarp();

  const Stencil st = stencil_of(a.tap_w, a.tap_i, a.wt_t, a.wt_i, a.wt_n,
                                a.dm_color, a.dm[i], T, W, a.K);
  const int* pnq = a.pn + a.wq[i] * 65 * 2;
  bool alive = a.alive[i];
  const int cqv = a.cq[i];
  const int freq = a.fmt_req[i];
  float pe0[4], pe1[4], rws[4];
  for (int c = 0; c < 4; ++c) {
    pe0[c] = a.ep0[b * 4 + c];
    pe1[c] = a.ep1[b * 4 + c];
    rws[c] = fmaxf(cw[c] * (float)T, 1e-17f);
  }

  // Round-independent: the RGB scale direction from the block mean.
  float sd[3];
  {
    const float* m = a.mean + (size_t)row * 4;
    const float norm = sqrtf((m[0] * m[0] + m[1] * m[1]) + m[2] * m[2]);
    for (int c = 0; c < 3; ++c) sd[c] = m[c] / (norm > 0.f ? norm : 1.f);
  }
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
  const float scalediv = clampf(smin / fmaxf(smax, 1e-10f), 0.f, 1.f);
  float sds[3];
  for (int c = 0; c < 3; ++c) sds[c] = sd[c] * smax;
  __syncwarp();

  for (int r = 0; r < a.R; ++r) {
    // --- infill both planes + 2-plane least-squares refit ----------------
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
    for (int c = 0; c < 4; ++c) {
      cvy[c] = warp_sum(cvy[c]) * cw[c];
      cvx[c] = warp_sum(cvx[c]) * cw[c];
    }
    sv0 = warp_sum(sv0) * ls_weight;
    sv1 = warp_sum(sv1) * ls_weight;

    const bool same1 = wmin1 >= wmax1 * 0.999f;
    const bool same2 = wmin2 >= wmax2 * 0.999f;
    float ep0[4], ep1[4], rgbs[4];
    for (int c = 0; c < 4; ++c) {
      const float avg = (cvx[c] + cvy[c]) / rws[c];
      const bool two = c == p2c;
      float e0f, e1f;
      const bool ok = two ? solve(l2, m2, r2, cw[c], cvx[c], cvy[c], &e0f,
                                  &e1f)
                          : solve(l1, m1, r1, cw[c], cvx[c], cvy[c], &e0f,
                                  &e1f);
      const bool same = two ? same2 : same1;
      if (same && !isnan(avg)) {
        ep0[c] = ep1[c] = avg;
      } else if (!same && ok) {
        ep0[c] = e0f;
        ep1[c] = e1f;
      } else {
        ep0[c] = pe0[c];
        ep1[c] = pe1[c];
      }
      pe0[c] = ep0[c];
      pe1[c] = ep1[c];
    }
    {
      const float lm0 = l1 * ls_weight, lm1 = m1 * ls_weight,
                  lm2 = r1 * ls_weight;
      const float ls_det = lm0 * lm2 - lm1 * lm1;
      const float ls_mss = (lm0 * lm0 + (2.f * lm1) * lm1) + lm2 * lm2;
      const float se0 = (lm2 * sv0 - lm1 * sv1) / ls_det;
      const float se1 = (lm0 * sv1 - lm1 * sv0) / ls_det;
      const bool ls_ok = fabsf(ls_det) > ls_mss * 1e-4f && !isnan(se0)
                         && !isnan(se1) && se0 < se1;
      for (int c = 0; c < 3; ++c)
        rgbs[c] = same1 ? sds[c] : (ls_ok ? sd[c] * se1 : sds[c]);
      rgbs[3] = same1 ? 1.f
                      : (ls_ok ? se0 / (se1 != 0.f ? se1 : 1.f) : scalediv);
    }

    // --- pack + decode -------------------------------------------------------
    int vals[8];
    const int fmt = pack_ldr(a.lohi, ep0, ep1, rgbs, freq, cqv, vals);
    int e0i[4], e1i[4];
    unpack_ldr(fmt, vals, a.profile, e0i, e1i);
    for (int j = lane; j < 4 * T; j += 32) {
      e0t[j] = (float)e0i[j & 3];
      e1t[j] = (float)e1i[j & 3];
    }
    __syncwarp();

    if (r == 0) {
      const float ep = trial_error(lane, T, tex, e0t, e1t, st, w1, w2, p2c,
                                   cw, a.u8_mask != 0);
      if (lane == 0) a.out_e[i] = alive ? ep : kBig;
    }
    bool adjusted = false;
    if (alive) {
      const unsigned m2c = 1u << p2c;
      const bool a1 = realign(lane, T, W, a.ncolors, tex, e0t, e1t,
                              0xFu & ~m2c, cw, st, pnq, w1, x);
      const bool a2 = realign(lane, T, W, a.ncolors, tex, e0t, e1t, m2c, cw,
                              st, pnq, w2, x);
      adjusted = a1 || a2;
    }
    const float ep = trial_error(lane, T, tex, e0t, e1t, st, w1, w2, p2c, cw,
                                 a.u8_mask != 0);
    int* o = a.out_i + ((size_t)r * NC + i) * (kOut + 2 * W);
    if (lane == 0) {
      a.out_e[(size_t)(r + 1) * NC + i] = alive ? ep : kBig;
      o[0] = fmt;
      for (int k = 0; k < 8; ++k) o[1 + k] = vals[k];
      for (int k = 9; k < kOut; ++k) o[k] = 0;
    }
    for (int w = lane; w < W; w += 32) {
      o[kOut + w] = w1[w];
      o[kOut + W + w] = w2[w];
    }
    alive = alive && adjusted;
    __syncwarp();
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
    float cw3, int* out_i, float* out_e, void* stream) {
  if (N < 0 || N0 < 1 || C < 1 || W > 63 || T > 216 || R < 1
      || (profile != 0 && profile != 1))
    return (int)cudaErrorInvalidValue;
  Args a{wg1, wg2, dm, wq, alive, cq, fmt_req, p2c, texels, mean, ep0, ep1,
         tap_w, tap_i, wt_t, wt_i, wt_n, dm_color, pn, lohi, N, N0, C, T, W,
         D, K, R, ncolors, u8_mask, profile, {cw0, cw1, cw2, cw3}, out_i,
         out_e};
  const size_t smem = sizeof(float) * (size_t)warp_words(T, W) * kWarps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refine2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long lanes = (long long)N * C;
  const long long grid = (lanes + kWarps - 1) / kWarps;
  if (grid == 0) return 0;
  refine2_kernel<<<(unsigned)grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
