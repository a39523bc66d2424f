// Kernel K4: line-error ranking of candidate partitionings.
//
// Replaces astcenc_tpu/ops/psearch_pallas.py::_psearch_kernel. One thread
// block per ASTC block: its texels are loaded once into shared memory and
// its warps take the S candidate partitionings in turn. A warp reads its
// candidate's partition-of-texel row from the partition table by packed
// index, then per partition: the means, the dominant direction (the
// first-longest sum of positive deviations), the squared distances of the
// texels to the uncorrelated line and the same-chroma line, and the
// line-length penalty. Lanes go over texels; sums are warp shuffles. The
// alpha channel takes part only for blocks whose alpha varies. Arithmetic
// follows the plain version (ops/psearch.py), term for term.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace astc;

constexpr int kWarps = 4;

struct Args {
  const float* texels;   // (N, T, 4)
  const int* ua;         // (N,) alpha varies
  const int* top;        // (N, S) packed partitioning index
  const int* pot;        // (Q, T) partition of each texel
  int N, S, T, P;
  float wie;
  float cw[4];
  float* out_u;          // (N, S)
  float* out_s;          // (N, S)
};

__device__ __forceinline__ void normalize_safe(const float* v, const float* cm,
                                               float root_nc, float* o) {
  float lensq = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) lensq += v[c] * v[c] * cm[c];
  const float rl = sqrtf(lensq > 0.f ? lensq : 1.f);
#pragma unroll
  for (int c = 0; c < 4; ++c) o[c] = lensq == 0.f ? cm[c] / root_nc : v[c] / rl;
}

__global__ void __launch_bounds__(kWarps * 32)
psearch_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x;
  const int T = a.T, S = a.S, P = a.P;
  float* tex = smem;                                      // (T, 4)
  int* pid = reinterpret_cast<int*>(tex + 4 * T) + warp * T;
  for (int j = threadIdx.x; j < 4 * T; j += kWarps * 32)
    tex[j] = a.texels[(size_t)n * T * 4 + j];
  __syncthreads();

  const bool ua = a.ua[n] != 0;
  const float cm[4] = {1.f, 1.f, 1.f, ua ? 1.f : 0.f};
  // sqrt(ncomp) of the plain version's unit diagonal cm / sqrt(ncomp).
  const float root_nc = ua ? 2.f : (float)1.7320508075688772;
  const int nc = ua ? 4 : 3;

  for (int s = warp; s < S; s += kWarps) {
    const int* row = a.pot + (size_t)a.top[(size_t)n * S + s] * T;
    for (int t = lane; t < T; t += 32) pid[t] = row[t];
    __syncwarp();
    float uerr = 0.f, serr = 0.f, uext = 0.f, sext = 0.f;
    for (int p = 0; p < P; ++p) {
      float cnt = 0.f, sum[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = lane; t < T; t += 32) {
        if (pid[t] != p) continue;
        cnt += 1.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[c] += tex[t * 4 + c] * cm[c];
      }
      cnt = warp_sum(cnt);
      float avg[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) avg[c] = warp_sum(sum[c]) / fmaxf(cnt, 1.f);

      float best[4] = {0.f, 0.f, 0.f, 0.f}, best_norm = 0.f;
      for (int c = 0; c < nc; ++c) {
        float np = 0.f, ps[4] = {0.f, 0.f, 0.f, 0.f};
        for (int t = lane; t < T; t += 32) {
          if (pid[t] != p || !(tex[t * 4 + c] * cm[c] - avg[c] > 0.f))
            continue;
          np += 1.f;
#pragma unroll
          for (int d = 0; d < 4; ++d) ps[d] += tex[t * 4 + d] * cm[d];
        }
        np = warp_sum(np);
        float sd[4], norm = 0.f;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          sd[d] = (warp_sum(ps[d]) - avg[d] * np) * cm[d];
          norm += sd[d] * sd[d] * cm[d];
        }
        if (c == 0 || norm > best_norm) {
          best_norm = norm;
#pragma unroll
          for (int d = 0; d < 4; ++d) best[d] = sd[d];
        }
      }
      float bu[4], bs[4], am[4], avc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) avc[c] = avg[c] * cm[c];
      normalize_safe(best, cm, root_nc, bu);
      normalize_safe(avc, cm, root_nc, bs);
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) dp += avg[c] * bu[c] * cm[c];
#pragma unroll
      for (int c = 0; c < 4; ++c) am[c] = avg[c] - bu[c] * dp;

      float lo = 1e10f, hi = -1e10f;
      for (int t = lane; t < T; t += 32) {
        if (pid[t] != p) continue;
        const float* x = tex + t * 4;
        float pu = 0.f, pv = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pu += x[c] * bu[c] * cm[c];
          pv += x[c] * bs[c] * cm[c];
        }
        float eu = 0.f, es = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float du = (am[c] + pu * bu[c]) - x[c];
          const float ds = pv * bs[c] - x[c];
          eu += du * du * a.cw[c] * cm[c];
          es += ds * ds * a.cw[c] * cm[c];
        }
        uerr += eu;
        serr += es;
        lo = fminf(lo, pu);
        hi = fmaxf(hi, pu);
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      const float ll = fmaxf(hi - lo, 1e-7f);
      const float lsq = ll * ll;
      const float ew = cnt * a.wie;
      float bu2 = 0.f, bs2 = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bu2 += (bu[c] * cm[c]) * (bu[c] * cm[c]);
        bs2 += (bs[c] * cm[c]) * (bs[c] * cm[c]);
      }
      uext += bu2 * lsq * ew;
      sext += bs2 * lsq * ew;
    }
    uerr = warp_sum(uerr);
    serr = warp_sum(serr);
    if (lane == 0) {
      a.out_u[(size_t)n * S + s] = uerr + uext;
      a.out_s[(size_t)n * S + s] = serr + sext;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int astc_psearch(const float* texels, const int* ua,
                            const int* top, const int* pot, int N, int S,
                            int T, int P, float wie, float cw0, float cw1,
                            float cw2, float cw3, float* out_u, float* out_s,
                            void* stream) {
  if (N < 0 || S < 1 || T < 1 || T > 216 || P < 2 || P > 4)
    return (int)cudaErrorInvalidValue;
  Args a{texels, ua, top, pot, N, S, T, P, wie, {cw0, cw1, cw2, cw3}, out_u,
         out_s};
  const size_t smem = sizeof(float) * (size_t)(4 * T + kWarps * T);
  if (N == 0) return 0;
  psearch_kernel<<<N, kWarps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
