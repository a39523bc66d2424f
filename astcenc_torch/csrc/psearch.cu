// Kernel K4: line-error ranking of candidate partitionings.
//
// Replaces astcenc_tpu/ops/psearch_pallas.py::_psearch_kernel. For each
// block and each of its S candidate partitionings: per partition the means,
// the dominant direction (the first-longest sum of positive deviations),
// the squared distances of the texels to the uncorrelated line and the
// same-chroma line, and the line-length penalty. The alpha channel takes
// part only for blocks whose alpha varies. Arithmetic follows the plain
// version (ops/psearch.py), term for term.
//
// Layout for the H100: one CTA per block, its texels loaded once into
// shared memory; each half-warp takes one candidate, so a warp runs two.
// A lane reads its texels' partition ids straight from the partition table
// into one register (2 bits a texel), so no row is staged per candidate.
// Each phase is one pass over the lane's texels for all P partitions, with
// a set of accumulators per partition (P is a template parameter), and
// the partitions' sums are reduced together.
//
// The sums keep the order of the one-warp-per-candidate kernel this
// replaced, so the outputs are bit-identical to it: there lane l added the
// texels t = l, l + 32, ... in turn and the lanes combined by an xor
// butterfly (16, 8, 4, 2, 1). Here lane h of a half-warp holds the sums of
// the old lanes h and h + 16 apart, adds them (the butterfly's first step,
// without a shuffle) and takes the four other steps inside the half-warp.
// Each lane's line errors run partition by partition, as the old lanes'
// running sums did. The kernel is bound by the latency of its dependent
// reductions; two candidates a warp and one shuffle step fewer per
// reduction cut the passes and butterflies per candidate.
//
// phases: load means directions line_errors output

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace astc;

constexpr int kWarps = 4;
constexpr int kSlots = 2 * kWarps;     // candidates in flight per CTA
constexpr int kMaxPer = 7;             // texels of a lane's half: T <= 216

struct Args {
  const float* texels;   // (N, T, 4)
  const int* ua;         // (N,) alpha varies
  const int* top;        // (N, S) packed partitioning index
  const int* pot;        // (Q, T) partition of each texel
  int N, S, T;
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

// The old warp_sum of one value from its lanes h (a) and h + 16 (b).
__device__ __forceinline__ float half_sum(float a, float b) {
  float v = a + b;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float half_min(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Texel k of half `hh` (0: the old lane h, 1: the old lane h + 16).
__device__ __forceinline__ int texel_of(int h, int hh, int k) {
  return h + 16 * hh + 32 * k;
}

// Two partitions (the common form) at 64 registers, 8 CTAs an SM: more
// resident warps paid back a few spills (tools/torch_phase_clocks.py).
template <int P>
__global__ void __launch_bounds__(kWarps * 32, P == 2 ? 8 : 4)
psearch_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = lane & 15;
  const int n = blockIdx.x;
  const int T = a.T, S = a.S;
  float* tex = smem;                                      // (T, 4)
  PHASE_START(lane == 0);
  for (int j = threadIdx.x; j < 4 * T; j += kWarps * 32)
    tex[j] = a.texels[(size_t)n * T * 4 + j];
  __syncthreads();

  const bool ua = a.ua[n] != 0;
  const float cm[4] = {1.f, 1.f, 1.f, ua ? 1.f : 0.f};
  // sqrt(ncomp) of the plain version's unit diagonal cm / sqrt(ncomp).
  const float root_nc = ua ? 2.f : (float)1.7320508075688772;
  const int nc = ua ? 4 : 3;
  // Texels of each half of this lane: t = h + 16 hh + 32 k, k < cnt[hh].
  int cnt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    cnt[hh] = T > h + 16 * hh ? (T - h - 16 * hh + 31) / 32 : 0;
  PHASE_MARK(0);

  // Both halves run the same steps; a half past the last candidate
  // repeats the other's and writes nothing. The partition ids of a
  // candidate are read one iteration ahead, so their loads overlap the
  // previous candidate's work.
  auto cand = [&](int s0) { return s0 + (lane >> 4) < S ? s0 + (lane >> 4)
                                                        : s0; };
  int raw[2][kMaxPer];
  auto fetch = [&](int s0) {
    const int* row = a.pot + (size_t)a.top[(size_t)n * S + cand(s0)] * T;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k)
        if (k < cnt[hh]) raw[hh][k] = row[texel_of(h, hh, k)];
  };
  if (warp * 2 < S) fetch(warp * 2);
  for (int s0 = warp * 2; s0 < S; s0 += kSlots) {
    const int s = cand(s0);
    unsigned pids[2] = {0u, 0u};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k)
        if (k < cnt[hh]) pids[hh] |= (unsigned)raw[hh][k] << (2 * k);
    if (s0 + kSlots < S) fetch(s0 + kSlots);
    PHASE_MARK(0);

    // --- counts and means, all partitions in one pass ---------------------
    float cntp[P][2], sum[P][4][2];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        cntp[p][hh] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[p][c][hh] = 0.f;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      for (int k = 0; k < cnt[hh]; ++k) {
        const int tp = (pids[hh] >> (2 * k)) & 3;
        const float* x = tex + texel_of(h, hh, k) * 4;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (tp != p) continue;
          cntp[p][hh] += 1.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[p][c][hh] += x[c] * cm[c];
        }
      }
    float count[P], avg[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      count[p] = half_sum(cntp[p][0], cntp[p][1]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        avg[p][c] = half_sum(sum[p][c][0], sum[p][c][1]) / fmaxf(count[p], 1.f);
    }
    PHASE_MARK(1);

    // --- dominant directions: a pass per channel in use -------------------
    float best[P][4], best_norm[P];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= nc) break;
      float np[P][2], ps[P][4][2];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          np[p][hh] = 0.f;
#pragma unroll
          for (int d = 0; d < 4; ++d) ps[p][d][hh] = 0.f;
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        for (int k = 0; k < cnt[hh]; ++k) {
          const int tp = (pids[hh] >> (2 * k)) & 3;
          const float* x = tex + texel_of(h, hh, k) * 4;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (tp != p || !(x[c] * cm[c] - avg[p][c] > 0.f)) continue;
            np[p][hh] += 1.f;
#pragma unroll
            for (int d = 0; d < 4; ++d) ps[p][d][hh] += x[d] * cm[d];
          }
        }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float npp = half_sum(np[p][0], np[p][1]);
        float sd[4], norm = 0.f;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          sd[d] = (half_sum(ps[p][d][0], ps[p][d][1]) - avg[p][d] * npp)
                  * cm[d];
          norm += sd[d] * sd[d] * cm[d];
        }
        if (c == 0 || norm > best_norm[p]) {
          best_norm[p] = norm;
#pragma unroll
          for (int d = 0; d < 4; ++d) best[p][d] = sd[d];
        }
      }
    }
    PHASE_MARK(2);

    // --- line errors, partition by partition ------------------------------
    float uerr[2] = {0.f, 0.f}, serr[2] = {0.f, 0.f}, uext = 0.f, sext = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float bu[4], bs[4], am[4], avc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) avc[c] = avg[p][c] * cm[c];
      normalize_safe(best[p], cm, root_nc, bu);
      normalize_safe(avc, cm, root_nc, bs);
      float dp = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) dp += avg[p][c] * bu[c] * cm[c];
#pragma unroll
      for (int c = 0; c < 4; ++c) am[c] = avg[p][c] - bu[c] * dp;

      float lo = 1e10f, hi = -1e10f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        for (int k = 0; k < cnt[hh]; ++k) {
          if ((int)((pids[hh] >> (2 * k)) & 3) != p) continue;
          const float* x = tex + texel_of(h, hh, k) * 4;
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
          uerr[hh] += eu;
          serr[hh] += es;
          lo = fminf(lo, pu);
          hi = fmaxf(hi, pu);
        }
      lo = half_min(lo);
      hi = half_max(hi);
      const float ll = fmaxf(hi - lo, 1e-7f);
      const float lsq = ll * ll;
      const float ew = count[p] * a.wie;
      float bu2 = 0.f, bs2 = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bu2 += (bu[c] * cm[c]) * (bu[c] * cm[c]);
        bs2 += (bs[c] * cm[c]) * (bs[c] * cm[c]);
      }
      uext += bu2 * lsq * ew;
      sext += bs2 * lsq * ew;
    }
    const float ue = half_sum(uerr[0], uerr[1]);
    const float se = half_sum(serr[0], serr[1]);
    PHASE_MARK(3);
    if (h == 0 && s0 + (lane >> 4) < S) {
      a.out_u[(size_t)n * S + s] = ue + uext;
      a.out_s[(size_t)n * S + s] = se + sext;
    }
    PHASE_MARK(4);
  }
}

template <int P>
int launch(const Args& a, void* stream) {
  const size_t smem = sizeof(float) * 4 * (size_t)a.T;
  psearch_kernel<P><<<a.N, kWarps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int astc_psearch(const float* texels, const int* ua,
                            const int* top, const int* pot, int N, int S,
                            int T, int P, float wie, float cw0, float cw1,
                            float cw2, float cw3, float* out_u, float* out_s,
                            void* stream) {
  if (N < 0 || S < 1 || T < 1 || T > 32 * kMaxPer - 8 || P < 2 || P > 4)
    return (int)cudaErrorInvalidValue;
  Args a{texels, ua, top, pot, N, S, T, wie, {cw0, cw1, cw2, cw3}, out_u,
         out_s};
  if (N == 0) return 0;
  switch (P) {
    case 2: return launch<2>(a, stream);
    case 3: return launch<3>(a, stream);
    default: return launch<4>(a, stream);
  }
}
