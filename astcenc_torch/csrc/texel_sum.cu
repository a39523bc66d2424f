// Texel sums in a fixed order: out[n, p, c] = sum over t of a[n, t, p] *
// b[n, t, c], each product rounded to float32 and then added.
//
// No TPU kernel: this is a repair of the port. The encoder's glue sums
// over a block's texels outside its kernels (partition means, dominant
// directions, line errors, k-means centres, the block mean and the 2-plane
// correlation). PyTorch's reductions and batched products add those terms
// in one order on the CPU and in another on the card, and a last-bit
// difference in such a sum flips encoder decisions. This kernel adds them
// in the CPU's order, so the card's sums are the CPU's bit for bit:
// order 0 adds texel 0, then 1, then 2 (the order of the CPU's batched
// product for a one-hot mask); order 1 is the CPU's reduction over an
// outer axis (x.sum(1)): runs of 16 texels added in turn into level 0,
// whose total moves up a cascade of 4 levels (ATen's multi_row_sum);
// order 2 adds in turn in float64 and rounds once (the CPU's cumsum).
//
// One thread per output walks the texels in order. The work is tiny (N P C
// threads of T terms each) and bound by device memory bytes; the inputs may
// be broadcast views (stride 0), so no operand is copied to make it
// contiguous. Built with --fmad=false: a product and its sum round apart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLevels = 4;

struct Args {
  const float* a;
  const float* b;
  float* out;              // (N, P, C)
  long long N;
  int T, P, C, order, level_power;
  long long sa[3], sb[3];  // element strides of a (n, t, p) and b (n, t, c)
};

__global__ void __launch_bounds__(kThreads) texel_sum_kernel(Args g) {
  const long long total = g.N * g.P * g.C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % g.C);
    const int p = (int)((i / g.C) % g.P);
    const long long n = i / ((long long)g.C * g.P);
    const float* a = g.a + n * g.sa[0] + p * g.sa[2];
    const float* b = g.b + n * g.sb[0] + c * g.sb[2];
    if (g.order == 2) {
      double wide = 0.0;
      for (int t = 0; t < g.T; ++t)
        wide = wide + (double)(a[t * g.sa[1]] * b[t * g.sb[1]]);
      g.out[i] = (float)wide;
      continue;
    }
    float acc[kLevels] = {0.f, 0.f, 0.f, 0.f};
    int t = 0;
    if (g.order == 1) {
      const int step = 1 << g.level_power;
      const int mask = step - 1;
      while (t + step <= g.T) {
        for (int j = 0; j < step; ++j, ++t)
          acc[0] = acc[0] + a[t * g.sa[1]] * b[t * g.sb[1]];
        for (int j = 1; j < kLevels; ++j) {
          acc[j] = acc[j] + acc[j - 1];
          acc[j - 1] = 0.f;
          if ((t & (mask << (j * g.level_power))) != 0) break;
        }
      }
    }
    for (; t < g.T; ++t) acc[0] = acc[0] + a[t * g.sa[1]] * b[t * g.sb[1]];
    if (g.order == 1)
      for (int j = 1; j < kLevels; ++j) acc[0] = acc[0] + acc[j];
    g.out[i] = acc[0];
  }
}

}  // namespace

extern "C" int astc_texel_sum(const float* a, const float* b, float* out,
                              long long N, int T, int P, int C, int order,
                              int level_power, long long sa_n, long long sa_t,
                              long long sa_p, long long sb_n, long long sb_t,
                              long long sb_c, void* stream) {
  if (N < 0 || T < 0 || P < 1 || C < 1 || order < 0 || order > 2
      || level_power < 1 || level_power > 7)
    return (int)cudaErrorInvalidValue;
  const long long total = N * P * C;
  if (total == 0) return 0;
  Args g{a, b, out, N, T, P, C, order, level_power,
         {sa_n, sa_t, sa_p}, {sb_n, sb_t, sb_c}};
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  texel_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g);
  return (int)cudaGetLastError();
}
