// Kernel K9: colour quantizer lookup out[b, k] = lo[q[b], v[b, k]]
// | hi[q[b], v[b, k]] << 8 from the (17, 256) colour quant tables.
//
// Replaces astcenc_tpu/ops/gather_pallas.py::_master_kernel. One thread per
// (row, value) element over a grid-stride loop; each thread block first
// stages both tables in shared memory, packed as lo | hi << 8 in 16 bits
// (8.7 KB), so every lookup is one shared-memory read. q is clamped to
// [0, 16] and v to [0, 255], as master_lookup does. The work is one read of
// q and v and one write of the result per element: bound by device memory
// bytes, and at the colour packers' sizes by launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace astc;

constexpr int kNQ = 17;
constexpr int kNV = 256;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quant_lookup_kernel(const int* __restrict__ q, const int* __restrict__ v,
                    const int* __restrict__ lohi, long long B, int K,
                    int* __restrict__ out) {
  __shared__ uint16_t tab[kNQ * kNV];
  for (int j = threadIdx.x; j < kNQ * kNV; j += blockDim.x)
    tab[j] = (uint16_t)(__ldg(lohi + j) | (__ldg(lohi + kNQ * kNV + j) << 8));
  __syncthreads();
  const long long n = B * K;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int row = clampi(__ldg(q + e / K), 0, kNQ - 1);
    const int val = clampi(__ldg(v + e), 0, kNV - 1);
    out[e] = (int)tab[row * kNV + val];
  }
}

}  // namespace

extern "C" int astc_quant_lookup(const int* q, const int* v, const int* lohi,
                                 int B, int K, int* out, void* stream) {
  if (B < 0 || K < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * K;
  if (n == 0) return 0;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  quant_lookup_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      q, v, lohi, (long long)B, K, out);
  return (int)cudaGetLastError();
}
