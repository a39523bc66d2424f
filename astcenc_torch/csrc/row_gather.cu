// Kernel K8: per-row table gather
// out[b, k, c] = rows[b, clamp(idx[b, k], 0, V - 1), c] on 32-bit words
// (float32 tables arrive as their bit patterns, so NaN payloads, -0.0 and
// denormals pass unchanged).
//
// Replaces astcenc_tpu/ops/gather_pallas.py::_kernel. The TPU kernel
// gathered one channel per launch through 128-lane slabs of the table
// (tpu.dynamic_gather); here one thread handles one (row, index) pair over
// a grid-stride loop and copies all C words of the entry, so the realign's
// prev/next pair (C = 2) is one launch. Each index and entry word is read
// once and each output word written once: the kernel is bound by device
// memory bytes, though at the realign's sizes (tens of thousands of rows
// of 65 entries) a call costs many times its bytes, in launch latency and
// the wrapper's host time.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace astc;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const int* __restrict__ rows, const int* __restrict__ idx,
                  long long B, int V, int K, int C, int* __restrict__ out) {
  const long long n = B * K;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long b = e / K;
    const int v = clampi(__ldg(idx + e), 0, V - 1);
    const int* src = rows + (b * V + v) * C;
    int* dst = out + e * C;
    for (int c = 0; c < C; ++c) dst[c] = __ldg(src + c);
  }
}

}  // namespace

extern "C" int astc_row_gather(const int* rows, const int* idx, int B, int V,
                               int K, int C, int* out, void* stream) {
  if (B < 0 || V <= 0 || K < 0 || C < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * K;
  if (n == 0 || C == 0) return 0;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  row_gather_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      rows, idx, (long long)B, V, K, C, out);
  return (int)cudaGetLastError();
}
