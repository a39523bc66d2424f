// Kernel K8: per-row table gather
// out[b, k, c] = rows[b, clamp(idx[b, k], 0, V - 1), c] on 32-bit words
// (float32 tables arrive as their bit patterns, so NaN payloads, -0.0 and
// denormals pass unchanged).
//
// Replaces astcenc_tpu/ops/gather_pallas.py::_kernel. The TPU kernel
// gathered one channel per launch through 128-lane slabs of the table
// (tpu.dynamic_gather); here one thread handles one (row, index) pair over
// a grid-stride loop and copies all C words of the entry, so the realign's
// prev/next pair (C = 2) is one launch, moved as one 8-byte load and store
// when the table and the output are 8-byte aligned. The indices are int32
// or int64 (a template instantiated for both) and clamped here, so the
// wrapper converts nothing. Each index and entry word is read once and each
// output word written once: the kernel is bound by device memory bytes,
// though at the realign's sizes (tens of thousands of rows of 65 entries)
// a call costs many times its bytes, in launch latency and the wrapper's
// host time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace astc;

constexpr int kThreads = 256;

template <typename I>
__device__ __forceinline__ long long entry(const I* idx, long long e, int V) {
  const long long v = (long long)__ldg(idx + e);
  return v < 0 ? 0 : (v > V - 1 ? V - 1 : v);
}

// Any C: each thread copies the C words of its entry.
template <typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const int* __restrict__ rows, const I* __restrict__ idx,
                  long long B, int V, int K, int C, int* __restrict__ out) {
  const long long n = B * K;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long b = e / K;
    const int* src = rows + (b * V + entry(idx, e, V)) * C;
    int* dst = out + e * C;
    for (int c = 0; c < C; ++c) dst[c] = __ldg(src + c);
  }
}

// C = 2 on 8-byte aligned tables: each entry is one int2.
template <typename I>
__global__ void __launch_bounds__(kThreads)
row_gather2_kernel(const int2* __restrict__ rows, const I* __restrict__ idx,
                   long long B, int V, int K, int2* __restrict__ out) {
  const long long n = B * K;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    out[e] = __ldg(rows + (e / K) * V + entry(idx, e, V));
}

template <typename I>
int launch(const int* rows, const I* idx, int B, int V, int K, int C,
           int* out, cudaStream_t stream) {
  const long long n = (long long)B * K;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  const bool pair = C == 2 && (((uintptr_t)rows | (uintptr_t)out) & 7) == 0;
  if (pair)
    row_gather2_kernel<I><<<(unsigned)grid, kThreads, 0, stream>>>(
        (const int2*)rows, idx, (long long)B, V, K, (int2*)out);
  else
    row_gather_kernel<I><<<(unsigned)grid, kThreads, 0, stream>>>(
        rows, idx, (long long)B, V, K, C, out);
  return (int)cudaGetLastError();
}

}  // namespace

// rows (B, V, C) 32-bit words; idx (B, K) int32, or int64 when idx64 is
// non-zero; out (B, K, C).
extern "C" int astc_row_gather(const int* rows, const void* idx, int idx64,
                               int B, int V, int K, int C, int* out,
                               void* stream) {
  if (B < 0 || V <= 0 || K < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * K == 0 || C == 0) return 0;
  if (idx64)
    return launch((const int*)rows, (const long long*)idx, B, V, K, C, out,
                  (cudaStream_t)stream);
  return launch((const int*)rows, (const int*)idx, B, V, K, C, out,
                (cudaStream_t)stream);
}
