// Shared helpers for the astcenc_torch CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace astc {

constexpr float kBig = 1e30f;        // ERROR_CALC_DEFAULT
constexpr unsigned kFull = 0xffffffffu;

// Butterfly reductions: every lane ends with the bit-identical result,
// because each step adds the same two operands on both partner lanes.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// float_to_int_rtn: floor(x + 0.5).
__device__ __forceinline__ int rtn(float x) { return (int)floorf(x + 0.5f); }

}  // namespace astc

extern "C" const char* astc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
