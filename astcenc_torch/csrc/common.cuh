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

// Phase clocks, in a build with -DASTC_PHASE_CLOCKS only
// (tools/torch_phase_clocks.py): a kernel names its phases on a
// "// phases:" line, starts with PHASE_START(on) and ends phase k with
// PHASE_MARK(k); each thread for which `on` holds adds the clock64()
// cycles since its previous mark to phase k's counter, which
// astc_phase_cycles reads (and zeroes with reset).
#ifdef ASTC_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[9];
#define PHASE_START(on)           \
  const bool phase_on = (on);     \
  long long t_mark = clock64()
#define PHASE_MARK(k)                                                   \
  do {                                                                  \
    if (phase_on) {                                                     \
      const long long now = clock64();                                  \
      atomicAdd(&g_phase_cycles[k], (unsigned long long)(now - t_mark)); \
      t_mark = now;                                                     \
    }                                                                   \
  } while (0)

extern "C" int astc_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles,
                                       sizeof(g_phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)e;
}
#else
#define PHASE_START(on) do {} while (0)
#define PHASE_MARK(k) do {} while (0)
#endif
