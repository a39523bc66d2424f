// CPU stand-in for the CUDA runtime and device intrinsics, so that the
// kernels of astcenc_torch/csrc compile with g++ and run on a CPU (see
// rehearse.py): one std::thread per CUDA thread, a CTA at a time;
// std::barrier for __syncthreads and __syncwarp; shuffles, votes and
// ballots through an exchange array (a __syncwarp, shuffle or vote waits
// for the lanes of its half-warp where its mask names one half, else for
// all 32 lanes); dynamic shared memory filled with
// garbage before each CTA, as on a card. Float arithmetic is the host's
// (built with -ffp-contract=off, like nvcc's --fmad=false), but libm is
// glibc's: atan2f and the like may differ from CUDA's in the last bit.
#pragma once
#include <math.h>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cstddef>
#include <barrier>
#include <thread>
#include <vector>
#include <memory>
struct int2 { int x, y; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__
#define __shared__ static  // CTAs run one at a time
alignas(16) inline float shim_smem[1 << 16];
using std::isnan;
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline long long clock64() { return 0; }
struct ShimCTA {
  std::unique_ptr<std::barrier<>> cta;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<std::unique_ptr<std::barrier<>>> half;  // two a warp
  uint32_t xch[1024];
};
inline ShimCTA* g_cta;
inline void __syncthreads() { g_cta->cta->arrive_and_wait(); }
inline void __syncwarp(unsigned m = 0xffffffffu) {
  const unsigned w = threadIdx.x / 32;
  if (m == 0x0000FFFFu || m == 0xFFFF0000u) g_cta->half[2 * w + (m >> 16 ? 1 : 0)]->arrive_and_wait();
  else g_cta->warp[w]->arrive_and_wait();
}
template <class T> inline T __shfl_xor_sync(unsigned m, T v, int o) {
  uint32_t u; std::memcpy(&u, &v, 4);
  g_cta->xch[threadIdx.x] = u; __syncwarp(m);
  uint32_t r = g_cta->xch[(threadIdx.x & ~31u) | ((threadIdx.x & 31u) ^ (unsigned)o)]; __syncwarp(m);
  T out; std::memcpy(&out, &r, 4); return out;
}
template <class T> inline T __shfl_sync(unsigned m, T v, int src) {
  uint32_t u; std::memcpy(&u, &v, 4);
  g_cta->xch[threadIdx.x] = u; __syncwarp(m);
  uint32_t r = g_cta->xch[(threadIdx.x & ~31u) | ((unsigned)src & 31u)]; __syncwarp(m);
  T out; std::memcpy(&out, &r, 4); return out;
}
// Votes read the lanes their mask names (a half-warp's vote sees its own
// half).
inline int __any_sync(unsigned m, int p) {
  g_cta->xch[threadIdx.x] = p ? 1 : 0; __syncwarp(m);
  int any = 0; for (unsigned l = 0; l < 32; ++l) if ((m >> l) & 1u) any |= g_cta->xch[(threadIdx.x & ~31u) | l];
  __syncwarp(m); return any;
}
inline int __all_sync(unsigned m, int p) {
  g_cta->xch[threadIdx.x] = p ? 1 : 0; __syncwarp(m);
  int all = 1; for (unsigned l = 0; l < 32; ++l) if ((m >> l) & 1u) all &= g_cta->xch[(threadIdx.x & ~31u) | l];
  __syncwarp(m); return all;
}
inline unsigned __ballot_sync(unsigned m, int p) {
  g_cta->xch[threadIdx.x] = p ? 1 : 0; __syncwarp(m);
  unsigned b = 0; for (unsigned l = 0; l < 32; ++l) if ((m >> l) & 1u) b |= g_cta->xch[(threadIdx.x & ~31u) | l] << l;
  __syncwarp(m); return b;
}
template <class T> inline T atomicAdd(T* p, T v) { T o = *p; *p += v; return o; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline const char* cudaGetErrorString(cudaError_t) { return "shim error"; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline int shim_sms = 2;
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = shim_sms; return cudaSuccess; }
template <class K> inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int v) {
  return v <= 232448 ? cudaSuccess : cudaErrorInvalidValue; }
template <class K> inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return cudaSuccess; }
template <class K, class... A>
inline void shim_launch(K kernel, unsigned grid, unsigned block, size_t smem, A... a) {
  if (smem > sizeof(shim_smem)) { fprintf(stderr, "shim: smem %zu too large\n", smem); abort(); }
  gridDim = dim3(grid); blockDim = dim3(block);
  for (unsigned b = 0; b < grid; ++b) {
    ShimCTA st;
    st.cta = std::make_unique<std::barrier<>>(block);
    for (unsigned w = 0; w < (block + 31) / 32; ++w) {
      st.warp.push_back(std::make_unique<std::barrier<>>(32));
      for (int h = 0; h < 2; ++h) st.half.push_back(std::make_unique<std::barrier<>>(16));
    }
    std::memset(shim_smem, 0xAB, smem);  // garbage, as on a card
    g_cta = &st;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([=] { threadIdx = dim3(t); blockIdx = dim3(b); kernel(a...); });
    for (auto& t : ts) t.join();
  }
}
#include <bit>
inline int __popc(unsigned v) { return std::popcount(v); }
