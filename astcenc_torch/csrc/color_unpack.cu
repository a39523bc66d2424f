// The colour endpoint decode: one unpack_color_endpoints call in one
// launch, every format under every profile.
//
// Replaces no TPU kernel: the JAX package decodes in XLA, which fuses the
// plain version's per-format arms into one jitted program. PyTorch has no
// jit, so the plain version (ops/color_unquant.py), which decodes all 16
// formats on the whole batch and picks one per element, dispatches some 700
// operations a call in the HDR profiles (174 in the LDR ones); in the HDR
// rounds of the encoder those held 43% of a -ch image's launches. Here one
// thread decodes one endpoint pair: the arm its format names
// (color_unpack_hdr.cuh; the LDR formats through refine_common.cuh's
// unpack_ldr), bit for bit the plain version's.
//
// Per pair it reads 1 format and 8 values and writes 8 endpoint values and
// 2 flags, about 70 bytes, so its bound is device memory bytes: a few
// microseconds at the HDR rounds' batch sizes, less than the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "color_unpack_hdr.cuh"

namespace {

using namespace astc;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
color_unpack_kernel(const int* __restrict__ fmt, const int* __restrict__ vals,
                    int B, int profile, int* __restrict__ ep0,
                    int* __restrict__ ep1, bool* __restrict__ rgb_hdr,
                    bool* __restrict__ alpha_hdr) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    int v[8], e0[4], e1[4];
    for (int i = 0; i < 8; ++i) v[i] = __ldg(vals + 8 * b + i);
    bool rh, ah;
    unpack_pair(__ldg(fmt + b), v, profile, e0, e1, rh, ah);
    for (int i = 0; i < 4; ++i) {
      ep0[4 * b + i] = e0[i];
      ep1[4 * b + i] = e1[i];
    }
    if (rgb_hdr != nullptr) rgb_hdr[b] = rh;
    if (alpha_hdr != nullptr) alpha_hdr[b] = ah;
  }
}

}  // namespace

// fmt (B,) int32; vals (B, 8) int32; profile 0-3. Writes ep0, ep1 (B, 4)
// int32 and, where not null, rgb_hdr and alpha_hdr (B,) bool.
extern "C" int astc_color_unpack(const int* fmt, const int* vals, int B,
                                 int profile, int* ep0, int* ep1,
                                 bool* rgb_hdr, bool* alpha_hdr,
                                 void* stream) {
  if (B < 0 || profile < 0 || profile > 3) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int grid = (B + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  color_unpack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      fmt, vals, B, profile, ep0, ep1, rgb_hdr, alpha_hdr);
  return (int)cudaGetLastError();
}
