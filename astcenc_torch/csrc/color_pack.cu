// The colour pack: one pack_color_endpoints call of the encoder, both arms,
// in one launch.
//
// Replaces astcenc_tpu/ops/gather_pallas.py::_master_kernel, the colour
// quantizer lookup lo[q, v] | hi[q, v] << 8 that the JAX package's packers
// call some 110-200 times per pack and XLA fuses into one jitted program.
// PyTorch has no jit, so here the lookup moves into a kernel that runs the
// whole pack: one thread per row computes the reference's scalar "try the
// modes in order, the first that fits wins" pack of that row (LDR arm from
// refine_common.cuh, HDR arm from color_pack_hdr.cuh), running only the arm
// that the row's requested format names. Each thread block first stages
// the (17, 256) lo/hi tables in shared memory, packed to 16 bits (8.7 KB),
// so every lookup is one shared-memory read.
//
// Per row it reads 16 floats and 2 ints and writes 9 ints, so its bound is
// device memory bytes; the work between is a few hundred to a few thousand
// scalar operations, more where a retain-top-bits search or the RGB nudge
// loop runs long. Rows of one warp that ask for different formats run
// their arms one after the other (divergence).

#include <cuda_runtime.h>
#include <stdint.h>

#include "color_pack_hdr.cuh"

namespace {

using namespace astc;

constexpr int kNQ = 17;
constexpr int kNV = 256;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
color_pack_kernel(const float* __restrict__ ep0, const float* __restrict__ ep1,
                  const float* __restrict__ rgbs,
                  const float* __restrict__ rgbo,
                  const int* __restrict__ req_fmt,
                  const int* __restrict__ quant_level,
                  const int* __restrict__ lohi, int B, int profile,
                  int* __restrict__ fmt_out, int* __restrict__ vals_out) {
  __shared__ uint16_t tab[kNQ * kNV];
  for (int j = threadIdx.x; j < kNQ * kNV; j += blockDim.x)
    tab[j] = (uint16_t)(__ldg(lohi + j) | (__ldg(lohi + kNQ * kNV + j) << 8));
  __syncthreads();
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    float e0[4], e1[4], s[4], o[4];
    for (int i = 0; i < 4; ++i) {
      e0[i] = __ldg(ep0 + 4 * b + i);
      e1[i] = __ldg(ep1 + 4 * b + i);
      s[i] = __ldg(rgbs + 4 * b + i);
      o[i] = profile >= 2 ? __ldg(rgbo + 4 * b + i) : 0.f;
    }
    int vals[8];
    fmt_out[b] = pack_row(tab, profile, e0, e1, s, o, __ldg(req_fmt + b),
                          __ldg(quant_level + b), vals);
    for (int i = 0; i < 8; ++i) vals_out[8 * b + i] = vals[i];
  }
}

}  // namespace

// ep0, ep1, rgbs (B, 4) float32; rgbo (B, 4) float32, read only when
// profile >= 2 (may be null otherwise); req_fmt, quant_level (B,) int32;
// lohi (2, 17, 256) int32. Writes fmt (B,) and vals (B, 8) int32.
extern "C" int astc_color_pack(const float* ep0, const float* ep1,
                               const float* rgbs, const float* rgbo,
                               const int* req_fmt, const int* quant_level,
                               const int* lohi, int B, int profile,
                               int* fmt, int* vals, void* stream) {
  if (B < 0 || (profile >= 2 && rgbo == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int grid = (B + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  color_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ep0, ep1, rgbs, rgbo, req_fmt, quant_level, lohi, B, profile, fmt, vals);
  return (int)cudaGetLastError();
}
