// The colour endpoint decode of every format under every profile, scalar
// per thread: the HDR arms and the per-pair decode. Device code of
// csrc/color_unpack.cu.
//
// Transcribed from the plain version ops/color_unquant.py (the port of
// astcenc_tpu/ops/color_unquant.py, reference
// astcenc_color_unquantize.cpp:310-820 and 844-1023). Where the plain
// version decodes every format on the whole batch and keeps the one each
// element names, a thread decodes the one format of its pair. The LDR formats are
// refine_common.cuh's unpack_ldr (the decode of K2 and K3). Left shifts run
// on uint32_t and are cast back, so they wrap as the plain version's int32
// shifts do; right shifts of signed values are arithmetic, as torch's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "color_pack_hdr.cuh"

namespace astc {

__device__ __forceinline__ int shl(int x, int n) {
  return (int)((uint32_t)x << n);
}

// The bit of `mode` set in `mask` places `bit` at `sh` (the plain
// version's put over a one-hot of the mode).
__device__ __forceinline__ int put_bit(int x, int oh, int mask, int bit,
                                       int sh) {
  return (oh & mask) ? x | shl(bit, sh) : x;
}

// The major component swizzle of the HDR RGB formats.
__device__ __forceinline__ void swizzle_major(int majcomp, int& r, int& g,
                                              int& b) {
  const int r0 = r, g0 = g, b0 = b;
  r = majcomp == 1 ? g0 : majcomp == 2 ? b0 : r0;
  g = majcomp == 1 ? r0 : g0;
  b = majcomp == 2 ? r0 : b0;
}

// FMT_HDR_RGB_SCALE (reference :310-489).
__device__ void _hdr_rgbo_unpack(const int* v, int* e0, int* e1) {
  const int modeval = ((v[0] & 0xC0) >> 6) | (((v[1] & 0x80) >> 7) << 2) |
                      (((v[2] & 0x80) >> 7) << 3);
  const bool not_c = (modeval & 0xC) != 0xC;
  const bool not_f = modeval != 0xF;
  const int majcomp = not_c ? modeval >> 2 : not_f ? modeval & 3 : 0;
  const int mode = not_c ? modeval & 3 : not_f ? 4 : 5;

  int red = v[0] & 0x3F, green = v[1] & 0x1F, blue = v[2] & 0x1F;
  int scale = v[3] & 0x1F;
  const int bit0 = (v[1] >> 6) & 1, bit1 = (v[1] >> 5) & 1;
  const int bit2 = (v[2] >> 6) & 1, bit3 = (v[2] >> 5) & 1;
  const int bit4 = (v[3] >> 7) & 1, bit5 = (v[3] >> 6) & 1;
  const int bit6 = (v[3] >> 5) & 1;
  const int oh = 1 << mode;

  green = put_bit(put_bit(green, oh, 0x30, bit0, 6), oh, 0x3A, bit1, 5);
  blue = put_bit(put_bit(blue, oh, 0x30, bit2, 6), oh, 0x3A, bit3, 5);
  scale = put_bit(put_bit(put_bit(scale, oh, 0x3D, bit6, 5), oh, 0x2D, bit5,
                          6), oh, 0x04, bit4, 7);
  red = put_bit(red, oh, 0x3B, bit4, 6);
  red = put_bit(red, oh, 0x04, bit3, 6);
  red = put_bit(red, oh, 0x10, bit5, 7);
  red = put_bit(red, oh, 0x0F, bit2, 7);
  red = put_bit(red, oh, 0x05, bit1, 8);
  red = put_bit(red, oh, 0x0A, bit0, 8);
  red = put_bit(red, oh, 0x05, bit0, 9);
  red = put_bit(red, oh, 0x02, bit6, 9);
  red = put_bit(red, oh, 0x01, bit3, 10);
  red = put_bit(red, oh, 0x02, bit5, 10);

  const int shamt = mode > 1 ? mode : 1;          // 1, 1, 2, 3, 4, 5
  red = shl(red, shamt);
  green = shl(green, shamt);
  blue = shl(blue, shamt);
  scale = shl(scale, shamt);
  if (mode != 5) {
    green = red - green;
    blue = red - blue;
  }
  swizzle_major(majcomp, red, green, blue);

  e0[0] = shl(max(red - scale, 0), 4);
  e0[1] = shl(max(green - scale, 0), 4);
  e0[2] = shl(max(blue - scale, 0), 4);
  e1[0] = shl(max(red, 0), 4);
  e1[1] = shl(max(green, 0), 4);
  e1[2] = shl(max(blue, 0), 4);
  e0[3] = e1[3] = 0x7800;
}

// FMT_HDR_RGB (reference :498-679); also the RGB of FMT_HDR_RGB_LDR_ALPHA
// and FMT_HDR_RGBA.
__device__ void _hdr_rgb_unpack(const int* v, int* e0, int* e1) {
  const int modeval = ((v[1] & 0x80) >> 7) | (((v[2] & 0x80) >> 7) << 1) |
                      (((v[3] & 0x80) >> 7) << 2);
  const int majcomp = ((v[4] & 0x80) >> 7) | (((v[5] & 0x80) >> 7) << 1);
  e0[3] = e1[3] = 0x7800;
  if (majcomp == 3) {                              // direct mode
    e0[0] = shl(v[0], 8);
    e0[1] = shl(v[2], 8);
    e0[2] = shl(v[4] & 0x7F, 9);
    e1[0] = shl(v[1], 8);
    e1[1] = shl(v[3], 8);
    e1[2] = shl(v[5] & 0x7F, 9);
    return;
  }
  int a = v[0] | shl(v[1] & 0x40, 2);
  int b0 = v[2] & 0x3F, b1 = v[3] & 0x3F, c = v[1] & 0x3F;
  int dq0 = v[4] & 0x7F, dq1 = v[5] & 0x7F;
  // 7, 6, 7, 6, 5, 6, 5, 6 by modeval
  const int dbits = modeval < 4 ? 7 - (modeval & 1) : 5 + (modeval & 1);
  const int bit0 = (v[2] >> 6) & 1, bit1 = (v[3] >> 6) & 1;
  const int bit2 = (v[4] >> 6) & 1, bit3 = (v[5] >> 6) & 1;
  const int bit4 = (v[4] >> 5) & 1, bit5 = (v[5] >> 5) & 1;
  const int oh = 1 << modeval;

  a = put_bit(a, oh, 0xA4, bit0, 9);
  a = put_bit(a, oh, 0x8, bit2, 9);
  a = put_bit(a, oh, 0x50, bit4, 9);
  a = put_bit(a, oh, 0x50, bit5, 10);
  a = put_bit(a, oh, 0xA0, bit1, 10);
  a = put_bit(a, oh, 0xC0, bit2, 11);
  c = put_bit(put_bit(put_bit(c, oh, 0x4, bit1, 6), oh, 0xE8, bit3, 6), oh,
              0x20, bit2, 7);
  b0 = put_bit(put_bit(b0, oh, 0x5B, bit0, 6), oh, 0x12, bit2, 7);
  b1 = put_bit(put_bit(b1, oh, 0x5B, bit1, 6), oh, 0x12, bit3, 7);
  dq0 = put_bit(put_bit(dq0, oh, 0xAF, bit4, 5), oh, 0x5, bit2, 6);
  dq1 = put_bit(put_bit(dq1, oh, 0xAF, bit5, 5), oh, 0x5, bit3, 6);

  // sign-extend d0/d1 from dbits
  const int sx = 32 - dbits;
  dq0 = shl(dq0, sx) >> sx;
  dq1 = shl(dq1, sx) >> sx;

  const int sh = (modeval >> 1) ^ 3;
  a = shl(a, sh);
  b0 = shl(b0, sh);
  b1 = shl(b1, sh);
  c = shl(c, sh);
  dq0 = shl(dq0, sh);
  dq1 = shl(dq1, sh);
  int r1 = clampi(a, 0, 4095);
  int g1 = clampi(a - b0, 0, 4095);
  int bl1 = clampi(a - b1, 0, 4095);
  int r0 = clampi(a - c, 0, 4095);
  int g0 = clampi(a - b0 - c - dq0, 0, 4095);
  int bl0 = clampi(a - b1 - c - dq1, 0, 4095);
  swizzle_major(majcomp, r0, g0, bl0);
  swizzle_major(majcomp, r1, g1, bl1);
  e0[0] = shl(r0, 4);
  e0[1] = shl(g0, 4);
  e0[2] = shl(bl0, 4);
  e1[0] = shl(r1, 4);
  e1[1] = shl(g1, 4);
  e1[2] = shl(bl1, 4);
}

// FMT_HDR_LUMINANCE_LARGE_RANGE.
__device__ void _hdr_lum_large_unpack(const int* v, int* e0, int* e1) {
  int y0, y1;
  if (v[1] >= v[0]) {
    y0 = shl(v[0], 4);
    y1 = shl(v[1], 4);
  } else {
    y0 = shl(v[1], 4) + 8;
    y1 = shl(v[0], 4) - 8;
  }
  for (int i = 0; i < 3; ++i) {
    e0[i] = shl(y0, 4);
    e1[i] = shl(y1, 4);
  }
  e0[3] = e1[3] = 0x7800;
}

// FMT_HDR_LUMINANCE_SMALL_RANGE.
__device__ void _hdr_lum_small_unpack(const int* v, int* e0, int* e1) {
  int y0, y1;
  if (v[0] & 0x80) {
    y0 = shl(v[1] & 0xE0, 4) | shl(v[0] & 0x7F, 2);
    y1 = shl(v[1] & 0x1F, 2);
  } else {
    y0 = shl(v[1] & 0xF0, 4) | shl(v[0] & 0x7F, 1);
    y1 = shl(v[1] & 0xF, 1);
  }
  y1 = min(y1 + y0, 0xFFF);
  for (int i = 0; i < 3; ++i) {
    e0[i] = shl(y0, 4);
    e1[i] = shl(y1, 4);
  }
  e0[3] = e1[3] = 0x7800;
}

// The HDR alpha of FMT_HDR_RGBA (reference :776-820): both LNS codes.
__device__ void _hdr_alpha_unpack(int v6, int v7, int& a0, int& a1) {
  const int modeval = ((v6 >> 7) & 1) | ((v7 >> 6) & 2);
  const int v6m = v6 & 0x7F, v7m = v7 & 0x7F;
  if (modeval == 3) {
    a0 = shl(shl(v6m, 5), 4);
    a1 = shl(shl(v7m, 5), 4);
    return;
  }
  int v6b = v6m | (shl(v7m, modeval + 1) & 0x780);
  const int half = 32 >> modeval;
  int v7b = v7m & (0x3F >> modeval);
  v7b = (v7b ^ half) - half;
  v6b = shl(v6b, 4 - modeval);
  v7b = shl(v7b, 4 - modeval);
  v7b = clampi(v6b + v7b, 0, 0xFFF);
  a0 = shl(v6b, 4);
  a1 = shl(v7b, 4);
}

// One endpoint pair of ops/color_unquant.py::unpack_color_endpoints_plain:
// e0, e1 in UNORM16 or LNS space, and whether its RGB and its alpha are
// LNS. In the LDR profiles the HDR formats decode as the error colour, as
// does a format outside 0..15 in every profile; in the HDR profiles the
// LDR formats decode to UNORM16.
__device__ void unpack_pair(int fmt, const int* v, int profile, int* e0,
                            int* e1, bool& rgb_hdr, bool& alpha_hdr) {
  rgb_hdr = alpha_hdr = false;
  if (profile < 2 || !is_hdr_format(fmt)) {
    unpack_ldr(fmt, v, profile < 2 ? profile : 1, e0, e1);
    return;
  }
  rgb_hdr = true;
  switch (fmt) {
    case FMT_HDR_LUMINANCE_LARGE_RANGE:
      _hdr_lum_large_unpack(v, e0, e1);
      break;
    case FMT_HDR_LUMINANCE_SMALL_RANGE:
      _hdr_lum_small_unpack(v, e0, e1);
      break;
    case FMT_HDR_RGB_SCALE:
      _hdr_rgbo_unpack(v, e0, e1);
      break;
    default:                  // FMT_HDR_RGB, _RGB_LDR_ALPHA, _RGBA
      _hdr_rgb_unpack(v, e0, e1);
      break;
  }
  if (fmt == FMT_HDR_RGB_LDR_ALPHA) {
    e0[3] = (int)((uint32_t)v[6] * 257u);
    e1[3] = (int)((uint32_t)v[7] * 257u);
  } else if (fmt == FMT_HDR_RGBA) {
    _hdr_alpha_unpack(v[6], v[7], e0[3], e1[3]);
    alpha_hdr = true;
  } else if (profile == 3) {  // the profile's default alpha, LNS
    e0[3] = e1[3] = 0x7800;
    alpha_hdr = true;
  } else {                    // the profile's default alpha, UNORM16
    e0[3] = e1[3] = 0xFF * 257;
  }
}

}  // namespace astc
