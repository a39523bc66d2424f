// The HDR arm of the colour pack, and the per-row pack of both arms, scalar
// per thread. Device code of csrc/color_pack.cu.
//
// Transcribed from the plain version ops/color_pack_hdr.py (the port of
// astcenc_tpu/ops/color_pack_hdr.py, reference
// astcenc_color_quantize.cpp:925-1905). Where the plain version evaluates
// every mode (and the 72 decrements of a retain-top-bits search) for every
// row and keeps the first that fits, a thread tries them in order and stops
// at the first. Arithmetic follows the plain version term for term: the
// same association of sums, floor(x + 0.5) where it rounds with _rtn and
// C's truncating (int)(x + 0.5f) where it uses _rtn_trunc, float32
// divides where it divides, and int32 products that wrap as torch's do.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "refine_common.cuh"

namespace astc {

enum {
  FMT_HDR_LUMINANCE_LARGE_RANGE = 2,
  FMT_HDR_LUMINANCE_SMALL_RANGE = 3,
  FMT_HDR_RGB_SCALE = 7,
  FMT_HDR_RGB = 11,
  FMT_HDR_RGB_LDR_ALPHA = 14,
  FMT_HDR_RGBA = 15,
};

__device__ __forceinline__ bool is_hdr_format(int f) {
  return f == FMT_HDR_LUMINANCE_SMALL_RANGE ||
         f == FMT_HDR_LUMINANCE_LARGE_RANGE || f == FMT_HDR_RGB_SCALE ||
         f == FMT_HDR_RGB || f == FMT_HDR_RGB_LDR_ALPHA || f == FMT_HDR_RGBA;
}

// astc::flt2int_rtn of a possibly negative value: (int)(x + 0.5f).
__device__ __forceinline__ int rtn_trunc(float x) { return (int)(x + 0.5f); }

// int32 arithmetic that wraps, as torch's int32 tensors do.
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// quantize_and_unquantize_retain_top_{two,four}_bits (:833-905): the
// quantization of the first of value, value - 1, ... (72 steps, clamped
// to 0..255) whose bits under top_mask survive it; if none does, that of
// the first step (the plain version's argmax of no hit).
template <class Q>
__device__ int retain_top_bits(const Q& q, int value, int top_mask) {
  for (int k = 0; k < 72; ++k) {
    const int vk = clampi(value - k, 0, 255);
    const int qk = q.col(vk);
    if (((qk ^ vk) & top_mask) == 0) return qk;
  }
  return q.col(clampi(value, 0, 255));
}

__device__ __forceinline__ int majcomp_of(float r, float g, float b) {
  return (r > g && r > b) ? 0 : (g > b ? 1 : 2);
}

// The major component moved to the front: (r, g, b) swizzled.
__device__ __forceinline__ void swizzle(int mc, float r, float g, float b,
                                        float* o) {
  o[0] = mc == 1 ? g : (mc == 2 ? b : r);
  o[1] = mc == 1 ? r : g;
  o[2] = mc == 2 ? r : b;
}

// FMT_HDR_RGB_SCALE from the rgbo vector (:925-1253): 4 values.
template <class Q>
__device__ void quantize_hdr_rgbo(const Q& q, const float* rgbo, int* out) {
  float color[4];
  for (int i = 0; i < 3; ++i)
    color[i] = clampf(rgbo[i] + rgbo[3], 0.f, 65535.f);
  color[3] = clampf(rgbo[3], 0.f, 65535.f);
  const int mc = majcomp_of(color[0], color[1], color[2]);
  float sw[3];
  swizzle(mc, color[0], color[1], color[2], sw);
  const float cr = sw[0], cg = sw[1], cb = sw[2];
  const float g_base = cr - cg;
  const float b_base = cr - cb;
  const float s_base = color[3];
  const float third = (float)(1.0 / 3.0);

  const int mode_bits[5][3] = {{11, 5, 7}, {11, 6, 5}, {10, 5, 8}, {9, 6, 7},
                               {8, 7, 6}};
  const float mode_cutoffs[5][2] = {{1024.f, 4096.f}, {2048.f, 1024.f},
                                    {2048.f, 16384.f}, {8192.f, 16384.f},
                                    {32768.f, 16384.f}};
  const float mode_rscales[5] = {32.f, 32.f, 64.f, 128.f, 256.f};
  for (int mode = 0; mode < 5; ++mode) {
    const float gb_cut = mode_cutoffs[mode][0], s_cut = mode_cutoffs[mode][1];
    if (!(g_base <= gb_cut && b_base <= gb_cut && s_base <= s_cut)) continue;
    const int mode_enc = mode < 4 ? (mode | (mc << 2)) : (mc | 0xC);
    const float rscale = mode_rscales[mode];
    const float mscale = 1.f / rscale;
    const int gb_intcut = 1 << mode_bits[mode][1];
    const int s_intcut = 1 << mode_bits[mode][2];

    int r_int = rtn(cr * mscale);
    const int r_q = retain_top_bits(
        q, (r_int & 0x3F) | ((mode_enc & 3) << 6), 0xC0);
    r_int = (r_int & ~0x3F) | (r_q & 0x3F);
    const float r_f = (float)r_int * rscale;

    int g_int = rtn(clampf(r_f - cg, 0.f, 65535.f) * mscale);
    int b_int = rtn(clampf(r_f - cb, 0.f, 65535.f) * mscale);
    if (!(g_int < gb_intcut && b_int < gb_intcut)) continue;

    int bit0, bit1, bit2, bit3;
    if (mode == 0 || mode == 2)
      bit0 = (r_int >> 9) & 1;
    else if (mode == 4)
      bit0 = (g_int >> 6) & 1;
    else
      bit0 = (r_int >> 8) & 1;
    bit2 = mode < 4 ? ((r_int >> 7) & 1) : ((b_int >> 6) & 1);
    bit1 = (mode == 0 || mode == 2) ? ((r_int >> 8) & 1) : ((g_int >> 5) & 1);
    if (mode == 0)
      bit3 = (r_int >> 10) & 1;
    else if (mode == 2)
      bit3 = (r_int >> 6) & 1;
    else
      bit3 = (b_int >> 5) & 1;
    const int g_low = (g_int & 0x1F) | ((mode_enc & 0x4) << 5) | (bit0 << 6) |
                      (bit1 << 5);
    const int b_low = (b_int & 0x1F) | ((mode_enc & 0x8) << 4) | (bit2 << 6) |
                      (bit3 << 5);
    const int g_q = retain_top_bits(q, g_low, 0xF0);
    const int b_q = retain_top_bits(q, b_low, 0xF0);
    g_int = (g_int & ~0x1F) | (g_q & 0x1F);
    b_int = (b_int & ~0x1F) | (b_q & 0x1F);
    const float g_f = (float)g_int * rscale;
    const float b_f = (float)b_int * rscale;

    const float rgb_errsum =
        ((r_f - cr) + ((r_f - g_f) - cg)) + ((r_f - b_f) - cb);
    const float s_f = clampf(s_base + rgb_errsum * third, 0.f, 1e9f);
    const int s_int = rtn(s_f * mscale);
    if (!(s_int < s_intcut)) continue;
    const int bit6 = mode == 1 ? ((r_int >> 9) & 1) : ((s_int >> 5) & 1);
    int bit5;
    if (mode == 4)
      bit5 = (r_int >> 7) & 1;
    else if (mode == 1)
      bit5 = (r_int >> 10) & 1;
    else
      bit5 = (s_int >> 6) & 1;
    const int bit4 = mode == 2 ? ((s_int >> 7) & 1) : ((r_int >> 6) & 1);
    const int s_q = retain_top_bits(
        q, (s_int & 0x1F) | (bit6 << 5) | (bit5 << 6) | (bit4 << 7), 0xF0);
    out[0] = r_q;
    out[1] = g_q;
    out[2] = b_q;
    out[3] = s_q;
    return;
  }

  // Fallback mode 5 (:1210-1253): RGB clamps first; the scale is clamped
  // only after the error is added.
  float v[3], cv[3];
  int iv[3];
  for (int i = 0; i < 3; ++i) {
    v[i] = clampf(color[i], 0.f, 65020.f);
    iv[i] = rtn(v[i] * (1.f / 512.f));
    cv[i] = (float)iv[i] * 512.f;
  }
  const float errsum = ((cv[0] - v[0]) + (cv[1] - v[1])) + (cv[2] - v[2]);
  const float s3 = clampf(color[3] + errsum * third, 0.f, 65020.f);
  const int i3 = rtn(s3 * (1.f / 512.f));
  out[0] = retain_top_bits(q, (iv[0] & 0x3F) | 0xC0, 0xF0);
  out[1] = retain_top_bits(q, (iv[1] & 0x7F) | 0x80, 0xF0);
  out[2] = retain_top_bits(q, (iv[2] & 0x7F) | 0x80, 0xF0);
  out[3] = retain_top_bits(q, (i3 & 0x7F) | ((iv[0] & 0x40) << 1), 0xF0);
}

// FMT_HDR_RGB (:1253-1640): 6 values.
template <class Q>
__device__ void quantize_hdr_rgb(const Q& q, const float* e0, const float* e1,
                                 int* out) {
  float c0[3], c1[3];
  for (int i = 0; i < 3; ++i) {
    c0[i] = clampf(e0[i], 0.f, 65535.f);
    c1[i] = clampf(e1[i], 0.f, 65535.f);
  }
  const int mc = majcomp_of(c1[0], c1[1], c1[2]);
  float s0[3], s1[3];
  swizzle(mc, c0[0], c0[1], c0[2], s0);
  swizzle(mc, c1[0], c1[1], c1[2], s1);
  const float c0r = s0[0], c0g = s0[1], c0bl = s0[2];
  const float c1r = s1[0], c1g = s1[1], c1bl = s1[2];

  const float a_base = clampf(c1r, 0.f, 65535.f);
  const float b0_base = a_base - c1g;
  const float b1_base = a_base - c1bl;
  const float c_base = a_base - c0r;
  const float d0_base = ((a_base - b0_base) - c_base) - c0g;
  const float d1_base = ((a_base - b1_base) - c_base) - c0bl;

  const int mode_bits[8][4] = {{9, 7, 6, 7},  {9, 8, 6, 6},  {10, 6, 7, 7},
                               {10, 7, 7, 6}, {11, 8, 6, 5}, {11, 6, 8, 6},
                               {12, 7, 7, 5}, {12, 6, 7, 6}};
  const float mode_cutoffs[8][3] = {
      {16384.f, 8192.f, 8192.f}, {32768.f, 8192.f, 4096.f},
      {4096.f, 8192.f, 4096.f},  {8192.f, 8192.f, 2048.f},
      {8192.f, 2048.f, 512.f},   {2048.f, 8192.f, 1024.f},
      {2048.f, 2048.f, 256.f},   {1024.f, 2048.f, 512.f}};
  const float mode_rscales[8] = {128.f, 128.f, 64.f, 64.f,
                                 32.f,  32.f,  16.f, 16.f};
  for (int mode = 7; mode >= 0; --mode) {
    const float b_cut = mode_cutoffs[mode][0], c_cut = mode_cutoffs[mode][1],
                d_cut = mode_cutoffs[mode][2];
    if (!(b0_base <= b_cut && b1_base <= b_cut && c_base <= c_cut &&
          fabsf(d0_base) <= d_cut && fabsf(d1_base) <= d_cut))
      continue;
    const float rscale = mode_rscales[mode];
    const float mscale = 1.f / rscale;
    const int b_intcut = 1 << mode_bits[mode][1];
    const int c_intcut = 1 << mode_bits[mode][2];
    const int d_intcut = 1 << (mode_bits[mode][3] - 1);

    int a_int = rtn(a_base * mscale);
    const int a_q = q.col(a_int & 0xFF);
    a_int = (a_int & ~0xFF) | a_q;
    const float a_f = (float)a_int * rscale;

    int c_int = rtn(clampf(a_f - c0r, 0.f, 65535.f) * mscale);
    if (!(c_int < c_intcut)) continue;
    const int c_q = retain_top_bits(
        q, (c_int & 0x3F) | ((mode & 1) << 7) | ((a_int & 0x100) >> 2), 0xC0);
    c_int = (c_int & ~0x3F) | (c_q & 0x3F);
    const float c_f = (float)c_int * rscale;

    int b0_int = rtn(clampf(a_f - c1g, 0.f, 65535.f) * mscale);
    int b1_int = rtn(clampf(a_f - c1bl, 0.f, 65535.f) * mscale);
    if (!(b0_int < b_intcut && b1_int < b_intcut)) continue;
    int bit0, bit1;
    if (mode == 0 || mode == 1 || mode == 3 || mode == 4 || mode == 6) {
      bit0 = (b0_int >> 6) & 1;
      bit1 = (b1_int >> 6) & 1;
    } else if (mode == 2) {
      bit0 = (a_int >> 9) & 1;
      bit1 = (c_int >> 6) & 1;
    } else {   // 5, 7
      bit0 = (a_int >> 9) & 1;
      bit1 = (a_int >> 10) & 1;
    }
    const int b0_q = retain_top_bits(
        q, (b0_int & 0x3F) | (bit0 << 6) | (((mode >> 1) & 1) << 7), 0xC0);
    const int b1_q = retain_top_bits(
        q, (b1_int & 0x3F) | (bit1 << 6) | (((mode >> 2) & 1) << 7), 0xC0);
    b0_int = (b0_int & ~0x3F) | (b0_q & 0x3F);
    b1_int = (b1_int & ~0x3F) | (b1_q & 0x3F);
    const float b0_f = (float)b0_int * rscale;
    const float b1_f = (float)b1_int * rscale;

    const int d0_int = rtn_trunc(
        clampf(((a_f - b0_f) - c_f) - c0g, -65535.f, 65535.f) * mscale);
    const int d1_int = rtn_trunc(
        clampf(((a_f - b1_f) - c_f) - c0bl, -65535.f, 65535.f) * mscale);
    if (!(abs(d0_int) < d_intcut && abs(d1_int) < d_intcut)) continue;
    int bit2, bit3, bit4, bit5;
    if (mode == 0 || mode == 2) {
      bit2 = (d0_int >> 6) & 1;
      bit3 = (d1_int >> 6) & 1;
    } else if (mode == 1 || mode == 4) {
      bit2 = (b0_int >> 7) & 1;
      bit3 = (b1_int >> 7) & 1;
    } else if (mode == 3) {
      bit2 = (a_int >> 9) & 1;
      bit3 = (c_int >> 6) & 1;
    } else if (mode == 5) {
      bit2 = (c_int >> 7) & 1;
      bit3 = (c_int >> 6) & 1;
    } else {   // 6, 7
      bit2 = (a_int >> 11) & 1;
      bit3 = (c_int >> 6) & 1;
    }
    if (mode == 4 || mode == 6) {
      bit4 = (a_int >> 9) & 1;
      bit5 = (a_int >> 10) & 1;
    } else {
      bit4 = (d0_int >> 5) & 1;
      bit5 = (d1_int >> 5) & 1;
    }
    out[0] = a_q;
    out[1] = c_q;
    out[2] = b0_q;
    out[3] = b1_q;
    out[4] = retain_top_bits(
        q, (d0_int & 0x1F) | (bit2 << 6) | (bit4 << 5) | ((mc & 1) << 7),
        0xF0);
    out[5] = retain_top_bits(
        q, (d1_int & 0x1F) | (bit3 << 6) | (bit5 << 5) | (((mc >> 1) & 1) << 7),
        0xF0);
    return;
  }

  // Flat fallback (:1600-1640), on the unswizzled clamped endpoints.
  const float v[6] = {clampf(c0[0], 0.f, 65020.f), clampf(c1[0], 0.f, 65020.f),
                      clampf(c0[1], 0.f, 65020.f), clampf(c1[1], 0.f, 65020.f),
                      clampf(c0[2], 0.f, 65020.f), clampf(c1[2], 0.f, 65020.f)};
  for (int i = 0; i < 4; ++i) out[i] = q.col(rtn(v[i] / 256.f));
  for (int i = 4; i < 6; ++i)
    out[i] = retain_top_bits(q, rtn(v[i] / 512.f) + 128, 0xC0);
}

// The luminance pair of both HDR luminance encodings.
__device__ void lum_pair(const float* c0, const float* c1, int* il0,
                         int* il1) {
  const float lum0 = ((c0[0] + c0[1]) + c0[2]) / 3.f;
  const float lum1 = ((c1[0] + c1[1]) + c1[2]) / 3.f;
  const bool swap = lum1 < lum0;
  const float avg = (lum0 + lum1) * 0.5f;
  *il0 = rtn(swap ? avg : lum0);
  *il1 = rtn(swap ? avg : lum1);
}

// FMT_HDR_LUMINANCE_LARGE_RANGE (:1644-1706): 2 values.
template <class Q>
__device__ void quantize_hdr_luminance_large(const Q& q, int il0, int il1,
                                             int* out) {
  const int up0 = clampi((il0 + 128) >> 8, 0, 255);
  const int up1 = clampi((il1 + 128) >> 8, 0, 255);
  const int lo0 = clampi((il1 + 256) >> 8, 0, 255);
  const int lo1 = clampi(il0 >> 8, 0, 255);
  const int ud0 = (up0 << 8) - il0;
  const int ud1 = (up1 << 8) - il1;
  const int ld0 = ((lo1 << 8) + 128) - il0;
  const int ld1 = ((lo0 << 8) - 128) - il1;
  const bool use_up = wadd(wmul(ud0, ud0), wmul(ud1, ud1)) <
                      wadd(wmul(ld0, ld0), wmul(ld1, ld1));
  out[0] = q.col(use_up ? up0 : lo0);
  out[1] = q.col(use_up ? up1 : lo1);
}

// FMT_HDR_LUMINANCE_SMALL_RANGE (:1716-1812): whether it fits, 2 values.
template <class Q>
__device__ bool try_quantize_hdr_luminance_small(const Q& q, int il0, int il1,
                                                 int* out) {
  if (!((il1 - il0) <= 2048)) return false;
  // high-precision submode
  int lo = clampi((il0 + 16) >> 5, 0, 2047);
  int hi = clampi((il1 + 16) >> 5, 0, 2047);
  int v0e = q.col(lo & 0x7F);
  int lo2 = (lo & ~0x7F) | v0e;
  int diff = hi - lo2;
  int v1 = ((lo2 >> 3) & 0xF0) | clampi(diff, 0, 15);
  int v1e = q.col(v1);
  if (v0e < 0x80 && diff >= 0 && diff <= 15 && (v1e & 0xF0) == (v1 & 0xF0)) {
    out[0] = v0e;
    out[1] = v1e;
    return true;
  }
  // low-precision submode
  lo = clampi((il0 + 32) >> 6, 0, 1023);
  hi = clampi((il1 + 32) >> 6, 0, 1023);
  v0e = q.col((lo & 0x7F) | 0x80);
  lo2 = (lo & ~0x7F) | (v0e & 0x7F);
  diff = hi - lo2;
  v1 = ((lo2 >> 2) & 0xE0) | clampi(diff, 0, 31);
  v1e = q.col(v1);
  if ((v0e & 0x80) != 0 && diff >= 0 && diff <= 31 &&
      (v1e & 0xE0) == (v1 & 0xE0)) {
    out[0] = v0e;
    out[1] = v1e;
    return true;
  }
  return false;
}

// HDR alpha (:1816-1885): 2 values.
template <class Q>
__device__ void quantize_hdr_alpha(const Q& q, float a0, float a1, int* out) {
  const int ia0 = rtn(clampf(a0, 0.f, 65280.f));
  const int ia1 = rtn(clampf(a1, 0.f, 65280.f));
  const int testbits[3] = {0xE0, 0xF0, 0xF8};
  for (int i = 2; i >= 0; --i) {
    const int val0 = (ia0 + (128 >> i)) >> (8 - i);
    const int val1 = (ia1 + (128 >> i)) >> (8 - i);
    const int v6 = (val0 & 0x7F) | ((i & 1) << 7);
    const int v6e = q.col(v6);
    if (((v6 ^ v6e) & 0x80) != 0) continue;
    const int val0b = (val0 & ~0x7F) | (v6e & 0x7F);
    const int diff = val1 - val0b;
    const int cutoff = 32 >> i;
    if (!(diff >= -cutoff && diff < cutoff)) continue;
    const int v7 = ((i & 2) << 6) | ((val0b >> 7) << (6 - i)) |
                   (diff & (2 * cutoff - 1));
    const int v7e = q.col(v7);
    if (((v7 ^ v7e) & testbits[i]) != 0) continue;
    out[0] = v6e;
    out[1] = v7e;
    return;
  }
  out[0] = q.col(((ia0 + 256) >> 9) | 0x80);
  out[1] = q.col(((ia1 + 256) >> 9) | 0x80);
}

// The HDR arm of pack_color_endpoints (:2049-2141) for one HDR request.
template <class Q>
__device__ int pack_hdr_q(const Q& q, const float* ep0, const float* ep1,
                          const float* rgbo, int req_fmt, int* vals) {
  for (int i = 0; i < 8; ++i) vals[i] = 0;
  switch (req_fmt) {
    case FMT_HDR_RGB_SCALE:
      quantize_hdr_rgbo(q, rgbo, vals);
      return FMT_HDR_RGB_SCALE;
    case FMT_HDR_LUMINANCE_SMALL_RANGE:
    case FMT_HDR_LUMINANCE_LARGE_RANGE: {
      int il0, il1;
      lum_pair(ep0, ep1, &il0, &il1);
      if (try_quantize_hdr_luminance_small(q, il0, il1, vals))
        return FMT_HDR_LUMINANCE_SMALL_RANGE;
      quantize_hdr_luminance_large(q, il0, il1, vals);
      return FMT_HDR_LUMINANCE_LARGE_RANGE;
    }
    case FMT_HDR_RGB_LDR_ALPHA: {
      quantize_hdr_rgb(q, ep0, ep1, vals);
      const float a0 = clampf(ep0[3] / 257.f, 0.f, 255.f);
      const float a1 = clampf(ep1[3] / 257.f, 0.f, 255.f);
      vals[6] = q.res(rtn(a0), a0);
      vals[7] = q.res(rtn(a1), a1);
      return FMT_HDR_RGB_LDR_ALPHA;
    }
    case FMT_HDR_RGBA:
      quantize_hdr_rgb(q, ep0, ep1, vals);
      quantize_hdr_alpha(q, ep0[3], ep1[3], vals + 6);
      return FMT_HDR_RGBA;
    default:   // FMT_HDR_RGB
      quantize_hdr_rgb(q, ep0, ep1, vals);
      return FMT_HDR_RGB;
  }
}

// Profile-aware pack_color_endpoints of one row: the HDR arm for an HDR
// request under an HDR profile (2, 3), the LDR arm otherwise. tab is the
// (17, 256) packed table; rgbo is read only by the HDR arm.
__device__ int pack_row(const uint16_t* tab, int profile, const float* ep0,
                        const float* ep1, const float* rgbs, const float* rgbo,
                        int req_fmt, int quant_level, int* vals) {
  Quant16 q;
  q.qidx = clampi(quant_level - 4, 0, 16);
  q.t = tab + q.qidx * 256;
  if (profile >= 2 && is_hdr_format(req_fmt))
    return pack_hdr_q(q, ep0, ep1, rgbo, req_fmt, vals);
  return pack_ldr_q(q, ep0, ep1, rgbs, req_fmt, vals);
}

}  // namespace astc
