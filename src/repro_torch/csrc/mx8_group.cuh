// MX8 group arithmetic shared by the port's quantizing kernels: the fused
// state update (mx_state_update.cu, kernel 1) and the standalone quantizer
// (mx_quant.cu, kernel 7).  One definition, so the two cannot drift apart.
//
// An MX8 group is 16 values along the last axis that share an 8-bit
// exponent e (biased by 127); each pair of values shares a micro-exponent
// bit; each value keeps a sign and 6 magnitude bits.  Value j is stored as
//
//     m_j = clamp(round(x_j / 2^(e - 6 - micro_(j/2))), -63, 63)
//
// with e = frexp exponent of the group's max |x| (2^(e-1) <= max < 2^e),
// clamped to [-126, 127], and micro = 1 where the pair's max is below
// 2^(e-1) -- except at the exponent floor e = -126 (an all-zero group, or
// one below 2^-126), which keeps micro 0, as repro_torch/core/formats.py
// defines it.  Rounding is to nearest even (rintf) or stochastic,
// floorf(x / scale + u) with u = (the counter hash of value j) * 2^-32.
//
// Scales are exact powers of two built from bits: no exp2f, and never
// flush-to-zero, since scales reach 2^-133, a subnormal.
//
// No division and no conversion instruction on the value path (the
// conversion pipe runs at an eighth of the fp32 rate):
//   * x / 2^s is x * 2^-s, bitwise: both are the one rounding of the same
//     real.  2^-s reaches 2^133, past the largest float, for e < -120;
//     such a group is first scaled by 2^64, which is exact (|x| < 2^-120),
//     and the second multiply then rounds as the division did;
//   * round and clamp run on t = r + 1.5 * 2^23, where the spacing of
//     floats is 1: adding rounds r to an integer (to nearest even, or down
//     with __fadd_rd for floor), t - 1.5 * 2^23 is that integer exactly,
//     and the low byte of t's bits is its two's-complement int8 (|r| < 2^8
//     always, so t stays in [2^23, 2^24));
//   * an int8 mantissa becomes a float the same way backwards.
// A zero may come out as +0 where rintf gave -0; its stored byte is the
// same, and y = 0.f + partials never carries a zero's sign.
#pragma once

#include <stdint.h>

namespace mx8 {

constexpr int kGroup = 16;
constexpr int kMBits = 6;
constexpr int kExpBias = 127;
constexpr int kExpFloor = -kExpBias + 1;   // -126
constexpr float kMagic = 12582912.f;       // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;     // its bits

__device__ __forceinline__ float exact_pow2(int e) {
  // 2^e for e in [-149, 127]; below 2^-126 a single mantissa bit
  if (e >= -126) return __int_as_float((e + 127) << 23);
  return __int_as_float(1 << (e + 149));
}

// The SR counter hash of repro_torch/core/formats.py::counter_hash_u32,
//     x = counter ^ (seed * 0x9E3779B9); x ^= x >> 16; x *= 0x7FEB352D;
//     x ^= x >> 15; x *= 0x846CA68B; x ^= x >> 16,
// for the 16 counters flat0 + j of a group, flat0 a multiple of 16: there
// flat0 + j = flat0 ^ j, and j < 2^16 does not reach x >> 16, so the first
// two steps give group_base(flat0, seed) ^ j and group_hash finishes.
__device__ __forceinline__ uint32_t group_base(uint32_t flat0,
                                               uint32_t seed) {
  const uint32_t x = flat0 ^ (seed * 0x9E3779B9u);
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t group_hash(uint32_t base, int j) {
  uint32_t x = base ^ (uint32_t)j;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ int frexp_exponent(float x) {
  // e with 2^(e-1) <= x < 2^e for normal x > 0; -126 otherwise
  if (!(x > 0.f)) return kExpFloor;
  return ((__float_as_int(x) >> 23) & 0xFF) - 126;
}

// The int8 mantissa in byte b of a packed word, as a float (exact).
__device__ __forceinline__ float mantissa_value(uint32_t word, int b) {
  // prmt: byte b, then its sign bit replicated over the three bytes above
  const uint32_t sel = (uint32_t)b | (uint32_t)(0x888 | b * 0x111) << 4;
  int m;
  asm("prmt.b32 %0, %1, %1, %2;" : "=r"(m) : "r"(word), "r"(sel));
  return __fsub_rn(__int_as_float(kMagicBits + m), kMagic);
}

// The 16 stored values m_j * 2^(e - 6 - micro_j) of a group with shared
// exponent e, micro bits mic and packed int8 mantissas w, exact.  Where
// kDequantMagic * scale is a float (e <= 109), one byte permute builds
// the float kDequantMagic + m_j from the biased byte m_j + 128 and one FMA
// takes off kDequantMagic * scale; else through m_j.
constexpr float kDequantMagic = 8388736.f;       // 2^23 + 128
__device__ __forceinline__ void dequantize_group(const uint32_t (&w)[4],
                                                 int e, int mic,
                                                 float (&s)[kGroup]) {
  const float sc0 = exact_pow2(e - kMBits);
  const float sc1 = __fmul_rn(sc0, 0.5f);            // >= 2^-134, exact
  if (e <= 109) {
    const float nc0 = -__fmul_rn(kDequantMagic, sc0);
    const float nc1 = -__fmul_rn(kDequantMagic, sc1);
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
      const uint32_t biased = w[j4] ^ 0x80808080u;   // bytes m + 128
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * j4 + b;
        const bool m = (mic >> (j >> 1)) & 1;
        // bits 0x4B0000XX: the float 2^23 + XX
        const float f = __uint_as_float(
            __byte_perm(biased, 0x4B000000u, 0x7650 + b));
        s[j] = __fmaf_rn(f, m ? sc1 : sc0, m ? nc1 : nc0);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      s[j] = __fmul_rn(mantissa_value(w[j >> 2], j & 3),
                       (mic >> (j >> 1)) & 1 ? sc1 : sc0);
  }
}

// Quantize 16 fp32 values into one MX8 group.  t receives the rounded,
// clamped mantissas m_j as kMagic + m_j (exact; m_j = t_j - kMagic),
// packed the same as int8 bytes (value j in byte j % 4 of word j / 4), e
// the unbiased shared exponent, mic the packed micro bits and scale the
// pairs' scales 2^(e - 6 - micro).  SR bits of value j come from counter
// flat0 + j; flat0 is a multiple of 16.
__device__ __forceinline__ void quantize_group(const float (&x)[kGroup],
                                               uint32_t flat0, uint32_t seed,
                                               int stochastic,
                                               float (&t)[kGroup],
                                               uint32_t (&packed)[4], int& e,
                                               int& mic,
                                               float (&scale)[kGroup / 2]) {
  float pmax[kGroup / 2];
  float gmax = 0.f;
#pragma unroll
  for (int p = 0; p < kGroup / 2; ++p) {
    pmax[p] = fmaxf(fabsf(x[2 * p]), fabsf(x[2 * p + 1]));
    gmax = fmaxf(gmax, pmax[p]);
  }
  e = frexp_exponent(gmax);
  e = e < kExpFloor ? kExpFloor : (e > 127 ? 127 : e);
  const float scale0 = exact_pow2(e - kMBits);       // 2^(e-6) >= 2^-132
  const float half_range = __fmul_rn(scale0, 32.f);  // 2^(e-1), exact

  // reciprocal scales 2^(6-e) (micro 0) and 2^(7-e) (micro 1)
  float xs[kGroup];
  int up = 0;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) xs[j] = x[j];
  if (e < -120) {
    up = 64;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) xs[j] = __fmul_rn(xs[j], 0x1p64f);
  }
  const float rc0 = exact_pow2(kMBits - e - up);
  const float rc1 = __fmul_rn(rc0, 2.f);             // <= 2^127, exact
  const uint32_t base = group_base(flat0, seed);

  mic = 0;
  uint32_t tb[kGroup];
#pragma unroll
  for (int p = 0; p < kGroup / 2; ++p) {
    const bool m = e > kExpFloor && pmax[p] < half_range;
    mic |= (m ? 1 : 0) << p;
    scale[p] = m ? __fmul_rn(scale0, 0.5f) : scale0;
    const float rc = m ? rc1 : rc0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * p + h;
      // r = x / scale is xs[j] * rc exactly; its rounding folds into the
      // add (an inexact r is below 2^-126, which rounds away either way)
      float tj;
      if (stochastic) {
        const float u = __uint2float_rn(group_hash(base, j));
        tj = __fadd_rd(__fmaf_rn(u, 2.3283064365386963e-10f,
                                 __fmul_rn(xs[j], rc)),
                       kMagic);                      // floor(r + u) + magic
      } else {
        tj = __fmaf_rn(xs[j], rc, kMagic);           // rint(r) + magic
      }
      t[j] = fminf(fmaxf(tj, kMagic - 63.f), kMagic + 63.f);
      tb[j] = __float_as_uint(t[j]);
    }
  }
#pragma unroll
  for (int w = 0; w < 4; ++w)
    packed[w] = __byte_perm(__byte_perm(tb[4 * w], tb[4 * w + 1], 0x0040),
                            __byte_perm(tb[4 * w + 2], tb[4 * w + 3], 0x0040),
                            0x5410);
}

}  // namespace mx8
