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
// floorf(x / scale + u) with u = counter_hash_u32(counter, seed) * 2^-32.
//
// Scales are exact powers of two built from bits: no exp2f, and never
// flush-to-zero, since scales reach 2^-133, a subnormal.
#pragma once

#include <stdint.h>

namespace mx8 {

constexpr int kGroup = 16;
constexpr int kMBits = 6;
constexpr int kExpBias = 127;
constexpr int kExpFloor = -kExpBias + 1;   // -126

__device__ __forceinline__ float exact_pow2(int e) {
  // 2^e for e in [-149, 127]; below 2^-126 a single mantissa bit
  if (e >= -126) return __int_as_float((e + 127) << 23);
  return __int_as_float(1 << (e + 149));
}

__device__ __forceinline__ uint32_t counter_hash_u32(uint32_t counter,
                                                     uint32_t seed) {
  uint32_t x = counter ^ (seed * 0x9E3779B9u);
  x ^= x >> 16;
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

// Scale of value j of a group with shared exponent e and micro bits mic.
__device__ __forceinline__ float group_scale(int e, int mic, int j) {
  return exact_pow2(e - kMBits - ((mic >> (j >> 1)) & 1));
}

// Quantize 16 fp32 values into one MX8 group.  qv receives the rounded,
// clamped mantissas as floats (integers in [-63, 63]), e the unbiased
// shared exponent and mic the packed micro bits.  SR bits of value j come
// from counter flat0 + j.
__device__ __forceinline__ void quantize_group(const float (&x)[kGroup],
                                               uint32_t flat0, uint32_t seed,
                                               int stochastic,
                                               float (&qv)[kGroup], int& e,
                                               int& mic) {
  float gmax = 0.f;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) gmax = fmaxf(gmax, fabsf(x[j]));
  e = frexp_exponent(gmax);
  e = e < kExpFloor ? kExpFloor : (e > 127 ? 127 : e);
  const float half_range = exact_pow2(e - 1);
  mic = 0;
#pragma unroll
  for (int p = 0; p < kGroup / 2; ++p) {
    const float pmax = fmaxf(fabsf(x[2 * p]), fabsf(x[2 * p + 1]));
    mic |= (e > kExpFloor && pmax < half_range ? 1 : 0) << p;
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    float r = __fdiv_rn(x[j], group_scale(e, mic, j));
    if (stochastic) {
      const uint32_t bits = counter_hash_u32(flat0 + (uint32_t)j, seed);
      const float u = __fmul_rn(__uint2float_rn(bits), 2.3283064365386963e-10f);
      r = floorf(__fadd_rn(r, u));
    } else {
      r = rintf(r);
    }
    qv[j] = fminf(fmaxf(r, -63.f), 63.f);
  }
}

}  // namespace mx8
