// What the decode-attention loops share, for Hopper (sm_90a): the MX8
// dequantization of one 16-value group, bf16 pairs, cp.async staging, the
// warp reductions, and where a 128-position tile of a batch row lives (the
// `Rows` policies):
//
//   Rows::tile_base(b, t)  ->  row index (in units of one position of one
//                              kv head) of position t*128, kv head 0
//
// The GQA loop (mx_attention_split.cuh) and the MLA loop (mx_mla_tile.cuh)
// run the same arithmetic whichever policy they are given, so the paged
// kernels are bitwise equal to the dense ones over gathered pages.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxattn {

constexpr int kGroup = 16;
constexpr int kMBits = 6;
constexpr int kExpBias = 127;
constexpr int kTile = 128;        // positions per tile (one page)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float exact_pow2(int e) {
  if (e >= -126) return __int_as_float((e + 127) << 23);
  return __int_as_float(1 << (e + 149));
}

union Group16 {
  int4 vec;
  int8_t m[kGroup];
};

// Dequantize one 16-value group: mantissas at m, exponent / micro bytes.
__device__ __forceinline__ void dequant_group(const int8_t* m, uint8_t ebyte,
                                              uint8_t mic, float* out) {
  Group16 g;
  g.vec = *reinterpret_cast<const int4*>(m);
  const int e = (int)ebyte - kExpBias;
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    out[j] = __fmul_rn((float)g.m[j],
                       exact_pow2(e - kMBits - ((mic >> (j >> 1)) & 1)));
}

// An exact bf16 value's fp32 bits end in 16 zeros: two values in a word
// (the first in the low half), and back.
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// Aligned 16-byte chunks that can cover w bytes starting anywhere.
__host__ __device__ constexpr int cover_chunks(int w) { return (w + 30) / 16; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int clip_len(int len, int cap) {
  return len < 0 ? 0 : (len > cap ? cap : len);
}

// Dense cache (B, T, KVH, d): tile t of row b starts at position b*T + t*128.
struct DenseRows {
  int T, KVH;
  __device__ __forceinline__ size_t tile_base(int b, int tile) const {
    return ((size_t)b * T + (size_t)tile * kTile) * KVH;
  }
};

// Paged pool (P, n_stack, 128, KVH, d): tile t of row b is page bt[b, t] of
// layer `group`.
struct PagedRows {
  const int* bt;
  int npg, n_stack, group, KVH;
  __device__ __forceinline__ size_t tile_base(int b, int tile) const {
    const int page = bt[(size_t)b * npg + tile];
    return ((size_t)page * n_stack + group) * kTile * KVH;
  }
};

}  // namespace mxattn
