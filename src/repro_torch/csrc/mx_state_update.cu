// Fused MX8 state update for Hopper (sm_90a): one decode step of paper Eq. 2
//
//     S' = d (.) S + k v^T ;   y = S'^T q
//
// over a packed MX8 state stored transposed, (B, H, dv, dk), with groups of
// 16 values along dk that share an 8-bit exponent and pairs that share a
// micro-exponent bit.
//
// Replaces the TPU kernel repro/kernels/mx_state_update.py::mx_state_update
// (_state_update_kernel).  What bounds it on an H100: bytes.  Each step reads
// and writes the packed state once (9 stored bits per value) and does about
// ten flops per value, far below the card's ~20 flops-per-byte fp32 ridge.
// The design therefore touches every state byte exactly once: one thread
// owns one 16-value group of one dv row (one 16-byte mantissa load plus its
// exponent and micro bytes), dequantizes, updates, requantizes and writes it
// back in place, and the row's output dot product is reduced in shared
// memory.  No intermediate leaves registers.
//
// Numerics match repro_torch/kernels/ref.py and, to a stated mismatch rate,
// the JAX package (see ROADMAP.md); the group requantize is mx8_group.cuh's,
// shared with the standalone quantizer (mx_quant.cu):
//   * scales are exact powers of two built from bits (no exp2f, and no
//     flush-to-zero: scales reach 2^-133, a subnormal);
//   * Sn = fma(S, d, round(v * k)) with explicit intrinsics, the contraction
//     XLA:CPU applies to the jitted reference;
//   * SR bits come from the same counter hash over the global flat index
//     ((b*H + h)*dv + row)*dk + col, in uint32 arithmetic.
//
// Slab mode (the paged serving pool): the state rows live in a slab pool
// (n_slabs, n_stack, H, dv, dk) and row b of the batch owns slab slab[b] at
// layer `group`, so the state pointer of (b, h) becomes
// pool[(slab[b] * n_stack + group) * H + h], updated in place -- no gather
// or scatter around the kernel.  The SR counter and the operand indices
// stay on the batch row b*H + h, so slab mode is bitwise equal to dense
// mode on the gathered rows.  Idle rows all point at scratch slab 0; their
// concurrent updates of it race harmlessly (it is never read back).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx8_group.cuh"

namespace {

using mx8::kExpBias;
using mx8::kGroup;
using mx8::kMBits;
constexpr int kThreads = 256;

union Group16 {
  int4 vec;
  int8_t m[kGroup];
};

__global__ void __launch_bounds__(kThreads)
mx_state_update_kernel(int8_t* __restrict__ mant, uint8_t* __restrict__ expo,
                       uint8_t* __restrict__ micro,
                       const float* __restrict__ d,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ q,
                       float* __restrict__ y,
                       const int* __restrict__ slab, int H, int n_stack,
                       int group, int dv, int dk, int d_per_channel,
                       uint32_t seed, int stochastic, int rows_per_block) {
  extern __shared__ float part[];  // rows_per_block * ngroups partial dots
  const int ngroups = dk / kGroup;
  const int bh = blockIdx.x;
  const int local = threadIdx.x;
  const int row = blockIdx.y * rows_per_block + local / ngroups;
  const int grp = local % ngroups;
  // state row of (b, h): the batch row itself, or its slab's row at layer
  // `group` in slab mode
  const size_t sbh =
      slab == nullptr
          ? (size_t)bh
          : ((size_t)slab[bh / H] * n_stack + group) * H + bh % H;

  float partial = 0.f;
  if (row < dv) {
    const size_t rowid = (size_t)bh * dv + row;       // operands, SR counter
    const size_t srow = sbh * dv + row;               // state storage
    const size_t gid = srow * ngroups + grp;
    const int col0 = grp * kGroup;
    const float vrow = v[rowid];

    Group16 g;
    g.vec = *reinterpret_cast<const int4*>(mant + srow * dk + col0);
    const int e_old = (int)expo[gid] - kExpBias;
    const int mic_old = micro[gid];

    // dequantize, decay + outer product: Sn = fma(S, d, v*k)
    float sn[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int mb = (mic_old >> (j >> 1)) & 1;
      const float s =
          __fmul_rn((float)g.m[j], mx8::exact_pow2(e_old - kMBits - mb));
      const float dj = d_per_channel ? d[(size_t)bh * dk + col0 + j] : d[bh];
      const float vk = __fmul_rn(vrow, k[(size_t)bh * dk + col0 + j]);
      sn[j] = __fmaf_rn(s, dj, vk);
    }

    // requantize (RNE or SR; the group arithmetic of mx8_group.cuh), then
    // the output dot product on the stored values
    float qv[kGroup];
    int e, mic;
    mx8::quantize_group(sn, (uint32_t)(rowid * (size_t)dk + col0), seed,
                        stochastic, qv, e, mic);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      g.m[j] = (int8_t)qv[j];
      partial = __fmaf_rn(__fmul_rn(qv[j], mx8::group_scale(e, mic, j)),
                          q[(size_t)bh * dk + col0 + j], partial);
    }

    *reinterpret_cast<int4*>(mant + srow * dk + col0) = g.vec;   // in place
    expo[gid] = (uint8_t)(e + kExpBias);
    micro[gid] = (uint8_t)mic;
  }

  part[local] = partial;
  __syncthreads();
  if (local < rows_per_block) {
    const int r = blockIdx.y * rows_per_block + local;
    if (r < dv) {
      float s = 0.f;
      for (int j = 0; j < ngroups; ++j) s += part[local * ngroups + j];
      y[(size_t)bh * dv + r] = s;
    }
  }
}

}  // namespace

// State (mant, expo, micro) is updated in place.  d is (BH, dk) when
// d_per_channel, else (BH,); k, q are (BH, dk); v, y are (BH, dv); all f32,
// contiguous.  slab is NULL (dense state (BH, dv, dk)) or (BH / H,) int32
// slab ids into a (n_slabs, n_stack, H, dv, dk) pool at layer `group`.
// Returns cudaGetLastError() after the launch.
extern "C" int mx_state_update_launch(void* mant, void* expo, void* micro,
                                      const void* d, const void* k,
                                      const void* v, const void* q, void* y,
                                      const void* slab, int BH, int H,
                                      int n_stack, int group, int dv, int dk,
                                      int d_per_channel, unsigned int seed,
                                      int stochastic, void* stream) {
  if (BH <= 0 || H <= 0 || BH % H != 0 || dv <= 0 || dk <= 0 ||
      dk % kGroup != 0 || dk / kGroup > kThreads || n_stack <= 0 ||
      group < 0 || group >= n_stack)
    return (int)cudaErrorInvalidValue;
  const int ngroups = dk / kGroup;
  int rows_per_block = kThreads / ngroups;
  if (rows_per_block > dv) rows_per_block = dv;
  const dim3 grid(BH, (dv + rows_per_block - 1) / rows_per_block);
  const dim3 block(rows_per_block * ngroups);
  const size_t smem = (size_t)rows_per_block * ngroups * sizeof(float);
  mx_state_update_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (int8_t*)mant, (uint8_t*)expo, (uint8_t*)micro, (const float*)d,
      (const float*)k, (const float*)v, (const float*)q, (float*)y,
      (const int*)slab, H, n_stack, group, dv, dk, d_per_channel,
      (uint32_t)seed, stochastic, rows_per_block);
  return (int)cudaGetLastError();
}
