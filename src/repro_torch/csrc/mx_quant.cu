// Standalone MX8 quantizer for Hopper (sm_90a): the host memory
// controller's Quantization Unit of paper §5.5 (REG_WRITE), which puts a
// prefilled recurrent state or K/V stream into MX8 storage.
//
// Replaces the TPU kernel repro/kernels/mx_quant.py::mx_quantize
// (_quant_kernel).  What bounds it on an H100: bytes.  Each value is read
// once as fp32 (4 B) and written once as MX8 (1 B of mantissa plus 2 B of
// exponent and micro per 16 values): 5.125 B per value against ~5 flops.
// The design touches each byte once: one thread owns one 16-value group
// (four float4 loads, one 16-byte mantissa store, one exponent byte and
// one micro byte), and a grid-stride loop walks the groups, so
// neighbouring threads read and write neighbouring addresses.
//
// x is (rows, cols) fp32, contiguous, cols % 16 == 0.  The group
// arithmetic is mx8_group.cuh's (shared with the state-update kernel).
// SR bits of element (row, col) are counter_hash_u32(row * cols + col,
// seed) in uint32 arithmetic -- the JAX kernel's flat index, which its row
// blocks and padding do not change.  For a contiguous (rows, cols) array
// that index is group * 16 + j, so the kernel needs only the group count.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx8_group.cuh"

namespace {

using mx8::kExpBias;
using mx8::kGroup;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks per SM, then grid-stride

__global__ void __launch_bounds__(kThreads)
mx_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ mant,
                uint8_t* __restrict__ expo, uint8_t* __restrict__ micro,
                long long n_groups, uint32_t seed, int stochastic) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       gid < n_groups; gid += stride) {
    const float4* src = reinterpret_cast<const float4*>(x) + gid * 4;
    float v[kGroup];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = src[i];
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
    float t[kGroup], scale[kGroup / 2];
    uint32_t packed[4];
    int e, mic;
    mx8::quantize_group(v, (uint32_t)(gid * kGroup), seed, stochastic, t,
                        packed, e, mic, scale);
    *reinterpret_cast<int4*>(mant + gid * kGroup) =
        make_int4((int)packed[0], (int)packed[1], (int)packed[2],
                  (int)packed[3]);
    expo[gid] = (uint8_t)(e + kExpBias);
    micro[gid] = (uint8_t)mic;
  }
}

}  // namespace

// x: n_groups * 16 fp32 values, 16-byte aligned; mant: as many int8, 16-byte
// aligned; expo, micro: n_groups bytes each.  Returns cudaGetLastError()
// after the launch.
extern "C" int mx_quant_launch(const void* x, void* mant, void* expo,
                               void* micro, long long n_groups,
                               unsigned int seed, int stochastic,
                               void* stream) {
  if (n_groups <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n_groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  mx_quant_kernel<<<(unsigned int)blocks, kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)mant, (uint8_t*)expo, (uint8_t*)micro,
      n_groups, (uint32_t)seed, stochastic);
  return (int)cudaGetLastError();
}
