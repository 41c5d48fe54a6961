// Single-query decode attention over a dense MX8 KV cache, GQA and MLA
// modes, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mx_attention.py::mx_attention_decode
// (_attn_kernel).  What bounds it on an H100: bytes.  One decode query per
// head reads every cached K and V value once (9 stored bits each) and does
// about four flops per value and query head, far below the fp32 ridge.
// The design streams the cache once: one block per (batch row, kv head)
// walks the valid 128-position tiles only -- the tile loop in
// mx_attention_tile.cuh, shared with the paged and the speculative-verify
// kernels (this one is its single-query instance).  Splitting the time
// axis across blocks (more blocks than B * KVH) is left to a later change.
//
// MLA mode (mx_attention_decode_mla_launch; the TPU kernel's qV=None,
// v_width) reads one latent stream whose first dv lanes are the values.
// It is bound by fp32 operations (~430 flops per cached byte at
// deepseek-v2-236b's widths) and runs mx_mla_tile.cuh's loop: a block per
// 16 query rows, each latent row dequantized once per block.
//
// Layouts as in the JAX package: q (B, KVH, G, dk) pre-scaled f32; K and V
// mantissas (B, T, KVH, d) int8 with exponent / micro bytes
// (B, T, KVH, d/16); lengths (B,) int32; out (B, KVH, G, dv) f32.
#include "mx_attention_tile.cuh"
#include "mx_mla_tile.cuh"

namespace {

using namespace mxattn;

__global__ void __launch_bounds__(kTile)
mx_attention_decode_kernel(const float* __restrict__ q,
                           const int8_t* __restrict__ km,
                           const uint8_t* __restrict__ ke,
                           const uint8_t* __restrict__ kmi,
                           const int8_t* __restrict__ vm,
                           const uint8_t* __restrict__ ve,
                           const uint8_t* __restrict__ vmi,
                           const int* __restrict__ lengths,
                           float* __restrict__ out,
                           int T, int KVH, int G, int dk, int dv) {
  attention_tiles(DenseRows{T, KVH}, q, km, ke, kmi, vm, ve, vmi, lengths,
                  out, T, KVH, G, /*n_q=*/1, dk, dv);
}

__global__ void __launch_bounds__(mla::kThreads)
mx_attention_decode_mla_kernel(const float* __restrict__ q,
                               const int8_t* __restrict__ km,
                               const uint8_t* __restrict__ ke,
                               const uint8_t* __restrict__ kmi,
                               const int* __restrict__ lengths,
                               float* __restrict__ out, int T, int KVH,
                               int G, int dk, int dv) {
  mla::mla_tiles(DenseRows{T, KVH}, q, km, ke, kmi, lengths, out, T, KVH, G,
                 /*n_q=*/1, dk, dv);
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take).  T must be a multiple of 128.
extern "C" int mx_attention_decode_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* vm, const void* ve, const void* vmi, const void* lengths,
    void* out, int B, int T, int KVH, int G, int dk, int dv, void* stream) {
  if (B <= 0 || KVH <= 0 || T <= 0 || T % kTile != 0 || !shape_ok(G, dk, dv))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, dk, dv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mx_attention_decode_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B, KVH);
  mx_attention_decode_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
      (const uint8_t*)kmi, (const int8_t*)vm, (const uint8_t*)ve,
      (const uint8_t*)vmi, (const int*)lengths, (float*)out, T, KVH, G, dk,
      dv);
  return (int)cudaGetLastError();
}

// MLA mode: values are the first dv lanes of the latent stream (km / ke /
// kmi, (B, T, KVH, dk)); out (B, KVH, G, dv).  Same return convention.
extern "C" int mx_attention_decode_mla_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* lengths, void* out, int B, int T, int KVH, int G, int dk,
    int dv, void* stream) {
  if (B <= 0 || KVH <= 0 || T <= 0 || T % kTile != 0)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int err =
      mla::prepare(mx_attention_decode_mla_kernel, G, dk, dv, &smem);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(B, KVH * mla::row_blocks(G));
  mx_attention_decode_mla_kernel<<<grid, mla::kThreads, smem,
                                   (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
      (const uint8_t*)kmi, (const int*)lengths, (float*)out, T, KVH, G, dk,
      dv);
  return (int)cudaGetLastError();
}
