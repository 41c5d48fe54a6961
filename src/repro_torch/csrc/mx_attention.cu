// Single-query decode attention over a dense MX8 KV cache, GQA and MLA
// modes, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mx_attention.py::mx_attention_decode
// (_attn_kernel).  What bounds it on an H100: bytes.  One decode query per
// head reads every cached K and V value once (9 stored bits each) and does
// about four flops per value and query head, far below the fp32 ridge.
// The design streams the cache once, split across blocks along the time
// axis: grid (B, KVH, T / 128), one block per valid 128-position split,
// K / V staged through shared memory with cp.async, the splits combined in
// order by the last block of each (row, kv head) -- the loop in
// mx_attention_split.cuh, shared with the paged and the speculative-verify
// kernels (this one is its single-query instance).
//
// MLA mode (mx_attention_decode_mla_launch; the TPU kernel's qV=None,
// v_width) reads one latent stream whose first dv lanes are the values.
// It is bound by arithmetic (~430 flops per cached byte at
// deepseek-v2-236b's widths) and runs mx_mla_tile.cuh's loop: grid
// (B, KVH * 16-row blocks, T / 64), one block per 64-position split and 16
// query rows, both products on the tensor cores, the splits combined in
// order in the same launch.
//
// Layouts as in the JAX package: q (B, KVH * G, dk) f32 (GQA: scaled in the
// kernel by `scale`; MLA: pre-scaled); K and V mantissas (B, T, KVH, d) int8
// with exponent / micro bytes (B, T, KVH, d/16); lengths (B,) int32; out
// (B, KVH * G, dv) f32.  Both launches also take their loop's workspace
// (ws, ws_floats) and counters (zero, and left zero).
#include "mx_attention_split.cuh"
#include "mx_mla_tile.cuh"

namespace {

using namespace mxattn;

template <int MAXR>
__global__ void __launch_bounds__(split::kThreads, split::kMinBlocks)
mx_attention_decode_kernel(const float* __restrict__ q,
                           const int8_t* __restrict__ km,
                           const uint8_t* __restrict__ ke,
                           const uint8_t* __restrict__ kmi,
                           const int8_t* __restrict__ vm,
                           const uint8_t* __restrict__ ve,
                           const uint8_t* __restrict__ vmi,
                           const int* __restrict__ lengths,
                           float* __restrict__ out, float* __restrict__ ws,
                           int* __restrict__ counters, int T, int KVH, int G,
                           int dk, int dv, float scale) {
  split::split_attention<MAXR>(DenseRows{T, KVH}, q,
                         split::Stream{km, ke, kmi, vm, ve, vmi}, lengths,
                         out, ws, counters, T, KVH, G, /*n_q=*/1, dk, dv,
                         scale);
}

__global__ void __launch_bounds__(mla::kThreads, mla::kMinBlocks)
mx_attention_decode_mla_kernel(const float* __restrict__ q,
                               const int8_t* __restrict__ km,
                               const uint8_t* __restrict__ ke,
                               const uint8_t* __restrict__ kmi,
                               const int* __restrict__ lengths,
                               float* __restrict__ out, float* __restrict__ ws,
                               int* __restrict__ counters, int T, int KVH,
                               int G, int dk, int dv) {
  mla::mla_split(DenseRows{T, KVH}, q, km, ke, kmi, lengths, out, ws,
                 counters, T, KVH, G, /*n_q=*/1, dk, dv);
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take).  T must be a multiple of 128.
extern "C" int mx_attention_decode_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* vm, const void* ve, const void* vmi, const void* lengths,
    void* out, void* ws, void* counters, int B, int T, int KVH, int G,
    int dk, int dv, float scale, long long ws_floats, int n_counters,
    void* stream) {
  if (T <= 0 || T % kTile != 0) return (int)cudaErrorInvalidValue;
  const int S = T / split::kSplit;
  return split::with_row_bound(split::block_rows(G, G, dv), [&](auto bound) {
    constexpr int M = decltype(bound)::value;
    size_t smem = 0;
    dim3 grid;
    const int err = split::prepare(mx_attention_decode_kernel<M>, B, KVH, S,
                                   G, G, dk, dv, ws_floats, n_counters, &smem,
                                   &grid);
    if (err != (int)cudaSuccess) return err;
    mx_attention_decode_kernel<M><<<grid, split::kThreads, smem,
                                    (cudaStream_t)stream>>>(
        (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
        (const uint8_t*)kmi, (const int8_t*)vm, (const uint8_t*)ve,
        (const uint8_t*)vmi, (const int*)lengths, (float*)out, (float*)ws,
        (int*)counters, T, KVH, G, dk, dv, scale);
    return (int)cudaGetLastError();
  });
}

// MLA mode: values are the first dv lanes of the latent stream (km / ke /
// kmi, (B, T, KVH, dk)); out (B, KVH, G, dv); ws / counters as sized by
// mla::workspace_floats / counters_needed.  Same return convention.
extern "C" int mx_attention_decode_mla_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* lengths, void* out, void* ws, void* counters, int B, int T,
    int KVH, int G, int dk, int dv, long long ws_floats, int n_counters,
    void* stream) {
  if (T <= 0 || T % kTile != 0) return (int)cudaErrorInvalidValue;
  const int S = T / mla::kSplit;
  size_t smem = 0;
  const int err = mla::prepare(mx_attention_decode_mla_kernel, B, KVH, S, G,
                               dk, dv, ws_floats, n_counters, &smem);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(B, KVH * mla::row_blocks(G), S);
  mx_attention_decode_mla_kernel<<<grid, mla::kThreads, smem,
                                 (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
      (const uint8_t*)kmi, (const int*)lengths, (float*)out, (float*)ws,
      (int*)counters, T, KVH, G, dk, dv);
  return (int)cudaGetLastError();
}
