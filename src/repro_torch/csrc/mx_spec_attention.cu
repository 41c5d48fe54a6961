// Speculative-verify MX8 attention, dense and paged, GQA and MLA modes,
// for Hopper (sm_90a).
//
// mx_spec_attention_decode replaces the TPU kernel
// repro/kernels/mx_spec_attention.py::mx_spec_attention_decode
// (_spec_kernel); mx_paged_spec_attention_decode replaces
// mx_paged_spec_attention_decode (_paged_spec_kernel) of the same file.
//
// A verify pass scores n_q = spec_k + 1 query positions against a cache
// that already holds their n_q appended rows; position j sees
// pos < len - (n_q - 1 - j).  What bounds it on an H100: bytes, as for the
// single-query kernels -- and the point of the design is that the bytes do
// not grow with n_q.  The n_q positions of the G query heads that share a
// kv head are folded into the query rows of one block (row r = j * G + g,
// query-major, as the TPU kernel's _fold_queries does), so each block
// streams its row's valid K / V tiles once for all n_q positions: one
// memory-bound cache read amortised over the drafted tokens.  The loop is
// mx_attention_split.cuh's, the one the decode kernels run with n_q = 1:
// grid (B, KVH, 128-position splits), K / V staged with cp.async, the
// splits combined in order in the same launch.  Every row carries its own
// length, and the sub-tiles and splits past a row's length are the
// identity on its accumulators, so row j is bitwise the decode kernel at
// length len - (n_q - 1 - j), and the paged kernel is bitwise the dense one
// over the gathered pages.
//
// Rows: the n_q * G query rows of a kv head go to row blocks of at most 16
// rows and 2048 accumulator items (mx_attention_split.cuh's block_rows:
// whole verify positions where they fit), one block per row block and
// split; the launchers refuse only what a block cannot hold (dv > 2048, or
// a row block's shared memory past 226 KB).
//
// MLA mode (the *_mla_launch entry points; the TPU kernels' qV / v_pool
// None, v_width): the n_q positions fold into the query rows of
// mx_mla_tile.cuh's split loop the same way (R = n_q * G, e.g. 4 x 128 =
// 512 rows in 32 row blocks of 16 at deepseek-v2-236b's widths; one block
// per row block and 64-position split, both products on the tensor
// cores).  Row j is bitwise the MLA decode kernel at the shifted length;
// the paged kernel bitwise the dense one over gathered pages.
//
// Layouts: GQA q (B, n_q, KVH * G, dk) f32, scaled and folded into
// query-major rows in the kernel, out (B, n_q, KVH * G, dv) f32; MLA q
// (B, KVH, n_q * G, dk) pre-scaled f32, query-major rows, out
// (B, KVH, n_q * G, dv) f32; dense K / V mantissas (B, T, KVH, d) int8 with
// exponent / micro bytes (B, T, KVH, d/16); paged pools
// (P, n_stack, 128, KVH, d) walked through bt (B, npg) int32 at layer
// `group`; lengths (B,) int32 counting the n_q appended rows.  Every
// launch also takes its loop's workspace and counters.
#include "mx_attention_split.cuh"
#include "mx_mla_tile.cuh"

namespace {

using namespace mxattn;

template <int MAXR>
__global__ void __launch_bounds__(split::kThreads, split::kMinBlocks)
mx_spec_attention_decode_kernel(const float* __restrict__ q,
                                const int8_t* __restrict__ km,
                                const uint8_t* __restrict__ ke,
                                const uint8_t* __restrict__ kmi,
                                const int8_t* __restrict__ vm,
                                const uint8_t* __restrict__ ve,
                                const uint8_t* __restrict__ vmi,
                                const int* __restrict__ lengths,
                                float* __restrict__ out,
                                float* __restrict__ ws,
                                int* __restrict__ counters, int T, int KVH,
                                int G, int n_q, int dk, int dv, float scale) {
  split::split_attention<MAXR>(DenseRows{T, KVH}, q,
                         split::Stream{km, ke, kmi, vm, ve, vmi}, lengths,
                         out, ws, counters, T, KVH, G, n_q, dk, dv, scale);
}

template <int MAXR>
__global__ void __launch_bounds__(split::kThreads, split::kMinBlocks)
mx_paged_spec_attention_decode_kernel(const float* __restrict__ q,
                                      const int8_t* __restrict__ km,
                                      const uint8_t* __restrict__ ke,
                                      const uint8_t* __restrict__ kmi,
                                      const int8_t* __restrict__ vm,
                                      const uint8_t* __restrict__ ve,
                                      const uint8_t* __restrict__ vmi,
                                      const int* __restrict__ bt,
                                      const int* __restrict__ lengths,
                                      float* __restrict__ out,
                                      float* __restrict__ ws,
                                      int* __restrict__ counters, int npg,
                                      int n_stack, int group, int KVH, int G,
                                      int n_q, int dk, int dv, float scale) {
  split::split_attention<MAXR>(PagedRows{bt, npg, n_stack, group, KVH}, q,
                               split::Stream{km, ke, kmi, vm, ve, vmi},
                               lengths, out, ws, counters, npg * kTile, KVH,
                               G, n_q, dk, dv, scale);
}

__global__ void __launch_bounds__(mla::kThreads, mla::kMinBlocks)
mx_spec_attention_decode_mla_kernel(const float* __restrict__ q,
                                    const int8_t* __restrict__ km,
                                    const uint8_t* __restrict__ ke,
                                    const uint8_t* __restrict__ kmi,
                                    const int* __restrict__ lengths,
                                    float* __restrict__ out,
                                    float* __restrict__ ws,
                                    int* __restrict__ counters, int T,
                                    int KVH, int G, int n_q, int dk, int dv) {
  mla::mla_split(DenseRows{T, KVH}, q, km, ke, kmi, lengths, out, ws,
                 counters, T, KVH, G, n_q, dk, dv);
}

__global__ void __launch_bounds__(mla::kThreads, mla::kMinBlocks)
mx_paged_spec_attention_decode_mla_kernel(const float* __restrict__ q,
                                          const int8_t* __restrict__ km,
                                          const uint8_t* __restrict__ ke,
                                          const uint8_t* __restrict__ kmi,
                                          const int* __restrict__ bt,
                                          const int* __restrict__ lengths,
                                          float* __restrict__ out,
                                          float* __restrict__ ws,
                                          int* __restrict__ counters, int npg,
                                          int n_stack, int group, int KVH,
                                          int G, int n_q, int dk, int dv) {
  mla::mla_split(PagedRows{bt, npg, n_stack, group, KVH}, q, km, ke, kmi,
                 lengths, out, ws, counters, npg * kTile, KVH, G, n_q, dk,
                 dv);
}

}  // namespace

// Both return cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a shape the kernel does not take).  T must be a multiple of 128.
extern "C" int mx_spec_attention_decode_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* vm, const void* ve, const void* vmi, const void* lengths,
    void* out, void* ws, void* counters, int B, int T, int KVH, int G,
    int n_q, int dk, int dv, float scale, long long ws_floats, int n_counters,
    void* stream) {
  if (T <= 0 || T % kTile != 0 || G <= 0 || n_q <= 0)
    return (int)cudaErrorInvalidValue;
  const int S = T / split::kSplit, R = n_q * G;
  return split::with_row_bound(split::block_rows(R, G, dv), [&](auto bound) {
    constexpr int M = decltype(bound)::value;
    size_t smem = 0;
    dim3 grid;
    const int err = split::prepare(mx_spec_attention_decode_kernel<M>, B,
                                   KVH, S, R, G, dk, dv, ws_floats,
                                   n_counters, &smem, &grid);
    if (err != (int)cudaSuccess) return err;
    mx_spec_attention_decode_kernel<M><<<grid, split::kThreads, smem,
                                         (cudaStream_t)stream>>>(
        (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
        (const uint8_t*)kmi, (const int8_t*)vm, (const uint8_t*)ve,
        (const uint8_t*)vmi, (const int*)lengths, (float*)out, (float*)ws,
        (int*)counters, T, KVH, G, n_q, dk, dv, scale);
    return (int)cudaGetLastError();
  });
}

extern "C" int mx_paged_spec_attention_decode_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* vm, const void* ve, const void* vmi, const void* bt,
    const void* lengths, void* out, void* ws, void* counters, int B, int npg,
    int n_stack, int group, int KVH, int G, int n_q, int dk, int dv,
    float scale, long long ws_floats, int n_counters, void* stream) {
  if (npg <= 0 || n_stack <= 0 || group < 0 || group >= n_stack || G <= 0 ||
      n_q <= 0)
    return (int)cudaErrorInvalidValue;
  const int R = n_q * G;
  return split::with_row_bound(split::block_rows(R, G, dv), [&](auto bound) {
    constexpr int M = decltype(bound)::value;
    size_t smem = 0;
    dim3 grid;
    const int err = split::prepare(mx_paged_spec_attention_decode_kernel<M>,
                                   B, KVH, npg, R, G, dk, dv, ws_floats,
                                   n_counters, &smem, &grid);
    if (err != (int)cudaSuccess) return err;
    mx_paged_spec_attention_decode_kernel<M><<<grid, split::kThreads, smem,
                                               (cudaStream_t)stream>>>(
        (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
        (const uint8_t*)kmi, (const int8_t*)vm, (const uint8_t*)ve,
        (const uint8_t*)vmi, (const int*)bt, (const int*)lengths,
        (float*)out, (float*)ws, (int*)counters, npg, n_stack, group, KVH, G,
        n_q, dk, dv, scale);
    return (int)cudaGetLastError();
  });
}

// MLA mode over the latent stream (km / ke / kmi); same return convention.
extern "C" int mx_spec_attention_decode_mla_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* lengths, void* out, void* ws, void* counters, int B, int T,
    int KVH, int G, int n_q, int dk, int dv, long long ws_floats,
    int n_counters, void* stream) {
  if (T <= 0 || T % kTile != 0 || G <= 0 || n_q <= 0)
    return (int)cudaErrorInvalidValue;
  const int S = T / mla::kSplit;
  size_t smem = 0;
  const int err = mla::prepare(mx_spec_attention_decode_mla_kernel, B, KVH,
                               S, n_q * G, dk, dv, ws_floats, n_counters,
                               &smem);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(B, KVH * mla::row_blocks(n_q * G), S);
  mx_spec_attention_decode_mla_kernel<<<grid, mla::kThreads, smem,
                                      (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
      (const uint8_t*)kmi, (const int*)lengths, (float*)out, (float*)ws,
      (int*)counters, T, KVH, G, n_q, dk, dv);
  return (int)cudaGetLastError();
}

extern "C" int mx_paged_spec_attention_decode_mla_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* bt, const void* lengths, void* out, void* ws, void* counters,
    int B, int npg, int n_stack, int group, int KVH, int G, int n_q, int dk,
    int dv, long long ws_floats, int n_counters, void* stream) {
  if (npg <= 0 || n_stack <= 0 || group < 0 || group >= n_stack || G <= 0 ||
      n_q <= 0)
    return (int)cudaErrorInvalidValue;
  const int S = npg * (kTile / mla::kSplit);
  size_t smem = 0;
  const int err = mla::prepare(mx_paged_spec_attention_decode_mla_kernel, B,
                               KVH, S, n_q * G, dk, dv, ws_floats,
                               n_counters, &smem);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(B, KVH * mla::row_blocks(n_q * G), S);
  mx_paged_spec_attention_decode_mla_kernel<<<grid, mla::kThreads, smem,
                                            (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
      (const uint8_t*)kmi, (const int*)bt, (const int*)lengths, (float*)out,
      (float*)ws, (int*)counters, npg, n_stack, group, KVH, G, n_q, dk, dv);
  return (int)cudaGetLastError();
}
