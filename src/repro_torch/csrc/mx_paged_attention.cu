// Paged MX8 decode attention and the in-place paged KV append, for Hopper
// (sm_90a).
//
// mx_paged_attention_decode replaces the TPU kernel
// repro/kernels/mx_paged_attention.py::mx_paged_attention_decode
// (_paged_attn_kernel).  Bound by bytes, like the dense kernel: every valid
// cached K and V value is read once.  It is the dense kernel's split loop
// (mx_attention_split.cuh) with one change: split s of row b is page
// bt[b, s] of the shared pool at layer `group`, so each 128-token page
// streams straight out of the pool in place, one block per page, and no
// dense copy of the context exists.  Splits past ceil(len / 128) exit at
// once, so the block table's bucketed tail (scratch page 0) is never
// touched.  Same splits, order and accumulators as the dense kernel:
// bitwise equal to it over the gathered pages.
//
// mx_paged_kv_append replaces repro/kernels/mx_paged_attention.py::
// mx_paged_kv_append (_append_kernel).  It writes one token's already
// quantized payload rows into their page slot
// pool[bt[b, len // 128], group, len % 128] in place -- the PIM analogue of
// a single-column read-modify-write.  Bound by launch latency: it moves
// B * KVH * (dk + dv) * 9/8 bytes.  One launch covers every payload pool
// (K and V x mantissa / exponent / micro): grid (B, n_pools * KVH), one
// block copies one row's w bytes.
//
// mx_paged_kv_append_quant is the same kernel designed for this card, and
// the one the served paged decode and verify steps launch.  On the TPU the
// quantize in front of the copy is left to XLA to fuse; eager on the card
// it is ~72 small launches a stream (F.sr_bits + F.quantize), which a
// host-bound step pays for on the host.  Here one launch takes the new
// token's fp32 rows (B, KVH, w) of every stream (K and V, or an MLA
// latent) and writes their MX8 payload straight into the page slots.  One
// thread owns one 16-value group, across (stream x B x KVH x w / 16): four
// float4 loads, mx8_group.cuh's arithmetic (kernels 1 and 7's), one
// 16-byte mantissa store into the slot, one exponent byte, one micro byte.
// Stream i rounds with SR bits counter_hash_u32(((row_base + b) * KVH_tot
// + kvh_base + h) * w + j, seed + i), in uint32 arithmetic: what sr_bits
// over the whole batch's (B_tot, 1, KVH_tot, w) gives rows row_base .. (a
// data-parallel rank's rows; 0 for the whole batch) of its heads
// kvh_base .. (a tensor-parallel rank's kv heads; 0 and KVH for a whole
// layer), so the slots hold byte for byte what the eager quantize
// followed by the copy wrote.  Bound
// by launch latency too (B * KVH * (dk + dv) * (4 + 9/8) bytes).
//
// MLA mode (mx_paged_attention_decode_mla_launch; the TPU kernel's
// v_pool=None, v_width): the dense MLA kernel's split loop
// (mx_mla_tile.cuh) over the pool's latent pages -- split s of row b is
// half s % 2 of page bt[b, s / 2] -- bitwise the dense MLA kernel over the
// gathered pages.  A latent-only append is the append
// kernel with three pools (mantissa / exponent / micro of the one stream).
//
// Pools are (n_pages, n_stack, 128, KVH, w) with n_stack the layers that
// share the pattern position; q (B, KVH * G, dk) f32 (GQA: scaled in the
// kernel; MLA: pre-scaled); bt (B, npg) int32; lengths (B,) int32; out
// (B, KVH * G, dv) f32.  Both attention launches also take their loop's
// workspace and counters.
#include <cassert>

#include "mx8_group.cuh"
#include "mx_attention_split.cuh"
#include "mx_mla_tile.cuh"

namespace {

using namespace mxattn;

constexpr int kMaxPools = 8;
constexpr int kMaxStreams = 2;        // K and V; an MLA latent is one
constexpr int kQuantThreads = 128;

template <int MAXR>
__global__ void __launch_bounds__(split::kThreads, split::kMinBlocks)
mx_paged_attention_decode_kernel(const float* __restrict__ q,
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
                                 int dk, int dv, float scale) {
  split::split_attention<MAXR>(PagedRows{bt, npg, n_stack, group, KVH}, q,
                               split::Stream{km, ke, kmi, vm, ve, vmi},
                               lengths, out, ws, counters, npg * kTile, KVH,
                               G, /*n_q=*/1, dk, dv, scale);
}

__global__ void __launch_bounds__(mla::kThreads, mla::kMinBlocks)
mx_paged_attention_decode_mla_kernel(const float* __restrict__ q,
                                     const int8_t* __restrict__ km,
                                     const uint8_t* __restrict__ ke,
                                     const uint8_t* __restrict__ kmi,
                                     const int* __restrict__ bt,
                                     const int* __restrict__ lengths,
                                     float* __restrict__ out,
                                     float* __restrict__ ws,
                                     int* __restrict__ counters, int npg,
                                     int n_stack, int group, int KVH, int G,
                                     int dk, int dv) {
  mla::mla_split(PagedRows{bt, npg, n_stack, group, KVH}, q, km, ke, kmi,
                 lengths, out, ws, counters, npg * kTile, KVH, G, /*n_q=*/1,
                 dk, dv);
}

struct AppendArgs {
  int8_t* pool[kMaxPools];
  const int8_t* row[kMaxPools];
  int width[kMaxPools];
};

__global__ void mx_paged_kv_append_kernel(AppendArgs a,
                                          const int* __restrict__ bt,
                                          const int* __restrict__ lengths,
                                          int npg, int n_pages, int n_stack,
                                          int group, int KVH) {
  const int b = blockIdx.x;
  const int i = blockIdx.y / KVH, h = blockIdx.y % KVH;
  const int len = lengths[b];
  // A slot outside the block table has no page to land in (the engine's
  // headroom check guarantees one).  Fail loudly, as the plain version's
  // IndexError does: a device-side assert, which the next synchronizing
  // call reports, and never a write to a neighbour's page.
  const bool slot_in_table = len >= 0 && len / kTile < npg;
  assert(slot_in_table);
  if (!slot_in_table) return;
  const int page = bt[(size_t)b * npg + len / kTile];
  const bool page_in_pool = page >= 0 && page < n_pages;
  assert(page_in_pool);
  if (!page_in_pool) return;
  const int w = a.width[i];
  const size_t dst =
      ((((size_t)page * n_stack + group) * kTile + len % kTile) * KVH + h) *
      w;
  const size_t src = ((size_t)b * KVH + h) * w;
  for (int j = threadIdx.x; j < w; j += blockDim.x)
    a.pool[i][dst + j] = a.row[i][src + j];
}

struct AppendQuantArgs {
  const float* x[kMaxStreams];   // (B, KVH, w) fp32, 16-byte aligned
  int8_t* mant[kMaxStreams];     // (n_pages, n_stack, 128, KVH, w)
  uint8_t* expo[kMaxStreams];    // (n_pages, n_stack, 128, KVH, w / 16)
  uint8_t* micro[kMaxStreams];   // the same
  int groups[kMaxStreams];       // w / 16
  uint32_t seed[kMaxStreams];    // seed + i, mod 2^32
};

__global__ void __launch_bounds__(kQuantThreads)
mx_paged_kv_append_quant_kernel(AppendQuantArgs a, int n,
                                const int* __restrict__ bt,
                                const int* __restrict__ lengths, int B,
                                int npg, int n_pages, int n_stack, int group,
                                int KVH, uint32_t kvh_base,
                                uint32_t kvh_total, uint32_t row_base,
                                int stochastic) {
  // groups are numbered stream after stream; g becomes the index within
  // the stream's (B, KVH, w / 16) groups (constant indices only, so the
  // arguments stay in the parameter space)
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  const float* x = nullptr;
  int8_t* mant = nullptr;
  uint8_t *expo = nullptr, *mic = nullptr;
  int ng = 0;
  uint32_t seed = 0;
#pragma unroll
  for (int s = 0; s < kMaxStreams; ++s) {
    const int per = s < n ? B * KVH * a.groups[s] : 0;
    if (x == nullptr) {
      if (g < per) {
        x = a.x[s];
        mant = a.mant[s];
        expo = a.expo[s];
        mic = a.micro[s];
        ng = a.groups[s];
        seed = a.seed[s];
      } else {
        g -= per;
      }
    }
  }
  if (x == nullptr) return;
  const int row = g / ng, j = g - row * ng;        // row = b * KVH + h
  const int b = row / KVH, h = row - b * KVH;
  const int len = lengths[b];
  // the copy kernel's slot checks: fail loudly, never write a neighbour's
  // page
  const bool slot_in_table = len >= 0 && len / kTile < npg;
  assert(slot_in_table);
  if (!slot_in_table) return;
  const int page = bt[(size_t)b * npg + len / kTile];
  const bool page_in_pool = page >= 0 && page < n_pages;
  assert(page_in_pool);
  if (!page_in_pool) return;

  const float4* src = reinterpret_cast<const float4*>(x) + (size_t)g * 4;
  float v[kGroup];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 f = src[k];
    v[4 * k] = f.x;
    v[4 * k + 1] = f.y;
    v[4 * k + 2] = f.z;
    v[4 * k + 3] = f.w;
  }
  float t[kGroup], scale[kGroup / 2];
  uint32_t packed[4];
  int e, micro_bits;
  // the SR counter: the element's flat index in the whole batch's array
  // of the layer's kv heads
  const uint32_t flat0 =
      (((row_base + (uint32_t)b) * kvh_total + kvh_base + (uint32_t)h) *
           (uint32_t)ng +
       (uint32_t)j) * kGroup;
  mx8::quantize_group(v, flat0, seed, stochastic, t, packed, e, micro_bits,
                      scale);
  const size_t slot =
      (((size_t)page * n_stack + group) * kTile + len % kTile) * KVH + h;
  const size_t at = slot * ng + j;                 // the group's index
  *reinterpret_cast<int4*>(mant + at * kGroup) =
      make_int4((int)packed[0], (int)packed[1], (int)packed[2],
                (int)packed[3]);
  expo[at] = (uint8_t)(e + kExpBias);
  mic[at] = (uint8_t)micro_bits;
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int mx_paged_attention_decode_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* vm, const void* ve, const void* vmi, const void* bt,
    const void* lengths, void* out, void* ws, void* counters, int B, int npg,
    int n_stack, int group, int KVH, int G, int dk, int dv, float scale,
    long long ws_floats, int n_counters, void* stream) {
  if (npg <= 0 || n_stack <= 0 || group < 0 || group >= n_stack)
    return (int)cudaErrorInvalidValue;
  return split::with_row_bound(split::block_rows(G, G, dv), [&](auto bound) {
    constexpr int M = decltype(bound)::value;
    size_t smem = 0;
    dim3 grid;
    const int err = split::prepare(mx_paged_attention_decode_kernel<M>, B,
                                   KVH, npg, G, G, dk, dv, ws_floats,
                                   n_counters, &smem, &grid);
    if (err != (int)cudaSuccess) return err;
    mx_paged_attention_decode_kernel<M><<<grid, split::kThreads, smem,
                                          (cudaStream_t)stream>>>(
        (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
        (const uint8_t*)kmi, (const int8_t*)vm, (const uint8_t*)ve,
        (const uint8_t*)vmi, (const int*)bt, (const int*)lengths,
        (float*)out, (float*)ws, (int*)counters, npg, n_stack, group, KVH, G,
        dk, dv, scale);
    return (int)cudaGetLastError();
  });
}

// MLA mode over the latent pools (km / ke / kmi); same return convention.
extern "C" int mx_paged_attention_decode_mla_launch(
    const void* q, const void* km, const void* ke, const void* kmi,
    const void* bt, const void* lengths, void* out, void* ws, void* counters,
    int B, int npg, int n_stack, int group, int KVH, int G, int dk, int dv,
    long long ws_floats, int n_counters, void* stream) {
  if (npg <= 0 || n_stack <= 0 || group < 0 || group >= n_stack)
    return (int)cudaErrorInvalidValue;
  const int S = npg * (kTile / mla::kSplit);
  size_t smem = 0;
  const int err = mla::prepare(mx_paged_attention_decode_mla_kernel, B, KVH,
                               S, G, dk, dv, ws_floats, n_counters, &smem);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(B, KVH * mla::row_blocks(G), S);
  mx_paged_attention_decode_mla_kernel<<<grid, mla::kThreads, smem,
                                       (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)km, (const uint8_t*)ke,
      (const uint8_t*)kmi, (const int*)bt, (const int*)lengths, (float*)out,
      (float*)ws, (int*)counters, npg, n_stack, group, KVH, G, dk, dv);
  return (int)cudaGetLastError();
}

// pools / rows: n device pointers each (host arrays of 64-bit addresses);
// widths: the n payload row widths in bytes.  Pools are updated in place.
extern "C" int mx_paged_kv_append_launch(
    const unsigned long long* pools, const unsigned long long* rows,
    const int* widths, int n, const void* bt, const void* lengths, int B,
    int npg, int n_pages, int n_stack, int group, int KVH, void* stream) {
  if (n <= 0 || n > kMaxPools || B <= 0 || npg <= 0 || KVH <= 0 ||
      n_stack <= 0 || group < 0 || group >= n_stack)
    return (int)cudaErrorInvalidValue;
  AppendArgs a;
  for (int i = 0; i < kMaxPools; ++i) {
    a.pool[i] = i < n ? (int8_t*)pools[i] : nullptr;
    a.row[i] = i < n ? (const int8_t*)rows[i] : nullptr;
    a.width[i] = i < n ? widths[i] : 0;
    if (i < n && a.width[i] <= 0) return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(B, n * KVH);
  mx_paged_kv_append_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
      a, (const int*)bt, (const int*)lengths, npg, n_pages, n_stack, group,
      KVH);
  return (int)cudaGetLastError();
}

// xs: n device pointers to the streams' fp32 rows (B, KVH, w_i), 16-byte
// aligned; pools: 3n device pointers, (mantissa, exponent, micro) of each
// stream's MX8 page pool, the mantissas 16-byte aligned; widths: the n row
// widths w_i (multiples of 16).  Stream i rounds with seed + i, its SR
// counter over the layer's kvh_total kv heads, of which the rows hold
// kvh_base .. kvh_base + KVH - 1 (0 and KVH for a whole layer), and over
// the whole batch, of which the rows are rows row_base .. row_base + B - 1
// (0 for the whole batch).  Pools are updated in place.  Same return
// convention.
extern "C" int mx_paged_kv_append_quant_launch(
    const unsigned long long* xs, const unsigned long long* pools,
    const int* widths, int n, const void* bt, const void* lengths, int B,
    int npg, int n_pages, int n_stack, int group, int KVH, unsigned int seed,
    unsigned int kvh_base, unsigned int kvh_total, unsigned int row_base,
    int stochastic, void* stream) {
  if (n <= 0 || n > kMaxStreams || B <= 0 || npg <= 0 || KVH <= 0 ||
      n_pages <= 0 || n_stack <= 0 || group < 0 || group >= n_stack ||
      kvh_total < (unsigned int)KVH || kvh_base > kvh_total - KVH)
    return (int)cudaErrorInvalidValue;
  AppendQuantArgs a = {};
  long long total = 0;
  for (int i = 0; i < n; ++i) {
    if (widths[i] <= 0 || widths[i] % kGroup || xs[i] % 16 ||
        pools[3 * i] % 16)
      return (int)cudaErrorInvalidValue;
    a.x[i] = (const float*)xs[i];
    a.mant[i] = (int8_t*)pools[3 * i];
    a.expo[i] = (uint8_t*)pools[3 * i + 1];
    a.micro[i] = (uint8_t*)pools[3 * i + 2];
    a.groups[i] = widths[i] / kGroup;
    a.seed[i] = seed + (uint32_t)i;
    total += (long long)B * KVH * a.groups[i];
  }
  if (total > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((total + kQuantThreads - 1) / kQuantThreads);
  mx_paged_kv_append_quant_kernel<<<blocks, kQuantThreads, 0,
                                    (cudaStream_t)stream>>>(
      a, n, (const int*)bt, (const int*)lengths, B, npg, n_pages, n_stack,
      group, KVH, kvh_base, kvh_total, row_base, stochastic);
  return (int)cudaGetLastError();
}
