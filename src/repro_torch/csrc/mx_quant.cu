// MX8 quantizers for Hopper (sm_90a): the host memory controller's
// Quantization Unit of paper §5.5 (REG_WRITE), which puts a prefilled
// recurrent state or K/V stream into MX8 storage, and the same unit on the
// slot pool's decode step, fused with the dense KV-cache append.
//
// Replaces the TPU kernel repro/kernels/mx_quant.py::mx_quantize
// (_quant_kernel).  What bounds it on an H100: bytes.  Each value is read
// once as fp32 (4 B) and written once as MX8 (1 B of mantissa plus 2 B of
// exponent and micro per 16 values): 5.125 B per value against ~5 flops.
//
// Two kernels, each taking all of a layer's streams (1 or 2: K and V, or
// one MLA latent) in one launch:
//
// * mx_quant_kernel (kernel 7): stream i is fp32 (outer, rows, C_i),
//   contiguous, C_i % 16 == 0, quantized into MX8 (outer, padded_rows, C_i)
//   with rows past `rows` read as 0.0 -- bitwise F.pad then quantize, so
//   the prefill's 128-token tile needs no padded copy.  Each warp owns
//   one tile of 32 consecutive output groups (2 KB of fp32) -- no
//   grid-stride loop: the launch has a warp for every tile.  It stages
//   them through shared memory with coalesced float4 loads (each load
//   instruction reads 512 contiguous bytes), then each lane quantizes one
//   group from shared memory and the warp stores 512 contiguous mantissa
//   bytes and 32 exponent and micro bytes.  Blocks are two warps, so a
//   1 MB stream (yi-9b's 512-token K) spreads over 256 blocks, every SM.
//   A float4's shared-memory slot is s ^ ((s >> 3) & 3): the lanes of a
//   quarter-warp then read 8 distinct 16-byte bank groups.  The stream
//   count is a template parameter, so a one-stream launch carries one
//   stream's arguments.  Timed on an H100 against one thread a group
//   loading its own 64 bytes, the staging was a little faster on large
//   one-stream launches and a little slower on the padded two-stream
//   prefill launch; a grid-stride loop, larger blocks and streaming loads
//   gained nothing.  Past a launch's fixed cost the kernel moves its bytes
//   at 91-95 % of the HBM rate (PERF.md, the kernel table).
// * mx_kv_append_quant_kernel: the slot pool's kv_append.  Stream i's new
//   rows (B, n, KVH * w_i) fp32 go, quantized, into the dense MX8 cache
//   (B, T, KVH * w_i) at token clamp(lengths[b], 0, T - n) + j, in place
//   -- core/attention_cache.py::_update_at's clamp (an idle slot's length
//   may run past T).  One thread per group: the launch is a few thousand
//   groups, bound by its latency.
//
// The group arithmetic is mx8_group.cuh's (shared with kernels 1 and 4).
// SR bits of a stream's element are counter_hash_u32(flat index, seed_i)
// in uint32 arithmetic over that stream's own flat index: the padded
// output's for kernel 7 (what quantizing the F.pad copy draws), the new
// rows' (B, n, KVH, w) for the append (what F.sr_bits(rows.shape, seed_i)
// draws).  For a group that index is group * 16 + j.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx8_group.cuh"

namespace {

using mx8::kExpBias;
using mx8::kGroup;
constexpr int kThreads = 64;                 // two warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                    // groups a warp owns
constexpr int kTileF4 = kTile * kGroup / 4;  // their float4s: 128
constexpr int kMaxStreams = 2;               // K and V; an MLA latent is one

// Stream i of a launch of N streams (N = 1 or 2, a template parameter so a
// one-stream launch carries one stream's arguments).
template <int N>
struct QuantArgs {
  const float* x[N];   // (outer, rows, C_i) fp32, 16-byte aligned
  int8_t* mant[N];     // (outer, padded_rows, C_i), 16-byte aligned
  uint8_t* expo[N];    // (outer, padded_rows, C_i / 16)
  uint8_t* micro[N];   // the same
  int groups[N];       // outer * padded_rows * C_i / 16
  int tiles[N];        // ceil(groups / 32)
  int row_groups[N];   // C_i / 16
  uint32_t seed[N];
};

// Element of a per-stream array: stream 1 where `second`, else stream 0
// (constant indices only, so the arguments stay in the parameter space).
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&v)[N], bool second) {
  return second ? v[N - 1] : v[0];
}

__device__ __forceinline__ int swizzle(int s) { return s ^ ((s >> 3) & 3); }

template <int N>
__global__ void __launch_bounds__(kThreads)
mx_quant_kernel(QuantArgs<N> a, int rows, int padded_rows, int stochastic) {
  __shared__ float4 stage[kWarps][kTileF4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = a.tiles[0] + (N > 1 ? a.tiles[N - 1] : 0);
  const int tile = blockIdx.x * kWarps + warp;     // one tile a warp
  if (tile >= n_tiles) return;
  const bool second = N > 1 && tile >= a.tiles[0];
  const float4* x = reinterpret_cast<const float4*>(pick(a.x, second));
  const int groups = pick(a.groups, second);
  const int rg = pick(a.row_groups, second);
  const int g0 = (second ? tile - a.tiles[0] : tile) * kTile;
  // float4 f = lane + 32 i of the tile is quarter f % 4 of group
  // ga + 8 i; its source group, where the stream is padded, walks from
  // ga's (outer o, row, column group c) by 8 groups a step
  const int ga = g0 + (lane >> 2);
  int o = 0, row = 0, c = 0;
  if (rows != padded_rows) {
    const int r = ga / rg;
    c = ga - r * rg;
    o = r / padded_rows;
    row = r - o * padded_rows;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = ga + 8 * i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < groups) {
      if (rows == padded_rows)
        v = x[(size_t)g * 4 + (lane & 3)];
      else if (row < rows)                     // else a padding row: 0.0
        v = x[(((size_t)o * rows + row) * rg + c) * 4 + (lane & 3)];
    }
    stage[warp][swizzle(lane + 32 * i)] = v;
    if (rows != padded_rows) {
      for (c += 8; c >= rg; c -= rg) {
        if (++row == padded_rows) {
          row = 0;
          ++o;
        }
      }
    }
  }
  __syncwarp();
  const int g = g0 + lane;
  if (g < groups) {
    float v[kGroup];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 f = stage[warp][swizzle(4 * lane + k)];
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
    float q[kGroup], scale[kGroup / 2];
    uint32_t packed[4];
    int e, mic;
    mx8::quantize_group(v, (uint32_t)g * kGroup, pick(a.seed, second),
                        stochastic, q, packed, e, mic, scale);
    *reinterpret_cast<int4*>(pick(a.mant, second) + (size_t)g * kGroup) =
        make_int4((int)packed[0], (int)packed[1], (int)packed[2],
                  (int)packed[3]);
    pick(a.expo, second)[g] = (uint8_t)(e + kExpBias);
    pick(a.micro, second)[g] = (uint8_t)mic;
  }
}

template <int N>
int launch_quant(const unsigned long long* xs,
                 const unsigned long long* outs, const int* row_groups,
                 const unsigned int* seeds, long long outer, long long rows,
                 long long padded_rows, int stochastic, void* stream) {
  QuantArgs<N> a = {};
  long long tiles = 0;
  for (int i = 0; i < N; ++i) {
    const long long groups = outer * padded_rows * row_groups[i];
    if (row_groups[i] <= 0 || groups >= (1LL << 31) || xs[i] % 16 ||
        outs[3 * i] % 16)
      return (int)cudaErrorInvalidValue;
    a.x[i] = (const float*)xs[i];
    a.mant[i] = (int8_t*)outs[3 * i];
    a.expo[i] = (uint8_t*)outs[3 * i + 1];
    a.micro[i] = (uint8_t*)outs[3 * i + 2];
    a.row_groups[i] = row_groups[i];
    a.groups[i] = (int)groups;
    a.tiles[i] = (int)((groups + kTile - 1) / kTile);
    a.seed[i] = seeds[i];
    tiles += a.tiles[i];
  }
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  mx_quant_kernel<N><<<(unsigned int)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(a, (int)rows,
                                               (int)padded_rows, stochastic);
  return (int)cudaGetLastError();
}

struct AppendArgs {
  const float* x[kMaxStreams];   // (B, n, KVH * w_i) fp32, 16-byte aligned
  int8_t* mant[kMaxStreams];     // (B, T, KVH * w_i), 16-byte aligned
  uint8_t* expo[kMaxStreams];    // (B, T, KVH * w_i / 16)
  uint8_t* micro[kMaxStreams];   // the same
  int row_groups[kMaxStreams];   // KVH * w_i / 16
  uint32_t seed[kMaxStreams];    // seed + i, mod 2^32
};

__global__ void __launch_bounds__(kThreads)
mx_kv_append_quant_kernel(AppendArgs a, int n_streams,
                          const int* __restrict__ lengths, int B, int n,
                          int T, int stochastic) {
  // groups are numbered stream after stream; g becomes the index within
  // the stream's (B, n, row_groups) groups
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int per0 = B * n * a.row_groups[0];
  const bool second = g >= per0;
  if (second) {
    g -= per0;
    if (n_streams < 2 || g >= B * n * a.row_groups[1]) return;
  }
  const int rg = second ? a.row_groups[1] : a.row_groups[0];
  const int r = g / rg, c = g - r * rg;            // r = b * n + j
  const int b = r / n, j = r - b * n;
  int start = lengths[b];                          // _update_at's clamp
  start = start < 0 ? 0 : (start > T - n ? T - n : start);

  const float4* src =
      reinterpret_cast<const float4*>(second ? a.x[1] : a.x[0]) +
      (size_t)g * 4;
  float v[kGroup];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 f = src[k];
    v[4 * k] = f.x;
    v[4 * k + 1] = f.y;
    v[4 * k + 2] = f.z;
    v[4 * k + 3] = f.w;
  }
  float q[kGroup], scale[kGroup / 2];
  uint32_t packed[4];
  int e, mic;
  mx8::quantize_group(v, (uint32_t)g * kGroup, second ? a.seed[1] : a.seed[0],
                      stochastic, q, packed, e, mic, scale);
  const size_t at = ((size_t)b * T + start + j) * rg + c;   // the group
  int8_t* mant = second ? a.mant[1] : a.mant[0];
  *reinterpret_cast<int4*>(mant + at * kGroup) =
      make_int4((int)packed[0], (int)packed[1], (int)packed[2],
                (int)packed[3]);
  (second ? a.expo[1] : a.expo[0])[at] = (uint8_t)(e + kExpBias);
  (second ? a.micro[1] : a.micro[0])[at] = (uint8_t)mic;
}

}  // namespace

// xs: n device pointers to the streams' fp32 values (outer, rows, C_i),
// 16-byte aligned; outs: 3n device pointers, (mantissa, exponent, micro)
// of each stream's MX8 output (outer, padded_rows, C_i), the mantissas
// 16-byte aligned; row_groups: the n values C_i / 16; seeds: the n SR
// seeds.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int mx_quant_streams_launch(
    const unsigned long long* xs, const unsigned long long* outs,
    const int* row_groups, const unsigned int* seeds, int n,
    long long outer, long long rows, long long padded_rows, int stochastic,
    void* stream) {
  if (n <= 0 || n > kMaxStreams || outer <= 0 || rows <= 0 ||
      padded_rows < rows)
    return (int)cudaErrorInvalidValue;
  return n == 1 ? launch_quant<1>(xs, outs, row_groups, seeds, outer, rows,
                                  padded_rows, stochastic, stream)
                : launch_quant<2>(xs, outs, row_groups, seeds, outer, rows,
                                  padded_rows, stochastic, stream);
}

// One stream of n_groups * 16 fp32 values (x 16-byte aligned; mant as many
// int8, 16-byte aligned; expo, micro n_groups bytes each): the launch above
// with one stream and no padding.  Same return convention.
extern "C" int mx_quant_launch(const void* x, void* mant, void* expo,
                               void* micro, long long n_groups,
                               unsigned int seed, int stochastic,
                               void* stream) {
  if (n_groups <= 0) return (int)cudaErrorInvalidValue;
  const unsigned long long xs[1] = {(unsigned long long)x};
  const unsigned long long outs[3] = {(unsigned long long)mant,
                                      (unsigned long long)expo,
                                      (unsigned long long)micro};
  const int one = 1;
  return mx_quant_streams_launch(xs, outs, &one, &seed, 1, 1, n_groups,
                                 n_groups, stochastic, stream);
}

// xs: n device pointers to the streams' new fp32 rows (B, n_tok, KVH * w_i),
// 16-byte aligned; caches: 3n device pointers, (mantissa, exponent, micro)
// of each stream's dense MX8 cache (B, T, KVH * w_i), the mantissas 16-byte
// aligned; row_groups: the n values KVH * w_i / 16; lengths: (B,) int32 on
// the device.  Stream i rounds with seed + i.  The caches are updated in
// place.  Same return convention.
extern "C" int mx_kv_append_quant_launch(
    const unsigned long long* xs, const unsigned long long* caches,
    const int* row_groups, int n, const void* lengths, int B, int n_tok,
    int T, unsigned int seed, int stochastic, void* stream) {
  if (n <= 0 || n > kMaxStreams || B <= 0 || n_tok <= 0 || T < n_tok)
    return (int)cudaErrorInvalidValue;
  AppendArgs a = {};
  long long total = 0;
  for (int i = 0; i < n; ++i) {
    if (row_groups[i] <= 0 || xs[i] % 16 || caches[3 * i] % 16)
      return (int)cudaErrorInvalidValue;
    a.x[i] = (const float*)xs[i];
    a.mant[i] = (int8_t*)caches[3 * i];
    a.expo[i] = (uint8_t*)caches[3 * i + 1];
    a.micro[i] = (uint8_t*)caches[3 * i + 2];
    a.row_groups[i] = row_groups[i];
    a.seed[i] = seed + (uint32_t)i;
    total += (long long)B * n_tok * row_groups[i];
  }
  if (total > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  mx_kv_append_quant_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, n, (const int*)lengths, B, n_tok, T, stochastic);
  return (int)cudaGetLastError();
}
