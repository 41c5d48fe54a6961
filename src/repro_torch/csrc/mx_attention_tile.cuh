// The decode-attention tile loop shared by the dense (mx_attention.cu) and
// the paged (mx_paged_attention.cu) kernels, for Hopper (sm_90a).
//
// One block per (batch row, kv head) walks the valid 128-position tiles of
// its row (tiles past the row's length are never read).  One thread per
// position dequantizes its K row and forms the G pre-scaled query heads'
// scores in fp32; the tile's V rows are dequantized into shared memory for
// the probability-weighted sum; the softmax is the streaming (flash) max /
// sum / rescale in fp32.  The two kernels differ only in where tile `t` of
// row `b` lives, which the `Rows` policy answers:
//
//   Rows::tile_base(b, t)  ->  row index (in units of one position of one
//                              kv head) of position t*128, kv head 0
//
// so the arithmetic, the tile order and the accumulators are one code, and
// the paged kernel is bitwise equal to the dense one over gathered pages.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxattn {

constexpr int kGroup = 16;
constexpr int kMBits = 6;
constexpr int kExpBias = 127;
constexpr int kTile = 128;        // positions per tile == threads per block
constexpr int kWarps = kTile / 32;
constexpr int kMaxG = 16;         // query heads per kv head
constexpr int kMaxAcc = 16;       // accumulator items per thread (G*dv <= 2048)
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

// Dynamic shared memory the tile loop needs (bytes).
inline size_t smem_bytes(int G, int dk, int dv) {
  return ((size_t)G * dk + (size_t)G * kTile + (size_t)kTile * dv) *
         sizeof(float);
}

// Host-side shape check shared by both launchers.
inline bool shape_ok(int G, int dk, int dv) {
  return G > 0 && G <= kMaxG && dk % kGroup == 0 && dv % kGroup == 0 &&
         G * dv <= kTile * kMaxAcc;
}

// q (B, KVH, G, dk) pre-scaled f32; K / V mantissas int8 and exponent /
// micro bytes addressed through `rows`; lengths (B,) int32 clipped to `cap`
// positions; out (B, KVH, G, dv) f32.  Launched with kTile threads and
// smem_bytes(G, dk, dv) of dynamic shared memory, grid (B, KVH).
template <class Rows>
__device__ __forceinline__ void attention_tiles(
    const Rows& rows, const float* __restrict__ q,
    const int8_t* __restrict__ km, const uint8_t* __restrict__ ke,
    const uint8_t* __restrict__ kmi, const int8_t* __restrict__ vm,
    const uint8_t* __restrict__ ve, const uint8_t* __restrict__ vmi,
    const int* __restrict__ lengths, float* __restrict__ out, int cap,
    int KVH, int G, int dk, int dv) {
  extern __shared__ float smem[];
  float* qs = smem;                  // G * dk   pre-scaled queries
  float* ps = qs + G * dk;           // G * kTile probabilities of this tile
  float* vs = ps + G * kTile;        // kTile * dv dequantized V rows
  __shared__ float red[kMaxG][kWarps];
  __shared__ float m_sh[kMaxG], l_sh[kMaxG], alpha_sh[kMaxG];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ngk = dk / kGroup, ngv = dv / kGroup;
  const size_t head = (size_t)b * KVH + h;

  for (int i = tid; i < G * dk; i += kTile) qs[i] = q[head * G * dk + i];
  if (tid < G) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int n_tiles = len > 0 ? (len + kTile - 1) / kTile : 1;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int pos = tile * kTile + tid;
    const size_t rowid = rows.tile_base(b, tile) + (size_t)tid * KVH + h;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    float vals[kGroup];
    for (int grp = 0; grp < ngk; ++grp) {
      dequant_group(km + rowid * dk + grp * kGroup, ke[rowid * ngk + grp],
                    kmi[rowid * ngk + grp], vals);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float* qg = qs + g * dk + grp * kGroup;
#pragma unroll
          for (int j = 0; j < kGroup; ++j) s[g] = fmaf(qg[j], vals[j], s[g]);
        }
      }
    }
    const bool valid = pos < len;
    for (int grp = 0; grp < ngv; ++grp)
      dequant_group(vm + rowid * dv + grp * kGroup, ve[rowid * ngv + grp],
                    vmi[rowid * ngv + grp], vs + tid * dv + grp * kGroup);

    // streaming softmax: tile max per query head
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        s[g] = valid ? s[g] : kNegInf;
        const float mx = warp_max(s[g]);
        if (lane == 0) red[g][warp] = mx;
      }
    }
    __syncthreads();
    if (tid < G) {
      float tmax = red[tid][0];
      for (int w = 1; w < kWarps; ++w) tmax = fmaxf(tmax, red[tid][w]);
      const float m_prev = m_sh[tid];
      const float m_new = fmaxf(m_prev, tmax);
      alpha_sh[tid] = expf(m_prev - m_new);
      m_sh[tid] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float p = expf(s[g] - m_sh[g]);
        ps[g * kTile + tid] = p;
        const float sum = warp_sum(p);
        if (lane == 0) red[g][warp] = sum;
      }
    }
    __syncthreads();
    if (tid < G) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[tid][w];
      l_sh[tid] = l_sh[tid] * alpha_sh[tid] + sum;
    }
    // acc = acc * alpha + P V over this tile
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int item = tid + i * kTile;
      if (item < G * dv) {
        const int g = item / dv, c = item - g * dv;
        float a = acc[i] * alpha_sh[g];
        const float* pg = ps + g * kTile;
        for (int t = 0; t < kTile; ++t) a = fmaf(pg[t], vs[t * dv + c], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int item = tid + i * kTile;
    if (item < G * dv) {
      const int g = item / dv;
      out[head * G * dv + item] = acc[i] / fmaxf(l_sh[g], 1e-30f);
    }
  }
}

}  // namespace mxattn
