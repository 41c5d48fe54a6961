// The decode-attention tile loop shared by the dense (mx_attention.cu), the
// paged (mx_paged_attention.cu) and the speculative-verify
// (mx_spec_attention.cu) kernels, for Hopper (sm_90a).
//
// One block per (batch row, kv head) walks the 128-position tiles of its
// row's longest query (tiles past it are never read).  One thread per
// position dequantizes its K row and forms the R = n_q * G pre-scaled query
// rows' scores in fp32; the tile's V rows are dequantized into shared memory
// for the probability-weighted sum; the softmax is the streaming (flash)
// max / sum / rescale in fp32, one private (m, l, acc) lane per query row.
//
// Query rows are query-major, r = j * G + g: n_q verify positions of the G
// query heads that share one kv head.  Row r masks to its own length
// len - (n_q - 1 - j), so position j of a verify pass sees the cache exactly
// as the j-th sequential decode step did.  A tile that is fully masked for
// a row that already saw a valid position is the identity on its (m, l,
// acc): alpha = expf(0) = 1, p = expf(-1e30 - m) = 0 and fmaf(0, v, a) = a.
// So row j of an n_q-position pass is bitwise the n_q = 1 kernel at length
// len - (n_q - 1 - j), and the decode kernels are the n_q = 1 instance.
//
// The kernels differ only in where tile `t` of row `b` lives, which the
// `Rows` policy answers:
//
//   Rows::tile_base(b, t)  ->  row index (in units of one position of one
//                              kv head) of position t*128, kv head 0
//
// so the arithmetic, the tile order and the accumulators are one code, and
// the paged kernels are bitwise equal to the dense ones over gathered pages.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxattn {

constexpr int kGroup = 16;
constexpr int kMBits = 6;
constexpr int kExpBias = 127;
constexpr int kTile = 128;        // positions per tile == threads per block
constexpr int kWarps = kTile / 32;
constexpr int kMaxG = 16;         // query rows per block (n_q * G)
constexpr int kMaxAcc = 16;       // accumulator items per thread (R*dv <= 2048)
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

// Dynamic shared memory the tile loop needs (bytes), R query rows.
inline size_t smem_bytes(int R, int dk, int dv) {
  return ((size_t)R * dk + (size_t)R * kTile + (size_t)kTile * dv) *
         sizeof(float);
}

// Host-side shape check shared by every launcher: R = n_q * G query rows.
inline bool shape_ok(int R, int dk, int dv) {
  return R > 0 && R <= kMaxG && dk % kGroup == 0 && dv % kGroup == 0 &&
         R * dv <= kTile * kMaxAcc;
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

// q (B, KVH, n_q * G, dk) pre-scaled f32, query-major rows; K / V
// mantissas int8 and exponent / micro bytes addressed through `rows`;
// lengths (B,) int32 counting all n_q positions, each row's length clipped
// to `cap` positions; out (B, KVH, n_q * G, dv) f32.  Launched with kTile
// threads and smem_bytes(n_q * G, dk, dv) of dynamic shared memory, grid
// (B, KVH).
template <class Rows>
__device__ __forceinline__ void attention_tiles(
    const Rows& rows, const float* __restrict__ q,
    const int8_t* __restrict__ km, const uint8_t* __restrict__ ke,
    const uint8_t* __restrict__ kmi, const int8_t* __restrict__ vm,
    const uint8_t* __restrict__ ve, const uint8_t* __restrict__ vmi,
    const int* __restrict__ lengths, float* __restrict__ out, int cap,
    int KVH, int G, int n_q, int dk, int dv) {
  extern __shared__ float smem[];
  const int R = n_q * G;             // query rows of this block
  float* qs = smem;                  // R * dk   pre-scaled queries
  float* ps = qs + R * dk;           // R * kTile probabilities of this tile
  float* vs = ps + R * kTile;        // kTile * dv dequantized V rows
  __shared__ float red[kMaxG][kWarps];
  __shared__ float m_sh[kMaxG], l_sh[kMaxG], alpha_sh[kMaxG];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ngk = dk / kGroup, ngv = dv / kGroup;
  const size_t head = (size_t)b * KVH + h;

  for (int i = tid; i < R * dk; i += kTile) qs[i] = q[head * R * dk + i];
  if (tid < R) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }
  // row r = j * G + g masks to pos < len - (n_q - 1 - j); the last
  // position's row is the longest and sets the tiles the block walks
  const int len_all = lengths[b];
  int row_len[kMaxG];
#pragma unroll
  for (int r = 0; r < kMaxG; ++r)
    row_len[r] = clip_len(len_all - (n_q - 1 - r / G), cap);
  const int len = clip_len(len_all, cap);
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
        if (g < R) {
          const float* qg = qs + g * dk + grp * kGroup;
#pragma unroll
          for (int j = 0; j < kGroup; ++j) s[g] = fmaf(qg[j], vals[j], s[g]);
        }
      }
    }
    for (int grp = 0; grp < ngv; ++grp)
      dequant_group(vm + rowid * dv + grp * kGroup, ve[rowid * ngv + grp],
                    vmi[rowid * ngv + grp], vs + tid * dv + grp * kGroup);

    // streaming softmax: tile max per query head
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < R) {
        s[g] = pos < row_len[g] ? s[g] : kNegInf;
        const float mx = warp_max(s[g]);
        if (lane == 0) red[g][warp] = mx;
      }
    }
    __syncthreads();
    if (tid < R) {
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
      if (g < R) {
        const float p = expf(s[g] - m_sh[g]);
        ps[g * kTile + tid] = p;
        const float sum = warp_sum(p);
        if (lane == 0) red[g][warp] = sum;
      }
    }
    __syncthreads();
    if (tid < R) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[tid][w];
      l_sh[tid] = l_sh[tid] * alpha_sh[tid] + sum;
    }
    // acc = acc * alpha + P V over this tile
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int item = tid + i * kTile;
      if (item < R * dv) {
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
    if (item < R * dv) {
      const int g = item / dv;
      out[head * R * dv + item] = acc[i] / fmaxf(l_sh[g], 1e-30f);
    }
  }
}

}  // namespace mxattn
