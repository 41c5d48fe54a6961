// The MLA-mode tile loop shared by the dense (mx_attention.cu), the paged
// (mx_paged_attention.cu) and the speculative-verify (mx_spec_attention.cu)
// kernels, for Hopper (sm_90a).
//
// MLA (DeepSeek-V2's latent cache) keeps one MX8 stream per kv head: a
// latent row of dk = kv_lora + rope_dim lanes serves as the key at full
// width and as the value in its first dv = kv_lora lanes (the TPU kernels'
// qV=None / v_width mode).  At deepseek-v2-236b's widths (KVH = 1, 128
// query heads, dk 576, dv 512) each 648-byte latent row feeds 128 x
// (576 + 512) multiply-adds, ~430 flops per byte: unlike every GQA row this
// loop is bound by fp32 operations, not bytes.  The GQA loop cannot take it
// (R <= 16 query rows, a whole V tile in shared memory), so MLA has its own
// work split:
//
//   * a block of kThreads threads per (batch row, kv head, chunk of kRows
//     query rows); the query rows are query-major, r = j * G + g, n_q verify
//     positions of the G heads, and row r masks to len - (n_q - 1 - j);
//   * the block walks its row's positions in sub-tiles of kSub (half a
//     128-token page), dequantizes each latent row of the sub-tile ONCE into
//     shared memory and uses it for both products (scores against all dk
//     lanes, the probability-weighted sum over the first dv lanes);
//   * warp w owns query rows 2w, 2w+1 for the scores and the streaming
//     softmax (lane = position, lane + 32 = position + 32); thread t owns
//     output columns t and t + kThreads of all kRows rows for the sum.
//
// Every row's arithmetic is a fixed function of its own query, its own
// length and the latent rows: scores are one fmaf chain over d ascending,
// the sub-tile max and sum are the same warp butterflies, acc is
// acc * alpha then one fmaf chain over positions ascending.  None of it
// depends on which chunk or warp a row falls in, so row j of an n_q-position
// pass is bitwise the n_q = 1 launch at its shifted length (a sub-tile that
// is fully masked for a row is the identity on its (m, l, acc), as in the
// GQA loop), the verify kernels with n_q = 1 are bitwise the decode
// kernels, and the paged kernels are bitwise the dense ones over gathered
// pages (the Rows policy only says where a 128-position tile lives).
#pragma once

#include "mx_attention_tile.cuh"

namespace mxattn {
namespace mla {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kSub = 64;                       // positions per sub-tile
constexpr int kColsPerThread = 2;
constexpr int kMaxDv = kThreads * kColsPerThread;
constexpr int kMaxDk = 704;                    // shared memory bound
constexpr int kPad = 4;                        // latent row stride dk + 4

// Dynamic shared memory (bytes): dequantized latent sub-tile, the block's
// pre-scaled queries, the sub-tile's probabilities.
inline size_t smem_bytes(int dk) {
  return ((size_t)kSub * (dk + kPad) + (size_t)kRows * dk +
          (size_t)kRows * kSub) * sizeof(float);
}

// Host-side shape check shared by every MLA launcher: R = n_q * G rows.
inline bool shape_ok(int R, int dk, int dv) {
  return R > 0 && dk > 0 && dk % kGroup == 0 && dk <= kMaxDk && dv > 0 &&
         dv <= dk && dv <= kMaxDv;
}

__host__ __device__ inline int row_blocks(int R) {
  return (R + kRows - 1) / kRows;
}

// q (B, KVH, n_q * G, dk) pre-scaled f32, query-major rows; latent
// mantissas int8 and exponent / micro bytes addressed through `rows`;
// lengths (B,) int32 counting all n_q positions, clipped to `cap`;
// out (B, KVH, n_q * G, dv) f32.  Launched with kThreads threads,
// smem_bytes(dk) of dynamic shared memory, grid (B, KVH * row_blocks(R)).
template <class Rows>
__device__ __forceinline__ void mla_tiles(
    const Rows& rows, const float* __restrict__ q,
    const int8_t* __restrict__ km, const uint8_t* __restrict__ ke,
    const uint8_t* __restrict__ kmi, const int* __restrict__ lengths,
    float* __restrict__ out, int cap, int KVH, int G, int n_q, int dk,
    int dv) {
  extern __shared__ __align__(16) float mla_smem[];
  const int ldk = dk + kPad;
  float* ks = mla_smem;               // kSub x ldk dequantized latent rows
  float* qs = ks + kSub * ldk;        // kRows x dk pre-scaled queries
  float* ps = qs + kRows * dk;        // kRows x kSub probabilities
  __shared__ float alpha_sh[kRows], l_sh[kRows];

  const int R = n_q * G;
  const int nrb = row_blocks(R);
  const int b = blockIdx.x;
  const int h = blockIdx.y / nrb;
  const int r0 = (blockIdx.y - h * nrb) * kRows;   // first row of the block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ngk = dk / kGroup;
  const size_t head = (size_t)b * KVH + h;

  // queries; rows past R are zero (computed on, never written)
  const size_t qbase = (head * R + r0) * dk;
  for (int i = tid; i < kRows * dk; i += kThreads)
    qs[i] = r0 + i / dk < R ? q[qbase + i] : 0.f;

  const int len_all = lengths[b];
  int my_len[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int gr = r0 + warp * kRowsPerWarp + i;
    my_len[i] = gr < R ? clip_len(len_all - (n_q - 1 - gr / G), cap) : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int len = clip_len(len_all, cap);
  const int n_sub = len > 0 ? (len + kSub - 1) / kSub : 1;
  float acc[kRows][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;
  __syncthreads();

  for (int st = 0; st < n_sub; ++st) {
    // dequantize the sub-tile's latent rows once: consecutive threads take
    // consecutive rows of one 16-lane group (conflict-free float4 stores
    // at row stride dk + 4)
    const int tile = st / (kTile / kSub);
    const int first = (st % (kTile / kSub)) * kSub;
    const size_t base = rows.tile_base(b, tile);
    for (int w = tid; w < kSub * ngk; w += kThreads) {
      const int i = w % kSub, grp = w / kSub;
      const size_t rowid = base + (size_t)(first + i) * KVH + h;
      float v[kGroup];
      dequant_group(km + rowid * dk + grp * kGroup, ke[rowid * ngk + grp],
                    kmi[rowid * ngk + grp], v);
      float4* dst = reinterpret_cast<float4*>(ks + i * ldk + grp * kGroup);
#pragma unroll
      for (int u = 0; u < kGroup / 4; ++u)
        dst[u] = make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2],
                             v[4 * u + 3]);
    }
    __syncthreads();

    // scores: warp rows x positions (lane, lane + 32), fmaf over d
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    {
      const float* qw = qs + warp * kRowsPerWarp * dk;
      const float* k0 = ks + lane * ldk;
      const float* k1 = ks + (lane + 32) * ldk;
      for (int d = 0; d < dk; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(k0 + d);
        const float4 y = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(qw + i * dk + d);
          s[i][0] = fmaf(a.x, x.x, s[i][0]);
          s[i][0] = fmaf(a.y, x.y, s[i][0]);
          s[i][0] = fmaf(a.z, x.z, s[i][0]);
          s[i][0] = fmaf(a.w, x.w, s[i][0]);
          s[i][1] = fmaf(a.x, y.x, s[i][1]);
          s[i][1] = fmaf(a.y, y.y, s[i][1]);
          s[i][1] = fmaf(a.z, y.z, s[i][1]);
          s[i][1] = fmaf(a.w, y.w, s[i][1]);
        }
      }
    }

    // streaming softmax of the warp's rows over this sub-tile
    const int p0 = st * kSub + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const float a0 = p0 < my_len[i] ? s[i][0] : kNegInf;
      const float a1 = p0 + 32 < my_len[i] ? s[i][1] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(a0, a1)));
      const float alpha = expf(m[i] - m_new);
      const float e0 = expf(a0 - m_new), e1 = expf(a1 - m_new);
      l[i] = l[i] * alpha + warp_sum(e0 + e1);
      m[i] = m_new;
      ps[r * kSub + lane] = e0;
      ps[r * kSub + lane + 32] = e1;
      if (lane == 0) alpha_sh[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V over the sub-tile; V = the first dv lanes
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float alpha = alpha_sh[r];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[r][j] *= alpha;
    }
    for (int t = 0; t < kSub; t += 4) {
      float v[kColsPerThread][4];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = tid + j * kThreads;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[j][u] = col < dv ? ks[(t + u) * ldk + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(ps + r * kSub + t);
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          acc[r][j] = fmaf(p.x, v[j][0], acc[r][j]);
          acc[r][j] = fmaf(p.y, v[j][1], acc[r][j]);
          acc[r][j] = fmaf(p.z, v[j][2], acc[r][j]);
          acc[r][j] = fmaf(p.w, v[j][3], acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      l_sh[warp * kRowsPerWarp + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r < R) {
      const float denom = fmaxf(l_sh[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = tid + j * kThreads;
        if (col < dv)
          out[(head * R + r0 + r) * dv + col] = acc[r][j] / denom;
      }
    }
  }
}

// Host-side launch preparation shared by the MLA launchers: the shape
// check and the dynamic shared memory opt-in.
template <class Kernel>
int prepare(Kernel kernel, int R, int dk, int dv, size_t* smem) {
  if (!shape_ok(R, dk, dv)) return (int)cudaErrorInvalidValue;
  *smem = smem_bytes(dk);
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return (int)cudaSuccess;
}

}  // namespace mla
}  // namespace mxattn
