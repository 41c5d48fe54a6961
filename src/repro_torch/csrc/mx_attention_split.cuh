// The GQA decode-attention loop shared by the dense (mx_attention.cu), the
// paged (mx_paged_attention.cu) and the speculative-verify
// (mx_spec_attention.cu) kernels, for Hopper (sm_90a).
//
// What bounds it: bytes and latency.  A position of one kv head is 9 stored
// bits per K and V value, read once, against ~4 flops per value and query
// row.  At zamba2-2.7b's shapes (B = 4, KVH = 32, a few hundred positions a
// row) the whole cache is ~5 MB, so the time goes to how many loads are in
// flight and how long each block's chain of dependent steps is.  The design:
//
//   * The time axis is split across blocks: grid (B, KVH * row blocks, S),
//     block s owns the fixed positions [s * kSplit, (s + 1) * kSplit) --
//     one 128-token page, so a paged block reads one block-table entry.
//     Blocks past their row's longest length exit at once.  The split
//     depends on nothing but the position, never on the lengths, n_q, G, B
//     or the layout.
//   * The query rows of a kv head are split into row blocks of at most
//     kMaxRows rows and kMaxItems accumulator items (block_rows): all R =
//     n_q * G rows in one block where they fit (then the grid is (B, KVH,
//     S)), else as many whole verify positions as fit (yi-9b's Kq = 4
//     verify pass, G = 8, dv = 128: two blocks of 2 positions, 16 rows),
//     else, where one position's G rows do not fit, runs of as many rows
//     as fit.  Each row block streams the split's K / V itself.
//   * Each block stages its positions through shared memory with cp.async
//     in kSub-position sub-tiles, double-buffered: consecutive threads copy
//     consecutive 16-byte chunks of one position's K and V mantissas, then
//     the aligned 16-byte chunks that cover its exponent and micro bytes
//     (every copy a 16-byte cp.async.cg: L2 requests, not L1 lines, are
//     what a few hundred scattered rows cost).
//     Sub-tile i + 1 is in flight while sub-tile i computes.
//   * Eight warps a block, so that the few blocks a decode step has still
//     keep latency hidden.  Scores, per sub-tile: four threads per
//     position, each an fmaf chain over a quarter of the position's
//     16-value groups; the quarters add in a fixed order.  The sub-tile's V
//     is dequantized beside them, once, into bf16 (exact for MX8 values).
//     Softmax, once per split over both sub-tiles: warp w owns rows w and
//     w + 8 (lanes = positions).  P V: warp w sums its 16 positions, each
//     lane a 4-row x 4-column tile of 16 independent accumulators, and the
//     eight warps' partials add in a fixed tree order.  No chain is longer
//     than a quarter of a key row (rounded up to whole groups) or 16
//     positions.
//   * The splits combine in the same launch: each block writes its rows'
//     (m, l, acc) to a workspace, and the last block of (b, h, row block)
//     to finish -- an acquire-release atomic counter per (b, h, row block)
//     -- combines splits 0 .. n - 1 in that order and resets the counter
//     (so a CUDA graph can replay the launch).  A row that fits one split
//     skips the workspace.
//
// Query rows are query-major, r = j * G + g: n_q verify positions of the G
// query heads that share one kv head.  Row r masks to its own length
// len - (n_q - 1 - j).  A masked position has p = 0 exactly, so it adds
// 0 * v = 0 to every sum, and a split that is fully masked for a row gives
// it the partial (-1e30, 0, 0), the identity of the combine: the running
// state's weight is expf(0) = 1 and the partial's expf(-1e30 - M) = 0.
// Every row's arithmetic is a fixed function of its own query, its own
// length and the cache -- whatever its row block, its slot in the block or
// the block's row bound -- so row j of an n_q-position pass is bitwise the
// n_q = 1 launch at length len - (n_q - 1 - j), and the decode kernels are
// the n_q = 1 instance.
//
// No tensor cores: R = n_q * G = 4 query rows at zamba2 fill a quarter of
// an m16 MMA, TF32 cannot hold the rtol 2e-4 contract, and the loop is
// bound by bytes and latency.
#pragma once

#include <cuda/atomic>
#include <type_traits>

#include "mx_attention_tile.cuh"

namespace mxattn {
namespace split {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;     // per SM: the 320 blocks of a zamba2 step
                                  // in one wave on 132 SMs
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = kTile;     // positions per block: one page
constexpr int kSub = 64;          // positions per staged sub-tile
constexpr int kStages = 2;        // sub-tile buffers
constexpr int kMaxRows = 16;      // query rows per block
constexpr int kMaxItems = 2048;   // accumulator items per block (rows * dv)
// dynamic shared memory a block may opt into on sm_90 (227 KB), less 1 KB
// for the loop's static arrays
constexpr size_t kMaxSmem = 227 * 1024 - 1024;
constexpr int kMaxAcc = kMaxItems / kThreads;   // per thread
constexpr int kParts = kThreads / kSub;         // threads per position
constexpr int kPosPerWarp = kSplit / kWarps;     // P V positions a warp
static_assert(kParts == 4, "score quarters add as (q0 + q1) + (q2 + q3)");
static_assert(kWarps == 8, "the P V partials add as a fixed 8-leaf tree");
static_assert(kSplit == 2 * kSub && kSub == 64,
              "two sub-tiles; softmax lanes take p + 32u, u < 4");
static_assert(kPosPerWarp % 4 == 0, "P V steps 4 positions at a time");

// Query rows a block takes of the R = n_q * G query-major rows of one kv
// head: all of them where they fit kMaxRows rows and kMaxItems accumulator
// items; else as many whole verify positions (G rows each) as fit; else,
// where one position's rows do not fit, as many rows as fit.  Row block rb
// holds rows [rb * block_rows, min(R, (rb + 1) * block_rows)).
__host__ __device__ inline int block_rows(int R, int G, int dv) {
  const int items = dv > 0 ? kMaxItems / dv : 0;
  const int cap = items < kMaxRows ? items : kMaxRows;
  if (R <= cap || cap < 1) return R;
  return G <= cap ? cap / G * G : cap;
}

__host__ __device__ inline int row_blocks(int R, int G, int dv) {
  const int rb = block_rows(R, G, dv);
  return rb > 0 ? (R + rb - 1) / rb : 1;
}

// The row bound a launch is compiled for: the smallest of 1, 4, 16 that
// holds a block's rows, so that the unrolled row loops issue no dead rows.
// Each row's arithmetic is the same whatever the bound (the bitwise
// contracts between R = G and R = n_q * G rest on that).
inline int row_bound(int R) { return R <= 1 ? 1 : R <= 4 ? 4 : kMaxRows; }

// f(std::integral_constant<int, row_bound(R)>{}): a launcher's body, given
// the row bound of its kernel as a compile-time constant.
template <class F>
int with_row_bound(int R, F&& f) {
  switch (row_bound(R)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, kMaxRows>{});
  }
}

// Staged K mantissa row stride: an odd number of 16-byte chunks, so the
// 16-byte loads of eight consecutive positions hit distinct banks.
__host__ __device__ inline int k_stride(int dk) {
  return (dk / 16) % 2 ? dk : dk + 16;
}

// Dequantized V row stride, in bf16 values: 8 over dv (a multiple of 16),
// so the 16-byte stores of eight consecutive positions hit distinct banks.
__host__ __device__ inline int v_stride(int dv) { return dv + 8; }

// Byte offsets of the dynamic shared memory, R query rows.
struct Smem {
  size_t qs, sc, ps, vh, part, stage, stage_bytes, total;
};

__host__ __device__ inline Smem smem_layout(int R, int dk, int dv) {
  const size_t f = sizeof(float);
  const int wk = cover_chunks(dk / kGroup), wv = cover_chunks(dv / kGroup);
  Smem L;
  // the score quarters die at the softmax, before P V writes its warp
  // partials: the two share one region
  const size_t sc_part = (size_t)R * f *
                         (kParts * kSplit > kWarps * dv ? kParts * kSplit
                                                        : kWarps * dv);
  L.qs = 0;                                          // R x dk queries
  L.sc = L.qs + (size_t)R * dk * f;                  // kParts x R x kSplit
  L.part = L.sc;                                     // kWarps x R x dv
  L.ps = L.sc + sc_part;                             // R x kSplit
  L.vh = L.ps + (size_t)R * kSplit * f;              // kSplit x v_stride bf16
  L.stage = L.vh + (size_t)kSplit * v_stride(dv) * 2;
  L.stage_bytes =
      (size_t)kSub * (k_stride(dk) + dv) + (size_t)kSub * 32 * (wk + wv);
  L.total = L.stage + kStages * L.stage_bytes;
  return L;
}

// Host-side shape check shared by every launcher: R = n_q * G query rows
// of G heads a kv head.  What it refuses is what a block cannot hold: a
// value row wider than the accumulators (dv > kMaxItems) or a row block
// past the shared memory (kMaxSmem).
inline bool shape_ok(int R, int G, int dk, int dv) {
  return R > 0 && G > 0 && R % G == 0 && dk > 0 && dv > 0 &&
         dk % kGroup == 0 && dv % kGroup == 0 && dv <= kMaxItems &&
         smem_layout(block_rows(R, G, dv), dk, dv).total <= kMaxSmem;
}

// Workspace floats for grid (B, KVH * row blocks, S): (acc, then (m, l))
// per split and query row, the rows of all row blocks.
inline size_t workspace_floats(int B, int KVH, int S, int R, int dv) {
  return (size_t)B * KVH * S * R * ((size_t)dv + 2);
}

// Offset of the first of a row's w bytes inside its first covering chunk.
__device__ __forceinline__ int cover_shift(const uint8_t* a, size_t rowid,
                                           int w) {
  return (int)(reinterpret_cast<uintptr_t>(a + rowid * w) & 15u);
}

// The arrays of one kv head's cache and where each staged sub-tile lands.
struct Stream {
  const int8_t* km;
  const uint8_t* ke;
  const uint8_t* kmi;
  const int8_t* vm;
  const uint8_t* ve;
  const uint8_t* vmi;
};

struct Stage {
  int8_t* km;          // kSub x k_stride(dk) mantissas
  int8_t* vm;          // kSub x dv
  uint8_t* ke;         // kSub x 16 * wk covering chunks
  uint8_t* kmi;
  uint8_t* ve;         // kSub x 16 * wv
  uint8_t* vmi;
};

__device__ __forceinline__ Stage stage_at(unsigned char* base, int dk,
                                          int dv, int wk, int wv) {
  Stage st;
  st.km = reinterpret_cast<int8_t*>(base);
  st.vm = st.km + kSub * k_stride(dk);
  st.ke = reinterpret_cast<uint8_t*>(st.vm + kSub * dv);
  st.kmi = st.ke + kSub * 16 * wk;
  st.ve = st.kmi + kSub * 16 * wk;
  st.vmi = st.ve + kSub * 16 * wv;
  return st;
}

// Issue the cp.async copies of the kSub positions whose first row (kv head
// h) is `row0`; rows of consecutive positions are KVH apart.
__device__ __forceinline__ void stage_copy(const Stage& st, const Stream& g,
                                           size_t row0, int KVH, int dk,
                                           int dv, int wk, int wv, int tid) {
  const int ck = dk / 16, cpos = (dk + dv) / 16, ldk = k_stride(dk);
  for (int i = tid; i < kSub * cpos; i += kThreads) {
    const int p = i / cpos, c = i - p * cpos;
    const size_t row = row0 + (size_t)p * KVH;
    if (c < ck)
      cp_async16(st.km + p * ldk + c * 16, g.km + row * dk + c * 16);
    else
      cp_async16(st.vm + p * dv + (c - ck) * 16,
                 g.vm + row * dv + (c - ck) * 16);
  }
  const int ngk = dk / kGroup, ngv = dv / kGroup;
  for (int i = tid; i < kSub * 4; i += kThreads) {
    const int a = i / kSub, p = i - a * kSub;
    const size_t row = row0 + (size_t)p * KVH;
    const int w = a < 2 ? ngk : ngv, nw_max = a < 2 ? wk : wv;
    const uint8_t* src = a == 0 ? g.ke : a == 1 ? g.kmi : a == 2 ? g.ve : g.vmi;
    uint8_t* dst = (a == 0 ? st.ke : a == 1 ? st.kmi : a == 2 ? st.ve : st.vmi)
                   + p * 16 * nw_max;
    const uintptr_t first = reinterpret_cast<uintptr_t>(src + row * w);
    const uint8_t* chunk =
        reinterpret_cast<const uint8_t*>(first & ~uintptr_t(15));
    const int nw = (int)((first & 15u) + w + 15) / 16;
    for (int k = 0; k < nw; ++k) cp_async16(dst + 16 * k, chunk + 16 * k);
  }
}

// q (B, n_q, KVH * G, dk) f32, scaled here by `scale` (one fp32 multiply a
// value, once the rows land); block (b, h) takes rows r = j * G + g from
// q[b, j, h * G + g]; K / V mantissas int8 and exponent / micro bytes
// addressed through `rows`; lengths (B,) int32 counting all n_q positions,
// each row's length clipped to `cap` positions; out (B, n_q, KVH * G, dv)
// f32, row r of block (b, h) at out[b, j, h * G + g]; ws
// workspace_floats(B, KVH, S, R, dv) floats; counters (B * KVH * row
// blocks) int32, all zero, left zero.  Launched with kThreads threads,
// smem_layout(block_rows(R, G, dv), dk, dv).total bytes of dynamic shared
// memory, grid (B, KVH * row_blocks(R, G, dv), S = cap / 128); block
// (b, h * row_blocks + rb, s) takes row block rb of kv head h.
template <int MAXR, class Rows>
__device__ __forceinline__ void split_attention(
    const Rows& rows, const float* __restrict__ q, const Stream& g,
    const int* __restrict__ lengths, float* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, int cap, int KVH,
    int G, int n_q, int dk, int dv, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float m_sh[kMaxRows], l_sh[kMaxRows];
  __shared__ int last_sh;

  const int b = blockIdx.x, s = blockIdx.z, S = gridDim.z;
  const int R_all = n_q * G, RB = block_rows(R_all, G, dv);
  const int nrb = (R_all + RB - 1) / RB;
  const int h = blockIdx.y / nrb, rb = blockIdx.y - h * nrb;
  const int r0 = rb * RB;                   // the block's first query row
  // the split's first row (a paged block's one block-table entry) is read
  // beside the length, not after it: s < cap / 128 is inside the table
  const size_t row0 = rows.tile_base(b, s) + h;
  const int len_all = lengths[b];
  const int len = clip_len(len_all, cap);
  const int n_split = len > 0 ? (len + kSplit - 1) / kSplit : 1;
  if (s >= n_split) return;

  const int R = min(RB, R_all - r0);        // the block's rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ngk = dk / kGroup, ngv = dv / kGroup;
  const int wk = cover_chunks(ngk), wv = cover_chunks(ngv);
  const Smem L = smem_layout(R, dk, dv);
  float* qs = reinterpret_cast<float*>(smem_raw + L.qs);
  float* sc = reinterpret_cast<float*>(smem_raw + L.sc);
  float* ps = reinterpret_cast<float*>(smem_raw + L.ps);
  uint16_t* vh = reinterpret_cast<uint16_t*>(smem_raw + L.vh);
  float* part = reinterpret_cast<float*>(smem_raw + L.part);
  const int ldk = k_stride(dk), ldvh = v_stride(dv);
  auto stage = [&](int i) {
    return stage_at(smem_raw + L.stage + (i % kStages) * L.stage_bytes, dk,
                    dv, wk, wv);
  };

  // this split's positions and the sub-tiles that hold any of them
  const int pos0 = s * kSplit;
  const int n_sub = len > pos0 ? min(kSplit / kSub, (len - pos0 + kSub - 1) /
                                                        kSub)
                               : 1;
  // the block's row r is query row r0 + r = j * G + g of kv head h, at
  // q[b, j, h * G + g]; the rows travel with the first sub-tile (scaled
  // once they land)
  const size_t head = (size_t)b * KVH + h;
  auto qrow = [&](int r) {
    const int rr = r0 + r;
    return ((size_t)b * n_q + rr / G) * KVH * G + (size_t)h * G + rr % G;
  };
  for (int i = tid; i < R * dk / 4; i += kThreads) {
    const int r = i / (dk / 4), c = i - r * (dk / 4);
    cp_async16(qs + r * dk + 4 * c, q + qrow(r) * dk + 4 * c);
  }
  stage_copy(stage(0), g, row0, KVH, dk, dv, wk, wv, tid);
  cp_async_commit();
  // query row r0 + r = j * G + g masks to pos < len - (n_q - 1 - j); warp
  // w owns the softmax of the block's rows r = w + 8k
  constexpr int kRowsPerWarp = (MAXR + kWarps - 1) / kWarps;
  constexpr int kTileRows = MAXR < 4 ? MAXR : 4;    // rows of a P V tile
  const int RD = R * dv;
  int acc_row[kMaxAcc];          // the query row of each accumulator item
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc_row[i] = (tid + i * kThreads) / dv;

  for (int sub = 0; sub < n_sub; ++sub) {
    cp_async_wait<0>();
    __syncthreads();
    // sub-tile sub + 1 flies while this one computes; its buffer was last
    // read before this barrier
    if (sub + 1 < n_sub)
      stage_copy(stage(sub + 1), g, row0 + (size_t)(sub + 1) * kSub * KVH,
                 KVH, dk, dv, wk, wv, tid);
    cp_async_commit();
    if (sub == 0) {
      for (int i = tid; i < R * dk; i += kThreads)
        qs[i] = __fmul_rn(qs[i], scale);
      __syncthreads();
    }
    const Stage st = stage(sub);
    const int ps0 = sub * kSub;             // the sub-tile's first position
    const size_t srow0 = row0 + (size_t)ps0 * KVH;

    // scores: thread (p, part) dequantizes a quarter of position p's K
    // groups
    {
      const int p = tid % kSub, qt = tid / kSub;
      const int gq = (ngk + kParts - 1) / kParts;
      const int g0 = qt * gq, g1 = min(ngk, g0 + gq);
      const size_t row = srow0 + (size_t)p * KVH;
      const int ek = p * 16 * wk + cover_shift(g.ke, row, ngk);
      const int mk = p * 16 * wk + cover_shift(g.kmi, row, ngk);
      float sacc[MAXR];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) sacc[r] = 0.f;
      for (int grp = g0; grp < g1; ++grp) {
        float kv[kGroup];
        dequant_group(st.km + p * ldk + grp * kGroup, st.ke[ek + grp],
                      st.kmi[mk + grp], kv);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          if (r < R) {
            const float4* qr =
                reinterpret_cast<const float4*>(qs + r * dk + grp * kGroup);
#pragma unroll
            for (int u = 0; u < kGroup / 4; ++u) {
              const float4 a = qr[u];
              sacc[r] = fmaf(a.x, kv[4 * u], sacc[r]);
              sacc[r] = fmaf(a.y, kv[4 * u + 1], sacc[r]);
              sacc[r] = fmaf(a.z, kv[4 * u + 2], sacc[r]);
              sacc[r] = fmaf(a.w, kv[4 * u + 3], sacc[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < R) sc[(qt * R + r) * kSplit + ps0 + p] = sacc[r];
    }
    // values: dequantized once, kept as bf16, zero past the block's
    // length.  Exact: an MX8 value is an int8 times a power of two no
    // smaller than 2^-132 (micro is 0 at the exponent floor), and bf16
    // holds 8 significant bits down to its 2^-133 subnormal
    for (int i = tid; i < kSub * ngv; i += kThreads) {
      const int p = i % kSub, grp = i / kSub;
      float vv[kGroup];
      if (pos0 + ps0 + p < len) {
        const size_t row = srow0 + (size_t)p * KVH;
        dequant_group(st.vm + p * dv + grp * kGroup,
                      st.ve[p * 16 * wv + cover_shift(g.ve, row, ngv) + grp],
                      st.vmi[p * 16 * wv + cover_shift(g.vmi, row, ngv) + grp],
                      vv);
      } else {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) vv[j] = 0.f;
      }
      uint4* dst =
          reinterpret_cast<uint4*>(vh + (ps0 + p) * ldvh + grp * kGroup);
      dst[0] = make_uint4(bf16_pair(vv[0], vv[1]), bf16_pair(vv[2], vv[3]),
                          bf16_pair(vv[4], vv[5]), bf16_pair(vv[6], vv[7]));
      dst[1] = make_uint4(bf16_pair(vv[8], vv[9]), bf16_pair(vv[10], vv[11]),
                          bf16_pair(vv[12], vv[13]),
                          bf16_pair(vv[14], vv[15]));
    }
  }
  __syncthreads();

  // softmax over the split, once: warp w, rows w + 8k, lane = positions
  // lane + 32u; a masked position has p = 0 exactly
  auto score = [&](int r, int p) {
    return (sc[r * kSplit + p] + sc[(R + r) * kSplit + p]) +
           (sc[(2 * R + r) * kSplit + p] + sc[(3 * R + r) * kSplit + p]);
  };
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + k * kWarps;
    if (r < R) {
      const int rl = clip_len(len_all - (n_q - 1 - (r0 + r) / G), cap) - pos0;
      float sv[4];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = lane + 32 * u;
        sv[u] = p < rl ? score(r, p) : kNegInf;
        mx = fmaxf(mx, sv[u]);
      }
      const float m = warp_max(mx);
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = lane + 32 * u;
        e[u] = p < rl ? expf(sv[u] - m) : 0.f;
        ps[r * kSplit + p] = e[u];
      }
      const float l = warp_sum((e[0] + e[1]) + (e[2] + e[3]));
      if (lane == 0) {
        m_sh[r] = m;
        l_sh[r] = l;
      }
    }
  }
  __syncthreads();

  // P V: warp w sums the split's positions 16w .. 16w + 15 (zeros where no
  // sub-tile was loaded); a lane takes 4 columns of kTileRows rows at a
  // time, one fmaf chain over the positions per item
  {
    const int p0 = warp * kPosPerWarp;
    const bool loaded = p0 < n_sub * kSub;
    for (int cq = lane; cq < dv / 4; cq += 32) {
      for (int r0 = 0; r0 < R; r0 += kTileRows) {
        float a[kTileRows][4];
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) a[i][c] = 0.f;
        if (loaded) {
#pragma unroll
          for (int t = 0; t < kPosPerWarp; t += 4) {
            float4 pr[kTileRows];
#pragma unroll
            for (int i = 0; i < kTileRows; ++i)
              pr[i] = r0 + i < R ? *reinterpret_cast<const float4*>(
                                       ps + (r0 + i) * kSplit + p0 + t)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const uint2 hv = *reinterpret_cast<const uint2*>(
                  vh + (p0 + t + u) * ldvh + 4 * cq);
              const float v[4] = {bf16_lo(hv.x), bf16_hi(hv.x),
                                  bf16_lo(hv.y), bf16_hi(hv.y)};
#pragma unroll
              for (int i = 0; i < kTileRows; ++i) {
                const float pu = u == 0   ? pr[i].x
                                 : u == 1 ? pr[i].y
                                 : u == 2 ? pr[i].z
                                          : pr[i].w;
#pragma unroll
                for (int c = 0; c < 4; ++c) a[i][c] = fmaf(pu, v[c], a[i][c]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
          if (r0 + i < R)
            *reinterpret_cast<float4*>(part + warp * RD + (r0 + i) * dv +
                                       4 * cq) =
                make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
      }
    }
  }
  __syncthreads();
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int item = tid + i * kThreads;
    if (i * kThreads >= RD) break;
    if (item < RD) {
      const float* pw = part + item;
      acc[i] = ((pw[0] + pw[RD]) + (pw[2 * RD] + pw[3 * RD])) +
               ((pw[4 * RD] + pw[5 * RD]) + (pw[6 * RD] + pw[7 * RD]));
    }
  }

  if (n_split == 1) {   // the whole row in this block: no combine
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int item = tid + i * kThreads;
      if (i * kThreads >= RD) break;
      if (item < RD)
        out[qrow(acc_row[i]) * dv + item - acc_row[i] * dv] =
            acc[i] / fmaxf(l_sh[acc_row[i]], 1e-30f);
    }
    return;
  }

  // this split's partial: query row r0 + r's acc at ws[((head * S + s) *
  // R_all + r0 + r) * dv + c], (m, l) after all B * KVH * S * R_all * dv
  // accumulators
  const size_t RDa = (size_t)R_all * dv;
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)gridDim.x * KVH * S * RDa;
  const size_t split_row = (head * S + s) * R_all + r0;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int item = tid + i * kThreads;
    if (i * kThreads >= RD) break;
    if (item < RD) ws_acc[split_row * dv + item] = acc[i];
  }
  if (tid < R) {
    ws_ml[(split_row + tid) * 2] = m_sh[tid];
    ws_ml[(split_row + tid) * 2 + 1] = l_sh[tid];
  }
  // the block's writes, ordered by the barrier before one thread's
  // release (cumulative) on the counter; the last block's acquire, passed
  // on by the barrier, orders the other splits' writes before its reads
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> count(
        counters[head * nrb + rb]);
    const int done = count.fetch_add(1, cuda::memory_order_acq_rel);
    last_sh = done == n_split - 1;
    if (last_sh) count.store(0, cuda::memory_order_relaxed);  // next launch
  }
  __syncthreads();
  if (!last_sh) return;

  // the last block of (b, h, rb): combine splits 0 .. n_split - 1 in order
  const size_t first_row = head * S * R_all + r0;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int item = tid + i * kThreads;
    if (i * kThreads >= RD) break;
    if (item < RD) {
      const int r = acc_row[i];
      const float* ml = ws_ml + (first_row + r) * 2;
      const float* ap = ws_acc + first_row * dv + item;
      float M = __ldcg(ml), Lsum = __ldcg(ml + 1), A = __ldcg(ap);
#pragma unroll 4
      for (int sp = 1; sp < n_split; ++sp) {
        const float m_s = __ldcg(ml + (size_t)sp * R_all * 2);
        const float l_s = __ldcg(ml + (size_t)sp * R_all * 2 + 1);
        const float a_s = __ldcg(ap + (size_t)sp * RDa);
        const float m_new = fmaxf(M, m_s);
        const float alpha = expf(M - m_new), beta = expf(m_s - m_new);
        Lsum = fmaf(Lsum, alpha, l_s * beta);
        A = fmaf(A, alpha, a_s * beta);
        M = m_new;
      }
      out[qrow(r) * dv + item - r * dv] = A / fmaxf(Lsum, 1e-30f);
    }
  }
}

// Host-side launch preparation shared by the GQA launchers: the shape
// check, the workspace and counter sizes, the dynamic shared memory
// opt-in, and the grid (B, KVH * row blocks, S).  Returns a cudaError_t.
template <class Kernel>
int prepare(Kernel kernel, int B, int KVH, int S, int R, int G, int dk,
            int dv, long long ws_floats, long long n_counters, size_t* smem,
            dim3* grid) {
  if (B <= 0 || KVH <= 0 || S <= 0 || S > 65535 || !shape_ok(R, G, dk, dv))
    return (int)cudaErrorInvalidValue;
  const int nrb = row_blocks(R, G, dv);
  if ((long long)KVH * nrb > 65535 ||
      ws_floats < (long long)workspace_floats(B, KVH, S, R, dv) ||
      n_counters < (long long)B * KVH * nrb)
    return (int)cudaErrorInvalidValue;
  *grid = dim3(B, KVH * nrb, S);
  *smem = smem_layout(block_rows(R, G, dv), dk, dv).total;
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return (int)cudaSuccess;
}

}  // namespace split
}  // namespace mxattn
