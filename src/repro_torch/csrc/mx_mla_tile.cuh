// The MLA-mode attention loop shared by the dense (mx_attention.cu), the
// paged (mx_paged_attention.cu) and the speculative-verify
// (mx_spec_attention.cu) kernels, for Hopper (sm_90a).
//
// MLA (DeepSeek-V2's latent cache) keeps one MX8 stream per kv head: a
// latent row of dk = kv_lora + rope_dim lanes serves as the key at full
// width and as the value in its first dv = kv_lora lanes (the TPU kernels'
// qV=None / v_width mode).  At deepseek-v2-236b's widths (KVH = 1, 128
// query heads, dk 576, dv 512) each 648-byte latent row feeds 128 x
// (576 + 512) multiply-adds, ~430 flops per cached byte: too many for the
// fp32 units of the few SMs a row's positions can occupy, so the products
// run on the tensor cores, and the work is spread over blocks by position
// as well as by query row.  The design:
//
//   * The time axis is split across blocks: grid (B, KVH * row blocks, S),
//     block (b, (h, rb), s) owns the fixed positions [64 s, 64 s + 64) --
//     half a 128-token page, so a paged block reads one block-table entry
//     -- and kRows = 16 query rows.  Blocks past their row's longest
//     length exit at once.  The split depends on nothing but the position.
//     At deepseek's decode lengths (72, 408, 141, 259) that is 136 blocks;
//     a Kq = 4 verify pass has 4x the row blocks.  112 KB of shared memory
//     and at most 128 registers a thread let two blocks share an SM, so
//     the decode launch is resident at once.
//   * The split's mantissa rows arrive in one bulk copy (the Tensor Memory
//     Accelerator; a copy a row when kv heads interleave) that completes
//     on an mbarrier, while each thread loads the exponent and micro bytes
//     of the 16-value groups it dequantizes.  Each latent row is
//     dequantized once into bf16 -- exact: an MX8 value is an int8 times a
//     power of two no smaller than 2^-132, and bf16 holds 8 significant
//     bits down to its 2^-133 subnormal -- with positions past the row's
//     length zeroed.  The 16 pre-scaled query rows follow in a second bulk
//     copy into the region the mantissas have left.
//   * Both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate).  The fp32 operand is split into three bf16 terms
//     that sum back to it exactly (hi: its top 8 significant bits by
//     truncation, mid: the next 8 of the remainder, lo: the rest), each
//     term multiplied by the exact bf16 latent and accumulated in fp32 in
//     the order lo, mid, hi: scores = Q K^T over all dk lanes (warp w
//     takes the 16-lane k-steps w, w + 8, ... for all 64 positions; the
//     eight warps' partials add in a fixed tree), then the split's softmax
//     (warp w rows 2w, 2w + 1), then P V over the first dv lanes (warp w
//     owns output columns 64w .. 64w + 63, four 16-position k-steps).
//   * The splits combine in the same launch: each block writes its rows'
//     (m, l, acc) to a workspace, the last block of (b, h, rb) to finish
//     -- an acquire-release counter per (b, h, rb), which that block resets
//     so a CUDA graph can replay the launch -- combines splits 0 .. n - 1
//     in order.  A row that fits one split skips the workspace.
//
// Query rows are query-major, r = j * G + g: n_q verify positions of the G
// heads that share a kv head; row r masks to len - (n_q - 1 - j).  Every
// row's arithmetic is a fixed function of its own query, its own length
// and the latent rows -- the same MMAs in the same order whatever the row
// block, the row's slot in the MMA tile or n_q -- and a split that is
// fully masked for a row gives it (-1e30, 0, 0), the identity of the
// combine.  So row j of an n_q-position pass is bitwise the n_q = 1
// launch at its shifted length, the verify kernels with n_q = 1 are
// bitwise the decode kernels, and the paged kernels are bitwise the dense
// ones over gathered pages (the Rows policy only says where a
// 128-position tile lives).
#pragma once

#include <cuda/atomic>

#include "mx_attention_tile.cuh"

// Phase hooks for tools/mla_phases.py, which defines this before including
// a launcher: thread 0 of a block stamps the timer at the block's entry
// (0), once its split is staged and dequantized (1), once the scores are
// in shared memory (2), after the softmax (3), after P V (4) and at its
// end (5).  Compiled out otherwise.
#ifndef MX_MLA_STAMP
#define MX_MLA_STAMP(phase)
#endif

namespace mxattn {
namespace mla {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;                 // a block resident beside another
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                     // query rows a block (m16)
constexpr int kSplit = 64;                    // positions a block
// groups whose exponent and micro bytes a thread prefetches (all of its
// groups up to dk = 576)
constexpr int kEm = 9;
constexpr int kNT = kSplit / 8;               // score n-tiles (8 positions)
constexpr int kColsPerWarp = 64;              // P V output columns a warp
constexpr int kMaxDv = kWarps * kColsPerWarp;
constexpr int kMaxDk = 1152;                  // shared memory bound (below)
constexpr int kPs = kSplit + 8;               // row stride of P
static_assert(kTile % kSplit == 0, "two splits a page");
static_assert(kRows == 2 * kWarps, "softmax: warp w takes rows 2w, 2w + 1");
static_assert(kThreads == 16 * kRows, "16 threads a row write the outputs");

// Row stride of the bf16 latent rows: dk + 8, an odd number of 16-byte
// chunks, so the eight row addresses of an ldmatrix hit distinct banks.
__host__ __device__ constexpr int k_stride(int dk) { return dk + 8; }

// The score partials and the staged outputs are rows of 64 and kMaxDv
// floats, their 8-float groups swizzled by the row (column ^ 8 (row % 4)):
// a half-warp's fragment stores (rows g .. g + 3) and a warp's row reads
// hit distinct banks.
__device__ __forceinline__ int swz(int row, int col) {
  return col ^ ((row & 3) << 3);
}

// Byte offsets of the dynamic shared memory: the bf16 latent rows, then
// one region used in turn by the split's staged mantissas, the query rows,
// and the score partials with the probabilities (the staged outputs reuse
// the partials).  At dk = 576 that is 112,128 bytes: two blocks fit an SM.
struct Smem {
  size_t ks, raw, qs, part, ps, total;
};

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

__host__ __device__ constexpr Smem smem_layout(int dk) {
  Smem L{};
  L.ks = 0;
  L.raw = align128((size_t)kSplit * k_stride(dk) * 2);
  L.qs = L.raw;
  L.part = L.raw;
  L.ps = L.part + (size_t)kWarps * kRows * kSplit * 4;
  const size_t staged = (size_t)kSplit * dk;    // = kRows * dk floats
  const size_t scores = L.ps - L.part + (size_t)kRows * kPs * 4;
  L.total = L.raw + (staged > scores ? staged : scores);
  return L;
}
// 227 KB a block on an H100, less the static arrays and a margin; the
// staged outputs (kRows x kMaxDv floats) fit the partials' place
static_assert(smem_layout(kMaxDk).total + 1024 <= 232448,
              "kMaxDk exceeds the shared memory of a block");
static_assert(2 * (smem_layout(576).total + 1024 + 256) <= 233472,
              "two blocks an SM at deepseek-v2-236b's dk = 576");
static_assert(kRows * kMaxDv <= kWarps * kRows * kSplit,
              "the staged outputs reuse the score partials");

inline size_t smem_bytes(int dk) { return smem_layout(dk).total; }

// Host-side shape check shared by every MLA launcher: R = n_q * G rows.
inline bool shape_ok(int R, int dk, int dv) {
  return R > 0 && dk > 0 && dk % kGroup == 0 && dk <= kMaxDk && dv > 0 &&
         dv <= dk && dv <= kMaxDv;
}

__host__ __device__ inline int row_blocks(int R) {
  return (R + kRows - 1) / kRows;
}

// A workspace row holds dv accumulators, rounded up to whole float4s.
__host__ __device__ inline int ws_stride(int dv) { return (dv + 3) & ~3; }

// Workspace floats for grid (B, KVH * row_blocks(R), S): (acc, then
// (m, l)) of kRows rows per block; one counter per (b, h, row block).
inline size_t workspace_floats(int B, int KVH, int S, int R, int dv) {
  return (size_t)B * KVH * row_blocks(R) * S * kRows *
         ((size_t)ws_stride(dv) + 2);
}
inline size_t counters_needed(int B, int KVH, int R) {
  return (size_t)B * KVH * row_blocks(R);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b: one m16n8k16 MMA, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bulk copy engine (TMA): one thread asks for `bytes` (a multiple of
// 16, both addresses 16-byte aligned) to land in shared memory; the copy
// completes on an mbarrier that expects that many bytes.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// Orders this thread's earlier shared-memory accesses before later bulk
// copies into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float trunc_bf16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// x = hi + mid + lo, each a bf16 value: hi keeps x's top 8 significant
// bits, mid the next 8 of the (exact) remainder, lo the rest (at most 8
// bits: exact wherever |x| >= 2^-110).
__device__ __forceinline__ void split3(float x, float& hi, float& mid,
                                       float& lo) {
  hi = trunc_bf16(x);
  const float r = __fsub_rn(x, hi);
  mid = trunc_bf16(r);
  lo = __fsub_rn(r, mid);
}

// The three bf16 terms (lo, mid, hi) of an A fragment from four fp32
// pairs: rows g and g + 8, columns 2c, 2c + 1 and 2c + 8, 2c + 9.
__device__ __forceinline__ void a_terms(const float2 (&x)[4],
                                        unsigned (&a)[3][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h0, m0, l0, h1, m1, l1;
    split3(x[i].x, h0, m0, l0);
    split3(x[i].y, h1, m1, l1);
    a[0][i] = bf16_pair(l0, l1);
    a[1][i] = bf16_pair(m0, m1);
    a[2][i] = bf16_pair(h0, h1);
  }
}

// One 16-value MX8 group as eight bf16 pairs: value j is m_j * 2^(e - 6 -
// micro bit j/2), the same product as dequant_group's, with the int8
// mantissa made a float without a conversion instruction: the byte
// m_j + 128 below the bits of 2^23, less 2^23 + 128 (exact).
__device__ __forceinline__ void dequant_bf16(int4 mant, uint8_t ebyte,
                                             uint8_t mic, unsigned (&w)[8]) {
  const int e = (int)ebyte - kExpBias - kMBits;
  const unsigned u[4] = {(unsigned)mant.x ^ 0x80808080u,
                         (unsigned)mant.y ^ 0x80808080u,
                         (unsigned)mant.z ^ 0x80808080u,
                         (unsigned)mant.w ^ 0x80808080u};
#pragma unroll
  for (int pr = 0; pr < 8; ++pr) {
    const float s = exact_pow2(e - ((mic >> pr) & 1));
    const unsigned word = u[pr >> 1];
    const unsigned sel = 0x7540u + 2u * (pr & 1);
    const float m0 = __fsub_rn(
        __uint_as_float(__byte_perm(word, 0x4B000000u, sel)), 8388736.0f);
    const float m1 = __fsub_rn(
        __uint_as_float(__byte_perm(word, 0x4B000000u, sel + 1u)), 8388736.0f);
    w[pr] = bf16_pair(__fmul_rn(m0, s), __fmul_rn(m1, s));
  }
}

// q (B, KVH, n_q * G, dk) pre-scaled f32, query-major rows, 16-byte
// aligned; latent mantissas int8 (16-byte aligned rows) and exponent /
// micro bytes addressed through `rows`; lengths (B,) int32 counting all
// n_q positions, each row's length clipped to `cap`; out (B, KVH,
// n_q * G, dv) f32; ws workspace_floats(B, KVH, S, R, dv) floats; counters
// counters_needed(B, KVH, R) int32, zero, left zero.  Launched with
// kThreads threads, smem_layout(dk).total bytes of dynamic shared memory,
// grid (B, KVH * row_blocks(R), S = cap / kSplit).
template <class Rows>
__device__ __forceinline__ void mla_split(
    const Rows& rows, const float* __restrict__ q,
    const int8_t* __restrict__ km, const uint8_t* __restrict__ ke,
    const uint8_t* __restrict__ kmi, const int* __restrict__ lengths,
    float* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int cap, int KVH, int G, int n_q, int dk,
    int dv) {
  extern __shared__ __align__(128) unsigned char mla_smem[];
  __shared__ float m_sh[kRows], l_sh[kRows];
  __shared__ int last_sh;
  __shared__ __align__(8) unsigned long long tma_bar;

  const int R = n_q * G;
  const int nrb = row_blocks(R);
  const int b = blockIdx.x, s = blockIdx.z, S = gridDim.z;
  const int h = blockIdx.y / nrb, rb = blockIdx.y - h * nrb;
  // the split's page (a paged block's one block-table entry) is read beside
  // the length: s < cap / 64 is inside the table
  const size_t row0 = rows.tile_base(b, s / (kTile / kSplit)) +
                      (size_t)(s % (kTile / kSplit)) * kSplit * KVH + h;
  const int len_all = lengths[b];
  const int len = clip_len(len_all, cap);
  const int n_split = len > 0 ? (len + kSplit - 1) / kSplit : 1;
  if (s >= n_split) return;
  MX_MLA_STAMP(0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;      // MMA fragment coordinates
  const int r0 = rb * kRows;                   // the block's first row
  const int pos0 = s * kSplit;
  const int ngk = dk / kGroup;
  const int ldk = k_stride(dk);
  const Smem L = smem_layout(dk);
  uint16_t* ks = reinterpret_cast<uint16_t*>(mla_smem + L.ks);
  const int8_t* raw = reinterpret_cast<const int8_t*>(mla_smem + L.raw);
  float* qs = reinterpret_cast<float*>(mla_smem + L.qs);
  float* part = reinterpret_cast<float*>(mla_smem + L.part);
  float* ps = reinterpret_cast<float*>(mla_smem + L.ps);
  float* os = part;                            // the staged outputs
  const size_t head = (size_t)b * KVH + h;

  // the split's mantissa rows arrive in one bulk copy (one a position when
  // kv heads interleave); meanwhile each thread loads the exponent and
  // micro bytes of the groups it will dequantize: group i = tid + 256 j is
  // position i / ngk, group i % ngk
  const int n_grp = kSplit * ngk;
  if (tid == 0) mbar_init(&tma_bar);
  auto em_bytes = [&](int i, uint8_t& e, uint8_t& mi) {
    const int p = i / ngk;
    const size_t at = (row0 + (size_t)p * KVH) * ngk + (i - p * ngk);
    e = ke[at];
    mi = kmi[at];
  };
  uint8_t eb[kEm], mb[kEm];
#pragma unroll
  for (int j = 0; j < kEm; ++j)
    if (tid + kThreads * j < n_grp) em_bytes(tid + kThreads * j, eb[j], mb[j]);
  __syncthreads();                // the barrier's init, seen by all
  if (tid == 0) {
    mbar_expect(&tma_bar, (unsigned)(kSplit * dk));
    if (KVH == 1) {
      bulk_copy(mla_smem + L.raw, km + row0 * dk, (unsigned)(kSplit * dk),
                &tma_bar);
    } else {
      for (int p = 0; p < kSplit; ++p)
        bulk_copy(mla_smem + L.raw + p * dk,
                  km + (row0 + (size_t)p * KVH) * dk, (unsigned)dk,
                  &tma_bar);
    }
  }
  mbar_wait(&tma_bar, 0);

  // dequantize each latent row once into bf16; zero past the block's
  // length (rows there may hold any bytes)
  auto dequant = [&](int i, uint8_t e, uint8_t mi) {
    const int p = i / ngk, grp = i - p * ngk;
    unsigned w[8];
    if (pos0 + p < len) {
      dequant_bf16(*reinterpret_cast<const int4*>(raw + p * dk +
                                                  grp * kGroup),
                   e, mi, w);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = 0u;
    }
    uint4* dst = reinterpret_cast<uint4*>(ks + p * ldk + grp * kGroup);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  };
#pragma unroll
  for (int j = 0; j < kEm; ++j)
    if (tid + kThreads * j < n_grp) dequant(tid + kThreads * j, eb[j], mb[j]);
  for (int i = tid + kThreads * kEm; i < n_grp; i += kThreads) {
    uint8_t e, mi;
    em_bytes(i, e, mi);
    dequant(i, e, mi);
  }
  // the block's query rows into the region the mantissas have left, in one
  // bulk copy (zero past R: computed on, never written)
  fence_proxy_async();
  __syncthreads();
  const int q_rows = R - r0 < kRows ? R - r0 : kRows;
  if (tid == 0) {
    mbar_expect(&tma_bar, (unsigned)(q_rows * dk * 4));
    bulk_copy(qs, q + (head * R + r0) * dk, (unsigned)(q_rows * dk * 4),
              &tma_bar);
  }
  for (int i = q_rows * dk + tid; i < kRows * dk; i += kThreads) qs[i] = 0.f;
  mbar_wait(&tma_bar, 1);
  __syncthreads();
  MX_MLA_STAMP(1);

  // scores: warp w, the k-steps w, w + 8, ... over all 64 positions
  {
    float sacc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[n][i] = 0.f;
    for (int kst = warp; kst < dk / 16; kst += kWarps) {
      const int k0 = kst * 16;
      const float2 x[4] = {
          *reinterpret_cast<const float2*>(qs + g * dk + k0 + 2 * c),
          *reinterpret_cast<const float2*>(qs + (g + 8) * dk + k0 + 2 * c),
          *reinterpret_cast<const float2*>(qs + g * dk + k0 + 2 * c + 8),
          *reinterpret_cast<const float2*>(qs + (g + 8) * dk + k0 + 2 * c +
                                           8)};
      unsigned a[3][4];
      a_terms(x, a);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        unsigned bm[4];
        ldmatrix_x4(bm, ks + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * ldk +
                            k0 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          mma_bf16(sacc[n], a[t], bm[0], bm[1]);
          mma_bf16(sacc[n + 1], a[t], bm[2], bm[3]);
        }
      }
    }
    __syncthreads();              // the queries are dead
    float* pw = part + (warp * kRows + g) * kSplit;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = swz(g, n * 8 + 2 * c);   // rows g and g + 8 alike
      *reinterpret_cast<float2*>(pw + col) =
          make_float2(sacc[n][0], sacc[n][1]);
      *reinterpret_cast<float2*>(pw + 8 * kSplit + col) =
          make_float2(sacc[n][2], sacc[n][3]);
    }
  }
  __syncthreads();
  MX_MLA_STAMP(2);

  // softmax over the split: warp w, rows 2w and 2w + 1, lanes = positions
  // lane and lane + 32; a masked position has p = 0 exactly
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * warp + i, gr = r0 + r;
    const int rl = gr < R ? clip_len(len_all - (n_q - 1 - gr / G), cap) - pos0
                          : 0;
    float sv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = lane + 32 * u;
      const float* pw = part + r * kSplit + swz(r, p);
      const int wp = kRows * kSplit;        // one warp's partials
      const float sc = ((pw[0] + pw[wp]) + (pw[2 * wp] + pw[3 * wp])) +
                       ((pw[4 * wp] + pw[5 * wp]) + (pw[6 * wp] + pw[7 * wp]));
      sv[u] = p < rl ? sc : kNegInf;
    }
    const float m = warp_max(fmaxf(sv[0], sv[1]));
    float e[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = lane + 32 * u;
      e[u] = p < rl ? expf(sv[u] - m) : 0.f;
      ps[r * kPs + p] = e[u];
    }
    const float l = warp_sum(e[0] + e[1]);
    if (lane == 0) {
      m_sh[r] = m;
      l_sh[r] = l;
    }
  }
  __syncthreads();
  MX_MLA_STAMP(3);

  // P V: warp w, output columns 64w .. 64w + 63, the four 16-position
  // k-steps in order
  const int col0 = warp * kColsPerWarp;
  float oacc[kColsPerWarp / 8][4];
#pragma unroll
  for (int n = 0; n < kColsPerWarp / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;
  if (col0 < dv) {
#pragma unroll
    for (int kk = 0; kk < kSplit / 16; ++kk) {
      const int k0 = kk * 16;
      const float2 x[4] = {
          *reinterpret_cast<const float2*>(ps + g * kPs + k0 + 2 * c),
          *reinterpret_cast<const float2*>(ps + (g + 8) * kPs + k0 + 2 * c),
          *reinterpret_cast<const float2*>(ps + g * kPs + k0 + 2 * c + 8),
          *reinterpret_cast<const float2*>(ps + (g + 8) * kPs + k0 + 2 * c +
                                           8)};
      unsigned a[3][4];
      a_terms(x, a);
#pragma unroll
      for (int pt = 0; pt < kColsPerWarp / 16; ++pt) {
        const int n0 = col0 + pt * 16;
        if (n0 < dv) {
          unsigned bm[4];
          ldmatrix_x4_trans(bm, ks + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                         ldk +
                                    n0 + (lane >> 4) * 8);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            mma_bf16(oacc[2 * pt], a[t], bm[0], bm[1]);
            mma_bf16(oacc[2 * pt + 1], a[t], bm[2], bm[3]);
          }
        }
      }
    }
  }

  // the outputs through shared memory (the partials' place), so that 16
  // threads a row store them coalesced
#pragma unroll
  for (int n = 0; n < kColsPerWarp / 8; ++n) {
    const int col = swz(g, col0 + n * 8 + 2 * c);
    *reinterpret_cast<float2*>(os + g * kMaxDv + col) =
        make_float2(oacc[n][0], oacc[n][1]);
    *reinterpret_cast<float2*>(os + (g + 8) * kMaxDv + col) =
        make_float2(oacc[n][2], oacc[n][3]);
  }
  __syncthreads();
  MX_MLA_STAMP(4);
  // 16 threads a row, four columns at a time: thread t takes row t / 16
  // and the column quads 4 (t % 16) + 64 k (the swizzle keeps a quad
  // whole); the workspace rows are padded to whole quads
  const int orow = tid >> 4, oc4 = 4 * (tid & 15);
  const float* orow_s = os + orow * kMaxDv;
  const int ldw = ws_stride(dv);
  auto out_quad = [&](float* o, int col, float4 v, float denom) {
    const float x[4] = {v.x / denom, v.y / denom, v.z / denom, v.w / denom};
    if (dv % 4 == 0) {
      *reinterpret_cast<float4*>(o + col) = make_float4(x[0], x[1], x[2],
                                                        x[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (col + u < dv) o[col + u] = x[u];
    }
  };
  if (n_split == 1) {             // the whole row in this block: no combine
    if (r0 + orow < R) {
      const float denom = fmaxf(l_sh[orow], 1e-30f);
      float* o = out + (head * R + r0 + orow) * dv;
      for (int col = oc4; col < dv; col += 64)
        out_quad(o, col,
                 *reinterpret_cast<const float4*>(orow_s + swz(orow, col)),
                 denom);
    }
    MX_MLA_STAMP(5);
    return;
  }

  // this split's partial: acc at ws[(split_row * kRows + r) * ldw + col],
  // (m, l) after all accumulators
  const size_t pair = head * nrb + rb;       // the (b, h, rb) counter
  const size_t n_rows = (size_t)gridDim.x * gridDim.y * S * kRows;
  float* ws_acc = ws;
  float* ws_ml = ws + n_rows * ldw;
  const size_t split_row = (pair * S + s) * kRows;
  {
    float* w = ws_acc + (split_row + orow) * ldw;
    for (int col = oc4; col < dv; col += 64)
      *reinterpret_cast<float4*>(w + col) =
          *reinterpret_cast<const float4*>(orow_s + swz(orow, col));
  }
  if (tid < kRows) {
    ws_ml[(split_row + tid) * 2] = m_sh[tid];
    ws_ml[(split_row + tid) * 2 + 1] = l_sh[tid];
  }
  // the block's writes, ordered by the barrier before one thread's
  // release (cumulative) on the counter; the last block's acquire, passed
  // on by the barrier, orders the other splits' writes before its reads
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> count(counters[pair]);
    const int done = count.fetch_add(1, cuda::memory_order_acq_rel);
    last_sh = done == n_split - 1;
    if (last_sh) count.store(0, cuda::memory_order_relaxed);  // next launch
  }
  __syncthreads();
  if (!last_sh) {
    MX_MLA_STAMP(5);
    return;
  }

  // the last block of (b, h, rb): combine splits 0 .. n_split - 1 in order,
  // each thread its row's quads, one split's loads all independent
  const size_t first_row = pair * S * kRows;
  constexpr int kQuads = kMaxDv / 64;
  if (r0 + orow < R) {
    const float* ml = ws_ml + (first_row + orow) * 2;
    const float* ap = ws_acc + (first_row + orow) * ldw + oc4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float M = __ldcg(ml), Lsum = __ldcg(ml + 1);
    float4 A[kQuads];
#pragma unroll
    for (int k = 0; k < kQuads; ++k)
      A[k] = oc4 + 64 * k < dv
                 ? __ldcg(reinterpret_cast<const float4*>(ap + 64 * k))
                 : zero;
    for (int sp = 1; sp < n_split; ++sp) {
      const float* mls = ml + (size_t)sp * kRows * 2;
      const float* aps = ap + (size_t)sp * kRows * ldw;
      float4 a_s[kQuads];
#pragma unroll
      for (int k = 0; k < kQuads; ++k)
        a_s[k] = oc4 + 64 * k < dv
                     ? __ldcg(reinterpret_cast<const float4*>(aps + 64 * k))
                     : zero;
      const float m_s = __ldcg(mls), l_s = __ldcg(mls + 1);
      const float m_new = fmaxf(M, m_s);
      const float alpha = expf(M - m_new), beta = expf(m_s - m_new);
      Lsum = fmaf(Lsum, alpha, l_s * beta);
#pragma unroll
      for (int k = 0; k < kQuads; ++k) {
        A[k].x = fmaf(A[k].x, alpha, a_s[k].x * beta);
        A[k].y = fmaf(A[k].y, alpha, a_s[k].y * beta);
        A[k].z = fmaf(A[k].z, alpha, a_s[k].z * beta);
        A[k].w = fmaf(A[k].w, alpha, a_s[k].w * beta);
      }
      M = m_new;
    }
    const float denom = fmaxf(Lsum, 1e-30f);
    float* o = out + (head * R + r0 + orow) * dv;
#pragma unroll
    for (int k = 0; k < kQuads; ++k)
      if (oc4 + 64 * k < dv) out_quad(o, oc4 + 64 * k, A[k], denom);
  }
  MX_MLA_STAMP(5);
}

// Host-side launch preparation shared by the MLA launchers: the shape
// check, the workspace and counter sizes, and the dynamic shared memory
// opt-in.  Returns a cudaError_t.
template <class Kernel>
int prepare(Kernel kernel, int B, int KVH, int S, int R, int dk, int dv,
            long long ws_floats, long long n_counters, size_t* smem) {
  if (B <= 0 || KVH <= 0 || S <= 0 || !shape_ok(R, dk, dv) ||
      (long long)KVH * row_blocks(R) > 65535 ||
      ws_floats < (long long)workspace_floats(B, KVH, S, R, dv) ||
      n_counters < (long long)counters_needed(B, KVH, R))
    return (int)cudaErrorInvalidValue;
  *smem = smem_bytes(dk);
  if (*smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (err != (int)cudaSuccess) return err;
  }
  // all of the SM's unified memory as shared memory: two blocks resident
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace mla
}  // namespace mxattn
