// Fused MX8 state update for Hopper (sm_90a): one decode step of paper Eq. 2
//
//     S' = d (.) S + k v^T ;   y = S'^T q
//
// over a packed MX8 state stored transposed, (B, H, dv, dk), with groups of
// 16 values along dk that share an 8-bit exponent and pairs that share a
// micro-exponent bit.
//
// Replaces the TPU kernel repro/kernels/mx_state_update.py::mx_state_update
// (_state_update_kernel).  What bounds it on an H100: instruction issue,
// then bytes.  Each step reads and writes the packed state once (9 stored
// bits per value), but dequantizing, updating, requantizing (stochastic
// rounding hashes every value) and the output dot take tens of
// instructions per value, more than the bytes' time at these sizes
// (tools/k1_phases.py reads the phases).  The design:
//   * one block per (head, batch row, block of rows); a thread owns one
//     16-value group column across R = 1 or 2 rows of the head (rows slot,
//     slot + slots), so neighbouring threads touch neighbouring bytes, and
//     every row's 16-byte mantissa load goes out before the first barrier;
//   * the head's k, q and per-channel d are staged in shared memory once
//     per block with 16-byte loads and read back per row, which keeps a
//     thread at 64 registers, 8 blocks of 128 threads an SM;
//   * R is 1 where the SMs hold the whole grid at once, else 2;
//   * the group arithmetic (mx8_group.cuh) has no division and no
//     conversion instruction but the SR hash's on the value path;
//   * y rounds each product of a stored value and q to fp32 and adds a
//     group's 16 products in order from 0.f, then each row's group
//     partials in group order from 0.f, one thread per row of the block,
//     all rows at once: no contraction into an FMA, so the plain version
//     (ref.py, group_ordered_dot) gives y bitwise.  (On an H100 a
//     pairwise sum a group took a 64-byte stack frame at one row a
//     thread and 1.09-1.30x the time; this running sum costs 1-2 % over
//     the FMA chain it replaced.)
//
// Numerics match repro_torch/kernels/ref.py and, to a stated mismatch rate,
// the JAX package (see ROADMAP.md):
//   * scales are exact powers of two built from bits (no exp2f, and no
//     flush-to-zero: scales reach 2^-133, a subnormal);
//   * Sn = fma(S, d, round(v * k)) with explicit intrinsics, the contraction
//     XLA:CPU applies to the jitted reference;
//   * SR bits come from the same counter hash over the global flat index
//     (((row_base + b)*H_tot + head_base + h)*dv + row)*dk + col, in
//     uint32 arithmetic: row_base is the index in the whole batch of this
//     call's row 0 (a data-parallel rank's first row; 0 otherwise), and
//     head_base the index among the layer's H_tot heads of this call's
//     head 0 (a tensor-parallel rank's first head; 0 and H otherwise), so
//     a rank's rows and heads draw what the whole call draws for them.
//
// Slab mode (the paged serving pool): the state rows live in a slab pool
// (n_slabs, n_stack, H, dv, dk) and row b of the batch owns slab slab[b] at
// layer `group`, so the state pointer of (b, h) becomes
// pool[(slab[b] * n_stack + group) * H + h], updated in place -- no gather
// or scatter around the kernel.  The SR counter and the operand indices
// stay on the batch row b*H + h, so slab mode is bitwise equal to dense
// mode on the gathered rows.  Idle rows all point at scratch slab 0; their
// concurrent updates of it race harmlessly (it is never read back).
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "mx8_group.cuh"

namespace {

using mx8::kExpBias;
using mx8::kGroup;
constexpr int kMaxThreads = 256;
constexpr int kBlockThreads = 128;     // threads a block aims at

// Per-phase timestamps for tools/k1_phases.py, which defines the macro
// before including this file; compiled out otherwise.
#ifndef MX_SU_STAMP
#define MX_SU_STAMP(phase)
#endif

// Shared memory of a block: the staged operands, then (reusing the same
// bytes) the rows' group partials at an odd stride, so the row sums read
// without bank conflicts.
size_t smem_bytes(int dk, int ngroups, int per_channel, int rows) {
  const size_t ops = (size_t)(per_channel ? 3 : 2) * dk;
  const size_t parts = (size_t)rows * (ngroups | 1);
  return (ops > parts ? ops : parts) * sizeof(float);
}

template <int R, bool kPerChannel, bool kStochastic>
__global__ void __launch_bounds__(kMaxThreads, 4)    // <= 64 registers
mx_state_update_kernel(int8_t* __restrict__ mant, uint8_t* __restrict__ expo,
                       uint8_t* __restrict__ micro,
                       const float* __restrict__ d,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ q,
                       float* __restrict__ y,
                       const int* __restrict__ slab, int H, int n_stack,
                       int group, int dv, int dk, uint32_t seed,
                       uint32_t flat_base, uint32_t row_stride, int slots) {
  extern __shared__ __align__(16) float smem[];
  MX_SU_STAMP(0);
  // block (ngroups, slots) threads, grid (H, B, row blocks): no division
  const int ngroups = blockDim.x;
  const int grp = threadIdx.x;
  const int slot = threadIdx.y;
  const int tid = slot * ngroups + grp;
  const int nthreads = ngroups * slots;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int bh = b * H + h;
  const int col0 = grp * kGroup;
  const int block_rows = slots * R;
  const int row0 = blockIdx.z * block_rows + slot;
  // state row of (b, h): the batch row itself, or its slab's row at layer
  // `group` in slab mode
  const size_t sbh = slab == nullptr
                         ? (size_t)bh
                         : ((size_t)slab[b] * n_stack + group) * H + h;
  // the SR counter of (b, h, row 0, col 0) in the whole state
  const uint32_t sr_head = flat_base + (uint32_t)b * row_stride +
                           (uint32_t)h * (uint32_t)dv * (uint32_t)dk;

  // the head's operands, once per block, with 16-byte loads
  {
    const int n4 = dk / 4;
    float4* s4 = reinterpret_cast<float4*>(smem);
    const float4* k4 = reinterpret_cast<const float4*>(k + (size_t)bh * dk);
    const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)bh * dk);
    const float4* d4 = reinterpret_cast<const float4*>(d + (size_t)bh * dk);
    for (int i = tid; i < n4; i += nthreads) {
      s4[i] = k4[i];
      s4[n4 + i] = q4[i];
      if (kPerChannel) s4[2 * n4 + i] = d4[i];
    }
  }
  // the state rows' loads go out before the barrier
  const float d0 = kPerChannel ? 0.f : d[bh];
  int4 mv[R];
  uint32_t em[R];
  float vr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + i * slots;
    if (row < dv) {
      const size_t srow = sbh * dv + row;
      const size_t gid = srow * ngroups + grp;
      mv[i] = *reinterpret_cast<const int4*>(mant + srow * dk + col0);
      em[i] = expo[gid] | (uint32_t)micro[gid] << 8;
      vr[i] = v[(size_t)bh * dv + row];
    }
  }
  __syncthreads();
  MX_SU_STAMP(1);
  // this group's 16 values of k, q (and d), read back per row: registers
  // kept for them would cost the occupancy that hides the loads
  const float4* ks = reinterpret_cast<const float4*>(smem + col0);
  const float4* qs = reinterpret_cast<const float4*>(smem + dk + col0);
  const float4* ds = reinterpret_cast<const float4*>(smem + 2 * dk + col0);

  float partial[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    partial[i] = 0.f;
    const int row = row0 + i * slots;
    if (row >= dv) continue;
    const size_t rowid = (size_t)bh * dv + row;       // operands
    const size_t srow = sbh * dv + row;               // state storage
    const size_t gid = srow * ngroups + grp;

    // dequantize, decay + outer product: Sn = fma(S, d, v*k)
    const uint32_t w[4] = {(uint32_t)mv[i].x, (uint32_t)mv[i].y,
                           (uint32_t)mv[i].z, (uint32_t)mv[i].w};
    float sn[kGroup];
    mx8::dequantize_group(w, (int)(em[i] & 0xFF) - kExpBias,
                          (int)(em[i] >> 8), sn);
#pragma unroll
    for (int j4 = 0; j4 < kGroup / 4; ++j4) {
      const float4 k4 = ks[j4];
      const float4 d4 = kPerChannel ? ds[j4] : make_float4(d0, d0, d0, d0);
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = 4 * j4 + h;
        sn[j] = __fmaf_rn(sn[j], dd[h], __fmul_rn(vr[i], kk[h]));
      }
    }

    // requantize (the group arithmetic of mx8_group.cuh), write back in
    // place, then the output dot product on the stored values
    float t[kGroup], scale[kGroup / 2];
    uint32_t packed[4];
    int e, mic;
    mx8::quantize_group(sn, sr_head + (uint32_t)row * (uint32_t)dk +
                                (uint32_t)col0,
                        seed, kStochastic, t, packed, e, mic, scale);
    *reinterpret_cast<int4*>(mant + srow * dk + col0) =
        make_int4((int)packed[0], (int)packed[1], (int)packed[2],
                  (int)packed[3]);
    expo[gid] = (uint8_t)(e + kExpBias);
    micro[gid] = (uint8_t)mic;
    // stored value m_j * scale = t_j * scale - kMagic * scale: one exact
    // FMA where kMagic * scale is a float (e <= 110), else two; its
    // product with q rounded, then added to the group's running sum
    float qq[kGroup];
#pragma unroll
    for (int j4 = 0; j4 < kGroup / 4; ++j4) {
      const float4 q4 = qs[j4];
      qq[4 * j4] = q4.x, qq[4 * j4 + 1] = q4.y;
      qq[4 * j4 + 2] = q4.z, qq[4 * j4 + 3] = q4.w;
    }
    if (e <= 110) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float sc = scale[j >> 1];
        partial[i] = __fadd_rn(partial[i], __fmul_rn(
            __fmaf_rn(t[j], sc, -__fmul_rn(mx8::kMagic, sc)), qq[j]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        partial[i] = __fadd_rn(partial[i], __fmul_rn(
            __fmul_rn(__fsub_rn(t[j], mx8::kMagic), scale[j >> 1]), qq[j]));
    }
  }

  // y: each row's partials summed in group order from 0.f, unfused
  const int stride = ngroups | 1;
  __syncthreads();                       // the operands are all read
  MX_SU_STAMP(2);
#pragma unroll
  for (int i = 0; i < R; ++i)
    smem[(i * slots + slot) * stride + grp] = partial[i];
  __syncthreads();
  for (int r = tid; r < block_rows; r += nthreads) {
    const int row = blockIdx.z * block_rows + r;
    if (row < dv) {
      float s = 0.f;
      for (int j = 0; j < ngroups; ++j)
        s = __fadd_rn(s, smem[r * stride + j]);
      y[(size_t)bh * dv + row] = s;
    }
  }
  MX_SU_STAMP(3);
}

using KernelFn = decltype(&mx_state_update_kernel<1, true, true>);

template <int R>
KernelFn kernel_rows(int per_channel, int stochastic) {
  if (per_channel)
    return stochastic ? mx_state_update_kernel<R, true, true>
                      : mx_state_update_kernel<R, true, false>;
  return stochastic ? mx_state_update_kernel<R, false, true>
                    : mx_state_update_kernel<R, false, false>;
}

KernelFn kernel_for(int rows, int per_channel, int stochastic) {
  return rows == 1 ? kernel_rows<1>(per_channel, stochastic)
                   : kernel_rows<2>(per_channel, stochastic);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// Blocks of kernel `fn` at `threads` threads and `smem` bytes that one SM
// holds at once, from the occupancy calculator, remembered per key.
int resident_blocks(const void* fn, int threads, size_t smem) {
  struct Entry {
    const void* fn;
    int threads;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static Entry seen[64];
  static int n_seen = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == fn && seen[i].threads == threads &&
        seen[i].smem == smem)
      return seen[i].blocks;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                    smem) != cudaSuccess)
    blocks = 1;
  if (n_seen < 64) seen[n_seen++] = {fn, threads, smem, blocks};
  return blocks;
}

// The block shape of a launch: blocks of about kBlockThreads threads
// (`slots` threads' rows each), and R, the rows a thread owns: 1 where the
// SMs hold the whole grid at once, else 2 (a second row per thread costs
// less than a second wave of blocks).
void pick_shape(int BH, int dv, int dk, int per_channel, int stochastic,
                int* rows, int* slots) {
  const int ngroups = dk / kGroup;
  const int s = kBlockThreads / ngroups > 0 ? kBlockThreads / ngroups : 1;
  const int sl = s < dv ? s : dv;
  const long long blocks = (long long)BH * ((dv + sl - 1) / sl);
  const long long fit =
      (long long)resident_blocks((const void*)kernel_for(1, per_channel,
                                                         stochastic),
                                 sl * ngroups,
                                 smem_bytes(dk, ngroups, per_channel, sl)) *
      sm_count();
  *rows = blocks <= fit ? 1 : 2;
  const int need = (dv + *rows - 1) / *rows;
  *slots = s < need ? s : need;
}

int launch_shape(void* mant, void* expo, void* micro, const void* d,
                 const void* k, const void* v, const void* q, void* y,
                 const void* slab, int BH, int H, int n_stack, int group,
                 int dv, int dk, int d_per_channel, unsigned int seed,
                 unsigned int row_base, unsigned int head_base,
                 unsigned int heads_total, int stochastic, void* stream,
                 int rows, int slots) {
  const int ngroups = dk / kGroup;
  if (slots <= 0 || slots * ngroups > kMaxThreads ||
      (rows != 1 && rows != 2))
    return (int)cudaErrorInvalidValue;
  const int block_rows = slots * rows;
  const dim3 grid(H, BH / H, (dv + block_rows - 1) / block_rows);
  const dim3 block(ngroups, slots);
  const size_t smem = smem_bytes(dk, ngroups, d_per_channel, block_rows);
  kernel_for(rows, d_per_channel, stochastic)<<<grid, block, smem,
                                                (cudaStream_t)stream>>>(
      (int8_t*)mant, (uint8_t*)expo, (uint8_t*)micro, (const float*)d,
      (const float*)k, (const float*)v, (const float*)q, (float*)y,
      (const int*)slab, H, n_stack, group, dv, dk, (uint32_t)seed,
      ((uint32_t)row_base * heads_total + head_base) * (uint32_t)dv *
          (uint32_t)dk,
      heads_total * (uint32_t)dv * (uint32_t)dk, slots);
  return (int)cudaGetLastError();
}

}  // namespace

// State (mant, expo, micro) is updated in place.  d is (BH, dk) when
// d_per_channel, else (BH,); k, q are (BH, dk); v, y are (BH, dv); all f32,
// contiguous; k, q and a per-channel d 16-byte aligned.  slab is NULL
// (dense state (BH, dv, dk)) or (BH / H,) int32 slab ids into a (n_slabs,
// n_stack, H, dv, dk) pool at layer `group`.  row_base: the index in the
// whole batch of row 0; head_base, heads_total: the index of head 0 among
// the layer's heads_total heads (0 and H for a whole layer) -- the SR
// counter's, see above.  Returns cudaGetLastError() after the launch.
extern "C" int mx_state_update_launch(void* mant, void* expo, void* micro,
                                      const void* d, const void* k,
                                      const void* v, const void* q, void* y,
                                      const void* slab, int BH, int H,
                                      int n_stack, int group, int dv, int dk,
                                      int d_per_channel, unsigned int seed,
                                      unsigned int row_base,
                                      unsigned int head_base,
                                      unsigned int heads_total,
                                      int stochastic, void* stream) {
  if (BH <= 0 || H <= 0 || BH % H != 0 || dv <= 0 || dk <= 0 ||
      heads_total < (unsigned int)H || head_base > heads_total - H ||
      dk % kGroup != 0 || dk / kGroup > kMaxThreads || n_stack <= 0 ||
      group < 0 || group >= n_stack)
    return (int)cudaErrorInvalidValue;
  int rows, slots;
  pick_shape(BH, dv, dk, d_per_channel, stochastic, &rows, &slots);
  return launch_shape(mant, expo, micro, d, k, v, q, y, slab, BH, H, n_stack,
                      group, dv, dk, d_per_channel, seed, row_base,
                      head_base, heads_total, stochastic, stream, rows,
                      slots);
}
