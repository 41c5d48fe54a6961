#!/usr/bin/env python3
"""Where kernel 1's time goes, block by block, on the card.

Usage, from the repository root, on a machine with one CUDA card:

    python3 tools/k1_phases.py

It builds ``src/repro_torch/csrc/mx_state_update.cu`` once more with its
phase hooks (``MX_SU_STAMP``) defined, so that thread 0 of every block
writes the global timer and its SM's cycle counter at four points: entry
(0), after the barrier that ends the operand staging (1: the head's k, q,
d are in shared memory), after the barrier that ends the rows' update (2),
and after its row sums (3), plus the SM it ran on.  Then it launches that
build once per served head shape (``PERF.md``'s kernel table), each launch
on a state cold in L2 and operands (k, q, d, v) warm in it, as the decode
step's projections leave them, and prints per shape: the launch's time between
CUDA events, the span from the first block's entry to the last block's
end on the global timer, the blocks and the most blocks one SM ran, and
each phase's mean length in SM cycles (entry -> staged: the loads' wait;
staged -> updated: the rows' arithmetic, including the wait for the state
loads; updated -> end: the row sums).  The instrumented build is timed
alone: its stamps cost a few global stores a block.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

_WRAPPER = r"""
#include <stdint.h>
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long k1_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned k1_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define MX_SU_STAMP(phase)                                               \
  if (threadIdx.x == 0 && threadIdx.y == 0) {                            \
    unsigned long long* s_ =                                             \
        g_stamps + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) *      \
                        gridDim.x + blockIdx.x) * 10;                    \
    s_[(phase)] = k1_now();                                              \
    s_[4 + (phase)] = (unsigned long long)clock64();                     \
    if ((phase) == 0) s_[8] = k1_smid();                                 \
  }
#include "CSRC/mx_state_update.cu"
extern "C" int k1_phases_set(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
"""


def main() -> int:
    import torch
    from kernels_vs_parent import K1_TIMED
    from repro_torch.core import formats as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_state_update as KS
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "k1_phases.cu"
        src.write_text(_WRAPPER.replace(
            "CSRC", str(ROOT / "src" / "repro_torch" / "csrc")))
        lib_path = Path(tmp) / "k1_phases.so"
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), str(src)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(lib_path))
    fn = lib.mx_state_update_launch
    fn.restype, fn.argtypes = ctypes.c_int, list(KS._ARGTYPES)
    lib.k1_phases_set.restype = ctypes.c_int
    lib.k1_phases_set.argtypes = [ctypes.c_void_p]
    flush = torch.empty(int(2 * 50e6) // 4, device="cuda")
    for label, (B, H, dv, dk), slab, per_channel in K1_TIMED:
        g = torch.Generator(device="cuda").manual_seed(dk + dv)
        d = torch.sigmoid(torch.randn((B, H, dk if per_channel else 1),
                                      generator=g, device="cuda"))
        k, q = (torch.randn((B, H, dk), generator=g, device="cuda")
                for _ in "kq")
        v = torch.randn((B, H, dv), generator=g, device="cuda")
        y = torch.empty((B, H, dv), device="cuda")
        if slab:
            st = F.mx8_quantize(torch.randn((B + 1, 2, H, dv, dk),
                                            generator=g, device="cuda"))
            slabs = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")
            sl, n_stack, group = slabs.data_ptr(), 2, 1
        else:
            st = F.mx8_quantize(torch.randn((B, H, dv, dk), generator=g,
                                            device="cuda"))
            sl, n_stack, group = None, 1, 0
        stamps = torch.zeros((B * H * dv, 10), dtype=torch.int64,
                             device="cuda")
        assert lib.k1_phases_set(stamps.data_ptr()) == 0
        p = st.payload

        def launch(seed):
            return fn(p["mantissa"].data_ptr(), p["exponent"].data_ptr(),
                      p["micro"].data_ptr(), d.data_ptr(), k.data_ptr(),
                      v.data_ptr(), q.data_ptr(), y.data_ptr(), sl, B * H, H,
                      n_stack, group, dv, dk, int(per_channel), seed, 1,
                      torch.cuda.current_stream().cuda_stream)
        for i in range(3):                     # warm up
            assert launch(i) == 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        event_ms = []
        for i in range(5):
            flush.zero_()
            for t in (d, k, q, v):
                t.sum()
            stamps.zero_()
            ev[0].record()
            launch(100 + i)
            ev[1].record()
            torch.cuda.synchronize()
            event_ms.append(ev[0].elapsed_time(ev[1]))
        s = stamps[stamps[:, 0] != 0].cpu().double()
        n_blocks = s.shape[0]
        span_us = float(s[:, 3].max() - s[:, 0].min()) / 1e3
        start_spread_us = float(s[:, 0].max() - s[:, 0].min()) / 1e3
        cyc = [float((s[:, 5 + i] - s[:, 4 + i]).mean()) for i in range(3)]
        ns = [float((s[:, 1 + i] - s[:, i]).mean()) for i in range(3)]
        per_sm = torch.bincount(s[:, 8].long())
        ghz = float((s[:, 7] - s[:, 4]).sum() / (s[:, 3] - s[:, 0]).sum())
        print(f"phases kernel 1 {label} {(B, H, dv, dk)}: "
              f"event_ms={min(event_ms):.5f} span_us={span_us:.3f} "
              f"blocks={n_blocks} sms={int((per_sm > 0).sum())} "
              f"max_blocks_per_sm={int(per_sm.max())} "
              f"last_block_start_us={start_spread_us:.3f} "
              f"sm_GHz={ghz:.3f} "
              f"cycles(entry->staged,staged->updated,updated->end)="
              f"{cyc[0]:.0f},{cyc[1]:.0f},{cyc[2]:.0f} "
              f"ns={ns[0]:.0f},{ns[1]:.0f},{ns[2]:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
