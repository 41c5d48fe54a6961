#!/usr/bin/env python3
"""Where the MLA attention loop's time goes, block by block, on the card.

Usage, from the repository root, on a machine with one CUDA card:

    python3 tools/mla_phases.py

It builds ``src/repro_torch/csrc/mx_paged_attention.cu`` (kernel 3) and
``mx_spec_attention.cu`` (kernel 5) once more with the MLA loop's phase
hooks (``MX_MLA_STAMP`` in ``csrc/mx_mla_tile.cuh``) defined, so that
thread 0 of every block that has work writes the global timer at six
points -- entry (0), split staged and dequantized (1), scores in shared
memory (2), softmax done (3), P V done (4), end (5; after the combine for
the last block of a row block) -- and the SM it ran on.  Then it launches
that build at deepseek-v2-236b's widths and ``PERF.md``'s timing lengths
(decode 72, 408, 141, 259; Kq = 4 verify 75, 411, 144, 262), the latent
cold in L2, and prints per launch: the time between CUDA events, the span
from the first block's entry to the last block's end, the blocks, the
most blocks one SM ran, the latest block start, each phase's mean length,
and the phases of the block that ended last.  The instrumented build is
timed alone: its stamps cost a few global stores a block.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))                 # chip_smoke's shapes

_WRAPPER = r"""
#include <stdint.h>
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long mla_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned mla_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define MX_MLA_STAMP(phase)                                              \
  if (threadIdx.x == 0) {                                                \
    unsigned long long* s_ =                                             \
        g_stamps + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) *      \
                        gridDim.x + blockIdx.x) * 8;                     \
    s_[(phase)] = mla_now();                                             \
    if ((phase) == 0) s_[6] = mla_smid() + 1;                            \
  }
#include "CSRC/SOURCE.cu"
extern "C" int mla_phases_set(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
"""

PHASES = ("staged", "scores", "softmax", "pv", "end")


def _build_stamped(source: str, tmp: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src = tmp / f"{source}_phases.cu"
    src.write_text(_WRAPPER.replace("CSRC", str(
        ROOT / "src" / "repro_torch" / "csrc")).replace("SOURCE", source))
    lib = tmp / f"{source}_phases.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    out = ctypes.CDLL(str(lib))
    out.mla_phases_set.restype = ctypes.c_int
    out.mla_phases_set.argtypes = [ctypes.c_void_p]
    return out


def _report(label, stamps, event_ms) -> None:
    import torch
    s = stamps[stamps[:, 6] != 0].cpu().double()
    t0 = float(s[:, 0].min())
    per_sm = torch.bincount(s[:, 6].long() - 1)
    ns = [float((s[:, i + 1] - s[:, i]).mean()) for i in range(5)]
    last = s[int(s[:, 5].argmax())]
    lp = [float(last[i + 1] - last[i]) for i in range(5)]
    print(f"phases {label}: event_ms={event_ms:.5f} "
          f"span_us={(float(s[:, 5].max()) - t0) / 1e3:.3f} "
          f"blocks={s.shape[0]} max_blocks_per_sm={int(per_sm.max())} "
          f"last_block_start_us={(float(s[:, 0].max()) - t0) / 1e3:.3f} "
          "mean_ns(" + ",".join(PHASES) + ")="
          + ",".join(f"{x:.0f}" for x in ns)
          + f" last_block(start_us={(float(last[0]) - t0) / 1e3:.3f}, ns="
          + ",".join(f"{x:.0f}" for x in lp) + ")", flush=True)


def main() -> int:
    import torch
    from chip_smoke import DS_MAX_NEW, DS_PROMPT_LENS, MLA, _mla_pool
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    if not torch.cuda.is_available():
        print("mla_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    m = MLA
    base = [n + DS_MAX_NEW // 2 for n in DS_PROMPT_LENS[:m["B"]]]
    scale, dk, dv, H = (128 + 64) ** -0.5, m["dk"], m["dv"], m["H"]
    flush = torch.empty(int(2 * 50e6) // 4, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {s: _build_stamped(s, Path(tmp))
                for s in ("mx_paged_attention", "mx_spec_attention")}
    for n_q in (1, 4):
        lengths = [n + n_q - 1 for n in base]
        q_all, C, bt, lens = _mla_pool(lengths, seed=130 + n_q)
        B, npg = len(lengths), bt.shape[1]
        if n_q == 1:
            qg = (q_all[:, 0] * scale).contiguous()
            lib, name, argtypes = (libs["mx_paged_attention"],
                                   "mx_paged_attention_decode_mla_launch",
                                   KP._MLA_ARGTYPES)
        else:
            qg = KV._fold(q_all[:, :n_q].contiguous(), 1, scale)
            lib, name, argtypes = (libs["mx_spec_attention"],
                                   "mx_paged_spec_attention_decode_mla_launch",
                                   KV._MLA_PAGED_ARGTYPES)
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        R = n_q * H
        ws, counters = KA.mla_scratch(B, 1, npg * 128, R, dv, qg.device)
        out = torch.empty((B, R, dv), device="cuda")
        n_blocks = B * -(-R // KA.MLA_ROWS) * npg * 2
        stamps = torch.zeros((n_blocks, 8), dtype=torch.int64, device="cuda")
        assert lib.mla_phases_set(stamps.data_ptr()) == 0
        p = C.payload
        dims = [B, npg, m["n_stack"], 1, 1, H] + ([n_q] if n_q > 1 else [])

        def launch():
            return fn(qg.data_ptr(), p["mantissa"].data_ptr(),
                      p["exponent"].data_ptr(), p["micro"].data_ptr(),
                      bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
                      ws.data_ptr(), counters.data_ptr(), *dims, dk, dv,
                      ws.numel(), counters.numel(),
                      torch.cuda.current_stream().cuda_stream)
        for _ in range(3):
            assert launch() == 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        best = None
        for _ in range(5):
            flush.zero_()
            stamps.zero_()
            ev[0].record()
            assert launch() == 0
            ev[1].record()
            torch.cuda.synchronize()
            t = ev[0].elapsed_time(ev[1])
            if best is None or t < best[0]:
                best = (t, stamps.clone())
        _report(f"{'kernel 3 decode' if n_q == 1 else 'kernel 5 verify'} "
                f"lengths={lengths}", best[1], best[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
