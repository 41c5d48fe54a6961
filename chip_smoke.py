#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version at the shapes the served model gives it,
times both (with a PyTorch library call as yardstick where one computes the
same function), then serves ``zamba2-2.7b`` at full width through the slot
pool, through the paged pool (``Engine``'s default) and through the paged
pool with speculative decoding, then ``deepseek-v2-236b`` at full width
(depth cut to 4 of its 60 layers: 53.2 GB of fp32 weights) through the same
three paths, then the paper's GLA-family models at full width and all 32
layers: ``gla-2.7b`` through the same three paths, ``retnet-2.7b`` and
``hgrn2-2.7b`` through the paged pool; then the paper's transformer
baseline ``opt-6.7b`` (32 layers) and ``yi-9b`` (48 layers, grouped
queries) at full width and full depth through the same three paths, then
``xlstm-1.3b`` (42 mLSTM + 6 sLSTM layers) at full width and depth
through the same three paths, then the last five configs: ``smollm-360m``
(all 32 layers), ``yi-34b`` (28 of 60 layers: 66.1 GB of fp32 weights)
and ``dbrx-132b`` (4 of 40: 57.1 GB) through the same three paths,
``paligemma-3b`` (all 18 layers) at model level -- 256 patch embeddings
before each request's text, prefill then decode -- and ``hubert-xlarge``
(all 48 layers), whose encoder has a prefill only.  It
checks that every decode step
went through the kernels of its path (the slot pool's appends through the
fused dense quantize-and-append), and every prefill through the MX8
quantizer (kernel 7, one launch for a layer's K and V), and that no
decode, verify or prefill step ran the plain MX8 quantizer on the card.
Phases, in the order they run:

  1. device   2. build   3. exact powers of two   4. state-update kernel
  5. attention kernel   9. paged kernels (paged attention, paged append:
  the copy and the fused quantize-and-append, state update in slab
  mode)   12. speculative-verify kernels (dense and
  paged)   20. the MX8 quantizer (kernel 7), bitwise   21. the
  state-update kernel at the GLA family's heads   28. the GQA kernels,
  the fused append and kernel 7 at opt-6.7b's and yi-9b's widths (yi-9b's
  verify pass: 32 query rows a kv head, two row blocks)   36. the slot
  pool's fused dense append at every served model's stream widths and
  kernel 7's two-stream launch, bitwise   38. kernel 1 at xlstm-1.3b's
  mLSTM heads (1040 rows of 64 groups) and kernel 7 at its prefill
  states, bitwise   43. kernels 2 to 7 and the dense append at the last
  five configs' widths (head width 64 at G = 3, 128 at G = 7 and 6, 256
  at G = 8 over one kv head), bitwise or within their tolerances
  6. timing   10.
  paged-kernel timing   13. verify-kernel timing   22. timing of kernels 7
  and 1 at the GLA family's shapes   29. timing at opt-6.7b's and yi-9b's
  widths   37. timing of the dense append and of kernel 7's prefill
  launch, with the paths they replaced   39. timing of kernels 1 and 7 at
  xlstm-1.3b's shapes   44. timing at the last five configs' widths
  7. main path, slot pool   11. main
  path, paged pool   12. matmul row invariance at the model's shapes
  14. main path, paged pool with speculation (n-gram drafts; a short
  model-draft run; the pool-level rollback check)   15. MLA mode of
  kernels 2, 3, 5 and 6 and the latent-only appends (copy and fused) at
  deepseek-v2-236b's widths   16. MLA timing   17. deepseek-v2-236b,
  slot pool   18.
  deepseek-v2-236b, paged pool   19. deepseek-v2-236b, paged pool with
  speculation   23. gla-2.7b, slot pool   24. gla-2.7b, paged pool
  25. gla-2.7b, paged pool with speculation   26. retnet-2.7b, paged
  pool   27. hgrn2-2.7b, paged pool   30-32. opt-6.7b: slot pool, paged
  pool, paged pool with speculation (the verify step's LayerNorm checked
  for row invariance)   33-35. yi-9b, the same   40-42. xlstm-1.3b:
  slot pool (with the sLSTM's share of a 400-token prefill), paged pool
  (with a pool-level spill and resume), paged pool with speculation
  45-47. smollm-360m: slot pool, paged pool, paged pool with speculation
  48. paligemma-3b at model level (prefill with patches, decode steps;
  the reference check by depth)   49. hubert-xlarge's encoder prefill
  50-52. yi-34b, the three paths   53-55. dbrx-132b, the three paths
  (greedy exactness at batch 1: MoE capacity couples a verify step's
  tokens)   8. kernels line

Any failure exits non-zero; with no card it fails (it never falls back to
the CPU).  The last three lines of standard output are the kernels' JSON
object, the card's name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``.
"""
import contextlib
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor)
#: flop/s, dense bf16 tensor-core flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
#: the MLA kernels' products: three bf16 terms of the fp32 operand, each a
#: tensor-core product (csrc/mx_mla_tile.cuh)
MLA_TERMS = 3

SU_SHAPES = ((4, 80, 64, 64), (4, 80, 64, 128))   # zamba2-2.7b, mamba2-2.7b
#: kernel 1 at a head of odd dv in a launch large enough that a thread owns
#: two rows (301 rows: the last block of rows partial, its last row alone)
SU_ODD = (4, 40, 301, 128)
#: kernel 1's state magnitudes; at 1e-37 (v scaled alike) the new state's
#: scales are subnormal and the quantizer takes its two-multiply path
SU_TINY = 1e-37
ATTN = dict(B=4, T=1024, H=32, KVH=32, d=80)       # zamba2-2.7b shared attn
PROMPT_LENS = (64, 400, 133, 251, 97, 320)         # main path, 64..400 tokens
MAX_NEW = 24
#: the paged main path: 9 pages (8 usable) of zamba2-2.7b KV make FCFS
#: preempt through the headroom check (the six requests need 13 pages
#: at their ends, four at a time up to 10)
PAGED = dict(batch=4, n_pages=9, prefill_chunk=256)
N_STACK = 9                                         # shared-attn applications
#: kernel checks: lengths across the 128-position split boundaries, and
#: (third) rows of 3 to 10 splits
PAGED_LENGTHS = ((1, 127, 128, 129), (1000, 128, 129, 1),
                 (1100, 1023, 257, 384))
SPEC_K = 3                                          # drafts per verify step
KQ = SPEC_K + 1                                     # verify positions
#: verify-kernel checks: lengths count the Kq appended rows and straddle a
#: split boundary (row j sees len - (Kq - 1 - j) positions); at Kq = 4,
#: 129, 131, 1025 and 1154 end row 0 one split before row 3 (a split fully
#: masked for row 0), and the third case has rows of 5 to 10 splits
SPEC_LENGTHS = ((4, 127, 128, 129), (1000, 131, 129, 5),
                (1025, 1154, 640, 8))
#: deepseek-v2-236b: depth cut to its dense prelude layer + 3 MoE groups,
#: the most of the 60 layers that fits one 80 GB card with room for prefill
DS_LAYERS = 4
DS_REDUCED = "n_layers 60 -> 4 (53.2 GB fp32 of 80 GB)"
DS_PROMPT_LENS = (64, 400, 133, 251, 97)
DS_MAX_NEW = 16
DS_PAGED = dict(batch=4, n_pages=9, prefill_chunk=256)
#: the MLA latent cache: one kv head of kv_lora + rope = 576 lanes, values
#: its first 512, 128 query heads; 3 MoE groups share the pattern position
MLA = dict(B=4, H=128, dk=576, dv=512, n_stack=3)
#: MLA kernel checks: across the 64-position split and page boundaries;
#: the third case spans 2 to 18 splits (9 pages), and at Kq = 4 the last
#: split of 65 and of 193 is fully masked for verify rows 0 to 2
MLA_LENGTHS = ((4, 127, 128, 129), (1000, 131, 129, 5), (1100, 65, 193, 4))
#: the fused quantize-and-append's value magnitudes: at 1e-37 the
#: groups' scales are subnormal, at 1e35 near the top exponent
APPEND_MAGS = (1.0, 1e-3, SU_TINY, 1e35)
#: kernel 1 at the GLA family's heads: (arch, (B, H, dv, dk), scalar decay)
GLA_SU = (("gla-2.7b", (4, 4, 640, 320), False),
          ("retnet-2.7b", (4, 10, 512, 256), True),
          ("hgrn2-2.7b", (4, 20, 128, 128), False))
#: kernel 7's checks: the GLA family's prefill states at batch 1 and 4,
#: zamba2's K and deepseek's latent at their prefill shapes, the JAX kernel
#: test's shapes, and one tensor of 67M values
QUANT_SHAPES = (tuple((b,) + shape[1:] for _, shape, _ in GLA_SU
                      for b in (1, 4))
                + ((4, 1024, 32, 80), (4, 512, 1, 576), (16, 64), (300, 128),
                   (5, 7, 32), (4096, 16384)))
#: kernel 1 at xlstm-1.3b's mLSTM heads: (B, H, dv_aug, dk), dv_aug = dv +
#: 16 (the normalizer row and 15 zero rows), scalar decay; kernel 7 at its
#: prefill states, one request and four; 12 new tokens a request keep
#: phases 38-42 near 90 s (a 48-layer step is host-bound at 50-100 ms)
XLSTM_SU = (4, 4, 1040, 1024)
XLSTM_K7 = ((1, 4, 1040, 1024), (4, 4, 1040, 1024))
XLSTM_MAX_NEW = 12
#: its paged pool prefills each prompt whole (a 400-token tail streamed
#: through verify steps would cost ~150 of them); 8 usable pages of 0 bytes
#: (no KV) still admit by page count, so FCFS may preempt
XLSTM_PAGED = dict(batch=4, n_pages=9, prefill_chunk=512)
#: the GLA family's kernels-vs-plain difference at each depth, at most
#: this many times that of the plain ops with one layer's y moved one ulp
#: (the H100 read 0.08-2.2 times at 1-32 layer groups)
CONTROL_FACTOR = 4
#: retnet-2.7b / hgrn2-2.7b: a few requests through the paged pool
OTHER_MAX_NEW = 8
#: the slot paths' decode profiles before the fused dense append, when the
#: slot pool quantized its appends eagerly: device busy ms and device
#: operations a step (PERF.md section 5; an H100 80GB HBM3 at 700 W)
EAGER_APPEND_PROFILE = {"zamba2-2.7b": (19.484, 4673),
                     "deepseek-v2-236b": (27.336, 857),
                     "gla-2.7b": (10.696, 1512), "opt-6.7b": (30.158, 7020),
                     "yi-9b": (41.892, 11478)}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(n, name, **fields):
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{n}] {name}: {body}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_loop_ms(fn, n, warmup=3):
    """Per-call time of ``fn`` issued from a Python loop, CUDA events around
    the loop: what a caller that launches from Python sees (host overhead
    included when it exceeds the device time)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(calls, replays):
    """Per-call device time: ``calls`` captured once into a CUDA graph,
    replayed ``replays`` times between CUDA events, so no host overhead
    sits between launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    phase(1, "device", card=repr(smi), torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count(),
          allow_tf32="False(matmul,cudnn)")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build(_build.SOURCES)
    dt = time.perf_counter() - t0
    for name, path in paths.items():
        report = _build.PTXAS_REPORT.get(name, "(cached build)")
        usage = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
        phase(2, f"build {name}", lib=path.name,
              ptxas=repr(" | ".join(usage)))
    phase(2, "build", seconds=f"{dt:.2f}", parallel_nvcc=len(paths))


def phase_exact_pow2():
    import torch
    from repro_torch.core import formats as F
    e = torch.arange(-140, 128, device="cuda")
    want = torch.ldexp(torch.ones_like(e, dtype=torch.float64), e)
    got = F.exact_pow2(e).double()
    check(torch.equal(got, want), "bit-built powers of two are not exact")
    ex = torch.exp2(e.float()).double()
    phase(3, "exact powers of two", range="[-140,127]", bit_built="exact",
          torch_exp2_inexact=int((ex != want).sum()))


def _mlstm_like(S, d, k, v, g, mag):
    """Reshape a kernel-1 case into the mLSTM's, in place: state row dv - 16
    is the normalizer n (grown by exp(i) k each step: here 8 to ~50 times
    the state's magnitude), rows past it are zero; v is ``[v, 1, 0 x
    15]`` (the one scaled as v is at SU_TINY); k carries the input gate
    exp(i), i in [-12, 4] per head; the forget gate is open (sigmoid(x +
    3))."""
    import torch
    n = S.shape[-2] - 16
    S[..., n, :] = (S[..., n, :].abs() + mag) * 8.0
    S[..., n + 1:, :] = 0.0
    v[..., n] = mag if mag <= SU_TINY else 1.0
    v[..., n + 1:] = 0.0
    k *= torch.exp(torch.rand(k.shape[:-1] + (1,), generator=g,
                              device="cuda") * 16.0 - 12.0)
    d.copy_(torch.sigmoid(torch.randn(d.shape, generator=g, device="cuda")
                          + 3.0))


def _su_case(shape, rounding, mag, scalar_decay, seed, mlstm=False):
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_state_update as KS
    B, H, dv, dk = shape[0], shape[1], shape[2], shape[3]
    g = torch.Generator(device="cuda").manual_seed(seed)
    S0 = torch.randn((B, H, dv, dk), generator=g, device="cuda") * mag
    d = torch.sigmoid(torch.randn((B, H, 1 if scalar_decay else dk),
                                  generator=g, device="cuda"))
    k = torch.randn((B, H, dk), generator=g, device="cuda")
    q = torch.randn((B, H, dk), generator=g, device="cuda")
    v = torch.randn((B, H, dv), generator=g, device="cuda")
    if mag <= SU_TINY:
        v *= mag
    if mlstm:
        _mlstm_like(S0, d, k, v, g, mag)
    qS = F.mx8_quantize(S0)
    qp, yp = KS.plain(qS.clone(), d, k, v, q, rounding=rounding, seed=seed)
    qk, yk = KS.mx_state_update(qS.clone(), d, k, v, q, seed=seed,
                                rounding=rounding)
    torch.cuda.synchronize()
    return _hold_su(f"state update {shape} {rounding}", qp.payload, yp,
                    qk.payload, yk)


def _hold_su(label, plain, yp, kern, yk):
    """The state-update contract, kernel against plain on the same inputs:
    exponent and micro bytes bitwise, mantissa within one step, ``y``
    bitwise on rows whose state matches (both sum in kernel 1's order).
    Returns (mantissa mismatches, values, max |y error|)."""
    import torch
    for f in ("exponent", "micro"):
        check(torch.equal(plain[f], kern[f]), f"{label}: {f} bytes differ")
    dm = (plain["mantissa"].int() - kern["mantissa"].int()).abs()
    check(int(dm.max()) <= 1, f"{label}: mantissa off by >1")
    diff = dm > 0
    ok = ~diff.any(-1)
    check(torch.equal(yk[ok], yp[ok]), f"{label}: y differs from the plain "
          f"version's where the state matches (max err "
          f"{float((yk[ok] - yp[ok]).abs().max()):.3g})")
    return int(diff.sum()), diff.numel(), float((yk - yp).abs().max())


def phase_state_update():
    mism = total = 0
    max_err = 0.0
    for shape in SU_SHAPES + (SU_ODD,):
        for rounding in ("stochastic", "nearest"):
            for mag, scalar in ((1.0, True), (1e-3, False), (SU_TINY, False),
                                (SU_TINY, True)):
                n_bad, n, err = _su_case(shape, rounding, mag, scalar,
                                         seed=shape[3] + int(mag * 10))
                mism, total, max_err = mism + n_bad, total + n, max(max_err,
                                                                   err)
    rate = mism / total
    check(rate <= 1e-5, f"state update mantissa mismatch rate {rate:.3g}")
    phase(4, "mx_state_update vs plain", shapes=list(SU_SHAPES + (SU_ODD,)),
          state_magnitudes=f"1,1e-3,{SU_TINY:g}",
          exp_micro="bitwise", mantissa_mismatch=f"{mism}/{total}",
          rate=f"{rate:.3g}", y_max_abs_err=f"{max_err:.3g}")
    return max_err


def _attn_inputs(lengths, seed=0):
    import torch
    from repro_torch.core import formats as F
    a = ATTN
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((a["B"], a["H"], a["d"]), generator=g, device="cuda")
    shp = (a["B"], a["T"], a["KVH"], a["d"])
    K = F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
    V = F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, K, V, lens


def phase_attention():
    import torch
    from repro_torch.kernels import mx_attention as KA
    max_err = 0.0
    for lengths in ((64, 333, 700, 1024), (1, 129, 128, 1000)):
        q, K, V, lens = _attn_inputs(lengths, seed=lengths[1])
        yk = KA.mx_attention_decode(q, K, V, lens)
        yp = KA.plain(q, K, V, lens)
        torch.cuda.synchronize()
        err = (yk - yp).abs()
        check(bool((err <= 2e-5 + 2e-4 * yp.abs()).all()),
              f"attention {lengths}: beyond rtol 2e-4 atol 2e-5 "
              f"(max err {float(err.max()):.3g})")
        max_err = max(max_err, float(err.max()))
    phase(5, "mx_attention_decode vs plain", B=ATTN["B"], T=ATTN["T"],
          H=ATTN["H"], KVH=ATTN["KVH"], d=ATTN["d"],
          ragged="(64,333,700,1024),(1,129,128,1000)",
          max_abs_err=f"{max_err:.3g}", tol="rtol2e-4,atol2e-5")
    return max_err


def _report(name, ms, plain_ms, lib_ms, host_ms, nbytes, flops,
            logical_bytes, n=6, tc_flops=None):
    """Print one kernel's times beside its bound and return the kernels
    line's fields.  The bound is the larger of the bytes over the HBM rate
    and the operations over the peak of their type: fp32 for a kernel that
    computes in fp32 units; for one whose products run on the tensor cores
    (``tc_flops``, bf16 products with their terms counted), that design's
    own bound, with the fp32 bound printed beside it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_fp32 = flops / PEAK_FP32_FLOPS * 1e3
    t_ops = t_fp32 if tc_flops is None else \
        tc_flops / PEAK_BF16_TC_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    extra = {} if tc_flops is None else dict(
        fp32_bound_ms=f"{max(t_bytes, t_fp32):.5f}",
        share_of_fp32_bound=f"{max(t_bytes, t_fp32) / ms:.3f}",
        tc_flops=int(tc_flops), share_of_bound=f"{bound / ms:.3f}")
    phase(n, f"time {name}", ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms="null" if lib_ms is None else f"{lib_ms:.5f}",
          host_loop_ms=f"{host_ms:.5f}", bound_ms=f"{bound:.5f}",
          bound_by=by, **extra, bytes=int(nbytes),
          traffic_plan_bytes=int(logical_bytes),
          GBps=f"{nbytes / ms / 1e6:.1f}",
          share_of_3p35TBps=f"{t_bytes / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by)


def phase_timing():
    """Device times from CUDA-graph replay (kernel, plain version, library
    yardstick), inputs cold in L2, plus the kernel's time when launched
    from a Python loop."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_state_update as KS

    # -- state update at the zamba2 shape; 54 layer states (80 MB) rotate,
    # as one decode step walks 54 layers, so each launch finds its state
    # cold in the 50 MB L2
    B, H, dv, dk = SU_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    states = [F.mx8_quantize(torch.randn((B, H, dv, dk), generator=g,
                                         device="cuda")) for _ in range(54)]
    d = torch.sigmoid(torch.randn((B, H, 1), generator=g, device="cuda"))
    k, q = (torch.randn((B, H, dk), generator=g, device="cuda") for _ in "kq")
    v = torch.randn((B, H, dv), generator=g, device="cuda")
    kern = [lambda i=i: KS.mx_state_update(states[i], d, k, v, q, seed=i)
            for i in range(54)]
    plain = [lambda i=i: KS.plain(states[i], d, k, v, q, seed=i)
             for i in range(9)]
    it = iter(range(10 ** 9))
    ms = graph_ms(kern, 20)
    plain_ms = graph_ms(plain, 5)
    host_ms = host_loop_ms(lambda: kern[next(it) % 54](), 540)
    n_val = B * H * dv * dk
    payload = n_val * (1 + 2 / F.MX8_GROUP)   # int8 + exponent + micro
    operands = 4 * (B * H * (1 + 2 * dk + dv) + B * H * dv)
    plan = OPS.plan_state_update_dims(B, H, dk, dv, OPS.StateQuantConfig())
    su = _report("mx_state_update", ms, plain_ms, None, host_ms,
                 2 * payload + operands, 10 * n_val,
                 OPS.traffic(plan).total)

    # -- attention at the main path's mid-decode lengths; 9 caches
    # (212 MB, one per shared-attention application) rotate
    a = ATTN
    lengths = [n + MAX_NEW // 2 for n in PROMPT_LENS[:a["B"]]]
    caches = [_attn_inputs(lengths, seed=s) for s in range(9)]
    kern2 = [lambda c=c: KA.mx_attention_decode(*c) for c in caches]
    plain2 = [lambda c=c: KA.plain(*c) for c in caches]
    # yardstick: one SDPA call on the dequantized fp32 K/V (never used by
    # the port)
    lib = []
    for qq, K, V, lens in caches:
        kf = F.dequantize(K).permute(0, 2, 1, 3).contiguous()
        vf = F.dequantize(V).permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(a["T"], device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        lib.append(lambda t=(qq[:, :, None, :], kf, vf, mask):
                   torch.nn.functional.scaled_dot_product_attention(
                       t[0], t[1], t[2], attn_mask=t[3]))
    ms2 = graph_ms(kern2, 30)
    plain2_ms = graph_ms(plain2, 3)
    lib_ms = graph_ms(lib, 30)
    host2_ms = host_loop_ms(lambda: kern2[next(it) % 9](), 270)
    valid = sum(lengths)
    d_ = a["d"]
    nbytes = (valid * a["KVH"] * 2 * d_ * (1 + 2 / F.MX8_GROUP)
              + 4 * a["B"] * a["H"] * 2 * d_ + 4 * a["B"])
    flops = valid * a["H"] * 4 * d_
    plan = OPS.plan_attn_decode_dims(
        dict(B=1, T=1, KVH=a["KVH"], dk=d_, dv=d_, H=a["H"]),
        OPS.StateQuantConfig())
    at = _report("mx_attention_decode", ms2, plain2_ms, lib_ms, host2_ms,
                 nbytes, flops, OPS.traffic(plan).state_read * valid)
    return su, at


# ---------------------------------------------------------------------------
# the paged kernels (paged attention, paged append, slab-mode state update)
# ---------------------------------------------------------------------------

def _paged_kv(lengths, seed, spare=2):
    """Page pools (P, N_STACK, 128, KVH, d) of random MX8 K/V, and a block
    table of shuffled, non-contiguous page ids covering ``len + 1``
    positions per row (the append slot included), bucketed to a power of
    two with scratch page 0 in its tail."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    from repro_torch.serving.memory import bucket_pages
    a = ATTN
    need = [pages_for(n + 1) for n in lengths]
    P = 1 + sum(need) + spare
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = (torch.randperm(P - 1, generator=g, device="cuda") + 1).tolist()
    bt = torch.zeros((len(lengths), bucket_pages(max(need))),
                     dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n])
        ids = ids[n:]
    shp = (P, N_STACK, 128, a["KVH"], a["d"])
    K = F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
    V = F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
    q = torch.randn((len(lengths), a["H"], a["d"]), generator=g,
                    device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, K, V, bt.cuda(), lens


def _append_rows(B, seed):
    """One token's K and V rows quantized as the paged append op does (SR
    seeds ``seed`` / ``seed + 1``): six payload rows (B, KVH, w), K then V,
    fields sorted."""
    import torch
    from repro_torch.core import formats as F
    a = ATTN
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for s in (seed, seed + 1):
        x = torch.randn((B, 1, a["KVH"], a["d"]), generator=g, device="cuda")
        qx = F.quantize(x, "mx8", "stochastic",
                        F.sr_bits(x.shape, s, device="cuda"))
        rows += [qx.payload[f][:, 0] for f in sorted(qx.payload)]
    return rows


def _payload_pools(K, V):
    return ([K.payload[f] for f in sorted(K.payload)]
            + [V.payload[f] for f in sorted(V.payload)])


def _new_rows(B, KVH, d, n, seed, mag=1.0):
    """The new token's fp32 rows (B, 1, KVH, d) of ``n`` streams at
    magnitude ``mag``, every fifth 16-value group zero."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = [torch.randn((B, 1, KVH, d), generator=g, device="cuda") * mag
            for _ in range(n)]
    rows[0].view(-1, 16)[::5] = 0.0
    return rows


def _replaced_append(pools, rows, bt, group, lens, seed,
                     rounding="stochastic"):
    """The path the fused launch replaced on the card: each stream
    quantized eagerly (``F.sr_bits`` + ``F.quantize``, seed ``seed + i``),
    then the copy kernel over the payload pools."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_paged_attention as KP
    payload, dst = [], []
    for i, (x, pool) in enumerate(zip(rows, pools)):
        bits = (F.sr_bits(x.shape, (seed + i) & 0xFFFFFFFF, device="cuda")
                if rounding == "stochastic" else None)
        q = F.quantize(x, "mx8", rounding, bits)
        payload += [q.payload[f][:, 0] for f in sorted(q.payload)]
        dst += [pool.payload[f] for f in sorted(pool.payload)]
    KP.mx_paged_kv_append(dst, payload, bt, group, lens)


def _hold_append_quant(pools, bt, group, lengths, seed, label):
    """The fused quantize-and-append over ``pools`` (one MX8 page pool per
    stream) at every magnitude of APPEND_MAGS and both roundings: its
    mantissa, exponent and micro bytes bitwise its plain version's and the
    replaced path's, every byte outside the appended slots unchanged.
    Returns (cases, max byte difference)."""
    import torch
    from repro_torch.kernels import mx_paged_attention as KP
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    keep = torch.ones(pools[0].payload["mantissa"].shape[:3],
                      dtype=torch.bool, device="cuda")
    for b, n in enumerate(lengths):
        keep[bt[b, n // 128], group, n % 128] = False
    _, _, _, KVH, d = pools[0].payload["mantissa"].shape
    cases = worst = 0
    for mag, rounding in itertools.product(APPEND_MAGS,
                                           ("nearest", "stochastic")):
        rows = _new_rows(len(lengths), KVH, d, len(pools), seed + cases, mag)
        before = [p.clone() for p in pools]
        plain = [p.clone() for p in pools]
        replaced = [p.clone() for p in pools]
        KP.mx_paged_kv_append_quant(rows, pools, bt, group, lens, seed,
                                    rounding=rounding)
        KP.plain_append_quant(rows, plain, bt, group, lens, seed, rounding)
        _replaced_append(replaced, rows, bt, group, lens, seed, rounding)
        torch.cuda.synchronize()
        for i, (a, p, r, b0) in enumerate(zip(pools, plain, replaced,
                                              before)):
            for f in ("mantissa", "exponent", "micro"):
                x, y = a.payload[f], p.payload[f]
                worst = max(worst, int((x.int() - y.int()).abs().max()))
                where = f"{label} {lengths} magnitude {mag:g} {rounding}: " \
                        f"stream {i} {f}"
                check(torch.equal(x, y), f"{where} differs from the plain "
                      "version")
                check(torch.equal(x, r.payload[f]), f"{where} differs from "
                      "the replaced path (eager quantize + copy kernel)")
                check(torch.equal(x[keep], b0.payload[f][keep]),
                      f"{where} changed outside the appended slots")
        cases += 1
    return cases, worst


def _slab_case(shape, gen_seed, sr_seed, scalar_decay=True,
               rounding="stochastic", mag=1.0, mlstm=False):
    """Kernel 1 in slab mode on a (9, 6, H, dv, dk) pool of state values of
    magnitude ``mag`` (``mlstm``: shaped as :func:`_mlstm_like` does), rows
    of slabs (7, 2, 5, 3) at layer 4: bitwise dense mode on the gathered
    rows, every other slab row unchanged, and the state-update contract
    against the plain slab version.  Returns (mantissa mismatches, values,
    max |y error|)."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_state_update as KS
    B, H, dv, dk = shape
    g = torch.Generator(device="cuda").manual_seed(gen_seed)
    n_slabs, n_stack, group = 9, 6, 4
    S0 = torch.randn((n_slabs, n_stack, H, dv, dk), generator=g,
                     device="cuda") * mag
    slabs = torch.tensor([7, 2, 5, 3], dtype=torch.int32, device="cuda")
    d = torch.sigmoid(torch.randn((B, H, 1 if scalar_decay else dk),
                                  generator=g, device="cuda"))
    k, q = (torch.randn((B, H, dk), generator=g, device="cuda")
            for _ in "kq")
    v = torch.randn((B, H, dv), generator=g, device="cuda")
    if mag <= SU_TINY:
        v *= mag
    if mlstm:
        _mlstm_like(S0, d, k, v, g, mag)
    pool = F.mx8_quantize(S0)
    del S0
    idx = (slabs.long(), group)
    rows = F.QuantizedTensor("mx8", (B, H, dv, dk), {
        f: a[idx].clone() for f, a in pool.payload.items()})
    before = pool.clone()
    plain, yp = KS.plain_slab(pool.clone(), slabs, group, d, k, v, q,
                              seed=sr_seed, rounding=rounding)
    dense, yd = KS.mx_state_update(rows, d, k, v, q, seed=sr_seed,
                                   rounding=rounding)
    _, ys = KS.mx_state_update(pool, d, k, v, q, seed=sr_seed,
                               rounding=rounding, slabs=slabs, group=group)
    torch.cuda.synchronize()
    label = f"slab mode {(B, H, dv, dk)} {rounding}"
    check(torch.equal(ys, yd), f"{label}: y differs from dense mode on "
          "the gathered rows")
    keep = torch.ones((n_slabs, n_stack), dtype=torch.bool, device="cuda")
    keep[idx] = False
    for f, a in pool.payload.items():
        check(torch.equal(a[idx], dense.payload[f]),
              f"{label}: {f} differs from dense mode")
        check(torch.equal(a[keep], before.payload[f][keep]),
              f"{label}: {f} changed outside the owned slab rows")
    return _hold_su(f"{label} vs plain",
                    {f: a[idx] for f, a in plain.payload.items()}, yp,
                    {f: a[idx] for f, a in pool.payload.items()}, ys)


def phase_paged_kernels():
    """Kernel 3 against its plain version and bitwise against kernel 2 over
    the gathered pages; kernel 4 bitwise against its plain version with
    every other pool byte unchanged; kernel 1 in slab mode bitwise against
    dense mode on the gathered rows -- all at zamba2-2.7b shapes."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_state_update as KS
    from repro_torch.kernels import ref as R
    attn_err = append_err = quant_err = quant_cases = 0
    for i, lengths in enumerate(PAGED_LENGTHS):
        q, K, V, bt, lens = _paged_kv(lengths, seed=30 + i)
        group = 4 + i
        y3 = KP.mx_paged_attention_decode(q, K, V, bt, group, lens)
        yp = KP.plain(q, K, V, bt, group, lens)
        y2 = KA.mx_attention_decode(q, R.gather_pages(K, bt, group),
                                    R.gather_pages(V, bt, group), lens)
        torch.cuda.synchronize()
        err = (y3 - yp).abs()
        check(bool((err <= 2e-5 + 2e-4 * yp.abs()).all()),
              f"paged attention {lengths}: beyond rtol 2e-4 atol 2e-5 "
              f"(max err {float(err.max()):.3g})")
        check(torch.equal(y3, y2), f"paged attention {lengths}: not bitwise "
              f"equal to the dense kernel over the gathered pages")
        attn_err = max(attn_err, float(err.max()))

        pools = _payload_pools(K, V)
        rows = _append_rows(len(lengths), seed=40 + i)
        before = [p.clone() for p in pools]
        plain_pools = [p.clone() for p in pools]
        KP.mx_paged_kv_append(pools, rows, bt, group, lens)
        KP.plain_append(plain_pools, rows, bt, group, lens)
        torch.cuda.synchronize()
        for j, (a, b) in enumerate(zip(pools, plain_pools)):
            append_err = max(append_err, int((a.int() - b.int()).abs().max()))
            check(torch.equal(a, b), f"paged append {lengths}: pool {j} "
                  "differs from the plain version")
        keep = torch.ones(pools[0].shape[:3], dtype=torch.bool,
                          device="cuda")
        for b, n in enumerate(lengths):
            keep[bt[b, n // 128], group, n % 128] = False
        for j, (a, b) in enumerate(zip(pools, before)):
            check(torch.equal(a[keep], b[keep]), f"paged append {lengths}: "
                  f"pool {j} changed outside the appended slots")
        n, err = _hold_append_quant([K, V], bt, group, lengths,
                                    0xFFFFFFFF - i, "fused append")
        quant_cases, quant_err = quant_cases + n, max(quant_err, err)
    phase(9, "mx_paged_attention_decode vs plain and vs dense kernel",
          B=4, H=ATTN["H"], KVH=ATTN["KVH"], d=ATTN["d"], n_stack=N_STACK,
          lengths=list(PAGED_LENGTHS), max_abs_err=f"{attn_err:.3g}",
          tol="rtol2e-4,atol2e-5", vs_dense_on_gathered_pages="bitwise")
    phase(9, "mx_paged_kv_append vs plain", pools=6, result="bitwise",
          max_abs_err=append_err, untouched_bytes="unchanged")
    phase(9, "mx_paged_kv_append_quant vs plain and vs the replaced path "
          "(eager quantize + copy kernel)", streams=2, pools=6,
          KVH=ATTN["KVH"], d=ATTN["d"], lengths=list(PAGED_LENGTHS),
          magnitudes=",".join(f"{m:g}" for m in APPEND_MAGS),
          roundings="nearest,stochastic", cases=quant_cases,
          fields="mantissa,exponent,micro", result="bitwise",
          max_abs_err=quant_err, untouched_bytes="unchanged")

    mism = total = 0
    slab_err = 0.0
    for shape, mag in itertools.product(SU_SHAPES + (SU_ODD,),
                                        (1.0, SU_TINY)):
        n_bad, n, err = _slab_case(shape, gen_seed=shape[3], sr_seed=9,
                                   mag=mag)
        mism, total, slab_err = mism + n_bad, total + n, max(slab_err, err)
    rate = mism / total
    check(rate <= 1e-5, f"slab mode mantissa mismatch rate {rate:.3g}")
    phase(9, "mx_state_update slab mode vs dense mode and vs plain",
          shapes=list(SU_SHAPES + (SU_ODD,)),
          state_magnitudes=f"1,{SU_TINY:g}", vs_dense="bitwise (state and y)",
          untouched_slabs="unchanged", vs_plain_exp_micro="bitwise",
          vs_plain_mantissa_mismatch=f"{mism}/{total}",
          y_max_abs_err=f"{slab_err:.3g}")
    return attn_err, float(append_err), float(quant_err), slab_err


def _spec_kv(lengths, G, seed, spare=2):
    """Kernel-5 inputs at zamba2-2.7b widths with G query heads per kv
    head (H = 32, KVH = 32 / G, d = 80): page pools of N_STACK layers, a
    block table of shuffled non-contiguous page ids spanning each row's
    ``len`` positions, and q ``(B, KQ, H, d)``."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    from repro_torch.serving.memory import bucket_pages
    H, d, KVH = ATTN["H"], ATTN["d"], ATTN["H"] // G
    need = [pages_for(n) for n in lengths]
    P = 1 + sum(need) + spare
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = (torch.randperm(P - 1, generator=g, device="cuda") + 1).tolist()
    bt = torch.zeros((len(lengths), bucket_pages(max(need))),
                     dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n])
        ids = ids[n:]
    shp = (P, N_STACK, 128, KVH, d)
    K = F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
    V = F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
    q = torch.randn((len(lengths), KQ, H, d), generator=g, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, K, V, bt.cuda(), lens


def phase_spec_kernels():
    """Kernels 6 (dense) and 5 (paged) against their plain versions; kernel
    5 bitwise kernel 6 over the gathered pages; verify row j bitwise
    kernels 2 and 3 at length len - (Kq - 1 - j) -- at Kq 1, 2 and 4, G 1
    and 4, lengths straddling a split boundary, rows of up to 10 splits, 9
    layers, shuffled pages."""
    import torch
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    err5 = err6 = 0.0
    cases = 0
    for G in (1, 4):
        for i, lengths in enumerate(SPEC_LENGTHS):
            q_all, K, V, bt, lens = _spec_kv(lengths, G, seed=80 + 10 * G + i)
            group = 3 + i
            Kd, Vd = R.gather_pages(K, bt, group), R.gather_pages(V, bt, group)
            for Kq in (1, 2, 4):
                q = q_all[:, :Kq].contiguous()
                label = f"Kq={Kq} G={G} lengths={lengths}"
                y5 = KV.mx_paged_spec_attention_decode(q, K, V, bt, group,
                                                       lens)
                y6 = KV.mx_spec_attention_decode(q, Kd, Vd, lens)
                p5 = KV.plain_paged(q, K, V, bt, group, lens)
                p6 = KV.plain(q, Kd, Vd, lens)
                torch.cuda.synchronize()
                for name, y, yp in (("kernel 5", y5, p5), ("kernel 6", y6,
                                                          p6)):
                    err = (y - yp).abs()
                    check(bool((err <= 2e-5 + 2e-4 * yp.abs()).all()),
                          f"{name} {label}: beyond rtol 2e-4 atol 2e-5 (max "
                          f"err {float(err.max()):.3g})")
                err5 = max(err5, float((y5 - p5).abs().max()))
                err6 = max(err6, float((y6 - p6).abs().max()))
                check(torch.equal(y5, y6), f"{label}: kernel 5 not bitwise "
                      "kernel 6 over the gathered pages")
                for j in range(Kq):
                    lj = lens - (Kq - 1 - j)
                    qj = q[:, j].contiguous()
                    check(torch.equal(y6[:, j], KA.mx_attention_decode(
                        qj, Kd, Vd, lj)), f"{label}: row {j} not bitwise "
                        "kernel 2 at the shifted length")
                    check(torch.equal(y5[:, j], KP.mx_paged_attention_decode(
                        qj, K, V, bt, group, lj)), f"{label}: row {j} not "
                        "bitwise kernel 3 at the shifted length")
                cases += 1
    app = _spec_appends_check()
    # Kq = 5, G = 4: 20 query rows a kv head, past one block's 16 -- two
    # row blocks of whole positions (12 and 8 rows)
    q, K, V, bt, lens = _spec_kv((130, 5), 4, seed=99)
    q5 = torch.cat([q, q[:, :1]], 1).contiguous()
    err20 = _within(KV.mx_paged_spec_attention_decode(q5, K, V, bt, 0, lens),
                    KV.plain_paged(q5, K, V, bt, 0, lens),
                    "kernel 5 at Kq*G = 20")
    phase(12, "mx_spec_attention_decode / mx_paged_spec_attention_decode "
          "vs plain", cases=cases, Kq="1,2,4", G="1,4", H=ATTN["H"],
          d=ATTN["d"], n_stack=N_STACK, lengths=list(SPEC_LENGTHS),
          max_abs_err_5=f"{err5:.3g}", max_abs_err_6=f"{err6:.3g}",
          tol="rtol2e-4,atol2e-5", paged_vs_dense="bitwise",
          row_j_vs_kernels_2_and_3="bitwise",
          Kq_times_G_20=f"two row blocks, max err {err20:.3g}")
    phase(12, "attention_spec_step appends vs sequential kv_append",
          Kq=KQ, lengths=app, result="bitwise (every pool byte)",
          verify_vs_spec_attend="bitwise")
    return err5, err6


def _spec_appends_check():
    """``attention_spec_step`` on a paged cache (CUDA kernels): its KQ
    appends, seeds seed + i, equal KQ sequential ``kv_append`` calls byte
    for byte over every pool (so no byte outside the appended slots moves),
    and its verify output is ``spec_attend`` over the appended cache."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import paged as PG
    a = ATTN
    base = (1, 124, 125, 1000)                      # crosses page boundaries
    q, K, V, bt, _ = _spec_kv([n + KQ for n in base], 1, seed=97)
    lens = torch.tensor(base, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(98)
    k_new, v_new = (torch.randn((len(base), KQ, a["KVH"], a["d"]),
                                generator=g, device="cuda") for _ in "kv")
    cfg = OPS.StateQuantConfig()
    caches = [PG.PagedKVCache(K.clone(), V.clone(), bt, lens, 5, "mx8")
              for _ in range(2)]
    y, c = OPS.attention_spec_step(caches[0], k_new, v_new, q, cfg,
                                   seed=0xFFFFFFFE)
    seq = caches[1]
    for i in range(KQ):
        seq = OPS.kv_append(seq, k_new[:, i:i + 1].contiguous(),
                            v_new[:, i:i + 1].contiguous(), cfg,
                            seed=(0xFFFFFFFE + i) & 0xFFFFFFFF)
    y_seq = OPS.spec_attend(seq, q, cfg)
    torch.cuda.synchronize()
    check(torch.equal(c.lengths, seq.lengths), "append lengths differ")
    for f in K.payload:
        check(torch.equal(c.k.payload[f], seq.k.payload[f]) and
              torch.equal(c.v.payload[f], seq.v.payload[f]),
              f"attention_spec_step appends differ from sequential "
              f"kv_append ({f})")
    check(torch.equal(y, y_seq), "attention_spec_step verify differs from "
          "spec_attend over the same cache")
    return list(base)


def phase_paged_timing():
    """Device times of the paged kernels from CUDA-graph replay at the main
    path's shapes, pools larger than the 50 MB L2."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_state_update as KS
    from repro_torch.kernels import ref as R
    a = ATTN
    it = iter(range(10 ** 9))

    # -- paged attention at the main path's mid-decode lengths, the 9
    # shared-attention layers' pages (73 MB) rotating
    lengths = [n + MAX_NEW // 2 for n in PROMPT_LENS[:a["B"]]]
    q, K, V, bt, lens = _paged_kv(lengths, seed=50, spare=0)
    kern = [lambda g=g: KP.mx_paged_attention_decode(q, K, V, bt, g, lens)
            for g in range(N_STACK)]
    plain = [lambda g=g: KP.plain(q, K, V, bt, g, lens)
             for g in range(N_STACK)]
    lib = []
    T = bt.shape[1] * 128
    mask = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    for g in range(N_STACK):
        kf = F.dequantize(R.gather_pages(K, bt, g)).permute(0, 2, 1, 3
                                                            ).contiguous()
        vf = F.dequantize(R.gather_pages(V, bt, g)).permute(0, 2, 1, 3
                                                            ).contiguous()
        lib.append(lambda t=(q[:, :, None, :], kf, vf):
                   torch.nn.functional.scaled_dot_product_attention(
                       t[0], t[1], t[2], attn_mask=mask))
    ms = graph_ms(kern, 30)
    plain_ms = graph_ms(plain, 3)
    lib_ms = graph_ms(lib, 30)
    host_ms = host_loop_ms(lambda: kern[next(it) % N_STACK](), 270)
    valid = sum(lengths)
    d_ = a["d"]
    npg_b = [pages_for(n) for n in lengths]
    nbytes = (valid * a["KVH"] * 2 * d_ * (1 + 2 / F.MX8_GROUP)
              + 4 * a["B"] * a["H"] * 2 * d_ + 4 * a["B"] + 4 * sum(npg_b))
    # traffic(plan) streams whole pages: each row's pages, read once
    pa = _report("mx_paged_attention_decode", ms, plain_ms, lib_ms, host_ms,
                 nbytes, valid * a["H"] * 4 * d_,
                 sum(OPS.traffic(OPS.plan_attn_decode_dims(
                     dict(B=1, T=n, KVH=a["KVH"], dk=d_, dv=d_, H=a["H"]),
                     OPS.StateQuantConfig(), layout="paged")).state_read
                     for n in lengths), n=10)

    # -- paged append: one launch writes the six payload pools' slots; the
    # library yardstick is the six index_put_ calls writing the same slots
    pools = _payload_pools(K, V)
    rows = _append_rows(a["B"], seed=60)
    kern = [lambda g=g: KP.mx_paged_kv_append(pools, rows, bt, g, lens)
            for g in range(N_STACK)]
    plain = [lambda g=g: KP.plain_append(pools, rows, bt, g, lens)
             for g in range(N_STACK)]
    page = bt.long()[torch.arange(a["B"], device="cuda"),
                     lens.long() // 128]
    off = lens.long() % 128
    lib = []
    for g in range(N_STACK):
        gi = torch.full_like(page, g)
        lib.append(lambda gi=gi: [p.index_put_((page, gi, off), r)
                                  for p, r in zip(pools, rows)])
    ms = graph_ms(kern, 50)
    plain_ms = graph_ms(plain, 10)
    lib_ms = graph_ms(lib, 50)
    host_ms = host_loop_ms(lambda: kern[next(it) % N_STACK](), 270)
    row_bytes = sum(r.numel() for r in rows)           # 1-byte payloads
    nbytes = 2 * row_bytes + 4 * a["B"] * 2             # rows in, slots out
    plan = OPS.registry.plan("kv_append", dict(B=a["B"], T=1, KVH=a["KVH"],
                                               dk=d_, dv=d_, n=1),
                             OPS.StateQuantConfig(), "cuda", layout="paged")
    ap = _report("mx_paged_kv_append", ms, plain_ms, lib_ms, host_ms,
                 nbytes, 0, OPS.traffic(plan).total, n=10)

    # -- the fused quantize-and-append the paged steps launch, beside its
    # plain version and the path it replaced (eager quantize + copy)
    apq = _time_append_quant([K, V], bt, lens, N_STACK,
                             "mx_paged_kv_append[quant]", OPS.traffic(
                                 plan).total, n=10)

    # -- the state update in slab mode: the six pattern positions' slab
    # pools (9 slabs x 9 layers each), 54 launches over 4 owned slabs
    B, H, dv, dk = SU_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(70)
    spools = [F.mx8_quantize(torch.randn((9, N_STACK, H, dv, dk),
                                         generator=g, device="cuda"))
              for _ in range(6)]
    slabs = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    d = torch.sigmoid(torch.randn((B, H, 1), generator=g, device="cuda"))
    k, qq = (torch.randn((B, H, dk), generator=g, device="cuda")
             for _ in "kq")
    v = torch.randn((B, H, dv), generator=g, device="cuda")
    kern = [lambda p=p, l=l: KS.mx_state_update(
        spools[p], d, k, v, qq, seed=l, slabs=slabs, group=l)
        for p in range(6) for l in range(N_STACK)]
    plain = [lambda l=l: KS.plain_slab(spools[0], slabs, l, d, k, v, qq,
                                       seed=l) for l in range(N_STACK)]
    ms = graph_ms(kern, 20)
    plain_ms = graph_ms(plain, 5)
    host_ms = host_loop_ms(lambda: kern[next(it) % 54](), 540)
    n_val = B * H * dv * dk
    payload = n_val * (1 + 2 / F.MX8_GROUP)
    operands = 4 * (B * H * (1 + 2 * dk + dv) + B * H * dv) + 4 * B
    plan = OPS.plan_state_update_dims(B, H, dk, dv, OPS.StateQuantConfig(),
                                      layout="paged")
    su = _report("mx_state_update[slab]", ms, plain_ms, None, host_ms,
                 2 * payload + operands, 10 * n_val, OPS.traffic(plan).total,
                 n=10)
    return pa, ap, apq, su


def _time_append_quant(pools, bt, lens, n_stack, name, plan_bytes, n):
    """Device times, by CUDA-graph replay over the ``n_stack`` layers of
    ``pools``, of the fused quantize-and-append, its plain version and the
    replaced path (eager quantize + copy kernel); the host time of one
    launch, and of one ``OPS.kv_append`` call (cuda backend, paged: the
    fused launch) against the replaced path's calls issued from Python.
    Bound: bytes, each fp32 row read once and its MX8 payload written
    once, plus ``lengths`` and the block-table entry of each row.  No
    single PyTorch call quantizes to MX8: the library time is null."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import formats as F
    from repro_torch.core import paged as PG
    from repro_torch.kernels import mx_paged_attention as KP
    B = bt.shape[0]
    _, _, _, KVH, d = pools[0].payload["mantissa"].shape
    rows = _new_rows(B, KVH, d, len(pools), seed=61)
    kern = [lambda g=g: KP.mx_paged_kv_append_quant(rows, pools, bt, g, lens,
                                                    g)
            for g in range(n_stack)]
    plain = [lambda g=g: KP.plain_append_quant(rows, pools, bt, g, lens, g)
             for g in range(n_stack)]
    replaced = [lambda g=g: _replaced_append(pools, rows, bt, g, lens, g)
                for g in range(n_stack)]
    it = iter(range(10 ** 9))
    ms = graph_ms(kern, 50)
    plain_ms = graph_ms(plain, 10)
    replaced_ms = graph_ms(replaced, 10)
    host_ms = host_loop_ms(lambda: kern[next(it) % n_stack](), 30 * n_stack)
    cache = PG.PagedKVCache(*pools, bt, lens, 1, "mx8") if len(pools) == 2 \
        else PG.PagedKVCache(pools[0], None, bt, lens, 1, "mx8", d - 64)
    cfg = OPS.StateQuantConfig()
    op_ms = host_loop_ms(lambda: OPS.kv_append(
        cache, rows[0], rows[1] if len(rows) == 2 else None, cfg, seed=3),
        30 * n_stack)
    replaced_host_ms = host_loop_ms(lambda: _replaced_append(
        pools, rows, bt, 1, lens, 3), 30 * n_stack)
    n_val = B * KVH * d * len(pools)
    nbytes = n_val * (4 + 1 + 2 / F.MX8_GROUP) + 4 * B * 2
    out = _report(name, ms, plain_ms, None, host_ms, nbytes, 5 * n_val,
                  plan_bytes, n=n)
    phase(n, f"{name} vs the replaced path", replaced_ms=f"{replaced_ms:.5f}",
          fused_faster=f"{replaced_ms / ms:.2f}x",
          host_kv_append_op_ms=f"{op_ms:.5f}",
          host_replaced_path_ms=f"{replaced_host_ms:.5f}",
          host_faster=f"{replaced_host_ms / op_ms:.2f}x")
    return out


def phase_spec_timing():
    """Device times of kernels 5 and 6 from CUDA-graph replay at the main
    path's mid-decode lengths with Kq = 4 (lengths count the appended
    rows), the 9 shared-attention layers' pages (and their gathered dense
    copies) rotating cold in L2; the yardstick is one
    ``scaled_dot_product_attention`` call with a boolean (B, H, Kq, T) mask
    over the gathered, dequantized fp32 K/V."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    a = ATTN
    it = iter(range(10 ** 9))
    lengths = [n + MAX_NEW // 2 + KQ for n in PROMPT_LENS[:a["B"]]]
    q, K, V, bt, lens = _spec_kv(lengths, 1, seed=90, spare=0)
    dense = [(R.gather_pages(K, bt, g), R.gather_pages(V, bt, g))
             for g in range(N_STACK)]
    T = bt.shape[1] * 128
    shift = torch.arange(KQ, device="cuda") - (KQ - 1)
    mask = (torch.arange(T, device="cuda")[None, None, :]
            < (lens[:, None] + shift[None, :])[:, :, None])[:, None]
    qh = q.permute(0, 2, 1, 3).contiguous()             # (B, H, Kq, d)
    lib = []
    for kd, vd in dense:
        kf = F.dequantize(kd).permute(0, 2, 1, 3).contiguous()
        vf = F.dequantize(vd).permute(0, 2, 1, 3).contiguous()
        lib.append(lambda t=(kf, vf):
                   torch.nn.functional.scaled_dot_product_attention(
                       qh, t[0], t[1], attn_mask=mask))
    # the yardstick computes the same function
    y_lib = lib[0]().permute(0, 2, 1, 3)
    y_k = KV.mx_spec_attention_decode(q, *dense[0], lens)
    torch.cuda.synchronize()
    check(bool(((y_lib - y_k).abs() <= 1e-4 + 1e-3 * y_k.abs()).all()),
          "verify yardstick (SDPA) disagrees with kernel 6")
    d_ = a["d"]
    row_pos = sum(n - (KQ - 1 - j) for n in lengths for j in range(KQ))
    flops = row_pos * a["H"] * 4 * d_
    io = 4 * a["B"] * KQ * a["H"] * 2 * d_ + 4 * a["B"]
    cache = sum(lengths) * a["KVH"] * 2 * d_ * (1 + 2 / F.MX8_GROUP)
    npg_b = [pages_for(n) for n in lengths]
    out = []
    for name, kern, plain, extra, layout in (
            ("mx_paged_spec_attention_decode",
             [lambda g=g: KV.mx_paged_spec_attention_decode(q, K, V, bt, g,
                                                            lens)
              for g in range(N_STACK)],
             [lambda g=g: KV.plain_paged(q, K, V, bt, g, lens)
              for g in range(N_STACK)], 4 * sum(npg_b), "paged"),
            ("mx_spec_attention_decode",
             [lambda c=c: KV.mx_spec_attention_decode(q, *c, lens)
              for c in dense],
             [lambda c=c: KV.plain(q, *c, lens) for c in dense], 0,
             "dense")):
        ms = graph_ms(kern, 30)
        plain_ms = graph_ms(plain, 3)
        lib_ms = graph_ms(lib, 30)
        host_ms = host_loop_ms(lambda k=kern: k[next(it) % N_STACK](), 270)
        plan_bytes = sum(OPS.traffic(OPS.registry.plan(
            "spec_verify", dict(B=1, T=n, KVH=a["KVH"], dk=d_, dv=d_, n=1,
                                H=a["H"], Kq=KQ), OPS.StateQuantConfig(),
            "cuda", layout=layout)).total for n in lengths)
        out.append(_report(name, ms, plain_ms, lib_ms, host_ms,
                           cache + io + extra, flops, plan_bytes, n=13))
    phase(13, "verify lengths", lengths=lengths, Kq=KQ,
          per_row_positions=row_pos)
    return out[0], out[1]


def _row_invariance(params, cfg):
    """Trouble spot of speculation on the card: a GEMM at M = B * Kq = 16
    rows need not round row i as at M = B = 4, so the verify step runs its
    dense products position by position on the plain step's (B, 1, d)
    input (``layers.per_position``).  Row i of ``(B, Kq, d) @ W`` against
    the contiguous ``(B, 1, d) @ W`` of position i, bitwise, at every
    weight shape of the model (fp32, TF32 off) -- what the per-position
    products are for -- and the RMSNorm reduction, which the verify step
    still runs over all Kq positions at once.  Returns {name: bool}."""
    import torch
    from repro_torch.models import layers as L
    g = torch.Generator(device="cuda").manual_seed(7)
    sh, m2 = params["shared"], params["groups"][0][0]["mixer"]
    weights = dict(wq=sh["attn"]["wq"], wk=sh["attn"]["wk"],
                   wv=sh["attn"]["wv"], wo=sh["attn"]["wo"],
                   ffn_wi=sh["ffn"]["wi"], ffn_wg=sh["ffn"]["wg"],
                   ffn_wo=sh["ffn"]["wo"], m2_wz=m2["wz"], m2_wx=m2["wx"],
                   m2_wbc=m2["wbc"], m2_wdt=m2["wdt"],
                   m2_out_proj=m2["out_proj"], lm_head=params["embed"].T
                   if cfg.tie_embeddings else params["lm_head"])
    out = {}
    B = ATTN["B"]
    for name, w in weights.items():
        x = torch.randn((B, KQ, w.shape[0]), generator=g, device="cuda")
        full = x @ w
        out[name] = all(torch.equal(full[:, i:i + 1],
                                    x[:, i:i + 1].contiguous() @ w)
                        for i in range(KQ))
    x = torch.randn((B, KQ, cfg.d_model), generator=g, device="cuda")
    full = L.apply_norm(params["final_norm"], x, "rmsnorm", cfg.norm_eps)
    out["rmsnorm"] = all(torch.equal(full[:, i:i + 1], L.apply_norm(
        params["final_norm"], x[:, i:i + 1].contiguous(), "rmsnorm",
        cfg.norm_eps)) for i in range(KQ))
    return out


def _agreement(ref, got):
    """Greedy token agreement of two stream sets: the share of positions
    equal before each request's first difference, and the earliest
    differing token index over requests (None when all equal)."""
    same = total = 0
    first = None
    for a, b in zip(ref, got):
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        same += k
        total += max(len(a), len(b))
        if k < max(len(a), len(b)):
            first = k if first is None else min(first, k)
    return same / max(total, 1), first


def _spec_rollback_check(eng, cfg, rng, invariant, lens0=(64, 129, 126,
                                                          200), phase_n=14):
    """The pool-level contract at full width, four active rows: one verify
    pass over KQ tokens against KQ sequential paged decode steps (seeds
    1..KQ), then ``commit_spec`` at all-accept, at sel = 0 and at a partial
    accept, sel = 1.  Always held: the state rows a commit restores are
    exactly the snapshot rows of the selected position, and the all-accept
    snapshot is the state the kernels left in place.  Held bitwise against
    the sequential steps (their logits, and at each sel the state after
    sel + 1 steps) when the verify step's remaining batched op (RMSNorm)
    is row invariant; otherwise the logits' largest difference and the
    argmax agreement are reported."""
    import numpy as np
    import torch
    from repro_torch.core.paged import pages_for
    from repro_torch.models import model as M
    pool, params = eng.engine.pool, eng.engine.params
    rids = [20_000 + i for i in range(len(lens0))]
    toks0 = []
    for rid, n in zip(rids, lens0):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                                 device="cuda")[None]
        logits, row = M.prefill(params, cfg, {"tokens": prompt})
        check(pool.register(rid, pages_for(n + KQ)), f"no pages for {rid}")
        toks0.append(int(logits[0].argmax()))
        pool.paging.insert_request(pool.pools, row, pool._ids(
            pool.page_table[rid][:pages_for(n)]), pool.slab_of[rid])
    snapshot = [p.clone() for p in pool.pools]
    slabs = [pool.slab_of[r] for r in rids]

    def slab_rows():
        return [p[slabs].clone() for p, sp in zip(pool.pools,
                                                  pool.paging.specs)
                if sp.kind == "slab"]

    L0 = np.array(lens0, np.int32)
    seq, seq_slabs, t = [], [], np.array(toks0)
    toks = [t]
    for i in range(KQ):
        lg = pool.decode(params, rids, t, L0 + i, seed=1 + i)
        seq.append(lg.clone())
        seq_slabs.append(slab_rows())
        t = lg.argmax(-1).cpu().numpy()
        toks.append(t)
    tokens = np.stack(toks[:KQ], axis=1)
    results = {}
    for sel in (KQ - 1, 0, 1):
        for p, s_ in zip(pool.pools, snapshot):
            p.copy_(s_)
        lg, snaps = pool.decode_spec(params, rids, tokens, L0, seed=1,
                                     min_pages=pages_for(int(L0.max()) + KQ))
        inplace = slab_rows()
        pool.commit_spec(rids, snaps, np.full(len(rids), sel))
        rolled = slab_rows()
        # the commit restores exactly the selected snapshot rows
        want = [snaps[sp.pos][sp.path][sel].to(p.dtype)
                for p, sp in zip(pool.pools, pool.paging.specs)
                if sp.kind == "slab"]
        check(all(torch.equal(a, b) for a, b in zip(rolled, want)),
              f"commit_spec(sel={sel}) did not restore the snapshot rows")
        if sel == KQ - 1:
            # the last snapshot is the state the step left in place
            check(all(torch.equal(a, b) for a, b in zip(inplace, rolled)),
                  "all-accept snapshot differs from the in-place state")
        results[sel] = (lg, rolled)
    lg = results[KQ - 1][0]
    diffs = [float((lg[:, i] - seq[i]).abs().max()) for i in range(KQ)]
    agree = float(np.mean([bool((lg[:, i].argmax(-1) == seq[i].argmax(-1)
                                 ).all()) for i in range(KQ)]))
    # each commit against the state after sel + 1 sequential steps
    rows_eq = {sel: all(torch.equal(a, b) for a, b in
                        zip(rolled, seq_slabs[sel]))
               for sel, (_, rolled) in results.items()}
    bitwise = all(torch.equal(lg[:, i], seq[i]) for i in range(KQ)) and all(
        rows_eq.values())
    for r in rids:
        pool.release(r)
    if invariant:
        check(bitwise, f"{cfg.name}: row-invariant {cfg.norm_kind}, yet "
              f"verify positions differ from sequential steps (max |dlogit| "
              f"{max(diffs):.3g}, committed rows equal by sel: {rows_eq})")
    phase(phase_n, "pool-level verify and rollback, full width",
          rows=len(rids),
          lengths=list(lens0), Kq=KQ, sels=sorted(results),
          commit_restores_snapshot="bitwise",
          all_accept_snapshot_vs_in_place="bitwise",
          vs_sequential_bitwise=bitwise, committed_rows_vs_sequential=rows_eq,
          max_abs_dlogit=f"{max(diffs):.3g}", argmax_agreement=f"{agree:.2f}")
    return bitwise


def _payload_bytes(x):
    import torch
    from repro_torch.core import formats as F
    if isinstance(x, F.QuantizedTensor):
        return sum(a.numel() * a.element_size() for a in x.payload.values())
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_payload_bytes(v) for v in x.values())
    return 0


def _model():
    """zamba2-2.7b at full width with random weights from a seeded CUDA
    generator, shared by both main paths."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("zamba2-2.7b")
    check(cfg.n_layers == 54 and cfg.d_model == 2560 and
          cfg.state_quant.fmt == "mx8" and cfg.state_quant.backend == "cuda",
          f"unexpected config {cfg.name}")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_model(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def _step_fields(st):
    return dict(tokens_per_s=f"{st['tokens_per_s']:.2f}",
                p50_step_ms=f"{st['p50_step_s'] * 1e3:.3f}",
                p99_step_ms=f"{st['p99_step_s'] * 1e3:.3f}",
                p50_ttft_ms=f"{st['p50_ttft_s'] * 1e3:.3f}")


def _check_done(handles, cfg, max_new=MAX_NEW):
    for h in handles:
        check(h.status == "done" and len(h.output) == max_new,
              f"request {h.rid}: {h.status} with {len(h.output)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in h.output),
              f"request {h.rid}: token out of range")


def phase_main_path(cfg, params, init_s):
    import numpy as np
    import torch
    from repro_torch.core import attention_cache as AC
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_quant as K7
    from repro_torch.kernels import mx_state_update as KS
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig

    n_params = sum(p.numel() for p in _leaves(params))
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(params, cfg, ServeConfig(backend="slots", batch=4,
                                          cache_capacity=1024))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    KS.mx_state_update.launches = 0
    KA.mx_attention_decode.launches = 0
    K7.mx_quantize.launches = 0
    K7.mx_kv_append_quant.launches = K7.mx_kv_append_quant.mla_launches = 0
    PLAIN_QUANT["calls"] = 0
    t1 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    n_su, n_at = KS.mx_state_update.launches, KA.mx_attention_decode.launches
    n_q = K7.mx_quantize.launches
    n_apd = K7.mx_kv_append_quant.launches
    n_plain_q = PLAIN_QUANT["calls"]
    steps = eng.engine.step_count
    _check_done(handles, cfg)
    check(steps > 0 and n_su == 54 * steps and n_at == 9 * steps
          and n_apd == 9 * steps and K7.mx_kv_append_quant.mla_launches == 0
          and n_q == _k7_per_prefill(cfg) * len(prompts),
          f"launches: state_update {n_su}, attention {n_at}, dense append "
          f"{n_apd} over {steps} decode steps (want 54x, 9x and 9x), "
          f"quantizer {n_q} over {len(prompts)} prefills (want "
          f"{_k7_per_prefill(cfg)}x)")
    check(n_plain_q == 0, f"the plain MX8 quantizer ran {n_plain_q} times "
          "on the card inside slot decode steps or prefills")
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    caches = eng.engine.caches
    kv_bytes = sum(_payload_bytes(c.k) + _payload_bytes(c.v)
                   for c in M.iter_kv_caches(caches))
    state_bytes = sum(_payload_bytes(c) for grp in caches for c in grp
                      if not isinstance(c, AC.KVCache))
    phase(7, "main path zamba2-2.7b slots", params=n_params,
          init_s=f"{init_s:.1f}", requests=len(handles), decode_steps=steps,
          launches=f"su={n_su},attn={n_at},dense_append={n_apd},quant={n_q}",
          plain_quantizer_calls_in_steps=n_plain_q, wall_s=f"{wall:.3f}",
          **_step_fields(st), peak_mem_GB=f"{peak / 1e9:.2f}",
          state_MB=f"{state_bytes / 1e6:.2f}", kv_MB=f"{kv_bytes / 1e6:.2f}")
    prof = _profile_decode(eng, cfg, rng, PROMPT_LENS[:4], 7,
                           before=EAGER_APPEND_PROFILE[cfg.name])
    _reference_check(params, cfg, prompts[0])
    return dict(n_su=n_su, n_at=n_at, n_apd=n_apd, stats=st, peak=peak,
                prof=prof)


def _paged_vs_gather(eng, cfg, rng, n_steps=4, lens0=(64, 129, 127, 200)):
    """One pool snapshot decoded ``n_steps`` steps twice, with
    ``decode_mode="gather"`` (dense kernels over gathered pages) and
    ``"paged"`` (the paged kernels in place); the logits of the four
    active rows must be bit-identical."""
    import numpy as np
    import torch
    from repro_torch.core.paged import pages_for
    from repro_torch.models import model as M
    pool, params = eng.engine.pool, eng.engine.params
    rids = [10_000 + i for i in range(len(lens0))]
    toks = []
    for rid, n in zip(rids, lens0):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                                 device="cuda")[None]
        logits, row = M.prefill(params, cfg, {"tokens": prompt})
        check(pool.register(rid, pages_for(n)), f"no pages for rid {rid}")
        pool.insert_prefill(rid, row)
        toks.append(int(logits[0].argmax()))
    snapshot = [p.clone() for p in pool.pools]
    tables = {r: list(pool.page_table[r]) for r in rids}
    runs = {}
    for mode in ("gather", "paged"):
        for p, s in zip(pool.pools, snapshot):
            p.copy_(s)
        for r in rids:
            grown = [p for p in pool.page_table[r] if p not in tables[r]]
            if grown:
                pool.placement.unref(grown)
            pool.page_table[r] = list(tables[r])
        pool.decode_mode = mode
        L, t, out = np.array(lens0, np.int32), np.array(toks), []
        for step in range(n_steps):
            for r, n in zip(rids, L):
                while n // 128 + 1 > len(pool.page_table[r]):
                    check(pool.grow(r, 1), f"no page to grow rid {r}")
            lg = pool.decode(params, rids, t, L, seed=1000 + step)
            out.append(lg.clone())
            t, L = lg.argmax(-1).cpu().numpy(), L + 1
        runs[mode] = out
    pool.decode_mode = "paged"
    for r in rids:
        pool.release(r)
    for step, (a, b) in enumerate(zip(runs["gather"], runs["paged"])):
        check(bool(torch.isfinite(b).all()), f"paged logits not finite "
              f"(step {step})")
        check(torch.equal(a, b), f"paged vs gather logits differ at step "
              f"{step} (max abs {float((a - b).abs().max()):.3g})")
    return runs["paged"][0].shape


def phase_paged_main_path(cfg, params, slot):
    """zamba2-2.7b at full width through ``Engine``'s default paged backend,
    a pool small enough that FCFS preempts; each decode step must launch
    the slab-mode state update 54 times and the paged attention and fused
    quantize-and-append kernels 9 times each, and the dense attention
    kernel, the copy append and the plain MX8 quantizer never."""
    import numpy as np
    import torch
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_quant as K7
    from repro_torch.kernels import mx_state_update as KS
    from repro_torch.serving.api import Engine, ServeConfig

    rng = np.random.default_rng(1)
    eng = Engine(params, cfg, ServeConfig(**PAGED))
    check(eng.backend == "paged", f"default backend {eng.backend}")
    shape = _paged_vs_gather(eng, cfg, rng)
    phase(11, "paged vs gather logits, fresh pool", steps=4,
          logits=tuple(shape), result="bit-identical")
    prompts = _pattern_prompts(rng, cfg)
    counters = (KS.mx_state_update, KP.mx_paged_attention_decode,
                KP.mx_paged_kv_append_quant, KP.mx_paged_kv_append,
                KA.mx_attention_decode, K7.mx_quantize)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    KS.mx_state_update.slab_launches = 0
    K7.mx_kv_append_quant.launches = K7.mx_kv_append_quant.mla_launches = 0
    PLAIN_QUANT["calls"] = 0
    t1 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    n_dense, n_pa, n_apq, n_ap, n_at, n_q = (c.launches for c in counters)
    n_su = KS.mx_state_update.slab_launches
    n_plain_q = PLAIN_QUANT["calls"]
    peak = torch.cuda.max_memory_allocated()
    steps = eng.engine.step_count
    _check_done(handles, cfg)
    st = eng.stats()
    check(st["preemptions"] >= 1, f"no preemption with {PAGED}")
    check(steps > 0 and n_su == 54 * steps and n_dense == 0
          and n_pa == 9 * steps and n_apq == 9 * steps and n_ap == 0
          and n_at == 0 and n_q == _k7_per_prefill(cfg) * len(prompts)
          and K7.mx_kv_append_quant.launches == 0,
          f"launches over {steps} decode steps: state_update slab mode "
          f"{n_su} (want 54x), dense mode {n_dense} (0), paged attention "
          f"{n_pa} (9x), fused append {n_apq} (9x), copy append {n_ap} "
          f"(0), dense attention {n_at} (0), dense append "
          f"{K7.mx_kv_append_quant.launches} (0); quantizer {n_q} over "
          f"{len(prompts)} prefills")
    check(n_plain_q == 0, f"the plain MX8 quantizer ran {n_plain_q} times "
          "on the card inside paged decode steps or prefills")
    pool = eng.engine.pool
    phase(11, "main path zamba2-2.7b paged", requests=len(handles),
          decode_steps=steps, launches=f"su_slab={n_su},su_dense={n_dense},"
          f"paged_attn={n_pa},fused_append={n_apq},copy_append={n_ap},"
          f"dense_attn={n_at},quant={n_q}",
          plain_quantizer_calls_in_decode=n_plain_q,
          wall_s=f"{wall:.3f}",
          **_step_fields(st), peak_mem_GB=f"{peak / 1e9:.2f}",
          preemptions=int(st["preemptions"]),
          pages=f"{pool.n_pages}x{pool.page_nbytes}B",
          page_MB=f"{pool.n_pages * pool.page_nbytes / 1e6:.2f}",
          slab_MB=f"{pool.n_slabs * pool.slab_nbytes / 1e6:.2f}",
          gather_MB=f"{st['gather_bytes'] / 1e6:.2f}",
          occupancy=f"{st['occupancy']:.3f}")
    prof = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 11)
    _paged_vs_gather(eng, cfg, rng)
    phase(11, "paged vs gather logits, after the run", steps=4,
          result="bit-identical")
    so = slot["stats"]
    phase(11, "paged vs slots (same run, same weights)",
          p50_step_ms=f"{st['p50_step_s'] * 1e3:.3f} vs "
          f"{so['p50_step_s'] * 1e3:.3f}",
          tokens_per_s=f"{st['tokens_per_s']:.2f} vs "
          f"{so['tokens_per_s']:.2f}",
          p50_ttft_ms=f"{st['p50_ttft_s'] * 1e3:.3f} vs "
          f"{so['p50_ttft_s'] * 1e3:.3f}",
          peak_mem_GB=f"{peak / 1e9:.2f} vs {slot['peak'] / 1e9:.2f}",
          idle_share=f"{prof['idle_share']:.3f} vs "
          f"{slot['prof']['idle_share']:.3f}")
    return dict(n_su=n_su, n_pa=n_pa, n_ap=n_ap, n_apq=n_apq,
                prompts=prompts,
                outputs=[h.output for h in handles], stats=st, peak=peak,
                steps=steps)


def _pattern_prompts(rng, cfg):
    """The paged main paths' prompts: PROMPT_LENS tokens each, a random
    8-token pattern repeated, so the n-gram draft source of phase 14 has
    earlier occurrences to propose from."""
    import numpy as np
    return [np.resize(rng.integers(0, cfg.vocab_size, 8), n)
            for n in PROMPT_LENS]


def phase_spec_main_path(cfg, params, paged):
    """zamba2-2.7b at full width through the paged ``Engine`` with n-gram
    speculation (``spec_k = 3``), on phase 11's prompts and weights.  Each
    verify step must launch the paged verify kernel 9 times, the fused
    append 9 * Kq times and the slab-mode state update 54 * Kq times, and
    kernels 2, 3 and 6, the copy append and the plain MX8 quantizer
    never.  Its greedy stream is compared with phase 11's, which
    drew other stochastic-rounding seeds (a plain step seeds with its step
    count, a verify pass with its own counter), so only agreement is
    reported.  Greedy exactness is held where it is defined: a plain run
    and speculative runs with both draft sources, all at round-to-nearest,
    equal when the verify step's remaining batched op (RMSNorm, its dense
    products run position by position) is row invariant; then the
    pool-level rollback check."""
    import numpy as np
    import torch
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_quant as K7
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import mx_state_update as KS
    from repro_torch.serving.api import Engine, ServeConfig

    rows = _row_invariance(params, cfg)
    invariant = rows["rmsnorm"]
    phase(12, "matmul row invariance, (B,Kq,d)@W rows vs (B,1,d)@W, fp32, "
          "TF32 off", B=ATTN["B"], Kq=KQ, all_equal=all(rows.values()),
          rows=repr({k: int(v) for k, v in rows.items()}),
          verify_products="per position",
          remaining_batched_op_invariant=invariant)
    eng = Engine(params, cfg, ServeConfig(**PAGED, spec="ngram",
                                          spec_k=SPEC_K))
    counters = (KV.mx_paged_spec_attention_decode, KV.mx_spec_attention_decode,
                KP.mx_paged_attention_decode, KP.mx_paged_kv_append_quant,
                KP.mx_paged_kv_append, KA.mx_attention_decode,
                KS.mx_state_update, K7.mx_quantize)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    KS.mx_state_update.slab_launches = 0
    K7.mx_kv_append_quant.launches = K7.mx_kv_append_quant.mla_launches = 0
    PLAIN_QUANT["calls"] = 0
    t1 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=MAX_NEW)
               for p in paged["prompts"]]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    n5, n6, n3, n4, n4c, n2, n1, n_q = (c.launches for c in counters)
    n1s = KS.mx_state_update.slab_launches
    n_plain_q = PLAIN_QUANT["calls"]
    peak = torch.cuda.max_memory_allocated()
    steps = eng.engine.step_count
    _check_done(handles, cfg)
    st = eng.stats()
    check(steps > 0 and n5 == 9 * steps and n4 == 9 * KQ * steps
          and n1s == 54 * KQ * steps and n6 == n3 == n4c == n2 == n1 == 0
          and n_q == _k7_per_prefill(cfg) * len(handles)
          and K7.mx_kv_append_quant.launches == 0,
          f"launches over {steps} verify steps: paged verify {n5} (want 9x), "
          f"fused append {n4} ({9 * KQ}x), state update slab {n1s} "
          f"({54 * KQ}x), dense verify {n6}, paged attention {n3}, copy "
          f"append {n4c}, dense attention {n2}, dense state update {n1} (0 "
          f"each); quantizer {n_q} over {len(handles)} prefills")
    check(n_plain_q == 0, f"the plain MX8 quantizer ran {n_plain_q} times "
          "on the card inside verify steps or prefills")
    agree, first = _agreement(paged["outputs"], [h.output for h in handles])
    ps = paged["stats"]
    phase(14, "main path zamba2-2.7b paged + ngram speculation",
          requests=len(handles), verify_steps=steps, Kq=KQ,
          launches=f"paged_verify={n5},fused_append={n4},su_slab={n1s},"
          f"dense_verify={n6},paged_attn={n3},copy_append={n4c},"
          f"dense_attn={n2},su_dense={n1},quant={n_q}",
          plain_quantizer_calls_in_verify=n_plain_q,
          per_step=f"{n5 / steps:g},{n4 / steps:g},{n1s / steps:g}",
          proposed=int(st["proposed_tokens"]),
          accepted=int(st["accepted_tokens"]),
          acceptance_rate=f"{st['acceptance_rate']:.3f}",
          accepted_tokens_per_step=f"{st['accepted_tokens_per_step']:.3f}",
          wall_s=f"{wall:.3f}", **_step_fields(st),
          peak_mem_GB=f"{peak / 1e9:.2f}",
          preemptions=int(st["preemptions"]),
          vs_phase_11_other_sr_seeds="equal" if first is None else
          f"agreement {agree:.3f}, first difference at token {first}")
    phase(14, "speculative vs plain paged (same run, same weights, same "
          "prompts)", decode_steps=f"{steps} vs {paged['steps']}",
          p50_step_ms=f"{st['p50_step_s'] * 1e3:.3f} vs "
          f"{ps['p50_step_s'] * 1e3:.3f}",
          tokens_per_s=f"{st['tokens_per_s']:.2f} vs "
          f"{ps['tokens_per_s']:.2f}",
          p50_ttft_ms=f"{st['p50_ttft_s'] * 1e3:.3f} vs "
          f"{ps['p50_ttft_s'] * 1e3:.3f}",
          peak_mem_GB=f"{peak / 1e9:.2f} vs {paged['peak'] / 1e9:.2f}")
    rng = np.random.default_rng(2)
    prof = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 14)
    _spec_rollback_check(eng, cfg, rng, invariant)

    _greedy_exactness(params, cfg, paged["prompts"], invariant, n=14)
    return dict(n5=n5, n6=n6, stats=st, prof=prof, invariant=invariant)


def _greedy_exactness(params, cfg, prompts, invariant, n, max_new=MAX_NEW,
                      paged=PAGED):
    """Greedy exactness at full width: the prompts of at most 256 tokens
    (zamba2's ``prefill_chunk``), round-to-nearest MX8 (so no
    stochastic-rounding seed enters), through the plain paged engine
    (``paged``) and the speculative one with
    the n-gram and the model draft sources (the llama3.2-1b smoke draft,
    vocabulary 512, always proposes).  Equal streams are required when the
    verify step's remaining batched op (the norm: RMSNorm or LayerNorm) is
    row invariant; otherwise the agreement is reported."""
    from repro_torch import ops as OPS
    from repro_torch.serving.api import Engine, ServeConfig
    ncfg = cfg.with_(state_quant=OPS.StateQuantConfig("mx8", "nearest",
                                                      "cuda"))
    short = [p for p in prompts if len(p) <= 256]
    runs = {}
    for spec in (None, "ngram", "model:llama3.2-1b"):
        eng = Engine(params, ncfg, ServeConfig(**paged, spec=spec,
                                               spec_k=SPEC_K))
        hs = [eng.submit(p, max_new_tokens=max_new) for p in short]
        t0 = time.perf_counter()
        eng.run()
        _check_done(hs, cfg, max_new)
        runs[spec] = ([h.output for h in hs], eng.stats(),
                      eng.engine.step_count, time.perf_counter() - t0)
    ref = runs[None][0]
    for spec in ("ngram", "model:llama3.2-1b"):
        out, st, steps, wall = runs[spec]
        agree, first = _agreement(ref, out)
        if invariant:
            check(first is None, f"{spec}: greedy stream differs from the "
                  f"plain paged stream at token {first} (round-to-nearest)")
        phase(n, f"greedy exactness, {spec} vs plain, round-to-nearest",
              requests=len(short), batch=paged["batch"],
              steps=f"{steps} vs {runs[None][2]}",
              proposed=int(st["proposed_tokens"]),
              accepted=int(st["accepted_tokens"]),
              accepted_tokens_per_step=f"{st['accepted_tokens_per_step']:.3f}",
              wall_s=f"{wall:.3f} vs {runs[None][3]:.3f}",
              stream="equal" if first is None else
              f"agreement {agree:.3f}, first difference at token {first}")
    check(runs["model:llama3.2-1b"][1]["proposed_tokens"] > 0,
          "the model draft proposed nothing")


def _profile_decode(eng, cfg, rng, prompt_lens, n, n_steps=5, before=None):
    """Device busy / idle share of steady decode steps at batch 4 of
    ``eng`` (:func:`_device_profile`).  ``before``: (device busy ms, device
    operations) a step of an earlier build, printed beside."""
    import torch
    for length in prompt_lens:
        eng.submit(rng.integers(0, cfg.vocab_size, length),
                   max_new_tokens=n_steps + 2)
    eng.step()                       # admissions (prefill) + first decode
    torch.cuda.synchronize()
    out = _device_profile(eng.step, n_steps, n, before=before)
    eng.run()
    return out


def _device_profile(step, n_steps, n, before=None):
    """Device busy / idle share of ``n_steps`` calls of ``step``, from a
    torch.profiler window (kernel time summed over the device timeline).
    A window without device events fails the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, n_kernels = {}, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us())
    check(bool(by_name), "decode profile: the profiler recorded no device "
          "events")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = dict(idle_share=1 - busy / wall_us)
    earlier = {} if before is None else dict(
        eager_append_device_busy_ms_per_step=f"{before[0]:.3f}",
        eager_append_device_ops_per_step=f"{before[1]:,}")
    phase(n, "decode profile", steps=n_steps,
          step_wall_ms=f"{wall_us / n_steps / 1e3:.3f}",
          device_busy_ms_per_step=f"{busy / n_steps / 1e3:.3f}",
          device_ops_per_step=f"{n_kernels / n_steps:.0f}", **earlier,
          idle_share=f"{out['idle_share']:.3f}",
          top=repr([(name[:48], f"{us / n_steps / 1e3:.3f}ms")
                    for name, us in top]))
    return out


# ---------------------------------------------------------------------------
# MLA mode (kernels 2, 3, 5, 6) and deepseek-v2-236b at full width
# ---------------------------------------------------------------------------

def _mla_pool(lengths, seed, n_stack=None, spare=2):
    """A latent page pool (P, n_stack, 128, 1, 576) of random MX8 rows, a
    block table of shuffled non-contiguous pages spanning ``len + 1``
    positions per row (bucketed, scratch page 0 in the tail), and q
    ``(B, KQ, 128, 576)``."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    from repro_torch.serving.memory import bucket_pages
    m = MLA
    n_stack = n_stack or m["n_stack"]
    need = [pages_for(n + 1) for n in lengths]
    P = 1 + sum(need) + spare
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = (torch.randperm(P - 1, generator=g, device="cuda") + 1).tolist()
    bt = torch.zeros((len(lengths), bucket_pages(max(need))),
                     dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n])
        ids = ids[n:]
    C = F.mx8_quantize(torch.randn((P, n_stack, 128, 1, m["dk"]), generator=g,
                                   device="cuda"))
    q = torch.randn((len(lengths), KQ, m["H"], m["dk"]), generator=g,
                    device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, C, bt.cuda(), lens


def _mla_scale():
    return (128 + 64) ** -0.5              # (nope_dim + rope_dim) ** -0.5


def phase_mla_kernels():
    """The MLA mode of kernels 6 (dense verify), 5 (paged verify), 2
    (dense decode) and 3 (paged decode) at deepseek-v2-236b's widths
    against their plain versions (rtol 2e-4, atol 2e-5), and the three
    bitwise contracts: paged == dense over the gathered pages, verify row
    j == decode at length len - (Kq - 1 - j), Kq = 1 == decode.  Then the
    latent-only append (kernel 4 over the stream's three payload pools)
    byte for byte against its plain version."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    m = MLA
    kw = dict(scale=_mla_scale(), v_width=m["dv"])
    errs = dict(e2=0.0, e3=0.0, e5=0.0, e6=0.0, apq_mla=0.0)
    cases = quant_cases = 0
    for i, lengths in enumerate(MLA_LENGTHS):
        q_all, C, bt, lens = _mla_pool(lengths, seed=110 + i)
        group = (1 + i) % m["n_stack"]
        Cd = R.gather_pages(C, bt, group)
        for Kq in (1, 2, 4):
            q = q_all[:, :Kq].contiguous()
            label = f"MLA Kq={Kq} lengths={lengths}"
            y5 = KV.mx_paged_spec_attention_decode(q, C, None, bt, group,
                                                   lens, **kw)
            y6 = KV.mx_spec_attention_decode(q, Cd, None, lens, **kw)
            p5 = KV.plain_paged(q, C, None, bt, group, lens, kw["scale"],
                                m["dv"])
            p6 = KV.plain(q, Cd, None, lens, kw["scale"], m["dv"])
            torch.cuda.synchronize()
            for key, y, yp in (("e5", y5, p5), ("e6", y6, p6)):
                err = (y - yp).abs()
                check(bool((err <= 2e-5 + 2e-4 * yp.abs()).all()),
                      f"{label} kernel {key[1]}: beyond rtol 2e-4 atol 2e-5 "
                      f"(max err {float(err.max()):.3g})")
                errs[key] = max(errs[key], float(err.max()))
            check(torch.equal(y5, y6), f"{label}: kernel 5 not bitwise "
                  "kernel 6 over the gathered pages")
            for j in range(Kq):
                lj = lens - (Kq - 1 - j)
                qj = q[:, j].contiguous()
                y2 = KA.mx_attention_decode(qj, Cd, None, lj, **kw)
                y3 = KP.mx_paged_attention_decode(qj, C, None, bt, group, lj,
                                                  **kw)
                if Kq == 4:
                    p2 = KA.plain(qj, Cd, None, lj, kw["scale"], m["dv"])
                    torch.cuda.synchronize()
                    for key, y in (("e2", y2), ("e3", y3)):
                        err = (y - p2).abs()
                        check(bool((err <= 2e-5 + 2e-4 * p2.abs()).all()),
                              f"{label} row {j} kernel {key[1]}: beyond "
                              f"rtol 2e-4 atol 2e-5")
                        errs[key] = max(errs[key], float(err.max()))
                check(torch.equal(y3, y2), f"{label}: row {j} kernel 3 not "
                      "bitwise kernel 2 over the gathered pages")
                check(torch.equal(y6[:, j], y2), f"{label}: row {j} not "
                      "bitwise kernel 2 at the shifted length")
            cases += 1

        # latent-only append: three payload pools of one stream
        B = len(lengths)
        g = torch.Generator(device="cuda").manual_seed(120 + i)
        x = torch.randn((B, 1, 1, m["dk"]), generator=g, device="cuda")
        qx = F.quantize(x, "mx8", "stochastic",
                        F.sr_bits(x.shape, 7 + i, device="cuda"))
        rows = [qx.payload[f][:, 0] for f in sorted(qx.payload)]
        pools = [C.payload[f] for f in sorted(C.payload)]
        before = [p.clone() for p in pools]
        plain_pools = [p.clone() for p in pools]
        KP.mx_paged_kv_append(pools, rows, bt, group, lens)
        KP.plain_append(plain_pools, rows, bt, group, lens)
        torch.cuda.synchronize()
        keep = torch.ones(pools[0].shape[:3], dtype=torch.bool,
                          device="cuda")
        for b, n in enumerate(lengths):
            keep[bt[b, n // 128], group, n % 128] = False
        for j, (a, b, b0) in enumerate(zip(pools, plain_pools, before)):
            check(torch.equal(a, b), f"latent append {lengths}: pool {j} "
                  "differs from the plain version")
            check(torch.equal(a[keep], b0[keep]), f"latent append "
                  f"{lengths}: pool {j} changed outside the appended slots")
        n, err = _hold_append_quant([C], bt, group, lengths, 7 + i,
                                    "fused latent append")
        quant_cases, errs["apq_mla"] = quant_cases + n, max(
            errs["apq_mla"], float(err))
    phase(15, "MLA mode of kernels 2, 3, 5, 6 vs plain, full width",
          B=m["B"], H=m["H"], dk=m["dk"], dv=m["dv"], n_stack=m["n_stack"],
          lengths=list(MLA_LENGTHS), Kq="1,2,4", cases=cases,
          max_abs_err=",".join(f"{k}={v:.3g}" for k, v in errs.items()
                               if k != "apq_mla"),
          tol="rtol2e-4,atol2e-5", paged_vs_dense="bitwise",
          row_j_vs_decode="bitwise", Kq1_vs_decode="bitwise")
    _mla_subnormal_check(kw)
    phase(15, "mx_paged_kv_append latent-only vs plain", pools=3,
          widths=f"{m['dk']},{m['dk'] // 16},{m['dk'] // 16}",
          result="bitwise", untouched_bytes="unchanged")
    phase(15, "mx_paged_kv_append_quant latent-only vs plain and vs the "
          "replaced path (eager quantize + copy kernel)", streams=1, pools=3,
          d=m["dk"], lengths=list(MLA_LENGTHS),
          magnitudes=",".join(f"{x:g}" for x in APPEND_MAGS),
          roundings="nearest,stochastic", cases=quant_cases,
          fields="mantissa,exponent,micro", result="bitwise",
          max_abs_err=f"{errs['apq_mla']:g}", untouched_bytes="unchanged")
    return errs


def _mla_subnormal_check(kw):
    """The MLA kernels on a latent at magnitude 1e-37: subnormal MX8
    scales, and ~7 % of the values subnormal in bf16.  The latent is
    nonnegative and the queries at 5e36 keep the scores O(1), so every
    output is a normal weighted mean: kernels 5, 6, 3 and 2 are held to the
    plain versions at rtol 2e-4 with atol 0, where a product that flushed
    the subnormal values would miss by up to 50 %."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    lengths = (300, 65, 129, 4)
    q, C, bt, lens = _mla_pool(lengths, seed=140)
    g = torch.Generator(device="cuda").manual_seed(141)
    C = F.mx8_quantize(torch.randn(C.shape, generator=g, device="cuda").abs()
                       * 1e-37)
    v = F.dequantize(C)
    sub = float(((v != 0) & (v.abs() < 2.0 ** -126)).float().mean())
    q = q * 5e36
    group, scale, dv = 1, kw["scale"], kw["v_width"]
    Cd = R.gather_pages(C, bt, group)
    q1 = q[:, -1].contiguous()
    got = (KV.mx_paged_spec_attention_decode(q, C, None, bt, group, lens,
                                             **kw),
           KV.mx_spec_attention_decode(q, Cd, None, lens, **kw),
           KP.mx_paged_attention_decode(q1, C, None, bt, group, lens, **kw),
           KA.mx_attention_decode(q1, Cd, None, lens, **kw))
    want = (KV.plain_paged(q, C, None, bt, group, lens, scale, dv),
            KV.plain(q, Cd, None, lens, scale, dv),
            KP.plain(q1, C, None, bt, group, lens, scale, dv),
            KA.plain(q1, Cd, None, lens, scale, dv))
    torch.cuda.synchronize()
    worst = 0.0
    for k, y, yp in zip((5, 6, 3, 2), got, want):
        rel = ((y - yp).abs() / yp.abs()).nan_to_num(0.0)
        check(bool(((y - yp).abs() <= 2e-4 * yp.abs()).all()),
              f"MLA latent at 1e-37: kernel {k} beyond rtol 2e-4 atol 0 "
              f"(max rel err {float(rel.max()):.3g})")
        worst = max(worst, float(rel.max()))
    check(sub > 0.05, f"MLA latent at 1e-37: only {sub:.3f} subnormal")
    phase(15, "MLA mode at latent magnitude 1e-37 vs plain", lengths=lengths,
          Kq=KQ, bf16_subnormal_share=f"{sub:.3f}",
          min_abs_out=f"{min(float(y.abs().min()) for y in want):.3g}",
          max_rel_err=f"{worst:.3g}", tol="rtol2e-4,atol0")


def phase_mla_timing():
    """Device times of the four MLA modes from CUDA-graph replay at the
    deepseek main path's mid-decode lengths (B = 4, Kq = 4 for the verify
    kernels, lengths counting the appended rows), 96 layers' latent pages
    (and their gathered dense copies) rotating cold in L2.  The yardstick
    is one ``scaled_dot_product_attention`` call on the dequantized latent
    (q (B, 128, n_q, 576), K (B, 1, T, 576) shared by the 128 heads, V its
    first 512 lanes, the verify mask for n_q = 4).  Bound: the design's own
    (three bf16 tensor-core products per multiply-add of the function, or
    the bytes), the fp32-operations bound (~430 flops per cached byte)
    printed beside it."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    m = MLA
    n_rot = 96
    it = iter(range(10 ** 9))
    base = [n + DS_MAX_NEW // 2 for n in DS_PROMPT_LENS[:m["B"]]]
    scale = _mla_scale()
    kw = dict(scale=scale, v_width=m["dv"])
    out = {}
    for n_q in (1, KQ):
        lengths = [n + n_q - 1 for n in base]
        q_all, C, bt, lens = _mla_pool(lengths, seed=130 + n_q,
                                       n_stack=n_rot, spare=0)
        q = q_all[:, :n_q].contiguous()
        q1 = q[:, 0].contiguous()
        dense = [R.gather_pages(C, bt, g) for g in range(n_rot)]
        T = bt.shape[1] * 128
        shift = torch.arange(n_q, device="cuda") - (n_q - 1)
        mask = (torch.arange(T, device="cuda")[None, None, :]
                < (lens[:, None] + shift[None, :])[:, :, None])[:, None]
        qh = q.permute(0, 2, 1, 3).contiguous()        # (B, 128, n_q, 576)
        kfs = [F.dequantize(c)[:, :, 0][:, None] for c in dense[:8]]
        lib = [lambda k=k: torch.nn.functional.scaled_dot_product_attention(
            qh, k, k[..., :m["dv"]], attn_mask=mask, scale=scale,
            enable_gqa=True) for k in kfs]
        y_lib = lib[0]().permute(0, 2, 1, 3)
        y_k = KV.mx_spec_attention_decode(q, dense[0], None, lens, **kw)
        torch.cuda.synchronize()
        check(bool(((y_lib - y_k).abs() <= 1e-4 + 1e-3 * y_k.abs()).all()),
              f"MLA yardstick (SDPA) disagrees with kernel 6 at n_q={n_q}")
        row_pos = sum(n - (n_q - 1 - j) for n in lengths for j in range(n_q))
        flops = row_pos * m["H"] * 2 * (m["dk"] + m["dv"])
        io = 4 * m["B"] * n_q * m["H"] * (m["dk"] + m["dv"]) + 4 * m["B"]
        cache = sum(lengths) * m["dk"] * (1 + 2 / F.MX8_GROUP)
        bt_bytes = 4 * sum(pages_for(n) for n in lengths)
        if n_q == 1:
            cases = (
                ("mx_paged_attention_decode[mla]",
                 [lambda g=g: KP.mx_paged_attention_decode(
                     q1, C, None, bt, g, lens, **kw) for g in range(n_rot)],
                 [lambda g=g: KP.plain(q1, C, None, bt, g, lens, scale,
                                       m["dv"]) for g in range(8)],
                 bt_bytes),
                ("mx_attention_decode[mla]",
                 [lambda c=c: KA.mx_attention_decode(q1, c, None, lens, **kw)
                  for c in dense],
                 [lambda c=c: KA.plain(q1, c, None, lens, scale, m["dv"])
                  for c in dense[:8]], 0))
        else:
            cases = (
                ("mx_paged_spec_attention_decode[mla]",
                 [lambda g=g: KV.mx_paged_spec_attention_decode(
                     q, C, None, bt, g, lens, **kw) for g in range(n_rot)],
                 [lambda g=g: KV.plain_paged(q, C, None, bt, g, lens, scale,
                                             m["dv"]) for g in range(8)],
                 bt_bytes),
                ("mx_spec_attention_decode[mla]",
                 [lambda c=c: KV.mx_spec_attention_decode(q, c, None, lens,
                                                          **kw)
                  for c in dense],
                 [lambda c=c: KV.plain(q, c, None, lens, scale, m["dv"])
                  for c in dense[:8]], 0))
        kind = "mla_decode" if n_q == 1 else "spec_verify"
        for (name, kern, plain, extra), layout in zip(cases,
                                                      ("paged", "dense")):
            ms = graph_ms(kern, 5)
            plain_ms = graph_ms(plain, 2)
            lib_ms = graph_ms(lib, 5)
            host_ms = host_loop_ms(lambda k=kern: k[next(it) % n_rot](), 96)
            plan_bytes = sum(OPS.traffic(OPS.registry.plan(
                kind, dict(B=1, T=n, KVH=1, dk=m["dk"], dv=0, n=1, H=m["H"],
                           Kq=n_q), OPS.StateQuantConfig(), "cuda",
                layout=layout, v_width=m["dv"])).total for n in lengths)
            out[name] = _report(name, ms, plain_ms, lib_ms, host_ms,
                                cache + io + extra, flops, plan_bytes, n=16,
                                tc_flops=MLA_TERMS * flops)
        phase(16, "MLA lengths", n_q=n_q, lengths=lengths,
              per_row_positions=row_pos, flops_per_launch=flops)
        del dense, kfs, lib, C

    # -- the fused latent append at the decode lengths, over the 3 MoE
    # groups' latent pages
    _, C, bt, lens = _mla_pool(base, seed=150)
    plan = OPS.registry.plan("kv_append", dict(B=m["B"], T=1, KVH=1,
                                               dk=m["dk"], dv=0, n=1),
                             OPS.StateQuantConfig(), "cuda", layout="paged")
    name = "mx_paged_kv_append[quant,mla]"
    out[name] = _time_append_quant([C], bt, lens, m["n_stack"], name,
                                   OPS.traffic(plan).total, n=16)
    return out


def _model_at(arch, layers=None):
    """``arch`` at full width, ``layers`` deep (else all its layers),
    random weights from a seeded CUDA generator: (cfg, params, info)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config(arch)
    cfg = full.with_(n_layers=layers or full.n_layers)
    check(cfg.state_quant.fmt == "mx8" and cfg.state_quant.backend == "cuda",
          f"unexpected {cfg.name}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_model(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in _leaves(params))
    nbytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    info = dict(params=n, GB=f"{nbytes / 1e9:.2f}",
                layers=f"{cfg.n_layers} of {full.n_layers}")
    if not cfg.encoder_only:
        # a decode step streams every weight once but the tables it
        # gathers rows from (the token embedding, unless it is the tied LM
        # head, and the learned positions)
        stream = nbytes - sum(
            params[k].numel() * params[k].element_size()
            for k in ("embed", "pos") if k in params
            and not (k == "embed" and cfg.tie_embeddings))
        info.update(weight_stream_GB=f"{stream / 1e9:.2f}",
                    weight_stream_bound_ms=(
                        f"{stream / PEAK_BYTES_PER_S * 1e3:.2f}"))
    info["init_s"] = f"{time.perf_counter() - t0:.1f}"
    return cfg, params, info


def _ds_model():
    """deepseek-v2-236b at full width, depth cut to ``DS_LAYERS`` (the
    dense-FFN prelude layer and 3 MoE groups)."""
    from repro_torch.configs import get_config
    cfg, params, info = _model_at("deepseek-v2-236b", DS_LAYERS)
    check(get_config(cfg.name).n_layers == 60 and cfg.d_model == 5120
          and cfg.n_heads == 128 and cfg.mla.cache_width == 576
          and cfg.moe.n_experts == 160 and cfg.n_groups == DS_LAYERS - 1,
          f"unexpected {cfg.name}")
    phase(17, "deepseek-v2-236b weights", **info, reduced=DS_REDUCED)
    return cfg, params


def _mla_counters():
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    return dict(k2=KA.mx_attention_decode, k3=KP.mx_paged_attention_decode,
                k5=KV.mx_paged_spec_attention_decode,
                k6=KV.mx_spec_attention_decode)


def phase_deepseek(cfg, params):
    """deepseek-v2-236b through the slot pool (phase 17), the paged pool
    with preemption (18; paged logits bitwise the dense-gather path's on a
    fresh pool first) and the paged pool with n-gram speculation (19).
    Every decode step must launch the MLA kernel of its path once per
    layer (4), the fused latent append once per layer and position (the
    dense one on the slot pool, the paged one on the paged paths: 4, 16),
    and no GQA attention or state-update kernel, no copy append and no
    plain MX8 quantizer; every request's prefill kernel 7 once per layer
    (one latent stream each)."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    rng = np.random.default_rng(3)
    prompts = [np.resize(rng.integers(0, cfg.vocab_size, 8), n)
               for n in DS_PROMPT_LENS]
    L = cfg.n_layers

    eng = Engine(params, cfg, ServeConfig(backend="slots", batch=4,
                                          cache_capacity=1024))
    slot = _serve_counted(eng, cfg, prompts, DS_MAX_NEW,
                          dict(k2=L, apd_mla=L), _k7_per_prefill(cfg),
                          "deepseek slots")
    kv = sum(_payload_bytes(c.k) for c in M.iter_kv_caches(eng.engine.caches))
    phase(17, "main path deepseek-v2-236b slots", reduced=DS_REDUCED,
          **_fields(slot), kv_MB=f"{kv / 1e6:.2f}")
    slot["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 17,
                                   before=EAGER_APPEND_PROFILE[cfg.name])
    _reference_check(params, cfg, prompts[0], n=17)
    del eng                    # frees the slot pool's caches

    eng = Engine(params, cfg, ServeConfig(**DS_PAGED))
    shape = _paged_vs_gather(eng, cfg, rng)
    phase(18, "deepseek paged vs gather logits, fresh pool", steps=4,
          logits=tuple(shape), result="bit-identical")
    paged = _serve_counted(eng, cfg, prompts, DS_MAX_NEW,
                           dict(k3=L, k4q_mla=L), _k7_per_prefill(cfg),
                           "deepseek paged")
    st = paged["stats"]
    check(st["preemptions"] >= 1, f"deepseek: no preemption with {DS_PAGED}")
    pool = eng.engine.pool
    phase(18, "main path deepseek-v2-236b paged", reduced=DS_REDUCED,
          **_fields(paged), preemptions=int(st["preemptions"]),
          pages=f"{pool.n_pages}x{pool.page_nbytes}B",
          gather_MB=f"{st['gather_bytes'] / 1e6:.2f}")
    paged["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 18)
    del eng

    eng = Engine(params, cfg, ServeConfig(**DS_PAGED, spec="ngram",
                                          spec_k=SPEC_K))
    spec = _serve_counted(eng, cfg, prompts, DS_MAX_NEW,
                          dict(k5=L, k4q_mla=L * KQ), _k7_per_prefill(cfg),
                          "deepseek paged + ngram")
    st = spec["stats"]
    agree, first = _agreement(paged["outputs"], spec["outputs"])
    phase(19, "main path deepseek-v2-236b paged + ngram speculation",
          reduced=DS_REDUCED, Kq=KQ, **_fields(spec),
          proposed=int(st["proposed_tokens"]),
          accepted=int(st["accepted_tokens"]),
          acceptance_rate=f"{st['acceptance_rate']:.3f}",
          preemptions=int(st["preemptions"]),
          vs_phase_18_other_sr_seeds="equal" if first is None else
          f"agreement {agree:.3f}, first difference at token {first}")
    spec["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 19)
    del eng
    return dict(slot=slot, paged=paged, spec=spec)


# ---------------------------------------------------------------------------
# kernel 7 (the MX8 quantizer), kernel 1 at the GLA family's heads, and
# gla-2.7b / retnet-2.7b / hgrn2-2.7b at full width and full depth
# ---------------------------------------------------------------------------

def _hold_quant(shapes, seed0=0):
    """Kernel 7 bitwise its plain version (mantissa, exponent, micro) at
    ``shapes``, both roundings; values spread over 45 decades with zero
    groups, so the exponent floor and subnormal scales are held too.
    Returns (values, max |byte difference|)."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_quant as K7
    n_vals, max_err = 0, 0
    for i, shape in enumerate(shapes, start=seed0):
        g = torch.Generator(device="cuda").manual_seed(20 + i)
        x = torch.randn(shape, generator=g, device="cuda")
        x *= torch.pow(10.0, torch.randint(-40, 6, shape[:-1] + (1,),
                                           generator=g, device="cuda").float())
        x.view(-1, F.MX8_GROUP)[::7] = 0.0
        for rounding in ("nearest", "stochastic"):
            got = K7.mx_quantize(x, 77 + i, rounding=rounding)
            want = K7.plain(x, rounding, 77 + i)
            torch.cuda.synchronize()
            for f in want.payload:
                max_err = max(max_err, int((got.payload[f].int()
                                            - want.payload[f].int())
                                           .abs().max()))
                check(torch.equal(got.payload[f], want.payload[f]),
                      f"mx_quantize {shape} {rounding}: {f} differs from "
                      "the plain version")
            del got, want
        n_vals += x.numel()
        del x
    torch.cuda.empty_cache()
    return n_vals, max_err


def phase_quant():
    """Kernel 7 bitwise its plain version at the prefill REG_WRITE shapes of
    every served model and the JAX kernel test's shapes."""
    n_vals, max_err = _hold_quant(QUANT_SHAPES)
    phase(20, "mx_quantize vs plain", shapes=len(QUANT_SHAPES),
          largest=QUANT_SHAPES[-1], values=n_vals,
          roundings="nearest,stochastic", max_abs_err=max_err,
          result="bitwise (mantissa, exponent, micro)")
    return float(max_err)


def phase_gla_state_update():
    """Kernel 1 at the GLA family's heads (gla: dk 320, 20 groups a row,
    two rows a thread, dv 640 ending in a partial block of rows; retnet;
    hgrn2) and at SU_ODD, dense and slab mode, scalar and per-channel decay
    each at state magnitudes 1, 1e-3 and SU_TINY, both roundings, against
    the plain version: mantissa, exponent and micro bitwise, y bitwise
    where the state matches."""
    mism = total = 0
    errs = {}
    for name, shape, _ in GLA_SU + (("odd", SU_ODD, True),):
        err = 0.0
        for rounding, mag, scalar in itertools.product(
                ("stochastic", "nearest"), (1.0, 1e-3, SU_TINY),
                (True, False)):
            n_bad, n, e = _su_case(shape, rounding, mag, scalar,
                                   seed=shape[3] + int(mag * 10))
            mism, total, err = mism + n_bad, total + n, max(err, e)
            n_bad, n, e = _slab_case(shape, gen_seed=shape[2] + int(mag * 10),
                                     sr_seed=21, scalar_decay=scalar,
                                     rounding=rounding, mag=mag)
            mism, total, err = mism + n_bad, total + n, max(err, e)
        errs[name] = err
    check(mism == 0, f"kernel 1 at the GLA family's shapes: {mism} of "
          f"{total} mantissas differ from the plain version")
    phase(21, "mx_state_update at the GLA family's heads vs plain",
          shapes=[s for _, s, _ in GLA_SU] + [SU_ODD], modes="dense,slab",
          decay="scalar,per-channel", state_magnitude=f"1,1e-3,{SU_TINY:g}",
          roundings="stochastic,nearest",
          mantissa_exp_micro="bitwise", values=total,
          y_max_abs_err=repr({k: f"{v:.3g}" for k, v in errs.items()}))
    return errs


def _rotation(nbytes_each, minimum=32):
    """How many copies of an input rotate so that each launch finds its
    input cold in the 50 MB L2 (twice the L2 at least)."""
    return max(minimum, math.ceil(2 * 50e6 / nbytes_each))


def phase_gla_timing():
    """Device times from CUDA-graph replay, inputs rotated past L2: kernel 7
    at gla's prefill state (B = 4, round to nearest: what the REG_WRITE
    sites run), kernel 1 dense at gla's heads and in slab mode at the three
    models' heads (per-channel decay for gla / hgrn2, scalar for retnet).
    No single PyTorch call quantizes to MX8 or updates an MX8 state, so the
    library times are null."""
    import torch
    out = {"mx_quantize": _time_k7("mx_quantize", GLA_SU[0][1], n=22)}
    for name, shape, scalar in GLA_SU:
        tag = name.split("-")[0]
        if name == "gla-2.7b":
            out[f"mx_state_update[{tag}]"] = _time_su(
                f"mx_state_update[{tag}]", shape, scalar, "dense", n=22)
        out[f"mx_state_update[slab,{tag}]"] = _time_su(
            f"mx_state_update[slab,{tag}]", shape, scalar, "slab", n=22)
    torch.cuda.empty_cache()
    return out


def _time_k7(key, shape, n):
    """Kernel 7 at ``shape`` (round to nearest: what the REG_WRITE sites
    run), its plain version, and its host-loop time; bytes = 4 B read +
    1.125 B written per value."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_quant as K7
    it = iter(range(10 ** 9))
    n_val = math.prod(shape)
    n_rot = _rotation(n_val * 4)
    g = torch.Generator(device="cuda").manual_seed(22)
    xs = [torch.randn(shape, generator=g, device="cuda")
          for _ in range(n_rot)]
    kern = [lambda x=x: K7.mx_quantize(x) for x in xs]
    plain = [lambda x=x: K7.plain(x) for x in xs[:8]]
    ms = graph_ms(kern, 10)
    plain_ms = graph_ms(plain, 3)
    host_ms = host_loop_ms(lambda: kern[next(it) % n_rot](), 10 * n_rot)
    nbytes = n_val * (4 + 1 + 2 / F.MX8_GROUP)
    return _report(key, ms, plain_ms, None, host_ms, nbytes, 5 * n_val,
                   n_val * 9 / 8 + 4 * n_val, n=n)


def _time_su(key, shape, scalar, mode, n):
    """Kernel 1 at ``shape`` in ``mode`` ("dense", or "slab" on a pool of
    ``n_rot`` layers), states rotated cold in L2, its plain version, and
    its host-loop time; bytes = the payload read and written once, the
    operands, y, and the slab ids."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_state_update as KS
    it = iter(range(10 ** 9))
    B, H, dv, dk = shape
    n_val = B * H * dv * dk
    payload = n_val * (1 + 2 / F.MX8_GROUP)
    dd = 1 if scalar else dk
    operands = 4 * (B * H * (dd + 2 * dk + dv) + B * H * dv)
    g = torch.Generator(device="cuda").manual_seed(dk)
    d = torch.sigmoid(torch.randn((B, H, dd), generator=g, device="cuda"))
    k, q = (torch.randn((B, H, dk), generator=g, device="cuda")
            for _ in "kq")
    v = torch.randn((B, H, dv), generator=g, device="cuda")
    n_rot = _rotation(payload)
    if mode == "dense":
        states = [F.mx8_quantize(torch.randn(shape, generator=g,
                                             device="cuda"))
                  for _ in range(n_rot)]
        kern = [lambda i=i: KS.mx_state_update(states[i], d, k, v, q, seed=i)
                for i in range(n_rot)]
        plain = [lambda i=i: KS.plain(states[i], d, k, v, q, seed=i)
                 for i in range(8)]
        extra = 0
    else:
        states = F.mx8_quantize(torch.randn((B + 1, n_rot, H, dv, dk),
                                            generator=g, device="cuda"))
        slabs = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")
        kern = [lambda i=i: KS.mx_state_update(
            states, d, k, v, q, seed=i, slabs=slabs, group=i)
            for i in range(n_rot)]
        plain = [lambda i=i: KS.plain_slab(states, slabs, i, d, k, v, q,
                                           seed=i)
                 for i in range(8)]
        extra = 4 * B
    ms = graph_ms(kern, 10)
    plain_ms = graph_ms(plain, 3)
    host_ms = host_loop_ms(lambda: kern[next(it) % n_rot](), 10 * n_rot)
    plan = OPS.plan_state_update_dims(
        B, H, dk, dv, OPS.StateQuantConfig(),
        layout="dense" if mode == "dense" else "paged")
    return _report(key, ms, plain_ms, None, host_ms,
                   2 * payload + operands + extra, 10 * n_val,
                   OPS.traffic(plan).total, n=n)


#: calls of ``F.mx8_quantize`` on a CUDA tensor made inside the served
#: model's decode, verify and prefill steps, counted by the wrappers that
#: :func:`_watch_plain_quantizer` installs (``depth`` > 0 inside a step)
PLAIN_QUANT = dict(depth=0, calls=0)
#: the steps the watcher wraps: the slot pool's decode step (and the paged
#: pool's dense-gather reference path), the paged pool's decode and verify
#: steps, and every prefill
WATCHED_STEPS = ("decode_step", "paged_decode_step", "paged_spec_decode_step",
                 "prefill")


def _watch_plain_quantizer():
    """Wrap ``F.mx8_quantize`` (which ``F.quantize`` calls) to count its
    calls on CUDA tensors inside the steps of ``WATCHED_STEPS``: on the
    card every quantize there belongs in a kernel.  This script's own
    checks call the plain quantizer outside those steps, uncounted, and
    its plain-ops reference runs inside them, outside the counted
    windows."""
    from repro_torch.core import formats as F
    from repro_torch.models import model as M
    quantize = F.mx8_quantize

    def counted(x, *args, **kwargs):
        if PLAIN_QUANT["depth"] and x.is_cuda:
            PLAIN_QUANT["calls"] += 1
        return quantize(x, *args, **kwargs)
    F.mx8_quantize = counted
    for name in WATCHED_STEPS:
        def inside(*args, _step=getattr(M, name), **kwargs):
            PLAIN_QUANT["depth"] += 1
            try:
                return _step(*args, **kwargs)
            finally:
                PLAIN_QUANT["depth"] -= 1
        setattr(M, name, inside)


def _k7_per_prefill(cfg):
    """Kernel 7's launches in one request's prefill: one per recurrent
    state, one per attention application (K and V in one launch), one per
    MLA latent stream."""
    per = (lambda kinds: sum(cfg.pattern.count(k) for k in kinds)
           * cfg.n_groups + sum(cfg.prelude.count(k) for k in kinds))
    return (per(("mamba2", "gla", "retnet", "hgrn2", "mlstm"))
            + per(("attn",))
            + (cfg.n_groups if cfg.shared_attn else 0) + per(("mla",)))


def _counter_attrs():
    """Every launch counter the main paths read: (function, attribute)."""
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_quant as K7
    from repro_torch.kernels import mx_state_update as KS
    out = {}
    for k, fn in _mla_counters().items():
        out[k] = (fn, "mla_launches")
        out[f"{k}_gqa"] = (fn, "launches")
    out["k4"] = (KP.mx_paged_kv_append, "launches")
    out["k4q"] = (KP.mx_paged_kv_append_quant, "launches")
    out["k4q_mla"] = (KP.mx_paged_kv_append_quant, "mla_launches")
    out["k1"] = (KS.mx_state_update, "launches")
    out["k1s"] = (KS.mx_state_update, "slab_launches")
    out["k7"] = (K7.mx_quantize, "launches")
    out["apd"] = (K7.mx_kv_append_quant, "launches")
    out["apd_mla"] = (K7.mx_kv_append_quant, "mla_launches")
    return out


def _counts_reset():
    for fn, attr in _counter_attrs().values():
        setattr(fn, attr, 0)


def _counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counter_attrs().items()}


def _serve_counted(eng, cfg, prompts, max_new, want, per_prefill, label):
    """Serve ``prompts`` with every launch counter reset just before and
    read just after; ``want`` maps counter -> launches per decode step,
    ``per_prefill`` is kernel 7's launches per request prefill; every other
    counter must stay 0, and so must the plain MX8 quantizer's calls on the
    card inside decode, verify and prefill steps."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    _counts_reset()
    PLAIN_QUANT["calls"] = 0
    t1 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    n = _counts()
    n_plain_q = PLAIN_QUANT["calls"]
    check(n_plain_q == 0, f"{label}: the plain MX8 quantizer ran "
          f"{n_plain_q} times on the card inside decode, verify or prefill "
          "steps")
    steps = eng.engine.step_count
    for h in handles:
        check(h.status == "done" and len(h.output) == max_new,
              f"{label} request {h.rid}: {h.status} with {len(h.output)}")
        check(all(0 <= t < cfg.vocab_size for t in h.output),
              f"{label} request {h.rid}: token out of range")
    expect = {k: want.get(k, 0) * steps for k in n}
    expect["k7"] = per_prefill * len(prompts)
    check(steps > 0 and n == expect, f"{label} launches over {steps} steps "
          f"and {len(prompts)} prefills: {n}, want {expect}")
    st = eng.stats()
    # outputs, not the handles: a handle keeps its engine (and the model's
    # weights) alive
    return dict(outputs=[h.output for h in handles], n=n, steps=steps,
                wall=wall, stats=st, peak=torch.cuda.max_memory_allocated(),
                plain_quant=n_plain_q)


def _fields(r):
    st = r["stats"]
    per = {k: v / r["steps"] for k, v in r["n"].items() if v and k != "k7"}
    return dict(requests=len(r["outputs"]), steps=r["steps"],
                launches_per_step=",".join(f"{k}={v:g}"
                                           for k, v in per.items()),
                k7_launches=r["n"]["k7"],
                plain_quantizer_calls_in_steps=r["plain_quant"],
                wall_s=f"{r['wall']:.3f}",
                **_step_fields(st), peak_mem_GB=f"{r['peak'] / 1e9:.2f}")


def _gla_model(arch):
    """A GLA-family model at full width and full depth (32 layers)."""
    cfg, params, info = _model_at(arch)
    check(cfg.n_layers == 32 and cfg.d_model == 2560,
          f"unexpected {cfg.name}")
    return cfg, params, info


def phase_gla(init):
    """gla-2.7b at full width and all 32 layers through the slot pool (23),
    the paged pool (24; paged logits bitwise the dense-gather path's on a
    fresh pool first) and the paged pool with n-gram speculation (25).
    Every decode step launches kernel 1 once per layer (dense on the slot
    pool, slab mode on the paged pool; Kq times per verify step), every
    request's prefill kernel 7 once per layer, and nothing else."""
    import numpy as np
    import torch
    from repro_torch.serving.api import Engine, ServeConfig
    cfg, params, info = init
    L = cfg.n_layers
    phase(23, "gla-2.7b weights", **info)
    rng = np.random.default_rng(4)
    prompts = _pattern_prompts(rng, cfg)

    eng = Engine(params, cfg, ServeConfig(backend="slots", batch=4,
                                          cache_capacity=1024))
    slot = _serve_counted(eng, cfg, prompts, MAX_NEW, dict(k1=L),
                          _k7_per_prefill(cfg), "gla slots")
    state = sum(_payload_bytes(c) for grp in eng.engine.caches for c in grp)
    phase(23, "main path gla-2.7b slots", **_fields(slot),
          state_MB=f"{state / 1e6:.2f}")
    slot["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 23,
                                   before=EAGER_APPEND_PROFILE[cfg.name])
    _reference_check_by_depth(params, cfg, _token_batch(prompts[0]), n=23)
    del eng

    eng = Engine(params, cfg, ServeConfig(**PAGED))
    shape = _paged_vs_gather(eng, cfg, rng)
    phase(24, "gla paged vs gather logits, fresh pool", steps=4,
          logits=tuple(shape), result="bit-identical")
    paged = _serve_counted(eng, cfg, prompts, MAX_NEW, dict(k1s=L),
                           _k7_per_prefill(cfg), "gla paged")
    pool = eng.engine.pool
    check(pool.page_nbytes == 0, f"gla holds no KV, yet pages of "
          f"{pool.page_nbytes} B")
    slab_nbytes = pool.slab_nbytes
    phase(24, "main path gla-2.7b paged", **_fields(paged),
          preemptions=int(paged["stats"]["preemptions"]),
          page_bytes=pool.page_nbytes,
          slab_MB=f"{slab_nbytes / 1e6:.2f}",
          gather_MB=f"{paged['stats']['gather_bytes'] / 1e6:.2f}")
    paged["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 24)
    del eng

    eng = Engine(params, cfg, ServeConfig(**PAGED, spec="ngram",
                                          spec_k=SPEC_K))
    spec = _serve_counted(eng, cfg, prompts, MAX_NEW, dict(k1s=L * KQ),
                          _k7_per_prefill(cfg), "gla paged + ngram")
    st = spec["stats"]
    agree, first = _agreement(paged["outputs"], spec["outputs"])
    # a verify step snapshots every recurrent leaf of every active row
    # after each of its Kq positions (the rollback's source)
    phase(25, "main path gla-2.7b paged + ngram speculation", Kq=KQ,
          **_fields(spec), proposed=int(st["proposed_tokens"]),
          accepted=int(st["accepted_tokens"]),
          acceptance_rate=f"{st['acceptance_rate']:.3f}",
          snapshot_MB_per_verify_step_at_batch_4=(
              f"{KQ * 4 * slab_nbytes / 1e6:.2f}"),
          vs_phase_24_other_sr_seeds="equal" if first is None else
          f"agreement {agree:.3f}, first difference at token {first}")
    spec["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 25)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(slot=slot, paged=paged, spec=spec)


def phase_gla_paged(arch, n):
    """retnet-2.7b (26) or hgrn2-2.7b (27) at full width and all 32 layers
    through the paged pool: paged logits bitwise the dense-gather path's,
    kernel 1 in slab mode once per layer per step, kernel 7 once per layer
    per prefill."""
    import numpy as np
    import torch
    from repro_torch.serving.api import Engine, ServeConfig
    cfg, params, info = _gla_model(arch)
    L = cfg.n_layers
    phase(n, f"{arch} weights", **info)
    rng = np.random.default_rng(n)
    prompts = _pattern_prompts(rng, cfg)[:4]
    eng = Engine(params, cfg, ServeConfig(**PAGED))
    _paged_vs_gather(eng, cfg, rng)
    phase(n, f"{arch} paged vs gather logits, fresh pool", steps=4,
          result="bit-identical")
    r = _serve_counted(eng, cfg, prompts, OTHER_MAX_NEW, dict(k1s=L),
                       _k7_per_prefill(cfg), f"{arch} paged")
    phase(n, f"main path {arch} paged", **_fields(r),
          slab_MB=f"{eng.engine.pool.slab_nbytes / 1e6:.2f}")
    _reference_check_by_depth(params, cfg, _token_batch(prompts[0]), n=n)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return r


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _clone_caches(caches):
    from repro_torch.core import attention_cache as AC
    from repro_torch.models import model as M

    def one(c):
        if isinstance(c, AC.KVCache):
            return AC.KVCache(c.k.clone(),
                              None if c.v is None else c.v.clone(),
                              c.lengths.clone(), c.fmt, c.v_width)
        return {n: v.clone() for n, v in c.items()}

    prelude, groups = M.split_caches(caches)
    return M.join_caches([one(c) for c in prelude],
                         [[one(c) for c in grp] for grp in groups])


@contextlib.contextmanager
def _first_update_one_ulp_up(attention=False):
    """The control of the reference check: while open, the first state
    update that a decode step runs (layer 0 of the first step) returns its
    ``y`` moved one ulp up, every value -- for an attention model
    (``attention``), the first attention decode step its output; every
    later update is untouched."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.models import ssm as SSM
    owner, name, i = ((OPS, "attention_decode_step", 0) if attention
                      else (SSM, "_spu_state_update", 1))
    real, calls = getattr(owner, name), [0]

    def nudged(*args, **kwargs):
        out = list(real(*args, **kwargs))
        calls[0] += 1
        if calls[0] == 1:
            out[i] = torch.nextafter(out[i], torch.full_like(out[i],
                                                             math.inf))
        return tuple(out)

    setattr(owner, name, nudged)
    try:
        yield
    finally:
        setattr(owner, name, real)
    check(calls[0] > 0, "the control ran no update")


def _kernel_vs_plain_runs(params, cfg, batch, n_steps=4,
                          rounding="stochastic", control=False):
    """Greedy decode steps from one prefill of ``batch`` (tokens, and a
    patch prefix where the model has one), through the served path
    (CUDA kernels) and through the plain ops, MX8 state and KV at
    ``rounding``: two lists of logits, and with ``control`` a third: the
    plain ops again with layer 0's first ``y`` (attention output) moved
    one ulp."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM
    cfg, plain_cfg = (cfg.with_(state_quant=OPS.StateQuantConfig(
        "mx8", rounding, backend)) for backend in ("cuda", "torch"))
    logits, caches = M.prefill(params, cfg, batch)
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    S = sum(batch[k].shape[1] for k in ("patches", "tokens") if k in batch)
    attention = not set(cfg.pattern) & set(SSM.MIXERS)

    def run(c):
        cc = _clone_caches(caches)
        t = logits.argmax(-1)
        lens = torch.full((1,), S, dtype=torch.int32, device="cuda")
        seq = []
        for i in range(n_steps):
            lg, cc = M.decode_step(params, c, t, cc, lens + i, seed=i + 1)
            seq.append(lg)
            t = lg.argmax(-1)
        return seq

    runs = [run(cfg), run(plain_cfg)]
    if control:
        with _first_update_one_ulp_up(attention):
            runs.append(run(plain_cfg))
    check(bool(torch.isfinite(runs[0][0]).all()), "decode logits not finite")
    return runs


def _first_step_error(runs, other=0):
    """Max |run ``other`` - plain| of the first decode step's logits (run 0:
    the kernels), and whether it is within rtol 1e-3 of the plain logits
    (atol 1e-3 * max)."""
    a, b = runs[other][0], runs[1][0]
    within = bool(((a - b).abs() <= 1e-3 * (b.abs() + b.abs().max())).all())
    return float((a - b).abs().max()), within


def _agreement_4(runs, other=0):
    import numpy as np
    return np.mean([int(x.argmax()) == int(y.argmax())
                    for x, y in zip(runs[other], runs[1])])


def _first_flip(runs, other=0):
    """At the first decode step where run ``other``'s greedy token differs
    from the plain ops' (run 1): the step, the plain logits' top-2 gap,
    run ``other``'s max |logit difference| from them at that step, and the
    two token ids; None where every step agrees."""
    for i, (x, y) in enumerate(zip(runs[other], runs[1])):
        x, y = x.flatten(), y.flatten()
        if int(x.argmax()) != int(y.argmax()):
            top2 = y.topk(2).values
            return dict(step=i + 1, plain_top2_gap=float(top2[0] - top2[1]),
                        max_abs_diff=float((x - y).abs().max()),
                        tokens=(int(x.argmax()), int(y.argmax())))
    return None


def _token_batch(prompt):
    """A prefill batch of one request's ``prompt`` tokens, on the card."""
    import numpy as np
    import torch
    return {"tokens": torch.as_tensor(np.asarray(prompt)[None],
                                      device="cuda")}


def _reference_check(params, cfg, prompt, n=7):
    """The served path (CUDA kernels) against the plain ops on the same
    prefill: first-step logits to rtol 1e-3 (a few SR decisions may flip
    where the kernel's FMA and the plain fp64 emulation round apart) and
    the greedy token agreement over 4 steps."""
    runs = _kernel_vs_plain_runs(params, cfg, _token_batch(prompt))
    err, within = _first_step_error(runs)
    check(within, f"first decode step: kernels vs plain max err {err:.3g}")
    phase(n, "reference check (kernels vs plain ops, same prefill)",
          first_step_max_abs_err=f"{err:.3g}",
          greedy_agreement_4_steps=f"{_agreement_4(runs):.2f}")


def _reference_check_by_depth(params, cfg, batch, n):
    """The reference check at growing depth over one prefill of ``batch``
    (the recurrent models; since phase 48 paligemma-3b's patch prefix and
    text): the first g
    layer groups of the same weights, and first the pattern's first layer
    alone where a group holds more than one (xlstm's 7 mLSTM + 1 sLSTM).
    The contract of :func:`_reference_check` (first-step logits to rtol
    1e-3) is held there and at one group, where the two paths differ only
    in the few stochastic-rounding decisions that the kernel's FMA and the
    plain fp64 emulation round apart (at round to nearest they are
    bitwise: kernel 1's ``y`` sums in its plain version's order).
    Deeper, a last-bit difference in a layer's input moves state values
    across MX8 rounding boundaries, the layers after it see inputs that
    differ more, and the difference grows with depth.  The control
    measures that growth without the kernels: the plain ops
    against themselves with layer 0's first ``y`` moved one ulp, at the
    same depths and roundings.  Held at every depth and rounding: the
    kernels' difference is at most ``CONTROL_FACTOR`` times the control's
    (the kernels part from the plain ops no more than one ulp of one layer
    does); at round to nearest the greedy tokens of 4 steps at full depth
    are the plain ops'; and wherever the full-depth greedy tokens differ
    (gla at stochastic rounding), it is a tie: at the first step that
    differs, the plain logits' top-2 gap is at most the kernels' max
    |logit difference| there.  An attention model has no state update:
    its control moves layer 0's first attention output one ulp, and its
    kernels are held within rtol 1e-3 of the plain ops at every depth
    (the attention kernels' split order parts from the plain version's
    within rtol 2e-4, more than one ulp, so the ratio to the control is
    reported, not held)."""
    from repro_torch.models import ssm as SSM
    attention = not set(cfg.pattern) & set(SSM.MIXERS)
    depths = [g for g in sorted({1, 2, 4, 8, 16, cfg.n_groups})
              if g <= cfg.n_groups]
    cut = {g: (dict(params, groups=params["groups"][:g]),
               cfg.with_(n_layers=g * len(cfg.pattern))) for g in depths}
    if len(cfg.pattern) > 1:
        depths.insert(0, "layer")
        cut["layer"] = (dict(params, groups=[params["groups"][0][:1]]),
                        cfg.with_(pattern=cfg.pattern[:1], n_layers=1))
    errs, ctrl, full = {}, {}, {}
    for rounding in ("stochastic", "nearest"):
        for g in depths:
            runs = _kernel_vs_plain_runs(
                *cut[g], batch, n_steps=4 if g == cfg.n_groups else 1,
                rounding=rounding, control=True)
            errs[rounding, g] = _first_step_error(runs)
            ctrl[rounding, g] = _first_step_error(runs, other=2)
            if g in ("layer", 1) or attention:
                check(errs[rounding, g][1], f"first decode step, depth "
                      f"{g} (groups), {rounding}: kernels vs plain max err "
                      f"{errs[rounding, g][0]:.3g}")
        full[rounding] = runs
    for (r, g), (err, _) in errs.items():
        check(attention or err <= CONTROL_FACTOR * ctrl[r, g][0],
              f"{cfg.name}, depth {g} (groups), {r}: kernels vs plain "
              f"{err:.3g} beyond {CONTROL_FACTOR}x the one-ulp control "
              f"{ctrl[r, g][0]:.3g}")
    check(_agreement_4(full["nearest"]) == 1.0, f"{cfg.name}, full depth, "
          "round to nearest: greedy tokens differ from the plain ops'")
    flips = {r: _first_flip(runs) for r, runs in full.items()}
    for r, f in flips.items():
        if f is not None:
            check(f["plain_top2_gap"] <= f["max_abs_diff"],
                  f"{cfg.name}, full depth, {r}: greedy tokens differ at "
                  f"step {f['step']} with a plain top-2 gap "
                  f"{f['plain_top2_gap']:.6g} above the kernels' max |logit "
                  f"difference| {f['max_abs_diff']:.6g}: not a tie")
    fields = {}
    for r in full:
        fields[f"max_abs_err_by_groups_{r}"] = repr(
            {g: f"{errs[r, g][0]:.3g}" for g in depths})
        fields[f"control_by_groups_{r}"] = repr(
            {g: f"{ctrl[r, g][0]:.3g}" for g in depths})
    top = float(full["stochastic"][1][0].abs().max())
    phase(n, "reference check by depth (kernels vs plain ops, same prefill; "
          "control: plain vs plain with one y moved 1 ulp)",
          one_layer_and_group="within rtol 1e-3",
          every_depth="within rtol 1e-3" if attention
          else f"within {CONTROL_FACTOR}x control", **fields,
          full_depth_max_abs_logit=f"{top:.3g}",
          greedy_agreement_4_steps_full_depth=repr(
              {r: f"{_agreement_4(runs):.2f}" for r, runs in full.items()}),
          control_greedy_agreement_4_steps_full_depth=repr(
              {r: f"{_agreement_4(runs, 2):.2f}"
               for r, runs in full.items()}),
          first_differing_step=repr(
              {r: None if f is None else
               {k: (f"{v:.6g}" if isinstance(v, float) else v)
                for k, v in f.items()} for r, f in flips.items()}))


# ---------------------------------------------------------------------------
# the dense transformer family: opt-6.7b (the paper's baseline) and yi-9b
# (GQA) at full width and full depth
# ---------------------------------------------------------------------------

#: the family's attention widths: opt-6.7b G = 1 (a Kq = 4 verify pass: 4
#: rows a kv head), yi-9b G = 8 (32 rows: two row blocks of 16); ``n``: the
#: first of the model's three main-path phases
DENSE = {"opt-6.7b": dict(tag="opt", H=32, KVH=32, d=128, n=30,
                          full_layers=32),
         "yi-9b": dict(tag="yi", H=32, KVH=4, d=128, n=33, full_layers=48)}
DENSE_MAX_NEW = 16
#: their paged pool: four of the six requests at once, each prompt in one
#: prefill (zamba2's and gla's paths stream prompt tails through decode
#: and preempt)
DENSE_PAGED = dict(batch=4, n_pages=17, prefill_chunk=512)
#: layers of page pools in the kernel checks
DENSE_STACK = 4


def _dense_pool(lengths, w, n_stack, seed, Kq=KQ):
    """Page pools (P, n_stack, 128, KVH, d) of random MX8 K/V at the
    widths ``w``, a block table of shuffled non-contiguous page ids
    spanning each row's ``len + 1`` positions (the append slot included,
    bucketed to a power of two, scratch page 0 in its tail), and q ``(B,
    Kq, H, d)``."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    from repro_torch.serving.memory import bucket_pages
    need = [pages_for(n + 1) for n in lengths]
    P = 1 + sum(need)
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = (torch.randperm(P - 1, generator=g, device="cuda") + 1).tolist()
    bt = torch.zeros((len(lengths), bucket_pages(max(need))),
                     dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n])
        ids = ids[n:]
    shp = (P, n_stack, 128, w["KVH"], w["d"])
    K = F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
    V = F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
    q = torch.randn((len(lengths), Kq, w["H"], w["d"]), generator=g,
                    device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, K, V, bt.cuda(), lens


def _within(y, yp, label):
    err = (y - yp).abs()
    check(bool((err <= 2e-5 + 2e-4 * yp.abs()).all()), f"{label}: beyond "
          f"rtol 2e-4 atol 2e-5 (max err {float(err.max()):.3g})")
    return float(err.max())


def phase_dense_kernels(models=None, n=28):
    """Phase 28 (``models`` None: DENSE; phase 43: NEW_GQA at the last five
    configs' widths): the GQA kernels at opt-6.7b's widths (G = 1) and
    yi-9b's (G = 8, Kq * G = 32 query rows: two row blocks), against their
    plain versions (rtol 2e-4, atol 2e-5) over SPEC_LENGTHS: kernels 2 and
    3 (decode; kernel 3 bitwise kernel 2 over the gathered pages), kernels
    6 and 5 at Kq 1, 2, 4 (kernel 5 bitwise kernel 6, verify row j bitwise
    kernels 2 and 3 at length len - (Kq - 1 - j)); the fused
    quantize-and-append at KVH x 128 (bitwise its plain version and the
    replaced path); kernel 7 at a 400-token prefill's K stream (bitwise);
    and each kernel's blocks per SM.  Returns {key: max error}."""
    import torch
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_quant as K7
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    errs = {}
    for arch, w in (models or DENSE).items():
        tag, G = w["tag"], w["H"] // w["KVH"]
        e = dict.fromkeys(("2", "3", "5", "6"), 0.0)
        cases = 0
        for i, lengths in enumerate(SPEC_LENGTHS):
            q, K, V, bt, lens = _dense_pool(lengths, w, DENSE_STACK,
                                            seed=280 + 10 * i + G)
            group = 1 + i
            Kd, Vd = R.gather_pages(K, bt, group), R.gather_pages(V, bt, group)
            q1 = q[:, 0].contiguous()
            y2 = KA.mx_attention_decode(q1, Kd, Vd, lens)
            y3 = KP.mx_paged_attention_decode(q1, K, V, bt, group, lens)
            label = f"{arch} lengths={lengths}"
            e["2"] = max(e["2"], _within(y2, KA.plain(q1, Kd, Vd, lens),
                                         f"kernel 2 {label}"))
            e["3"] = max(e["3"], _within(
                y3, KP.plain(q1, K, V, bt, group, lens), f"kernel 3 {label}"))
            check(torch.equal(y3, y2), f"{label}: kernel 3 not bitwise "
                  "kernel 2 over the gathered pages")
            for Kq in (1, 2, 4):
                qk = q[:, :Kq].contiguous()
                lab = f"{label} Kq={Kq} rows={Kq * G}"
                y5 = KV.mx_paged_spec_attention_decode(qk, K, V, bt, group,
                                                       lens)
                y6 = KV.mx_spec_attention_decode(qk, Kd, Vd, lens)
                e["5"] = max(e["5"], _within(
                    y5, KV.plain_paged(qk, K, V, bt, group, lens),
                    f"kernel 5 {lab}"))
                e["6"] = max(e["6"], _within(
                    y6, KV.plain(qk, Kd, Vd, lens), f"kernel 6 {lab}"))
                check(torch.equal(y5, y6), f"{lab}: kernel 5 not bitwise "
                      "kernel 6 over the gathered pages")
                for j in range(Kq):
                    lj = lens - (Kq - 1 - j)
                    qj = qk[:, j].contiguous()
                    check(torch.equal(y6[:, j], KA.mx_attention_decode(
                        qj, Kd, Vd, lj)), f"{lab}: row {j} not bitwise "
                        "kernel 2 at the shifted length")
                    check(torch.equal(y5[:, j], KP.mx_paged_attention_decode(
                        qj, K, V, bt, group, lj)), f"{lab}: row {j} not "
                        "bitwise kernel 3 at the shifted length")
                cases += 1
        # the append slot of each row is its length: the table spans it
        n_app, e4 = _hold_append_quant([K, V], bt, 1, SPEC_LENGTHS[-1],
                                       seed=290 + G, label=f"{arch} K and V")
        # kernel 7 at one request's prefill K stream (400 tokens padded
        # to 512), values over 45 decades with zero groups
        g = torch.Generator(device="cuda").manual_seed(295 + G)
        x = torch.randn((1, 512, w["KVH"], w["d"]), generator=g,
                        device="cuda")
        x *= torch.pow(10.0, torch.randint(-40, 6, x.shape[:-1] + (1,),
                                           generator=g, device="cuda").float())
        x.view(-1, 16)[::7] = 0.0
        e7 = 0
        for rounding in ("nearest", "stochastic"):
            got, want = (K7.mx_quantize(x, 7, rounding=rounding),
                         K7.plain(x, rounding, 7))
            for f in want.payload:
                e7 = max(e7, int((got.payload[f].int()
                                  - want.payload[f].int()).abs().max()))
                check(torch.equal(got.payload[f], want.payload[f]),
                      f"mx_quantize {tuple(x.shape)} {rounding}: {f} "
                      "differs from the plain version")
        rows = KQ * G
        per_block = KA.split_block_rows(rows, G, w["d"])
        smem = [KA.split_smem_bytes(r, w["d"], w["d"]) / 1024
                for r in (G, per_block)]
        # decode (kernels 2, 3) and verify (5, 6): blocks whose shared
        # memory one SM holds
        occ = [KA.split_blocks_per_sm(r, G, w["d"], w["d"])
               for r in (G, rows)]
        phase(n, f"GQA kernels at {arch}'s widths vs plain", H=w["H"],
              KVH=w["KVH"], d=w["d"], G=G, cases=cases, Kq="1,2,4",
              verify_rows=rows,
              row_blocks=KA.split_row_blocks(rows, G, w["d"]),
              rows_per_block=per_block,
              smem_KB_decode_verify=f"{smem[0]:g},{smem[1]:g}",
              blocks_per_sm_decode_verify=f"{occ[0]},{occ[1]}",
              lengths=list(SPEC_LENGTHS),
              max_abs_err=repr({k: f"{v:.3g}" for k, v in e.items()}),
              tol="rtol2e-4,atol2e-5", paged_vs_dense="bitwise",
              row_j_vs_kernels_2_and_3="bitwise")
        phase(n, f"fused append and quantizer at {arch}'s widths",
              append_cases=n_app, append="bitwise (plain, replaced path)",
              quantizer_shape=tuple(x.shape), quantizer="bitwise")
        errs.update({f"e{k}_{tag}": v for k, v in e.items()})
        errs[f"apq_{tag}"] = float(e4)
        errs[f"k7_{tag}"] = float(e7)
        del q, K, V, Kd, Vd, x
        torch.cuda.empty_cache()
    return errs


def _sdpa(q, kf, vf, mask, gqa):
    import torch
    return torch.nn.functional.scaled_dot_product_attention(
        q, kf, vf, attn_mask=mask, enable_gqa=gqa)


def phase_dense_timing(models=None, phase_n=29):
    """Phase 29 (``models`` None: DENSE; phase 44: NEW_GQA): device times
    (CUDA-graph replay, inputs rotated so each launch finds them cold in
    L2) of kernels 2, 3, 6, 5 and the fused paged append at opt-6.7b's and
    yi-9b's widths (kernel 7's: phase 37): batch 4 at the main path's
    mid-decode lengths (``w["decode_lens"]`` where the model's prompts
    differ: paligemma's 256 patches before its text; verify: Kq = 4,
    lengths counting the appended rows); the yardstick is one
    ``scaled_dot_product_attention`` call (``enable_gqa`` for yi-9b) on the
    dequantized fp32 K/V, with a boolean mask.  Returns {kernels-line name:
    times}."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    it = iter(range(10 ** 9))
    out = {}
    sq = OPS.StateQuantConfig()
    for arch, w in (models or DENSE).items():
        tag, H, KVH, d = w["tag"], w["H"], w["KVH"], w["d"]
        G, gqa = H // KVH, H != KVH
        dec = list(w.get("decode_lens", [n + DENSE_MAX_NEW // 2
                                         for n in PROMPT_LENS[:4]]))
        ver = [n + KQ for n in dec]
        n_stack = _rotation(sum(ver) * KVH * 2 * d * 1.125)
        q, K, V, bt, lens_v = _dense_pool(ver, w, n_stack, seed=300 + G)
        lens_d = torch.tensor(dec, dtype=torch.int32, device="cuda")
        q1 = q[:, 0].contiguous()
        T = bt.shape[1] * 128
        dense = [(R.gather_pages(K, bt, g), R.gather_pages(V, bt, g))
                 for g in range(n_stack)]
        deq = [(F.dequantize(kd).permute(0, 2, 1, 3).contiguous(),
                F.dequantize(vd).permute(0, 2, 1, 3).contiguous())
               for kd, vd in dense]
        pos = torch.arange(T, device="cuda")
        mask_d = (pos[None, :] < lens_d[:, None])[:, None, None, :]
        shift = torch.arange(KQ, device="cuda") - (KQ - 1)
        mask_v = (pos[None, None, :] < (lens_v[:, None] + shift[None, :])
                  [:, :, None])[:, None]
        qh1 = q1[:, :, None, :]
        qh = q.permute(0, 2, 1, 3).contiguous()
        lib_d = [lambda t=t: _sdpa(qh1, *t, mask_d, gqa) for t in deq]
        lib_v = [lambda t=t: _sdpa(qh, *t, mask_v, gqa) for t in deq]
        # the yardsticks compute the same functions as the kernels
        for lib, y in ((lib_d[0](), KA.mx_attention_decode(
                            q1, *dense[0], lens_d)[:, :, None]),
                       (lib_v[0]().permute(0, 2, 1, 3),
                        KV.mx_spec_attention_decode(q, *dense[0], lens_v))):
            check(bool(((lib.reshape(y.shape) - y).abs()
                        <= 1e-4 + 1e-3 * y.abs()).all()),
                  f"{arch}: SDPA yardstick disagrees with the kernel")
        io_d = 4 * 4 * H * 2 * d + 4 * 4
        io_v = 4 * 4 * KQ * H * 2 * d + 4 * 4
        cache_d = sum(dec) * KVH * 2 * d * (1 + 2 / F.MX8_GROUP)
        cache_v = sum(ver) * KVH * 2 * d * (1 + 2 / F.MX8_GROUP)
        tbl_d = 4 * sum(pages_for(n) for n in dec)
        tbl_v = 4 * sum(pages_for(n) for n in ver)
        row_pos = sum(n - (KQ - 1 - j) for n in ver for j in range(KQ))

        def plan_bytes(kind, n, layout):
            dims = dict(B=1, T=n, KVH=KVH, dk=d, dv=d, H=H)
            if kind == "spec_verify":
                dims.update(n=1, Kq=KQ)
                return OPS.traffic(OPS.registry.plan(
                    kind, dims, sq, "cuda", layout=layout)).total
            return OPS.traffic(OPS.plan_attn_decode_dims(
                dims, sq, layout=layout)).state_read

        for name, kern, plain, lib, nbytes, flops, kind, lens, layout in (
                (f"mx_attention_decode[{tag}]",
                 [lambda c=c: KA.mx_attention_decode(q1, *c, lens_d)
                  for c in dense],
                 [lambda c=c: KA.plain(q1, *c, lens_d) for c in dense[:3]],
                 lib_d, cache_d + io_d, sum(dec) * H * 4 * d, "attn", dec,
                 "dense"),
                (f"mx_paged_attention_decode[{tag}]",
                 [lambda g=g: KP.mx_paged_attention_decode(
                     q1, K, V, bt, g, lens_d) for g in range(n_stack)],
                 [lambda g=g: KP.plain(q1, K, V, bt, g, lens_d)
                  for g in range(3)],
                 lib_d, cache_d + io_d + tbl_d, sum(dec) * H * 4 * d,
                 "attn", dec, "paged"),
                (f"mx_paged_spec_attention_decode[{tag}]",
                 [lambda g=g: KV.mx_paged_spec_attention_decode(
                     q, K, V, bt, g, lens_v) for g in range(n_stack)],
                 [lambda g=g: KV.plain_paged(q, K, V, bt, g, lens_v)
                  for g in range(3)],
                 lib_v, cache_v + io_v + tbl_v, row_pos * H * 4 * d,
                 "spec_verify", ver, "paged"),
                (f"mx_spec_attention_decode[{tag}]",
                 [lambda c=c: KV.mx_spec_attention_decode(q, *c, lens_v)
                  for c in dense],
                 [lambda c=c: KV.plain(q, *c, lens_v) for c in dense[:3]],
                 lib_v, cache_v + io_v, row_pos * H * 4 * d,
                 "spec_verify", ver, "dense")):
            ms = graph_ms(kern, 10)
            plain_ms = graph_ms(plain, 3)
            lib_ms = graph_ms(lib, 10)
            host_ms = host_loop_ms(lambda k=kern: k[next(it) % n_stack](),
                                   10 * n_stack)
            out[name] = _report(name, ms, plain_ms, lib_ms, host_ms, nbytes,
                                flops, sum(plan_bytes(kind, n, layout)
                                           for n in lens), n=phase_n)
        del dense, deq, lib_d, lib_v
        plan = OPS.registry.plan("kv_append", dict(B=4, T=1, KVH=KVH, dk=d,
                                                   dv=d, n=1),
                                 sq, "cuda", layout="paged")
        out[f"mx_paged_kv_append[quant,{tag}]"] = _time_append_quant(
            [K, V], bt, lens_d, n_stack, f"mx_paged_kv_append[quant,{tag}]",
            OPS.traffic(plan).total, n=phase_n)
        del q, K, V
        phase(phase_n, f"{arch} timing shapes", B=4, decode_lengths=dec,
              verify_lengths=ver, Kq=KQ, layers_rotated=n_stack)
        torch.cuda.empty_cache()
    return out


def _dense_model(arch, w):
    """A GQA model at full width (``w``: its widths, and ``layers`` where
    its depth is cut)."""
    from repro_torch.configs import get_config
    cfg, params, info = _model_at(arch, w.get("layers"))
    check(get_config(arch).n_layers == w["full_layers"]
          and cfg.n_heads == w["H"] and cfg.n_kv_heads == w["KVH"]
          and cfg.head_dim == w["d"], f"unexpected {cfg.name}")
    if "reduced" in w:
        info["reduced"] = repr(w["reduced"])
    return cfg, params, info


def _verify_invariance(params, cfg):
    """The verify step's trouble spot on the card, at this model's shapes:
    row i of ``(B, Kq, d) @ W`` against the contiguous ``(B, 1, d) @ W`` of
    position i, bitwise, for the matrices of the first and last layer of
    the pattern and the LM head (fp32, TF32 off; the verify step runs its
    products position by position, so these only report), and the norm
    (RMSNorm or LayerNorm: its reductions run over all Kq positions at
    once), which gates greedy exactness.  Returns {name: bool}."""
    import torch
    from repro_torch.models import layers as L
    g = torch.Generator(device="cuda").manual_seed(7)
    layer = params["groups"][0][0]
    weights = {}
    for pos in sorted({0, len(cfg.pattern) - 1}):
        kind, lp = cfg.pattern[pos], params["groups"][0][pos]
        # not the mLSTM's conv taps and per-head tables, nor the block-
        # diagonal (H, dk, dk) projections, which lead with H = 4; not the
        # experts' (E, d, d_expert) stacks (MoE routes all B * Kq tokens
        # at once)
        weights.update({f"{kind}_{k}": v for k, v in lp["mixer"].items()
                        if v.shape[0] > 16})
        weights.update({f"ffn_{k}": v for k, v in lp.get("ffn", {}).items()
                        if v.dim() == 2})
    weights["lm_head"] = (params["embed"].T if cfg.tie_embeddings
                          else params["lm_head"])
    out = {}
    B = 4
    for name, w in weights.items():
        x = torch.randn((B, KQ, w.shape[0]), generator=g, device="cuda")
        full = x @ w
        out[name] = all(torch.equal(full[:, i:i + 1],
                                    x[:, i:i + 1].contiguous() @ w)
                        for i in range(KQ))
    x = torch.randn((B, KQ, cfg.d_model), generator=g, device="cuda") * 3
    for norm in (params["final_norm"], layer["norm"]):
        full = L.apply_norm(norm, x, cfg.norm_kind, cfg.norm_eps)
        out[cfg.norm_kind] = out.get(cfg.norm_kind, True) and all(
            torch.equal(full[:, i:i + 1], L.apply_norm(
                norm, x[:, i:i + 1].contiguous(), cfg.norm_kind,
                cfg.norm_eps)) for i in range(KQ))
    return out


def phase_dense(arch, w):
    """``arch`` (opt-6.7b or yi-9b at full width and full depth; since
    phase 45 smollm-360m, yi-34b and dbrx-132b at full width, ``w["layers"]``
    deep) through the slot pool (phase n), the paged pool (n + 1; paged
    logits bitwise the dense-gather path's on a fresh pool first) and the
    paged pool with n-gram speculation (n + 2), ``w["requests"]`` of the
    PROMPT_LENS prompts with ``w["max_new"]`` new tokens each.  Every decode
    step launches the GQA
    attention kernel of its path once per layer (kernel 2 on the slot
    pool, 3 on the paged pool, 5 per verify step), the fused append of its
    pool once per layer and position (dense on the slot pool, paged on the
    paged paths), and nothing else of the port's kernels; every request's
    prefill kernel 7 once per layer (K and V in one launch).  The verify
    step's norm is checked for row invariance, which gates greedy
    exactness (spec == plain at round to nearest) and the pool-level
    verify-vs-sequential check.  An MoE model routes a verify step's B * Kq
    tokens together where a plain step routes B, and expert capacity
    couples them: its pool-level check at batch 4 only reports, and its
    greedy exactness runs at batch 1, where no expert can overflow."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    n = w["n"]
    max_new = w.get("max_new", DENSE_MAX_NEW)
    cfg, params, info = _dense_model(arch, w)
    L = cfg.n_layers
    phase(n, f"{arch} weights", **info)
    rng = np.random.default_rng(n)
    prompts = _pattern_prompts(rng, cfg)[:w.get("requests", 6)]
    k7 = _k7_per_prefill(cfg)
    moe = cfg.moe is not None

    eng = Engine(params, cfg, ServeConfig(backend="slots", batch=4,
                                          cache_capacity=1024))
    slot = _serve_counted(eng, cfg, prompts, max_new,
                          dict(k2_gqa=L, apd=L), k7, f"{arch} slots")
    kv = sum(_payload_bytes(c.k) + _payload_bytes(c.v)
             for c in M.iter_kv_caches(eng.engine.caches))
    phase(n, f"main path {arch} slots", **_fields(slot),
          kv_MB=f"{kv / 1e6:.2f}")
    slot["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), n,
                                   before=EAGER_APPEND_PROFILE.get(arch))
    _reference_check(params, cfg, prompts[0], n=n)
    del eng

    eng = Engine(params, cfg, ServeConfig(**DENSE_PAGED))
    shape = _paged_vs_gather(eng, cfg, rng)
    phase(n + 1, f"{arch} paged vs gather logits, fresh pool", steps=4,
          logits=tuple(shape), result="bit-identical")
    paged = _serve_counted(eng, cfg, prompts, max_new,
                           dict(k3_gqa=L, k4q=L), k7, f"{arch} paged")
    pool = eng.engine.pool
    phase(n + 1, f"main path {arch} paged", **_fields(paged),
          preemptions=int(paged["stats"]["preemptions"]),
          pages=f"{pool.n_pages}x{pool.page_nbytes}B",
          gather_MB=f"{paged['stats']['gather_bytes'] / 1e6:.2f}")
    paged["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), n + 1)
    del eng

    rows = _verify_invariance(params, cfg)
    invariant = rows[cfg.norm_kind]
    phase(n + 2, "matmul and norm row invariance, (B,Kq,d) rows vs (B,1,d), "
          "fp32, TF32 off", B=4, Kq=KQ,
          rows=repr({k: int(v) for k, v in rows.items()}),
          verify_products="per position", norm=cfg.norm_kind,
          remaining_batched_op_invariant=invariant)
    eng = Engine(params, cfg, ServeConfig(**DENSE_PAGED, spec="ngram",
                                          spec_k=SPEC_K))
    spec = _serve_counted(eng, cfg, prompts, max_new,
                          dict(k5_gqa=L, k4q=L * KQ), k7,
                          f"{arch} paged + ngram")
    st = spec["stats"]
    agree, first = _agreement(paged["outputs"], spec["outputs"])
    phase(n + 2, f"main path {arch} paged + ngram speculation", Kq=KQ,
          **_fields(spec), proposed=int(st["proposed_tokens"]),
          accepted=int(st["accepted_tokens"]),
          acceptance_rate=f"{st['acceptance_rate']:.3f}",
          preemptions=int(st["preemptions"]),
          vs_paged_other_sr_seeds="equal" if first is None else
          f"agreement {agree:.3f}, first difference at token {first}")
    spec["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), n + 2)
    _spec_rollback_check(eng, cfg, rng, invariant and not moe, phase_n=n + 2)
    del eng
    _greedy_exactness(params, cfg, prompts, invariant, n=n + 2,
                      max_new=max_new,
                      paged=dict(DENSE_PAGED, batch=1) if moe else DENSE_PAGED)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(slot=slot, paged=paged, spec=spec, invariant=invariant)


# ---------------------------------------------------------------------------
# the slot pool's fused dense append and kernel 7's two-stream launch
# ---------------------------------------------------------------------------

#: the slot pools' appended streams: (label, KVH, width, streams) --
#: zamba2's shared attention, opt-6.7b's and yi-9b's K and V, deepseek's
#: latent -- and the layers whose caches a decode step walks
APPEND_WIDTHS = (("zamba2", 32, 80, 2, N_STACK), ("opt", 32, 128, 2, 32),
                 ("yi", 4, 128, 2, 48), ("mla", 1, 576, 1, DS_LAYERS))
#: the slot caches' capacity (every slot path's ``cache_capacity``)
SLOT_T = 1024
#: the dense-append checks' lengths: an empty row, one mid-cache, T - 2
#: (clamped to T - Kq at n = Kq) and an idle slot's, past T
SLOT_LENGTHS = (0, 400, SLOT_T - 2, SLOT_T + 9)
#: kernel 7's prefill checks: (label, stream shape, pad_to) -- two gla
#: states, opt-6.7b's and yi-9b's 400-token K and V padded to the tile
K7_STREAMS = (("gla state", GLA_SU[0][1], None),
              ("opt K/V", (1, 400, 32, 128), 512),
              ("yi K/V", (1, 400, 4, 128), 512))


def _spread(shape, g, mag=None):
    """Values over 45 decades (``mag`` None) or at magnitude ``mag``, every
    seventh 16-value group zero."""
    import torch
    x = torch.randn(shape, generator=g, device="cuda")
    if mag is None:
        x *= torch.pow(10.0, torch.randint(-40, 6, shape[:-1] + (1,),
                                           generator=g, device="cuda").float())
    else:
        x *= mag
    x.view(-1, 16)[::7] = 0.0
    return x


def phase_dense_append(widths=None, k7_streams=None, phase_n=36):
    """Phase 36 (phase 43 with the last five configs' ``widths`` and
    ``k7_streams``): the fused dense append (``mx_kv_append_quant``) at every
    served model's slot-pool streams (zamba2's K and V, 32 x 80; opt-6.7b's,
    32 x 128; yi-9b's, 4 x 128; deepseek's latent, 576) into caches of
    SLOT_T tokens, n = 1 and n = Kq new rows, lengths SLOT_LENGTHS (the
    last past T - n), magnitudes APPEND_MAGS, both roundings: every cache
    byte equal to its plain version's and to the replaced path's (the
    ``torch`` backend's ``kv_append`` on the card: the eager quantize and
    ``_update_at``), every byte outside the appended slots unchanged.
    Then kernel 7's two-stream launch at K7_STREAMS (padded to the tile in
    the launch where the prefill pads), values over 45 decades and at the
    four magnitudes, both roundings: bitwise its plain version and a
    one-stream ``mx_quantize`` per stream on the padded copy.  Returns
    {key: max byte difference}."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import attention_cache as AC
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_quant as K7
    errs = {}
    B = len(SLOT_LENGTHS)
    lens = torch.tensor(SLOT_LENGTHS, dtype=torch.int32, device="cuda")
    fields = ("mantissa", "exponent", "micro")
    for label, KVH, w, k, _ in widths or APPEND_WIDTHS:
        g = torch.Generator(device="cuda").manual_seed(360 + w)
        base = [F.mx8_quantize(torch.randn((B, SLOT_T, KVH, w), generator=g,
                                           device="cuda")) for _ in range(k)]
        worst = cases = 0
        for n, mag, rounding in itertools.product(
                (1, KQ), APPEND_MAGS, ("nearest", "stochastic")):
            rows = [torch.randn((B, n, KVH, w), generator=g, device="cuda")
                    * mag for _ in range(k)]
            rows[0].view(-1, 16)[::5] = 0.0
            seed = 0xFFFFFFFF - cases            # V's seed wraps past 2^32
            kern, plain, eager = ([c.clone() for c in base] for _ in "kpe")
            K7.mx_kv_append_quant(rows, kern, lens, seed, rounding=rounding)
            K7.plain_append(rows, plain, lens, seed, rounding)
            cache = AC.KVCache(eager[0], eager[1] if k == 2 else None,
                               lens.clone(), "mx8", None if k == 2 else 512)
            OPS.kv_append(cache, rows[0], rows[1] if k == 2 else None,
                          OPS.StateQuantConfig("mx8", rounding, "torch"),
                          seed=seed)
            torch.cuda.synchronize()
            start = lens.long().clamp(0, SLOT_T - n)
            keep = torch.ones((B, SLOT_T), dtype=torch.bool, device="cuda")
            for b in range(B):
                keep[b, int(start[b]):int(start[b]) + n] = False
            for i in range(k):
                for f in fields:
                    x = kern[i].payload[f]
                    worst = max(worst, int((x.int() - plain[i].payload[f]
                                            .int()).abs().max()))
                    where = (f"dense append {label} n={n} magnitude {mag:g} "
                             f"{rounding}: stream {i} {f}")
                    check(torch.equal(x, plain[i].payload[f]),
                          f"{where} differs from the plain version")
                    check(torch.equal(x, eager[i].payload[f]),
                          f"{where} differs from the replaced path (the "
                          "torch op's eager quantize + _update_at)")
                    check(torch.equal(x[keep], base[i].payload[f][keep]),
                          f"{where} changed outside the appended slots")
            cases += 1
            del kern, plain, eager, cache
        errs[f"apd_{label}"] = float(worst)
        phase(phase_n, f"fused dense append at {label}'s widths", KVH=KVH,
              w=w,
              streams=k, T=SLOT_T, lengths=SLOT_LENGTHS,
              new_rows=f"1,{KQ}",
              magnitudes=",".join(f"{m:g}" for m in APPEND_MAGS),
              roundings="nearest,stochastic", cases=cases,
              result="bitwise (plain version, replaced torch op; other "
              "slots untouched)")
        del base
    worst = cases = 0
    k7_streams = k7_streams or K7_STREAMS
    for label, shape, pad_to in k7_streams:
        g = torch.Generator(device="cuda").manual_seed(370 + shape[-1])
        for mag, rounding in itertools.product((None,) + APPEND_MAGS,
                                               ("nearest", "stochastic")):
            xs = [_spread(shape, g, mag), _spread(shape, g, mag)]
            seeds = [cases, 0xFFFFFFFF - cases]
            got = K7.mx_quantize_streams(xs, seeds, rounding=rounding,
                                         pad_to=pad_to)
            want = K7.plain_streams(xs, seeds, rounding, pad_to)
            for x, q, p, s in zip(xs, got, want, seeds):
                if pad_to is not None:
                    x = torch.nn.functional.pad(
                        x, (0, 0, 0, 0, 0, pad_to - shape[1]))
                one = K7.mx_quantize(x, s, rounding=rounding)
                torch.cuda.synchronize()
                for f in fields:
                    worst = max(worst, int((q.payload[f].int() - p.payload[f]
                                            .int()).abs().max()))
                    where = (f"kernel 7, two streams, {label} {shape} "
                             f"magnitude {mag} {rounding}: {f}")
                    check(torch.equal(q.payload[f], p.payload[f]),
                          f"{where} differs from the plain version")
                    check(torch.equal(q.payload[f], one.payload[f]),
                          f"{where} differs from a one-stream launch")
            cases += 1
            del xs, got, want
    errs[f"k7_streams_{phase_n}"] = float(worst)
    phase(phase_n, "kernel 7, two streams a launch, vs plain and vs one "
          "stream",
          shapes=[f"{lab} {s}" + (f" padded to {p}" if p else "")
                  for lab, s, p in k7_streams], cases=cases,
          values="45 decades," + ",".join(f"{m:g}" for m in APPEND_MAGS),
          roundings="nearest,stochastic", max_abs_err=worst,
          result="bitwise (mantissa, exponent, micro)")
    torch.cuda.empty_cache()
    return errs


def phase_dense_append_timing(widths=None, k7_prefills=(("opt", 32, 128),
                                                         ("yi", 4, 128)),
                              n=37):
    """Phase 37 (phase 44 with the last five configs' ``widths`` and
    ``k7_prefills``): device times by CUDA-graph replay.  The fused dense append
    at each slot path's streams, B = 4, n = 1, mid-decode lengths, walking
    the caches of the model's attention layers as a decode step does;
    beside it its plain version, the path it replaced (the ``torch``
    backend's ``kv_append``: the eager quantize + ``_update_at``) and the
    host time of one ``OPS.kv_append`` call through each backend.  Bound:
    bytes, the fp32 rows read once and their MX8 payload written once, and
    the lengths.  Then kernel 7 at opt-6.7b's and yi-9b's prefill (one
    request of 400 tokens): the path's launch (K and V of (1, 400, KVH,
    128), padded to 512 in the launch), the path it replaced (``F.pad`` and
    one launch a stream), one stream of (1, 512, KVH, 128) (the shape timed
    before the two-stream launch existed), and the least launch, one
    16-value group, by the same method.  Inputs rotate so each launch finds
    them cold in L2.  No single PyTorch call quantizes to MX8: the library
    times are null.  Returns {kernels-line name: times}."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.core import attention_cache as AC
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_quant as K7
    it = iter(range(10 ** 9))
    out = {}
    B = 4
    lens = torch.tensor([n + DENSE_MAX_NEW // 2 for n in PROMPT_LENS[:B]],
                        dtype=torch.int32, device="cuda")
    cuda_cfg = OPS.StateQuantConfig()
    torch_cfg = OPS.StateQuantConfig("mx8", "stochastic", "torch")
    for label, KVH, w, k, L in widths or APPEND_WIDTHS:
        name = ("mx_kv_append_quant" if label == "zamba2"
                else f"mx_kv_append_quant[{label}]")
        g = torch.Generator(device="cuda").manual_seed(380 + w)
        caches = [[F.mx8_quantize(torch.randn((B, SLOT_T, KVH, w),
                                              generator=g, device="cuda"))
                   for _ in range(k)] for _ in range(L)]
        rows = [torch.randn((B, 1, KVH, w), generator=g, device="cuda")
                for _ in range(k)]
        kv = [AC.KVCache(c[0], c[1] if k == 2 else None, lens, "mx8",
                         None if k == 2 else 512) for c in caches]
        v_row = rows[1] if k == 2 else None
        kern = [lambda c=c, i=i: K7.mx_kv_append_quant(rows, c, lens, i)
                for i, c in enumerate(caches)]
        plain = [lambda c=c, i=i: K7.plain_append(rows, c, lens, i)
                 for i, c in enumerate(caches)]
        replaced = [lambda c=c, i=i: OPS.kv_append(c, rows[0], v_row,
                                                   torch_cfg, seed=i)
                    for i, c in enumerate(kv)]
        ms = graph_ms(kern, 50)
        plain_ms = graph_ms(plain, 5)
        replaced_ms = graph_ms(replaced, 5)
        host_ms = host_loop_ms(lambda: kern[next(it) % L](), 30 * L)
        op_ms = host_loop_ms(lambda: OPS.kv_append(kv[0], rows[0], v_row,
                                                   cuda_cfg, seed=3), 30 * L)
        replaced_host_ms = host_loop_ms(lambda: OPS.kv_append(
            kv[0], rows[0], v_row, torch_cfg, seed=3), 30 * L)
        n_val = B * KVH * w * k
        plan = OPS.registry.plan("kv_append", dict(
            B=B, T=1, KVH=KVH, dk=w, dv=w if k == 2 else 0, n=1), cuda_cfg,
            "cuda")
        out[name] = _report(name, ms, plain_ms, None, host_ms,
                            n_val * (4 + 1 + 2 / F.MX8_GROUP) + 4 * B,
                            5 * n_val, OPS.traffic(plan).total, n=n)
        phase(n, f"{name} vs the replaced path", layers=L,
              replaced_ms=f"{replaced_ms:.5f}",
              fused_faster=f"{replaced_ms / ms:.2f}x",
              per_step_layers_ms=f"{L * ms:.5f} vs {L * replaced_ms:.5f}",
              host_kv_append_op_ms=f"{op_ms:.5f}",
              host_replaced_op_ms=f"{replaced_host_ms:.5f}",
              host_faster=f"{replaced_host_ms / op_ms:.2f}x")
        del caches, kv, kern, plain, replaced
        torch.cuda.empty_cache()
    # the least launch of kernel 7: one group, the same method
    xs = [torch.randn((1, 16), device="cuda") for _ in range(64)]
    floor_ms = graph_ms([lambda x=x: K7.mx_quantize(x) for x in xs], 50)
    for tag, KVH, d in k7_prefills:
        shape = (1, 400, KVH, d)
        n_in, n_out = 2 * math.prod(shape), 2 * 512 * KVH * d
        n_rot = _rotation(4 * n_in)
        g = torch.Generator(device="cuda").manual_seed(390 + KVH)
        xs = [[torch.randn(shape, generator=g, device="cuda")
               for _ in "kv"] for _ in range(n_rot)]
        kern = [lambda x=x: K7.mx_quantize_streams(x, pad_to=512)
                for x in xs]
        plain = [lambda x=x: K7.plain_streams(x, [0, 0], "nearest", 512)
                 for x in xs[:8]]
        replaced = [lambda x=x: [K7.mx_quantize(torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, 112))) for a in x] for x in xs]
        ms = graph_ms(kern, 10)
        plain_ms = graph_ms(plain, 3)
        replaced_ms = graph_ms(replaced, 10)
        host_ms = host_loop_ms(lambda: kern[next(it) % n_rot](), 10 * n_rot)
        name = f"mx_quantize[{tag}]"
        out[name] = _report(name, ms, plain_ms, None, host_ms,
                            4 * n_in + n_out * (1 + 2 / F.MX8_GROUP),
                            5 * n_out, 4 * n_in + n_out * 9 / 8, n=n)
        one = (1, 512, KVH, d)
        n_one = math.prod(one)
        ys = [torch.randn(one, generator=g, device="cuda")
              for _ in range(_rotation(4 * n_one))]
        one_ms = graph_ms([lambda y=y: K7.mx_quantize(y) for y in ys], 10)
        one_bound = n_one * (4 + 1 + 2 / F.MX8_GROUP) / PEAK_BYTES_PER_S * 1e3
        phase(n, f"{name}: the prefill's K and V, one launch", shape=shape,
              pad_to=512, replaced_ms=f"{replaced_ms:.5f}",
              replaced="F.pad + one launch a stream",
              fused_faster=f"{replaced_ms / ms:.2f}x",
              one_stream_shape=one, one_stream_ms=f"{one_ms:.5f}",
              one_stream_bound_ms=f"{one_bound:.5f}",
              least_launch_one_group_ms=f"{floor_ms:.5f}")
        del xs, ys, kern, plain, replaced
        torch.cuda.empty_cache()
    return out

# ---------------------------------------------------------------------------
# xlstm-1.3b (mLSTM + sLSTM) at full width and full depth
# ---------------------------------------------------------------------------

def phase_xlstm_kernels():
    """Phase 38: kernel 1 at xlstm-1.3b's mLSTM heads (4, 4, 1040, 1024):
    64 groups a row, the normalizer row at 8 to ~50 times the state and 15
    zero rows a head (the zero-group path), scalar decay, dense mode and
    slab mode (n_stack 6, layer 4), both roundings, state magnitudes
    APPEND_MAGS: mantissa, exponent and micro bitwise the plain version, y
    bitwise where the state matches (its largest difference over all rows
    printed by state magnitude; the kernels line takes magnitude 1's).
    Then kernel 7 at the mLSTM's prefill states, bitwise."""
    import torch
    mism = total = 0
    err = {m: 0.0 for m in APPEND_MAGS}
    for rounding, mag in itertools.product(("stochastic", "nearest"),
                                           APPEND_MAGS):
        seed = 38 + APPEND_MAGS.index(mag)
        for n_bad, n, e in (
                _su_case(XLSTM_SU, rounding, mag, True, seed, mlstm=True),
                _slab_case(XLSTM_SU, gen_seed=seed, sr_seed=0xFFFFFFF0 + seed,
                           rounding=rounding, mag=mag, mlstm=True)):
            mism, total, err[mag] = mism + n_bad, total + n, max(err[mag], e)
        torch.cuda.empty_cache()
    check(mism == 0, f"kernel 1 at xlstm's heads: {mism} of {total} "
          "mantissas differ from the plain version")
    phase(38, "mx_state_update at xlstm-1.3b's mLSTM heads vs plain",
          shape=XLSTM_SU, modes="dense,slab", decay="scalar",
          normalizer_row="8-50x the state, rows 1025-1039 zero",
          state_magnitude=",".join(f"{m:g}" for m in APPEND_MAGS),
          roundings="stochastic,nearest", mantissa_exp_micro="bitwise",
          values=total, y_max_abs_err_by_magnitude=repr(
              {f"{m:g}": f"{e:.3g}" for m, e in err.items()}))
    n_vals, k7_err = _hold_quant(XLSTM_K7, seed0=38)
    phase(38, "mx_quantize at xlstm-1.3b's prefill states vs plain",
          shapes=list(XLSTM_K7), values=n_vals,
          roundings="nearest,stochastic", max_abs_err=k7_err,
          result="bitwise (mantissa, exponent, micro)")
    return {"su_xlstm": err[1.0], "k7_xlstm": float(k7_err)}


def phase_xlstm_timing():
    """Phase 39: device times by CUDA-graph replay, inputs rotated cold in
    L2: kernel 1 dense and slab at XLSTM_SU (scalar decay), kernel 7 at one
    request's prefill state (1, 4, 1040, 1024).  No single PyTorch call
    updates or makes an MX8 state: the library times are null."""
    import torch
    out = {"mx_state_update[xlstm]": _time_su(
               "mx_state_update[xlstm]", XLSTM_SU, True, "dense", n=39),
           "mx_state_update[xlstm_slab]": _time_su(
               "mx_state_update[xlstm_slab]", XLSTM_SU, True, "slab", n=39),
           "mx_quantize[xlstm]": _time_k7("mx_quantize[xlstm]", XLSTM_K7[0],
                                          n=39)}
    torch.cuda.empty_cache()
    return out


def _xlstm_model():
    """xlstm-1.3b at full width and all 48 layers (6 groups of 7 mLSTM + 1
    sLSTM)."""
    cfg, params, info = _model_at("xlstm-1.3b")
    check(cfg.n_layers == 48 and cfg.d_model == 2048
          and cfg.pattern.count("mlstm") * cfg.n_groups == 42,
          f"unexpected {cfg.name}")
    return cfg, params, info


def _slstm_prefill_share(params, cfg, rng, n=40, length=400):
    """The sLSTM's share of one request's prefill of ``length`` tokens: its
    six layers run the cell position by position in plain PyTorch (no SPU
    op, no kernel).  Each sLSTM forward is timed between device
    synchronisations, and so is the whole prefill around it."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM
    real, spent = SSM.MIXERS["slstm"], []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real.forward(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, length),
                          device="cuda")[None]
    M.prefill(params, cfg, {"tokens": tok[:, :64]})          # warm up
    SSM.MIXERS["slstm"] = real._replace(forward=timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.prefill(params, cfg, {"tokens": tok})
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        SSM.MIXERS["slstm"] = real
    check(len(spent) == cfg.pattern.count("slstm") * cfg.n_groups,
          f"timed {len(spent)} sLSTM layers")
    phase(n, "sLSTM share of a prefill", prompt_tokens=length,
          slstm_layers=len(spent), prefill_s=f"{total:.3f}",
          slstm_s=f"{sum(spent):.3f}", slstm_share=f"{sum(spent) / total:.3f}")
    return dict(prefill_s=total, slstm_s=sum(spent))


def _spill_resume_check(eng, cfg, rng, n=41):
    """Spill and resume at the pool level: a slab-only model is never
    preempted through the page headroom check, so a live request is
    spilled (``extract_request`` into a host blob) and re-pinned
    (``insert_blob``) on another slab, the freed one overwritten first.
    Every slab leaf (the mLSTM state, its conv tail, the sLSTM's c, n, m,
    h) must come back bitwise, and the request's next steps must equal
    those of the uninterrupted run, bitwise."""
    import numpy as np
    import torch
    from repro_torch.core.paged import pages_for
    from repro_torch.models import model as M
    pool, params = eng.engine.pool, eng.engine.params
    rid, other = 30_000, 30_001
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, 97),
                             device="cuda")[None]
    logits, row = M.prefill(params, cfg, {"tokens": prompt})
    check(pool.register(rid, pages_for(97 + 8)), "no pages for the spill")
    pool.insert_prefill(rid, row)
    rids = [rid, None, None, None]

    def steps(t, L, k, seed0):
        out = []
        for i in range(k):
            lg = pool.decode(params, rids, np.array([t, 0, 0, 0]),
                             np.array([L + i, 0, 0, 0], np.int32),
                             seed=seed0 + i)
            out.append(lg[0].clone())
            t = int(lg[0].argmax())
        return out, t

    _, t = steps(int(logits[0].argmax()), 97, 2, 1)
    snapshot = [p.clone() for p in pool.pools]
    want, _ = steps(t, 99, 3, 3)
    for p, s_ in zip(pool.pools, snapshot):
        p.copy_(s_)
    slab = pool.slab_of[rid]
    before = [p[slab].clone() for p in pool.pools]
    sp = pool.spill(rid, 99)
    for p in pool.pools:
        p[slab] = 3
    check(pool.register(other, 1), "no slab for the second request")
    check(pool.resume(rid, sp), "resume refused")
    new = pool.slab_of[rid]
    check(new != slab, "resumed on the slab it left")
    leaves = [sp_.path[0] for sp_ in pool.paging.specs]
    for p, b, leaf in zip(pool.pools, before, leaves):
        check(torch.equal(p[new], b), f"slab leaf {leaf} not given back "
              "bitwise")
    got, _ = steps(t, 99, 3, 3)
    check(all(torch.equal(a, b) for a, b in zip(want, got)),
          "the resumed stream differs from the uninterrupted one")
    pool.release(rid)
    pool.release(other)
    blob = sum(a.numel() * a.element_size() for a in sp.blob)
    phase(n, "spill and resume, pool level", leaves=sorted(set(leaves)),
          slab_MB=f"{pool.slab_nbytes / 1e6:.2f}",
          blob_MB=f"{blob / 1e6:.2f}",
          leaves_after_resume="bitwise", next_3_steps="bitwise")


def phase_xlstm():
    """xlstm-1.3b at full width and all 48 layers through the slot pool
    (40), the paged pool (41; paged logits bitwise the dense-gather path's
    on a fresh pool first; spill and resume at the pool level) and the
    paged pool with n-gram speculation (42; the pool-level verify and
    rollback check; greedy spec == plain at round to nearest).  Every
    decode step launches kernel 1 once per mLSTM layer (42: dense on the
    slot pool, slab mode on the paged pool; Kq times per verify step),
    every request's prefill kernel 7 once per mLSTM layer, and nothing
    else of the port's kernels; the sLSTM runs in plain PyTorch."""
    import numpy as np
    import torch
    from repro_torch.serving.api import Engine, ServeConfig
    cfg, params, info = _xlstm_model()
    L = cfg.pattern.count("mlstm") * cfg.n_groups
    k7 = _k7_per_prefill(cfg)
    check(k7 == L == 42, f"kernel 7 per prefill {k7}, mLSTM layers {L}")
    phase(40, "xlstm-1.3b weights", **info)
    rng = np.random.default_rng(40)
    prompts = _pattern_prompts(rng, cfg)

    eng = Engine(params, cfg, ServeConfig(backend="slots", batch=4,
                                          cache_capacity=1024))
    slot = _serve_counted(eng, cfg, prompts, XLSTM_MAX_NEW, dict(k1=L), k7,
                          "xlstm slots")
    state = sum(_payload_bytes(c) for grp in eng.engine.caches for c in grp)
    phase(40, "main path xlstm-1.3b slots", **_fields(slot),
          state_MB_per_request=f"{state / 4 / 1e6:.2f}")
    slot["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 40)
    del eng
    slot["slstm"] = _slstm_prefill_share(params, cfg, rng)
    _reference_check_by_depth(params, cfg, _token_batch(prompts[0]),
                              n=40)

    eng = Engine(params, cfg, ServeConfig(**XLSTM_PAGED))
    shape = _paged_vs_gather(eng, cfg, rng)
    phase(41, "xlstm paged vs gather logits, fresh pool", steps=4,
          logits=tuple(shape), result="bit-identical")
    paged = _serve_counted(eng, cfg, prompts, XLSTM_MAX_NEW, dict(k1s=L),
                           k7, "xlstm paged")
    pool = eng.engine.pool
    check(pool.page_nbytes == 0, f"xlstm holds no KV, yet pages of "
          f"{pool.page_nbytes} B")
    phase(41, "main path xlstm-1.3b paged", **_fields(paged),
          preemptions=int(paged["stats"]["preemptions"]),
          page_bytes=pool.page_nbytes,
          slab_MB=f"{pool.slab_nbytes / 1e6:.2f}",
          gather_MB=f"{paged['stats']['gather_bytes'] / 1e6:.2f}")
    _spill_resume_check(eng, cfg, rng)
    paged["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 41)
    del eng

    rows = _verify_invariance(params, cfg)
    invariant = rows[cfg.norm_kind]
    phase(42, "matmul and norm row invariance, (B,Kq,d) rows vs (B,1,d), "
          "fp32, TF32 off", B=4, Kq=KQ,
          rows=repr({k: int(v) for k, v in rows.items()}),
          verify_products="per position (the mixers' decode)",
          norm=cfg.norm_kind, remaining_batched_op_invariant=invariant)
    eng = Engine(params, cfg, ServeConfig(**XLSTM_PAGED, spec="ngram",
                                          spec_k=SPEC_K))
    spec = _serve_counted(eng, cfg, prompts, XLSTM_MAX_NEW,
                          dict(k1s=L * KQ), k7, "xlstm paged + ngram")
    st = spec["stats"]
    agree, first = _agreement(paged["outputs"], spec["outputs"])
    phase(42, "main path xlstm-1.3b paged + ngram speculation", Kq=KQ,
          **_fields(spec), proposed=int(st["proposed_tokens"]),
          accepted=int(st["accepted_tokens"]),
          acceptance_rate=f"{st['acceptance_rate']:.3f}",
          snapshot_MB_per_verify_step_at_batch_4=(
              f"{KQ * 4 * eng.engine.pool.slab_nbytes / 1e6:.2f}"),
          vs_phase_41_other_sr_seeds="equal" if first is None else
          f"agreement {agree:.3f}, first difference at token {first}")
    spec["prof"] = _profile_decode(eng, cfg, rng, (64, 97, 133, 120), 42)
    _spec_rollback_check(eng, cfg, rng, invariant, phase_n=42)
    del eng
    # 8 new tokens: the three engines' 4 requests keep phase 42 short
    _greedy_exactness(params, cfg, prompts, invariant, n=42, max_new=8,
                      paged=XLSTM_PAGED)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(slot=slot, paged=paged, spec=spec, invariant=invariant)


# ---------------------------------------------------------------------------
# the last five configs: smollm-360m, yi-34b and dbrx-132b served through
# the three paths, paligemma-3b's patch prefix and hubert-xlarge's encoder
# at model level
# ---------------------------------------------------------------------------

#: paligemma-3b: four requests of 256 patch embeddings (a 224-px image in
#: 14-px patches, 1152 wide as SigLIP gives them) and 64-256 text tokens
#: (256 + S <= 512: one attention chunk), then 12 greedy decode steps
PALI_TEXT = (64, 256, 133, 200)
PALI_STEPS = 12
#: its kernels' timing lengths: mid-decode, the patches counted
PALI_DECODE_LENS = tuple(256 + t + PALI_STEPS // 2 for t in PALI_TEXT)
#: the last five configs' attention widths -- smollm-360m G = 3 at head
#: width 64; yi-34b G = 7 and dbrx-132b G = 6 at 128 (a Kq = 4 verify
#: pass: 28 and 24 rows a kv head, two row blocks of 14 and 12);
#: paligemma-3b G = 8 over one kv head at 256 (8 rows x 256 = 2048
#: accumulator items a block, 229,376 B of shared memory; its verify pass
#: four row blocks) -- held and timed in phases 43 and 44; the three
#: served through the three paths from phase ``n`` on, ``requests`` of the
#: PROMPT_LENS prompts with ``max_new`` new tokens, their depth cut to
#: ``layers`` where the fp32 weights would not fit one card with the pools
NEW_GQA = {
    "smollm-360m": dict(tag="smollm", H=15, KVH=5, d=64, n=45,
                        full_layers=32, requests=6, max_new=16),
    "yi-34b": dict(tag="yi34", H=56, KVH=8, d=128, n=50, full_layers=60,
                   layers=28, requests=4, max_new=8,
                   reduced="n_layers 60 -> 28 (66.1 GB fp32 of 80 GB)"),
    "dbrx-132b": dict(tag="dbrx", H=48, KVH=8, d=128, n=53, full_layers=40,
                      layers=4, requests=4, max_new=8,
                      reduced="n_layers 40 -> 4 (57.1 GB fp32 of 80 GB)"),
    "paligemma-3b": dict(tag="pali", H=8, KVH=1, d=256, full_layers=18,
                         decode_lens=PALI_DECODE_LENS),
}
SERVED_NEW = ("smollm-360m", "yi-34b", "dbrx-132b")
#: the slot pools' appended streams at the new widths, with the layers a
#: decode step walks (as APPEND_WIDTHS), and kernel 7 at one request's
#: prefill K and V of 400 positions (paligemma: 256 patches + 144 tokens)
NEW_APPEND_WIDTHS = (("smollm", 5, 64, 2, 32), ("yi34", 8, 128, 2, 28),
                     ("dbrx", 8, 128, 2, 4), ("pali", 1, 256, 2, 18))
NEW_K7_STREAMS = (("smollm K/V", (1, 400, 5, 64), 512),
                  ("yi-34b and dbrx K/V", (1, 400, 8, 128), 512),
                  ("paligemma K/V", (1, 400, 1, 256), 512))
NEW_K7_PREFILLS = (("smollm", 5, 64), ("yi34", 8, 128), ("dbrx", 8, 128),
                   ("pali", 1, 256))
#: hubert-xlarge: two clips of 10 s of 16 kHz audio at its 20 ms frames
HUBERT = dict(B=2, frames=500)


def _pali_batch(cfg, g, n_text):
    """One request: ``prefix_len`` seeded patch embeddings and ``n_text``
    tokens."""
    import torch
    return {"patches": torch.randn((1, cfg.prefix_len, cfg.frontend_dim),
                                   generator=g, device="cuda"),
            "tokens": torch.randint(0, cfg.vocab_size, (1, n_text),
                                    generator=g, device="cuda")}


def phase_paligemma():
    """Phase 48: paligemma-3b at full width and all 18 layers, at model
    level (the engines prefill token prompts only, as the JAX package's
    do): four requests of 256 seeded patch embeddings and PALI_TEXT
    tokens, each prefilled alone (kernel 7 once per layer: the layer's K
    and V over 256 + S positions in one launch) and written into a slot
    cache of four rows (``write_row``), then PALI_STEPS greedy
    ``decode_step``s from ``lengths = 256 + S`` (kernel 2 at R = 8, dv =
    256, and the fused dense append, once per layer a step).  The launch
    counters are set to 0 just before and read just after; no other
    kernel runs and the plain MX8 quantizer is not called inside a step.
    Then the decode profile and the reference check by depth over one
    request's prefill."""
    import torch
    from repro_torch.models import model as M
    cfg, params, info = _model_at("paligemma-3b")
    check(cfg.prefix_len == 256 and cfg.frontend_dim == 1152
          and cfg.n_kv_heads == 1 and cfg.head_dim == 256
          and cfg.n_heads == 8, f"unexpected {cfg.name}")
    phase(48, "paligemma-3b weights", **info)
    L, B, V = cfg.n_layers, len(PALI_TEXT), cfg.vocab_size
    g = torch.Generator(device="cuda").manual_seed(48)
    batches = [_pali_batch(cfg, g, t) for t in PALI_TEXT]
    lens = [cfg.prefix_len + t for t in PALI_TEXT]
    cap = -(-(max(lens) + PALI_STEPS) // 128) * 128
    torch.cuda.reset_peak_memory_stats()
    caches = M.init_decode_caches(cfg, B, cap, device="cuda")
    _counts_reset()
    PLAIN_QUANT["calls"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = []
    for slot, (b, S) in enumerate(zip(batches, lens)):
        logits, row = M.prefill(params, cfg, b)
        check(tuple(logits.shape) == (1, V)
              and bool(torch.isfinite(logits).all()),
              f"paligemma prefill {slot}: logits {tuple(logits.shape)}")
        M.write_row(caches, row, slot, S)
        first.append(int(logits[0].argmax()))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.tensor(first, device="cuda")
    L0 = torch.tensor(lens, dtype=torch.int32, device="cuda")
    step_ms = []
    for i in range(PALI_STEPS):
        t1 = time.perf_counter()
        logits, caches = M.decode_step(params, cfg, tok, caches, L0 + i,
                                       seed=i + 1)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        check(tuple(logits.shape) == (B, V)
              and bool(torch.isfinite(logits).all()),
              f"paligemma decode step {i}: logits not finite")
    n = _counts()
    check(PLAIN_QUANT["calls"] == 0, f"paligemma: the plain MX8 quantizer "
          f"ran {PLAIN_QUANT['calls']} times inside prefill or decode")
    expect = dict.fromkeys(n, 0)
    expect.update(k7=L * B, k2_gqa=L * PALI_STEPS, apd=L * PALI_STEPS)
    check(n == expect, f"paligemma launches {n}, want {expect}")
    per = {k: v / PALI_STEPS for k, v in n.items() if v and k != "k7"}
    phase(48, "main path paligemma-3b, model level (prefill with patches, "
          "decode_step)", requests=B, patches=cfg.prefix_len,
          text_tokens=list(PALI_TEXT), cache_capacity=cap,
          steps=PALI_STEPS, launches_per_step=",".join(
              f"{k}={v:g}" for k, v in per.items()),
          k7_launches=n["k7"], plain_quantizer_calls_in_steps=0,
          prefill_s=f"{prefill_s:.3f}",
          p50_step_ms=f"{sorted(step_ms)[len(step_ms) // 2]:.3f}",
          peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    state = dict(tok=tok, caches=caches, L=L0 + PALI_STEPS, i=PALI_STEPS)

    def step():
        state["i"] += 1
        lg, state["caches"] = M.decode_step(params, cfg, state["tok"],
                                            state["caches"], state["L"],
                                            seed=state["i"])
        state["tok"], state["L"] = lg.argmax(-1), state["L"] + 1

    prof = _device_profile(step, 5, 48)
    del caches, state
    _reference_check_by_depth(params, cfg, batches[0], n=48)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n=n, steps=PALI_STEPS, prof=prof, step_ms=step_ms,
                prefill_s=prefill_s)


def phase_hubert():
    """Phase 49: hubert-xlarge at full width and all 48 layers, its
    encoder's prefill (the only step it has, in the JAX package too) over
    HUBERT["B"] clips of HUBERT["frames"] seeded frame features: per-position
    logits (B, frames, 504), all finite; non-causal, so the first frame's
    logits move with the last frame's features.  It launches no kernel:
    an encoder builds no cache."""
    import torch
    from repro_torch.models import model as M
    cfg, params, info = _model_at("hubert-xlarge")
    check(cfg.encoder_only and not cfg.causal
          and cfg.frontend == "audio_frames" and cfg.d_model == 1280,
          f"unexpected {cfg.name}")
    phase(49, "hubert-xlarge weights", **info)
    g = torch.Generator(device="cuda").manual_seed(49)
    frames = torch.randn((HUBERT["B"], HUBERT["frames"], cfg.frontend_dim),
                         generator=g, device="cuda")
    M.prefill(params, cfg, {"frames": frames[:, :100]})          # warm up
    torch.cuda.reset_peak_memory_stats()
    _counts_reset()
    PLAIN_QUANT["calls"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = M.prefill(params, cfg, {"frames": frames})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n = _counts()
    want = (HUBERT["B"], HUBERT["frames"], cfg.vocab_size)
    check(tuple(logits.shape) == want and caches is None,
          f"hubert: logits {tuple(logits.shape)}, want {want}, no caches")
    check(bool(torch.isfinite(logits).all()), "hubert logits not finite")
    check(not any(n.values()) and PLAIN_QUANT["calls"] == 0,
          f"hubert launched {n}")
    moved = frames.clone()
    moved[:, -1] += 1.0
    late = M.prefill(params, cfg, {"frames": moved})[0]
    check(not torch.equal(late[:, 0], logits[:, 0]), "hubert: the first "
          "frame's logits ignore the last frame (causal?)")
    phase(49, "main path hubert-xlarge, encoder prefill", clips=want[0],
          frames=want[1], logits=want, finite=True, caches=None,
          kernel_launches=0, prefill_s=f"{prefill_s:.3f}",
          frames_per_s=f"{want[0] * want[1] / prefill_s:.1f}",
          peak_mem_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
          first_frame_moves_with_last="yes")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prefill_s=prefill_s, logits=want)


def main():
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to chip_smoke.py; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    try:
        smi = phase_device()
        _watch_plain_quantizer()
        phase_build()
        phase_exact_pow2()
        errs = dict(su=phase_state_update(), at=phase_attention())
        errs.update(zip(("pa", "ap", "apq", "su_slab"),
                        phase_paged_kernels()))
        errs.update(zip(("sv_paged", "sv_dense"), phase_spec_kernels()))
        errs["k7"] = phase_quant()
        errs.update({f"su_{a}": e
                     for a, e in phase_gla_state_update().items()})
        errs.update(phase_dense_kernels())
        errs.update(phase_dense_append())
        times = dict(zip(("su", "at"), phase_timing()))
        times.update(zip(("pa", "ap", "apq", "su_slab"),
                         phase_paged_timing()))
        times.update(zip(("sv_paged", "sv_dense"), phase_spec_timing()))
        times.update(phase_gla_timing())
        times.update(phase_dense_timing())
        times.update(phase_dense_append_timing())
        cfg, params, init_s = _model()
        slot = phase_main_path(cfg, params, init_s)
        paged = phase_paged_main_path(cfg, params, slot)
        spec = phase_spec_main_path(cfg, params, paged)
        # zamba2's weights and pools go before deepseek's 53.2 GB arrive
        del params
        gc.collect()
        torch.cuda.empty_cache()
        errs.update(phase_mla_kernels())
        times.update(phase_mla_timing())
        gc.collect()
        torch.cuda.empty_cache()
        phase(17, "device memory before deepseek-v2-236b",
              allocated_GB=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
        ds_cfg, ds_params = _ds_model()
        ds = phase_deepseek(ds_cfg, ds_params)
        del ds_params
        gc.collect()
        torch.cuda.empty_cache()
        gla = phase_gla(_gla_model("gla-2.7b"))
        gla.update({arch: phase_gla_paged(arch, n)
                    for arch, n in (("retnet-2.7b", 26), ("hgrn2-2.7b", 27))})
        phase(30, "device memory before the dense family",
              allocated_GB=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
        dense = {arch: phase_dense(arch, w) for arch, w in DENSE.items()}
        gc.collect()
        torch.cuda.empty_cache()
        t_x = time.perf_counter()
        errs.update(phase_xlstm_kernels())
        times.update(phase_xlstm_timing())
        phase(40, "device memory before xlstm-1.3b",
              allocated_GB=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
        xlstm = phase_xlstm()
        phase(42, "xlstm-1.3b phases 38-42",
              seconds=f"{time.perf_counter() - t_x:.1f}")
        t_n = time.perf_counter()
        errs.update(phase_dense_kernels(NEW_GQA, n=43))
        errs.update(phase_dense_append(NEW_APPEND_WIDTHS, NEW_K7_STREAMS,
                                       phase_n=43))
        times.update(phase_dense_timing(NEW_GQA, phase_n=44))
        times.update(phase_dense_append_timing(NEW_APPEND_WIDTHS,
                                               NEW_K7_PREFILLS, n=44))
        dense["smollm-360m"] = phase_dense("smollm-360m",
                                           NEW_GQA["smollm-360m"])
        pali = phase_paligemma()
        phase_hubert()
        for arch in ("yi-34b", "dbrx-132b"):
            gc.collect()
            torch.cuda.empty_cache()
            phase(NEW_GQA[arch]["n"], f"device memory before {arch}",
                  allocated_GB=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
            dense[arch] = phase_dense(arch, NEW_GQA[arch])
        phase(55, "the last five configs, phases 43-55",
              seconds=f"{time.perf_counter() - t_n:.1f}")
        kernels = kernels_line(errs, times, slot, paged, spec, ds, gla,
                               dense, xlstm, pali)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernels_line(errs, times, slot, paged, spec, ds, gla, dense, xlstm,
                 pali):
    """One entry per kernel and mode (kernel 1: dense mode on the slot
    path, slab mode on the paged path, at zamba2's heads and again at the
    GLA family's; kernels 2, 3, 5 and 6: GQA mode on zamba2's paths, MLA
    mode on deepseek's; kernel 7 on gla's slot path; the fused dense append
    on zamba2's and deepseek's slot paths; kernels 2 to 7 and the dense
    append again at opt-6.7b's and yi-9b's widths, on their paths; kernels
    1 and 7 at xlstm-1.3b's mLSTM heads and prefill states, on its paths;
    kernels 2 to 7 and the dense append at smollm-360m's, yi-34b's and
    dbrx-132b's widths, on their paths, and at paligemma-3b's, where its
    model-level run launches kernels 2 and 7 and the dense append and
    kernels 3 to 6 none); ``launches`` counts
    each one's own main path (the verify kernels: the speculative path,
    where kernel 6, the dense-cache twin, has no launch; kernel 4: the
    fused quantize-and-append on the paged paths, the copy on none),
    ``max_abs_err`` is each one's measured difference from its plain
    version (``y`` for the state update, bytes for the appends and the
    quantizer)."""
    su_src = "src/repro_torch/csrc/mx_state_update.cu"
    su_tpu = "src/repro/kernels/mx_state_update.py:104"
    q_src = "src/repro_torch/csrc/mx_quant.cu"
    q_tpu = "src/repro/kernels/mx_quant.py:35"
    pa_src = "src/repro_torch/csrc/mx_paged_attention.cu"
    sv_src = "src/repro_torch/csrc/mx_spec_attention.cu"
    kernels = [
        dict(name="mx_state_update", route="cuda", source=su_src,
             replaces=su_tpu, launches=slot["n_su"], max_abs_err=errs["su"],
             **times["su"]),
        dict(name="mx_attention_decode", route="cuda",
             source="src/repro_torch/csrc/mx_attention.cu",
             replaces="src/repro/kernels/mx_attention.py:98",
             launches=slot["n_at"], max_abs_err=errs["at"], **times["at"]),
        dict(name="mx_paged_attention_decode", route="cuda", source=pa_src,
             replaces="src/repro/kernels/mx_paged_attention.py:108",
             launches=paged["n_pa"], max_abs_err=errs["pa"], **times["pa"]),
        dict(name="mx_paged_kv_append", route="cuda", source=pa_src,
             replaces="src/repro/kernels/mx_paged_attention.py:199",
             launches=paged["n_ap"], max_abs_err=errs["ap"], **times["ap"]),
        dict(name="mx_paged_kv_append[quant]", route="cuda", source=pa_src,
             replaces="src/repro/kernels/mx_paged_attention.py:199",
             launches=paged["n_apq"], max_abs_err=errs["apq"],
             **times["apq"]),
        dict(name="mx_state_update[slab]", route="cuda", source=su_src,
             replaces=su_tpu, launches=paged["n_su"],
             max_abs_err=errs["su_slab"], **times["su_slab"]),
        dict(name="mx_paged_spec_attention_decode", route="cuda",
             source=sv_src,
             replaces="src/repro/kernels/mx_spec_attention.py:193",
             launches=spec["n5"], max_abs_err=errs["sv_paged"],
             **times["sv_paged"]),
        dict(name="mx_spec_attention_decode", route="cuda", source=sv_src,
             replaces="src/repro/kernels/mx_spec_attention.py:123",
             launches=spec["n6"], max_abs_err=errs["sv_dense"],
             **times["sv_dense"]),
        dict(name="mx_attention_decode[mla]", route="cuda",
             source="src/repro_torch/csrc/mx_attention.cu",
             replaces="src/repro/kernels/mx_attention.py:98",
             launches=ds["slot"]["n"]["k2"], max_abs_err=errs["e2"],
             **times["mx_attention_decode[mla]"]),
        dict(name="mx_paged_attention_decode[mla]", route="cuda",
             source=pa_src,
             replaces="src/repro/kernels/mx_paged_attention.py:108",
             launches=ds["paged"]["n"]["k3"], max_abs_err=errs["e3"],
             **times["mx_paged_attention_decode[mla]"]),
        dict(name="mx_paged_kv_append[quant,mla]", route="cuda",
             source=pa_src,
             replaces="src/repro/kernels/mx_paged_attention.py:199",
             launches=ds["paged"]["n"]["k4q_mla"],
             max_abs_err=errs["apq_mla"],
             **times["mx_paged_kv_append[quant,mla]"]),
        dict(name="mx_paged_spec_attention_decode[mla]", route="cuda",
             source=sv_src,
             replaces="src/repro/kernels/mx_spec_attention.py:193",
             launches=ds["spec"]["n"]["k5"], max_abs_err=errs["e5"],
             **times["mx_paged_spec_attention_decode[mla]"]),
        dict(name="mx_spec_attention_decode[mla]", route="cuda",
             source=sv_src,
             replaces="src/repro/kernels/mx_spec_attention.py:123",
             launches=ds["spec"]["n"]["k6"], max_abs_err=errs["e6"],
             **times["mx_spec_attention_decode[mla]"]),
        dict(name="mx_quantize", route="cuda", source=q_src, replaces=q_tpu,
             launches=gla["slot"]["n"]["k7"], max_abs_err=errs["k7"],
             **times["mx_quantize"]),
        dict(name="mx_kv_append_quant", route="cuda", source=q_src,
             replaces=q_tpu, launches=slot["n_apd"],
             max_abs_err=errs["apd_zamba2"], **times["mx_kv_append_quant"]),
        dict(name="mx_kv_append_quant[mla]", route="cuda", source=q_src,
             replaces=q_tpu, launches=ds["slot"]["n"]["apd_mla"],
             max_abs_err=errs["apd_mla"],
             **times["mx_kv_append_quant[mla]"]),
        dict(name="mx_state_update[gla]", route="cuda", source=su_src,
             replaces=su_tpu, launches=gla["slot"]["n"]["k1"],
             max_abs_err=errs["su_gla-2.7b"],
             **times["mx_state_update[gla]"]),
        dict(name="mx_state_update[slab,gla]", route="cuda", source=su_src,
             replaces=su_tpu, launches=gla["paged"]["n"]["k1s"],
             max_abs_err=errs["su_gla-2.7b"],
             **times["mx_state_update[slab,gla]"]),
    ] + [
        dict(name=f"mx_state_update[slab,{arch.split('-')[0]}]",
             route="cuda", source=su_src, replaces=su_tpu,
             launches=gla[arch]["n"]["k1s"], max_abs_err=errs[f"su_{arch}"],
             **times[f"mx_state_update[slab,{arch.split('-')[0]}]"])
        for arch in ("retnet-2.7b", "hgrn2-2.7b")
    ]
    new = {arch: NEW_GQA[arch] for arch in SERVED_NEW}
    pali_runs = dict.fromkeys(("slot", "paged", "spec"), pali)
    for arch, w in itertools.chain(DENSE.items(), new.items(),
                                   [("paligemma-3b",
                                     NEW_GQA["paligemma-3b"])]):
        tag = w["tag"]
        r = pali_runs if tag == "pali" else dense[arch]
        for name, source, replaces, path, counter, err in (
                ("mx_attention_decode", "src/repro_torch/csrc/mx_attention.cu",
                 "src/repro/kernels/mx_attention.py:98", "slot", "k2_gqa",
                 f"e2_{tag}"),
                ("mx_paged_attention_decode", pa_src,
                 "src/repro/kernels/mx_paged_attention.py:108", "paged",
                 "k3_gqa", f"e3_{tag}"),
                ("mx_paged_kv_append[quant", pa_src,
                 "src/repro/kernels/mx_paged_attention.py:199", "paged",
                 "k4q", f"apq_{tag}"),
                ("mx_paged_spec_attention_decode", sv_src,
                 "src/repro/kernels/mx_spec_attention.py:193", "spec",
                 "k5_gqa", f"e5_{tag}"),
                ("mx_spec_attention_decode", sv_src,
                 "src/repro/kernels/mx_spec_attention.py:123", "spec",
                 "k6_gqa", f"e6_{tag}"),
                ("mx_quantize", q_src, q_tpu, "slot", "k7", f"k7_{tag}"),
                ("mx_kv_append_quant", q_src, q_tpu, "slot", "apd",
                 f"apd_{tag}")):
            key = (f"{name},{tag}]" if name.endswith("[quant")
                   else f"{name}[{tag}]")
            kernels.append(dict(name=key, route="cuda", source=source,
                                replaces=replaces,
                                launches=r[path]["n"][counter],
                                max_abs_err=errs[err], **times[key]))
    for key, path, counter, err in (
            ("mx_state_update[xlstm]", "slot", "k1", "su_xlstm"),
            ("mx_state_update[xlstm_slab]", "paged", "k1s", "su_xlstm"),
            ("mx_quantize[xlstm]", "slot", "k7", "k7_xlstm")):
        kernels.append(dict(name=key, route="cuda",
                            source=q_src if counter == "k7" else su_src,
                            replaces=q_tpu if counter == "k7" else su_tpu,
                            launches=xlstm[path]["n"][counter],
                            max_abs_err=errs[err], **times[key]))
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            check(math.isfinite(k[key]), f"{k['name']}: {key} not finite")
    phase(8, "kernels", names=[k["name"] for k in kernels])
    return kernels


if __name__ == "__main__":
    sys.exit(main())
