#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version at the shapes the served model gives it,
times both (with a PyTorch library call as yardstick where one computes the
same function), then serves ``zamba2-2.7b`` at full width (24 of its 54
layers: 4 of its 9 groups) through the slot pool, through the paged pool
(``Engine``'s default) and through the paged pool with speculative
decoding, then ``deepseek-v2-236b`` at full width
(depth cut to 4 of its 60 layers: 53.2 GB of fp32 weights) through the same
three paths, then the paper's GLA-family models at full width (16 of
their 32 layers): ``gla-2.7b`` through the same three paths, ``retnet-2.7b`` and
``hgrn2-2.7b`` through the paged pool; then the paper's transformer
baseline ``opt-6.7b`` (32 layers) and ``yi-9b`` (48 layers, grouped
queries) at full width and full depth through the same three paths, then
``xlstm-1.3b`` at full width (24 of 48 layers: 21 mLSTM + 3 sLSTM)
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
decode, verify or prefill step ran the plain MX8 quantizer on the card;
and it drives the paged engine's memory hierarchy and fault paths at full
width: the host tier in pinned memory, the prefetch on a side stream, the
radix prefix store (warm and cold hits through the same kernels) and the
resilience layer; every engine writes its structured trace (steps,
request spans, bank counters, recompile instants), and the launcher runs
as a user runs it; last, the format study (paper Fig. 4) on the card,
through kernel 1, and at mamba2-2.7b's full depth; then training on the
card (smollm-360m trained, resumed bitwise and served; zamba2-2.7b trained
and served).
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
  tokens)   56-58, 61 (on zamba2-2.7b's weights, after phase 14): 56.
  the paged pool's tier moves (a page and a slab row to pinned host
  memory and back, bitwise, timed beside the pageable path; a prefetch
  on the side stream)   57. the radix prefix store (requests behind one
  256-token system prompt, with and without the store, at both roundings;
  a hit with speculation)   58. a cold hit (pages demoted to the host
  tier, promoted), phase 11's spills, a prefetch resume and its overlap
  with decode (torch.profiler)   61. fault plans (chaos under preemption,
  a corrupt spill blob, nan, slow step) with the sanitizer on   59. the
  prefix path on yi-9b (after phase 35)   60. on gla-2.7b (after phase
  25)   62 (after phase 61). the trace at full width: the slot, paged,
  verify, tier and fault engines' traces saved under ``chiprun_out/`` and
  validated (``repro_torch.obs.schema``) with their features; the
  recompile watcher's per-site counts; a steady decode step adds no
  watcher event; the events and the tracer's and watcher's host
  microseconds per step   63. the launcher in its own process
  (``--paged --mixed --stream --turns 2 --trace``), its trace validated
  64-65 (after phase 55; the analysis layer): 64. the swamping study
  (paper Fig. 4's mechanism, ``analysis/formats_study.py``, T = 300) on
  the card, every format on the torch backend and again with mx8 through
  kernel 1, held to kernel 1's contract at every step, the Fig. 4
  orderings asserted, each error beside the CPU port's   65. the format
  study at model level: mamba2-2.7b at full width and all 64 layers, a
  16-token prefill and 24 decode steps under fp32, mx8 (both roundings,
  kernels 1 and 7), int8 and fp8_e5m2 state; logit error and greedy
  agreement against fp32, each step's time beside its roofline
  66-68 (after phase 65; training, which runs none of the kernels): 66.
  smollm-360m at full width and all 32 layers trained by
  ``python -m repro_torch.launch.train`` in its own process (10 steps of
  8 x 256 tokens, a 4.3 GB checkpoint at step 6), then a second process
  auto-resumed from that checkpoint: losses and final parameters bitwise
  the uninterrupted run's, the loss falling   67. that checkpoint served
  through the paged pool and the paged pool with speculation (kernels 3,
  4 fused, 5 and 7; no plain quantizer), the reference check   68.
  zamba2-2.7b at full width (24 of 54 layers) trained three steps (step
  0's loss against a ``want_cache=True`` forward's), then served through
  the slot pool on its trained weights (kernels 1, 2, 7); one flash
  attention forward and backward at S = 8192 far under one score
  tensor's memory, against SDPA   69 (after phase 68; the distribution
  layer at world size 1: an NCCL process group of one rank and a (1, 1)
  mesh): smollm-360m at full width and depth from phase 66's seeded
  weights and batches, three ZeRO-sharded train steps (DTensor
  parameters and moments) against three plain steps, losses and
  parameters bitwise; on the trained weights a sharded model-level
  prefill and 8 decode steps with parameters and caches in their
  layouts, logits bitwise the unsharded steps' and kernels 2, 7 and the
  dense append launched as often; the append of the last half batch's
  rows with its SR row base bitwise the whole batch's append on those
  rows; the int8 compressed all-reduce of a
  gradient tree through NCCL, bitwise the CPU compressor's   70 (after
  69; tensor-parallel serving): (a) at zamba2-2.7b's widths, rank tp - 1
  of tp = 2 and 4: kernel 1 (dense and slab mode), the dense append and
  the fused paged append on the rank's heads with their head base, and
  kernels 2, 3 and 5 on its kv heads, each bitwise the whole launch's
  heads, timed beside its plain version; (b) two ranks in their own
  processes (this script with ``--tp-worker``) share the card over gloo
  (NCCL refuses two ranks on one card) and serve zamba2-2.7b at full
  width and ZAMBA2_LAYERS deep: a model-level prefill and decode steps
  against tp = 1 in rank 0's process (fp32 state and MX8 SR), logits
  bitwise across the ranks, then the paged engine (4 requests, 16 new
  tokens); each rank's launches a step (kernel 1 at 40 heads, kernels 2
  / 3 and the appends at 16 kv heads, no plain quantizer) and its weight
  and pool bytes against tp = 1.  Then the GLA family, mLSTM and MLA:
  (a) kernel 1 at the head shards of gla, retnet, hgrn2 and xlstm's
  mLSTM (dense and slab mode, the head base) and MLA kernels 2, 3 and 5
  at 64 and 32 of deepseek's 128 query rows, each against the whole
  launch's heads or rows, the tp = 2 shards timed; (b) the same two
  workers serve gla-2.7b (TP_NEW's depth), xlstm-1.3b (one sLSTM
  included) and deepseek-v2-236b (prelude + one MoE layer, expert
  parallel) at model level against tp = 1 (gla: bitwise tp = 1 with its
  products summed in the ranks' order, ``dist.emulate.split_sums``), then
  deepseek through the paged engine with n-gram speculation.  Then the
  data axes: (a) the fused paged append on a data rank's half batch with
  its SR row base, bitwise the whole batch's launch; (b) the two workers
  as a (2, 1) mesh serve zamba2 through the slot and the paged engine
  (DP: preemptions resume in the other rank's rows, pages move between
  the ranks) at fp32 state and MX8 SR, against one process's engines
  71 (after 70; training under tensor parallelism): two ranks in their
  own processes (``--tp-train-worker``) share the card over gloo as a
  (1, 2) mesh and train zamba2-2.7b at full width, TP_TRAIN's depth (one
  group of six Mamba-2 layers and one shared-block application), remat
  and sequence parallelism on: a step and a ``grad_accum=2`` step
  against the same weights trained at tp = 1 in rank 0's process
  (losses, the largest parameter difference, the first step's gradients
  of ``wbc`` and of the shared attention's ``wq``), a rank's parameter
  bytes and peak device memory against tp = 1, the step's wall time (two
  ranks sharing one card over gloo: no speed figure), no kernel launched
  8. kernels line

The card's peaks in every bound come from
``repro_torch.analysis.roofline`` (``HBM_BW``, ``PEAK_FP32_FLOPS``,
``PEAK_FLOPS``).

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
#: where the traces go (git-ignored)
OUT = ROOT / "chiprun_out"

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
#: gla-2.7b / retnet-2.7b / hgrn2-2.7b: depth cut to 16 of their 32
#: layers, and xlstm-1.3b to 24 of its 48 (3 of its 6 groups: 21 mLSTM +
#: 3 sLSTM layers), to keep the whole smoke well inside its time limit
GLA_LAYERS = 16
XLSTM_LAYERS = 24
#: the GLA family's kernels-vs-plain difference at each depth, at most
#: this many times that of the plain ops with one layer's y moved one ulp
#: (the H100 read 0.08-2.2 times at 1-32 layer groups)
CONTROL_FACTOR = 4
#: retnet-2.7b / hgrn2-2.7b: a few requests through the paged pool
OTHER_MAX_NEW = 8
#: the slot paths' decode profiles before the fused dense append, when the
#: slot pool quantized its appends eagerly: device busy ms and device
#: operations a step (PERF.md section 5; an H100 80GB HBM3 at 700 W)
EAGER_APPEND_PROFILE = {"deepseek-v2-236b": (27.336, 857),
                        "gla-2.7b": (10.696, 1512),
                        "opt-6.7b": (30.158, 7020),
                        "yi-9b": (41.892, 11478)}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


#: the script's start, for each phase line's ``at_s`` (where the time goes)
T0 = time.perf_counter()


def phase(n, name, **fields):
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{n}] {name}: {body} at_s={time.perf_counter() - T0:.1f}",
          flush=True)


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
    own bound, with the fp32 bound printed beside it.  The card's peaks
    come from the port's roofline module."""
    from repro_torch.analysis.roofline import (HBM_BW, PEAK_FLOPS,
                                               PEAK_FP32_FLOPS)
    t_bytes = nbytes / HBM_BW * 1e3
    t_fp32 = flops / PEAK_FP32_FLOPS * 1e3
    t_ops = t_fp32 if tc_flops is None else tc_flops / PEAK_FLOPS * 1e3
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


#: zamba2-2.7b's depth on the main paths: 4 of its 9 groups (24 Mamba-2
#: layers and 4 shared-attention applications), so the whole script keeps
#: under 900 s on a slow host (the main paths cost about 5.6 s a layer)
ZAMBA2_LAYERS = 24


def _zamba2_launches(cfg):
    """(state updates, attention applications) of one zamba2 decode step."""
    return cfg.pattern.count("mamba2") * cfg.n_groups, cfg.n_groups


def _model():
    """zamba2-2.7b at full width and ``ZAMBA2_LAYERS`` deep with random
    weights from a seeded CUDA generator, shared by both main paths."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    full = get_config("zamba2-2.7b")
    cfg = full.with_(n_layers=ZAMBA2_LAYERS)
    check(full.n_layers == 54 and cfg.d_model == 2560 and cfg.shared_attn
          and cfg.state_quant.fmt == "mx8"
          and cfg.state_quant.backend == "cuda",
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
    L, A = _zamba2_launches(cfg)
    check(steps > 0 and n_su == L * steps and n_at == A * steps
          and n_apd == A * steps and K7.mx_kv_append_quant.mla_launches == 0
          and n_q == _k7_per_prefill(cfg) * len(prompts),
          f"launches: state_update {n_su}, attention {n_at}, dense append "
          f"{n_apd} over {steps} decode steps (want {L}x, {A}x and {A}x), "
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
          layers=f"{cfg.n_layers} of 54",
          reduced=repr(f"n_layers 54 -> {cfg.n_layers}"),
          init_s=f"{init_s:.1f}", requests=len(handles), decode_steps=steps,
          launches=f"su={n_su},attn={n_at},dense_append={n_apd},quant={n_q}",
          plain_quantizer_calls_in_steps=n_plain_q, wall_s=f"{wall:.3f}",
          **_step_fields(st), peak_mem_GB=f"{peak / 1e9:.2f}",
          state_MB=f"{state_bytes / 1e6:.2f}", kv_MB=f"{kv_bytes / 1e6:.2f}")
    prof = _profile_decode(eng, cfg, rng, PROMPT_LENS[:4], 7)
    _reference_check(params, cfg, prompts[0])
    return dict(n_su=n_su, n_at=n_at, n_apd=n_apd, stats=st, peak=peak,
                prof=prof, trace=_trace_record(eng, "slots"))


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
    the slab-mode state update once a Mamba-2 layer and the paged attention
    and fused quantize-and-append kernels once a shared-attention
    application each, and the dense attention
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
    L, A = _zamba2_launches(cfg)
    check(steps > 0 and n_su == L * steps and n_dense == 0
          and n_pa == A * steps and n_apq == A * steps and n_ap == 0
          and n_at == 0 and n_q == _k7_per_prefill(cfg) * len(prompts)
          and K7.mx_kv_append_quant.launches == 0,
          f"launches over {steps} decode steps: state_update slab mode "
          f"{n_su} (want {L}x), dense mode {n_dense} (0), paged attention "
          f"{n_pa} ({A}x), fused append {n_apq} ({A}x), copy append {n_ap} "
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
                steps=steps, trace=_trace_record(eng, "paged"))


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
    verify step must launch the paged verify kernel once a shared-attention
    application, the fused append Kq times as often and the slab-mode state
    update Kq times a Mamba-2 layer, and
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
    L, A = _zamba2_launches(cfg)
    check(steps > 0 and n5 == A * steps and n4 == A * KQ * steps
          and n1s == L * KQ * steps and n6 == n3 == n4c == n2 == n1 == 0
          and n_q == _k7_per_prefill(cfg) * len(handles)
          and K7.mx_kv_append_quant.launches == 0,
          f"launches over {steps} verify steps: paged verify {n5} (want "
          f"{A}x), fused append {n4} ({A * KQ}x), state update slab {n1s} "
          f"({L * KQ}x), dense verify {n6}, paged attention {n3}, copy "
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
    trace = _trace_record(eng, "verify")
    del eng

    _greedy_exactness(params, cfg, paged["prompts"], invariant, n=14)
    return dict(n5=n5, n6=n6, stats=st, prof=prof, invariant=invariant,
                trace=trace)


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


def _weight_stream_bytes(cfg, params):
    """The weight bytes a decode step streams: every weight once but the
    tables it gathers rows from (the token embedding, unless it is the tied
    LM head, and the learned positions)."""
    return sum(p.numel() * p.element_size() for p in _leaves(params)) - sum(
        params[k].numel() * params[k].element_size()
        for k in ("embed", "pos") if k in params
        and not (k == "embed" and cfg.tie_embeddings))


def _model_at(arch, layers=None):
    """``arch`` at full width, ``layers`` deep (else all its layers),
    random weights from a seeded CUDA generator: (cfg, params, info)."""
    import torch
    from repro_torch.analysis.roofline import HBM_BW
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
        stream = _weight_stream_bytes(cfg, params)
        info.update(weight_stream_GB=f"{stream / 1e9:.2f}",
                    weight_stream_bound_ms=(
                        f"{stream / HBM_BW * 1e3:.2f}"))
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
# gla-2.7b / retnet-2.7b / hgrn2-2.7b at full width, GLA_LAYERS deep
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


def _time_su(key, shape, scalar, mode, n, heads=None):
    """Kernel 1 at ``shape`` in ``mode`` ("dense", or "slab" on a pool of
    ``n_rot`` layers), states rotated cold in L2, its plain version, and
    its host-loop time; bytes = the payload read and written once, the
    operands, y, and the slab ids.  ``heads``: ``(head_base,
    heads_total)`` where ``shape`` holds a tensor-parallel rank's heads."""
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
    hb = {} if heads is None else dict(head_base=heads[0],
                                       heads_total=heads[1])
    if mode == "dense":
        states = [F.mx8_quantize(torch.randn(shape, generator=g,
                                             device="cuda"))
                  for _ in range(n_rot)]
        kern = [lambda i=i: KS.mx_state_update(states[i], d, k, v, q, seed=i,
                                               **hb)
                for i in range(n_rot)]
        plain = [lambda i=i: KS.plain(states[i], d, k, v, q, seed=i, **hb)
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
    ``per_prefill`` is kernel 7's launches per request prefill (a prefix-
    store hit prefills nothing); every other counter must stay 0, and so
    must the plain MX8 quantizer's calls on the card inside decode, verify
    and prefill steps."""
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
    st = eng.stats()
    expect = {k: want.get(k, 0) * steps for k in n}
    expect["k7"] = per_prefill * int(len(prompts) - st.get("prefix_hits", 0))
    check(steps > 0 and n == expect, f"{label} launches over {steps} steps "
          f"and {len(prompts)} requests: {n}, want {expect}")
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
    """A GLA-family model at full width and ``GLA_LAYERS`` of its 32
    layers."""
    cfg, params, info = _model_at(arch, GLA_LAYERS)
    check(cfg.n_layers == GLA_LAYERS and cfg.d_model == 2560,
          f"unexpected {cfg.name}")
    info["reduced"] = repr(f"n_layers 32 -> {GLA_LAYERS}")
    return cfg, params, info


def phase_gla(init, extra=None):
    """gla-2.7b at full width, ``GLA_LAYERS`` deep, through the slot pool (23),
    the paged pool (24; paged logits bitwise the dense-gather path's on a
    fresh pool first) and the paged pool with n-gram speculation (25).
    Every decode step launches kernel 1 once per layer (dense on the slot
    pool, slab mode on the paged pool; Kq times per verify step), every
    request's prefill kernel 7 once per layer, and nothing else.
    ``extra(params, cfg)`` runs last, on the same weights."""
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
    del eng
    if extra is not None:
        extra(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(slot=slot, paged=paged, spec=spec)


def phase_gla_paged(arch, n):
    """retnet-2.7b (26) or hgrn2-2.7b (27) at full width, ``GLA_LAYERS``
    deep, through the paged pool: paged logits bitwise the dense-gather path's,
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
#: first of the model's three main-path phases; yi-9b's depth is cut to
#: keep the smoke in its time with the training phases 66-68
DENSE = {"opt-6.7b": dict(tag="opt", H=32, KVH=32, d=128, n=30,
                          full_layers=32),
         "yi-9b": dict(tag="yi", H=32, KVH=4, d=128, n=33, full_layers=48,
                       layers=24, reduced="n_layers 48 -> 24 (the smoke's "
                                          "time, with phases 66-68)")}
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


def phase_dense(arch, w, extra=None):
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
    greedy exactness runs at batch 1, where no expert can overflow.
    ``extra(params, cfg)`` runs last, on the same weights."""
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
    if extra is not None:
        extra(params, cfg)
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
    from repro_torch.analysis.roofline import HBM_BW
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
        one_bound = n_one * (4 + 1 + 2 / F.MX8_GROUP) / HBM_BW * 1e3
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
# xlstm-1.3b (mLSTM + sLSTM) at full width, XLSTM_LAYERS deep
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
    """xlstm-1.3b at full width and ``XLSTM_LAYERS`` of its 48 layers
    (groups of 7 mLSTM + 1 sLSTM)."""
    cfg, params, info = _model_at("xlstm-1.3b", XLSTM_LAYERS)
    check(cfg.n_layers == XLSTM_LAYERS and cfg.d_model == 2048
          and cfg.pattern.count("mlstm") * cfg.n_groups
          == XLSTM_LAYERS // 8 * 7, f"unexpected {cfg.name}")
    info["reduced"] = repr(f"n_layers 48 -> {XLSTM_LAYERS}")
    return cfg, params, info


def _slstm_prefill_share(params, cfg, rng, n=40, length=400):
    """The sLSTM's share of one request's prefill of ``length`` tokens: its
    sLSTM layers run the cell position by position in plain PyTorch (no SPU
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
    """xlstm-1.3b at full width, ``XLSTM_LAYERS`` deep, through the slot pool
    (40), the paged pool (41; paged logits bitwise the dense-gather path's
    on a fresh pool first; spill and resume at the pool level) and the
    paged pool with n-gram speculation (42; the pool-level verify and
    rollback check; greedy spec == plain at round to nearest).  Every
    decode step launches kernel 1 once per mLSTM layer (21: dense on the
    slot pool, slab mode on the paged pool; Kq times per verify step),
    every request's prefill kernel 7 once per mLSTM layer, and nothing
    else of the port's kernels; the sLSTM runs in plain PyTorch."""
    import numpy as np
    import torch
    from repro_torch.serving.api import Engine, ServeConfig
    cfg, params, info = _xlstm_model()
    L = cfg.pattern.count("mlstm") * cfg.n_groups
    k7 = _k7_per_prefill(cfg)
    check(k7 == L == XLSTM_LAYERS // 8 * 7,
          f"kernel 7 per prefill {k7}, mLSTM layers {L}")
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


# ---------------------------------------------------------------------------
# the paged engine's memory hierarchy and fault paths: the tier moves
# (pinned host memory, the prefetch side stream), the radix prefix store,
# cold hits, preemption with prefetch, fault plans (phases 56-61)
# ---------------------------------------------------------------------------

#: the host link's nominal rate, one direction: PCIe Gen5 x16
HOST_LINK_BYTES_PER_S = 64e9
#: the prefix path (phases 57, 59, 60): requests behind one 256-token
#: system prompt (two full pages, one prefill chunk), seeded tails of
#: 16-150 tokens, 16 new tokens each
PREFIX = dict(batch=4, n_pages=17, prefill_chunk=256, prefix_store_pages=8)
PREFIX_SYS = 256
PREFIX_MAX_NEW = 16
#: the preempted request of phase 58 (the JAX tier test's pattern: a long
#: request preempted by an urgent one at batch 1) and phase 61's chaos plan
PREEMPT = dict(batch=1, n_pages=9, n_slabs=5, prefill_chunk=512)
CHAOS = ("alloc:p=0.15;host_pin:p=0.5;blob_corrupt:p=0.3;"
         "prefetch_commit:p=0.5;nan:p=0.03;slow_step:p=0.2,ms=5")


def _nearest(cfg):
    from repro_torch import ops as OPS
    return cfg.with_(state_quant=OPS.StateQuantConfig("mx8", "nearest",
                                                      "cuda"))


def _random_bytes(pools, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    for p in pools:
        b = p.view(torch.uint8)
        b.copy_(torch.randint(0, 256, b.shape, generator=g, device="cuda",
                              dtype=torch.uint8))


def _blob_mb(blob):
    return sum(t.numel() * t.element_size() for t in blob) / 1e6


def _median_ms(fn, n=10, warmup=2):
    """Median host time of ``fn`` (which ends in a synchronize), ms."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[n // 2]


def _trace_overlap(prof):
    """A profiler window's side-stream work against the other streams'
    kernels.  The prefetch's stream is the one of its pinned host-to-device
    copies; its span is the union of that stream's copies and kernels (the
    scatter).  Returns (stream, other streams, copy bytes, span us,
    overlapped us)."""
    import os
    path = ROOT / "build" / "prefetch_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        os.remove(path)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    for e in dev:
        e.setdefault("args", {})
    check(bool(dev), "prefetch profile: no device events in the trace")
    h2d = [e for e in dev if e["cat"] == "gpu_memcpy"
           and "HtoD" in e["name"] and "Pinned" in e["name"]
           and e["args"].get("bytes", 0) >= 1 << 20]
    check(bool(h2d), "prefetch profile: no pinned host-to-device copy")
    side = h2d[0]["args"]["stream"]

    def union(ivs):
        out = []
        for a, b in sorted(ivs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    mine = union([(e["ts"], e["ts"] + e["dur"]) for e in dev
                  if e["args"].get("stream") == side])
    other = union([(e["ts"], e["ts"] + e["dur"]) for e in dev
                   if e["cat"] == "kernel"
                   and e["args"].get("stream") != side])
    span = sum(b - a for a, b in mine)
    lap = sum(max(0.0, min(b, d) - max(a, c))
              for a, b in mine for c, d in other)
    streams = sorted({e["args"].get("stream") for e in dev
                      if e["cat"] == "kernel"} - {side})
    return (side, streams, sum(e["args"]["bytes"] for e in h2d
                               if e["args"]["stream"] == side), span, lap)


def phase_tier_moves(cfg, params):
    """Phase 56: the tier's units at zamba2-2.7b's full width.  A page (6
    leaves) and a slab row (30 leaves) go to pinned host tensors
    (``non_blocking`` copies waited on by an event before the checksum)
    and back into other ids, byte for byte, the checksum that of a
    synchronous copy; each is timed both ways beside the pageable
    ``.to("cpu")`` path it replaces and a bound of its bytes over the host
    link's nominal rate; a pinned allocation cold and from the caching
    host allocator.  Then a request spilled and staged back by a prefetch
    issued behind a busy stream: the copy runs on the pool's side stream,
    waits for the current one, and a decode step launched right after the
    commit gives the logits it gave before the spill, bitwise."""
    import numpy as np
    import torch
    from repro_torch.core.paged import pages_for
    from repro_torch.models import model as M
    from repro_torch.serving.memory import TieredStatePool
    from repro_torch.serving.memory.layout import host_copy
    from repro_torch.serving.resilience import crc_blob
    pool = TieredStatePool(cfg, n_pages=6, n_slabs=3, device="cuda")
    paging = pool.paging
    _random_bytes(pool.pools, 56)
    before = [p.view(torch.uint8).clone() for p in pool.pools]
    page_ids = torch.tensor([2], device="cuda")
    units = {"page": (lambda: paging.extract_pages(pool.pools, page_ids),
                      lambda blob: paging.insert_pages(
                          pool.pools, blob, torch.tensor([4],
                                                         device="cuda")),
                      pool.page_nbytes),
             "slab": (lambda: paging.extract_slab(pool.pools, 1),
                      lambda blob: paging.insert_slab(pool.pools, blob, 2),
                      pool.slab_nbytes)}
    t0 = time.perf_counter()
    host_copy(units["page"][0]())                      # first pinned alloc
    cold_ms = (time.perf_counter() - t0) * 1e3
    rows = {}
    for name, (extract, insert, nbytes) in units.items():
        dev = extract()
        pinned = host_copy(dev)
        check(all(t.is_pinned() for t in pinned),
              f"{name}: a blob tensor is not pinned")
        check(crc_blob(pinned) == crc_blob([t.cpu() for t in dev]),
              f"{name}: the pinned copy's checksum is not the synchronous "
              "copy's (a copy read before it landed)")
        check(sum(t.numel() * t.element_size() for t in pinned) == nbytes,
              f"{name}: {nbytes} B expected")
        insert(pinned)
        torch.cuda.synchronize()
        pageable = [t.to("cpu", copy=True) for t in dev]

        def d2h_pageable():
            [t.to("cpu", copy=True) for t in extract()]

        def h2d(blob):
            insert(blob)
            torch.cuda.synchronize()
        ms = dict(d2h=_median_ms(lambda: host_copy(extract())),
                  d2h_pageable=_median_ms(d2h_pageable),
                  h2d=_median_ms(lambda: h2d(pinned)),
                  h2d_pageable=_median_ms(lambda: h2d(pageable)))
        crc_ms = _median_ms(lambda: crc_blob(pinned), n=5)
        bound = nbytes / HOST_LINK_BYTES_PER_S * 1e3
        rows[name] = dict(bytes=nbytes, leaves=len(pinned), bound_ms=bound,
                          crc_ms=crc_ms, **ms)
        phase(56, f"tier move, one {name}", bytes=nbytes, leaves=len(pinned),
              **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
              **{f"{k}_GB_per_s": f"{nbytes / v / 1e6:.2f}"
                 for k, v in ms.items()},
              bound_ms=f"{bound:.4f}", round_trip="bitwise",
              crc="matches the synchronous copy",
              crc_host_ms=f"{crc_ms:.3f}")
    after = [p.view(torch.uint8) for p in pool.pools]
    for a, b, spec in zip(after, before, paging.specs):
        same = (torch.equal(a[4], b[2]) if spec.kind == "page"
                else torch.equal(a[2], b[1]))
        check(same, f"round trip changed bytes of {spec.path}")
    # the caching host allocator keeps freed pinned blocks by power-of-two
    # size class: a class no blob has used yet pays cudaHostAlloc, a
    # second allocation in it is served from the cache
    nb = 3 * pool.slab_nbytes
    t0 = time.perf_counter()
    fresh = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
    first_ms = (time.perf_counter() - t0) * 1e3
    del fresh
    t0 = time.perf_counter()
    again = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
    cached_ms = (time.perf_counter() - t0) * 1e3
    del again
    phase(56, "pinned allocation", first_page_copy_ms=f"{cold_ms:.3f}",
          new_size_class_MB=f"{nb / 1e6:.1f}", new_size_class_ms=(
              f"{first_ms:.3f}"),
          from_caching_host_allocator_ms=f"{cached_ms:.4f}")

    del pool
    gc.collect()

    # a spilled request staged back on the side stream, behind a busy one
    # (a fresh pool: the random bytes above are no valid MX8 state)
    pool = TieredStatePool(cfg, n_pages=6, n_slabs=3, device="cuda")
    rng = np.random.default_rng(56)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, 300),
                             device="cuda")[None]
    logits, row = M.prefill(params, cfg, {"tokens": prompt})
    check(pool.register(1, pages_for(300)), "no pages for the prefill")
    pool.insert_prefill(1, row)
    tok = np.array([int(logits[0].argmax())], np.int64)
    lens = np.array([300], np.int32)
    snap = [p.clone() for p in pool.pools]
    ref = pool.decode(params, [1], tok, lens, seed=5600).clone()
    for p, s_ in zip(pool.pools, snap):
        p.copy_(s_)
    del snap
    sp = pool.spill(1, 300)
    check(all(t.is_pinned() for t in sp.blob), "spill blob not pinned")
    torch.cuda._sleep(1_000_000_000)           # ~0.5 s of spin
    check(pool.prefetch_begin(1, sp), "prefetch refused")
    st = pool._staged[1]
    side = pool.copy_stream.cuda_stream != torch.cuda.current_stream(
        ).cuda_stream
    waited = not st.done.query()
    check(side and waited, f"prefetch copy: side stream {side}, waits on "
          f"the busy current stream {waited}")
    check(pool.prefetch_commit(1), "commit failed")
    got = pool.decode(params, [1], tok, lens, seed=5600)
    check(torch.equal(got, ref), "decode after prefetch_commit differs "
          f"from before the spill (max abs {float((got - ref).abs().max())})")
    pool.release(1)
    phase(56, "prefetch on the side stream", stream="side (not the decode "
          "step's)", waits_on_busy_current_stream=waited,
          decode_after_commit="bitwise the logits before the spill",
          staged_MB=f"{_blob_mb(sp.blob):.2f}")
    del pool
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, cold_ms=cold_ms, first_ms=first_ms,
                cached_ms=cached_ms)


def _prefix_prompts(cfg, seed, n=6):
    import numpy as np
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, cfg.vocab_size, PREFIX_SYS)
    tails = rng.integers(16, 151, n)
    return sysp, [np.concatenate([sysp, rng.integers(0, cfg.vocab_size, t)])
                  for t in tails]


def phase_prefix(params, cfg, n, want, roundings=("nearest", "stochastic"),
                 requests=6):
    """Phases 57, 59, 60: ``requests`` requests behind one 256-token system
    prompt through the paged pool with the prefix store off and on, at each
    rounding: the store's hits decode their un-cached tails through the
    kernels of the paged step (``want`` a step; the plain MX8 quantizer
    never), and prefill nothing (kernel 7 launches only for misses).  At
    round to nearest the streams with the store equal those without; at
    stochastic rounding a plain step seeds its rounding with its step
    count, so the stored pages were rounded at other steps and the
    agreement is reported.  Returns the round-to-nearest engines (store
    on, store off) and the runs."""
    from repro_torch.serving.api import Engine, ServeConfig
    sysp, prompts = _prefix_prompts(cfg, n, requests)
    per_prefill = _k7_per_prefill(cfg)
    runs, engines = {}, {}
    for rounding in roundings:
        rcfg = _nearest(cfg) if rounding == "nearest" else cfg
        for cache in (False, True):
            eng = Engine(params, rcfg, ServeConfig(**PREFIX,
                                                   prefix_cache=cache))
            r = _serve_counted(eng, cfg, prompts, PREFIX_MAX_NEW, want,
                               per_prefill, f"{cfg.name} prefix "
                               f"{rounding} cache={cache}")
            runs[rounding, cache] = r
            if rounding == "nearest":
                engines[cache] = eng
            else:
                del eng
        off, on = runs[rounding, False], runs[rounding, True]
        so, sn = off["stats"], on["stats"]
        agree, first = _agreement(off["outputs"], on["outputs"])
        if rounding == "nearest":
            check(first is None, f"{cfg.name}: streams with the prefix "
                  f"store differ at token {first} (round to nearest)")
        check(sn["prefix_hits"] > 0 and sn["prefill_tokens"]
              < so["prefill_tokens"], f"{cfg.name}: prefix store unused "
              f"({sn['prefix_hits']} hits)")
        phase(n, f"{cfg.name} prefix store, {rounding}",
              requests=len(prompts), system_prompt=PREFIX_SYS,
              tails=[len(p) - PREFIX_SYS for p in prompts],
              steps=f"{on['steps']} vs {off['steps']} without",
              prefix_hits=int(sn["prefix_hits"]),
              prefix_hit_tokens=int(sn["prefix_hit_tokens"]),
              prefill_tokens=f"{int(sn['prefill_tokens'])} vs "
              f"{int(so['prefill_tokens'])}",
              k7_launches=f"{on['n']['k7']} vs {off['n']['k7']}",
              p50_ttft_ms=f"{sn['p50_ttft_s'] * 1e3:.3f} vs "
              f"{so['p50_ttft_s'] * 1e3:.3f}",
              mean_ttft_ms=f"{sn['mean_ttft_s'] * 1e3:.3f} vs "
              f"{so['mean_ttft_s'] * 1e3:.3f}",
              tokens_per_s=f"{sn['tokens_per_s']:.2f} vs "
              f"{so['tokens_per_s']:.2f}",
              p50_step_ms=f"{sn['p50_step_s'] * 1e3:.3f} vs "
              f"{so['p50_step_s'] * 1e3:.3f}",
              store_pages=int(sn["prefix_store_pages"]),
              host_MB=f"{sn['host_bytes'] / 1e6:.2f}",
              plain_quantizer_calls_in_steps=on["plain_quant"],
              streams="equal" if first is None else
              f"agreement {agree:.3f}, first difference at token {first}")
    return engines, runs, sysp


def _count_window(fn, label):
    """Run ``fn`` with the launch counters and the plain-quantizer watcher
    reset just before; returns the counts just after."""
    import torch
    _counts_reset()
    PLAIN_QUANT["calls"] = 0
    out = fn()
    torch.cuda.synchronize()
    n = _counts()
    check(PLAIN_QUANT["calls"] == 0, f"{label}: the plain MX8 quantizer ran "
          f"{PLAIN_QUANT['calls']} times on the card")
    return out, n


def phase_cold_and_prefetch(cfg, params, engines, sysp, paged, want):
    """Phase 58.  A cold hit: every stored page demoted to pinned host
    memory, then a request on the prefix promotes them (checksum-verified)
    and its stream equals the one without the store.  Phase 11's FCFS run
    at n_pages=9: its spills' bytes out and back.  A prefetch: a long
    request preempted by an urgent one at batch 1 (priority), staged back
    on the side stream while the urgent one decodes, committed; its stream
    equals a never-preempted run, the tier keys read the bytes that moved,
    and a profiler window over the staging step says how much of the copy
    overlapped a decode kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.api import Engine, ServeConfig
    from repro_torch.serving.scheduler import SchedulerConfig
    ncfg = _nearest(cfg)
    on, off = engines[True], engines[False]
    pool = on.engine.pool
    st0 = on.stats()
    demoted = pool.demote_all()
    check(demoted >= 1 and pool.host.cached_bytes > 0,
          f"demote_all moved {demoted} nodes")
    rng = np.random.default_rng(58)
    prompt = np.concatenate([sysp, rng.integers(0, cfg.vocab_size, 40)])
    s0 = on.engine.step_count

    def cold():
        h = on.submit(prompt, max_new_tokens=PREFIX_MAX_NEW)
        on.run()
        return h
    h, n = _count_window(cold, "cold hit")
    steps = on.engine.step_count - s0
    ref = off.submit(prompt, max_new_tokens=PREFIX_MAX_NEW).result()
    st = on.stats()
    check(h.status == "done" and h.output == ref.output,
          "cold hit stream differs from the stream without the store")
    check(st["prefix_hits"] == st0["prefix_hits"] + 1
          and st["promote_bytes"] > st0["promote_bytes"],
          "the cold request did not hit / promote")
    expect = {k: want.get(k, 0) * steps for k in n}
    expect["k7"] = 0
    check(n == expect, f"cold hit launches {n}, want {expect}")
    up = st["promote_bytes"] - st0["promote_bytes"]
    down = st["demote_bytes"] - st0["demote_bytes"]
    phase(58, "cold hit (pages demoted to pinned host, promoted)",
          nodes_demoted=demoted, steps=steps,
          promoted_MB=f"{up / 1e6:.2f}", demoted_MB=f"{down / 1e6:.2f}",
          launches_per_step=",".join(f"{k}={v // steps}"
                                     for k, v in n.items() if v),
          k7_launches=n["k7"], plain_quantizer_calls_in_steps=0,
          stream="equal to the stream without the store")
    del engines[True], engines[False], on, off
    gc.collect()

    ps = paged["stats"]
    check(ps["demote_bytes"] > 0 and ps["promote_bytes"]
          == ps["demote_bytes"] and ps["host_bytes"] == 0
          and ps["tier_misses"] >= 1,
          f"phase 11's spills: demote {ps['demote_bytes']}, promote "
          f"{ps['promote_bytes']}, host {ps['host_bytes']}")
    phase(58, "phase 11's FCFS run at n_pages=9 (prefetch_window=2)",
          preemptions=int(ps["preemptions"]),
          demote_MB=f"{ps['demote_bytes'] / 1e6:.2f}",
          promote_MB=f"{ps['promote_bytes'] / 1e6:.2f}",
          host_bytes_after=int(ps["host_bytes"]),
          tier_misses=int(ps["tier_misses"]),
          prefetch_commits=int(ps["prefetch_commits"]),
          why_no_prefetch="FCFS queues a spilled request first, and "
          "admission resumes it in the step its pages free, before "
          "prefetches are issued")

    rng = np.random.default_rng(580)
    prompt_b = rng.integers(0, cfg.vocab_size, 400)
    prompt_a = rng.integers(0, cfg.vocab_size, 64)
    scfg = ServeConfig(**PREEMPT, scheduler=SchedulerConfig(
        policy="priority"))
    base = Engine(params, ncfg, scfg)
    ref_b = base.submit(prompt_b, max_new_tokens=8, priority=5).result()
    del base
    eng = Engine(params, ncfg, scfg)
    pool = eng.engine.pool
    moved = {"out": 0, "back": 0}
    spill, begin = pool.spill, pool.prefetch_begin

    def counted_spill(rid, length):
        sp = spill(rid, length)
        moved["out"] += sum(t.numel() * t.element_size() for t in sp.blob)
        return sp
    window = {"prof": None, "staged": False, "traces": []}

    def profiled_begin(rid, sp, reserve=1):
        if rid in pool._staged:
            return begin(rid, sp, reserve)
        if window["prof"] is None:
            window["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            window["prof"].__enter__()
        ok = begin(rid, sp, reserve)
        if ok:
            window["staged"] = True
            moved["back"] += sum(t.numel() * t.element_size()
                                 for t in sp.blob)
        return ok
    pool.spill, pool.prefetch_begin = counted_spill, profiled_begin

    def serve():
        hb = eng.submit(prompt_b, max_new_tokens=8, priority=5)
        while hb.status == "queued" and eng.step():
            pass
        eng.step()
        ha = eng.submit(prompt_a, max_new_tokens=6, priority=0)
        eng.engine._preempt(hb.rid)
        while eng.step():
            if window["prof"] is not None:
                torch.cuda.synchronize()
                window["prof"].__exit__(None, None, None)
                if window["staged"]:
                    window["traces"].append(_trace_overlap(window["prof"]))
                window["prof"], window["staged"] = None, False
        return ha, hb
    s0 = eng.engine.step_count
    (ha, hb), n = _count_window(serve, "prefetch resume")
    steps = eng.engine.step_count - s0
    st = eng.stats()
    check(ha.status == hb.status == "done" and hb.output == ref_b.output,
          "the prefetched request's stream differs from the never-"
          "preempted run")
    check(st["prefetch_commits"] >= 1 and st["preemptions"] >= 1,
          f"no prefetch commit ({st['prefetch_commits']})")
    check(st["demote_bytes"] == moved["out"] and st["promote_bytes"]
          == moved["back"] == moved["out"] and st["host_bytes"] == 0,
          f"tier bytes {st['demote_bytes']} / {st['promote_bytes']} / "
          f"{st['host_bytes']}, moved {moved}")
    expect = {k: want.get(k, 0) * steps for k in n}
    expect["k7"] = 2 * _k7_per_prefill(cfg)
    check(n == expect, f"prefetch run launches {n}, want {expect}")
    check(bool(window["traces"]), "no profiled prefetch")
    side, others, nbytes, span, lap = window["traces"][0]
    check(others and side not in others, f"the prefetch copy ran on stream "
          f"{side}, the decode kernels on {others}")
    phase(58, "prefetch resume (priority, batch 1, n_pages=9)",
          preemptions=int(st["preemptions"]),
          prefetch_commits=int(st["prefetch_commits"]),
          tier_hits=int(st["tier_hits"]),
          demote_MB=f"{st['demote_bytes'] / 1e6:.2f}",
          promote_MB=f"{st['promote_bytes'] / 1e6:.2f}",
          host_bytes_after=int(st["host_bytes"]), steps=steps,
          launches_per_step=",".join(f"{k}={v // steps}"
                                     for k, v in n.items()
                                     if v and k != "k7"),
          k7_launches=n["k7"], plain_quantizer_calls_in_steps=0,
          stream="equal to the never-preempted run")
    phase(58, "prefetch overlap (torch.profiler, the staging step)",
          copy_stream=side, decode_streams=others,
          copied_MB=f"{nbytes / 1e6:.2f}", copy_span_us=f"{span:.1f}",
          copy_GB_per_s=f"{nbytes / max(span, 1e-9) / 1e3:.2f}",
          overlapped_us=f"{lap:.1f}",
          overlapped_share=f"{lap / max(span, 1e-9):.3f}")
    trace = _trace_record(eng, "tier")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(span=span, lap=lap, nbytes=nbytes, trace=trace)


def phase_faults(cfg, params):
    """Phase 61: the resilience layer at zamba2-2.7b's full width, with the
    shadow-ledger sanitizer on.  A chaos plan over every site under
    preempting FCFS traffic (4 usable pages): every request terminal, the
    engine drained, the sanitizer silent.  A corrupt spill blob: detected
    at resume, recovered by re-prefill, the stream equal to the never-
    preempted run (round to nearest).  A ``nan`` fault quarantines exactly
    its row (the others' streams equal a fault-free run) and a
    ``slow_step`` stall trips the watchdog."""
    import os
    import numpy as np
    import torch
    from repro_torch.serving.api import Engine, ServeConfig
    from repro_torch.serving.engine import TERMINAL_STATUSES
    from repro_torch.serving.scheduler import SchedulerConfig
    ncfg = _nearest(cfg)
    old = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        rng = np.random.default_rng(61)
        eng = Engine(params, ncfg, ServeConfig(
            batch=3, n_pages=5, prefill_chunk=128, fault_plan=CHAOS,
            step_budget_s=0.5))
        check(eng.engine.pool.placement._shadow is not None,
              "the sanitizer is off")
        hs = []
        for L in rng.integers(118, 128, 6):     # each grows a second page
            hs.append(eng.submit(rng.integers(0, cfg.vocab_size, L),
                                 max_new_tokens=8))
            eng.step()
        eng.run()
        statuses = [h.status for h in hs]
        check(all(s in TERMINAL_STATUSES for s in statuses)
              and not eng.engine.has_work()
              and eng.engine.pool.host.pinned_bytes == 0,
              f"chaos: statuses {statuses}, work left "
              f"{eng.engine.has_work()}")
        m = eng.obs.metrics
        injected = dict(eng.engine.faults.injected)
        phase(61, "chaos plan", plan=CHAOS, statuses=statuses,
              injected=injected, preemptions=int(eng.stats()["preemptions"]),
              recovered=int(m.family_total("faults_recovered_total")),
              retries=int(m.family_total("fault_retries_total")),
              degradations=int(m.family_total("degradations_total")),
              quarantines=int(m.value("quarantines_total")),
              blob_corruptions=int(m.value("blob_corruptions_total")),
              watchdog_trips=eng.engine.watchdog.trips,
              sanitizer="silent")
        trace = _trace_record(eng, "faults")
        del eng

        rng = np.random.default_rng(610)
        prompt_b = rng.integers(0, cfg.vocab_size, 400)
        prompt_a = rng.integers(0, cfg.vocab_size, 64)
        sched = SchedulerConfig(policy="priority")
        ref = Engine(params, ncfg, ServeConfig(**PREEMPT, scheduler=sched)
                     ).submit(prompt_b, max_new_tokens=8, priority=5).result()
        eng = Engine(params, ncfg, ServeConfig(
            **PREEMPT, scheduler=sched, fault_plan="blob_corrupt:nth=1"))
        hb = eng.submit(prompt_b, max_new_tokens=8, priority=5)
        while hb.status == "queued" and eng.step():
            pass
        eng.step()
        ha = eng.submit(prompt_a, max_new_tokens=6, priority=0)
        eng.engine._preempt(hb.rid)
        eng.run()
        m = eng.obs.metrics
        check(ha.status == hb.status == "done" and hb.output == ref.output
              and m.value("blob_corruptions_total") == 1
              and m.value("faults_recovered_total", site="blob_corrupt") == 1,
              f"corrupt spill blob: {hb.status}, stream equal "
              f"{hb.output == ref.output}, corruptions "
              f"{m.value('blob_corruptions_total')}")
        phase(61, "corrupt spill blob", detected="at resume",
              recovered="re-prefill of prompt + generated tokens",
              stream="equal to the never-preempted run",
              prefill_tokens=int(eng.stats()["prefill_tokens"]))
        del eng

        rng = np.random.default_rng(611)
        prompts = [rng.integers(0, cfg.vocab_size, L) for L in (64, 97, 120)]
        outs = {}
        for plan in (None, "nan:rid=1;slow_step:step=2,ms=400"):
            eng = Engine(params, ncfg, ServeConfig(
                batch=3, n_pages=9, fault_plan=plan,
                step_budget_s=0.3 if plan else None))
            hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.run()
            outs[plan] = [(h.status, h.output) for h in hs]
            last = eng
        m = last.obs.metrics
        faulty, clean = outs[plan], outs[None]
        check(faulty[1][0] == "failed" and faulty[0] == clean[0]
              and faulty[2] == clean[2]
              and m.value("quarantines_total") == 1,
              f"nan: {[s for s, _ in faulty]}, other rows equal "
              f"{faulty[0] == clean[0] and faulty[2] == clean[2]}")
        check(last.engine.watchdog.trips >= 1, "the watchdog did not trip")
        phase(61, "nan and slow_step", quarantined="exactly rid 1",
              other_rows="equal to the fault-free run",
              watchdog_trips=last.engine.watchdog.trips,
              slowest_step_ms=f"{last.engine.watchdog.slowest_s * 1e3:.1f}")
        del last, eng
    finally:
        if old is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = old
    gc.collect()
    torch.cuda.empty_cache()
    return trace


def phase_prefix_other(params, cfg, n, want):
    """Phase 59 (yi-9b at full width and depth: pure attention with grouped
    queries) or 60 (gla-2.7b: no pages, so a hit is the state snapshot
    alone): the prefix path of phase 57 at round to nearest, four
    requests."""
    engines, runs, _ = phase_prefix(params, cfg, n, want,
                                    roundings=("nearest",), requests=4)
    pool = engines[True].engine.pool
    phase(n, f"{cfg.name} store units", page_bytes=pool.page_nbytes,
          slab_bytes=pool.slab_nbytes,
          hit="state snapshot alone" if pool.page_nbytes == 0
          else "pages by reference" + (" + state snapshot"
                                       if pool.slab_nbytes else ""))
    engines.clear()
    gc.collect()
    return runs


def phase_tiering(cfg, params, paged):
    """Phases 56-58 and 61 on zamba2-2.7b's weights (phase 57: the prefix
    path at both roundings; a prefix hit with speculation through kernel
    5)."""
    import numpy as np
    from repro_torch.serving.api import Engine, ServeConfig
    t0 = time.perf_counter()
    moves = phase_tier_moves(cfg, params)
    L, A = _zamba2_launches(cfg)
    want = dict(k1s=L, k3_gqa=A, k4q=A)
    engines, runs, sysp = phase_prefix(params, cfg, 57, want)
    rng = np.random.default_rng(570)
    prompts = [np.concatenate([sysp, rng.integers(0, cfg.vocab_size, t)])
               for t in (16, 20)]
    eng = Engine(params, _nearest(cfg), ServeConfig(
        **dict(PREFIX, batch=2), prefix_cache=True, spec="ngram",
        spec_k=SPEC_K))
    spec = _serve_counted(eng, cfg, prompts, 8,
                          dict(k1s=L * KQ, k5_gqa=A, k4q=A * KQ),
                          _k7_per_prefill(cfg), "zamba2 prefix + ngram")
    check(spec["stats"]["prefix_hits"] >= 1, "no prefix hit with speculation")
    phase(57, "prefix hit with speculation (ngram)", **_fields(spec),
          prefix_hits=int(spec["stats"]["prefix_hits"]))
    del eng
    over = phase_cold_and_prefetch(cfg, params, engines, sysp, paged, want)
    faults = phase_faults(cfg, params)
    phase(61, "zamba2-2.7b tier and fault phases 56-58, 61",
          seconds=f"{time.perf_counter() - t0:.1f}")
    return dict(moves=moves, runs=runs, overlap=over,
                traces=dict(tier=over["trace"], faults=faults))


# ---------------------------------------------------------------------------
# observability: the trace, the recompile watcher, the launcher (62-63)
# ---------------------------------------------------------------------------

#: the features each engine's trace must carry (repro_torch.obs.schema)
TRACE_NEEDS = {
    "slots": ("steps", "spans", "recompile"),
    "paged": ("steps", "spans", "bank", "recompile"),
    "verify": ("steps", "spans", "bank", "recompile", "speculation"),
    "tier": ("steps", "spans", "bank", "recompile", "tiered"),
    "faults": ("steps", "spans", "bank", "recompile", "tiered",
               "resilience"),
}
#: replays of one step's emit and describe calls, timed for their host cost
HOST_REPLAYS = 1000


def _trace_record(eng, label):
    """Save ``eng``'s trace as ``chiprun_out/trace_<label>.json`` and keep
    what phase 62 reads of it: the watcher's per-site counts, the events
    (metadata excluded) and the decode steps behind them."""
    OUT.mkdir(exist_ok=True)
    path = OUT / f"trace_{label}.json"
    eng.save_trace(str(path))
    return dict(path=path, counts=eng.obs.recompiles.counts(),
                events=sum(1 for e in eng.obs.tracer.events()
                           if e["ph"] != "M"),
                dropped=eng.obs.tracer.dropped, steps=eng.engine.step_count)


def _steady(eng, cfg, rng, sites, label, n_steps=8):
    """Four 64-token requests through ``eng``; once all four decode, the
    next ``n_steps`` steps (one page each, constant shapes) must add no
    watcher event.  Returns the trace events per steady step, the steady
    step's host wall, and one call's arguments of each site in ``sites``
    (captured on the first steady step)."""
    import torch
    pool = eng.engine.pool
    hs = [eng.submit(rng.integers(0, cfg.vocab_size, 64),
                     max_new_tokens=n_steps + 4) for _ in range(4)]
    eng.step()                  # four prefills + the first step
    eng.step()
    check(all(h.status == "running" for h in hs),
          f"{label}: {[h.status for h in hs]} before the steady window")
    captured, inner = {}, {}
    for site in sites:
        wfn = getattr(pool, site)
        inner[site] = wfn._fn

        def capture(*a, _site=site, **k):
            captured.setdefault(_site, (a, k))
            return inner[_site](*a, **k)
        wfn._fn = capture
    n0, ev0 = eng.obs.recompiles.n_events, len(eng.obs.tracer.events())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_steps
    for site in sites:
        getattr(pool, site)._fn = inner[site]
    per_step = (len(eng.obs.tracer.events()) - ev0) / n_steps
    new = eng.obs.recompiles.events[n0:]
    check(not new, f"{label}: a steady decode step added watcher events "
          f"{[(e.fn, e.changed) for e in new]}")
    eng.run()
    check(all(h.status == "done" for h in hs), f"{label}: not done")
    return dict(per_step=per_step, wall_ms=wall * 1e3, args=captured)


def _key_us(wfn, calls):
    """Host microseconds of ``wfn``'s per-call signature and lookup,
    replayed over ``calls`` ((args, kwargs) each, in turn)."""
    t0 = time.perf_counter()
    for i in range(HOST_REPLAYS):
        a, k = calls[i % len(calls)]
        wfn.key(*a, **k) in wfn._seen
    return (time.perf_counter() - t0) * 1e6 / HOST_REPLAYS


def _emit_us(bank, spec):
    """Host microseconds of one step's trace events (the decode_step X
    event, the bank and pool counters, the spec counter on a verify
    step), replayed into a scratch buffer."""
    from repro_torch.obs import TraceBuffer
    tr = TraceBuffer()
    pool = {"occupancy": 0.5, "fragmentation": 0.25}
    t0 = time.perf_counter()
    for i in range(HOST_REPLAYS):
        tr.complete("decode_step", cat="step", ts=tr.now_us(), dur=1.0,
                    track="engine", step=i, batch=4, compiled=False)
        tr.counter("bank_traffic", bank)
        tr.counter("pool", pool)
        if spec:
            tr.counter("spec", {"proposed": 9, "accepted": 3})
    return (time.perf_counter() - t0) * 1e6 / HOST_REPLAYS


def phase_trace(cfg, params, records):
    """Phase 62: the trace at full width.  The traces of the slot (7),
    paged (11), verify (14), tier (58's prefetch resume) and fault (61's
    chaos plan) engines validate and carry their features; the watcher's
    per-site counts on each path.  On fresh paged and verify engines, a
    steady decode step adds no watcher event; the trace events per steady
    step; and the host time that the tracer (one step's events) and the
    watcher (one step's signatures, the slot engine's cache tree included)
    add to a step, each from 1,000 replays."""
    import numpy as np
    import torch
    from repro_torch.core import pimsim
    from repro_torch.obs import trace_features, validate_chrome_trace
    from repro_torch.obs.recompile import _describe as describe
    from repro_torch.serving.api import Engine, ServeConfig
    t0 = time.perf_counter()
    for label, rec in records.items():
        obj = json.loads(rec["path"].read_text())
        errors = validate_chrome_trace(obj)
        feats = trace_features(obj)
        missing = sorted(set(TRACE_NEEDS[label]) - feats)
        check(not errors and not missing and rec["dropped"] == 0,
              f"trace {label}: errors {errors[:3]}, missing {missing}, "
              f"dropped {rec['dropped']}")
        phase(62, f"trace {label}", file=rec["path"].name,
              MB=f"{rec['path'].stat().st_size / 1e6:.2f}",
              events=rec["events"], decode_steps=rec["steps"],
              events_per_step=f"{rec['events'] / max(rec['steps'], 1):.2f}",
              features=",".join(sorted(feats)),
              sites=repr(dict(sorted(rec["counts"].items()))))
    rng = np.random.default_rng(62)
    paged = Engine(params, cfg, ServeConfig(**PAGED))
    plain = _steady(paged, cfg, rng, ("_decode",), "paged")
    bank = pimsim.bank_trace_counters(paged.engine.last_traffic)
    paged_key = _key_us(paged.engine.pool._decode, [plain["args"]["_decode"]])
    paged_sites = paged.obs.recompiles.counts()
    del paged
    verify = Engine(params, cfg, ServeConfig(**PAGED, spec="ngram",
                                             spec_k=SPEC_K))
    spec = _steady(verify, cfg, rng, ("_decode_spec", "_commit_spec"),
                   "verify")
    vpool = verify.engine.pool
    verify_key = (_key_us(vpool._decode_spec,
                          [spec["args"]["_decode_spec"]])
                  + _key_us(vpool._commit_spec,
                            [spec["args"]["_commit_spec"]]))
    verify_sites = verify.obs.recompiles.counts()
    del verify
    # the slot engine's decode gets a new cache list every step: replay
    # two distinct lists over the same caches, so each call walks the tree
    slot = Engine(params, cfg, ServeConfig(backend="slots", batch=4,
                                           cache_capacity=1024))
    se = slot.engine
    lens = torch.full((4,), 64, dtype=torch.int32, device=se.device)
    calls = [((params,), dict(tokens=se.cur_tokens, caches=list(se.caches),
                              lengths=lens, seed=i)) for i in (1, 2)]
    slot_key = _key_us(se._decode, calls)
    n_leaves = len(describe((), {"caches": se.caches}))
    del slot, se, calls
    gc.collect()
    torch.cuda.empty_cache()
    emit_plain, emit_spec = _emit_us(bank, False), _emit_us(bank, True)
    phase(62, "steady decode steps add no watcher event",
          paged=f"{plain['per_step']:.2f} events/step, sites "
          f"{dict(sorted(paged_sites.items()))}",
          verify=f"{spec['per_step']:.2f} events/step, sites "
          f"{dict(sorted(verify_sites.items()))}")
    phase(62, "host cost per step (1,000 replays each)",
          tracer_emit_us=f"paged {emit_plain:.2f}, verify {emit_spec:.2f}",
          watcher_us=f"paged {paged_key:.2f}, verify {verify_key:.2f}, "
          f"slots {slot_key:.2f} ({n_leaves} cache leaves)",
          step_wall_ms=f"paged {plain['wall_ms']:.3f}, verify "
          f"{spec['wall_ms']:.3f}",
          share=f"paged {(emit_plain + paged_key) / 10 / plain['wall_ms']:.4f}"
          f"%, verify {(emit_spec + verify_key) / 10 / spec['wall_ms']:.4f}%",
          seconds=f"{time.perf_counter() - t0:.1f}")


def phase_launcher():
    """Phase 63: the launcher as a user runs it, in its own process, on
    zamba2-2.7b at full width: ``--paged --mixed --stream --turns 2``; it
    must exit 0, stream tokens, hold the session, and write a trace that
    the schema CLI accepts with steps, spans, bank and recompile."""
    import os
    from repro_torch.obs.schema import main as schema_main
    OUT.mkdir(exist_ok=True)
    path = OUT / "serve_trace.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "zamba2-2.7b", "--paged", "--mixed", "--stream", "--turns", "2",
           "--requests", "6", "--max-new", "8", "--trace", str(path)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    (OUT / "serve_stdout.txt").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"launcher exited {proc.returncode}: "
          f"{proc.stderr[-1500:]}")
    lines = proc.stdout.splitlines()
    check(any("] += [" in ln for ln in lines)
          and any(ln.strip().startswith("turn 1: sent") for ln in lines)
          and any(ln.startswith("trace: ") for ln in lines),
          "launcher output lacks streamed tokens, the session or the trace "
          "line")
    rc = schema_main([str(path), "--require", "steps,spans,bank,recompile"])
    check(rc == 0, f"the launcher's trace fails the schema (rc {rc})")
    phase(63, "launcher zamba2-2.7b --paged --mixed --stream --turns 2",
          wall_s=f"{wall:.1f}",
          summary=repr(next(ln for ln in lines if "requests," in ln)),
          trace=repr(next(ln for ln in lines if ln.startswith("trace: "))),
          stdout=(OUT / "serve_stdout.txt").name)


#: phase 64: the swamping study's length (300 kernel-1 launches a rounding)
SWAMP_T = 300
#: phase 65: mamba2-2.7b at full width and depth under each state format --
#: (label, format, rounding, backend); mx8 through kernels 1 and 7
FORMAT_RUNS = (("fp32", "fp32", "nearest", "torch"),
               ("mx8_sr", "mx8", "stochastic", "cuda"),
               ("mx8_rn", "mx8", "nearest", "cuda"),
               ("int8_sr", "int8", "stochastic", "torch"),
               ("fp8_e5m2_rn", "fp8_e5m2", "nearest", "torch"),
               ("fp8_e5m2_sr", "fp8_e5m2", "stochastic", "torch"))
FORMAT_PROMPT, FORMAT_STEPS = 16, 24


def _swamping_orderings(errs):
    """The orderings ``tests/test_state_update.py`` holds the JAX study to
    (paper Fig. 4): the ones that fail."""
    e = errs
    rules = {
        "mx8 SR < e5m2 RN / 2":
            e[("mx8", "stochastic")] < e[("fp8_e5m2", "nearest")] / 2,
        "int8 SR < e5m2 RN / 3":
            e[("int8", "stochastic")] < e[("fp8_e5m2", "nearest")] / 3,
        "e4m3 RN < e5m2 RN":
            e[("fp8_e4m3", "nearest")] < e[("fp8_e5m2", "nearest")],
        "fp16 < 0.01": e[("fp16", "nearest")] < 0.01,
        "mx8 SR < mx8 RN":
            e[("mx8", "stochastic")] < e[("mx8", "nearest")],
        "e5m2 SR < e5m2 RN / 2":
            e[("fp8_e5m2", "stochastic")] < e[("fp8_e5m2", "nearest")] / 2,
        "e4m3 SR < e4m3 RN / 2":
            e[("fp8_e4m3", "stochastic")] < e[("fp8_e4m3", "nearest")] / 2,
    }
    return [k for k, ok in rules.items() if not ok]


def phase_swamping():
    """Phase 64: the swamping study (paper Fig. 4's mechanism,
    ``analysis/formats_study.py``) on the card, T = 300, from one set of
    draws: every format on the torch backend, then with mx8 through kernel
    1 (dense mode, one (1, 1, 32, 32) head; 300 launches a rounding,
    counted).  Kernel 1 is held to its phase-4 contract against its plain
    version at every step of the study's trajectory (both roundings), the
    two runs' mx8 rows must agree to rtol 1e-3, and the Fig. 4 orderings
    must hold on both.  Each error prints beside the CPU port's from the
    same draws."""
    import torch
    from repro_torch.analysis.formats_study import (run_swamping_study,
                                                    swamping_draws,
                                                    swamping_inputs)
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_state_update as KS
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(64)
    draws = swamping_draws(SWAMP_T, generator=g, device="cuda")
    _counts_reset()
    on_torch = run_swamping_study(SWAMP_T, draws=draws, device="cuda")
    check(_counts()["k1"] == 0, "the torch-backend study launched kernel 1")
    on_k1 = run_swamping_study(SWAMP_T, draws=draws, device="cuda",
                               backend="cuda")
    n_k1 = _counts()["k1"]
    check(n_k1 == 2 * SWAMP_T, f"kernel 1 ran {n_k1} times in the study, "
          f"not {2 * SWAMP_T}")
    t_card = time.perf_counter() - t0
    on_cpu = run_swamping_study(SWAMP_T, draws=[a.cpu() for a in draws],
                                device="cpu")
    # kernel 1 against its plain version at every step of the trajectory
    d, ks, vs, qs = swamping_inputs(draws, "cuda")
    mism = total = 0
    y_err = 0.0
    for rounding in ("nearest", "stochastic"):
        qS = F.mx8_quantize(torch.zeros((1, 1, 32, 32), device="cuda"))
        for t in range(SWAMP_T):
            qp, yp = KS.plain(qS.clone(), d, ks[t], vs[t], qs[t],
                              rounding=rounding, seed=t)
            qk, yk = KS.mx_state_update(qS.clone(), d, ks[t], vs[t], qs[t],
                                        seed=t, rounding=rounding)
            n_bad, n, err = _hold_su(f"study step {t} {rounding}",
                                     qp.payload, yp, qk.payload, yk)
            mism, total, y_err = mism + n_bad, total + n, max(y_err, err)
            qS = qk
    rate = mism / total
    check(rate <= 1e-5, f"study trajectory: mantissa mismatch rate {rate:.3g}")
    for rounding in ("nearest", "stochastic"):
        a, b = on_k1[("mx8", rounding)], on_torch[("mx8", rounding)]
        check(abs(a - b) <= 1e-3 * b, f"mx8 {rounding}: kernel 1's study "
              f"error {a:.6g} vs the torch backend's {b:.6g}")
    for label, errs in (("torch backend", on_torch), ("kernel 1", on_k1),
                        ("CPU port", on_cpu)):
        bad = _swamping_orderings(errs)
        check(not bad, f"swamping orderings fail on the {label}: {bad}")
    phase(64, "swamping study on the card (T=300, Fig. 4 orderings hold)",
          k1_launches=n_k1, trajectory_mantissa_mismatch=f"{mism}/{total}",
          trajectory_y_max_abs_err=f"{y_err:.3g}",
          card_s=f"{t_card:.1f}")
    for key in on_torch:
        fmt, rounding = key
        phase(64, f"{fmt} {rounding}", card_torch=repr(on_torch[key]),
              card_kernel1=(repr(on_k1[key]) if fmt == "mx8" else "-"),
              cpu_port=repr(on_cpu[key]))
    phase(64, "swamping study", seconds=f"{time.perf_counter() - t0:.1f}")


def phase_format_model():
    """Phase 65: the format study at model level -- mamba2-2.7b (the arch
    ``examples/format_ablation.py`` studies) at full width and all 64
    layers, seeded weights on the card shared by every format, one
    16-token prompt, a prefill then 24 ``decode_step``s under each state
    format of ``FORMAT_RUNS``.  Every format is fed the fp32 run's greedy
    tokens, so its logits compare with fp32's on the same inputs: the
    relative error (Frobenius over the prefill and 24 steps) and the greedy
    agreement print, reported, not asserted (the weights are random).
    Asserted: finite logits, the fp32 run repeats bitwise, every mx8 decode
    step launched kernel 1 once a layer and each prefill kernel 7 once a
    layer, and no plain MX8 quantizer ran on the card.  Beside each
    format's measured step time, its roofline: the weights at their served
    fp32 size plus the cache and state bytes (``_cache_state_bytes``, the
    state read and written), over ``HBM_BW``."""
    import torch
    from repro_torch import ops as OPS
    from repro_torch.analysis.roofline import (HBM_BW, _cache_state_bytes,
                                               analytic_cost, count_params)
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig
    t0 = time.perf_counter()
    cfg, params, info = _model_at("mamba2-2.7b")
    check(cfg.n_layers == 64 and cfg.pattern == ("mamba2",),
          f"unexpected {cfg.name}")
    g = torch.Generator(device="cuda").manual_seed(65)
    prompt = torch.randint(0, cfg.vocab_size, (1, FORMAT_PROMPT),
                           generator=g, device="cuda")
    lens = torch.full((1,), FORMAT_PROMPT, dtype=torch.int32, device="cuda")
    sc = ShapeConfig("format_study", FORMAT_PROMPT + FORMAT_STEPS, 1,
                     "decode")
    weights = _weight_stream_bytes(cfg, params)
    analytic_ms = analytic_cost(
        cfg, sc, chips=1, tp=1, fs=1, pods=1,
        n_params=count_params(params))["hbm_bytes"] / HBM_BW * 1e3

    def run(fmt, rounding, backend, feed=None):
        c = cfg.with_(state_quant=OPS.StateQuantConfig(fmt, rounding,
                                                       backend))
        _counts_reset()
        q0 = PLAIN_QUANT["calls"]
        logits, caches = M.prefill(params, c, {"tokens": prompt})
        k7 = _counts()["k7"]
        seq, fed = [logits], []
        tok = logits.argmax(-1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(FORMAT_STEPS):
            tok = tok if feed is None else feed[i]
            fed.append(tok)
            logits, caches = M.decode_step(params, c, tok, caches, lens + i,
                                           seed=i + 1)
            seq.append(logits)
            tok = logits.argmax(-1)
        end.record()
        torch.cuda.synchronize()
        n = _counts()
        kv, state = _cache_state_bytes(c, sc)
        return dict(logits=torch.stack(seq), fed=fed, k7=k7, k1=n["k1"],
                    k1s=n["k1s"], plain=PLAIN_QUANT["calls"] - q0,
                    step_ms=start.elapsed_time(end) / FORMAT_STEPS,
                    bound_ms=(weights + kv + 2 * state) / HBM_BW * 1e3)

    ref = run("fp32", "nearest", "torch")
    again = run("fp32", "nearest", "torch", feed=ref["fed"])
    check(bool(torch.isfinite(ref["logits"]).all()), "fp32 logits not finite")
    check(torch.equal(ref["logits"], again["logits"]),
          "the fp32 run does not repeat bitwise")
    n_state = _k7_per_prefill(cfg)
    rows = {}
    for label, fmt, rounding, backend in FORMAT_RUNS[1:]:
        r = run(fmt, rounding, backend, feed=ref["fed"])
        check(bool(torch.isfinite(r["logits"]).all()),
              f"{label}: logits not finite")
        if fmt == "mx8":
            check(r["k1"] == cfg.n_layers * FORMAT_STEPS and r["k1s"] == 0,
                  f"{label}: kernel 1 ran {r['k1']} times in "
                  f"{FORMAT_STEPS} steps of {cfg.n_layers} layers")
            check(r["k7"] == n_state, f"{label}: kernel 7 ran {r['k7']} "
                  f"times in the prefill, not {n_state}")
            check(r["plain"] == 0, f"{label}: the plain MX8 quantizer ran "
                  f"{r['plain']} times on the card")
        else:
            check(r["k1"] == 0, f"{label}: kernel 1 ran on the torch backend")
        rows[label] = r
    phase(65, "mamba2-2.7b format study: the model", **info,
          prompt=FORMAT_PROMPT, decode_steps=FORMAT_STEPS,
          fp32_repeat="bitwise", fp32_step_ms=f"{ref['step_ms']:.3f}",
          fp32_bound_ms=f"{ref['bound_ms']:.3f}",
          analytic_cost_bf16_weights_ms=f"{analytic_ms:.3f}")
    ref_tok = ref["logits"].argmax(-1)
    for label, r in rows.items():
        diff = r["logits"] - ref["logits"]
        rel = float(torch.linalg.norm(diff) / torch.linalg.norm(
            ref["logits"]))
        last = float(torch.linalg.norm(diff[-1]) / torch.linalg.norm(
            ref["logits"][-1]))
        agree = float((r["logits"].argmax(-1) == ref_tok).float().mean())
        phase(65, f"{label} vs fp32", logit_rel_err=f"{rel:.4g}",
              last_step_rel_err=f"{last:.4g}",
              greedy_agreement=f"{agree:.3f}",
              step_ms=f"{r['step_ms']:.3f}",
              bound_ms=f"{r['bound_ms']:.3f}",
              share_of_bound=f"{r['bound_ms'] / r['step_ms']:.3f}",
              k1=r["k1"], k7=r["k7"], plain_quantizer=r["plain"])
    del params
    phase(65, "format study at model level",
          seconds=f"{time.perf_counter() - t0:.1f}")


# ---------------------------------------------------------------------------
# phases 66-68: training on the card
# ---------------------------------------------------------------------------

#: phase 66: smollm-360m at full width and all 32 layers through the
#: trainer launcher (as its docstring runs it: 256 tokens, batch 8), a
#: checkpoint every TRAIN["k"] steps (params + two fp32 moments: 4.3 GB):
#: one, as 10 steps run
TRAIN = dict(arch="smollm-360m", steps=10, k=6, seq_len=256, batch=8)
#: the loss must fall by at least this many nats, mean of the last five
#: steps against the first five (PERF.md: predicted about 2)
TRAIN_LOSS_DROP = 0.5
#: phase 68: zamba2-2.7b's training steps (batch 2 of 256 tokens)
ZAMBA2_TRAIN = dict(steps=3, seq_len=256, batch=2)
#: phase 68: one attention forward and backward at smollm's heads
LONG_ATTN = dict(S=8192, chunk=512, H=15, KVH=5, d=64)
#: phase 69: train steps of each kind, then the decode check's prompts
DIST = dict(train_steps=3, prompts=4, prompt_len=64, decode_steps=8)


def _trainer(ckpt_dir, label):
    """``python -m repro_torch.launch.train`` at TRAIN in its own process
    (its determinism settings come before CUDA initialises there); its
    output goes to ``chiprun_out/train_<label>.txt``.  Returns the parsed
    report: ``losses``, ``sha256`` (of the final parameters), ``step_ms``,
    ``tokens_per_s``, ``peak_GB``, ``resumed`` (the step it resumed from,
    or None), ``checkpoint_s`` (each save's seconds) and ``wall_s``."""
    import os
    OUT.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN["arch"], "--steps", str(TRAIN["steps"]), "--seq-len",
           str(TRAIN["seq_len"]), "--global-batch", str(TRAIN["batch"]),
           "--ckpt-every", str(TRAIN["k"]), "--ckpt-dir", str(ckpt_dir)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=400,
                          env=env, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    (OUT / f"train_{label}.txt").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"trainer ({label}) exited "
          f"{proc.returncode}: {proc.stderr[-1500:]}")
    lines = proc.stdout.splitlines()
    done = next(ln for ln in lines if ln.startswith("done: loss"))
    fields = dict(part.strip().split(" ", 1) for part in
                  done.split(";")[1:])
    resumed = [int(ln.rsplit(" ", 1)[1]) for ln in lines
               if ln.startswith("auto-resumed from step")]
    saves = [float(ln.split(" in ")[1].split()[0]) for ln in lines
             if ln.startswith("checkpoint step")]
    return dict(losses=[float(v) for v in next(
        ln for ln in lines if ln.startswith("losses ")).split()[1:]],
        sha256=next(ln.split()[1] for ln in lines
                    if ln.startswith("params_sha256 ")),
        checkpoint_s=saves,
        step_ms=float(fields["step_ms"]),
        tokens_per_s=float(fields["tokens_per_s"]),
        peak_GB=fields["peak_GB"], wall_s=wall,
        resumed=resumed[0] if resumed else None)


def phase_train():
    """Phases 66-67.  66: smollm-360m at full width and all 32 layers
    trained by the launcher in its own process, TRAIN["steps"] steps with
    a checkpoint every TRAIN["k"]; then a second process started on that
    run's step-k checkpoint alone (what a run stopped at step k leaves on
    disk) auto-resumes and trains to the end: its losses and its final
    parameters (their SHA-256 digest) must be bitwise the uninterrupted
    run's, and the uninterrupted run's loss must fall by TRAIN_LOSS_DROP.
    67: the step-k checkpoint served (:func:`phase_trained_serve`).  The
    temporary directory goes at the end."""
    import os
    import shutil
    import tempfile
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    # memory-backed where the machine has it: the phase times the trainer,
    # not the disk (each checkpoint is 4.3 GB)
    shm = Path("/dev/shm")
    root = Path(tempfile.mkdtemp(prefix="train_smoke_",
                                 dir=shm if shm.is_dir() else None))
    try:
        free = shutil.disk_usage(root).free
        full, resumed = root / "full", root / "resumed"
        run = _trainer(full, "full")
        k, n = TRAIN["k"], TRAIN["steps"]
        check(sorted(p.name for p in full.iterdir()) ==
              ["LATEST", f"step_{k:08d}"],
              f"checkpoints of the uninterrupted run: "
              f"{sorted(p.name for p in full.iterdir())}")
        (resumed / f"step_{k:08d}").mkdir(parents=True)
        for f in (full / f"step_{k:08d}").iterdir():
            os.link(f, resumed / f"step_{k:08d}" / f.name)
        (resumed / "LATEST").write_text(str(k))
        again = _trainer(resumed, "resumed")
        check(again["resumed"] == k and len(again["losses"]) == n - k,
              f"the restart resumed from {again['resumed']} and ran "
              f"{len(again['losses'])} steps")
        check(again["losses"] == run["losses"][k:],
              "the resumed run's losses differ from the uninterrupted run's")
        check(again["sha256"] == run["sha256"], "the resumed run's final "
              "parameters differ from the uninterrupted run's")
        losses = run["losses"]
        first, final = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        check(all(math.isfinite(v) for v in losses), "a loss is not finite")
        check(first - final >= TRAIN_LOSS_DROP, f"the loss fell "
              f"{first - final:.3f} nats (want >= {TRAIN_LOSS_DROP})")
        ckpt = full / f"step_{k:08d}"
        ckpt_GB = sum(f.stat().st_size for f in ckpt.iterdir()) / 1e9
        phase(66, f"{TRAIN['arch']} trained, full width and depth",
              steps=n, seq_len=TRAIN["seq_len"], batch=TRAIN["batch"],
              loss_first5=f"{first:.4f}", loss_last5=f"{final:.4f}",
              loss_drop=f"{first - final:.4f}",
              step_ms=f"{run['step_ms']:.1f}",
              tokens_per_s=f"{run['tokens_per_s']:.0f}",
              peak_GB=run["peak_GB"], resumed_step_ms=f"{again['step_ms']:.1f}",
              resume="bitwise", params_sha256=run["sha256"][:16],
              checkpoint_GB=f"{ckpt_GB:.2f}",
              checkpoint_save_s=run["checkpoint_s"],
              process_s=f"{run['wall_s']:.1f},{again['wall_s']:.1f}",
              tmp_free_GB=f"{free / 1e9:.0f}",
              deterministic="use_deterministic_algorithms + "
                            "CUBLAS_WORKSPACE_CONFIG=:4096:8")
        phase_trained_serve(resumed, k)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_trained_serve(ckpt_dir, step):
    """Phase 67: the parameters of phase 66's checkpoint at ``step``
    restored onto the card (``restore(..., device="cuda")`` into a
    ``meta`` template, the serve launcher's ``--ckpt-dir`` path) and
    served through the paged pool
    (kernels 3 and 4 fused a layer a step, kernel 7 a layer a prefill) and
    the paged pool with n-gram speculation (kernels 5 and 4), no plain
    quantizer inside any step; the slot path's logits held against the
    plain ops on the same prefill."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    cfg = get_config(TRAIN["arch"])
    t0 = time.perf_counter()
    like = M.init_model(cfg, torch.Generator(), device="meta")
    t1 = time.perf_counter()
    restored, got = CheckpointManager(str(ckpt_dir)).restore(
        {"params": like, "opt_state": None}, device="cuda")
    load_s = time.perf_counter() - t1
    params = restored["params"]
    check(got == step and all(
        p.is_cuda and not p.requires_grad for p in _leaves(params)),
        f"restored step {got}, want {step}")
    L = cfg.n_layers
    k7 = _k7_per_prefill(cfg)
    prompts = _pattern_prompts(np.random.default_rng(67), cfg)[:4]
    paged = _serve_counted(Engine(params, cfg, ServeConfig(**DENSE_PAGED)),
                           cfg, prompts, 8, dict(k3_gqa=L, k4q=L), k7,
                           "trained paged")
    phase(67, f"trained {cfg.name} (checkpoint step {step}) paged",
          template_s=f"{t1 - t0:.1f}", load_s=f"{load_s:.1f}",
          **_fields(paged))
    spec = _serve_counted(
        Engine(params, cfg, ServeConfig(**DENSE_PAGED, spec="ngram",
                                        spec_k=SPEC_K)),
        cfg, prompts, 8, dict(k5_gqa=L, k4q=L * KQ), k7,
        "trained paged + ngram")
    phase(67, f"trained {cfg.name} paged + ngram speculation", Kq=KQ,
          **_fields(spec),
          acceptance_rate=f"{spec['stats']['acceptance_rate']:.3f}")
    _reference_check(params, cfg, prompts[0], n=67)
    del params, restored
    gc.collect()
    torch.cuda.empty_cache()


def _long_attention():
    """One GQA ``blockwise_attention`` forward and backward at smollm's
    heads over LONG_ATTN["S"] positions in 512-position chunks: its peak
    memory above what it was handed, against one (H, S, S) fp32 score
    tensor; its gradients against SDPA's (the library's fused fp32
    attention) on the same inputs, and both timed."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.models import attention as ATT
    w = LONG_ATTN
    S, H, KVH, d, c = w["S"], w["H"], w["KVH"], w["d"], w["chunk"]
    g = torch.Generator(device="cuda").manual_seed(68)
    q = torch.randn((1, S, H, d), device="cuda", generator=g)
    k = torch.randn((1, S, KVH, d), device="cuda", generator=g)
    v = torch.randn((1, S, KVH, d), device="cuda", generator=g)
    dout = torch.randn((1, S, H, d), device="cuda", generator=g)
    inputs = [t.requires_grad_(True) for t in (q, k, v)]

    def flash():
        out = ATT.blockwise_attention(*inputs, q_chunk=c, kv_chunk=c)
        return torch.autograd.grad(out, inputs, dout)

    def sdpa():
        G = H // KVH
        qt, kt, vt = (t.transpose(1, 2) for t in inputs)
        out = Fn.scaled_dot_product_attention(
            qt, kt.repeat_interleave(G, 1), vt.repeat_interleave(G, 1),
            is_causal=True)
        return torch.autograd.grad(out.transpose(1, 2), inputs, dout)

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = flash()
    torch.cuda.synchronize()
    flash_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    want = sdpa()
    torch.cuda.synchronize()
    sdpa_s = time.perf_counter() - t0
    score = H * S * S * 4
    check(peak < score / 8, f"flash forward + backward peaked at "
          f"{peak / 1e9:.3f} GB against one score tensor's "
          f"{score / 1e9:.2f} GB")
    errs = []
    for a, b, name in zip(got, want, "qkv"):
        check(bool(torch.isfinite(a).all()), f"d{name} not finite")
        errs.append(float((a - b).abs().max() / b.abs().max()))
    # within 1e-2 of the largest: the library's fp32 attention may round
    # its products through TF32; a wrong gradient is off by O(1)
    check(max(errs) < 1e-2, f"flash gradients against SDPA's: {errs}")
    return dict(peak_GB=f"{peak / 1e9:.3f}", score_GB=f"{score / 1e9:.2f}",
                flash_fwd_bwd_ms=f"{flash_s * 1e3:.1f}",
                sdpa_fwd_bwd_ms=f"{sdpa_s * 1e3:.1f}",
                max_rel_err_vs_sdpa=",".join(f"{e:.2e}" for e in errs))


def phase_train_zamba2():
    """Phase 68: zamba2-2.7b at full width and ZAMBA2_LAYERS deep (its
    main paths' depth) takes ZAMBA2_TRAIN["steps"] AdamW steps in this
    process: finite losses and gradient norms, and step 0's loss equal to
    rtol 1e-5 to the cross-entropy of a ``want_cache=True`` forward's
    logits (the prefill's path, kernel 7 building its caches), and no
    kernel launched by the training steps; the trained parameters then
    serve through the slot pool (kernels 1 and 2 and the
    dense append every step, kernel 7 every prefill); last, the long
    attention of :func:`_long_attention`."""
    import numpy as np
    import torch
    import torch.nn.functional as Fn
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import batch_to_device, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, init_s = _model()
    w = ZAMBA2_TRAIN
    opt = O.OptimizerConfig(warmup_steps=1, total_steps=w["steps"])
    batch_fn = make_batch_fn(cfg, w["seq_len"], w["batch"])
    b0 = batch_to_device(batch_fn(0), "cuda")
    with torch.no_grad():
        x, positions, prefix_len = M.embed_inputs(params, cfg, b0)
        x, caches = M._run_blocks(params, x, cfg, positions, prefix_len,
                                  want_cache=True)
        x = L.apply_norm(params["final_norm"], x, cfg.norm_kind,
                         cfg.norm_eps)
        logits = (x @ M._lm_head(params, cfg)).float()
        ref = float(Fn.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     b0["targets"].reshape(-1)))
    check(caches[0][0] is not None, "the want_cache=True forward built no "
          "cache")
    del x, caches, logits
    opt_state = O.init_opt_state(params, opt)
    step_fn = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    _counts_reset()
    losses, norms, times = [], [], []
    for i in range(w["steps"]):
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch_fn(i))
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    launched = {k: v for k, v in _counts().items() if v}
    check(not launched, f"the training steps launched kernels: {launched}")
    check(all(math.isfinite(v) for v in losses + norms),
          f"losses {losses}, gradient norms {norms}")
    check(abs(losses[0] - ref) <= 1e-5 * abs(ref),
          f"step 0's loss {losses[0]!r} against the want_cache=True "
          f"forward's {ref!r}")
    del opt_state
    gc.collect()
    torch.cuda.empty_cache()
    phase(68, "zamba2-2.7b trained, full width",
          layers=f"{cfg.n_layers} of 54", steps=w["steps"],
          seq_len=w["seq_len"], batch=w["batch"],
          losses=",".join(f"{v:.4f}" for v in losses),
          grad_norms=",".join(f"{v:.3f}" for v in norms),
          step0_vs_cache_forward=f"{abs(losses[0] - ref):.2e}",
          step_ms=",".join(f"{t * 1e3:.0f}" for t in times),
          peak_GB=f"{peak / 1e9:.2f}", init_s=f"{init_s:.1f}",
          kernel_launches_in_training=0)
    su, attn = _zamba2_launches(cfg)
    prompts = [np.random.default_rng(68).integers(0, cfg.vocab_size, n)
               for n in PROMPT_LENS[:4]]
    slot = _serve_counted(
        Engine(params, cfg, ServeConfig(backend="slots", batch=4,
                                        cache_capacity=1024)),
        cfg, prompts, 8, dict(k1=su, k2_gqa=attn, apd=attn),
        _k7_per_prefill(cfg), "trained zamba2 slots")
    phase(68, "trained zamba2-2.7b slots", **_fields(slot))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase(68, "flash attention forward + backward, S=8192",
          S=LONG_ATTN["S"], chunk=LONG_ATTN["chunk"], H=LONG_ATTN["H"],
          KVH=LONG_ATTN["KVH"], **_long_attention())


@contextlib.contextmanager
def _deterministic():
    """Deterministic kernels for the bitwise comparisons of phase 69 (the
    embedding's and the gather's backward scatter without atomics), as the
    trainer runs them.  This process sets no cuBLAS workspace, so cuBLAS
    only warns (its products on one stream repeat bitwise).  The settings
    come back after."""
    import warnings
    import torch
    import torch.utils.deterministic as det
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CUBLAS_WORKSPACE")
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]


def _dist_train(cfg, par, SH, M, O, make_train_step, batch_fn):
    """Phase 69's training half: DIST["train_steps"] plain steps and as
    many sharded ones from the same seeded weights and batches; losses,
    parameters and moments bitwise.  Returns (plain parameters, sharded
    parameters, step times, the host ms of a rank's parameter cut)."""
    import torch
    from repro_torch.core import tree as T
    opt = O.OptimizerConfig(lr=3e-4, total_steps=TRAIN["steps"],
                            warmup_steps=max(TRAIN["steps"] // 20, 1))
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    state = O.init_opt_state(params, opt)
    p_shard = SH.param_shardings(params, cfg, par)
    sp = SH.distribute(T.tree_map(torch.clone, params), p_shard)
    ss = SH.distribute(T.tree_map(torch.clone, state),
                       SH.opt_state_shardings(state, p_shard, par))
    steps = dict(plain=make_train_step(cfg, opt),
                 sharded=make_train_step(cfg, opt, par=par))
    losses = dict(plain=[], sharded=[])
    ms = dict(plain=[], sharded=[])
    for i in range(DIST["train_steps"]):
        batch = batch_fn(i)
        for kind in ("plain", "sharded"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "plain":
                params, state, m = steps[kind](params, state, batch)
            else:
                sp, ss, m = steps[kind](sp, ss, batch)
            losses[kind].append(float(m["loss"]))
            ms[kind].append((time.perf_counter() - t0) * 1e3)
    check(losses["plain"] == losses["sharded"]
          and all(math.isfinite(v) for v in losses["plain"]),
          f"sharded losses {losses['sharded']} != plain {losses['plain']}")
    for tree, dtree, what in ((params, sp, "parameters"),
                              (state["m"], ss["m"], "first moments"),
                              (state["v"], ss["v"], "second moments")):
        bad = [i for i, (a, b) in enumerate(zip(T.leaves(tree),
                                                T.leaves(dtree)))
               if not torch.equal(a, b.to_local())]
        check(not bad, f"sharded {what} differ from plain at leaves {bad}")
    del state, ss
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        SH.cut_params(sp, cfg, par)
    gather_ms = (time.perf_counter() - t0) / 5 * 1e3
    return params, sp, losses, ms, gather_ms


def _dist_decode(cfg, par, SH, M, params, sp):
    """Phase 69's decode half: a model-level prefill of DIST["prompts"]
    seeded prompts and DIST["decode_steps"] greedy steps, unsharded and
    sharded (parameters, batch and caches in their layouts); logits
    bitwise, each path's launches counted in its own window."""
    import torch
    B, S, n = DIST["prompts"], DIST["prompt_len"], DIST["decode_steps"]
    g = torch.Generator(device="cuda").manual_seed(69)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                        device="cuda")
    lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
    ln_layout = SH.batch_shardings(lengths, par)
    runs, counts, ms = {}, {}, {}
    for kind in ("plain", "sharded"):
        PLAIN_QUANT["calls"] = 0
        _counts_reset()
        if kind == "plain":
            logits, caches = M.prefill(params, cfg, {"tokens": tok})
        else:
            batch = SH.distribute({"tokens": tok}, SH.batch_shardings(
                {"tokens": tok}, par))
            logits, caches = SH.sharded_prefill(sp, cfg, batch, par)
            logits = logits.full_tensor()
        pre = _counts()
        out = [logits]
        nxt = logits.argmax(-1)
        _counts_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            if kind == "plain":
                logits, caches = M.decode_step(params, cfg, nxt, caches,
                                               lengths + i, seed=i + 1)
            else:
                logits, caches = SH.sharded_decode_step(
                    sp, cfg, SH.distribute(nxt, ln_layout), caches,
                    SH.distribute(lengths + i, ln_layout), par, seed=i + 1)
                logits = logits.full_tensor()
            out.append(logits)
            nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        ms[kind] = (time.perf_counter() - t0) / n * 1e3
        counts[kind] = (pre, _counts())
        if kind == "plain":
            plain_cache = next(M.iter_kv_caches(caches))
        check(PLAIN_QUANT["calls"] == 0, f"{kind} decode: the plain MX8 "
              f"quantizer ran {PLAIN_QUANT['calls']} times in a step")
        runs[kind] = out
    for i, (a, b) in enumerate(zip(runs["plain"], runs["sharded"])):
        check(torch.equal(a, b), f"sharded logits differ from the "
              f"unsharded at step {i}: max |d| "
              f"{float((a - b).abs().max()):.3g}")
    check(counts["plain"] == counts["sharded"], f"launches: sharded "
          f"{counts['sharded']}, unsharded {counts['plain']}")
    pre, dec = counts["sharded"]
    check(pre["k7"] > 0 and dec["k2_gqa"] > 0 and dec["apd"] > 0,
          f"phase 69's path launched no kernel 7, 2 or append: {pre} {dec}")
    _row_base_append(plain_cache, B // 2)
    return ({k: v / n for k, v in dec.items() if v}, pre["k7"], ms,
            bool(torch.isfinite(runs["plain"][-1]).all()))


def _row_base_append(cache, b0):
    """A second data rank's dense append on the card, on the decoded
    cache of the path's first attention layer: rows ``b0 ..`` of the K/V
    rows appended with their row base are bitwise what the whole batch's
    append writes for them, and what the plain version writes (the draws
    ``sharded_decode_step`` keys on the rank's first row).  Kernel level:
    a model-level half batch is not bitwise the whole batch's rows on the
    card, as cuBLAS takes other GEMM kernels for fewer rows."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_quant as KQ
    g = torch.Generator(device="cuda").manual_seed(70)
    B, _, KVH, w = cache.k.shape
    rows = [torch.randn((B, 1, KVH, w), generator=g, device="cuda")
            for _ in "kv"]
    rows_of = lambda qt, lo: F.QuantizedTensor(
        "mx8", (B - lo,) + tuple(qt.shape[1:]),
        {f: a[lo:].clone() for f, a in qt.payload.items()})
    whole = [rows_of(c, 0) for c in (cache.k, cache.v)]
    part = [rows_of(c, b0) for c in (cache.k, cache.v)]
    plain = [rows_of(c, b0) for c in (cache.k, cache.v)]
    n0 = KQ.mx_kv_append_quant.launches
    KQ.mx_kv_append_quant(rows, whole, cache.lengths, 9)
    KQ.mx_kv_append_quant([r[b0:] for r in rows], part, cache.lengths[b0:],
                          9, row_base=b0)
    KQ.plain_append([r[b0:] for r in rows], plain, cache.lengths[b0:], 9,
                    "stochastic", b0)
    torch.cuda.synchronize()
    check(KQ.mx_kv_append_quant.launches == n0 + 2,
          "the row-base append did not launch its kernel")
    for w_, p_, q_ in zip(whole, part, plain):
        for f in p_.payload:
            check(torch.equal(p_.payload[f], w_.payload[f][b0:])
                  and torch.equal(p_.payload[f], q_.payload[f]),
                  f"the append's rows {b0}.. with their row base differ "
                  f"from the whole batch's ({f})")


def _dist_compress(cfg, M, params, batch_fn):
    """Phase 69's compression: one gradient tree at the trained weights
    through the compressed all-reduce over NCCL (the one-rank world) and
    through the CPU compressor; ``q``, ``scale``, the reduced tree and
    the residual bitwise."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import tree as T
    from repro_torch.dist import compression as C
    from repro_torch.train.train_loop import _loss_and_grads, batch_to_device
    _, grads = _loss_and_grads(params, cfg, batch_to_device(
        batch_fn(DIST["train_steps"]), "cuda"))
    cpu = T.tree_map(lambda t: t.cpu(), grads)
    for g, h in zip(T.leaves(grads), T.leaves(cpu)):
        q, s = C.quantize_int8(g)
        qc, sc = C.quantize_int8(h)
        check(torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc),
              "int8 q / scale on the card differ from the CPU's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    red, ef = C.compressed_allreduce_mean(grads, C.init_error_feedback(grads),
                                          group=dist.group.WORLD)
    torch.cuda.synchronize()
    nccl_ms = (time.perf_counter() - t0) * 1e3
    red_c, ef_c = C.compressed_allreduce_mean(cpu, C.init_error_feedback(cpu))
    for a, b in zip(T.leaves(red) + T.leaves(ef),
                    T.leaves(red_c) + T.leaves(ef_c)):
        check(torch.equal(a.cpu(), b), "the NCCL compressed all-reduce "
              "differs from the CPU compressor")
    n = sum(g.numel() for g in T.leaves(grads))
    # compressed_bytes is the int8 payload's nominal size; the all-reduce
    # (as the JAX package's pmean) sends the dequantized fp32 values
    return dict(values=n, int8_payload_bytes=C.compressed_bytes(grads),
                bf16_bytes=2 * n, sent_fp32_bytes=4 * n,
                leaves=len(T.leaves(grads)),
                nccl_ms=f"{nccl_ms:.1f}")


def phase_dist():
    """Phase 69: the distribution layer on the card at world size 1 (NCCL
    refuses two ranks on one card): an NCCL group of one rank and a (1, 1)
    ``Parallel`` over "cuda", destroyed at the end.  smollm-360m at full
    width and all 32 layers from phase 66's seeded weights and batches:
    ZeRO-sharded train steps against plain ones (:func:`_dist_train`),
    the sharded model-level prefill and decode on the trained weights
    against the unsharded (:func:`_dist_decode`), and the compressed
    all-reduce through NCCL against the CPU (:func:`_dist_compress`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import local_init_method, make_local_parallel
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=local_init_method(),
                            world_size=1, rank=0)
    try:
        par = make_local_parallel(1, 1, device_type="cuda")
        cfg = get_config(TRAIN["arch"])
        batch_fn = make_batch_fn(cfg, TRAIN["seq_len"], TRAIN["batch"])
        init_s = time.perf_counter() - t_start
        with _deterministic():
            params, sp, losses, ms, gather_ms = _dist_train(
                cfg, par, SH, M, O, make_train_step, batch_fn)
        phase(69, f"{cfg.name} ZeRO-sharded train steps at world size 1 "
              "(NCCL, a (1, 1) mesh)", steps=DIST["train_steps"],
              losses=",".join(f"{v:.6f}" for v in losses["sharded"]),
              losses_and_params="bitwise the plain steps'",
              plain_step_ms=",".join(f"{v:.1f}" for v in ms["plain"]),
              sharded_step_ms=",".join(f"{v:.1f}" for v in ms["sharded"]),
              cut_params_host_ms=f"{gather_ms:.2f}",
              nccl_init_s=f"{init_s:.1f}")
        per_step, k7, dec_ms, finite = _dist_decode(cfg, par, SH, M, params,
                                                    sp)
        check(finite, "phase 69: the decode's logits are not finite")
        phase(69, f"{cfg.name} sharded prefill + {DIST['decode_steps']} "
              "decode steps", prompts=DIST["prompts"],
              prompt_len=DIST["prompt_len"], logits="bitwise the unsharded",
              append_rows_with_row_base="bitwise the whole batch's rows",
              launches_per_step=",".join(f"{k}={v:g}"
                                         for k, v in per_step.items()),
              prefill_k7=k7, plain_quantizer_calls_in_steps=0,
              plain_step_ms=f"{dec_ms['plain']:.2f}",
              sharded_step_ms=f"{dec_ms['sharded']:.2f}")
        del sp
        comp = _dist_compress(cfg, M, params, batch_fn)
        phase(69, "int8 compressed all-reduce through NCCL", **comp,
              q_scale_reduced_residual="bitwise the CPU's")
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    phase(69, "the distribution layer",
          seconds=f"{time.perf_counter() - t_start:.1f}")


# ---------------------------------------------------------------------------
# phase 70: tensor-parallel serving
# ---------------------------------------------------------------------------

#: phase 70: (a) the head-shard launches at zamba2's widths, rank ``tp - 1``
#: of tp = 2 and 4; (b) two ranks sharing the one card over gloo serve
#: zamba2-2.7b at full width and ZAMBA2_LAYERS deep: a model-level prefill
#: of ``B`` prompts of ``S`` tokens and ``steps`` decode steps at fp32
#: state (``sr_steps`` at MX8 SR) against tp = 1, then the paged engine
#: with four requests and ``max_new`` new tokens
TP = dict(degrees=(2, 4), ranks=2, B=4, S=64, steps=8, sr_steps=4,
          max_new=16, paged=dict(batch=4, n_pages=17, prefill_chunk=512),
          prompts=(64, 400, 133, 251), timeout_s=700)
#: phase 70 (b)'s other models, after zamba2, on the same two workers:
#: (arch, layers, the cut), each at full width; a model-level prefill of
#: ``TP["B"]`` prompts of ``TP["S"]`` tokens and TP_NEW_STEPS decode steps
#: at fp32 state and at MX8 SR against tp = 1; deepseek then through the
#: paged engine without and with n-gram speculation (TP_DS_ENGINE)
TP_NEW = (("gla-2.7b", 4, "n_layers 32 -> 4"),
          ("xlstm-1.3b", 8, "n_layers 48 -> 8 (7 mLSTM + the sLSTM)"),
          ("deepseek-v2-236b", 2,
           "n_layers 60 -> 2 (the dense prelude layer + one MoE layer)"))
TP_NEW_STEPS = 4
TP_DS_ENGINE = dict(prompts=(64, 133, 97, 120), max_new=8)
#: phase 70 (b)'s data axes, last on the same two workers as a (2, 1)
#: mesh: zamba2 (ZAMBA2_LAYERS deep) through the slot engine and through a
#: paged engine whose 4 usable pages force preemptions (each request grows
#: a second page), so requests resume in rows of the other data rank and
#: their pages move; fp32 state and the config's MX8 SR
DP = dict(prompts=(120, 126, 121, 127), max_new=8,
          slots=dict(backend="slots", batch=4, cache_capacity=256),
          paged=dict(batch=4, n_pages=5, prefill_chunk=512))


def _shard(qt, h0, n, dim):
    """Heads ``h0 .. h0 + n - 1`` (along ``dim``) of an MX8 tensor, a copy."""
    from repro_torch.core import formats as F
    return F.QuantizedTensor("mx8", tuple(
        n if i == dim else e for i, e in enumerate(qt.shape)),
        {f: a.narrow(dim, h0, n).clone() for f, a in qt.payload.items()})


def _same_heads(shard, whole, h0, dim, what):
    import torch
    from repro_torch.core import formats as F
    if isinstance(shard, F.QuantizedTensor):
        for f, a in shard.payload.items():
            check(torch.equal(a, whole.payload[f].narrow(dim, h0, a.shape[
                dim])), f"{what}: {f} of the head shard differs from the "
                "whole launch's heads")
        return
    check(torch.equal(shard, whole.narrow(dim, h0, shard.shape[dim])),
          f"{what}: the head shard differs from the whole launch's heads")


def _payload_err(a, b):
    """Max |difference| over the payload bytes of two MX8 tensors."""
    return max(float((a.payload[f].float() - b.payload[f].float()).abs()
                     .max()) for f in a.payload)


def _tp_kernels(tp):
    """Phase 70 (a) at one degree: rank ``tp - 1``'s share of zamba2's
    heads through kernel 1 (dense and slab mode), the dense append, the
    fused paged append (each with its head base) and kernels 2, 3 and 5,
    each held bitwise against the whole launch's heads and timed beside
    its plain version (and SDPA for the attention kernels)."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_quant as K7
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import mx_state_update as KS
    from repro_torch.kernels import ref as R
    out, errs = {}, {}
    B, H, dv, dk = SU_SHAPES[0]
    n = H // tp
    h0 = (tp - 1) * n
    hs = lambda t: t[:, h0:h0 + n].contiguous()
    g = torch.Generator(device="cuda").manual_seed(700 + tp)
    # -- kernel 1, dense mode: 24 states (one a Mamba-2 layer) rotate
    states = [F.mx8_quantize(torch.randn((B, H, dv, dk), generator=g,
                                         device="cuda")) for _ in range(24)]
    d = torch.sigmoid(torch.randn((B, H, 1), generator=g, device="cuda"))
    k, q = (torch.randn((B, H, dk), generator=g, device="cuda") for _ in "kq")
    v = torch.randn((B, H, dv), generator=g, device="cuda")
    sw, yw = KS.mx_state_update(states[0].clone(), d, k, v, q, seed=7)
    part = [_shard(s, h0, n, 1) for s in states]
    args = (hs(d), hs(k), hs(v), hs(q))
    ss, ys = KS.mx_state_update(part[0].clone(), *args, seed=7, head_base=h0,
                                heads_total=H)
    sp, yp = KS.plain(part[0].clone(), *args, seed=7, head_base=h0,
                      heads_total=H)
    torch.cuda.synchronize()
    _same_heads(ss, sw, h0, 1, f"kernel 1 at tp={tp}")
    _same_heads(ys, yw, h0, 1, f"kernel 1's y at tp={tp}")
    _hold_su(f"kernel 1 head shard tp={tp}", sp.payload, yp, ss.payload, ys)
    errs["su"] = float((ys - yp).abs().max())
    kern = [lambda i=i: KS.mx_state_update(part[i], *args, seed=i,
                                           head_base=h0, heads_total=H)
            for i in range(24)]
    plain = [lambda i=i: KS.plain(part[i], *args, seed=i, head_base=h0,
                                  heads_total=H) for i in range(4)]
    n_val = B * n * dv * dk
    payload = n_val * (1 + 2 / F.MX8_GROUP)
    operands = 4 * (B * n * (1 + 2 * dk + dv) + B * n * dv)
    out["su"] = _report(f"mx_state_update[tp{tp}]", graph_ms(kern, 20),
                        graph_ms(plain, 5), None, host_loop_ms(kern[0], 100),
                        2 * payload + operands, 10 * n_val, 2 * payload,
                        n=70)
    # -- kernel 1, slab mode: the six positions' pools of the rank's heads
    pools = [F.mx8_quantize(torch.randn((5, 4, H, dv, dk), generator=g,
                                        device="cuda")) for _ in range(6)]
    slabs = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    whole = pools[0].clone()
    _, yw = KS.mx_state_update(whole, d, k, v, q, seed=9, slabs=slabs,
                               group=2)
    sp_pools = [_shard(p, h0, n, 2) for p in pools]
    check_pool = sp_pools[0].clone()
    _, ys = KS.mx_state_update(check_pool, *args, seed=9, slabs=slabs,
                               group=2, head_base=h0, heads_total=H)
    torch.cuda.synchronize()
    _same_heads(check_pool, whole, h0, 2, f"kernel 1 slab mode at tp={tp}")
    _same_heads(ys, yw, h0, 1, f"kernel 1 slab mode's y at tp={tp}")
    kern = [lambda p=p, l=l: KS.mx_state_update(
        sp_pools[p], *args, seed=l, slabs=slabs, group=l, head_base=h0,
        heads_total=H) for p in range(6) for l in range(4)]
    plain = [lambda l=l: KS.plain_slab(sp_pools[0], slabs, l, *args, seed=l,
                                       head_base=h0, heads_total=H)
             for l in range(4)]
    out["su_slab"] = _report(f"mx_state_update[slab,tp{tp}]",
                             graph_ms(kern, 20), graph_ms(plain, 5), None,
                             host_loop_ms(kern[0], 100),
                             2 * payload + operands + 4 * B, 10 * n_val,
                             2 * payload, n=70)
    errs["su_slab"] = errs["su"]
    del states, part, pools, sp_pools
    # -- the dense append (the slot pool's K and V of the rank's kv heads)
    a = ATTN
    KVH, w = a["KVH"], a["d"]
    kn = KVH // tp
    k0 = (tp - 1) * kn
    T = 1024
    caches = [F.mx8_quantize(torch.randn((B, T, KVH, w), generator=g,
                                         device="cuda")) for _ in "kv"]
    rows = [torch.randn((B, 1, KVH, w), generator=g, device="cuda")
            for _ in "kv"]
    lens = torch.tensor([0, 400, T - 2, T + 9], dtype=torch.int32,
                        device="cuda")
    mine = [r[:, :, k0:k0 + kn].contiguous() for r in rows]
    part = [_shard(c, k0, kn, 2) for c in caches]
    plain_part = [c.clone() for c in part]
    K7.mx_kv_append_quant(rows, caches, lens, 17)
    K7.mx_kv_append_quant(mine, part, lens, 17, head_base=k0,
                          heads_total=KVH)
    K7.plain_append(mine, plain_part, lens, 17, "stochastic", 0, k0, KVH)
    torch.cuda.synchronize()
    for c, p_, q_ in zip(caches, part, plain_part):
        _same_heads(p_, c, k0, 2, f"the dense append at tp={tp}")
        _same_heads(p_, q_, 0, 2, f"the dense append vs plain at tp={tp}")
    errs["apd"] = max(_payload_err(p_, q_) for p_, q_ in zip(part,
                                                             plain_part))
    kern = [lambda i=i: K7.mx_kv_append_quant(mine, part, lens, i,
                                              head_base=k0, heads_total=KVH)
            for i in range(9)]
    plain = [lambda i=i: K7.plain_append(mine, plain_part, lens, i,
                                         "stochastic", 0, k0, KVH)
             for i in range(3)]
    n_val = 2 * B * kn * w
    out["apd"] = _report(f"mx_kv_append_quant[tp{tp}]", graph_ms(kern, 50),
                         graph_ms(plain, 10), None,
                         host_loop_ms(kern[0], 100),
                         n_val * (4 + 1 + 2 / F.MX8_GROUP) + 4 * B,
                         5 * n_val, n_val * 9 / 8, n=70)
    del caches, part, plain_part
    # -- the fused paged append and kernels 2, 3, 5 over the rank's kv heads
    lengths = [n_ + MAX_NEW // 2 for n_ in PROMPT_LENS[:B]]
    qa, K, V, bt, lens = _paged_kv(lengths, seed=710 + tp, spare=0)
    Ks, Vs = _shard(K, k0, kn, 3), _shard(V, k0, kn, 3)
    rows = _new_rows(B, KVH, w, 2, seed=711)
    mine = [r[:, :, k0:k0 + kn].contiguous() for r in rows]
    Kw, Vw = K.clone(), V.clone()
    KP.mx_paged_kv_append_quant(rows, [Kw, Vw], bt, 1, lens, 5)
    Kc, Vc = Ks.clone(), Vs.clone()
    KP.mx_paged_kv_append_quant(mine, [Kc, Vc], bt, 1, lens, 5, head_base=k0,
                                heads_total=KVH)
    Kp, Vp = Ks.clone(), Vs.clone()
    KP.plain_append_quant(mine, [Kp, Vp], bt, 1, lens, 5, "stochastic", k0,
                          KVH)
    torch.cuda.synchronize()
    for c, w_, p_ in ((Kc, Kw, Kp), (Vc, Vw, Vp)):
        _same_heads(c, w_, k0, 3, f"the paged append at tp={tp}")
        _same_heads(c, p_, 0, 3, f"the paged append vs plain at tp={tp}")
    errs["apq"] = max(_payload_err(Kc, Kp), _payload_err(Vc, Vp))
    # timed on copies: the attention kernels below read Ks / Vs
    Kt, Vt = Ks.clone(), Vs.clone()
    kern = [lambda l=l: KP.mx_paged_kv_append_quant(
        mine, [Kt, Vt], bt, l, lens, l, head_base=k0, heads_total=KVH)
        for l in range(N_STACK)]
    plain = [lambda l=l: KP.plain_append_quant(mine, [Kt, Vt], bt, l, lens,
                                               l, "stochastic", k0, KVH)
             for l in range(3)]
    n_val = 2 * B * kn * w
    out["apq"] = _report(f"mx_paged_kv_append[quant,tp{tp}]",
                         graph_ms(kern, 50), graph_ms(plain, 10), None,
                         host_loop_ms(kern[0], 100),
                         n_val * (4 + 1 + 2 / F.MX8_GROUP) + 4 * B * 2,
                         5 * n_val, n_val * 9 / 8, n=70)
    G_ = a["H"] // KVH
    qs = qa[:, k0 * G_:(k0 + kn) * G_].contiguous()
    Kd, Vd = R.gather_pages(K, bt, 1), R.gather_pages(V, bt, 1)
    Kds, Vds = _shard(Kd, k0, kn, 2), _shard(Vd, k0, kn, 2)
    y2, y2s = (KA.mx_attention_decode(qa, Kd, Vd, lens),
               KA.mx_attention_decode(qs, Kds, Vds, lens))
    y3, y3s = (KP.mx_paged_attention_decode(qa, K, V, bt, 1, lens),
               KP.mx_paged_attention_decode(qs, Ks, Vs, bt, 1, lens))
    q5 = torch.randn((B, KQ, a["H"], w), generator=g, device="cuda")
    q5s = q5[:, :, k0 * G_:(k0 + kn) * G_].contiguous()
    lens5 = lens + KQ
    y5, y5s = (KV.mx_paged_spec_attention_decode(q5, K, V, bt, 1, lens5),
               KV.mx_paged_spec_attention_decode(q5s, Ks, Vs, bt, 1, lens5))
    torch.cuda.synchronize()
    bitwise = {}
    for name, whole_y, shard_y, plain_y in (
            ("k2", y2, y2s, KA.plain(qs, Kds, Vds, lens)),
            ("k3", y3, y3s, KP.plain(qs, Ks, Vs, bt, 1, lens)),
            ("k5", y5, y5s, KV.plain_paged(q5s, Ks, Vs, bt, 1, lens5))):
        sl = whole_y[..., k0 * G_:(k0 + kn) * G_, :]
        bitwise[name] = torch.equal(shard_y, sl)
        if not bitwise[name]:        # the decode-attention contract instead
            torch.testing.assert_close(shard_y, sl, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(shard_y, plain_y, rtol=2e-4, atol=2e-5)
        errs[name] = float((shard_y - plain_y).abs().max())
    valid = sum(lengths)
    mask = (torch.arange(bt.shape[1] * 128, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    kf = F.dequantize(R.gather_pages(Ks, bt, 1)).permute(0, 2, 1, 3
                                                         ).contiguous()
    vf = F.dequantize(R.gather_pages(Vs, bt, 1)).permute(0, 2, 1, 3
                                                         ).contiguous()
    lib = [lambda: torch.nn.functional.scaled_dot_product_attention(
        qs[:, :, None, :], kf, vf, attn_mask=mask)]
    nbytes = (valid * kn * 2 * w * (1 + 2 / F.MX8_GROUP)
              + 4 * B * kn * G_ * 2 * w + 4 * B)
    flops = valid * kn * G_ * 4 * w
    kern = [lambda l=l: KP.mx_paged_attention_decode(qs, Ks, Vs, bt, l, lens)
            for l in range(N_STACK)]
    plain = [lambda l=l: KP.plain(qs, Ks, Vs, bt, l, lens) for l in range(3)]
    out["k3"] = _report(f"mx_paged_attention_decode[tp{tp}]",
                        graph_ms(kern, 30), graph_ms(plain, 3),
                        graph_ms(lib, 30), host_loop_ms(kern[0], 100),
                        nbytes + 4 * sum(bt.shape), flops, nbytes, n=70)
    kern = [lambda: KA.mx_attention_decode(qs, Kds, Vds, lens)]
    plain = [lambda: KA.plain(qs, Kds, Vds, lens)]
    out["k2"] = _report(f"mx_attention_decode[tp{tp}]", graph_ms(kern, 30),
                        graph_ms(plain, 3), graph_ms(lib, 30),
                        host_loop_ms(kern[0], 100), nbytes, flops, nbytes,
                        n=70)
    # kernel 5's yardstick: SDPA with the boolean (B, H, Kq, T) verify mask
    shift = torch.arange(KQ, device="cuda") - (KQ - 1)
    mask5 = (torch.arange(bt.shape[1] * 128, device="cuda")[None, None, :]
             < (lens5[:, None] + shift[None, :])[:, :, None])[:, None]
    q5h = q5s.permute(0, 2, 1, 3).contiguous()
    lib5 = [lambda: torch.nn.functional.scaled_dot_product_attention(
        q5h, kf, vf, attn_mask=mask5, enable_gqa=G_ > 1)]
    y_lib5 = lib5[0]().permute(0, 2, 1, 3)
    torch.cuda.synchronize()
    check(bool(((y_lib5 - y5s).abs() <= 1e-4 + 1e-3 * y5s.abs()).all()),
          f"verify yardstick (SDPA) disagrees with kernel 5 at tp={tp}")
    kern = [lambda l=l: KV.mx_paged_spec_attention_decode(
        q5s, Ks, Vs, bt, l, lens5) for l in range(N_STACK)]
    plain = [lambda: KV.plain_paged(q5s, Ks, Vs, bt, 1, lens5)]
    out["k5"] = _report(f"mx_paged_spec_attention_decode[tp{tp}]",
                        graph_ms(kern, 30), graph_ms(plain, 3),
                        graph_ms(lib5, 30),
                        host_loop_ms(kern[0], 100),
                        nbytes + 4 * B * kn * G_ * 2 * w * (KQ - 1),
                        KQ * flops, nbytes, n=70)
    phase(70, f"head shards at tp={tp} (rank {tp - 1}: heads {h0}..{h0 + n - 1}"
          f" of {H}, kv heads {k0}..{k0 + kn - 1} of {KVH})",
          kernel1_dense_and_slab="bitwise the whole launch's heads",
          dense_append="bitwise", paged_append="bitwise",
          **{f"{k}_shard": "bitwise" if v else "within rtol 2e-4, atol 2e-5"
             for k, v in bitwise.items()},
          max_abs_err_vs_plain=",".join(f"{k}={v:.3g}"
                                        for k, v in errs.items()))
    return out, errs, bitwise


#: phase 70 (a)'s kernel-1 head shards of the GLA family and the mLSTM:
#: (tag, the whole layer's (B, H, dv, dk), scalar decay, tp degrees); a
#: rank holds H / tp heads, the last rank's from (tp - 1) * H / tp
TP_SU = (("gla", GLA_SU[0][1], False, (2, 4)),
         ("retnet", GLA_SU[1][1], True, (2,)),
         ("hgrn2", GLA_SU[2][1], False, (2, 4)),
         ("xlstm", XLSTM_SU, True, (2, 4)))


def _tp_su_shards():
    """Phase 70 (a), kernel 1 at the GLA family's and the mLSTM's head
    shards: the last rank's heads of a whole dense launch and of a whole
    slab-mode launch (their pools' rows of the rank's heads), with its
    head base, bitwise the whole launch's heads (state payload and ``y``)
    and its plain version's; the tp = 2 shards timed as ``_time_su``
    times the whole layers (no PyTorch call updates an MX8 state: no
    library time)."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_state_update as KS
    out, errs = {}, {}
    for tag, shape, scalar, degrees in TP_SU:
        B, H, dv, dk = shape
        g = torch.Generator(device="cuda").manual_seed(720 + H)
        dd = 1 if scalar else dk
        d = torch.sigmoid(torch.randn((B, H, dd), generator=g, device="cuda"))
        k, q = (torch.randn((B, H, dk), generator=g, device="cuda")
                for _ in "kq")
        v = torch.randn((B, H, dv), generator=g, device="cuda")
        S = F.mx8_quantize(torch.randn(shape, generator=g, device="cuda"))
        pool = F.mx8_quantize(torch.randn((B + 1, 2, H, dv, dk), generator=g,
                                          device="cuda"))
        slabs = torch.arange(B, 0, -1, dtype=torch.int32, device="cuda")
        sw, yw = KS.mx_state_update(S.clone(), d, k, v, q, seed=71)
        pw = pool.clone()
        _, ysw = KS.mx_state_update(pw, d, k, v, q, seed=72, slabs=slabs,
                                    group=1)
        err = 0.0
        for tp in degrees:
            n = H // tp
            h0 = (tp - 1) * n
            hs = lambda t: t[:, h0:h0 + n].contiguous()
            args = (hs(d), hs(k), hs(v), hs(q))
            hb = dict(head_base=h0, heads_total=H)
            ss, ys = KS.mx_state_update(_shard(S, h0, n, 1), *args, seed=71,
                                        **hb)
            sp, yp = KS.plain(_shard(S, h0, n, 1), *args, seed=71, **hb)
            ps = _shard(pool, h0, n, 2)
            _, yss = KS.mx_state_update(ps, *args, seed=72, slabs=slabs,
                                        group=1, **hb)
            torch.cuda.synchronize()
            what = f"kernel 1 at {tag}'s heads {h0}..{h0 + n - 1} of {H}"
            _same_heads(ss, sw, h0, 1, what)
            _same_heads(ys, yw, h0, 1, f"{what}: y")
            _same_heads(ps, pw, h0, 2, f"{what}, slab mode")
            _same_heads(yss, ysw, h0, 1, f"{what}, slab mode: y")
            _hold_su(what, sp.payload, yp, ss.payload, ys)
            err = max(err, float((ys - yp).abs().max()))
            phase(70, f"mx_state_update head shard {tag} tp={tp}",
                  heads=f"{h0}..{h0 + n - 1} of {H}", shape=(B, n, dv, dk),
                  dense_and_slab="bitwise the whole launch's heads",
                  vs_plain="bitwise state, y within "
                  f"{float((ys - yp).abs().max()):.3g}")
            if tp == 2:
                key = f"mx_state_update[{tag},tp2]"
                out[key] = _time_su(key, (B, n, dv, dk), scalar, "dense",
                                    n=70, heads=(h0, H))
        errs[tag] = err
        del S, pool, pw
    torch.cuda.empty_cache()
    return out, errs


def _tp_mla_shards():
    """Phase 70 (a), MLA kernels 2, 3 (decode) and 5 (verify, Kq = 4) at
    deepseek's widths on the last rank's 64 and 32 of the 128 query heads
    over the whole latent (every rank reads all of it), against the whole
    launch's rows, bitwise where the kernels' 16-row blocks make them so
    (else within the decode-attention contract, rtol 2e-4, atol 2e-5, and
    said), and against the plain versions; the 64-head launches timed as
    ``phase_mla_timing`` times the whole ones: 96 layers' latent pages
    rotating cold in L2, the library yardstick SDPA on the dequantized
    latent at the rank's heads, the bound the design's own (three bf16
    tensor-core terms a product) with the fp32 one beside it."""
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
    scale = _mla_scale()
    kw = dict(scale=scale, v_width=m["dv"])
    base = [n + DS_MAX_NEW // 2 for n in DS_PROMPT_LENS[:m["B"]]]
    out, errs, bitwise = {}, {}, {}
    for n_q in (1, KQ):
        lengths = [n + n_q - 1 for n in base]
        q_all, C, bt, lens = _mla_pool(lengths, seed=170 + n_q,
                                       n_stack=n_rot, spare=0)
        q = q_all[:, :n_q].contiguous()
        dense = [R.gather_pages(C, bt, g) for g in range(n_rot)]
        if n_q == 1:
            q1 = q[:, 0].contiguous()
            calls = {
                "k2": (lambda qq, c=0: KA.mx_attention_decode(
                    qq, dense[c], None, lens, **kw),
                    lambda qq, c=0: KA.plain(qq, dense[c], None, lens, scale,
                                             m["dv"]), q1),
                "k3": (lambda qq, c=0: KP.mx_paged_attention_decode(
                    qq, C, None, bt, c, lens, **kw),
                    lambda qq, c=0: KP.plain(qq, C, None, bt, c, lens, scale,
                                             m["dv"]), q1)}
        else:
            calls = {"k5": (lambda qq, c=0: KV.mx_paged_spec_attention_decode(
                qq, C, None, bt, c, lens, **kw),
                lambda qq, c=0: KV.plain_paged(qq, C, None, bt, c, lens,
                                               scale, m["dv"]), q)}
        T = bt.shape[1] * 128
        shift = torch.arange(n_q, device="cuda") - (n_q - 1)
        mask = (torch.arange(T, device="cuda")[None, None, :]
                < (lens[:, None] + shift[None, :])[:, :, None])[:, None]
        row_pos = sum(n - (n_q - 1 - j) for n in lengths for j in range(n_q))
        cache = sum(lengths) * m["dk"] * (1 + 2 / F.MX8_GROUP)
        bt_bytes = 4 * sum(pages_for(n) for n in lengths)
        for name, (kern, plain, qq) in calls.items():
            whole = kern(qq)
            for tp in (2, 4):
                nh = m["H"] // tp
                h0 = (tp - 1) * nh
                qs = qq[..., h0:h0 + nh, :].contiguous()
                got = kern(qs)
                want = whole[..., h0:h0 + nh, :]
                pl = plain(qs)
                torch.cuda.synchronize()
                bw = torch.equal(got, want)
                if not bw:
                    torch.testing.assert_close(got, want, rtol=2e-4,
                                               atol=2e-5)
                torch.testing.assert_close(got, pl, rtol=2e-4, atol=2e-5)
                bitwise[f"{name}_tp{tp}"] = bw
                errs[f"{name}_tp{tp}"] = float((got - pl).abs().max())
                if tp != 2:
                    continue
                key = {"k2": "mx_attention_decode[mla,tp2]",
                       "k3": "mx_paged_attention_decode[mla,tp2]",
                       "k5": "mx_paged_spec_attention_decode[mla,tp2]"}[name]
                qh = (qs[:, :, None] if n_q == 1 else
                      qs.permute(0, 2, 1, 3)).contiguous()
                kfs = [F.dequantize(c)[:, :, 0][:, None] for c in dense[:8]]
                lib = [lambda k_=k_: torch.nn.functional
                       .scaled_dot_product_attention(
                           qh, k_, k_[..., :m["dv"]], attn_mask=mask,
                           scale=scale, enable_gqa=True) for k_ in kfs]
                y_lib = lib[0]()
                y_lib = y_lib[:, :, 0] if n_q == 1 else y_lib.permute(
                    0, 2, 1, 3)
                y0 = kern(qs)              # group 0: dense[0]'s pages
                torch.cuda.synchronize()
                check(bool(((y_lib - y0).abs() <= 1e-4 + 1e-3 * y0.abs())
                           .all()), f"MLA yardstick (SDPA) disagrees with "
                      f"{key}")
                kr = [lambda c=c, f=kern: f(qs, c) for c in range(n_rot)]
                extra = 0 if name == "k2" else bt_bytes
                flops = row_pos * nh * 2 * (m["dk"] + m["dv"])
                io = 4 * m["B"] * n_q * nh * (m["dk"] + m["dv"]) + 4 * m["B"]
                plan_bytes = sum(OPS.traffic(OPS.registry.plan(
                    "mla_decode" if n_q == 1 else "spec_verify",
                    dict(B=1, T=n, KVH=1, dk=m["dk"], dv=0, n=1, H=nh,
                         Kq=n_q), OPS.StateQuantConfig(), "cuda",
                    layout="dense" if name == "k2" else "paged",
                    v_width=m["dv"])).total for n in lengths)
                out[key] = _report(
                    key, graph_ms(kr, 5),
                    graph_ms([lambda c=c: plain(qs, c) for c in range(8)], 2),
                    graph_ms(lib, 5),
                    host_loop_ms(lambda k_=kr: k_[next(it) % len(k_)](), 96),
                    cache + io + extra, flops, plan_bytes, n=70,
                    tc_flops=MLA_TERMS * flops)
                del kfs, lib
        del dense, C
    phase(70, "MLA kernels at a rank's query heads (the last rank's of tp "
          "= 2 and 4: 64 and 32 of 128) over the whole latent",
          **{k: "bitwise the whole launch's rows" if v else
             "within rtol 2e-4, atol 2e-5 of the whole launch's rows"
             for k, v in bitwise.items()},
          max_abs_err_vs_plain=",".join(f"{k}={v:.3g}"
                                        for k, v in errs.items()))
    torch.cuda.empty_cache()
    return out, errs, bitwise


def _dp_append():
    """Phase 70 (a), the fused paged append on a data rank's rows: zamba2's
    K and V of a batch of 4 as two launches of 2 rows, the second with row
    base 2, bitwise the whole batch's launch in all three MX8 fields, and
    so is the plain version of each half; row base 0 is bitwise the launch
    without one.  The second half's launch is timed beside its plain
    version (kernel 4's row has the whole batch's)."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_paged_attention as KP
    KVH, w = ATTN["KVH"], ATTN["d"]
    B = 4
    b0 = B // 2
    lengths = [n_ + MAX_NEW // 2 for n_ in PROMPT_LENS[:B]]
    _, K, V, bt, lens = _paged_kv(lengths, seed=720, spare=0)
    rows = _new_rows(B, KVH, w, 2, seed=721)
    half = lambda lo, hi: [r[lo:hi].contiguous() for r in rows]
    whole = [K.clone(), V.clone()]
    KP.mx_paged_kv_append_quant(rows, whole, bt, 1, lens, 0xFFFFFFF0)
    zero = [K.clone(), V.clone()]
    KP.mx_paged_kv_append_quant(rows, zero, bt, 1, lens, 0xFFFFFFF0,
                                row_base=0)
    split, plain = [K.clone(), V.clone()], [K.clone(), V.clone()]
    for lo, hi in ((0, b0), (b0, B)):
        KP.mx_paged_kv_append_quant(half(lo, hi), split, bt[lo:hi], 1,
                                    lens[lo:hi], 0xFFFFFFF0, row_base=lo)
        KP.plain_append_quant(half(lo, hi), plain, bt[lo:hi], 1,
                              lens[lo:hi], 0xFFFFFFF0, "stochastic", 0, KVH,
                              lo)
    torch.cuda.synchronize()
    for what, got in (("two halves with their row bases", split),
                      ("row base 0", zero), ("the plain halves", plain)):
        for a, b in zip(got, whole):
            for f in ("mantissa", "exponent", "micro"):
                check(torch.equal(a.payload[f], b.payload[f]),
                      f"phase 70 (a) fused paged append, {what}: {f} "
                      "differs from the whole batch's launch")
    err = max(_payload_err(a, b) for a, b in zip(split, plain))
    mine = half(b0, B)
    Kt, Vt = K.clone(), V.clone()
    kern = [lambda l=l: KP.mx_paged_kv_append_quant(
        mine, [Kt, Vt], bt[b0:], l, lens[b0:], l, row_base=b0)
        for l in range(N_STACK)]
    plain_k = [lambda l=l: KP.plain_append_quant(
        mine, [Kt, Vt], bt[b0:], l, lens[b0:], l, "stochastic", 0, KVH, b0)
        for l in range(3)]
    n_val = 2 * (B - b0) * KVH * w
    out = _report("mx_paged_kv_append[quant,rows2..3]", graph_ms(kern, 50),
                  graph_ms(plain_k, 10), None, host_loop_ms(kern[0], 100),
                  n_val * (4 + 1 + 2 / F.MX8_GROUP) + 4 * (B - b0) * 2,
                  5 * n_val, n_val * 9 / 8, n=70)
    phase(70, "the fused paged append on a data rank's rows (row base)",
          rows=f"{b0}..{B - 1} of {B}", halves_vs_whole="bitwise",
          row_base_0_vs_none="bitwise", plain_halves_vs_whole="bitwise",
          max_abs_err_vs_plain=f"{err:.3g}")
    return out, err


def phase_tp_kernels():
    """Phase 70 (a): the head-shard launches at tp = 2 and 4: zamba2's,
    then the GLA family's, the mLSTM's and MLA's; the fused paged append
    on a data rank's rows."""
    t0 = time.perf_counter()
    res = {tp: _tp_kernels(tp) for tp in TP["degrees"]}
    res["su"] = _tp_su_shards()
    res["mla"] = _tp_mla_shards()
    res["rows"] = _dp_append()
    phase(70, "head-shard kernels", seconds=f"{time.perf_counter() - t0:.1f}")
    return res


def _tp_decode(M, p, c, par, tok, lengths, n, feed=None):
    """Model-level prefill + ``n`` decode steps (greedy, or fed ``feed``):
    (logits (n + 1, B, V), the fed tokens (n, B), step ms)."""
    import torch
    logits, caches = M.prefill(p, c, {"tokens": tok}, par=par)
    out, fed, ms = [logits], [], []
    for s in range(n):
        nxt = logits.argmax(-1) if feed is None else feed[s]
        fed.append(nxt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = M.decode_step(p, c, nxt, caches, lengths + s,
                                       seed=s + 1, par=par)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits)
    return torch.stack(out), torch.stack(fed), ms


def tp_worker(rank, world, init, out):
    """One rank of phase 70 (b), in its own process: a gloo group of
    ``world`` ranks on the one card (NCCL refuses two ranks on one card;
    gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``)."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _watch_plain_quantizer()
    from repro_torch import ops as OPS
    from repro_torch.core import tree as T
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.tp import tp_sum
    from repro_torch.launch.mesh import make_local_parallel
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    from repro_torch.serving.memory.layout import CachePaging
    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    res = {}
    try:
        par = make_local_parallel(1, world, device_type="cuda")
        # the forward path's one collective on CUDA tensors, first
        x = torch.full((3,), float(rank + 1), device="cuda")
        y = tp_sum(x, par)
        check(y.is_cuda and torch.equal(y, torch.full_like(
            x, world * (world + 1) / 2)), f"gloo's all_reduce of a CUDA "
            f"tensor gave {y}")
        cfg, params, _ = _model()
        g = torch.Generator(device="cuda").manual_seed(70)
        B, S = TP["B"], TP["S"]
        tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                            device="cuda")
        lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
        res["setup_s"] = time.perf_counter() - t_start
        for tag, sq in (("fp32", OPS.StateQuantConfig("fp32", "nearest",
                                                      "torch")),
                        ("sr", cfg.state_quant)):
            c = cfg.with_(state_quant=sq)
            n = TP["steps"] if tag == "fp32" else TP["sr_steps"]
            feed = torch.zeros((n, B), dtype=torch.int64, device="cuda")
            if rank == 0:                      # tp = 1 in rank 0's process
                ref, fed, ms1 = _tp_decode(M, params, c, None, tok, lengths,
                                           n)
                feed.copy_(fed)
                res[f"{tag}_tp1_step_ms"] = ms1
            dist.broadcast(feed, src=0)
            p = SH.tp_params(params, c, par)
            PLAIN_QUANT["calls"] = 0
            _counts_reset()
            got, _, ms = _tp_decode(M, p, c, par, tok, lengths, n, feed)
            res[f"{tag}_counts"] = {k: v for k, v in _counts().items() if v}
            res[f"{tag}_plain_quant"] = PLAIN_QUANT["calls"]
            res[f"{tag}_step_ms"] = ms
            np.save(Path(out) / f"rank{rank}_{tag}.npy", got.cpu().numpy())
            if rank == 0:
                res[f"{tag}_max_dlogit"] = float((got - ref).abs().max())
                res[f"{tag}_agree"] = float(
                    (got.argmax(-1) == ref.argmax(-1)).float().mean())
                res[f"{tag}_finite"] = bool(torch.isfinite(got).all())
            del p
        # the paged engine at the config's MX8 SR
        rng = np.random.default_rng(70)
        prompts = [rng.integers(0, cfg.vocab_size, n_)
                   for n_ in TP["prompts"]]
        eng = Engine(params, cfg, ServeConfig(**TP["paged"]), par=par)
        pool = eng.engine.pool
        steps = []
        decode = pool.decode
        pool.decode = lambda *a, **k: steps.append(1) or decode(*a, **k)
        PLAIN_QUANT["calls"] = 0
        _counts_reset()
        t0 = time.perf_counter()
        hs = [eng.submit(pr, max_new_tokens=TP["max_new"]) for pr in prompts]
        eng.run()
        torch.cuda.synchronize()
        res["engine_s"] = time.perf_counter() - t0
        res["engine_counts"] = {k: v for k, v in _counts().items() if v}
        res["engine_plain_quant"] = PLAIN_QUANT["calls"]
        res["engine_steps"] = len(steps)
        res["engine_tokens"] = [list(map(int, h.result().output)) for h in hs]
        res["engine_status"] = [h.status for h in hs]
        st = eng.stats()
        res["engine_p50_step_ms"] = st["p50_step_s"] * 1e3
        res["engine_tokens_per_s"] = st["tokens_per_s"]
        whole = CachePaging(M.init_decode_caches(cfg, 1, 128, device="meta"))
        nbytes = lambda tree: sum(t.numel() * t.element_size()
                                  for t in T.leaves(tree))
        res["bytes"] = dict(
            weights=nbytes(eng.engine.params), weights_tp1=nbytes(params),
            page=pool.paging.page_nbytes, page_tp1=whole.page_nbytes,
            slab=pool.paging.slab_nbytes, slab_tp1=whole.slab_nbytes,
            pool=sum(t.numel() * t.element_size() for t in pool.pools),
            pool_tp1=(pool.n_pages * whole.page_nbytes
                      + pool.n_slabs * whole.slab_nbytes))
        res["heads"] = dict(
            state=[int(t.shape[2]) for t, s in zip(pool.pools,
                                                   pool.paging.specs)
                   if s.kind == "slab" and t.dim() == 5][:1],
            kv=[int(t.shape[3]) for t, s in zip(pool.pools,
                                                pool.paging.specs)
                if s.kind == "page"][:1])
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
        for arch, layers, _ in TP_NEW:
            res[arch] = _tp_new_model(rank, par, out, arch, layers)
        res["dp"] = _dp_engines(rank, world)
        res["seconds"] = time.perf_counter() - t_start
    finally:
        dist.destroy_process_group()
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def _tp_new_model(rank, par, out, arch, layers):
    """One of TP_NEW in a phase 70 (b) worker: the model-level runs against
    tp = 1 (rank 0 runs tp = 1, and at MX8 SR the one-ulp control
    too), a rank's launches, bytes and logits (saved for the
    parent); deepseek then through the paged engine, without and with
    n-gram speculation, its latent pool's digest."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import ops as OPS
    from repro_torch.core import tree as T
    from repro_torch.dist import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    from repro_torch.serving.memory.layout import CachePaging
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in T.leaves(tree))
    t0 = time.perf_counter()
    cfg, params, _ = _model_at(arch, layers)
    B, S, n = TP["B"], TP["S"], TP_NEW_STEPS
    g = torch.Generator(device="cuda").manual_seed(71)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")
    lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
    r = {}
    for tag, sq in (("fp32", OPS.StateQuantConfig("fp32", "nearest",
                                                  "torch")),
                    ("sr", cfg.state_quant)):
        c = cfg.with_(state_quant=sq)
        feed = torch.zeros((n, B), dtype=torch.int64, device="cuda")
        if rank == 0:
            ref, fed, ms1 = _tp_decode(M, params, c, None, tok, lengths, n)
            feed.copy_(fed)
            r[f"{tag}_tp1_step_ms"] = ms1
            if tag == "sr":
                with _first_update_one_ulp_up(attention="mla" in c.pattern):
                    ctl, _, _ = _tp_decode(M, params, c, None, tok, lengths,
                                           n, feed)
                r["sr_control"] = float((ctl - ref).abs().max())
        dist.broadcast(feed, src=0)
        p = SH.tp_params(params, c, par)
        PLAIN_QUANT["calls"] = 0
        _counts_reset()
        got, _, ms = _tp_decode(M, p, c, par, tok, lengths, n, feed)
        r[f"{tag}_counts"] = {k: v for k, v in _counts().items() if v}
        r[f"{tag}_plain_quant"] = PLAIN_QUANT["calls"]
        r[f"{tag}_step_ms"] = ms
        np.save(Path(out) / f"rank{rank}_{arch}_{tag}.npy", got.cpu().numpy())
        if rank == 0 and tag == "sr" and arch == "gla-2.7b":
            # tp = 1 with each row-parallel sum cut and added as the two
            # ranks add it: the drift's cause, if bitwise
            from repro_torch.dist.emulate import split_sums
            with split_sums(params, c, par.tp) as emulated:
                emu, _, _ = _tp_decode(M, emulated, c, None, tok, lengths, n,
                                       feed)
            de = (got - emu).abs().flatten(1).amax(1)
            r["sr_emulation_by_step"] = [float(x) for x in de]
            r["sr_emulation_bitwise"] = bool(torch.equal(got, emu))
            del emu
        if rank == 0:
            d = (got - ref).abs().flatten(1).amax(1)
            r[f"{tag}_dlogit_by_step"] = [float(x) for x in d]
            r[f"{tag}_max_dlogit"] = float(d.max())
            r[f"{tag}_agree"] = float(
                (got.argmax(-1) == ref.argmax(-1)).float().mean())
            r[f"{tag}_finite"] = bool(torch.isfinite(got).all())
        if tag == "sr":
            r["bytes"] = dict(weights=nbytes(p), weights_tp1=nbytes(params),
                              layers=nbytes([p.get("prelude", []),
                                             p["groups"]]),
                              layers_tp1=nbytes([params.get("prelude", []),
                                                 params["groups"]]))
        del p
    whole = CachePaging(M.init_decode_caches(cfg, 1, 128, device="meta"))
    mine = CachePaging(M.init_decode_caches(cfg, 1, 128, device="meta",
                                            par=par))
    r["bytes"].update(slab=mine.slab_nbytes, slab_tp1=whole.slab_nbytes,
                      page=mine.page_nbytes, page_tp1=whole.page_nbytes)
    if arch == "deepseek-v2-236b":
        rng = np.random.default_rng(3)
        prompts = [np.resize(rng.integers(0, cfg.vocab_size, 8), k)
                   for k in TP_DS_ENGINE["prompts"]]
        L = cfg.n_layers
        for name, kw, want in (
                ("paged", {}, dict(k3=L, k4q_mla=L)),
                ("spec", dict(spec="ngram", spec_k=SPEC_K),
                 dict(k5=L, k4q_mla=L * KQ))):
            eng = Engine(params, cfg, ServeConfig(**DS_PAGED, **kw), par=par)
            run = _serve_counted(eng, cfg, prompts, TP_DS_ENGINE["max_new"],
                                 want, _k7_per_prefill(cfg),
                                 f"phase 70 rank {rank} deepseek {name}")
            pool = eng.engine.pool
            h = hashlib.sha256()
            for t, sp in zip(pool.pools, pool.paging.specs):
                if sp.kind == "page":
                    h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                             .tobytes())
            r[f"engine_{name}"] = dict(
                n={k: v for k, v in run["n"].items() if v},
                steps=run["steps"], wall=run["wall"],
                outputs=[list(map(int, o)) for o in run["outputs"]],
                latent_sha=h.hexdigest(),
                p50_step_ms=run["stats"]["p50_step_s"] * 1e3)
            del eng, pool
    del params
    gc.collect()
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t0
    return r


def _dp_engines(rank, world):
    """Phase 70 (b)'s data axes in a worker: the two ranks as a (2, 1)
    mesh serve zamba2 through the slot and the paged engine (DP), each
    rank its 2 of the 4 decode rows, at fp32 state and at MX8 SR, every
    launch counter reset just before a run and read just after; then rank
    0 serves the same requests on one process, the tokens and the live
    rows' sampled logits to compare, and at MX8 SR once more with the one-ulp control
    (:func:`_first_update_one_ulp_up`), what a wrong SR row would move."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import ops as OPS
    from repro_torch.core import tree as T
    from repro_torch.launch.mesh import make_local_parallel
    from repro_torch.serving import engine as SE
    from repro_torch.serving.api import Engine, ServeConfig
    t0 = time.perf_counter()
    par = make_local_parallel(world, 1, device_type="cuda")
    cfg, params, _ = _model()
    rng = np.random.default_rng(72)
    prompts = [rng.integers(0, cfg.vocab_size, n_) for n_ in DP["prompts"]]
    r = {}
    for tag, sq in (("fp32", OPS.StateQuantConfig("fp32", "nearest",
                                                  "torch")),
                    ("sr", cfg.state_quant)):
        c = cfg.with_(state_quant=sq)
        for name in ("slots", "paged"):
            runs = [("dp", par)] + ([("one", None)] if rank == 0 else [])
            if rank == 0 and tag == "sr":
                runs.append(("ctl", None))
            seen = {}
            for who, pr in runs:
                eng = Engine(params, c, ServeConfig(**DP[name]), par=pr)
                PLAIN_QUANT["calls"] = 0
                _counts_reset()
                seen[who], real = [], SE.sample

                def recording(lg, *a, _s=seen[who], _c=eng.engine, **k):
                    x = lg.detach().float().cpu()
                    if x.shape[0] == DP[name]["batch"]:   # live rows only
                        x = x[torch.as_tensor(np.asarray(
                            _c.active if _c.backend == "slots"
                            else [r is not None for r in _c.rows], bool))]
                    _s.append(x)
                    return real(lg, *a, **k)
                SE.sample = recording
                ctl = (_first_update_one_ulp_up() if who == "ctl"
                       else contextlib.nullcontext())
                t1 = time.perf_counter()
                try:
                    with ctl:
                        hs = [eng.submit(p, max_new_tokens=DP["max_new"])
                              for p in prompts]
                        eng.run()
                finally:
                    SE.sample = real
                torch.cuda.synchronize()
                key = f"{name}_{tag}_{who}"
                st = eng.stats()
                held = (eng.engine.caches if name == "slots"
                        else eng.engine.pool.pools)
                r[key] = dict(
                    tokens=[list(map(int, h.result().output)) for h in hs],
                    status=[h.status for h in hs],
                    counts={k: v for k, v in _counts().items() if v},
                    plain_quant=PLAIN_QUANT["calls"],
                    steps=eng.engine.step_count,
                    wall=time.perf_counter() - t1,
                    moves=st.get("dp_moves", 0.0),
                    move_bytes=st.get("dp_move_bytes", 0.0),
                    preemptions=st.get("preemptions", 0.0),
                    bytes=sum(t.numel() * t.element_size()
                              for t in T.leaves(held)))
                del eng, held
                gc.collect()
            if rank == 0:       # max |dlogit| of each run from one process's
                for who in seen:
                    a, b = seen[who], seen["one"]
                    r[f"{name}_{tag}_{who}"]["dlogit"] = (
                        max(float((x - y).abs().max()) for x, y in zip(a, b))
                        if [x.shape for x in a] == [y.shape for y in b]
                        else math.inf)
            dist.barrier()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t0
    return r


def _dp_checks(rs):
    """Phase 70 (b)'s checks of the (2, 1) runs: every request done with
    its tokens; both ranks the same tokens, the one-process engine's; at
    MX8 SR the sampled logits within ``CONTROL_FACTOR`` times what the
    one-ulp control moves them from one process's; each rank's launches a
    step as one process's, no plain quantizer; the paged run preempted and
    moved pages between the ranks; a rank's slot caches half of one
    process's."""
    n_su, n_at = _zamba2_launches(_model_cfg())
    r0 = rs[0]
    for tag in ("fp32", "sr"):
        for name in ("slots", "paged"):
            key = f"{name}_{tag}"
            d0, d1, one = r0[key + "_dp"], rs[1][key + "_dp"], r0[key + "_one"]
            for d in (d0, d1, one):
                check(all(x == "done" for x in d["status"])
                      and all(len(t) == DP["max_new"] for t in d["tokens"])
                      and d["plain_quant"] == 0,
                      f"phase 70 (2, 1) {key}: {d['status']}, plain "
                      f"quantizer {d['plain_quant']}")
            ctl = r0[key + "_ctl"]["dlogit"] if tag == "sr" else None
            agree = float(sum(a == b for x, y in zip(
                d0["tokens"], one["tokens"]) for a, b in zip(x, y))
                / sum(len(x) for x in one["tokens"]))
            phase(70, f"data-parallel zamba2-2.7b {name} engine, (2, 1) "
                  f"mesh, {tag}", layers=ZAMBA2_LAYERS,
                  requests=len(DP["prompts"]), max_new=DP["max_new"],
                  steps=d0["steps"], token_agreement_with_one_process=(
                      f"{agree:.3f}"),
                  max_dlogit_vs_one_process=f"{d0['dlogit']:.3g}",
                  one_ulp_control=("n/a" if ctl is None
                                   else f"{ctl:.3g}"),
                  preemptions=int(d0["preemptions"]),
                  dp_moves=int(d0["moves"]),
                  dp_move_bytes=int(d0["move_bytes"]),
                  rank_bytes=d0["bytes"], one_process_bytes=one["bytes"],
                  launches_per_rank=",".join(f"{k}={v}" for k, v in
                                             d0["counts"].items()),
                  wall_s=f"{d0['wall']:.2f}",
                  one_process_wall_s=f"{one['wall']:.2f}")
            check(d0["tokens"] == d1["tokens"], f"phase 70 (2, 1) {key}: "
                  "the data ranks sampled other tokens")
            check(d0["tokens"] == one["tokens"], f"phase 70 (2, 1) "
                  f"{key}: tokens differ from one process's")
            if tag == "sr":
                check(d0["dlogit"] <= CONTROL_FACTOR * ctl,
                      f"phase 70 (2, 1) {key}: |dlogit| {d0['dlogit']:.3g} "
                      f"from one process, above {CONTROL_FACTOR} x the "
                      f"one-ulp control's {ctl:.3g}")
                n = d0["steps"]
                want = (dict(k1=n_su * n, k2_gqa=n_at * n, apd=n_at * n)
                        if name == "slots" else
                        dict(k1s=n_su * n, k3_gqa=n_at * n, k4q=n_at * n))
                for d in (d0, d1):
                    got = {k: d["counts"].get(k, 0) for k in want}
                    check(got == want, f"phase 70 (2, 1) {key}: launches "
                          f"{d['counts']} over {n} steps (want {want})")
    check(r0["paged_sr_dp"]["preemptions"] >= 1
          and r0["paged_sr_dp"]["moves"] > 0,
          f"phase 70 (2, 1): the paged run preempted "
          f"{r0['paged_sr_dp']['preemptions']} and moved "
          f"{r0['paged_sr_dp']['moves']} pages")
    check(r0["slots_sr_dp"]["bytes"] * 2 == r0["slots_sr_one"]["bytes"],
          f"phase 70 (2, 1): a rank's slot caches "
          f"{r0['slots_sr_dp']['bytes']} of {r0['slots_sr_one']['bytes']}")


def _run_ranks(flag, world, tmp, timeout_s, n):
    """``world`` processes of this script (``flag RANK WORLD INIT TMP``)
    sharing the card over gloo, waited for (all ended at the first that
    fails, or at ``timeout_s``): what each wrote to ``TMP/rank{r}.json``.
    A rank that failed fails phase ``n``."""
    from repro_torch.launch.mesh import local_init_method
    init = local_init_method()
    logs = [open(Path(tmp) / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(r),
         str(world), init, tmp], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    while any(p.poll() is None for p in procs) \
            and time.monotonic() < deadline \
            and not any(p.poll() for p in procs):
        time.sleep(0.2)
    for p, log in zip(procs, logs):
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    for r, p in enumerate(procs):
        text = (Path(tmp) / f"rank{r}.log").read_text()
        check(p.returncode == 0, f"phase {n} rank {r} exited "
              f"{p.returncode}:\n{text[-3000:]}")
    return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
            for r in range(world)]


def phase_tp_serve():
    """Phase 70 (b): two ranks on the card, each in its own process
    (:func:`tp_worker`), serve zamba2-2.7b tensor-parallel, then TP_NEW's
    models; this process checks what they wrote."""
    import tempfile
    import numpy as np
    t0 = time.perf_counter()
    world = TP["ranks"]
    with tempfile.TemporaryDirectory() as tmp:
        res = _run_ranks("--tp-worker", world, tmp, TP["timeout_s"], 70)
        for tag in ("fp32", "sr"):
            a, b = (np.load(Path(tmp) / f"rank{r}_{tag}.npy")
                    for r in range(2))
            check(np.array_equal(a, b), f"phase 70: the ranks' {tag} "
                  "logits differ")
            for arch, _, _ in TP_NEW:
                a, b = (np.load(Path(tmp) / f"rank{r}_{arch}_{tag}.npy")
                        for r in range(2))
                check(np.array_equal(a, b), f"phase 70: the ranks' {arch} "
                      f"{tag} logits differ")
    r0 = res[0]
    cfg_steps = TP["steps"]
    n_su, n_at = _zamba2_launches(_model_cfg())
    check(r0["fp32_max_dlogit"] <= 1e-3 and r0["fp32_agree"] == 1.0
          and r0["fp32_finite"], f"phase 70 fp32 state: |dlogit| "
          f"{r0['fp32_max_dlogit']:.3g}, agreement {r0['fp32_agree']}")
    check(r0["sr_max_dlogit"] < 1e-2 and r0["sr_finite"],
          f"phase 70 MX8 SR: |dlogit| {r0['sr_max_dlogit']:.3g}")
    for r in res:
        c = r["sr_counts"]
        check(c.get("k1") == n_su * TP["sr_steps"]
              and c.get("k2_gqa") == n_at * TP["sr_steps"]
              and c.get("apd") == n_at * TP["sr_steps"]
              and r["sr_plain_quant"] == 0,
              f"phase 70 model-level launches {c}, plain quantizer "
              f"{r['sr_plain_quant']}")
        e, n = r["engine_counts"], r["engine_steps"]
        check(e.get("k1s") == n_su * n and e.get("k3_gqa") == n_at * n
              and e.get("k4q") == n_at * n and e.get("k7", 0) > 0
              and r["engine_plain_quant"] == 0,
              f"phase 70 engine launches {e} over {n} steps, plain "
              f"quantizer {r['engine_plain_quant']}")
        check(r["heads"] == dict(state=[40], kv=[16]), f"phase 70 a rank's "
              f"heads {r['heads']}")
        check(all(s == "done" for s in r["engine_status"])
              and all(len(t) == TP["max_new"] for t in r["engine_tokens"]),
              f"phase 70 engine requests {r['engine_status']}")
    check(res[0]["engine_tokens"] == res[1]["engine_tokens"],
          "phase 70: the ranks' engines sampled other tokens")
    by = r0["bytes"]
    phase(70, "tensor-parallel zamba2-2.7b, two ranks on one card over gloo "
          "(all_reduce on CUDA tensors), model level",
          layers=ZAMBA2_LAYERS, prompts=f"{TP['B']}x{TP['S']}",
          fp32_steps=cfg_steps,
          fp32_max_dlogit_vs_tp1=f"{r0['fp32_max_dlogit']:.3g}",
          fp32_greedy_agreement=r0["fp32_agree"],
          sr_steps=TP["sr_steps"],
          sr_max_dlogit_vs_tp1=f"{r0['sr_max_dlogit']:.3g}",
          sr_greedy_agreement=r0["sr_agree"],
          logits_across_ranks="bitwise",
          launches_per_rank=",".join(f"{k}={v}" for k, v in
                                     r0["sr_counts"].items()),
          plain_quantizer_calls=0)
    phase(70, "step times (two ranks sharing one card over gloo, whose "
          "CUDA all-reduce goes through the host: not a tensor-parallel "
          "speed figure)",
          fp32_tp1_step_ms=f"{np.median(r0['fp32_tp1_step_ms']):.2f}",
          fp32_tp2_step_ms=f"{np.median(r0['fp32_step_ms']):.2f}",
          sr_tp1_step_ms=f"{np.median(r0['sr_tp1_step_ms']):.2f}",
          sr_tp2_step_ms=f"{np.median(r0['sr_step_ms']):.2f}",
          engine_p50_step_ms=f"{r0['engine_p50_step_ms']:.2f}",
          engine_tokens_per_s=f"{r0['engine_tokens_per_s']:.2f}")
    phase(70, "tensor-parallel paged engine", requests=len(TP["prompts"]),
          max_new=TP["max_new"], decode_steps=r0["engine_steps"],
          launches_per_rank=",".join(f"{k}={v}" for k, v in
                                     r0["engine_counts"].items()),
          state_heads_a_rank=40, kv_heads_a_rank=16,
          tokens_across_ranks="equal", plain_quantizer_calls=0,
          engine_s=f"{r0['engine_s']:.1f}")
    phase(70, "a rank's bytes against tp = 1",
          weights_GB=f"{by['weights'] / 1e9:.3f}",
          weights_tp1_GB=f"{by['weights_tp1'] / 1e9:.3f}",
          page_bytes=by["page"], page_tp1_bytes=by["page_tp1"],
          slab_bytes=by["slab"], slab_tp1_bytes=by["slab_tp1"],
          pool_GB=f"{by['pool'] / 1e9:.4f}",
          pool_tp1_GB=f"{by['pool_tp1'] / 1e9:.4f}")
    for arch, layers, cut in TP_NEW:
        _tp_new_checks(arch, layers, cut, [r[arch] for r in res])
    _dp_checks([r["dp"] for r in res])
    phase(70, "tensor-parallel serving", seconds=f"{time.perf_counter() - t0:.1f}",
          rank_seconds=",".join(f"{r['seconds']:.1f}" for r in res),
          rank_setup_s=",".join(f"{r['setup_s']:.1f}" for r in res))
    return r0


def _tp_new_checks(arch, layers, cut, rs):
    """Phase 70 (b)'s checks of one TP_NEW model, on what the two workers
    wrote: fp32 state within 1e-3 of tp = 1 with every greedy token equal;
    MX8 SR: gla bitwise tp = 1 under the split-sum emulation
    (``dist.emulate.split_sums``: its products summed in the ranks'
    order) at every step; the others within 1e-2, or within
    CONTROL_FACTOR times what moving one ``y`` of layer 0's first decode
    step one ulp does at tp = 1 (the control of
    ``_reference_check_by_depth``): the row-parallel sums differ from tp =
    1's in the last bits, and at full width a last-bit difference flips
    some MX8 roundings of the millions of state values a layer, which the
    layers above amplify; each model-level step's launches (kernel 1 a
    split layer, MLA's kernel 2 and latent append a layer, kernel 7 a
    prefilled layer) and no plain quantizer; a rank's bytes; deepseek's
    engines: launches a step, the same tokens and latent pool bits on both
    ranks."""
    import numpy as np
    from repro_torch.configs import get_config
    cfg = get_config(arch).with_(n_layers=layers)
    r0 = rs[0]
    n = TP_NEW_STEPS
    per = (lambda kinds: sum(cfg.pattern.count(k) for k in kinds)
           * cfg.n_groups + sum(cfg.prelude.count(k) for k in kinds))
    n_su = per(("gla", "retnet", "hgrn2", "mlstm"))
    n_mla = per(("mla",))
    want = {k: v for k, v in dict(k1=n_su * n, k2=n_mla * n,
                                  apd_mla=n_mla * n,
                                  k7=_k7_per_prefill(cfg)).items() if v}
    check(r0["fp32_max_dlogit"] <= 1e-3 and r0["fp32_agree"] == 1.0
          and r0["fp32_finite"], f"phase 70 {arch} fp32 state: |dlogit| "
          f"{r0['fp32_max_dlogit']:.3g}, agreement {r0['fp32_agree']}")
    if "sr_emulation_bitwise" in r0:
        # gla: the ranks' logits are tp = 1's with the products' sums in
        # the ranks' order (dist.emulate.split_sums), bitwise at every step:
        # their drift from tp = 1 is that order, not an SR counter
        check(r0["sr_emulation_bitwise"] and r0["sr_finite"],
              f"phase 70 {arch} MX8 SR: the ranks' logits differ from the "
              f"split-sum emulation by {r0['sr_emulation_by_step']} a step")
    else:
        sr_bound = max(1e-2, CONTROL_FACTOR * r0["sr_control"])
        check(r0["sr_max_dlogit"] < sr_bound and r0["sr_finite"],
              f"phase 70 {arch} MX8 SR: |dlogit| {r0['sr_max_dlogit']:.3g}"
              f" (bound {sr_bound:.3g})")
    for r in rs:
        check(r["sr_counts"] == want and r["sr_plain_quant"] == 0
              and not r["fp32_counts"], f"phase 70 {arch} launches "
              f"{r['sr_counts']} (want {want}), at fp32 {r['fp32_counts']}, "
              f"plain quantizer {r['sr_plain_quant']}")
    by = r0["bytes"]
    layer_share = by["layers"] / by["layers_tp1"]
    check(by["slab"] * 2 == by["slab_tp1"] if arch == "gla-2.7b"
          else by["slab"] < by["slab_tp1"] or by["slab_tp1"] == 0,
          f"phase 70 {arch}: a rank's slab {by['slab']} of {by['slab_tp1']}")
    check(by["page"] == by["page_tp1"], f"phase 70 {arch}: a rank's page "
          f"{by['page']} of {by['page_tp1']} (the latent is whole)")
    if arch == "gla-2.7b":
        check(0.49 <= layer_share <= 0.52, f"phase 70 gla: a rank's layer "
              f"weights {layer_share:.3f} of the whole")
    phase(70, f"tensor-parallel {arch}, two ranks, model level",
          reduced=repr(cut), prompts=f"{TP['B']}x{TP['S']}", steps=n,
          fp32_max_dlogit_vs_tp1=f"{r0['fp32_max_dlogit']:.3g}",
          fp32_greedy_agreement=r0["fp32_agree"],
          sr_dlogit_vs_tp1_by_step=",".join(
              f"{x:.3g}" for x in r0["sr_dlogit_by_step"]),
          sr_greedy_agreement=r0["sr_agree"],
          sr_one_ulp_control=f"{r0['sr_control']:.3g}",
          **({"sr_vs_split_sum_emulation_by_step": ",".join(
              f"{x:.3g}" for x in r0["sr_emulation_by_step"])}
             if "sr_emulation_by_step" in r0 else {}),
          logits_across_ranks="bitwise",
          launches_per_rank=",".join(f"{k}={v}" for k, v in
                                     r0["sr_counts"].items()),
          plain_quantizer_calls=0,
          sr_tp1_step_ms=f"{np.median(r0['sr_tp1_step_ms']):.2f}",
          sr_tp2_step_ms=f"{np.median(r0['sr_step_ms']):.2f}",
          seconds=",".join(f"{r['seconds']:.1f}" for r in rs))
    phase(70, f"{arch}: a rank's bytes against tp = 1",
          weights_GB=f"{by['weights'] / 1e9:.3f}",
          weights_tp1_GB=f"{by['weights_tp1'] / 1e9:.3f}",
          layer_weights_share=f"{layer_share:.4f}",
          slab_bytes=by["slab"], slab_tp1_bytes=by["slab_tp1"],
          page_bytes=by["page"], page_tp1_bytes=by["page_tp1"])
    for name in ("paged", "spec"):
        if f"engine_{name}" not in r0:
            continue
        e0, e1 = (r[f"engine_{name}"] for r in rs)
        check(e0["outputs"] == e1["outputs"]
              and e0["latent_sha"] == e1["latent_sha"] and e0["n"] == e1["n"],
              f"phase 70 {arch} {name} engine: the ranks differ")
        phase(70, f"tensor-parallel {arch} paged engine"
              + (" + n-gram speculation" if name == "spec" else ""),
              requests=len(TP_DS_ENGINE["prompts"]),
              max_new=TP_DS_ENGINE["max_new"], steps=e0["steps"],
              launches_per_rank=",".join(f"{k}={v}" for k, v in
                                         e0["n"].items()),
              tokens_across_ranks="equal", latent_pages_across_ranks="bitwise",
              p50_step_ms=f"{e0['p50_step_ms']:.2f}",
              wall_s=f"{e0['wall']:.2f}")


def _model_cfg():
    from repro_torch.configs import get_config
    return get_config("zamba2-2.7b").with_(n_layers=ZAMBA2_LAYERS)


# ---------------------------------------------------------------------------
# phase 71: training under tensor parallelism
# ---------------------------------------------------------------------------

#: phase 71: zamba2-2.7b at full width, ``layers`` deep (one group of six
#: Mamba-2 layers and one shared-block application), trained at (1, 2) by
#: two ranks sharing the card over gloo: ``batch`` rows of ``seq_len``
#: tokens, a step, then a step of ``grad_accum=2``, remat and sequence
#: parallelism on (the config's), against tp = 1 in rank 0's process.
#: Tolerances: the losses to ``loss_rtol``; each parameter after the two
#: steps within ``param_atol`` of tp = 1's (2.42e-6 measured on the card:
#: AdamW moves a weight by up to lr a step, so a bound near lr would pass
#: any gradient, while a rank's partial gradient in the ``grad_accum=2``
#: step moves the second update by a fair share of lr); the first step's
#: gradients of ``wbc`` (whole on each rank, a Megatron f after its B / C
#: stream) and of the shared attention's ``wq`` (cut) within ``grad_rel``
#: of tp = 1's largest entry -- a rank's partial gradient would be off by
#: about half
TP_TRAIN = dict(ranks=2, layers=6, cut="n_layers 54 -> 6", batch=2,
                seq_len=512, lr=1e-3, loss_rtol=1e-4, param_atol=1e-4,
                grad_rel=1e-3, timeout_s=300)


def _tp_train_leaves(tree):
    """The paths of the leaves phase 71 holds the gradients of."""
    from repro_torch.core import tree as T
    paths = ["/".join(map(str, p)) for p, _ in T.leaves_with_paths(tree)]
    return {"wbc": paths.index("groups/0/0/mixer/wbc"),
            "shared_wq": paths.index("shared/attn/wq")}


def _whole(x, par):
    """A DTensor leaf at rest in the training layout, put together on every
    rank with the model axis's c10d all-gather (gloo's functional
    all-gather of a CUDA tensor crashes; no data axis at (1, 2))."""
    from repro_torch.dist.sharding import Shard
    from repro_torch.dist.tp import model_gather
    t = x.to_local()
    for pl in x.placements:
        if isinstance(pl, Shard):
            t = model_gather(t, pl.dim, par)
    return t


def tp_train_worker(rank, world, init, out):
    """One rank of phase 71, in its own process: a gloo group of
    ``world`` ranks on the one card, the (1, world) mesh's train steps,
    then (rank 0) tp = 1 from the same seed; writes its numbers, and rank
    0 the comparison, to ``out``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_local_parallel
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import (make_train_step,
                                              sharded_loss_and_grads,
                                              _loss_and_grads,
                                              batch_to_device)
    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    w = TP_TRAIN
    res = {}
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in T.leaves(tree))
    try:
        par = make_local_parallel(1, world, device_type="cuda")
        cfg, params, _ = _model_at("zamba2-2.7b", w["layers"])
        check(cfg.seq_parallel and cfg.remat and cfg.n_groups == 1
              and cfg.shared_attn, f"phase 71: unexpected {cfg.name}")
        opt = O.OptimizerConfig(lr=w["lr"])
        batch_fn = make_batch_fn(cfg, w["seq_len"], w["batch"])
        which = _tp_train_leaves(params)
        res["bytes_tp1"] = nbytes(params)
        lay = SH.param_shardings(params, cfg, par)
        ps = SH.distribute(params, lay)
        st = O.init_opt_state(params, opt)
        st = SH.distribute(st, SH.opt_state_shardings(st, lay, par))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        res["bytes_cut"] = nbytes(SH.cut_params(ps, cfg, par))
        res["setup_s"] = time.perf_counter() - t_start
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _counts_reset()
        _, grads = sharded_loss_and_grads(ps, cfg, batch_fn(0), par)
        leaves = T.leaves(ps)
        g_tp = {k: _whole(SH.like([T.leaves(grads)[i]], [leaves[i]])[0],
                          par) for k, i in which.items()}
        del grads
        losses, ms = [], []
        for i, ga in enumerate((1, 2)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ps, st, m = make_train_step(cfg, opt, par=par, grad_accum=ga)(
                ps, st, batch_fn(i))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        res["launches"] = {k: v for k, v in _counts().items() if v}
        res["losses"], res["step_ms"] = losses, ms
        final = [_whole(x, par) for x in T.leaves(ps)]
        del ps, st
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:                   # tp = 1 from the same seed
            cfg1, params, _ = _model_at("zamba2-2.7b", w["layers"])
            st1 = O.init_opt_state(params, opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, g1 = _loss_and_grads(params, cfg1, batch_to_device(
                batch_fn(0), "cuda"))
            g1 = T.leaves(g1)
            res["grad_rel"] = {
                k: float((g_tp[k] - g1[i]).abs().max()
                         / g1[i].abs().max()) for k, i in which.items()}
            del g1
            step = {ga: make_train_step(cfg1, opt, grad_accum=ga)
                    for ga in (1, 2)}
            l1, ms1 = [], []
            for i, ga in enumerate((1, 2)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, st1, m = step[ga](params, st1, batch_fn(i))
                l1.append(float(m["loss"]))
                torch.cuda.synchronize()
                ms1.append((time.perf_counter() - t0) * 1e3)
            res["peak_GB_tp1"] = torch.cuda.max_memory_allocated() / 1e9
            res["losses_tp1"], res["step_ms_tp1"] = l1, ms1
            res["param_max_abs"] = max(float((a - b).abs().max()) for a, b
                                       in zip(final, T.leaves(params)))
            res["param_max_rel"] = max(
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip(final, T.leaves(params)))
            res["finite"] = all(bool(torch.isfinite(a).all())
                                for a in final)
        res["seconds"] = time.perf_counter() - t_start
    finally:
        dist.destroy_process_group()
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def phase_tp_train():
    """Phase 71: two ranks on the card (:func:`tp_train_worker`) train
    zamba2-2.7b at (1, 2); this process checks what they wrote."""
    import tempfile
    t0 = time.perf_counter()
    w = TP_TRAIN
    with tempfile.TemporaryDirectory() as tmp:
        res = _run_ranks("--tp-train-worker", w["ranks"], tmp,
                         w["timeout_s"], 71)
    r0 = res[0]
    for r in res:
        check(r["losses"] == r0["losses"], f"phase 71: the ranks' losses "
              f"{[x['losses'] for x in res]} differ")
        check(not r["launches"], f"phase 71: the training steps launched "
              f"kernels: {r['launches']}")
        check(r["bytes_cut"] < r["bytes_tp1"], f"phase 71: a rank computes "
              f"with {r['bytes_cut']} parameter bytes of {r['bytes_tp1']}")
    dl = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                              r0["losses_tp1"])]
    check(all(math.isfinite(v) for v in r0["losses"]) and r0["finite"]
          and max(dl) <= w["loss_rtol"], f"phase 71: losses "
          f"{r0['losses']} against tp = 1's {r0['losses_tp1']}")
    check(r0["param_max_abs"] <= w["param_atol"], f"phase 71: parameters "
          f"{r0['param_max_abs']:.3g} from tp = 1's")
    check(max(r0["grad_rel"].values()) <= w["grad_rel"], f"phase 71: "
          f"gradients {r0['grad_rel']} from tp = 1's")
    phase(71, "zamba2-2.7b trained tensor-parallel, two ranks sharing one "
          "card over gloo at (1, 2), sequence-parallel, remat",
          reduced=w["cut"], batch=w["batch"], seq_len=w["seq_len"],
          losses=",".join(f"{v:.6f}" for v in r0["losses"]),
          losses_tp1=",".join(f"{v:.6f}" for v in r0["losses_tp1"]),
          loss_rel_diff=",".join(f"{v:.3g}" for v in dl),
          param_max_abs_diff=f"{r0['param_max_abs']:.3g}",
          param_max_rel_diff=f"{r0['param_max_rel']:.3g}",
          grad_rel_diff_wbc=f"{r0['grad_rel']['wbc']:.3g}",
          grad_rel_diff_shared_wq=f"{r0['grad_rel']['shared_wq']:.3g}",
          param_GB_a_rank=f"{r0['bytes_cut'] / 1e9:.3f}",
          param_GB_tp1=f"{r0['bytes_tp1'] / 1e9:.3f}",
          peak_GB_a_rank=",".join(f"{r['peak_GB']:.2f}" for r in res),
          peak_GB_tp1=f"{r0['peak_GB_tp1']:.2f}",
          step_ms_two_ranks_sharing_one_card_over_gloo=",".join(
              f"{v:.0f}" for v in r0["step_ms"]),
          step_ms_tp1=",".join(f"{v:.0f}" for v in r0["step_ms_tp1"]),
          kernel_launches_in_training=0,
          worker_s=",".join(f"{r['seconds']:.1f}" for r in res),
          seconds=f"{time.perf_counter() - t0:.1f}")


def main():
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to chip_smoke.py; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    workers = {"--tp-worker": lambda *a: tp_worker(*a),   # phase 70 (b)
               "--tp-train-worker": lambda *a: tp_train_worker(*a)}  # 71
    if sys.argv[1:2] and sys.argv[1] in workers:
        rank, world, init, out = sys.argv[2:6]
        try:
            return workers[sys.argv[1]](int(rank), int(world), init, out)
        except SmokeFailure as e:
            print(f"chip_smoke: rank {rank} FAILED: {e}", file=sys.stderr)
            return 1
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
        tiers = phase_tiering(cfg, params, paged)
        t_obs = time.perf_counter()
        phase_trace(cfg, params, dict(slots=slot["trace"],
                                      paged=paged["trace"],
                                      verify=spec["trace"],
                                      **tiers["traces"]))
        phase_launcher()
        phase(63, "observability phases 62-63",
              seconds=f"{time.perf_counter() - t_obs:.1f}")
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
        gla = phase_gla(_gla_model("gla-2.7b"), extra=lambda p, c:
                        phase_prefix_other(p, c, 60,
                                           dict(k1s=GLA_LAYERS)))
        gla.update({arch: phase_gla_paged(arch, n)
                    for arch, n in (("retnet-2.7b", 26), ("hgrn2-2.7b", 27))})
        phase(30, "device memory before the dense family",
              allocated_GB=f"{torch.cuda.memory_allocated() / 1e9:.2f}")
        dense = {arch: phase_dense(arch, w, extra=None if arch != "yi-9b"
                                   else lambda p, c: phase_prefix_other(
                                       p, c, 59, dict(k3_gqa=c.n_layers,
                                                      k4q=c.n_layers)))
                 for arch, w in DENSE.items()}
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
        gc.collect()
        torch.cuda.empty_cache()
        t_f = time.perf_counter()
        phase_swamping()
        phase_format_model()
        phase(65, "the format study, phases 64-65",
              seconds=f"{time.perf_counter() - t_f:.1f}")
        t_t = time.perf_counter()
        phase_train()
        phase_train_zamba2()
        phase(68, "training, phases 66-68",
              seconds=f"{time.perf_counter() - t_t:.1f}")
        phase_dist()
        tp_kern = phase_tp_kernels()
        tp_run = phase_tp_serve()
        phase_tp_train()
        kernels = kernels_line(errs, times, slot, paged, spec, ds, gla,
                               dense, xlstm, pali, tp_kern, tp_run)
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
                 pali, tp_kern, tp_run):
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
    kernels 3 to 6 none; and the head-shard launches of tensor-parallel
    serving at tp = 2, counted on phase 70's path in rank 0's process:
    kernels 1, 2 and the dense append on its model-level decode, kernel 1
    in slab mode, kernel 3 and the fused paged append on its paged
    engine; then kernel 1 at gla's and xlstm's head shards, counted on
    their model-level decodes, and MLA kernels 2, 3 and 5 at 64 of 128
    query rows, on deepseek's model-level decode, paged engine and paged
    engine with speculation; and the fused paged append on a data rank's
    2 of 4 rows with its row base, counted on rank 0's paged engine at the
    (2, 1) mesh); ``launches`` counts
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
    out2, errs2, _ = tp_kern[2]
    for key, counts, counter, source, replaces in (
            ("su", "sr_counts", "k1", su_src, su_tpu),
            ("su_slab", "engine_counts", "k1s", su_src, su_tpu),
            ("k2", "sr_counts", "k2_gqa",
             "src/repro_torch/csrc/mx_attention.cu",
             "src/repro/kernels/mx_attention.py:98"),
            ("k3", "engine_counts", "k3_gqa", pa_src,
             "src/repro/kernels/mx_paged_attention.py:108"),
            ("apd", "sr_counts", "apd", q_src, q_tpu),
            ("apq", "engine_counts", "k4q", pa_src,
             "src/repro/kernels/mx_paged_attention.py:199")):
        name = {"su": "mx_state_update[tp2]",
                "su_slab": "mx_state_update[slab,tp2]",
                "k2": "mx_attention_decode[tp2]",
                "k3": "mx_paged_attention_decode[tp2]",
                "apd": "mx_kv_append_quant[tp2]",
                "apq": "mx_paged_kv_append[quant,tp2]"}[key]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=tp_run[counts].get(counter, 0),
                            max_abs_err=errs2[key], **out2[key]))
    su_out, su_errs = tp_kern["su"]
    mla_out, mla_errs, _ = tp_kern["mla"]
    ds = tp_run["deepseek-v2-236b"]
    at_src = "src/repro_torch/csrc/mx_attention.cu"
    for name, times, launches, err, source, replaces in (
            ("mx_state_update[gla,tp2]", su_out,
             tp_run["gla-2.7b"]["sr_counts"].get("k1", 0), su_errs["gla"],
             su_src, su_tpu),
            ("mx_state_update[xlstm,tp2]", su_out,
             tp_run["xlstm-1.3b"]["sr_counts"].get("k1", 0),
             su_errs["xlstm"], su_src, su_tpu),
            ("mx_attention_decode[mla,tp2]", mla_out,
             ds["sr_counts"].get("k2", 0), mla_errs["k2_tp2"], at_src,
             "src/repro/kernels/mx_attention.py:98"),
            ("mx_paged_attention_decode[mla,tp2]", mla_out,
             ds["engine_paged"]["n"].get("k3", 0), mla_errs["k3_tp2"],
             pa_src, "src/repro/kernels/mx_paged_attention.py:108"),
            ("mx_paged_spec_attention_decode[mla,tp2]", mla_out,
             ds["engine_spec"]["n"].get("k5", 0), mla_errs["k5_tp2"],
             sv_src, "src/repro/kernels/mx_spec_attention.py:193")):
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=err, **times[name]))
    rows_out, rows_err = tp_kern["rows"]
    kernels.append(dict(
        name="mx_paged_kv_append[quant,rows2..3]", route="cuda",
        source=pa_src, replaces="src/repro/kernels/mx_paged_attention.py:199",
        launches=tp_run["dp"]["paged_sr_dp"]["counts"].get("k4q", 0),
        max_abs_err=rows_err, **rows_out))
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            check(math.isfinite(k[key]), f"{k['name']}: {key} not finite")
    phase(8, "kernels", names=[k["name"] for k in kernels])
    return kernels


if __name__ == "__main__":
    sys.exit(main())
