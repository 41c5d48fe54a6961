"""Analytical DRAM-timing model of the Pimba PIM designs (paper §4--§6):
the PyTorch port's copy of ``repro/core/pimsim.py`` (pure Python and numpy;
no device runs here).

The paper's *architecture* claims are reproduced with a first-principles
timing model parameterized by the paper's Table 1.  Per state-update
invocation it models the GPU (bandwidth over HBM at the system's storage
format), the time-multiplexed PIM unit, the per-bank pipelined unit, and
Pimba's one SPU per two banks with access interleaving and command
scheduling (:func:`pim_state_update_latency`).  :func:`generation_step_latency`
and :func:`spec_verify_step_latency` add projections and attention for a
whole model step (Figs. 12/13/15); :func:`placement_step_latency` scores a
real page map from the paged pool's placement.

Every byte count comes from the port's op registry on its ``torch`` backend
(``traffic(plan)``), the descriptors the serving engines are accounted with;
there is no local byte formula.

Reproduced results: Fig. 5a -- time-mux ~2.8x GPU, pipelined ~4.3x GPU
throughput; Fig. 12 -- Pimba against GPU / GPU+Q / GPU+PIM generation gains.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class HBMConfig:
    """Paper Table 1 (HBM2E) in memory-bus cycles @ bus_freq."""
    banks_per_bankgroup: int = 4
    bankgroups_per_pch: int = 4
    pseudo_channels: int = 16 * 2      # 40 stacks-worth scaled per device
    bus_freq_hz: float = 1.512e9
    tRP: int = 14
    tRAS: int = 34
    tCCD_S: int = 2
    tCCD_L: int = 4
    tWR: int = 16
    tRTP_L: int = 6
    tFAW: int = 30
    tRCD: int = 14
    burst_bytes: int = 32              # one column access per pseudo-channel
    row_bytes: int = 1024

    @property
    def banks(self) -> int:
        return self.banks_per_bankgroup * self.bankgroups_per_pch

    @property
    def cycle_s(self) -> float:
        return 1.0 / self.bus_freq_hz


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """A100-class host + 40 PIM-enabled HBM modules (paper §6.1)."""
    hbm: HBMConfig = HBMConfig()
    n_stacks: int = 40
    hbm_bw_bytes: float = 2.0e12       # aggregate channel bandwidth
    gpu_flops: float = 312e12          # A100 fp16


# ---------------------------------------------------------------------------
# workload: one generation step's state updates for a whole model
# ---------------------------------------------------------------------------

#: storage format each paper system keeps its state/KV in
SYSTEM_FMT = {"gpu": "fp16", "gpu_q": "int8", "gpu_pim": "fp16",
              "pimba": "mx8"}


def _op_plan(kind: str, fmt: str, dims: Dict[str, int],
             layout: str = "dense"):
    """Plan one SPU op on the torch backend (timing model scores logical
    ops; the twin of the JAX package's jnp backend).

    ``layout="paged"`` plans the block-table-native op instead: its traffic
    is page-granular (whole 128-token pages stream), which is what the
    bank-conflict model scores for the paged serving pool -- see
    ``PagedStatePool.bank_traffic``, which feeds
    :func:`placement_step_latency` bursts derived from those descriptors.
    """
    from repro_torch import ops as OPS
    quant = OPS.StateQuantConfig(fmt=fmt, rounding="stochastic",
                                 backend="torch")
    return OPS.plan(kind, dims, quant, "torch", layout=layout)


def _op_traffic(plan):
    from repro_torch import ops as OPS
    return OPS.traffic(plan)


@dataclasses.dataclass(frozen=True)
class StateWorkload:
    """One generation step's Eq. 2 invocations, one plan per layer.

    Byte counts come from the registered state-update op's own
    ``traffic(plan)`` descriptor -- the same numbers the executing call
    sites are accounted with -- not from a local formula.
    """
    batch: int
    n_layers: int
    n_heads: int
    dk: int                 # dim_head in the paper's Eq. 2
    dv: int                 # dim_state
    fmt: str = "fp16"       # storage format (fp16 GPU, int8 GPU+Q, mx8 Pimba)
    layout: str = "dense"   # operand layout (paged = block-table pools)

    @property
    def plan(self):
        return _op_plan("state_update", self.fmt,
                        dict(B=self.batch, H=self.n_heads,
                             dk=self.dk, dv=self.dv), self.layout)

    @property
    def state_bytes(self) -> float:
        """One pass over all layers' state (read side of traffic(plan))."""
        return self.n_layers * _op_traffic(self.plan).state_read

    @property
    def flops(self) -> float:
        # decay + outer + add + GEMV ≈ 6 ops per state element
        return (self.batch * self.n_layers * self.n_heads
                * self.dk * self.dv * 6.0)


#: the unfused GPU state update (decay / outer+add / GEMV as separate
#: kernels, as in the PyTorch baselines of paper Fig. 3) re-touches the
#: state between kernels; 1.7 effective passes matches the paper's measured
#: GPU latencies against pure-bandwidth time.
GPU_STATE_PASSES = 1.7
GPU_ATTN_PASSES = 1.2


def gpu_state_update_latency(w: StateWorkload, sys: SystemConfig) -> float:
    """GPU baseline: bandwidth-bound read+write of the state + operands."""
    traffic = _op_traffic(w.plan)
    bytes_moved = w.n_layers * traffic.state_total * GPU_STATE_PASSES
    t_bw = bytes_moved / sys.hbm_bw_bytes
    t_fl = w.flops / sys.gpu_flops
    return max(t_bw, t_fl)


def _bursts_per_device(w: StateWorkload, sys: SystemConfig) -> float:
    """Column accesses per pseudo-channel-bank-group pipeline."""
    h = sys.hbm
    total_bursts = w.state_bytes / h.burst_bytes
    pipes = sys.n_stacks * h.pseudo_channels
    return total_bursts / pipes


def _cycles_per_burst(h: HBMConfig, design: str) -> float:
    """Cost of one state sub-chunk (one column burst) on the owning unit.

    * ``time_multiplexed`` -- the non-pipelined unit issues read / decay /
      outer / add / dot / write as separate serialized micro-ops
      (6 x tCCD_L) and pays the read->write bus turnaround
      (tWR/2 + tRTP) per sub-chunk.
    * ``pipelined`` -- 4-stage per-bank pipeline: compute is hidden, but
      each sub-chunk still needs a read burst + a write burst on the same
      bank's row buffer plus write recovery before the next read (tWR).
    * ``pimba`` -- access interleaving: the SPU's read (upper bank) and the
      write of the previous result (bottom bank) overlap, so the write
      burst and its recovery vanish from the critical path -- same
      throughput as per-bank pipelined with HALF the units (the paper's
      headline claim is area, throughput is preserved); command scheduling
      (Fig. 11) removes the operand/result transfer overhead separately.
    """
    if design == "time_multiplexed":
        return 6 * h.tCCD_L + h.tWR / 2 + h.tRTP_L
    if design in ("pipelined", "pimba"):
        return 2 * h.tCCD_L + h.tWR
    raise ValueError(design)


def pim_state_update_latency(w: StateWorkload, sys: SystemConfig,
                             design: str) -> float:
    """Latency of the in-PIM state update under the three designs.

    Per sub-chunk (one column burst) the SPU must:
      read S, compute decay+outer+add, write S', dot-product for y.
    Column accesses across a pseudo-channel serialize on I/O gating at
    tCCD_L; what differs per design is the cost of one state sub-chunk
    (see :func:`_cycles_per_burst`).
    """
    h = sys.hbm
    bursts = _bursts_per_device(w, sys)       # per pseudo-channel
    compute_cycles = bursts * _cycles_per_burst(h, design)
    # row activate/precharge + operand (REG_WRITE) / result (RESULT_READ)
    # transfer overheads; Pimba hides them inside tFAW/tRP windows.
    rows = w.state_bytes / (h.row_bytes * sys.n_stacks * h.pseudo_channels)
    row_overhead = rows * (h.tRCD + h.tRP) / h.banks
    operand_cycles = 0.0 if design == "pimba" else bursts * h.tCCD_L * 0.5
    total_cycles = compute_cycles + row_overhead + operand_cycles
    return total_cycles * h.cycle_s


def placement_step_latency(bursts: np.ndarray, sys: SystemConfig,
                           design: str = "pimba") -> Dict[str, float]:
    """Bank-conflict-aware latency of one decode step for a *real* page map.

    ``bursts`` is a (pseudo_channels, bank_pairs) array of column bursts the
    step issues against each bank pair (``PagedStatePool.bank_traffic``).
    Returns the real and the ideal (same traffic, perfectly spread)
    latency and their ratio ``conflict_factor`` (1.0: placement costs
    nothing).
    """
    h = sys.hbm
    bursts = np.asarray(bursts, float)
    cpb = _cycles_per_burst(h, design)
    pair_cycles = bursts * cpb                          # SPU-bound
    bus_cycles = bursts.sum(axis=1) * h.tCCD_L          # pch I/O gating
    per_pch = np.maximum(bus_cycles, pair_cycles.max(axis=1, initial=0.0))
    t_real = float(per_pch.max(initial=0.0) * h.cycle_s)

    total = bursts.sum()
    n_pch, n_pairs = bursts.shape
    uniform_pair = total / (n_pch * n_pairs)
    uniform_bus = total / n_pch
    t_ideal = float(max(uniform_pair * cpb, uniform_bus * h.tCCD_L)
                    * h.cycle_s)
    return {"t_real_s": t_real, "t_ideal_s": t_ideal,
            "conflict_factor": t_real / t_ideal if t_ideal > 0 else 1.0}


def bank_trace_counters(bursts: np.ndarray,
                        sys: Optional[SystemConfig] = None,
                        design: str = "pimba") -> Dict[str, float]:
    """One decode step's bank traffic as a flat numeric dict: per-pseudo-
    channel burst totals, total bursts, and the placement model's
    ``conflict_factor`` / real step latency for the same map."""
    if sys is None:
        sys = SystemConfig()
    bursts = np.asarray(bursts, float)
    rep = placement_step_latency(bursts, sys, design)
    out = {f"pch{p:02d}_bursts": float(b)
           for p, b in enumerate(bursts.sum(axis=1))}
    out["total_bursts"] = float(bursts.sum())
    out["conflict_factor"] = rep["conflict_factor"]
    out["t_real_us"] = rep["t_real_s"] * 1e6
    return out


# ---------------------------------------------------------------------------
# end-to-end generation model (Figs. 12/13/15)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    n_params: float
    n_layers: int
    n_heads: int
    dk: int
    dv: int
    attn_layers: int = 0       # attention layers (hybrid / transformer)
    attn_kv_heads: int = 0     # KV heads per attention layer
    attn_head_dim: int = 0


PAPER_MODELS = {
    "retnet-2.7b": ModelSpec("retnet-2.7b", 2.7e9, 32, 10, 256, 512),
    "gla-2.7b": ModelSpec("gla-2.7b", 2.7e9, 32, 4, 320, 640),
    "hgrn2-2.7b": ModelSpec("hgrn2-2.7b", 2.7e9, 32, 20, 128, 128),
    "mamba2-2.7b": ModelSpec("mamba2-2.7b", 2.7e9, 64, 80, 128, 64),
    "zamba2-7b": ModelSpec("zamba2-7b", 7.0e9, 54, 80, 64, 64,
                           attn_layers=9, attn_kv_heads=32, attn_head_dim=80),
    "opt-6.7b": ModelSpec("opt-6.7b", 6.7e9, 0, 0, 0, 0,
                          attn_layers=32, attn_kv_heads=32, attn_head_dim=128),
}


def generation_step_latency(spec: ModelSpec, batch: int, seq_len: int,
                            sys: SystemConfig, system: str) -> Dict[str, float]:
    """One token step: projections/FFN on GPU + state update + attention.

    system: gpu | gpu_q | gpu_pim | pimba
    Returns {"proj": s, "state": s, "attn": s, "total": s}.
    """
    # GPU part: weight-bound GEMMs (batch amortizes weights)
    w_bytes = 2.0 * spec.n_params
    t_proj = max(w_bytes / sys.hbm_bw_bytes,
                 2.0 * spec.n_params * batch / sys.gpu_flops)

    fmt = SYSTEM_FMT[system]
    t_state = 0.0
    if spec.n_layers:
        w = StateWorkload(batch, spec.n_layers, spec.n_heads, spec.dk,
                          spec.dv, fmt)
        if system in ("gpu", "gpu_q"):
            t_state = gpu_state_update_latency(w, sys)
        elif system == "gpu_pim":
            t_state = pim_state_update_latency(w, sys, "time_multiplexed")
        else:
            t_state = pim_state_update_latency(w, sys, "pimba")

    t_attn = 0.0
    if spec.attn_layers:
        # one attn_decode op per layer; its traffic(plan) streams the whole
        # valid cache once (score + attend phases, read-only)
        attn_plan = _op_plan("attn_decode", fmt,
                             dict(B=batch, T=seq_len, H=spec.attn_kv_heads,
                                  KVH=spec.attn_kv_heads,
                                  dk=spec.attn_head_dim,
                                  dv=spec.attn_head_dim, n=1))
        kv_bytes = _op_traffic(attn_plan).state_read * spec.attn_layers
        if system in ("gpu", "gpu_q"):
            t_attn = kv_bytes * GPU_ATTN_PASSES / sys.hbm_bw_bytes
        else:
            # PIM attention: score+attend are read-only GEMV streams (no
            # write-back), so no tWR recovery; the host softmax bounce adds
            # a second pass over the scores for non-Pimba designs (§6.2:
            # interleaving gains less here, MX8 is the main win)
            h = sys.hbm
            bursts = kv_bytes / h.burst_bytes / (sys.n_stacks * h.pseudo_channels)
            per_burst = h.tCCD_L if system == "pimba" else h.tCCD_L * 1.5
            t_attn = bursts * per_burst * h.cycle_s
    return {"proj": t_proj, "state": t_state, "attn": t_attn,
            "total": t_proj + t_state + t_attn}


def generation_throughput(spec: ModelSpec, batch: int, seq_len: int,
                          sys: SystemConfig, system: str) -> float:
    lat = generation_step_latency(spec, batch, seq_len, sys, system)["total"]
    return batch / lat


# ---------------------------------------------------------------------------
# speculative decoding (spec_verify workload)
# ---------------------------------------------------------------------------

def spec_verify_step_latency(spec: ModelSpec, batch: int, seq_len: int,
                             k: int, sys: SystemConfig,
                             system: str) -> Dict[str, float]:
    """One speculative verify step over ``Kq = k + 1`` query positions.

    The weight streams of projections/FFN are unchanged (weights stream
    once regardless of how many positions ride the GEMM -- that is why
    verification is nearly free on a bandwidth-bound step), recurrent state
    updates run once per position, and attention streams the cache ONCE for
    all positions through the ``spec_verify`` op's own traffic descriptor.
    """
    Kq = k + 1
    w_bytes = 2.0 * spec.n_params
    t_proj = max(w_bytes / sys.hbm_bw_bytes,
                 2.0 * spec.n_params * batch * Kq / sys.gpu_flops)

    fmt = SYSTEM_FMT[system]
    t_state = 0.0
    if spec.n_layers:
        w = StateWorkload(batch, spec.n_layers, spec.n_heads, spec.dk,
                          spec.dv, fmt)
        if system in ("gpu", "gpu_q"):
            t_state = gpu_state_update_latency(w, sys) * Kq
        elif system == "gpu_pim":
            t_state = pim_state_update_latency(w, sys,
                                               "time_multiplexed") * Kq
        else:
            t_state = pim_state_update_latency(w, sys, "pimba") * Kq

    t_attn = 0.0
    if spec.attn_layers:
        plan = _op_plan("spec_verify", fmt,
                        dict(B=batch, T=seq_len, H=spec.attn_kv_heads,
                             KVH=spec.attn_kv_heads, dk=spec.attn_head_dim,
                             dv=spec.attn_head_dim, n=1, Kq=Kq))
        kv_bytes = _op_traffic(plan).state_read * spec.attn_layers
        if system in ("gpu", "gpu_q"):
            t_attn = kv_bytes * GPU_ATTN_PASSES / sys.hbm_bw_bytes
        else:
            h = sys.hbm
            bursts = kv_bytes / h.burst_bytes / (sys.n_stacks
                                                 * h.pseudo_channels)
            per_burst = h.tCCD_L if system == "pimba" else h.tCCD_L * 1.5
            t_attn = bursts * per_burst * h.cycle_s
    return {"proj": t_proj, "state": t_state, "attn": t_attn,
            "total": t_proj + t_state + t_attn}


def expected_tokens_per_spec_step(k: int, acceptance: float) -> float:
    """Expected emitted tokens of one verify step at per-draft acceptance
    probability ``a``: 1 + a + a^2 + ... + a^k (every step emits at least
    the model's own token, each consecutive accepted draft adds one)."""
    assert 0.0 <= acceptance <= 1.0
    if acceptance >= 1.0:
        return float(k + 1)
    return (1.0 - acceptance ** (k + 1)) / (1.0 - acceptance)


def spec_generation_throughput(spec: ModelSpec, batch: int, seq_len: int,
                               k: int, acceptance: float, sys: SystemConfig,
                               system: str) -> float:
    """Tokens/s of speculative serving: verify-step latency amortized over
    the expected accepted tokens (draft-source cost assumed off-device)."""
    lat = spec_verify_step_latency(spec, batch, seq_len, k, sys,
                                   system)["total"]
    return batch * expected_tokens_per_spec_step(k, acceptance) / lat
