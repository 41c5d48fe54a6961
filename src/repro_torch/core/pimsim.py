"""Analytical DRAM-timing model of the Pimba PIM designs: the part of
``repro/core/pimsim.py`` the paged serving engine calls (pure Python and
numpy).

The paged pool's placement produces a real page map -- column bursts per
(pseudo-channel, bank pair) for one decode step -- and
:func:`placement_step_latency` scores it with the paper's Table 1 HBM
timings: each SPU (one per bank pair) retires its own bursts, every burst
of a pseudo-channel shares its I/O gating.  The closed-form per-design
latencies and the end-to-end generation model follow with the cost-model
slice (ROADMAP.md).
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


def _cycles_per_burst(h: HBMConfig, design: str) -> float:
    """Cost of one state sub-chunk (one column burst) on the owning unit:
    the time-multiplexed unit serializes six micro-ops plus the bus
    turnaround; the pipelined unit and Pimba's interleaved SPU retire a
    read + write burst plus write recovery."""
    if design == "time_multiplexed":
        return 6 * h.tCCD_L + h.tWR / 2 + h.tRTP_L
    if design in ("pipelined", "pimba"):
        return 2 * h.tCCD_L + h.tWR
    raise ValueError(design)


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
