"""Per-model decode-op plans: the bridge from a ModelConfig to SpuOp traffic.

The PyTorch twin of ``repro/ops/model_traffic.py``:
``decode_op_plans(cfg, batch, seq_len, layout)`` enumerates every registered
SPU op one decode step runs, with its per-step count, so the serving
engines' traffic meters and the cost accounting read the ops' own
``traffic(plan)``.  ``layout="paged"`` enumerates the block-table-native
ops (page-granular attention reads, one-slot appends); ``spec_k > 0`` one
speculative verify step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.ops import registry
from repro_torch.ops.base import OpPlan, TrafficBytes


@dataclasses.dataclass(frozen=True)
class OpTrafficEntry:
    """One op kind's plan and how many times a decode step runs it."""
    kind: str
    plan: OpPlan
    count: int

    @property
    def traffic(self) -> TrafficBytes:
        return registry.traffic(self.plan).scaled(self.count)


def _state_dims(cfg, kind: str):
    """(H, dk, dv) of one mixer's recurrent state, from the mixers' own
    dimension helpers in ``models/ssm.py`` (imported lazily: ssm imports
    ``repro_torch.ops`` at module top)."""
    from repro_torch.models import ssm as SSM
    if kind == "mamba2":
        _, H, N, P = SSM._m2_dims(cfg)
        return H, N, P
    if kind in SSM.GLA_FAMILY:
        return SSM._gla_dims(cfg)
    if kind == "mlstm":      # the normalizer-augmented dv
        _, H, dk, _, dv_aug = SSM._mlstm_dims(cfg)
        return H, dk, dv_aug
    raise ValueError(f"mixer {kind!r} runs no state update")


def decode_op_plans(cfg, batch: int, seq_len: int,
                    layout: str = "dense",
                    spec_k: int = 0) -> List[OpTrafficEntry]:
    """Every SPU op one decode step runs for ``cfg`` in ``layout``, with
    layer counts.  ``spec_k > 0`` describes one speculative step at
    ``Kq = spec_k + 1`` query positions: attention streams through
    ``spec_verify`` (one cache stream for all positions), appends and
    recurrent-state updates run once per position."""
    quant = cfg.state_quant
    Kq = spec_k + 1
    entries: List[OpTrafficEntry] = []
    # the sLSTM is a vector recurrence, not an SPU op: it has no entry

    def layer_count(kind: str) -> int:
        return (cfg.pattern.count(kind) * cfg.n_groups
                + cfg.prelude.count(kind))

    state_counts: Dict[tuple, int] = {}
    for kind in ("mamba2", "gla", "retnet", "hgrn2", "mlstm"):
        n = layer_count(kind)
        if n and cfg.ssm is not None:
            dims = _state_dims(cfg, kind)
            state_counts[dims] = state_counts.get(dims, 0) + n
    from repro_torch.ops.state_update import plan_state_update_dims
    for (H, dk, dv), n in sorted(state_counts.items()):
        entries.append(OpTrafficEntry(
            "state_update",
            plan_state_update_dims(batch, H, dk, dv, quant, layout=layout),
            n * Kq))

    from repro_torch.ops.attention import plan_attn_decode_dims
    n_attn = layer_count("attn") + (cfg.n_groups if cfg.shared_attn else 0)
    if n_attn:
        dims = dict(B=batch, T=seq_len, KVH=cfg.n_kv_heads,
                    dk=cfg.head_dim, dv=cfg.head_dim, n=1, H=cfg.n_heads)
        if spec_k > 0:
            entries.append(OpTrafficEntry(
                "spec_verify", registry.plan("spec_verify", dict(dims, Kq=Kq),
                                             quant, quant.backend,
                                             layout=layout), n_attn))
        else:
            entries.append(OpTrafficEntry(
                "attn_decode", plan_attn_decode_dims(dims, quant,
                                                     layout=layout), n_attn))
        entries.append(OpTrafficEntry(
            "kv_append", registry.plan("kv_append", dims, quant,
                                       quant.backend, layout=layout),
            n_attn * Kq))
    n_mla = layer_count("mla")
    if n_mla and cfg.mla is not None:
        # one latent stream (KVH = 1, no V); the output is kv_lora wide
        dims = dict(B=batch, T=seq_len, KVH=1, dk=cfg.mla.cache_width,
                    dv=0, n=1, H=cfg.n_heads)
        if spec_k > 0:
            entries.append(OpTrafficEntry(
                "spec_verify", registry.plan("spec_verify", dict(dims, Kq=Kq),
                                             quant, quant.backend,
                                             layout=layout,
                                             v_width=cfg.mla.kv_lora),
                n_mla))
        else:
            entries.append(OpTrafficEntry(
                "mla_decode", plan_attn_decode_dims(
                    dims, quant, kind="mla_decode", v_width=cfg.mla.kv_lora,
                    layout=layout), n_mla))
        entries.append(OpTrafficEntry(
            "kv_append", registry.plan("kv_append", dims, quant,
                                       quant.backend, layout=layout),
            n_mla * Kq))
    return entries


def decode_traffic_by_kind(cfg, batch: int, seq_len: int,
                           layout: str = "dense") -> Dict[str, TrafficBytes]:
    """Per-op-kind traffic of one decode step (sums entries of a kind)."""
    out: Dict[str, TrafficBytes] = {}
    for e in decode_op_plans(cfg, batch, seq_len, layout):
        out[e.kind] = out.get(e.kind, TrafficBytes()) + e.traffic
    return out
