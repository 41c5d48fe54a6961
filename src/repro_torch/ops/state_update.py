"""The generalized state-update operator (paper Eq. 2) as registered SpuOps.

    S_t = d_t ⊙ S_{t-1} + k_t v_tᵀ ;   y_t = S_tᵀ q_t

The PyTorch twin of ``repro/ops/state_update.py``.  Stored state layout is
``(B, H, dv, dk)`` (Sᵀ) with MX groups along dk.  Two backends:

* ``cuda``  -- the fused kernel (``kernels/mx_state_update.py``), MX8 only.
  It updates the state in place on the card.
* ``torch`` -- the plain version for every storage format (a new state).

A ``PagedState`` slab view dispatches the ``layout="paged"`` ops of
``repro_torch/ops/paged_ops.py`` instead, which update the owned slab rows
of the pool in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.core import formats as F
from repro_torch.core.paged import PagedState
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.mx_state_update import mx_state_update as _su_cuda
from repro_torch.ops import registry
from repro_torch.ops.base import (OPERAND_BYTES, OUTPUT_BYTES, OpPlan, SpuOp,
                                  StateQuantConfig, TrafficBytes,
                                  fmt_of_state, sr_heads, sr_row_base)

StateLike = Union[F.QuantizedTensor, torch.Tensor]

#: the unquantized Eq. 2 step (the paper's "GPU" configuration), exported
#: beside the quantized entry points as the JAX package's ops export it
state_update_float = _ref.state_update_float


def init_state(B: int, H: int, dk: int, dv: int, cfg: StateQuantConfig,
               device=None) -> StateLike:
    """Zero-initialized recurrent state, stored layout (B, H, dv, dk)."""
    zeros = torch.zeros((B, H, dv, dk), dtype=torch.float32, device=device)
    if not cfg.quantized:
        return zeros.to(F.FLOAT_DTYPES[cfg.fmt])
    return F.quantize(zeros, cfg.fmt)


class _StateUpdateBase(SpuOp):
    kind = "state_update"

    def traffic(self, plan: OpPlan) -> TrafficBytes:
        B, H = plan.dim("B"), plan.dim("H")
        dk, dv = plan.dim("dk"), plan.dim("dv")
        state = B * H * dk * dv * plan.bits_per_val / 8.0
        operands = B * H * (3 * dk + dv) * OPERAND_BYTES
        out = B * H * dv * OUTPUT_BYTES
        return TrafficBytes(state_read=state, state_write=state,
                            operand_read=operands, output_write=out)


@registry.register
class StateUpdateCuda(_StateUpdateBase):
    """Fused MX8 state update (dequant + decay + outer + requant + GEMV)."""
    backend = "cuda"
    formats = ("mx8",)

    def execute(self, state, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[StateLike, torch.Tensor]:
        return _su_cuda(state, inputs["d"], inputs["k"], inputs["v"],
                        inputs["q"], inputs.get("seed", 0),
                        rounding=plan.rounding,
                        row_base=inputs.get("row_base", 0),
                        head_base=inputs.get("head_base", 0),
                        heads_total=inputs.get("heads_total"))


@registry.register
class StateUpdateTorch(_StateUpdateBase):
    """Plain PyTorch semantics for every storage format."""
    backend = "torch"
    formats = ("mx8", "int8", "fp8_e4m3", "fp8_e5m2", "fp32", "bf16", "fp16")

    def execute(self, state, inputs: Dict[str, Any],
                plan: OpPlan) -> Tuple[StateLike, torch.Tensor]:
        d, k, v, q = inputs["d"], inputs["k"], inputs["v"], inputs["q"]
        seed = int(inputs.get("seed", 0)) & 0xFFFFFFFF
        if not isinstance(state, F.QuantizedTensor):
            return _ref.state_update_float(state, d, k, v, q,
                                           dtype=state.dtype)
        return _ref.quantized_state_update_stored_ref(
            state, d, k, v, q, rounding=plan.rounding, seed=seed,
            row_base=inputs.get("row_base", 0),
            head_base=inputs.get("head_base", 0),
            heads_total=inputs.get("heads_total"))


def plan_state_update_dims(B: int, H: int, dk: int, dv: int,
                           cfg: StateQuantConfig, *, layout: str = "dense",
                           strict: bool = False) -> OpPlan:
    """Plan one Eq. 2 invocation from explicit dims (cost-model entry)."""
    return registry.plan("state_update", dict(B=B, H=H, dk=dk, dv=dv),
                         cfg, cfg.backend, layout=layout, strict=strict)


def state_nbytes(B: int, H: int, dk: int, dv: int,
                 cfg: StateQuantConfig) -> float:
    """Logical storage bytes of one layer's state (bandwidth accounting)."""
    return registry.traffic(plan_state_update_dims(B, H, dk, dv,
                                                   cfg)).state_read


def plan_state_update(state, cfg: StateQuantConfig) -> OpPlan:
    """Plan from a live state container: format and layout come from the
    container (a ``PagedState`` slab view plans the paged op)."""
    B, H, dv, dk = state.shape
    paged = isinstance(state, PagedState)
    quant = StateQuantConfig(fmt=state.fmt if paged else fmt_of_state(state),
                             rounding=cfg.rounding, backend=cfg.backend)
    return plan_state_update_dims(B, H, dk, dv, quant,
                                  layout="paged" if paged else "dense")


def state_update_step(state: StateLike, d: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, q: torch.Tensor, cfg: StateQuantConfig,
                      seed: int = 0) -> Tuple[StateLike, torch.Tensor]:
    """One decode step of Eq. 2: plan + dispatch through the registry.

    d: (B,H,dk) or (B,H,1); k,q: (B,H,dk); v: (B,H,dv) -> y: (B,H,dv) f32.
    Stochastic rounding counts from the row base of
    :func:`~repro_torch.ops.base.sr_rows_from` and the head base of
    :func:`~repro_torch.ops.base.sr_heads_from`.
    """
    p = plan_state_update(state, cfg)
    head_base, heads_total = sr_heads()
    return registry.execute(state, {"d": d, "k": k, "v": v, "q": q,
                                    "seed": seed,
                                    "row_base": sr_row_base(),
                                    "head_base": head_base,
                                    "heads_total": heads_total}, p)
