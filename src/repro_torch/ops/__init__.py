"""repro_torch.ops -- the unified SPU operator subsystem (PyTorch port).

One registry-dispatched decode-op interface for attention and state updates
(paper §4: both are the same memory-bound op class).  See
``repro_torch/ops/base.py`` for the plan/execute/traffic contract and
``repro_torch/ops/registry.py`` for dispatch and capability negotiation.

    from repro_torch import ops as OPS

    Sn, y = OPS.state_update_step(S, d, k, v, q, cfg.state_quant, seed=seed)
    out, cache = OPS.attention_decode_step(cache, k_new, v_new, q,
                                           cfg.state_quant, seed=seed)
    out, cache = OPS.attention_spec_step(cache, k_new, v_new, q_n,
                                         cfg.state_quant, seed=seed)
"""
# base and registry first, then the op implementations (they register
# themselves on import; dense, then the paged layout), then the model-level
# traffic bridge
from repro_torch.ops.base import (LAYOUTS, OpPlan, SpuDeprecationWarning,
                                  SpuOp, StateQuantConfig, TrafficBytes,
                                  fmt_bits, fmt_of_state, sr_heads,
                                  sr_heads_from, sr_row_base,
                                  sr_rows_from)
from repro_torch.ops.registry import (BACKEND_PREFERENCE, OP_KINDS,
                                      backends_for, execute, get_op, plan,
                                      register, registered, resolve_backend,
                                      traffic)
from repro_torch.ops.state_update import (StateLike, init_state,
                                          plan_state_update,
                                          plan_state_update_dims,
                                          state_nbytes, state_update_float,
                                          state_update_step)
from repro_torch.ops.attention import (attention_decode_step, attn_decode,
                                       attn_kind_of, kv_append,
                                       plan_attn_decode_dims)
from repro_torch.ops import paged_ops  # noqa: F401  (registers layout="paged")
from repro_torch.ops.spec_verify import attention_spec_step, spec_attend
from repro_torch.ops.model_traffic import (OpTrafficEntry, decode_op_plans,
                                           decode_traffic_by_kind)

__all__ = [
    "LAYOUTS", "OpPlan", "SpuDeprecationWarning", "SpuOp",
    "StateQuantConfig", "TrafficBytes",
    "fmt_bits", "fmt_of_state", "sr_heads", "sr_heads_from",
    "sr_row_base", "sr_rows_from",
    "BACKEND_PREFERENCE", "OP_KINDS", "backends_for", "execute", "get_op",
    "plan", "register", "registered", "resolve_backend", "traffic",
    "StateLike", "init_state", "plan_state_update", "plan_state_update_dims",
    "state_nbytes", "state_update_float", "state_update_step",
    "attention_decode_step", "attn_decode", "attn_kind_of", "kv_append",
    "plan_attn_decode_dims",
    "attention_spec_step", "spec_attend",
    "OpTrafficEntry", "decode_op_plans", "decode_traffic_by_kind",
]
