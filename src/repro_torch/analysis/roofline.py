"""Three-term roofline analysis: the PyTorch port's copy of
``repro/analysis/roofline.py`` with the NVIDIA H100 SXM's constants.

Hardware model: H100 SXM5 80GB --
  989 TFLOP/s dense bf16 (67 TFLOP/s fp32), 3.35 TB/s HBM3, 450 GB/s
  NVLink 4 per direction.  The port's bounds (``chip_smoke.py``, the kernel
  table in PERF.md) take their peaks from here.

  compute term    = FLOPs / (chips x peak)
  memory term     = bytes / (chips x HBM_bw)
  collective term = per-chip link bytes / link_bw

:func:`parse_collectives` reads collective bytes from XLA's HLO text (plain
text parsing, kept as the JAX package has it): for each all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute it takes the
result shapes (local shapes in SPMD output) and a ring-algorithm cost over
the replica-group size.  :func:`analytic_cost` is the explicit per-chip byte
model; its decode-time cache and state bytes come from the port's op
registry (:func:`_cache_state_bytes`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

# --- NVIDIA H100 SXM5 80GB hardware constants ------------------------------
# Source: NVIDIA H100 Tensor Core GPU datasheet (SXM5 column) and the
# "NVIDIA H100 Tensor Core GPU Architecture" whitepaper.  The figures are
# the card's peaks at its 700 W maximum; a card set below 700 W runs slower
# under load, so every measurement beside these bounds names its limit.
#: dense BF16 on the tensor cores (989.4 TFLOP/s; the datasheet's 1,979 is
#: with 2:4 sparsity) -- the counterpart of a TPU's bf16 MXU figure
PEAK_FLOPS = 989e12
#: HBM3, 5 stacks (datasheet: 3.35 TB/s)
HBM_BW = 3.35e12
#: NVLink 4: 18 links x 25 GB/s = 450 GB/s per direction (900 GB/s total)
LINK_BW = 450e9
#: FP32 on the CUDA cores (datasheet: 67 TFLOP/s); the port's kernels and
#: its fp32 projections compute at this rate
PEAK_FP32_FLOPS = 67e12

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# result side of an HLO instruction: `%name = bf16[1,2,3]{...} opcode(`
_INSTR_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\](?:\{[^}]*\})?)\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> float:
    b = _DTYPE_BYTES.get(dtype)
    if b is None:
        return 0.0
    n = 1
    for d in dims.split(","):
        if d.strip():
            n *= int(d)
    return float(n * b)


def _tuple_bytes(inner: str) -> float:
    return sum(_shape_bytes(dt, dims) for dt, dims in _SHAPE_RE.findall(inner))


@dataclasses.dataclass
class CollectiveStats:
    """Per-chip ring-model link bytes, by collective kind."""
    by_kind: Dict[str, float]
    op_count: int

    @property
    def total_link_bytes(self) -> float:
        return sum(self.by_kind.values())


def parse_collectives(hlo_text: str, default_group: int = 1) -> CollectiveStats:
    by_kind: Dict[str, float] = {}
    count = 0
    for line in hlo_text.splitlines():
        if not any(c in line for c in _COLLECTIVES):
            continue
        m = _INSTR_RE.search(line)
        if not m:
            continue
        tuple_inner, dtype, dims, kind = m.groups()
        if "-done(" in line:
            continue  # async pair: count the -start only
        size = (_tuple_bytes(tuple_inner) if tuple_inner is not None
                else _shape_bytes(dtype, dims))
        g = default_group
        gm = _GROUPS_RE.search(line)
        if gm:
            g = len(gm.group(1).split(","))
        else:
            gi = _GROUPS_IOTA_RE.search(line)
            if gi:
                g = int(gi.group(2))
        if g <= 1:
            continue
        ring = (g - 1) / g
        if kind == "all-reduce":
            link = 2.0 * size * ring          # reduce-scatter + all-gather
        elif kind == "all-gather":
            link = size * ring                # result is the gathered size
        elif kind == "reduce-scatter":
            link = size * (g - 1)             # result is the scattered size
        elif kind == "all-to-all":
            link = size * ring
        else:                                  # collective-permute
            link = size
        by_kind[kind] = by_kind.get(kind, 0.0) + link
        count += 1
    return CollectiveStats(by_kind, count)


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    link_bytes_per_chip: float
    model_flops: float = 0.0          # 6*N*D (or 6*N_active*D) useful FLOPs
    n_chips: int = 1

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.link_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> Optional[float]:
        if self.model_flops and self.flops_per_chip:
            return self.model_flops / (self.flops_per_chip * self.n_chips)
        return None

    def row(self) -> Dict[str, object]:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
        }


# ---------------------------------------------------------------------------
# analytic per-chip HBM / ICI byte models
# ---------------------------------------------------------------------------
# XLA:CPU's "bytes accessed" counts unfused operand traffic (no TPU-grade
# fusion), and HLO-parsed collective bytes double-count loop-invariant
# gathers in the unrolled cost probe.  The roofline memory/collective terms
# therefore come from the explicit models below (standard roofline practice);
# the HLO-derived numbers are reported alongside as diagnostics.

def analytic_cost(cfg, sc, *, chips: int, tp: int, fs: int, pods: int,
                  n_params: float, grad_accum: int = 1,
                  serve_2d: bool = False,
                  cache_layout: str = "dense") -> Dict[str, float]:
    """Per-chip, per-step HBM bytes and ICI link bytes.

    Model assumptions (bf16 params/activations, f32 grads+moments):
      * FSDP: params live sharded over (tp x fs); each pass materializes the
        tp-shard via all-gather over fs, so per-chip weight reads ~= P/tp.
      * Megatron-SP: layer-boundary activations shard over tp; each layer
        costs an AG+RS pair per pass.
      * activations: ~c_act tensor r/w passes of (tokens_chip x d) per layer.
      * attention: flash streams K/V once per q-chunk; LA models stream the
        (dk x dv) chunk state instead.
      * decode: weights gathered per token (serving-with-FSDP posture),
        caches read (attention) or read+written (state update) once.
    """
    P = n_params * 2.0                        # bf16 param bytes
    d = cfg.d_model
    L = cfg.n_layers
    S = sc.seq_len
    B = sc.global_batch
    toks_chip = B * S / (fs * pods)
    kind = sc.kind

    # per-layer cache/state streaming bytes for one full sequence pass
    kv_width = 0.0
    state_stream = 0.0
    if any(k in ("attn", "mla") for k in cfg.pattern + cfg.prelude) \
            or cfg.shared_attn:
        if cfg.mla is not None:
            kv_width = cfg.mla.cache_width
        else:
            kv_width = 2 * cfg.n_kv_heads * cfg.head_dim
    n_ssm = sum(cfg.pattern.count(k) for k in
                ("mamba2", "gla", "retnet", "hgrn2", "mlstm")) \
        * cfg.n_groups
    if n_ssm and cfg.ssm is not None:
        H_ssm = (cfg.ssm.n_heads or cfg.n_heads)
        if "mamba2" in cfg.pattern:
            d_inner = cfg.ssm.expand * d
            H_ssm = d_inner // cfg.ssm.head_dim
            dk_, dv_ = cfg.ssm.d_state, cfg.ssm.head_dim
        elif "mlstm" in cfg.pattern:
            d_up = cfg.ssm.expand * d
            dk_ = dv_ = d_up // H_ssm
        else:
            dk_ = cfg.ssm.dk_head or cfg.head_dim
            dv_ = cfg.ssm.dv_head or cfg.head_dim
        chunk = cfg.ssm.chunk
        state_stream = (S / chunk) * H_ssm * dk_ * dv_ * 4 * 2  # r+w, f32
    n_attn_layers = (sum(cfg.pattern.count(k) for k in ("attn", "mla"))
                     * cfg.n_groups + len(cfg.prelude)
                     + (cfg.n_groups if cfg.shared_attn else 0))

    q_chunk = getattr(cfg, "attn_q_chunk", 512)
    attn_stream_per_seq = (S / q_chunk) * S * kv_width * 2.0   # bf16

    # op-registry traffic; cache_layout="paged" scores the block-table ops
    kv_cache, state_rw = _cache_state_bytes(cfg, sc, cache_layout)
    cache = kv_cache + state_rw

    out = {}
    if kind == "train":
        passes = 3.0                                  # fwd + bwd + remat
        hbm = (P / tp * passes * grad_accum           # weight reads
               + 8.0 * n_params * 2 / chips           # f32 grads r/w
               + 20.0 * n_params / chips              # adam moments + update
               + 30.0 * toks_chip * d * 2 * L / tp * 1.0   # activations (SP)
               + n_attn_layers * (B / (fs * pods)) * attn_stream_per_seq * passes
               + n_ssm * (B / (fs * pods)) * state_stream * passes)
        link = ((fs - 1) / fs * P / tp * passes * grad_accum      # FSDP AG
                + (fs - 1) / fs * 4.0 * n_params / tp             # grad RS
                + (2.0 * (pods - 1) / pods * 4.0 * n_params / (tp * fs)
                   if pods > 1 else 0.0))                          # pod AR
        # SP AG/RS pairs: ~4 per layer per pass on (toks_chip x d) bf16;
        # without SP the boundary stays sharded batch-only (TP einsums still
        # pay ~2 ARs per layer)
        sp_ops = 4.0 if getattr(cfg, "seq_parallel", True) else 2.0
        link += sp_ops * passes * (tp - 1) / tp * toks_chip * d * 2 * L
    elif kind == "prefill":
        hbm = (P / tp
               + 10.0 * toks_chip * d * 2 * L / tp
               + n_attn_layers * (B / (fs * pods)) * attn_stream_per_seq
               + n_ssm * (B / (fs * pods)) * state_stream
               + cache / chips)
        sp_ops_p = 2.0 if getattr(cfg, "seq_parallel", True) else 2.0
        link = ((fs - 1) / fs * P / tp
                + sp_ops_p * (tp - 1) / tp * toks_chip * d * 2 * L)
    else:  # decode
        if serve_2d:
            # 2D weight-stationary serving (Pope et al.): weights stay
            # sharded over (data x model); activations all-reduce over both
            # axes per layer; batch replicated, cache time over both axes
            hbm = (P / chips
                   + cache / chips
                   + 2.0 * state_rw / chips
                   + B * cfg.vocab_size * 4 / tp)
            link = (2.0 * ((tp - 1) / tp + (fs - 1) / fs)
                    * B * d * 2 * L)
        else:
            hbm = (P / tp                               # weights per token
                   + cache / chips                       # attention cache read
                   + 2.0 * state_rw / chips              # state read+write
                   + B / (fs * pods) * cfg.vocab_size * 4)  # logits
            link = ((fs - 1) / fs * P / tp               # FSDP weight AG
                    + 2.0 * (tp - 1) / tp * (B / (fs * pods)) * d * 2 * L)
    out["hbm_bytes"] = hbm
    out["link_bytes"] = link
    out["cache_bytes_total"] = cache
    return out


# Decode-time cache/state byte counts are sourced from the SPU op
# registry's own traffic descriptors (repro_torch/ops): one decode step's ops are
# enumerated by ``decode_op_plans(cfg, B, S)`` and each entry's
# ``traffic(plan)`` supplies the bytes -- the roofline scores exactly the
# ops the model dispatches, with no independent per-family byte formulas.

def _cache_state_bytes(cfg, sc, layout: str = "dense") -> Tuple[float, float]:
    """(KV cache bytes, recurrent state bytes) of the decode-time caches.

    One attn/mla decode op streams its whole cache once, so the read side of
    its traffic IS the cache footprint; the state footprint is one read pass
    of every state_update op.  One registry enumeration serves both.
    ``layout="paged"`` scores the block-table-native ops instead: attention
    reads are page-granular (whole 128-token pages, including a partially
    filled tail page), matching what the paged serving engine dispatches.
    """
    from repro_torch.ops import decode_traffic_by_kind
    by_kind = decode_traffic_by_kind(cfg, sc.global_batch, sc.seq_len, layout)
    kv = sum(t.state_read for k, t in by_kind.items()
             if k in ("attn_decode", "mla_decode"))
    state = by_kind.get("state_update")
    return kv, state.state_read if state is not None else 0.0


def model_flops_train(n_params: float, n_tokens: float) -> float:
    return 6.0 * n_params * n_tokens


def model_flops_decode(n_params_active: float, n_tokens: float,
                       state_bytes_touched: float = 0.0) -> float:
    # decode step: 2*N_active per token matmul FLOPs (fwd only)
    return 2.0 * n_params_active * n_tokens


def count_params(tree) -> float:
    """Number of scalars in a parameter tree: nested dicts, lists and tuples
    whose leaves are tensors (any device, ``meta`` included) or anything
    else with a ``shape``."""
    if isinstance(tree, dict):
        return float(sum(count_params(v) for v in tree.values()))
    if isinstance(tree, (list, tuple)):
        return float(sum(count_params(v) for v in tree))
    n = 1
    for s in tree.shape:
        n *= int(s)
    return float(n)
