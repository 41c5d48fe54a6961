"""Model configuration dataclasses (PyTorch port; field for field the JAX
package's ``repro/models/config.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.ops.base import StateQuantConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0              # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    first_dense_ff: int = 0        # layer 0 uses a dense FFN of this width


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128

    @property
    def cache_width(self) -> int:          # latent + shared rope key
        return self.kv_lora + self.rope_dim


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Parameters for state-update mixers (mamba2/gla/retnet/hgrn2/mlstm/slstm)."""
    d_state: int = 128        # mamba2 N (== dk of the generalized op)
    head_dim: int = 64        # mamba2 P (== dv)
    expand: int = 2           # d_inner = expand * d_model
    d_conv: int = 4
    n_heads: int = 0          # heads for gla/retnet/hgrn2/mlstm (0 = use model n_heads)
    dk_head: int = 0          # per-head key dim for gla-family (0 = derive)
    dv_head: int = 0          # per-head value dim
    chunk: int = 64           # prefill chunk length
    log_decay_min: float = -1.0  # per-step log-decay clamp (vector-decay path)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|ssm|moe|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # repeating block pattern; len(pattern) must divide n_layers - len(prelude).
    # elements: attn|mla|mamba2|gla|retnet|hgrn2|mlstm|slstm
    pattern: Tuple[str, ...] = ("attn",)
    # non-repeated leading layers (e.g. DeepSeek-V2's dense-FFN first layer);
    # these always use a dense FFN (moe.first_dense_ff wide if ffn_kind=moe)
    prelude: Tuple[str, ...] = ()
    ffn_kind: str = "swiglu"       # swiglu|geglu|gelu|relu|none|moe
    norm_kind: str = "rmsnorm"     # rmsnorm|layernorm
    pos_emb: str = "rope"          # rope|learned|sincos|none
    rope_theta: float = 10000.0
    causal: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Zamba2): one shared attention+MLP block applied after every
    # pattern group (weights shared across applications)
    shared_attn: bool = False
    # modality frontends are STUBS: input_specs() supplies precomputed
    # patch/frame embeddings of width frontend_dim
    frontend: Optional[str] = None  # patch|audio_frames
    frontend_dim: int = 0
    prefix_len: int = 0             # bidirectional prefix length (VLM)
    encoder_only: bool = False
    # numerics / execution
    state_quant: StateQuantConfig = StateQuantConfig()
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    # Megatron-SP constraint on layer-boundary activations (train/prefill):
    # divides saved-residual memory by TP at the cost of AG/RS pairs per
    # layer -- toggleable because the roofline shows it is a memory vs
    # collective tradeoff (see EXPERIMENTS.md §Perf)
    seq_parallel: bool = True
    # cost-probe mode: fully unroll inner scans (flash attention, chunked
    # linear attention, chunked CE) so XLA cost_analysis -- which counts a
    # while body ONCE regardless of trip count -- reports exact FLOPs/bytes.
    # Used by the dry-run roofline at reduced depth; never for real runs.
    cost_probe: bool = False
    logit_chunk: int = 1024
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 512

    # ---- derived ----
    @property
    def n_groups(self) -> int:
        n = self.n_layers - len(self.prelude)
        assert n % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} (minus prelude) not "
            f"divisible by pattern of length {len(self.pattern)}")
        return n // len(self.pattern)

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def ffn_kind_inner(self) -> str:
        """Activation used by expert FFNs when ffn_kind == 'moe'."""
        return "swiglu" if self.ffn_kind == "moe" else self.ffn_kind

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
