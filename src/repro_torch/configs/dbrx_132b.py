"""DBRX-132B: 16 experts top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    pattern=("attn",), ffn_kind="moe", rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512,
    pattern=("attn",), ffn_kind="moe",
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128, capacity_factor=1.5),
)
