"""DeepSeek-V2 236B: MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab_size=102400,
    pattern=("mla",), prelude=("mla",), ffn_kind="moe", rope_theta=10_000.0,
    mla=MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
                  v_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  capacity_factor=1.25, first_dense_ff=12288),
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=64, vocab_size=512,
    pattern=("mla",), prelude=("mla",), ffn_kind="moe",
    mla=MLAConfig(q_lora=64, kv_lora=64, rope_dim=16, nope_dim=32, v_dim=32),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=1,
                  capacity_factor=1.5, first_dense_ff=128),
)
