"""Zamba2-2.7B: Mamba-2 backbone + shared attention block every 6 layers
[arXiv:2411.15242; hf].  The paper's headline hybrid workload."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    pattern=("mamba2",) * 6, ffn_kind="swiglu", shared_attn=True,
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=64),
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    pattern=("mamba2",) * 3, ffn_kind="swiglu", shared_attn=True,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=16),
)
