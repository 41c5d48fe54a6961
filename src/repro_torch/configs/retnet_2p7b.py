"""RetNet 2.7B (paper eval model) [arXiv:2307.08621]: fixed per-head decay."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="retnet-2.7b", family="ssm",
    n_layers=32, d_model=2560, n_heads=10, n_kv_heads=10, head_dim=256,
    d_ff=5120, vocab_size=50257,
    pattern=("retnet",), ffn_kind="swiglu", pos_emb="none",
    ssm=SSMConfig(n_heads=10, dk_head=256, dv_head=512, chunk=64),
)

SMOKE = ModelConfig(
    name="retnet-2.7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512,
    pattern=("retnet",), ffn_kind="swiglu", pos_emb="none",
    ssm=SSMConfig(n_heads=2, dk_head=32, dv_head=64, chunk=16),
)
