"""GLA 2.7B (paper eval model) [arXiv:2312.06635]: per-channel gated decay."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="gla-2.7b", family="ssm",
    n_layers=32, d_model=2560, n_heads=4, n_kv_heads=4, head_dim=320,
    d_ff=6912, vocab_size=50257,
    pattern=("gla",), ffn_kind="swiglu", pos_emb="none",
    ssm=SSMConfig(n_heads=4, dk_head=320, dv_head=640, chunk=64),
)

SMOKE = ModelConfig(
    name="gla-2.7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512,
    pattern=("gla",), ffn_kind="swiglu", pos_emb="none",
    ssm=SSMConfig(n_heads=2, dk_head=32, dv_head=32, chunk=16),
)
