"""HGRN2 2.7B (paper eval model) [arXiv:2404.07904]: gated linear RNN with
state expansion; forget-gate lower bound grows with depth."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hgrn2-2.7b", family="ssm",
    n_layers=32, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=50257,
    pattern=("hgrn2",), ffn_kind="swiglu", pos_emb="none",
    ssm=SSMConfig(n_heads=20, dk_head=128, dv_head=128, chunk=64),
)

SMOKE = ModelConfig(
    name="hgrn2-2.7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512,
    pattern=("hgrn2",), ffn_kind="swiglu", pos_emb="none",
    ssm=SSMConfig(n_heads=2, dk_head=32, dv_head=32, chunk=16),
)
