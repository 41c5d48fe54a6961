"""Mamba-2 2.7B (paper eval model) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=80, n_kv_heads=80, head_dim=64,
    d_ff=0, vocab_size=50288,
    pattern=("mamba2",), ffn_kind="none", pos_emb="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=64),
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=512,
    pattern=("mamba2",), ffn_kind="none", pos_emb="none",
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=16),
)
