"""OPT-6.7B (paper's attention-based baseline) [arXiv:2205.01068]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="opt-6.7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=16384, vocab_size=50272,
    pattern=("attn",), ffn_kind="relu", norm_kind="layernorm",
    pos_emb="learned",
)

SMOKE = ModelConfig(
    name="opt-6.7b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512,
    pattern=("attn",), ffn_kind="relu", norm_kind="layernorm",
    pos_emb="learned",
)
