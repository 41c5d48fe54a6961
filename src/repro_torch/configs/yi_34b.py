"""Yi-34B: llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    pattern=("attn",), ffn_kind="swiglu", rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    name="yi-34b-smoke", family="dense",
    n_layers=2, d_model=112, n_heads=7, n_kv_heads=1, head_dim=16,
    d_ff=224, vocab_size=512,
    pattern=("attn",), ffn_kind="swiglu", rope_theta=5_000_000.0,
)
