"""Yi-9B: llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    pattern=("attn",), ffn_kind="swiglu", rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    name="yi-9b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    pattern=("attn",), ffn_kind="swiglu", rope_theta=5_000_000.0,
)
