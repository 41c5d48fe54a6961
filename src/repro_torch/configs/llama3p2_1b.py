"""Llama-3.2-1B: small llama3 GQA [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256,
    pattern=("attn",), ffn_kind="swiglu", rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    pattern=("attn",), ffn_kind="swiglu", rope_theta=500_000.0,
    tie_embeddings=True,
)
