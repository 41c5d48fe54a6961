"""SmolLM-360M: llama-arch small GQA [hf:HuggingFaceTB/SmolLM; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152,
    pattern=("attn",), ffn_kind="swiglu", rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, head_dim=32,
    d_ff=192, vocab_size=512,
    pattern=("attn",), ffn_kind="swiglu", rope_theta=10_000.0,
    tie_embeddings=True,
)
