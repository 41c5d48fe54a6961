"""PaliGemma-3B: SigLIP frontend (stub) + gemma decoder, prefix-LM
[arXiv:2407.07726; hf].  The caller supplies precomputed patch embeddings
(``batch["patches"]``, ``frontend_dim`` wide)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216,
    pattern=("attn",), ffn_kind="geglu", rope_theta=10_000.0,
    frontend="patch", frontend_dim=1152, prefix_len=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512,
    pattern=("attn",), ffn_kind="geglu",
    frontend="patch", frontend_dim=64, prefix_len=16,
    tie_embeddings=True,
)
