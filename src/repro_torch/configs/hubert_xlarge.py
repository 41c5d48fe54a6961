"""HuBERT-XLarge: encoder-only audio transformer [arXiv:2106.07447].

Pimba's technique does not apply (no decode step, no cache): the port runs
its prefill only.  The frontend is a stub: the caller supplies the conv
frame features (``batch["frames"]``, ``frontend_dim`` wide)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    pattern=("attn",), ffn_kind="gelu", norm_kind="layernorm",
    pos_emb="sincos", causal=False, encoder_only=True,
    frontend="audio_frames", frontend_dim=512,
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=64,
    pattern=("attn",), ffn_kind="gelu", norm_kind="layernorm",
    pos_emb="sincos", causal=False, encoder_only=True,
    frontend="audio_frames", frontend_dim=64,
)
