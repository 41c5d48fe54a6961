"""xLSTM-1.3B: sLSTM + mLSTM blocks, 7:1 ratio [arXiv:2405.04517; unverified]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab_size=50304,
    pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm",
             "slstm"),
    ffn_kind="none", pos_emb="none",
    # chunk=512: one chunk covers a prompt of up to 512 tokens
    ssm=SSMConfig(expand=2, n_heads=4, d_conv=4, chunk=512),
)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=0, vocab_size=512,
    pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm",
             "slstm"),
    ffn_kind="none", pos_emb="none",
    ssm=SSMConfig(expand=2, n_heads=2, d_conv=4, chunk=16),
)
