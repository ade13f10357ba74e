"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]. d_ff=0: the xLSTM blocks
carry their own up/down projections (mLSTM pre-up-projection expand=2, sLSTM
gated FFN 4/3) instead of a separate transformer MLP.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attn_type="none",
    ssm_expand=2,
    xlstm_slstm_every=2,  # alternate mLSTM / sLSTM
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    attn_type="none",
    ssm_expand=2,
    xlstm_slstm_every=2,
)

register(FULL, REDUCED)
