"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave. [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    attn_every=8,  # 1 attention layer per 8 (1:7 attn:mamba)
    moe_every=2,  # MoE every other layer
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    mlp_activation="silu",
)

REDUCED = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=8,  # one full interleave group
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    n_experts=4,
    top_k=2,
    moe_d_ff=256,
    attn_every=8,
    moe_every=2,
    ssm_state_dim=8,
    ssm_conv_width=4,
    ssm_expand=2,
    mlp_activation="silu",
    attn_chunk=64,
)

register(FULL, REDUCED)
