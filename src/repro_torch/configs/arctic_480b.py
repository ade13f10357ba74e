"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual FFN. [hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,  # dense residual FFN width
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual_ff=True,
    mlp_activation="silu",
)

REDUCED = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    n_experts=8,
    top_k=2,
    moe_d_ff=128,
    dense_residual_ff=True,
    mlp_activation="silu",
    attn_chunk=64,
)

register(FULL, REDUCED)
