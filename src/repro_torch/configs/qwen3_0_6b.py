"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.

qk_norm, GQA [hf:Qwen/Qwen3-8B family; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,  # qwen3 uses head_dim 128 (not d_model/n_heads)
    qk_norm=True,
    mlp_activation="silu",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    qk_norm=True,
    mlp_activation="silu",
    tie_embeddings=True,
    attn_chunk=64,
)

register(FULL, REDUCED)
