"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b family; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    mlp_activation="silu",
)

REDUCED = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    mlp_activation="silu",
    attn_chunk=64,
)

register(FULL, REDUCED)
