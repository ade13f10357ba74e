"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Pruned nemotron [arXiv:2407.14679; hf]. Plain (non-gated) ReLU^2 MLP in nemotron
style is approximated with gated silu per the shared transformer block; the
pruned-width config is what matters for the shapes.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    mlp_activation="relu2",  # squared-relu (nemotron) => activation sparsity >0
    ffn_sparsity="block_ecr",  # paper technique applies: ReLU-family FFN
)

REDUCED = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    mlp_activation="relu2",
    ffn_sparsity="block_ecr",
    attn_chunk=64,
)

register(FULL, REDUCED)
