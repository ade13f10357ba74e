"""deepseek-v2-236b [moe] — 60L d_model=5120 128H (MLA kv_lora=512) d_ff=1536
vocab=102400, MoE 2 shared + 160 routed top-6. [arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA: per-head latent up-projection; no GQA grouping
    d_ff=1536,  # routed-expert intermediate width
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    mlp_activation="silu",
)

REDUCED = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab_size=512,
    attn_type="mla",
    kv_lora_rank=32,
    q_lora_rank=48,
    rope_head_dim=16,
    nope_head_dim=32,
    v_head_dim=32,
    n_experts=8,
    top_k=2,
    n_shared_experts=1,
    moe_d_ff=64,
    mlp_activation="silu",
    attn_chunk=64,
)

register(FULL, REDUCED)
