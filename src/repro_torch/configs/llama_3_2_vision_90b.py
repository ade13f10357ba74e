"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision encoder is not modelled, as in the reference: a batch carries
precomputed patch embeddings `img_embeds` (batch, n_image_tokens, d_model);
every 5th layer is a gated cross-attention layer over them (100L = 80 self
+ 20 cross).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    n_image_tokens=1024,
    mlp_activation="silu",
)

REDUCED = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=5,  # one cross-attn group
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    cross_attn_every=5,
    n_image_tokens=16,
    mlp_activation="silu",
    attn_chunk=64,
)

register(FULL, REDUCED)
