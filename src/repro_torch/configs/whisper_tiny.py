"""whisper-tiny [audio] — 4L d_model=384 6H d_ff=1536 vocab=51865, enc-dec.

[arXiv:2212.04356; unverified]. The encoder takes frame embeddings
(batch, frames, d_model) as its input, as the reference's does; the conv
frontend that makes them from a mel spectrogram is
`repro_torch.models.cnn.whisper_frontend`, run on its own.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    mlp_activation="gelu",
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not rope
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=2,
    n_encoder_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    is_encoder_decoder=True,
    mlp_activation="gelu",
    rope_theta=0.0,
    attn_chunk=64,
)

register(FULL, REDUCED)
