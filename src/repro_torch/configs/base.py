"""Config system of the port's LMs: `ModelConfig`, `ShapeConfig`,
`RunConfig`, the shape table and the architecture registry (counterpart of
`repro.configs.base`).

The dataclasses carry every field of the reference's, so a config file
copies over verbatim. The registry loads every LM arch of the reference
(`_ARCH_MODULES`): the dense LM family, the MoE family, arctic-480b (GQA
attention) and deepseek-v2-236b (MLA attention), the recurrent-state
families, jamba-v0.1-52b (hybrid) and xlstm-125m (SSM), and the
cross-attention families, llama-3.2-vision-90b (VLM) and whisper-tiny
(audio encoder-decoder). The reference also registers a "vgg19-sparse"
ModelConfig; the port keeps its CNN configs in `configs.vgg19_sparse` as
`CNNConfig`s only.
`ModelConfig.n_params` counts from the parameter shapes without allocating
them (`models.model.count_params_analytic`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    attn_type: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_chunk: int = 1024  # kv-chunk for blockwise (flash-style) attention

    # MLA (deepseek)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_residual_ff: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01

    # hybrid (jamba): one attention layer every `attn_every` layers (rest mamba);
    # MoE on every `moe_every`-th layer (0 = never).
    attn_every: int = 0
    moe_every: int = 0

    # ssm (mamba / xlstm)
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    xlstm_slstm_every: int = 2  # alternate mLSTM / sLSTM blocks

    # vlm (llama-3.2-vision): cross-attention to image embeddings every k layers
    cross_attn_every: int = 0
    n_image_tokens: int = 1024

    # audio enc-dec (whisper): encoder length fixed by frontend stub
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # FFN
    mlp_activation: str = "silu"  # silu | gelu | relu | relu2
    ffn_sparsity: str = "none"  # none | block_ecr (paper technique lifted to FFN)

    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: recurrent/SSM state or hybrid w/ few attn layers."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (matches init_params; used for 6ND roofline)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def n_active_params(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


# ---------------------------------------------------------------------------
# Shape config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs; reason recorded in the dry-run table."""
    if shape.name == "long_500k" and not model.supports_long_context:
        return False, "full-attention arch: 500k dense KV/O(L^2) attn — needs sub-quadratic attention (DESIGN.md §5)"
    return True, ""


# ---------------------------------------------------------------------------
# Run config (distribution knobs; the port reads kv_cache_dtype's values)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RunConfig:
    # mesh
    multi_pod: bool = False
    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"  # bf16 for the very large archs to fit HBM
    # memory
    remat: str = "full"  # none | full | dots  (activation-checkpoint policy)
    grad_accum: int = 1  # microbatch count inside train_step (scan + accumulate)
    # parallelism
    fsdp: bool = True  # shard params/opt-state over the data (+pod) axes
    seq_shard: bool = True  # Megatron-SP style activation sharding over "model"
    pipeline_stages: int = 0  # >0: GPipe-style PP over the "pod" axis
    # serving
    kv_cache_dtype: str = "bfloat16"  # int8: quantized KV (decode memory lever)
    # optimizer
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # gradient compression (distributed-optimization trick; off by default)
    grad_compression: str = "none"  # none | int8 | topk
    grad_topk_frac: float = 0.01
    # fault tolerance
    checkpoint_every: int = 200
    keep_checkpoints: int = 3

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_RUN = RunConfig()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}
_REDUCED: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False

_ARCH_MODULES = [
    "stablelm_12b",
    "mistral_large_123b",
    "minitron_8b",
    "qwen3_0_6b",
    "arctic_480b",
    "deepseek_v2_236b",
    "jamba_v0_1_52b",
    "xlstm_125m",
    "llama_3_2_vision_90b",
    "whisper_tiny",
]


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib

    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _LOADED = True
